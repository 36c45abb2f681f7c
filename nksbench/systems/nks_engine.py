"""The system under test of the nearest-keyword-set configurations:
``repro_torch``'s ``NKSEngine`` over the seed's corpus.

A configuration names its system (``"system": "nks_engine"``), and the
harness finds this file by that name (``harness/spec.py``). It is, with
the loops, the only file of the harness that imports the program. What
the harness calls:

* :func:`make_data`: the configuration's corpus, made from the seed
  (``harness/corpus.py``);
* :func:`build`: the engine over it, on the device. The program gets the
  corpus as plain arrays (the points, made on the device from the seed and
  copied to the host, and the point -> tags CSR) through
  ``core.carry.dataset_from_arrays``, and the configuration's ``engine``
  settings;
* :func:`instrument`: a span (``harness.system.Span``) around every call
  into the engine's ``query_batch``, with the engine's own phase timers of
  that call (``PipelineStats.t_pack_s`` and ``t_dispatch_s``);
* :data:`KERNELS` and :func:`launches`: the hand-written kernels whose
  device time the traced run reads, each by a mark in its kernels' names
  and by the program's launch counter of it;
* :func:`work`: the operations, bytes and bound seconds of the window's
  answered queries, counted from their inputs (``harness/roofline.py``).
"""
from __future__ import annotations

import contextlib
import time

import torch

from harness.corpus import make_corpus
from harness.roofline import anchor_star_work, bound_s
from harness.system import Span

# the fused anchor-star kernel (K6): its two kernels a query are named
# anchor_star_*, counted under diameter.launches["anchor_star"]
KERNELS = {"k6": "anchor_star_"}


def make_data(config: dict, seed: int):
    return make_corpus(config, seed)


def build(config: dict, corpus, device: str):
    from repro_torch.core.carry import dataset_from_arrays
    from repro_torch.serve.engine import NKSEngine

    pts = corpus.points(device)
    host = pts.cpu().numpy()
    del pts
    dataset = dataset_from_arrays(host, corpus.kw_offsets, corpus.kw_values,
                                  corpus.u)
    engine = NKSEngine(dataset, device=device, **config["engine"])
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return engine


def instrument(engine, spans) -> None:
    """Record a span around every ``engine.query_batch`` call into
    ``spans`` (a ``harness.system.Spans``), in whichever thread makes it,
    while ``spans.recording`` is set; with ``spans.trace``, under a
    profiler label too."""
    inner = engine.query_batch

    def query_batch(queries, *args, **kwargs):
        label = torch.profiler.record_function("nksbench.query_batch") \
            if spans.trace else contextlib.nullcontext()
        t0 = time.perf_counter()
        with label:
            out = inner(queries, *args, **kwargs)
        t1 = time.perf_counter()
        if spans.recording:
            st = engine.last_batch_stats
            spans.add(Span(t0, t1, [list(q) for q in queries],
                           st.t_pack_s, st.t_dispatch_s))
        return out

    engine.query_batch = query_batch


def launches() -> dict[str, int]:
    """The program's launch counters of :data:`KERNELS`, in kernels (the
    fused search is two a query of more than one tag)."""
    from repro_torch.kernels import diameter
    return {"k6": int(diameter.launches["anchor_star"])}


def work(corpus, queries, answers) -> tuple[float, float, float]:
    """(operations, bytes, bound seconds) of the anchor-star searches of
    the answered queries (``answers[i]`` None for an unanswered one)."""
    sizes = corpus.posting_sizes()
    flops = nbytes = bound = 0.0
    for q, a in zip(queries, answers):
        if a is None:
            continue
        f, b = anchor_star_work([int(sizes[t]) for t in q], corpus.d)
        flops, nbytes, bound = flops + f, nbytes + b, bound + bound_s(f, b)
    return flops, nbytes, bound
