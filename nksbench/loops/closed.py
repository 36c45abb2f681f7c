"""The closed loop: one client sends a batch of queries to
``NKSEngine.query_batch`` and sends the next when the answer is back.

Callers that wait for each reply: nothing comes between batches. The
window is a fixed amount of work: the traffic's first ``round(seconds *
batches_per_s)`` batches (the mix's rate of batches, about what the
system answered in a second when it was set), whatever their time, so
that which queries a window holds never depends on the timing. It opens
with the device idle and closes when the last batch is answered: its
length covers all the work of every query counted. Warm-up: the mix's
``warmup`` queries in one call, before the window.
"""
from __future__ import annotations

import time

import torch

from harness.traffic import warmup_queries


def run(ctx):
    tr, mix, engine = ctx.traffic, ctx.mix, ctx.engine
    warm = warmup_queries(mix, ctx.corpus, ctx.seed,
                          int(mix.get("warmup", tr.batch)))
    engine.query_batch(warm, k=tr.k, tier=tr.tier)
    ctx.setup_done()
    queries, answers = [], []
    with ctx.window():
        ctx.spans.recording = True
        if torch.device(ctx.device).type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(max(1, round(ctx.seconds * mix["batches_per_s"]))):
            batch = tr.batch_at(i)
            res = engine.query_batch(batch, k=tr.k, tier=tr.tier)
            queries += [list(q) for q in batch]
            answers += [[(tuple(c.ids), float(c.diameter))
                         for c in r.candidates] for r in res[:len(batch)]]
            # a query the call left without a result is unanswered
            answers += [None] * (len(batch) - len(res))
        t_end = time.perf_counter()
        ctx.spans.recording = False
    return ctx.result_window(queries=queries, answers=answers,
                             window_s=t_end - t0)
