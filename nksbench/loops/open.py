"""The open loop: requests due on a schedule, through the serving runtime.

Independent users: each request is submitted at its due time, whatever
the system has answered, to ``serve/runtime.py``'s ``ServingRuntime``
(admission queue, coalescing into ``NKSEngine.query_batch`` calls, one
worker thread) with the mix's ``runtime`` settings. A request's latency
runs from its due time to its answer, so a stall's wait on later requests
counts, and so does any lateness of this client (``lag_s``). Both ends
are this client's own clock: a waiter thread takes each ticket in
submission order and stamps the moment its answer is there. The window
holds every request due in it; the loop waits for their answers up to a
minute past its close. A request refused or not answered by then is
failed. Warm-up: the mix's ``warmup`` queries submitted at once and
answered, before the window.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time

import numpy as np

from harness.traffic import warmup_queries


def _request(tier: str, k: int, keywords) -> dict:
    return {"op": "query", "tier": tier, "k": k, "keywords": list(keywords)}


def run(ctx):
    from repro_torch.serve.runtime import RuntimeConfig, ServingRuntime

    tr, mix = ctx.traffic, ctx.mix
    rt = ServingRuntime(ctx.engine, RuntimeConfig(tier=tr.tier, k=tr.k,
                                                  **mix.get("runtime", {})))
    try:
        warm = [rt.submit(_request(tr.tier, tr.k, q)) for q in
                warmup_queries(mix, ctx.corpus, ctx.seed,
                               int(mix.get("warmup", 32)))]
        for t in warm:
            res = t.result(timeout=600.0)
            if not res.ok:
                raise RuntimeError(f"warm-up request failed: {res.status} "
                                   f"{res.error}")
        ctx.setup_done()
        before = dataclasses.replace(rt.stats)
        n = len(tr.queries)
        tickets, sent, done = [None] * n, [0.0] * n, [None] * n
        pending: queue.Queue = queue.Queue()
        with ctx.window():
            ctx.spans.recording = True
            t0 = time.monotonic()
            deadline = t0 + ctx.seconds + 60.0

            def waiter():
                while (item := pending.get()) is not None:
                    i, t = item
                    try:
                        t.result(timeout=max(0.0,
                                             deadline - time.monotonic()))
                    except TimeoutError:
                        continue
                    done[i] = time.monotonic()

            stamp = threading.Thread(target=waiter, name="nksbench-waiter")
            stamp.start()
            try:
                for i, (due, q) in enumerate(zip(tr.due_s, tr.queries)):
                    wait = t0 + float(due) - time.monotonic()
                    if wait > 0:
                        time.sleep(wait)
                    tickets[i] = rt.submit(_request(tr.tier, tr.k, q))
                    sent[i] = time.monotonic()
                    pending.put((i, tickets[i]))
            finally:
                pending.put(None)
                stamp.join()
            stamped = [x for x in done if x is not None]
            t_end = max(stamped) if stamped else time.monotonic()
            ctx.spans.recording = False
        after = dataclasses.replace(rt.stats)
    finally:
        rt.close(timeout=60.0, drain=False)
    answers, latency, lag = [], [], []
    for due, t, s_at, d_at in zip(tr.due_s, tickets, sent, done):
        lag.append(s_at - (t0 + float(due)))
        res = t.response if d_at is not None else None
        if res is None or not res.ok:
            answers.append(None)
            continue
        answers.append([(tuple(c.ids), float(c.diameter))
                        for c in res.payload["candidates"]])
        latency.append(d_at - (t0 + float(due)))
    return ctx.result_window(
        queries=[list(q) for q in tr.queries], answers=answers,
        window_s=t_end - t0, latency_s=np.asarray(latency),
        lag_s=np.asarray(lag),
        runtime={f: getattr(after, f) - getattr(before, f)
                 for f in ("batches", "batched_queries", "rejected_full",
                           "completed", "errors")})
