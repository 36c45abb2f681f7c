"""Wall-clock timing helpers (the reference package's bench timer).

A host clock: around work on the card, the timed function must end in a
``torch.cuda.synchronize()`` (CUDA launches return before the work is
done).
"""
from __future__ import annotations

import time


class Timer:
    """Context manager measuring elapsed seconds."""

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.t0
        return False


def bench(fn, *args, repeats: int = 3, warmup: int = 1, **kwargs) -> float:
    """Return median seconds per call."""
    for _ in range(warmup):
        fn(*args, **kwargs)
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]
