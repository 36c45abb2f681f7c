"""One general traffic generator, driven by a mix file's parameters.

A mix (``nksbench/mixes/<traffic>.json``) is data only:

* ``loop``: ``"open"`` (requests due on a schedule, whatever the system
  answers: independent users) or ``"closed"`` (one client sends a batch and
  waits for its answer before the next);
* ``query``: how each query's tags are drawn: ``{"draw": "uniform", "q":
  Q}`` (Q distinct tags uniform over the tags that tag at least one point,
  in random order: the first is the anchor keyword) or ``{"draw": "log",
  "log": [[tag, ...], ...]}`` (a frozen log, replayed in order from its
  start and wrapped around);
* ``k``, ``tier``: what every request asks for;
* open loop: ``arrivals`` ``{"process": "poisson", "rate_qps": R}``. A run
  of T seconds holds ``round(R T)`` requests whose gaps are the same set
  for every seed, the exponential distribution's quantiles at
  ``(i + 1/2) / n``, put in an order drawn from the seed: the count and
  the gaps do not move with the seed, only their order;
* closed loop: ``batch``, the queries a call, and ``batches_per_s``: a
  window of T seconds is the first ``round(T * batches_per_s)`` batches
  of the replay (a uniform draw replays ``pass_queries`` queries, default
  4,096, drawn from the seed).

The seed draws the order of the gaps and the uniform tags (its own
streams, apart from the corpus's); a log does not move with the seed.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from harness.corpus import Corpus, rng as seeded_rng

TRAFFIC_STREAM, WARMUP_STREAM, SAMPLE_STREAM = 2, 3, 4


@dataclasses.dataclass
class OpenLoop:
    due_s: np.ndarray              # (n,) seconds after the window opens
    queries: list[list[int]]
    k: int
    tier: str


@dataclasses.dataclass
class ClosedLoop:
    queries: list[list[int]]       # one pass of the log, in order
    batch: int
    k: int
    tier: str

    def batch_at(self, i: int) -> list[list[int]]:
        """The i-th batch of the replay (wrapping around the log)."""
        n = len(self.queries)
        return [self.queries[(i * self.batch + j) % n]
                for j in range(self.batch)]


def poisson_gaps(n: int, rate_qps: float) -> np.ndarray:
    """The n exponential quantiles at (i + 1/2) / n, mean about 1/rate."""
    p = (np.arange(n, dtype=np.float64) + 0.5) / n
    return -np.log1p(-p) / float(rate_qps)


def uniform_queries(corpus: Corpus, q: int, count: int,
                    rng: np.random.Generator) -> list[list[int]]:
    present = np.flatnonzero(corpus.posting_sizes() > 0)
    if len(present) < q:
        raise ValueError(f"{len(present)} populated tags, a query needs {q}")
    keys = rng.random((count, len(present)))
    picks = np.argpartition(keys, q - 1, axis=1)[:, :q]
    # argpartition leaves the first q unordered: order them by their keys,
    # so the anchor is the tag of least key, as a draw without replacement.
    order = np.take_along_axis(keys, picks, axis=1).argsort(axis=1)
    picks = np.take_along_axis(picks, order, axis=1)
    return present[picks].tolist()


def draw_queries(mix: dict, corpus: Corpus, count: int,
                 rng: np.random.Generator) -> list[list[int]]:
    spec = mix["query"]
    if spec["draw"] == "uniform":
        return uniform_queries(corpus, int(spec["q"]), count, rng)
    if spec["draw"] == "log":
        log = [list(map(int, row)) for row in spec["log"]]
        return [log[i % len(log)] for i in range(count)]
    raise ValueError(f"unknown query draw {spec['draw']!r}")


def make_traffic(mix: dict, corpus: Corpus, seed: int, seconds: float,
                 rate_qps: float | None = None):
    """The run's requests: an :class:`OpenLoop` or a :class:`ClosedLoop`.
    ``rate_qps`` overrides an open mix's rate (the rate sweep)."""
    rng = seeded_rng(seed, TRAFFIC_STREAM)
    k, tier = int(mix["k"]), mix.get("tier", "device")
    if mix["loop"] == "open":
        arr = mix["arrivals"]
        if arr["process"] != "poisson":
            raise ValueError(f"unknown arrival process {arr['process']!r}")
        rate = float(rate_qps if rate_qps is not None else arr["rate_qps"])
        n = max(1, int(round(rate * seconds)))
        gaps = rng.permutation(poisson_gaps(n, rate))
        due = np.concatenate([[0.0], np.cumsum(gaps[:-1])])
        return OpenLoop(due, draw_queries(mix, corpus, n, rng), k, tier)
    if mix["loop"] == "closed":
        spec = mix["query"]
        count = len(spec["log"]) if spec["draw"] == "log" \
            else int(mix.get("pass_queries", 4096))
        return ClosedLoop(draw_queries(mix, corpus, count, rng),
                          int(mix["batch"]), k, tier)
    raise ValueError(f"unknown loop {mix['loop']!r}")


def warmup_queries(mix: dict, corpus: Corpus, seed: int,
                   count: int) -> list[list[int]]:
    """Queries to warm the path up with: the mix's first ``count`` for a
    log, else ``count`` fresh draws from the seed's warm-up stream."""
    return draw_queries(mix, corpus, count, seeded_rng(seed, WARMUP_STREAM))


def check_sample(n_answered: int, size: int, seed: int) -> np.ndarray:
    """Indices of the answered requests whose answers are checked: ``size``
    of them (or all), drawn from the seed, ascending."""
    if n_answered <= size:
        return np.arange(n_answered)
    rng = seeded_rng(seed, SAMPLE_STREAM)
    return np.sort(rng.choice(n_answered, size=size, replace=False))
