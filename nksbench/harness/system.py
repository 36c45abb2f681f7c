"""Spans that the harness records around calls into the system under
test (``nksbench/systems/<system>.py`` installs them: its ``instrument``).

A :class:`Span` is one call: its wall on ``time.perf_counter()``, the
queries it carried and the system's own phase timers for that call.
"""
from __future__ import annotations

import dataclasses
import threading

import numpy as np


@dataclasses.dataclass
class Span:
    start: float            # time.perf_counter()
    end: float
    queries: list
    pack_s: float
    dispatch_s: float


class Spans:
    """The spans of a run, kept while ``recording`` is set; ``trace``
    asks the instrumentation for profiler labels too."""

    def __init__(self, trace: bool = False):
        self.items: list[Span] = []
        self.recording = False
        self.trace = trace
        self._lock = threading.Lock()

    def add(self, span: Span) -> None:
        with self._lock:
            self.items.append(span)

    def total(self, field: str) -> float:
        return float(np.sum([getattr(s, field) for s in self.items]))

    def wall_s(self) -> float:
        return float(np.sum([s.end - s.start for s in self.items]))

    def queries(self) -> int:
        return sum(len(s.queries) for s in self.items)
