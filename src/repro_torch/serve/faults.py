"""Deterministic fault injection for the durable engine.

The durability tests need *repeatable* failures: "the process dies between
the WAL append and the ack", "compaction crashes mid-rebuild". A
:class:`FaultPlan` arms named fault points at specific 1-based hit counts;
the engine and the WAL thread one plan through and call
:meth:`FaultPlan.check` at each point. The default :data:`NO_FAULTS` plan
makes every check a counter bump, so the hooks cost nothing in normal
serving.

Two failure flavours map to two exception types:

  * :class:`InjectedFault` — a *transient* error (a flaky device dispatch),
    which a retrying caller treats as retryable.
  * :class:`InjectedCrash` — simulated *process death* (kill -9 between WAL
    append and ack, compaction crash): nothing may catch-and-continue the
    in-process state; recovery happens by replaying the WAL into a fresh
    engine. InjectedCrash deliberately subclasses BaseException so a stray
    ``except Exception`` in the serving path cannot swallow a "death".

Named points (the reference package's, so a plan means the same in both):

  ``dispatch``      query-batch device dispatch of a serving runtime
                    (transient)
  ``compact``       mid-rebuild, after the compacted dataset is materialised
                    but before the new indices exist (crash or transient)
  ``wal_ack``       after a WAL record is durably on disk, before the engine
                    acknowledges the op to the caller (crash)

and the document ingest pipeline's worker sites ``claim``, ``embed``,
``insert`` and ``ack`` (one per state-machine window: batch leased, records
in worker memory, insert intent durable, batch past its WAL group-commit
barrier).
"""
from __future__ import annotations

from collections import Counter
from typing import Iterable


class InjectedFault(RuntimeError):
    """A transient injected failure (retryable)."""

    def __init__(self, point: str, hit: int):
        super().__init__(f"injected fault at {point!r} (hit #{hit})")
        self.point = point
        self.hit = hit


class InjectedCrash(BaseException):
    """Simulated process death — must not be handled as a normal error."""

    def __init__(self, point: str, hit: int):
        super().__init__(f"injected crash at {point!r} (hit #{hit})")
        self.point = point
        self.hit = hit


class FaultPlan:
    """Arms named fault points at deterministic hit counts.

    ``transient`` / ``crash`` map point name -> 1-based hit indices (an int
    is shorthand for a single hit). A point may appear in either dict, not
    both. ``hits`` counts every check (fired or not), ``fired`` only the
    injections — both are per-point Counters the tests assert on.
    """

    def __init__(self,
                 transient: "dict[str, int | Iterable[int]] | None" = None,
                 crash: "dict[str, int | Iterable[int]] | None" = None):
        def norm(plan):
            out = {}
            for point, when in (plan or {}).items():
                if isinstance(when, int):
                    when = (when,)
                out[str(point)] = frozenset(int(w) for w in when)
            return out
        self._transient = norm(transient)
        self._crash = norm(crash)
        dup = set(self._transient) & set(self._crash)
        if dup:
            raise ValueError(f"points armed as both transient and crash: "
                             f"{sorted(dup)}")
        self.hits: Counter = Counter()
        self.fired: Counter = Counter()

    def check(self, point: str) -> None:
        """Count a pass through ``point``; raise if this hit is armed."""
        self.hits[point] += 1
        hit = self.hits[point]
        if hit in self._crash.get(point, ()):
            self.fired[point] += 1
            raise InjectedCrash(point, hit)
        if hit in self._transient.get(point, ()):
            self.fired[point] += 1
            raise InjectedFault(point, hit)


#: Shared no-op plan: every check is a counter bump, nothing ever fires.
NO_FAULTS = FaultPlan()
