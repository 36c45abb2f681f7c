"""The kernel wrappers under several host threads, on the CPU.

The serving runtime's worker and compactor and the ingest pipeline's
workers launch kernels from several threads: each wrapper module loads its
library once (``library()`` through ``build.load``, under a lock) and counts
its launches through ``build.count``, atomically. Here the loader's ``_bind`` is replaced by a
slow stand-in (the CPU has no nvcc), and the counter is driven directly;
the launches themselves are counted on the card (``tests/test_torch_cuda.py``).
"""
import threading
import time

import pytest

from repro_torch.kernels import (build, diameter, flash_attention,
                                 pairwise_l2, project_bin)

MODULES = [pairwise_l2, diameter, flash_attention, project_bin]


@pytest.mark.parametrize("mod", MODULES, ids=lambda m: m.__name__)
def test_library_binds_once_under_threads(monkeypatch, mod):
    calls = []
    sentinel = object()

    def slow_bind():
        calls.append(threading.get_ident())
        time.sleep(0.05)            # a build in flight while others ask
        return sentinel

    monkeypatch.setattr(build, "_LOADED", {})
    monkeypatch.setattr(mod, "_bind", slow_bind)
    start = threading.Barrier(8)
    got = []

    def ask():
        start.wait()
        got.append(mod.library())

    threads = [threading.Thread(target=ask) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert len(calls) == 1
    assert got == [sentinel] * 8


def test_launch_counts_are_exact_under_threads():
    """8 threads adding to one counter 20,000 times each, with the
    interpreter switching threads as often as it can: nothing is lost, and
    a reset from another thread leaves every count at 0."""
    import sys
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        table = {"a": 0, "b": 0}
        start = threading.Barrier(8)

        def add(name, n):
            start.wait()
            for _ in range(20_000):
                build.count(table, name, n)

        threads = [threading.Thread(target=add, args=("a" if i % 2 else "b",
                                                      1 + i % 2))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(switch)
    assert table == {"a": 4 * 20_000 * 2, "b": 4 * 20_000}
    build.reset(table)
    assert table == {"a": 0, "b": 0}


@pytest.mark.parametrize("mod", MODULES, ids=lambda m: m.__name__)
def test_reset_launches_zeroes_every_count(mod):
    saved = dict(mod.launches)
    try:
        for name in mod.launches:
            build.count(mod.launches, name, 3)
        mod.reset_launches()
        assert set(mod.launches.values()) == {0}
    finally:
        mod.launches.update(saved)
