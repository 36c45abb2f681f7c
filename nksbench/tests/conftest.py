"""Puts the harness (``nksbench/``) and the program (``src/``) on the path
and gives the tests cells cut to a size the CPU holds.

Run: ``PYTHONPATH=src python -m pytest -q nksbench/tests``."""
from __future__ import annotations

import copy
import dataclasses
import pathlib
import sys

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

STREAM = "synth10m-d100.stream.q9k10"
BATCH = "flickr1m-d64.batch.tags-q3k1"


def small_cell(workload: str, n: int = 20_000):
    """The cell with its corpus cut to ``n`` points (the synthetic one's
    dictionary to 100, so that groups keep about 200 points) and an open
    loop's rate to 20 a second, its check sample to 16."""
    from harness.spec import cell, load_bench

    c = cell(load_bench(ROOT), workload)
    config, mix = copy.deepcopy(c.config), copy.deepcopy(c.mix)
    config["corpus"]["n"] = n
    if config["corpus"]["generator"] == "synthetic":
        config["corpus"]["u"] = 100
    if mix["loop"] == "open":
        mix["arrivals"]["rate_qps"] = 20.0
        mix["check_sample"] = 16
    return dataclasses.replace(c, config=config, mix=mix)
