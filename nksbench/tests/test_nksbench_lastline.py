"""The result line's contract, on the CPU at a small size (``run_cell``
skips the look for a chip), and the CLI's refusal without a card."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest
from conftest import BATCH, ROOT, STREAM, small_cell

from harness.bench import forbidden_modules, run_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", [STREAM, BATCH])
def test_result_line(workload, trace):
    c = small_cell(workload)
    out = run_cell(c, 2**31 + 7, 2.0, bool(trace), device="cpu")
    host = out.pop("host")          # run.py prints it on standard error
    assert host["queries"] > 0 and host["window_s"] > 0
    back = json.loads(json.dumps(out))
    keys = list(back)
    assert keys[:5] == KEYS and keys[-1] == "checks"
    assert set(keys) <= set(KEYS) | {"breakdown", "checks"}
    assert back["correct"] is True
    assert back["failed"] == 0 and back["attempted"] > 0
    want = {m["name"]: m["unit"] for m in c.metrics(bool(trace))}
    for name, m in back["metrics"].items():
        assert want[name] == m["unit"] and isinstance(m["value"], float)
    if not trace:
        # end to end: all of the cell's, taken by the harness itself
        assert set(back["metrics"]) == set(want)
        assert back["metrics"]["setup_s"]["value"] > 0
    else:
        # the host's spans are there; the device's need a card
        assert any(n.startswith("pack_ms") for n in back["metrics"])
    dev = back["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    for name, c_ in back["checks"].items():
        assert set(c_) == {"value", "limit"} and c_["value"] <= c_["limit"]


def test_cli_refuses_without_a_card():
    proc = subprocess.run(
        [sys.executable, "nksbench/run.py", "--workload", STREAM, "--seed",
         "5", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 2
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch.x", object())
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro", object())
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert forbidden_modules() == ["jax", "repro"]
