"""On the card only: one short run of each cell through the CLI, whose
last line must be a correct result. Skips (inside the test) without a
CUDA device. Run there: ``python -m pytest -m cuda nksbench/tests``."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch
from conftest import BATCH, ROOT, STREAM


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [STREAM, BATCH])
def test_short_run_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run(
        [sys.executable, "nksbench/run.py", "--workload", workload, "--seed",
         str(2**31 + 3), "--seconds", "3", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["failed"] == 0, out["checks"]
    assert out["device"]["platform"] == "gpu"
