"""The port's examples (``examples/torch/``) run on the CPU with JAX
blocked, through their ``--device cpu`` flag."""
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("script, argv, expect", [
    ("quickstart.py", ["--device", "cpu", "--n", "1000"],
     "answers equal the direct batch"),
    ("ingest_corpus.py", ["--device", "cpu"], "(matches static build)"),
    ("distributed_serve.py", ["--device", "cpu", "--n", "3000"],
     "answers equal the single-device engine's"),
    ("train_embedder.py", ["--device", "cpu", "--steps", "4"],
     "NKS query [0, 1] -> ids="),
])
def test_example_runs_with_jax_blocked(tmp_path, script, argv, expect):
    path = ROOT / "examples" / "torch" / script
    code = textwrap.dedent(f"""
        import runpy
        import sys
        sys.modules["jax"] = None          # any import of jax now fails
        import torch
        torch.set_num_threads(1)
        sys.argv = [{str(path)!r}, *{argv!r}]
        runpy.run_path(sys.argv[0], run_name="__main__")
        loaded = [m for m in sys.modules
                  if m == "repro" or m.startswith(("repro.", "jax"))]
        assert loaded == ["jax"], loaded
        """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               TMPDIR=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert expect in proc.stdout
