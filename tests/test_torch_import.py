"""The port stands alone: it runs with JAX blocked and names nothing of the
reference package or of JAX in its sources or in ``chip_smoke.py``."""
import os
import pathlib
import re
import subprocess
import sys
import textwrap

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_cpu_query_batch_runs_with_jax_blocked():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None          # any import of jax now fails
        import torch
        torch.set_num_threads(1)
        from repro_torch import NKSEngine, flickr_like_dataset, random_queries
        ds = flickr_like_dataset(n=300, d=8, u=20, t=3, seed=1)
        engine = NKSEngine(ds, device="cpu")
        queries = random_queries(ds, 3, 4, seed=2)
        for tier in ("exact", "approx"):
            out = engine.query_batch(queries, k=2, tier=tier)
            assert len(out) == 4 and all(r.candidates for r in out)
        loaded = [m for m in sys.modules
                  if m == "repro" or m.startswith(("repro.", "jax"))]
        assert loaded == ["jax"], loaded      # only the blocking sentinel
        print("ok")
        """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_port_sources_name_no_reference_or_jax():
    pattern = re.compile(r"\brepro\.|jax", re.IGNORECASE)
    files = [p for p in (ROOT / "src" / "repro_torch").rglob("*")
             if p.is_file() and p.suffix in (".py", ".cu", ".cuh", ".h")]
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    offenders = [f"{p.relative_to(ROOT)}:{i}"
                 for p in files
                 for i, line in enumerate(p.read_text().splitlines(), 1)
                 if pattern.search(line)]
    assert not offenders, offenders
