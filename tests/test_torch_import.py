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
    """A CPU query batch in every tier and a smoke embed-and-ingest, with
    JAX blocked."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None          # any import of jax now fails
        import torch
        torch.set_num_threads(1)
        from repro_torch import NKSEngine, flickr_like_dataset, random_queries
        ds = flickr_like_dataset(n=300, d=8, u=20, t=3, seed=1)
        engine = NKSEngine(ds, device="cpu")
        queries = random_queries(ds, 3, 4, seed=2)
        for tier in ("exact", "approx", "device"):
            out = engine.query_batch(queries, k=2, tier=tier)
            assert len(out) == 4 and all(r.candidates for r in out)
        assert engine.build_stats.k5_launches == 5
        more = flickr_like_dataset(n=40, d=8, u=20, t=3, seed=3)
        ext = engine.insert(more.points, [more.kw.row(i).tolist()
                                          for i in range(more.n)])
        engine.delete([0, int(ext[0])])
        assert engine.query_batch(queries, k=2, tier="exact")[0].candidates
        assert engine.compact() and engine.corpus_generation == 1
        from repro_torch.configs import get_config
        from repro_torch.models.api import model_api
        cfg = get_config("minicpm-2b").smoke()
        api = model_api(cfg)
        params = api.init(torch.Generator().manual_seed(0), device="cpu")
        gen = torch.Generator().manual_seed(1)
        batches = [{"tokens": torch.randint(0, cfg.vocab_size, (4, 12),
                                            generator=gen)}
                   for _ in range(2)]
        emb = api.embed(params, batches[0])
        assert emb.shape == (4, cfg.d_model)
        assert bool(torch.isfinite(emb.float()).all())
        tagged = NKSEngine.ingest_embeddings(
            api, params, batches, [[i % 3, 3] for i in range(8)],
            device="cpu", n_scales=3)
        assert tagged.query_batch([[0, 3]], k=1)[0].candidates
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
