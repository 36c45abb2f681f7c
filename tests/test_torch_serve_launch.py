"""The port's JSONL launcher (``repro_torch.launch.serve``) on the CPU.

The counterparts of the reference's ``tests/test_serve_errors.py`` (a bad
request yields a structured error envelope and the stream survives, in the
synchronous loop and through the runtime), then ``handle_request`` held
against the reference's for every op on the same seeded corpus (the JSON
responses equal, timing fields apart), and ``main()`` run as a subprocess
with ``--device cpu`` and JAX blocked.
"""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.data.synthetic import attach_attrs as ref_attach_attrs
from repro.data.synthetic import synthetic_tenants as ref_tenants
from repro.launch import serve as ref_serve
from repro.serve.engine import NKSEngine as RefEngine
from repro_torch.data.synthetic import attach_attrs, synthetic_tenants
from repro_torch.launch.serve import (handle_request, handle_request_safe,
                                      serve_with_runtime)
from repro_torch.serve.engine import NKSEngine
from repro_torch.serve.runtime import RuntimeConfig, ServingRuntime

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _tenanted(pkg_attach, pkg_tenants):
    return pkg_attach(pkg_tenants({"acme": 120, "globex": 80}, d=4, u=16,
                                  t=2, seed=2), seed=2)


@pytest.fixture(scope="module")
def engine():
    return NKSEngine(_tenanted(attach_attrs, synthetic_tenants), seed=1,
                     compact_min=10_000, device="cpu")


BAD_REQUESTS = [
    # (request, expected op in envelope, error fragment)
    ({"__parse_error__": "malformed JSON: boom"}, "parse", "malformed"),
    ("not a dict", "parse", "JSON object"),
    ({"op": "frobnicate"}, "frobnicate", "unknown op"),
    ({"op": "query"}, "query", "keywords"),                  # missing field
    ({"keywords": [99999]}, "query", ""),                    # out-of-dict kw
    # attrs schema mismatch: corpus has price+category, insert omits one
    ({"op": "insert", "points": [[0.0] * 4], "keywords": [[0]],
      "attrs": {"price": [1.0]}, "tenant": "acme"}, "insert", ""),
    # tenant-unknown keyword: local id beyond the tenant's namespace
    ({"op": "insert", "points": [[0.0] * 4], "keywords": [[4000]],
      "tenant": "acme"}, "insert", ""),
    # unknown tenant name
    ({"op": "insert", "points": [[0.0] * 4], "keywords": [[0]],
      "tenant": "hooli"}, "insert", ""),
    # snapshot without a WAL attached
    ({"op": "snapshot"}, "snapshot", "WAL"),
]

GOOD = {"keywords": [0, 1], "k": 1, "filter": {"tenant": "acme"}}


def _check_envelope(out, op, frag):
    assert out.get("status", "ok") == "error" or "error" in out
    assert out["op"] == op
    assert frag.lower() in out["error"].lower()


def test_sync_loop_survives_every_bad_request(engine):
    for req, op, frag in BAD_REQUESTS:
        out = handle_request_safe(engine, req, tier="exact", k=1)
        _check_envelope(out, op, frag)
        # the stream is alive: a good request right after still answers
        ok = handle_request_safe(engine, GOOD, tier="exact", k=1)
        assert "error" not in ok and ok["results"]


def test_runtime_loop_survives_every_bad_request(engine):
    reqs = []
    for req, _, _ in BAD_REQUESTS:
        reqs.append(req)
        reqs.append(GOOD)
    rt = ServingRuntime(engine, RuntimeConfig(batch_window_s=0.0))
    try:
        outs = list(serve_with_runtime(rt, engine, reqs, tier="exact", k=1))
    finally:
        rt.close()
    assert len(outs) == len(reqs)
    for i, (_, op, frag) in enumerate(BAD_REQUESTS):
        _check_envelope(outs[2 * i], op, frag)
        assert "error" not in outs[2 * i + 1] and outs[2 * i + 1]["results"]
    # no bad request crashed the runtime itself
    assert not rt.health()["crashed"]


def _strip(out):
    return {k: v for k, v in out.items() if k != "latency_ms"}


def test_sync_and_runtime_answers_agree(engine):
    """The two serving paths format identical results for the same stream
    (modulo latency), including tenant-resolved inserts."""
    rng = np.random.default_rng(8)
    stream = [
        {"keywords": [0, 1], "k": 2, "filter": {"tenant": "acme"}},
        {"op": "insert",
         "points": rng.standard_normal((3, 4)).astype(np.float32).tolist(),
         "keywords": [[0, 1]] * 3,
         "attrs": {"price": [1.0, 2.0, 3.0], "category": [0, 1, 0]},
         "tenant": "acme"},
        {"keywords": [0, 1], "k": 3, "filter": {"tenant": "acme"}},
        {"op": "delete", "ids": [0]},
        {"keywords": [0, 1], "k": 3, "filter": {"tenant": "acme"}},
        {"op": "health"},
    ]
    ds = engine.dataset
    sync_eng = NKSEngine(ds, seed=1, compact_min=10_000, device="cpu")
    sync = [_strip(handle_request_safe(sync_eng, r, tier="exact", k=1))
            for r in stream]
    rt_eng = NKSEngine(ds, seed=1, compact_min=10_000, device="cpu")
    rt = ServingRuntime(rt_eng, RuntimeConfig(batch_window_s=0.0))
    try:
        asynchronous = [_strip(o) for o in
                        serve_with_runtime(rt, rt_eng, stream,
                                           tier="exact", k=1)]
    finally:
        rt.close()
    # health payloads legitimately differ (queue stats); compare the rest.
    for s, a in zip(sync[:-1], asynchronous[:-1]):
        assert s == a
    assert asynchronous[-1]["op"] == "health"
    assert asynchronous[-1]["generation"] == sync[-1]["generation"]


# ------------------------------------------------ against the reference's
def _ops_stream():
    """Every op the launcher speaks, in an order that exercises each:
    queries (a tenant filter, a tenant filter with an attribute predicate,
    boosts and m-of-k with scoring, the device tier), an attributed tenant
    insert, a delete, health, a compaction, a snapshot, a malformed line and
    an unknown op."""
    rng = np.random.default_rng(5)
    return [
        {"keywords": [0, 1], "k": 2, "filter": {"tenant": "acme"}},
        {"keywords": [1, 3], "k": 2, "filter": {
            "tenant": "globex", "where": [["price", "<", 50.0]]}},
        {"keywords": ["2", "5^4", 7], "k": 2, "m": 2, "score": True,
         "tier": "approx"},
        {"keywords": [0, 2], "k": 1, "weights": {"0": 3.0}},
        {"keywords": [4, 9], "k": 2, "tier": "device"},
        {"op": "insert",
         "points": rng.standard_normal((4, 4)).astype(np.float32).tolist(),
         "keywords": [[0, 1], [1, 2], [0, 3], [2]],
         "attrs": {"price": [5.0, 15.0, 55.0, 95.0],
                   "category": [1, 2, 3, 4]},
         "tenant": "acme"},
        {"keywords": [0, 1], "k": 3, "filter": {"tenant": "acme"}},
        {"op": "delete", "ids": [0, 3, 201]},
        {"keywords": [0, 1], "k": 3, "filter": {"tenant": "acme"}},
        {"op": "health"},
        {"op": "compact"},
        {"keywords": [0, 1], "k": 3, "filter": {"tenant": "acme"}},
        {"op": "snapshot"},
        {"__parse_error__": "malformed JSON: boom"},
        {"op": "frobnicate"},
    ]


@pytest.mark.parametrize("wal", [False, True])
def test_handle_request_equals_reference(tmp_path, wal):
    """Each op through the port's ``handle_request_safe`` and through the
    reference's, on engines over the same seeded corpus: the responses are
    equal, the latency field apart. (The device tier is an fp32 search on
    both sides and must agree in ids and in the rounded diameter.)"""
    port = NKSEngine(_tenanted(attach_attrs, synthetic_tenants), seed=1,
                     compact_min=10_000, device="cpu")
    ref = RefEngine(_tenanted(ref_attach_attrs, ref_tenants), seed=1,
                    compact_min=10_000)
    if wal:
        port.attach_wal(str(tmp_path / "port"))
        ref.attach_wal(str(tmp_path / "ref"))
    for req in _ops_stream():
        mine = handle_request_safe(port, req, tier="exact", k=1)
        theirs = ref_serve.handle_request_safe(ref, req, tier="exact", k=1)
        if req.get("op") == "snapshot" and wal:
            # each engine names its own root
            assert mine.pop("snapshot").startswith(str(tmp_path / "port"))
            assert theirs.pop("snapshot").startswith(str(tmp_path / "ref"))
        assert _strip(mine) == _strip(theirs), req
        if req.get("op") == "snapshot" and not wal:
            assert mine["status"] == "error"
    assert handle_request(port, {"op": "health"}, tier="exact", k=1) \
        == ref_serve.handle_request(ref, {"op": "health"}, tier="exact", k=1)


def _write_requests(path, queries):
    rng = np.random.default_rng(0)
    lines = [json.dumps({"keywords": q, "k": 1}) for q in queries]
    for _ in range(2):
        lines.append(json.dumps({
            "op": "insert",
            "points": rng.standard_normal((3, 8)).astype(np.float32).tolist(),
            "keywords": [[0, 1]] * 3,
            "attrs": {"price": [1.0, 2.0, 3.0], "category": [0, 1, 2]}}))
    lines += [json.dumps({"op": "delete", "ids": [5]}),
              json.dumps({"op": "health"}),
              json.dumps({"op": "snapshot"}),
              "{not json",
              json.dumps({"keywords": queries[0], "k": 1})]
    path.write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("runtime", [False, True])
def test_main_runs_with_jax_blocked(tmp_path, runtime):
    """``python -m repro_torch.launch.serve --device cpu`` at a small
    ``--n``, with 40 documents through the ingest pipeline first and JAX
    blocked: exit 0, every line parses, the malformed line gets an error
    envelope, and the first answers equal those of an in-process engine
    over the corpus the launcher builds, fed the same documents by the same
    pipeline (one worker: the documents land in job order, so their
    external ids agree)."""
    import argparse
    from repro_torch.data.flickr_like import flickr_like_dataset
    from repro_torch.data.synthetic import random_queries
    from repro_torch.launch.serve import _run_ingest_pipeline
    ds = attach_attrs(flickr_like_dataset(n=400, d=8, u=30, t=3, seed=0),
                      seed=0)
    queries = random_queries(ds, 3, 6, seed=4)
    reqs = tmp_path / "reqs.jsonl"
    _write_requests(reqs, queries)
    args = ["--n", "400", "--d", "8", "--u", "30", "--t", "3", "--attrs",
            "--tier", "exact", "--device", "cpu", "--requests", str(reqs),
            "--wal", str(tmp_path / "wal"), "--ingest-docs", "40",
            "--ingest-workers", "1", "--ingest-jobs", str(tmp_path / "jobs")]
    if runtime:
        args.append("--runtime")
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        import torch
        torch.set_num_threads(1)
        from repro_torch.launch.serve import main
        main({args!r})
        loaded = [m for m in sys.modules
                  if m == "repro" or m.startswith(("repro.", "jax"))]
        assert loaded == ["jax"], loaded
        """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               TMPDIR=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    outs = [json.loads(line) for line in proc.stdout.splitlines()]
    n_q = len(queries)
    assert [o["op"] for o in outs] == ["query"] * n_q + [
        "insert", "insert", "delete", "health", "snapshot", "parse", "query"]
    assert "device=cpu" in proc.stderr
    assert "ingest: 40 docs" in proc.stderr and "failed=0" in proc.stderr
    assert outs[n_q + 5]["status"] == "error"
    assert "malformed" in outs[n_q + 5]["error"]
    assert all("error" not in o for i, o in enumerate(outs) if i != n_q + 5)
    assert outs[n_q]["ids"] == [440, 441, 442]
    health = outs[n_q + 3]
    assert health["wal_attached"] is True
    assert ("stats" in health) if runtime else (health["runtime"] is False)
    engine = NKSEngine(ds, build_approx=False, compact_ratio=0.25,
                       compact_min=4096, device="cpu")
    report = _run_ingest_pipeline(engine, ds, argparse.Namespace(
        ingest_docs=40, u=30, t=3, ingest_workers=1,
        ingest_jobs=str(tmp_path / "jobs-in-process")))
    assert report["docs_done"] == 40 and engine.next_external_id == 440
    for q, out in zip(queries, outs):
        want = handle_request(engine, {"keywords": q, "k": 1},
                              tier="exact", k=1)
        assert out["keywords"] == want["keywords"]
        assert out["results"] == want["results"], q
