"""Production NKS serving launcher: build/ingest a corpus, start the batched
engine, answer queries from a JSONL request stream (or a built-in demo).

    PYTHONPATH=src python -m repro_torch.launch.serve --n 20000 --d 32 \
        --tier approx --queries 10

The engine runs on the CUDA card (its build through K5, exact and approx
batches through the join kernels, the device tier through the anchor-star
kernel); ``--device cpu`` runs the kernels' plain PyTorch versions on the
host instead. With no card and no ``--device`` it raises.

The request stream is one JSON object per line. ``op`` selects the action
(default ``query``), so a single stream can interleave serving and ingest —
the streaming consistency model (README "Streaming ingest") applies: each
response reflects every earlier op in the stream, never a partial batch.

    {"keywords": [3, 7], "k": 2}                          # query (default op)
    {"keywords": ["3", "7^4"], "m": 1, "score": true}     # flexible semantics
    {"keywords": [3, 7], "filter": {"where": [["price", "<", 50]]}}
    {"keywords": [0, 2], "filter": {"tenant": "acme"}}    # tenant-local kws
    {"op": "insert", "points": [[...]], "keywords": [[...]],
     "attrs": {"price": [...]}, "tenant": "acme"}
    {"op": "delete", "ids": [12, 904]}
    {"op": "compact"}
    {"op": "health"}                                      # runtime/engine state
    {"op": "snapshot"}                                    # requires --wal

A malformed line or failing op never kills the stream: each bad request gets
a structured ``{"op": ..., "error": ..., "status": "error"}`` response and
serving continues.

Flexible query semantics (README "Query semantics") ride on the query op:
a ``keywords`` entry may be a ``"<id>^<weight>"`` boost string (merged with
an explicit ``weights`` object — the inline boost wins on conflict), ``m``
asks for m-of-k partial coverage, and ``score``/``alpha`` switch ranking to
the blended coverage/cost score — scored result rows gain a ``score`` field.

``filter`` applies attribute predicates (grammar: ``[attr, op, value]``
clauses, op in ``< <= > >= == != in between``, conjunction) and tenant
scoping — on a namespaced corpus (``--tenants``) a tenant-scoped query
speaks tenant-local keyword ids. ``--attrs`` attaches synthetic
price/category columns to the demo corpus so filtered requests work out of
the box; inserts must then carry matching ``attrs`` (and ``tenant`` on a
multi-tenant corpus).

``--runtime`` routes requests through the fault-tolerant async runtime
(``serve.runtime``): consecutive queries are admitted together and coalesced
into batched dispatches; ingest ops are awaited before later requests are
admitted, preserving the stream contract. Responses gain ``degraded: true``
when overload shed an exact request to the approx tier. ``--wal DIR``
attaches the crash-recovery write-ahead log — every ingest ack is then
durable (README "Serving runtime").

Insert responses carry the assigned stable external ids; every ingest
response reports the engine's generation/delta/tombstone state. Compaction
also runs automatically at the ``--compact-ratio`` / ``--compact-min``
cadence (off-thread under ``--runtime``).
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from repro_torch.core.semantics import parse_weighted_keywords
from repro_torch.data.flickr_like import flickr_like_dataset
from repro_torch.data.synthetic import random_queries, synthetic_dataset
from repro_torch.serve.engine import NKSEngine


def _ingest_state(engine: NKSEngine) -> dict:
    return {
        "generation": engine.corpus_generation,
        "delta_points": engine.delta_points,
        "tombstones": engine.tombstone_count,
        "compactions": engine.ingest.compactions,
    }


def _resolve_insert_keywords(engine: NKSEngine, req: dict) -> list:
    """Tenant-LOCAL keyword ids -> global dictionary slots (same convention
    as tenant-scoped queries), so an inserted point is reachable by the very
    queries its tenant will issue and can never land in another tenant's
    namespace. Per-point tenant lists resolve per row."""
    keywords = req["keywords"]
    tenant = req.get("tenant")
    ns = getattr(engine.dataset, "tenants", None)
    if tenant is None or ns is None:
        return keywords
    if isinstance(tenant, (list, tuple)):
        return [ns.resolve(t, ks) for t, ks in zip(tenant, keywords)]
    return [ns.resolve(tenant, ks) for ks in keywords]


def _parse_query_semantics(req: dict) -> tuple[list[int], dict | None]:
    """Keyword ids plus the request's semantics wire-dict (or None for a
    classic request). ``keywords`` entries may use the ``"7^4"`` boost
    grammar; inline boosts merge over an explicit ``weights`` object and win
    on conflict. Validation happens in ``QuerySemantics.coerce`` downstream."""
    kws, boosts = parse_weighted_keywords(req["keywords"])
    weights = {int(kw): float(w)
               for kw, w in (req.get("weights") or {}).items()}
    weights.update(boosts)
    sem: dict = {}
    if req.get("m") is not None:
        sem["m"] = int(req["m"])
    if weights:
        sem["weights"] = weights
    if req.get("score"):
        sem["score"] = True
    if req.get("alpha") is not None:
        sem["alpha"] = float(req["alpha"])
    return kws, (sem or None)


def _result_row(c) -> dict:
    row = {"ids": list(c.ids), "diameter": round(c.diameter, 4)}
    if c.score is not None:
        row["score"] = round(c.score, 6)
    return row


def handle_request(engine: NKSEngine, req: dict, *, tier: str, k: int) -> dict:
    """Execute one JSONL op against the engine; returns the JSON response.

    Raises on a bad request — the serving loop wraps this in
    :func:`handle_request_safe` to produce error envelopes instead."""
    op = req.get("op", "query")
    if op == "query":
        kws, sem = _parse_query_semantics(req)
        res = engine.query(kws, k=req.get("k", k),
                           tier=req.get("tier", tier),
                           filter=req.get("filter"), semantics=sem)
        out = {
            "op": "query",
            "keywords": kws,
            "latency_ms": round(res.latency_s * 1e3, 2),
            "results": [_result_row(c) for c in res.candidates],
        }
        if req.get("filter"):
            out["filter"] = req["filter"]
        return out
    if op == "insert":
        pts = np.asarray(req["points"], dtype=np.float32)
        attrs = {name: np.asarray(col)
                 for name, col in (req.get("attrs") or {}).items()} or None
        keywords = _resolve_insert_keywords(engine, req)
        ids = engine.insert(pts, keywords, attrs=attrs,
                            tenant=req.get("tenant"))
        return {"op": "insert", "ids": [int(i) for i in ids],
                **_ingest_state(engine)}
    if op == "delete":
        n = engine.delete(req["ids"])
        return {"op": "delete", "deleted": n, **_ingest_state(engine)}
    if op == "compact":
        ran = engine.compact()
        return {"op": "compact", "compacted": ran, **_ingest_state(engine)}
    if op == "snapshot":
        return {"op": "snapshot", "snapshot": engine.snapshot(),
                **_ingest_state(engine)}
    if op == "health":
        # Synchronous loop: no queue, never degraded.
        return {"op": "health", "queue_depth": 0, "degraded": False,
                "runtime": False,
                "wal_attached": engine.wal_stats is not None,
                **_ingest_state(engine)}
    raise ValueError(f"unknown op: {op!r}")


def handle_request_safe(engine: NKSEngine, req, *, tier: str, k: int) -> dict:
    """One request in, one response out — errors become structured envelopes
    so a malformed request can never kill the stream."""
    if isinstance(req, dict) and "__parse_error__" in req:
        return {"op": "parse", "status": "error",
                "error": req["__parse_error__"]}
    if not isinstance(req, dict):
        return {"op": "parse", "status": "error",
                "error": f"request must be a JSON object, got "
                         f"{type(req).__name__}"}
    try:
        return handle_request(engine, req, tier=tier, k=k)
    except Exception as e:
        return {"op": str(req.get("op", "query")), "status": "error",
                "error": f"{type(e).__name__}: {e}"}


# ---------------------------------------------------------------- runtime path
def _to_runtime_request(engine: NKSEngine, req: dict, *, tier: str,
                        k: int) -> dict:
    """Validate/convert a JSONL request into the runtime's structured form
    (raises on a malformed request — caller wraps)."""
    op = req.get("op", "query")
    if op == "query":
        kws, sem = _parse_query_semantics(req)
        return {"op": "query", "keywords": kws,
                "k": int(req.get("k", k)), "tier": req.get("tier", tier),
                "filter": req.get("filter"), "semantics": sem}
    if op == "insert":
        attrs = {name: np.asarray(col)
                 for name, col in (req.get("attrs") or {}).items()} or None
        return {"op": "insert",
                "points": np.asarray(req["points"], dtype=np.float32),
                "keywords": _resolve_insert_keywords(engine, req),
                "attrs": attrs, "tenant": req.get("tenant")}
    if op == "delete":
        return {"op": "delete", "ids": req["ids"]}
    if op in ("compact", "snapshot", "health"):
        return {"op": op}
    raise ValueError(f"unknown op: {op!r}")


def _format_runtime_response(req: dict, resp) -> dict:
    if resp.status != "ok":
        return {"op": resp.op, "status": resp.status, "error": resp.error}
    if resp.op == "query":
        out = {
            "op": "query",
            "keywords": parse_weighted_keywords(req["keywords"])[0],
            "latency_ms": round(resp.latency_s * 1e3, 2),
            "results": [_result_row(c) for c in resp.payload["candidates"]],
        }
        if resp.degraded:
            out["degraded"] = True
            out["tier"] = resp.tier
        if req.get("filter"):
            out["filter"] = req["filter"]
        return out
    return {"op": resp.op, **resp.payload}


def serve_with_runtime(runtime, engine: NKSEngine, reqs, *, tier: str, k: int):
    """Drive the async runtime while preserving the JSONL stream contract:
    runs of consecutive queries are admitted together (so they coalesce into
    batched dispatches); an ingest op is awaited before anything later is
    admitted (its ack orders the stream). Yields one response dict per
    request, in request order."""
    def flush(window):
        for raw, ticket in window:
            if ticket is None:        # conversion failed; raw is the envelope
                yield raw
            else:
                yield _format_runtime_response(raw, ticket.result())
    window: list = []
    for req in reqs:
        envelope = None
        rt_req = None
        if isinstance(req, dict) and "__parse_error__" in req:
            envelope = {"op": "parse", "status": "error",
                        "error": req["__parse_error__"]}
        elif not isinstance(req, dict):
            envelope = {"op": "parse", "status": "error",
                        "error": f"request must be a JSON object, got "
                                 f"{type(req).__name__}"}
        else:
            try:
                rt_req = _to_runtime_request(engine, req, tier=tier, k=k)
            except Exception as e:
                envelope = {"op": str(req.get("op", "query")),
                            "status": "error",
                            "error": f"{type(e).__name__}: {e}"}
        if envelope is not None:
            window.append((envelope, None))
            continue
        if rt_req["op"] == "query":
            window.append((req, runtime.submit(rt_req)))
            continue
        # Ingest/health: drain queries first, then await the op's ack before
        # admitting anything later.
        yield from flush(window)
        window = []
        yield _format_runtime_response(req, runtime.submit(rt_req).result())
    yield from flush(window)


def _run_ingest_pipeline(target, ds, args) -> dict:
    """Drive ``--ingest-docs`` raw documents through the job-queue pipeline
    into ``target`` (engine, or runtime under ``--runtime``). Documents are
    ``flickr_like`` payloads matched to the serving corpus: same point dim,
    same (per-tenant) dictionary size, attrs iff the corpus has them."""
    import os
    import tempfile

    from repro_torch.data.ingest import (IngestPipeline, JobStore,
                                         ProjectionEmbedder,
                                         flickr_like_documents)
    tenanted = ds.tenants is not None
    u = args.u if tenanted else ds.n_keywords
    d_raw = 4 * ds.dim
    docs, vocab = flickr_like_documents(
        args.ingest_docs, d_raw=d_raw, u=u, t=args.t, seed=11,
        tenants=list(ds.tenants.names) if tenanted else None,
        with_attrs=bool(ds.attrs))
    embedder = ProjectionEmbedder(ds.dim, vocab, d_raw=d_raw, seed=11)
    root = args.ingest_jobs or tempfile.mkdtemp(prefix="nks-ingest-")
    os.makedirs(root, exist_ok=True)
    store = JobStore(os.path.join(root, "jobs.jsonl"))
    pipe = IngestPipeline(store, target, embedder,
                          workers=args.ingest_workers)
    outcome = pipe.recover()          # resolve a prior run's open intent
    if outcome:
        print(f"ingest: recovered open intent -> {outcome}", file=sys.stderr)
    store.add(docs)
    report = pipe.run(timeout_s=max(120.0, args.ingest_docs / 50.0))
    store.close()
    print(f"ingest: {report['docs_done']} docs in {report['wall_s']:.2f}s "
          f"({report['docs_per_s']:.0f} docs/s, "
          f"retries={report['retries']} reclaims={report['reclaims']} "
          f"failed={report['docs_failed']}) jobs={root}", file=sys.stderr)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20_000)
    ap.add_argument("--d", type=int, default=32)
    ap.add_argument("--u", type=int, default=300)
    ap.add_argument("--t", type=int, default=4)
    ap.add_argument("--corpus", choices=["flickr", "uniform"], default="flickr")
    ap.add_argument("--tier", choices=["exact", "approx", "device"],
                    default="approx")
    ap.add_argument("--k", type=int, default=1)
    ap.add_argument("--queries", type=int, default=10,
                    help="demo random queries (ignored with --requests)")
    ap.add_argument("--requests", default=None,
                    help="JSONL file: {\"op\": ..., \"keywords\": [..], ...}")
    ap.add_argument("--compact-ratio", type=float, default=0.25,
                    help="auto-compact once delta+tombstones exceed this "
                         "fraction of the bulk corpus")
    ap.add_argument("--compact-min", type=int, default=4096,
                    help="minimum churn before auto-compaction triggers")
    ap.add_argument("--attrs", action="store_true",
                    help="attach synthetic price/category attribute columns "
                         "(enables filtered requests)")
    ap.add_argument("--tenants", type=int, default=0,
                    help="build a multi-tenant corpus with this many tenants "
                         "(t0, t1, ...), each with a private keyword "
                         "namespace of size --u; implies --attrs")
    ap.add_argument("--runtime", action="store_true",
                    help="serve through the async fault-tolerant runtime "
                         "(admission queue, coalesced batches, off-thread "
                         "compaction)")
    ap.add_argument("--max-queue", type=int, default=256,
                    help="runtime admission-queue bound (backpressure past "
                         "it)")
    ap.add_argument("--max-batch", type=int, default=32,
                    help="runtime coalesced query batch cap")
    ap.add_argument("--batch-window-ms", type=float, default=2.0,
                    help="runtime coalescing window for a young batch head")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="default per-request deadline (expired requests get "
                         "a timeout response)")
    ap.add_argument("--wal", default=None, metavar="DIR",
                    help="attach a write-ahead log rooted here: every ingest "
                         "ack becomes durable; recover with "
                         "NKSEngine.recover(DIR)")
    ap.add_argument("--ingest-docs", type=int, default=0,
                    help="before serving, run this many flickr_like raw "
                         "documents through the ingestion job pipeline "
                         "(data/ingest.py) into the engine — through the "
                         "admission queue under --runtime, so pipeline "
                         "batches coalesce with other ingest")
    ap.add_argument("--ingest-workers", type=int, default=2,
                    help="ingestion pipeline worker threads")
    ap.add_argument("--ingest-jobs", default=None, metavar="DIR",
                    help="persist the ingestion job journal here (reopening "
                         "resumes unfinished jobs); default: a temp dir")
    ap.add_argument("--device", default=None,
                    help="torch device of the engine (default: the CUDA "
                         "card; 'cpu' runs the kernels' plain versions)")
    args = ap.parse_args(argv)

    if args.tenants:
        from repro_torch.data.synthetic import synthetic_tenants
        per = max(args.n // args.tenants, 1)
        ds = synthetic_tenants({f"t{i}": per for i in range(args.tenants)},
                               d=args.d, u=args.u, t=args.t, seed=0)
    elif args.corpus == "flickr":
        ds = flickr_like_dataset(n=args.n, d=args.d, u=args.u, t=args.t, seed=0)
    else:
        ds = synthetic_dataset(n=args.n, d=args.d, u=args.u, t=args.t, seed=0)
    if args.attrs and not args.tenants:
        from repro_torch.data.synthetic import attach_attrs
        ds = attach_attrs(ds, seed=0)
    engine = NKSEngine(ds, build_exact=(args.tier == "exact"),
                       build_approx=(args.tier != "exact"),
                       compact_ratio=args.compact_ratio,
                       compact_min=args.compact_min, device=args.device)
    if args.wal:
        engine.attach_wal(args.wal)
    print(f"serving: corpus N={ds.n} d={ds.dim} U={ds.n_keywords} "
          f"tier={args.tier} device={engine.device}"
          + (f" wal={args.wal}" if args.wal else "")
          + (" runtime=async" if args.runtime else ""), file=sys.stderr)

    if args.requests:
        reqs = []
        for line in open(args.requests):
            if not line.strip():
                continue
            try:
                reqs.append(json.loads(line))
            except json.JSONDecodeError as e:
                reqs.append({"__parse_error__": f"malformed JSON: {e}"})
    else:
        reqs = [{"keywords": q, "k": args.k} for q in
                random_queries(ds, 3, args.queries, seed=1)]

    if args.runtime:
        from repro_torch.serve.runtime import RuntimeConfig, ServingRuntime
        runtime = ServingRuntime(engine, RuntimeConfig(
            max_queue=args.max_queue, max_batch=args.max_batch,
            batch_window_s=args.batch_window_ms / 1e3,
            default_deadline_s=args.deadline_s,
            tier=args.tier, k=args.k))
        try:
            if args.ingest_docs:
                _run_ingest_pipeline(runtime, ds, args)
            for out in serve_with_runtime(runtime, engine, reqs,
                                          tier=args.tier, k=args.k):
                print(json.dumps(out), flush=True)
        finally:
            runtime.close()
    else:
        if args.ingest_docs:
            _run_ingest_pipeline(engine, ds, args)
        for req in reqs:
            print(json.dumps(handle_request_safe(engine, req, tier=args.tier,
                                                 k=args.k)), flush=True)


if __name__ == "__main__":
    main()
