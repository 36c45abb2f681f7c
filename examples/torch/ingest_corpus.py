"""End-to-end ingestion quickstart: raw documents -> job queue -> live NKS.

The paper's Flickr scenario (§I) from the front: instead of a pre-built
dataset, raw "photos" (feature payloads + tag strings + price/category
attrs, split across two tenants) enter a persistent job queue and a small
worker fleet pulls them through the embed stage into a WAL-backed engine —
each batch committed under one group-commit fsync barrier. A fault plan
kills one worker mid-batch on the way, exercising the lease-reclaim path.
At the end, the pipeline-built corpus answers filtered multi-tenant queries
identically to a fresh static engine over the same documents.

The engines live on the CUDA card (inserts binned by K5, exact batches
through the join kernels); ``--device cpu`` runs the kernels' plain
versions on the host.

    PYTHONPATH=src python examples/torch/ingest_corpus.py               # card
    PYTHONPATH=src python examples/torch/ingest_corpus.py --device cpu
"""
import argparse
import os
import tempfile

from repro_torch.data.ingest import (
    IngestPipeline, JobStore, ProjectionEmbedder, corpus_from_documents,
    flickr_like_documents,
)
from repro_torch.serve.engine import NKSEngine
from repro_torch.serve.faults import FaultPlan


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=2_000, help="documents")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain versions)")
    args = ap.parse_args(argv)

    # Raw documents: 32-dim feature payloads, Zipf-popular tag strings,
    # price/category attrs, two tenants. The vocabulary maps tag strings to
    # (tenant-local) keyword ids.
    docs, vocab = flickr_like_documents(args.n, d_raw=32, u=40, t=4, seed=1,
                                        tenants=("alice", "bob"))
    embedder = ProjectionEmbedder(8, vocab, d_raw=32, seed=1)

    # The engine needs a seed corpus (it fixes the tenant namespaces and the
    # attribute schema); the rest of the documents arrive through the queue.
    n_seed = args.n // 5
    seed_docs, stream_docs = docs[:n_seed], docs[n_seed:]
    seed_ds, _ = corpus_from_documents(seed_docs, embedder)
    root = tempfile.mkdtemp(prefix="nks-ingest-demo-")
    engine = NKSEngine(seed_ds, m=2, n_scales=5, seed=0, device=args.device)
    engine.attach_wal(os.path.join(root, "wal"))

    # Persistent job queue + 4 workers; the fault plan crashes whichever
    # worker performs the 5th insert — its lease expires and survivors
    # reclaim and finish the batch (the journal and WAL make this safe).
    store = JobStore(os.path.join(root, "jobs.jsonl"), lease_s=0.5,
                     backoff_s=0.01, max_attempts=6)
    store.add(stream_docs)
    faults = FaultPlan(crash={"insert": 5})
    pipeline = IngestPipeline(store, engine, embedder, workers=4,
                              batch_docs=32, faults=faults)
    pipeline.recover()                     # no-op on a fresh queue
    report = pipeline.run(timeout_s=120.0)
    print(f"ingested {report['docs_done']}/{len(stream_docs)} docs in "
          f"{report['wall_s']:.2f}s ({report['docs_per_s']:.0f} docs/s), "
          f"retries={report['retries']} reclaims={report['reclaims']} "
          f"dead_workers={report['dead_workers']}")
    assert report["drained"] and report["docs_failed"] == 0

    # Differential: the pipeline-built engine vs a fresh static build over
    # the same documents. Tenant-scoped filtered queries use tenant-LOCAL
    # keyword ids; answers are compared by optimal diameter.
    ref_ds, _ = corpus_from_documents(docs, embedder)
    ref = NKSEngine(ref_ds, m=2, n_scales=5, seed=0, device=args.device)
    for q, flt in [([4, 11], {"tenant": "alice"}),
                   ([7, 15], {"tenant": "bob"}),
                   ([2, 9], {"tenant": "alice",
                             "where": [["price", "<", 50.0]]})]:
        mine = engine.query_batch([q], k=2, tier="exact", filter=flt)[0]
        them = ref.query_batch([q], k=2, tier="exact", filter=flt)[0]
        diam = [round(c.diameter, 6) for c in mine.candidates]
        assert diam == [round(c.diameter, 6) for c in them.candidates]
        print(f"query {q} {flt}: diameters {diam} (matches static build)")

    engine.close()
    store.close()
    print(f"journal + WAL kept under {root} — rerun JobStore/NKSEngine."
          f"recover to resume")


if __name__ == "__main__":
    main()
