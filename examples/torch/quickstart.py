"""Quickstart on the PyTorch/CUDA port: build a tagged dataset, index it on
the card, run NKS queries per query, in batches and through the serving
runtime.

    PYTHONPATH=src python examples/torch/quickstart.py               # card
    PYTHONPATH=src python examples/torch/quickstart.py --device cpu --n 2000
"""
import argparse

from repro_torch.core import brute_force, promish_a, promish_e
from repro_torch.data.synthetic import random_queries, synthetic_dataset
from repro_torch.serve.engine import NKSEngine
from repro_torch.serve.runtime import RuntimeConfig, ServingRuntime


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=5_000, help="corpus points")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain versions)")
    args = ap.parse_args(argv)

    # A tagged multi-dimensional dataset (paper fig. 1 setting).
    ds = synthetic_dataset(n=args.n, d=16, u=50, t=2, seed=0)
    print(f"dataset: N={ds.n} d={ds.dim} U={ds.n_keywords}")

    # The engine puts the corpus on the device and builds both multi-scale
    # hash indices there (paper defaults m=2, L=5; binning in K5).
    engine = NKSEngine(ds, m=2, n_scales=5, seed=0, device=args.device)
    idx_e, idx_a = engine.index_e, engine.index_a
    print(f"engine on {engine.device}: L={idx_e.n_scales} scales, "
          f"w0={idx_e.w0:.1f}, E={idx_e.nbytes() / 1e6:.1f}MB "
          f"A={idx_a.nbytes() / 1e6:.1f}MB, K5 launches "
          f"{engine.build_stats.k5_launches}")

    for query in random_queries(ds, q=3, n_queries=3, seed=42):
        exact = promish_e.search(ds, idx_e, query, k=2)
        approx = promish_a.search(ds, idx_a, query, k=2)
        truth = brute_force.search(ds, query, k=2)
        print(f"\nquery {query}")
        for name, pq in (("ProMiSH-E", exact), ("ProMiSH-A", approx),
                         ("oracle   ", truth)):
            top = pq.items[0]
            print(f"  {name}: ids={top.ids} diameter={top.diameter:.2f}")
        assert abs(exact.items[0].diameter - truth.items[0].diameter) < 1e-3

    # Batched serving path: a few size-binned join dispatches per scale for
    # the whole batch, on the engine's device (the torch backend).
    batch = random_queries(ds, q=3, n_queries=8, seed=7)
    results = engine.query_batch(batch, k=1, tier="exact")
    stats = engine.last_batch_stats
    print(f"\nbatched: {len(results)} queries, "
          f"{sum(s.tasks_searched for s in stats.scales)} subsets, "
          f"dispatches/scale={stats.dispatches_per_scale}")

    # The serving runtime: requests submitted at once coalesce into batched
    # dispatches and answer as the direct batch does.
    with ServingRuntime(engine, RuntimeConfig(max_batch=8)) as rt:
        tickets = [rt.submit({"op": "query", "keywords": q, "k": 1,
                              "tier": "exact"}) for q in batch]
        served = [t.result(60) for t in tickets]
    assert all(r.ok for r in served)
    assert [[c.key() for c in r.payload["candidates"]] for r in served] \
        == [[c.key() for c in r.candidates] for r in results]
    print(f"runtime: {len(served)} requests in {rt.stats.batches} coalesced "
          f"batches (mean {rt.stats.mean_batch:.1f}), answers equal the "
          f"direct batch")


if __name__ == "__main__":
    main()
