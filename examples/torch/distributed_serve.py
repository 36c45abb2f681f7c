"""Sharded NKS serving on the PyTorch/CUDA port: an 8-shard serving plane
over the cards there are (or 8 CPU shards with ``--device cpu``).

One :class:`DevicePlane` carries every tier: the anchor-star search (each
shard scores its slice of the anchors against the whole groups, the shards'
top-k merged) and the batched exact pipeline, whose size-binned join
dispatches split over the same shards when the engine is built with
``mesh=``. The plane's answers equal the single-device engine's.

    PYTHONPATH=src python examples/torch/distributed_serve.py    # card(s)
    PYTHONPATH=src python examples/torch/distributed_serve.py --device cpu
"""
import argparse
import time

import torch

from repro_torch.core import brute_force
from repro_torch.core.backend import TorchBackend
from repro_torch.core.device_plane import DevicePlane
from repro_torch.data.flickr_like import flickr_like_dataset
from repro_torch.data.synthetic import random_queries
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.serve.engine import NKSEngine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=20_000, help="corpus points")
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="'cpu' puts every shard on the host (the kernels' "
                         "plain versions); default: the CUDA cards, dealt "
                         "cyclically")
    args = ap.parse_args(argv)

    plane = DevicePlane(make_serving_mesh(data=args.shards,
                                          device=args.device))
    ds = flickr_like_dataset(n=args.n, d=32, u=300, t=4, n_clusters=32,
                             seed=0)
    print(f"corpus: {ds.n} points on a {plane.n_shards}-shard serving plane "
          f"({sorted({str(d) for d in plane.devices})})")

    # device tier: the anchor-star search on the plane
    for query in random_queries(ds, q=3, n_queries=3, seed=4):
        pg = plane.pack_groups(ds, query)
        t0 = time.perf_counter()
        diams, cand_ids = plane.nks_topk(
            *(torch.from_numpy(a).to(plane.device) for a in pg), k=3)
        diams, cand_ids = diams.cpu(), cand_ids.cpu()
        dt = time.perf_counter() - t0
        truth = brute_force.search(ds, query, k=1).items[0]
        best = float(diams[0])
        print(f"query {query}: device top-1 diameter={best:.2f} (truth "
              f"{truth.diameter:.2f}, ratio "
              f"{best / max(truth.diameter, 1e-9):.3f}) ids="
              f"{sorted(set(int(i) for i in cand_ids[0]))} "
              f"[{dt * 1e3:.1f} ms]")

    # exact tier on the same plane: sharded size-binned join dispatches
    # (every bin pinned to the device, so the split shows on the CPU too)
    engine = NKSEngine(ds, m=2, n_scales=5, seed=0, build_approx=False,
                       mesh=plane)
    one = NKSEngine(ds, m=2, n_scales=5, seed=0, build_approx=False,
                    device=plane.device,
                    _indices=(engine.index_e, engine.index_a))
    queries = random_queries(ds, q=3, n_queries=8, seed=5)
    out = engine.query_batch(queries, k=2, tier="exact",
                             backend=TorchBackend(plane=plane,
                                                  route="device"))
    st = engine.last_batch_stats
    print(f"exact batch: {len(out)} queries, "
          f"{st.sharded_dispatches}/{st.total_dispatches} dispatches sharded, "
          f"per-shard counts {st.shard_dispatches}, "
          f"shard utilisation {st.shard_utilisation}")
    want = one.query_batch(queries, k=2, tier="exact",
                           backend=TorchBackend(device=plane.device,
                                                route="device"))
    same = all([(c.ids, c.diameter) for c in a.candidates]
               == [(c.ids, c.diameter) for c in b.candidates]
               for a, b in zip(out, want))
    assert same, "the plane's answers differ from one device's"
    print("answers equal the single-device engine's")


if __name__ == "__main__":
    main()
