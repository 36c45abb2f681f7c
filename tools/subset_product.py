#!/usr/bin/env python3
"""How far numpy's fp32 product of a row subset lies from the same rows of
the full product.

    python3 tools/subset_product.py

The index build defines every bin edge from ``points @ z.T`` over the whole
corpus, while a streaming batch is binned from its own product. This prints,
per dimension d, the largest |(x[rows] @ z.T) - (x @ z.T)[rows]| over random
row subsets and aligned row blocks of several sizes (x uniform with
|x| ~ 100 sqrt(d), z two unit vectors), and the numpy version and BLAS it ran
with. A nonzero entry means the batch's product can bin a point within that
distance of an edge differently from a fresh build.
"""
from __future__ import annotations

import numpy as np


def main() -> None:
    rng = np.random.default_rng(0)
    n = 8192
    print("numpy", np.__version__)
    try:
        cfg = np.show_config(mode="dicts")["Build Dependencies"]["blas"]
        print("blas", cfg.get("name"), cfg.get("version"))
    except (TypeError, KeyError):
        pass
    for d in (32, 64, 256, 2304):
        x = rng.uniform(0, 200, (n, d)).astype(np.float32)
        z = rng.standard_normal((2, d)).astype(np.float32)
        z /= np.linalg.norm(z, axis=1, keepdims=True)
        full = x @ z.T
        out = {}
        for size in (1, 7, 100, 500):
            worst = 0.0
            for _ in range(20):
                rows = np.sort(rng.choice(n, size, replace=False))
                worst = max(worst, float(np.abs(x[rows] @ z.T
                                                - full[rows]).max()))
            out[f"random {size}"] = worst
        for size in (8, 64, 256, 1024, 4096):
            worst = 0.0
            for start in range(0, n, size):
                blk = slice(start, start + size)
                worst = max(worst, float(np.abs(x[blk] @ z.T
                                                - full[blk]).max()))
            out[f"aligned {size}"] = worst
        print(f"d={d}: " + ", ".join(f"{k}: {v:.3g}" for k, v in out.items()))


if __name__ == "__main__":
    main()
