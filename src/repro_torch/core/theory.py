"""Statistical models from the paper (§VI approximation bound, §VII pruning).

Implements eqs. 4-7 plus the Monte-Carlo estimators the paper used to
instantiate them (candidate-diameter pmf f_r, bin-containment probability
Pr(A|r)). Drives benchmarks `tab2_pruning` and the ProMiSH-A ratio bound.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import brute_force
from repro_torch.core.types import KeywordDataset


def keyword_pmf(dataset: KeywordDataset) -> np.ndarray:
    """f_v: empirical keyword probability mass function."""
    counts = np.diff(dataset.ikp.offsets).astype(np.float64)
    return counts / max(counts.sum(), 1.0)


def total_candidates(dataset: KeywordDataset, query) -> float:
    """Eq. 4: N_n = prod_i f_v(v_Qi) * N  (the paper's t=1 model)."""
    f_v = keyword_pmf(dataset)
    out = float(dataset.n)
    for v in query:
        out *= float(f_v[v])
    return out


def candidate_diameter_pmf(dataset: KeywordDataset, query, bins: int = 50,
                           max_candidates: int = 200_000, seed: int = 0):
    """f_r: histogram of candidate diameters, normalised to [0, 1] diameters.

    Enumerates (or samples, beyond ``max_candidates``) candidates and returns
    (bin_centers, pmf, r_star, diam_scale).
    """
    rng = np.random.default_rng(seed)
    groups = [dataset.ikp.row(v) for v in query]
    sizes = np.array([len(g) for g in groups], dtype=np.int64)
    if (sizes == 0).any():
        raise ValueError("query keyword with no points")
    total = int(np.prod(sizes.astype(np.float64)))
    diams = []
    if total <= max_candidates:
        for ids in brute_force.enumerate_candidates(dataset, query):
            diams.append(brute_force.set_diameter(ids, dataset))
    else:
        for _ in range(max_candidates):
            ids = tuple(sorted(set(int(rng.choice(g)) for g in groups)))
            diams.append(brute_force.set_diameter(ids, dataset))
    diams = np.asarray(diams, dtype=np.float64)
    r_star = float(diams.min())
    scale = float(diams.max()) or 1.0
    hist, edges = np.histogram(diams / scale, bins=bins, range=(0.0, 1.0))
    pmf = hist / max(hist.sum(), 1)
    centers = 0.5 * (edges[:-1] + edges[1:])
    return centers, pmf, r_star, scale


def containment_probability(points: np.ndarray, width: float, n_vectors: int = 4096,
                            overlapping: bool = False, seed: int = 0) -> float:
    """Pr(A|r): probability over random unit vectors that all points of A fall
    in one bin of width ``width``.

    Non-overlapping bins (ProMiSH-A / §VI model): same floor(p/w) for all.
    Overlapping bins (ProMiSH-E): containment in either bin plane.
    """
    rng = np.random.default_rng(seed)
    d = points.shape[1]
    z = rng.standard_normal((n_vectors, d)).astype(np.float64)
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    p = points.astype(np.float64) @ z.T                     # (|A|, V)
    b1 = np.floor(p / width)
    same1 = (b1 == b1[:1]).all(axis=0)
    if not overlapping:
        return float(same1.mean())
    b2 = np.floor((p - width / 2.0) / width)
    same2 = (b2 == b2[:1]).all(axis=0)
    return float((same1 | same2).mean())


def expected_explored(dataset: KeywordDataset, query, m: int, width: float,
                      n_vectors: int = 1024, max_candidates: int = 20_000,
                      seed: int = 0) -> tuple[float, float]:
    """Eq. 7: N_p = sum_r Pr(A|r)^m * N_r, returned with measured N_n.

    Estimated by summing Pr(A|r)^m over enumerated/sampled candidates directly
    (the histogram of eq. 5 taken at its finest granularity).
    """
    rng = np.random.default_rng(seed)
    cands = list(brute_force.enumerate_candidates(dataset, query))
    if len(cands) > max_candidates:
        sel = rng.choice(len(cands), size=max_candidates, replace=False)
        sample = [cands[i] for i in sel]
        scale_up = len(cands) / max_candidates
    else:
        sample = cands
        scale_up = 1.0
    n_p = 0.0
    for ids in sample:
        pr = containment_probability(dataset.points[np.asarray(ids)], width,
                                     n_vectors=n_vectors, seed=seed)
        n_p += pr ** m
    return n_p * scale_up, float(len(cands))


def retrieval_probability(diams: np.ndarray, pr_fn, m: int, r_star: float,
                          r_prime: float) -> float:
    """Eq. 6: P(r') = 1 - prod_{r* <= r <= r'} (1 - Pr(A|r)^m)^{N_r}.

    ``diams`` are candidate diameters; ``pr_fn(r)`` evaluates Pr(A|r).
    """
    mask = (diams >= r_star) & (diams <= r_prime)
    log_miss = 0.0
    for r in np.unique(diams[mask]):
        n_r = int((diams == r).sum())
        p = min(max(pr_fn(float(r)) ** m, 0.0), 1.0 - 1e-12)
        log_miss += n_r * np.log1p(-p)
    return 1.0 - float(np.exp(log_miss))


def approximation_ratio_bound(dataset: KeywordDataset, query, m: int, width: float,
                              lam: float = 0.8, n_vectors: int = 512,
                              seed: int = 0) -> float:
    """rho* = r'/r* for the smallest r' with P(r') >= lambda (§VI)."""
    cands = list(brute_force.enumerate_candidates(dataset, query))
    diams = np.array([brute_force.set_diameter(ids, dataset) for ids in cands])
    order = np.argsort(diams)
    diams_sorted = diams[order]
    cands_sorted = [cands[i] for i in order]
    r_star = float(diams_sorted[0]) or 1e-9
    cache: dict[int, float] = {}

    def pr_fn_idx(i: int) -> float:
        if i not in cache:
            cache[i] = containment_probability(
                dataset.points[np.asarray(cands_sorted[i])], width,
                n_vectors=n_vectors, seed=seed)
        return cache[i]

    log_miss = 0.0
    for i, r in enumerate(diams_sorted):
        p = min(max(pr_fn_idx(i) ** m, 0.0), 1.0 - 1e-12)
        log_miss += np.log1p(-p)
        if 1.0 - np.exp(log_miss) >= lam:
            return float(max(r, r_star) / r_star)
    return float(diams_sorted[-1] / r_star)
