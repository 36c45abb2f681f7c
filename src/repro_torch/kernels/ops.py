"""Public threshold-join ops, routed by the device of their tensors.

A CUDA tensor goes to the hand-written kernel (``kernels.pairwise_l2``,
``kernels.diameter``, ``kernels.flash_attention``, ``kernels.project_bin``),
which launches or raises; a CPU tensor goes to the kernel's plain PyTorch
version (``kernels.ref``). Nothing else is routed: there is no silent
fallback from the card to the host.

  * :func:`pairwise_l2_join_batched_masked` — the fp32 masked self-join of a
    batch of padded subsets (the serving hot path), with the optional
    eligibility fold.
  * :func:`pairwise_l2_join_batched_counts` — the bf16 (K2) or int8 (K2i)
    coarse counts of the cascade's prune tier.
  * :func:`pairwise_l2_join` — one (M, d) x (N, d) join.
  * :func:`pairwise_l2_join_batched` — the batched self-join with the dense
    block and per-tile counts (K4; no serving path calls it, as in the
    reference).
  * :func:`anchor_star` — the anchor-star search of one query (the device
    tier): masked nearest neighbours of every anchor in each other keyword
    group, the worst of their squared distances and the tuples' diameters,
    fused in one kernel on the card (``kernels.diameter``).
  * :func:`tuple_diameters` — the diameters r(A) of a batch of given
    candidate tuples (the TPU kernel's own function).
  * :func:`flash_attention` — causal or windowed attention forward (the LM
    embedder's self-attention).
  * :func:`project_and_bin` — the random projections and both bin keys of
    every point (the index build, inserts and deletes).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import diameter as _diameter
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import pairwise_l2 as _cuda
from repro_torch.kernels import project_bin as _project
from repro_torch.kernels import ref


def _route(t: torch.Tensor) -> str:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


def pairwise_l2_join_batched_masked(x: torch.Tensor, lengths: torch.Tensor,
                                    r: torch.Tensor,
                                    elig: torch.Tensor | None = None, *,
                                    with_sq: bool = False):
    """Fused batched self-join emitting the packed adjacency bitmask.

    Returns ``(mask, counts[, sq])``: mask (S, P, ceil(P/32)) int32 words
    (bit ``j % 32`` of word ``j // 32`` of row i set iff points i, j of the
    subset join at its radius, both valid and, with ``elig``, both
    eligible), counts (S,) int32 (diagonal included), and the dense fp32
    block only when ``with_sq``."""
    if _route(x) == "cuda":
        return _cuda.join_batched_masked(x, lengths, r, elig, with_sq=with_sq)
    return ref.join_batched_masked(x, lengths, r, elig, with_sq=with_sq)


def pairwise_l2_join_batched_counts(x: torch.Tensor, lengths: torch.Tensor,
                                    r: torch.Tensor,
                                    elig: torch.Tensor | None = None, *,
                                    dtype: str = "bf16") -> torch.Tensor:
    """Coarse threshold-join counts (the cascade's tier 0): same batching
    and eligibility contract as the masked join, counts (S,) int32 only.
    ``dtype`` picks the coarse arithmetic: ``"bf16"`` (K2: coordinates
    rounded to bf16, fp32 sums) or ``"int8"`` (K2i: per-subset symmetric
    int8 quantisation, exact int32 norms and Gram, an integer threshold
    widened by the quantisation error). Call with the error-widened coarse
    radii; a subset whose count stays at or below its (eligible) diagonal
    provably has no off-diagonal fp32 pair."""
    if dtype not in ("bf16", "int8"):
        raise ValueError(f"unknown prune dtype: {dtype!r}")
    if _route(x) == "cuda":
        if dtype == "int8":
            return _cuda.join_batched_prune_int8(x, lengths, r, elig)
        return _cuda.join_batched_prune(x, lengths, r, elig)
    if dtype == "int8":
        return ref.join_batched_counts_int8(x, lengths, r, elig)
    return ref.join_batched_counts(x, lengths, r, elig)


def pairwise_l2_join_batched(x: torch.Tensor, lengths,
                             r: torch.Tensor | float = float("inf"), *,
                             bm: int = 128, bn: int = 128
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """One self-join over a batch of padded subsets: x (S, P, d) fp32,
    ``lengths`` (S,) valid points per subset, ``r`` a radius per subset or
    one for all. Returns sq (S, P, P) fp32 (fp32-max outside each subset's
    valid square) and counts (S, ceil(P/bm), ceil(P/bn)) int32, the valid
    pairs with ``sq <= r^2`` per bm x bn tile (``counts.sum((1, 2))`` is each
    subset's join size)."""
    s = x.shape[0]
    lengths = torch.as_tensor(lengths, dtype=torch.int32,
                              device=x.device).reshape(s)
    r = torch.as_tensor(r, dtype=torch.float32,
                        device=x.device).expand(s).contiguous()
    if _route(x) == "cuda":
        return _cuda.join_batched_tiles(x, lengths, r, bm=bm, bn=bn)
    return ref.join_batched_dense(x, lengths, r, bm=bm, bn=bn)


def pairwise_l2_join(a: torch.Tensor, b: torch.Tensor,
                     r: float = float("inf"), *, bm: int = 128,
                     bn: int = 128) -> tuple[torch.Tensor, torch.Tensor]:
    """Pairwise squared-L2 + threshold-join counts. Returns sq (M, N) fp32
    and counts (ceil(M/bm), ceil(N/bn)) int32, the pairs with ``sq <= r^2``
    per bm x bn tile, as the reference's grid; ``counts.sum()`` is the join
    size at ``r``."""
    if _route(a) == "cuda":
        return _cuda.pairwise_join(a, b, r, bm=bm, bn=bn)
    return ref.pairwise_join(a, b, r, bm=bm, bn=bn)


def anchor_star(groups: torch.Tensor, mask: torch.Tensor, *,
                block_bytes: int = ref.ANCHOR_BLOCK_BYTES
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Nearest valid neighbour of every anchor (``groups[0]``) in each other
    group, the worst of those squared distances and each anchor tuple's
    diameter: groups (q, R, d) fp32, mask (q, R) bool -> (nn (R, q) int32,
    worst_nn (R,) fp32, diam (R,) fp32); see ``kernels.ref.anchor_star``.
    On the card only contiguous fp32 groups and bool mask with 1 <= q <= 9
    are taken (anything else raises), and anchors of a wholly masked
    128-anchor tile are left at nn 0, worst_nn BIG. ``block_bytes`` bounds
    the plain version's (anchors, R) blocks; the kernel has none."""
    if _route(groups) == "cuda":
        return _diameter.anchor_star(groups, mask)
    return ref.anchor_star(groups, mask, block_bytes=block_bytes)


def tuple_diameters(pts: torch.Tensor) -> torch.Tensor:
    """Largest pairwise L2 distance of each tuple: pts (T, q, d) fp32 ->
    (T,) fp32, through the norms identity. On the card only contiguous fp32
    with 1 <= q <= 9 is taken (anything else raises)."""
    if _route(pts) == "cuda":
        return _diameter.tuple_diameters(pts)
    return ref.tuple_diameters(pts)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: int | None = None) -> torch.Tensor:
    """Attention of q (B, S, H, hd) over k, v (B, T, Kv, hd), positions 0..
    on both axes; returns (B, S, H, hd). On the card only bf16 with hd 64 or
    128 is taken (anything else raises)."""
    if _route(q) == "cuda":
        return _flash.flash_attention(q, k, v, causal=causal, window=window)
    return ref.flash_attention(q, k, v, causal=causal, window=window)


def project_and_bin(x: torch.Tensor, z: torch.Tensor, w: float, c: int
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Projections p = x z^T and the bin keys h1 = floor(p / w), h2 =
    floor((p - w/2) / w) + c, each (N, m), with the TPU kernel's rounding
    points (``kernels.ref.project_and_bin``). On the card only contiguous
    fp32 or bf16 x with 1 <= m <= 8 is taken (anything else raises)."""
    if _route(x) == "cuda":
        return _project.project_and_bin(x, z, w, c)
    return ref.project_and_bin(x, z, w, c)
