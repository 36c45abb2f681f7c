"""Plain PyTorch versions of the hand-written kernels.

Each function computes what its CUDA kernel in ``csrc/pairwise_l2.cu`` (the
threshold joins K1-K4), ``csrc/diameter.cu`` (the anchor-star search and
tuple diameters), ``csrc/flash_attention.cu`` (attention) or
``csrc/project_bin.cu`` (projection and binning) computes, with the same
inputs and outputs; ``kernels.ops`` routes a CPU tensor here, and the
tests and ``chip_smoke.py`` hold the kernels against these. They transcribe
the reference package's memory-lean formulations (the masked join and the
bf16 and int8 coarse counts).

Mask words are ``int32`` tensors holding the uint32 bit patterns (PyTorch has
no shifts or comparisons for uint32 on the CPU). At the host boundary
``t.numpy().view(np.uint32)`` recovers the unsigned words bit for bit.

Arithmetic: ``sq = max((|a|^2 + |b|^2) - 2 a.b, 0)`` in fp32, joined iff
``sq <= r*r`` with r squared in fp32. Float32 products here must run in full
fp32: callers on the card keep ``torch.backends.cuda.matmul.allow_tf32``
False (PyTorch's default).
"""
from __future__ import annotations

import numpy as np
import torch

# The square tile of the masked join and the coarse counts (K1, K2), which
# compute the tiles of the upper triangle of each subset.
JOIN_SQUARE_TILE = 64

_FMAX = torch.finfo(torch.float32).max


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., n) bool -> (..., ceil(n/32)) int32 words, LSB-first: bit
    ``j % 32`` of word ``j // 32`` is ``bits[..., j]``; bits past n are 0."""
    n = bits.shape[-1]
    w = (n + 31) // 32
    padded = torch.zeros(*bits.shape[:-1], w * 32, dtype=torch.bool,
                         device=bits.device)
    padded[..., :n] = bits
    words = torch.zeros(*bits.shape[:-1], w, dtype=torch.int64,
                        device=bits.device)
    for b in range(32):
        words |= padded[..., b::32].to(torch.int64) << b
    return torch.where(words >= 1 << 31, words - (1 << 32), words) \
        .to(torch.int32)


def unpack_bits(words: torch.Tensor, n: int) -> torch.Tensor:
    """(..., W) int32 words -> (..., n) bool (inverse of :func:`pack_bits`)."""
    col = torch.arange(n, device=words.device)
    w = words.to(torch.int64) & 0xFFFFFFFF
    return ((w[..., col // 32] >> (col % 32)) & 1).bool()


def _self_sq(xf: torch.Tensor) -> torch.Tensor:
    n2 = (xf * xf).sum(-1)                                      # (S, P)
    gram = torch.bmm(xf, xf.transpose(1, 2))
    return (n2[:, :, None] + n2[:, None, :] - 2.0 * gram).clamp_min(0.0)


def _live_rows(lengths: torch.Tensor, p: int,
               elig: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor]:
    valid = torch.arange(p, device=lengths.device)[None, :] \
        < lengths.to(torch.int64)[:, None]                       # (S, P)
    live = valid if elig is None else valid & unpack_bits(elig, p)
    return valid, live


def join_batched_masked(x: torch.Tensor, lengths: torch.Tensor,
                        r: torch.Tensor, elig: torch.Tensor | None = None, *,
                        with_sq: bool = False):
    """Masked batched self-join (kernel ``join_batched_masked``).

    x (S, P, d) fp32, lengths (S,) int32, r (S,) fp32, elig optional
    (S, ceil(P/32)) int32 eligibility words. Returns ``(mask, counts[, sq])``:
    mask (S, P, ceil(P/32)) int32 words of ``sq <= r^2`` on the valid square,
    ANDed with eligibility on rows and columns; counts (S,) int32 set bits per
    subset (diagonal included); sq (S, P, P) fp32 with fp32-max outside the
    valid square, only when ``with_sq``."""
    p = x.shape[1]
    sq = _self_sq(x.float())
    valid, live = _live_rows(lengths, p, elig)
    r2 = r.float() * r.float()
    joined = (sq <= r2[:, None, None]) & live[:, :, None] & live[:, None, :]
    counts = joined.sum(dim=(1, 2), dtype=torch.int32)
    mask = pack_bits(joined)
    if with_sq:
        sq = torch.where(valid[:, :, None] & valid[:, None, :], sq,
                         torch.full_like(sq, _FMAX))
        return mask, counts, sq
    return mask, counts


def join_batched_counts(x: torch.Tensor, lengths: torch.Tensor,
                        r: torch.Tensor,
                        elig: torch.Tensor | None = None) -> torch.Tensor:
    """Coarse bf16 join counts (kernel ``join_batched_prune``).

    Coordinates round to bfloat16 (round to nearest even); norms and the Gram
    term are taken from the rounded values in fp32 — a product of two bf16
    values is exact in fp32, so only the fp32 accumulation order differs from
    a tensor-core product. Same x, lengths, r and eligibility words as
    :func:`join_batched_masked` (ineligible points drop out of the counts);
    returns counts (S,) int32."""
    p = x.shape[1]
    sq = _self_sq(x.to(torch.bfloat16).float())
    _, live = _live_rows(lengths, p, elig)
    r2 = r.float() * r.float()
    joined = (sq <= r2[:, None, None]) & live[:, :, None] & live[:, None, :]
    return joined.sum(dim=(1, 2), dtype=torch.int32)


# Symmetric int8 quantisation's full scale, and the floor of a subset's
# largest magnitude (an all-zero subset quantises to zeros, not to NaN).
INT8_LEVELS = 127.0
INT8_MAXABS_FLOOR = 1e-30
_I32_MIN, _I32_MAX = -(2 ** 31), 2 ** 31 - 1


def int8_scale(maxabs: torch.Tensor) -> torch.Tensor:
    """Per-subset int8 scale ``127 / max(maxabs, 1e-30)`` in fp32."""
    m = maxabs.float().clamp_min(INT8_MAXABS_FLOOR)
    return torch.full_like(m, INT8_LEVELS) / m


def int8_threshold(scale: torch.Tensor, r: torch.Tensor, d: int
                   ) -> torch.Tensor:
    """Per-subset integer join threshold, in fp32 with one rounding an
    operation (no fused multiply-add): ``rq = r * scale + sqrt(d)``, ``thr
    = ceil(rq * rq) + 1``, converted to int32 with saturation. A pair of
    quantised points joins iff its exact squared integer distance is at
    most ``thr``: ``|x_i - x_j| >= (|q_i - q_j| - sqrt(d)) / scale`` (half a
    level of rounding per coordinate and endpoint), and the +1 absorbs the
    fp32 threshold's rounding, so the count bounds the fp32 join's from
    above."""
    rq = r.float() * scale + torch.tensor(float(d), dtype=torch.float32) ** 0.5
    thr = torch.ceil(rq * rq) + 1.0
    return thr.double().clamp(_I32_MIN, _I32_MAX).to(torch.int32)


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(S, P, d) fp32 -> q (S, P, d) int32 holding the int8 levels, and each
    subset's scale (S,) fp32 from its largest magnitude over the whole padded
    block: ``q = round_half_even(x * scale)``, the fp32 product rounded
    once."""
    xf = x.float()
    maxabs = xf.abs().amax(dim=(1, 2)) if xf.numel() else \
        torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    scale = int8_scale(maxabs)
    return torch.round(xf * scale[:, None, None]).to(torch.int32), scale


def join_batched_counts_int8(x: torch.Tensor, lengths: torch.Tensor,
                             r: torch.Tensor,
                             elig: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """Coarse int8 join counts (kernel ``join_batched_prune_int8``): the
    reference's int8 arm of the prune tier. Each subset is quantised
    symmetrically (:func:`quantize_int8`); norms and the Gram term are exact
    int32, ``sq = n2_i + n2_j - 2 g``, and a pair joins iff ``sq <= thr``
    (:func:`int8_threshold`). Same x, lengths, r and eligibility words
    as :func:`join_batched_masked`; returns counts (S,) int32, a superset of
    the fp32 join's at the same radius. All integer work is exact, so the
    kernel's counts equal these bit for bit. CPU tensors only: the card has
    no integer bmm."""
    s, p, d = x.shape
    q, scale = quantize_int8(x)
    thr = int8_threshold(scale, r, d)
    n2 = (q * q).sum(-1, dtype=torch.int32)                     # (S, P)
    gram = torch.bmm(q, q.transpose(1, 2))                      # exact int32
    sq = n2[:, :, None] + n2[:, None, :] - 2 * gram
    _, live = _live_rows(lengths, p, elig)
    joined = (sq <= thr[:, None, None]) & live[:, :, None] & live[:, None, :]
    return joined.sum(dim=(1, 2), dtype=torch.int32)


def join_batched_dense(x: torch.Tensor, lengths: torch.Tensor,
                       r: torch.Tensor, *, bm: int = 128, bn: int = 128
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched self-join with the dense block and per-tile counts (kernel
    ``join_batched_tiles``). Same x, lengths and r as
    :func:`join_batched_masked`; returns sq (S, P, P) fp32 with fp32-max
    outside the valid square, and counts (S, ceil(P/bm), ceil(P/bn)) int32:
    the valid pairs with ``sq <= r^2`` in each bm x bn tile."""
    s, p = x.shape[:2]
    sq = _self_sq(x.float())
    valid, _ = _live_rows(lengths, p, None)
    cell = valid[:, :, None] & valid[:, None, :]
    sq = torch.where(cell, sq, torch.full_like(sq, _FMAX))
    r2 = r.float() * r.float()
    return sq, _tile_counts((sq <= r2[:, None, None]) & cell, bm, bn)


def _tile_counts(joined: torch.Tensor, bm: int, bn: int) -> torch.Tensor:
    """(..., M, N) bool -> (..., ceil(M/bm), ceil(N/bn)) int32: the set cells
    of each bm x bn tile."""
    *lead, m, n = joined.shape
    gm, gn = -(-m // bm), -(-n // bn)
    pad = torch.zeros(*lead, gm * bm, gn * bn, dtype=torch.int32,
                      device=joined.device)
    pad[..., :m, :n] = joined
    return pad.view(*lead, gm, bm, gn, bn).sum(dim=(-3, -1),
                                               dtype=torch.int32)


def pairwise_join(a: torch.Tensor, b: torch.Tensor,
                  r: float = float("inf"), *, bm: int = 128, bn: int = 128
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """One (M, d) x (N, d) join (kernel ``pairwise_join``). Returns sq (M, N)
    fp32 and counts (ceil(M/bm), ceil(N/bn)) int32: the pairs with
    ``sq <= r^2`` in each bm x bn tile (``counts.sum()`` is the join
    size), the reference's grid."""
    af, bf = a.float(), b.float()
    sq = ((af * af).sum(1)[:, None] + (bf * bf).sum(1)[None, :]
          - 2.0 * (af @ bf.T)).clamp_min(0.0)
    r32 = torch.tensor(r, dtype=torch.float32, device=a.device)
    return sq, _tile_counts(sq <= r32 * r32, bm, bn)


def bin_constants(w: float, c: int) -> tuple[float, float, float]:
    """The binning constants as the TPU kernel rounds them: ``fp32(1 / w)``
    (the division in double), ``fp32(w / 2)`` and ``fp32(c)``."""
    return (float(np.float32(1.0 / w)), float(np.float32(w / 2.0)),
            float(np.float32(c)))


def project_and_bin(x: torch.Tensor, z: torch.Tensor, w: float, c: int
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Projection onto m unit vectors and both bin keys (paper eqs. 1-2):
    x (N, d), z (m, d) -> (h1, h2, p), each (N, m), with the TPU kernel's
    rounding points: p in fp32, ``h1 = floor(p * inv_w)``, ``h2 =
    floor((p - half_w) * inv_w) + c`` (the add in fp32), int32 keys."""
    inv_w, half_w, cf = (torch.tensor(v, dtype=torch.float32, device=x.device)
                         for v in bin_constants(w, c))
    p = x.to(torch.float32) @ z.to(torch.float32).T
    h1 = torch.floor(p * inv_w).to(torch.int32)
    h2 = (torch.floor((p - half_w) * inv_w) + cf).to(torch.int32)
    return h1, h2, p


def tuple_diameters(pts: torch.Tensor) -> torch.Tensor:
    """Diameters r(A) of a batch of candidate tuples (kernel
    ``tuple_diameters`` in ``csrc/diameter.cu``): pts (T, q, d) -> (T,) fp32,
    the largest pairwise L2 distance within each tuple.

    The norms identity per tuple, in fp32, as the TPU kernel computes it:
    ``sq = sum x^2``, ``gram = x x^T``, ``d2 = max(sq_i + sq_j - 2 gram_ij,
    0)``, the result ``sqrt(max d2)``. A tuple padded by repeating a member
    keeps its diameter (the duplicate adds only entries the tuple already
    has)."""
    x = pts.float()
    sq = (x * x).sum(-1)                                        # (T, q)
    gram = torch.bmm(x, x.transpose(1, 2))                      # (T, q, q)
    d2 = (sq[:, :, None] + sq[:, None, :] - 2.0 * gram).clamp_min(0.0)
    return d2.amax(dim=(1, 2)).sqrt()


# The score of a masked point in the anchor-star search (the reference's
# BIG), and the byte budget of one (anchors, R) fp32 distance block of
# :func:`anchor_star`: the product and its epilogue hold two such blocks.
BIG = float(np.float32(3.4e38))
ANCHOR_BLOCK_BYTES = 1 << 30


def _masked_sq_dists(a: torch.Tensor, b: torch.Tensor,
                     b_mask: torch.Tensor) -> torch.Tensor:
    """(A, d) x (B, d) -> (A, B) squared L2 with invalid b masked to BIG:
    ``max((|a|^2 + |b|^2) - 2 a.b, 0)`` in fp32, in place after the sum."""
    sq = (a * a).sum(1)[:, None] + (b * b).sum(1)[None, :]
    sq.sub_(torch.mm(a, b.T).mul_(2.0)).clamp_min_(0.0)
    return sq.masked_fill_(~b_mask[None, :], BIG)


def anchor_star(groups: torch.Tensor, mask: torch.Tensor, *,
                block_bytes: int = ANCHOR_BLOCK_BYTES
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The anchor-star search of one query (kernel ``anchor_star`` in
    ``csrc/diameter.cu``).

    groups (q, R, d) fp32 (centred by the caller), mask (q, R) bool; the
    anchors are ``groups[0]``. Returns nn (R, q) int32 — ``nn[a, 0] = a``
    and ``nn[a, j]`` the nearest valid point of group j by
    :func:`_masked_sq_dists` (the lowest index among equal minima,
    ``torch.argmin``'s rule; index 0 at BIG when the group has no valid
    point) — worst_nn (R,) fp32, the largest of those squared distances (0
    for q = 1), and diam (R,) fp32, the diameter of each anchor's tuple by
    :func:`tuple_diameters`.

    Anchors are taken ``block_bytes // (4 R)`` at a time. Each anchor's row
    is independent of the others, so tiling changes nothing but how the
    matrix product may round (its blocking), not which rows meet which."""
    q, r, d = groups.shape
    anchors = groups[0]
    chunk = max(1, block_bytes // (4 * max(r, 1)))
    nn = torch.empty((r, q), dtype=torch.int64, device=groups.device)
    nn[:, 0] = torch.arange(r, device=groups.device)
    tuples = torch.empty((r, q, d), dtype=torch.float32, device=groups.device)
    tuples[:, 0] = anchors
    worst_nn = torch.zeros(r, dtype=torch.float32, device=groups.device)
    for a0 in range(0, r, chunk):
        rows = slice(a0, min(r, a0 + chunk))
        for j in range(1, q):
            sq = _masked_sq_dists(anchors[rows], groups[j], mask[j])
            idx = sq.argmin(dim=1)
            nn_d = sq.gather(1, idx[:, None])[:, 0]
            del sq
            worst_nn[rows] = torch.maximum(worst_nn[rows], nn_d)
            tuples[rows, j] = groups[j][idx]
            nn[rows, j] = idx
    return nn.to(torch.int32), worst_nn, tuple_diameters(tuples)


def _attention_numerators(q, k, v, causal, window):
    """Unnormalised softmax numerators ``p = exp(s - rowmax)`` (B, H, S, T)
    in fp32 over the scores of ``q * (1/sqrt(hd))`` (rounded to q's dtype)
    against k, with masked scores at -1e30, and v repeated per query head
    (B, T, H, hd)."""
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    if h % kvh:
        raise ValueError(f"{h} query heads are not a multiple of {kvh} "
                         f"kv heads")
    g = h // kvh
    qs = (q.float() * (1.0 / float(hd) ** 0.5)).to(q.dtype).float()
    kf = k.repeat_interleave(g, dim=2).float() if g > 1 else k.float()
    vv = v.repeat_interleave(g, dim=2) if g > 1 else v
    sc = torch.einsum("bshd,bthd->bhst", qs, kf)
    q_pos = torch.arange(s, device=q.device)[:, None]
    kv_pos = torch.arange(t, device=q.device)[None, :]
    valid = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        valid &= kv_pos <= q_pos
    if window is not None:
        valid &= kv_pos > q_pos - window
    # in place: at (2, 4096, 36, 64) one score block is 4.8 GB
    p = sc.masked_fill_(~valid, -1e30)
    return p.sub_(p.amax(dim=-1, keepdim=True)).exp_(), vv


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: int | None = None) -> torch.Tensor:
    """Attention forward (kernel ``flash_attention`` in
    ``csrc/flash_attention.cu``), written out as einsum and softmax.

    q (B, S, H, hd); k, v (B, T, Kv, hd) with H a multiple of Kv (query head
    h reads kv head ``h // (H // Kv)``); positions run 0.. on both axes.
    Query ``i`` sees key ``j`` iff ``j < T``, and ``j <= i`` when ``causal``,
    and ``j > i - window`` with a ``window``; masked scores are -1e30.
    Returns (B, S, H, hd) in q's dtype.

    Rounds where the kernel rounds: ``q * (1/sqrt(hd))`` is taken in fp32 and
    rounded to q's dtype before the QK^T dot, the softmax numerators to v's
    dtype before the PV dot; products accumulate in fp32 and the output is
    ``acc / max(l, 1e-30)`` with the fp32 denominator. In fp32 this is the
    dense-softmax oracle of the flash kernel. The kernel normalises
    numerators by a running maximum, this version by the row maximum, so the
    two round the numerators at different scales."""
    p, vv = _attention_numerators(q, k, v, causal, window)
    denom = p.sum(dim=-1)                                       # (B, H, S)
    out = torch.einsum("bhst,bthd->bshd", p.to(v.dtype).float(), vv.float())
    return (out / denom.clamp_min(1e-30).transpose(1, 2)[..., None]) \
        .to(q.dtype)


def flash_attention_tolerance(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, plain: torch.Tensor, *,
                              causal: bool = True,
                              window: int | None = None) -> torch.Tensor:
    """Element-wise bound (B, S, H, hd) fp32 on ``|kernel - plain|`` for
    bf16 inputs, ``plain`` being :func:`flash_attention` on them:

        2^-7 |plain| + 2^-6 sqrt(sum_j p_j^2 v_j^2) / l

    The two versions differ in two roundings. (1) Each rounds the softmax
    numerator p_j to bf16 at its own scale (the kernel's running maximum,
    this version's row maximum), a relative 2^-9 each, so the numerators
    differ by |dp_j| <= 2^-8 p_j. These roundings do not depend on v, so the
    output's error sum_j dp_j v_j / l has a standard deviation of at most
    2^-9 sqrt(2/3) sqrt(sum_j p_j^2 v_j^2) / l; the second term is ~10 of
    those, and for a row of 16 live keys or fewer it also covers the worst
    case 2^-8 sum_j p_j |v_j| / l. It scales with the row's own rounding
    noise, so it shrinks as 1/sqrt(live keys) where the output does, and a
    kernel that drops or mis-weights one key tile lies far outside it.
    (2) Each rounds its fp32 output to bf16: one bf16 ulp, <= 2^-7 |plain|.
    fp32 summation-order differences are ~2^-24 sqrt(T) relative, far
    below both terms."""
    p, vv = _attention_numerators(q, k, v, causal, window)
    denom = p.sum(dim=-1).clamp_min(1e-30).transpose(1, 2)[..., None]
    spread = torch.einsum("bhst,bthd->bshd", p.square_(),
                          vv.float().square()).sqrt_() / denom
    return 2.0 ** -7 * plain.float().abs() + 2.0 ** -6 * spread
