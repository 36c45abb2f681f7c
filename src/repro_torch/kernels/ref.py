"""Plain PyTorch versions of the threshold-join kernels.

Each function computes exactly what its CUDA kernel in ``csrc/pairwise_l2.cu``
computes, with the same inputs and outputs; ``kernels.ops`` routes a CPU
tensor here, and the tests and ``chip_smoke.py`` hold the kernels against
these. They transcribe the reference package's memory-lean formulations
(the masked join and the bf16 coarse counts).

Mask words are ``int32`` tensors holding the uint32 bit patterns (PyTorch has
no shifts or comparisons for uint32 on the CPU). At the host boundary
``t.numpy().view(np.uint32)`` recovers the unsigned words bit for bit.

Arithmetic: ``sq = max((|a|^2 + |b|^2) - 2 a.b, 0)`` in fp32, joined iff
``sq <= r*r`` with r squared in fp32. Float32 products here must run in full
fp32: callers on the card keep ``torch.backends.cuda.matmul.allow_tf32``
False (PyTorch's default).
"""
from __future__ import annotations

import torch

# The CUDA kernels' block tile (rows, columns): ``pairwise_join`` reports one
# join count per tile of this shape.
JOIN_TILE = (32, 128)

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
                        r: torch.Tensor) -> torch.Tensor:
    """Coarse bf16 join counts (kernel ``join_batched_prune``).

    Coordinates round to bfloat16 (round to nearest even); norms and the Gram
    term are taken from the rounded values in fp32 — a product of two bf16
    values is exact in fp32, so only the fp32 accumulation order differs from
    a tensor-core product. Same x, lengths and r as
    :func:`join_batched_masked`; returns counts (S,) int32."""
    p = x.shape[1]
    sq = _self_sq(x.to(torch.bfloat16).float())
    valid, _ = _live_rows(lengths, p, None)
    r2 = r.float() * r.float()
    joined = (sq <= r2[:, None, None]) & valid[:, :, None] & valid[:, None, :]
    return joined.sum(dim=(1, 2), dtype=torch.int32)


def pairwise_join(a: torch.Tensor, b: torch.Tensor,
                  r: float = float("inf")) -> tuple[torch.Tensor, torch.Tensor]:
    """One (M, d) x (N, d) join (kernel ``pairwise_join``). Returns sq (M, N)
    fp32 and counts (ceil(M/32), ceil(N/128)) int32: the pairs with
    ``sq <= r^2`` in each :data:`JOIN_TILE` tile (``counts.sum()`` is the
    join size)."""
    af, bf = a.float(), b.float()
    sq = ((af * af).sum(1)[:, None] + (bf * bf).sum(1)[None, :]
          - 2.0 * (af @ bf.T)).clamp_min(0.0)
    r32 = torch.tensor(r, dtype=torch.float32, device=a.device)
    joined = sq <= r32 * r32
    tm, tn = JOIN_TILE
    m, n = sq.shape
    gm, gn = -(-m // tm), -(-n // tn)
    pad = torch.zeros(gm * tm, gn * tn, dtype=torch.int32, device=a.device)
    pad[:m, :n] = joined
    counts = pad.view(gm, tm, gn, tn).sum(dim=(1, 3), dtype=torch.int32)
    return sq, counts
