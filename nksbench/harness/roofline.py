"""Peaks of the card and the anchor-star search's operations and bytes.

Peaks: NVIDIA's H100 SXM data sheet, dense rates, at the card's full 700 W
(a card set below it runs slower; the run's device line carries the power
limit). The search's counts are ``chip_smoke.py``'s (``bound`` and
``anchor_star_row``), counted from the valid anchors and points of a
query, whatever implements it:

* operations: ``2 A d sum_j R_j`` for the nearest neighbours (a
  multiply-add per feature per pair of a valid anchor and a valid point of
  another tag) and ``2 A q^2 d`` for the stars' Gram matrices;
* bytes: every valid point read once, ``(A + sum_j R_j) d 4``, the (q, R)
  mask, and per anchor slot of the padded width R its q neighbour indices,
  worst distance and diameter, ``R (4 q + 8)``;

where A is the size of the first tag's point set (the anchors), R_j that of
tag j >= 1, and R the largest set rounded up to 128 (the program's
padding). The bound is the larger of operations over the fp32 peak (the
configuration's precision, outside the tensor cores) and bytes over the
memory's rate.
"""
from __future__ import annotations

PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
ALIGN = 128


def anchor_star_work(sizes: list[int], d: int) -> tuple[float, float]:
    """(operations, bytes) of one query whose tags' point sets have
    ``sizes`` (the first is the anchors'). A query with an empty set is
    answered without a search: (0, 0)."""
    if not sizes or min(sizes) == 0:
        return 0.0, 0.0
    q, a, rest = len(sizes), float(sizes[0]), float(sum(sizes[1:]))
    r = max(ALIGN, -(-max(sizes) // ALIGN) * ALIGN)
    flops = 2.0 * a * d * rest + 2.0 * a * q * q * d
    nbytes = (a + rest) * d * 4.0 + q * r + r * (4.0 * q + 8.0)
    return flops, nbytes


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: seconds."""
    return max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_S)
