"""The plain anchor-star search, the reference that ``correct`` rests on.

The semantics are the device tier's (arXiv 1409.3867's nearest keyword
set query, answered by anchor stars): the anchors are the points of the
query's first tag, in ascending point id; an anchor's star takes, in the
point set of every other tag, the point nearest to the anchor (the lowest
id among equal distances); a star's diameter is the largest distance
between two of its points; the answer is the k stars of least diameter,
ascending, ties to the lower anchor, each given as the sorted set of its
point ids with its diameter.

:func:`search` computes it in float64 on the device of ``points``, the
anchors in blocks so that no distance block exceeds ``block_bytes``.
With ``precision="tf32"`` it is the control: the same search in float32
with every product's inputs rounded to TF32 (10 mantissa bits, round to
nearest even, as the tensor cores take them) and fp32 accumulation, on
points centred as the program centres them, diameters by the Gram
identity: the reference put in the program's place one precision below
the configuration's fp32.

This file imports numpy and torch only: nothing of the program under test
and nothing that it made. The callers hand it points and tag sets that the
benchmark made from the seed.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

EPS32 = 2.0 ** -23
BLOCK_BYTES = 1 << 32


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to TF32 (10 explicit mantissa bits), nearest
    even, kept in fp32."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = (u + 0xFFF + ((u >> 13) & 1)) & 0xFFFFE000
    u = torch.where(u >= (1 << 31), u - (1 << 32), u)
    return u.to(torch.int32).view(torch.float32)


def set_diameter(pts: torch.Tensor) -> torch.Tensor:
    """(..., m, d) float64 -> (...,) the largest pairwise distance, by
    coordinate differences (no norms identity)."""
    diff = pts[..., :, None, :] - pts[..., None, :, :]
    return diff.square().sum(-1).amax(dim=(-1, -2)).sqrt()


@dataclasses.dataclass
class Query:
    """One query's point sets, gathered from the seed's points: ``ids[j]``
    the ascending point ids of tag j, ``pts[j]`` their float64 rows."""

    tags: list[int]
    ids: list[np.ndarray]
    pts: list[torch.Tensor]

    @property
    def centre(self) -> torch.Tensor:
        return torch.cat(self.pts).mean(dim=0)

    @property
    def scale2(self) -> float:
        """The largest squared distance of a point of the query from the
        mean of its point sets: the size that fp32 rounding of squared
        distances scales with, once centred."""
        allp = torch.cat(self.pts)
        return float((allp - self.centre).square().sum(-1).max())


def gather_query(points: torch.Tensor, postings, tags) -> Query:
    ids = [np.asarray(postings(int(t)), dtype=np.int64) for t in tags]
    pts = [points[torch.from_numpy(i).to(points.device)].to(torch.float64)
           for i in ids]
    return Query(list(map(int, tags)), ids, pts)


def _nearest(anchors: torch.Tensor, group: torch.Tensor,
             block_bytes: int, tf32: bool = False) -> torch.Tensor:
    """(A,) index in ``group`` of each anchor's nearest point (lowest
    index among equal minima)."""
    if tf32:
        anchors, group = to_tf32(anchors), to_tf32(group)
    g_sq = group.square().sum(-1)
    rows = max(1, block_bytes // (group.element_size() * max(len(group), 1)))
    out = torch.empty(len(anchors), dtype=torch.int64,
                      device=anchors.device)
    for lo in range(0, len(anchors), rows):
        a = anchors[lo:lo + rows]
        # |a|^2 is the same along a row: the argmin needs |b|^2 - 2 a.b.
        s = torch.addmm(g_sq[None, :], a, group.T, alpha=-2.0)
        out[lo:lo + rows] = s.argmin(dim=1)
        del s
    return out


def stars(q: Query, block_bytes: int = BLOCK_BYTES) -> torch.Tensor:
    """(A, len(tags)) int64: every anchor's star, as indices into each
    tag's point set (column 0 the anchor itself), in float64."""
    anchors = q.pts[0]
    cols = [torch.arange(len(anchors), device=anchors.device)]
    cols += [_nearest(anchors, g, block_bytes) for g in q.pts[1:]]
    return torch.stack(cols, dim=1)


def star_diameters(q: Query, members: torch.Tensor,
                   chunk: int = 1 << 14) -> torch.Tensor:
    """(A,) float64 diameters of the stars ``members`` (from :func:`stars`)."""
    out = torch.empty(len(members), dtype=torch.float64,
                      device=members.device)
    for lo in range(0, len(members), chunk):
        m = members[lo:lo + chunk]
        pts = torch.stack([q.pts[j][m[:, j]] for j in range(m.shape[1])],
                          dim=1)
        out[lo:lo + chunk] = set_diameter(pts)
    return out


def nearest_sq(q: Query, point: torch.Tensor, j: int) -> float:
    """Squared distance, float64, from ``point`` (d,) to tag j's nearest
    point."""
    return float((q.pts[j] - point).square().sum(-1).min())


@dataclasses.dataclass
class Answer:
    """A top-k answer: ``diams`` ascending and ``ids[i]`` the sorted point
    ids of star i."""

    diams: list[float]
    ids: list[tuple[int, ...]]


def _answer(q: Query, members: torch.Tensor, diams: torch.Tensor,
            k: int) -> Answer:
    order = torch.sort(diams, stable=True).indices[:k].cpu().numpy()
    mem = members.cpu().numpy()
    ids = [tuple(sorted({int(q.ids[j][mem[a, j]])
                         for j in range(mem.shape[1])})) for a in order]
    return Answer([float(diams[a]) for a in order], ids)


def search(q: Query, k: int, precision: str = "float64",
           block_bytes: int = BLOCK_BYTES) -> Answer:
    """The top-k answer of one query. ``precision`` ``"float64"``: the
    reference; ``"tf32"``: the control (see the module's docstring)."""
    if any(len(i) == 0 for i in q.ids):
        return Answer([], [])
    if precision == "float64":
        return reference(q, k, block_bytes).answer
    if precision != "tf32":
        raise ValueError(f"unknown precision {precision!r}")
    c = torch.cat(q.pts).float().mean(dim=0)
    pts32 = [(p.float() - c) for p in q.pts]
    anchors = pts32[0]
    cols = [torch.arange(len(anchors), device=anchors.device)]
    cols += [_nearest(anchors, g, block_bytes, tf32=True)
             for g in pts32[1:]]
    members = torch.stack(cols, dim=1)
    diams = torch.empty(len(members), dtype=torch.float32,
                        device=members.device)
    for lo in range(0, len(members), 1 << 14):
        m = members[lo:lo + (1 << 14)]
        x = to_tf32(torch.stack([pts32[j][m[:, j]]
                                 for j in range(m.shape[1])], dim=1))
        gram = torch.bmm(x, x.transpose(1, 2))
        sq = torch.diagonal(gram, dim1=1, dim2=2)
        d2 = (sq[:, :, None] + sq[:, None, :] - 2.0 * gram).clamp_min(0.0)
        diams[lo:lo + len(m)] = d2.amax(dim=(1, 2)).sqrt()
    return _answer(q, members, diams, k)


def alt_band(q: Query) -> float:
    """Squared-distance band within which the program's fp32 search may
    take another point for a nearest one: twice the fp32 error bound of
    a squared distance by the norms identity on centred points,
    ``2 (64 + 4 d) eps32 scale2`` (the device tier's own band form)."""
    d = q.pts[0].shape[1]
    return 2.0 * (64.0 + 4.0 * d) * EPS32 * q.scale2


def loosest_topk(q: Query, members: torch.Tensor, diams: torch.Tensor,
                 k: int) -> list[float]:
    """The k smallest, over the anchors, of the largest diameter a star of
    that anchor can have when each of its points may be any point within
    :func:`alt_band` of the nearest (bounded above by the diameter of the
    anchor with all such points). ``members`` and ``diams`` are the
    float64 stars (:func:`stars`, :func:`star_diameters`). A sound fp32
    search's i-th diameter is no larger, up to its rounding of diameters,
    whichever of tied points it takes."""
    order = torch.sort(diams, stable=True).indices.cpu().numpy()
    tau = alt_band(q)
    best: list[float] = []
    for a in order:
        if len(best) >= k and float(diams[a]) >= best[k - 1]:
            break
        anchor = q.pts[0][a]
        pool = [anchor[None]]
        for g in q.pts[1:]:
            sq = (g - anchor).square().sum(-1)
            pool.append(g[sq <= sq.min() + tau])
        best.append(float(set_diameter(torch.cat(pool))))
        best.sort()
    return best[:k]


def _reach_sq(q: Query, members: torch.Tensor,
             chunk: int = 1 << 14) -> torch.Tensor:
    """(A,) float64: each anchor's largest squared distance to its star's
    neighbours, the nearest point of each other tag. Whatever points within
    the band a star of that anchor takes, its diameter is at least the
    square root of this."""
    anchors = q.pts[0]
    out = torch.zeros(len(members), dtype=torch.float64,
                      device=members.device)
    for lo in range(0, len(members), chunk):
        m, a = members[lo:lo + chunk], anchors[lo:lo + chunk]
        for j in range(1, m.shape[1]):
            out[lo:lo + chunk] = torch.maximum(
                out[lo:lo + chunk],
                (q.pts[j][m[:, j]] - a).square().sum(-1))
    return out


def tightest_topk(q: Query, members: torch.Tensor, diams: torch.Tensor,
                  k: int, block_bytes: int = BLOCK_BYTES) -> list[float]:
    """The k smallest, over the anchors, of the least diameter a star of
    that anchor can have when each of its points may be any point within
    :func:`alt_band` of the nearest: the float64 diameter where every tag
    has one such point, else a lower bound of it (the largest, over pairs
    of tags and over the anchor with each tag, of the least distance
    between their points within the band). A sound fp32 search's i-th
    diameter is no smaller, whichever of tied points it takes. Only
    anchors whose :func:`_reach_sq` lies under the k-th least diameter can
    go below it, and only they are looked at."""
    low = diams.clone()
    if not len(diams):
        return []
    kth = float(torch.sort(diams).values[min(k, len(diams)) - 1])
    cand = torch.nonzero(_reach_sq(q, members) < kth * kth).flatten()
    tau = alt_band(q)
    anchors = q.pts[0]
    widest = max(len(g) for g in q.pts[1:]) if len(q.pts) > 1 else 1
    chunk = max(1, block_bytes // (8 * widest))
    for lo in range(0, len(cand), chunk):
        c = cand[lo:lo + chunk]
        a = anchors[c]
        # each tag's points within the band of the nearest, padded with
        # the nearest to the largest such set of the chunk
        pools, tags, tied = [a[:, None, :]], [0], False
        for j, g in enumerate(q.pts[1:], start=1):
            s = torch.addmm(g.square().sum(-1)[None, :], a, g.T, alpha=-2.0)
            # |a|^2 is the same along a row: the band needs differences only
            width = int((s <= s.amin(dim=1, keepdim=True) + tau)
                        .sum(dim=1).max())
            vals, idx = s.topk(width, dim=1, largest=False)
            del s
            idx = torch.where(vals <= vals[:, :1] + tau, idx, idx[:, :1])
            pools.append(g[idx])
            tags += [j] * width
            tied |= width > 1
        if not tied:
            continue                     # every star as the reference's
        x = torch.cat(pools, dim=1)      # (chunk, points, d)
        at = [torch.tensor([p for p, t in enumerate(tags) if t == j],
                           device=x.device) for j in range(len(q.pts))]
        bound = torch.zeros(len(c), dtype=torch.float64, device=x.device)
        rows = max(1, (1 << 27) // (x.shape[1] ** 2))
        for r0 in range(0, len(c), rows):
            xr = x[r0:r0 + rows]
            sq = xr.square().sum(-1)
            d2 = sq[:, :, None] + sq[:, None, :] \
                - 2.0 * torch.bmm(xr, xr.transpose(1, 2))
            for i in range(len(q.pts)):
                for j in range(i + 1, len(q.pts)):
                    pair = d2[:, at[i]][:, :, at[j]]
                    bound[r0:r0 + rows] = torch.maximum(
                        bound[r0:r0 + rows], pair.amin(dim=(1, 2)))
        low[c] = torch.minimum(low[c], bound.clamp_min(0.0).sqrt())
    return [float(x) for x in torch.sort(low).values[:k]]


@dataclasses.dataclass
class Reference:
    """A query's float64 answer and the band that a sound fp32 search's
    i-th diameter lies in: ``tightest[i]`` <= it <= ``loosest[i]``, up to
    the search's rounding of diameters."""

    answer: Answer
    loosest: list[float]
    tightest: list[float]
    members: torch.Tensor | None = None     # every anchor's star (stars())
    diams: torch.Tensor | None = None       # their float64 diameters


def reference(q: Query, k: int, block_bytes: int = BLOCK_BYTES
              ) -> Reference:
    """The float64 answer of one query, its :func:`loosest_topk` and its
    :func:`tightest_topk`."""
    if any(len(i) == 0 for i in q.ids):
        return Reference(Answer([], []), [], [])
    members = stars(q, block_bytes)
    diams = star_diameters(q, members)
    return Reference(_answer(q, members, diams, k),
                     loosest_topk(q, members, diams, k),
                     tightest_topk(q, members, diams, k, block_bytes),
                     members, diams)
