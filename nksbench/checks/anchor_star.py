"""Whether the anchor-star answers of the window are right.

Every request due in the window must be answered (``unanswered``). A
sample of the answered ones, drawn from the seed, is compared with the
float64 reference (``harness/reference.py``) on the seed's points:

* ``wrong_count``: answers with another number of stars than the
  reference's top-k (exact: 0);
* ``uncovered``: stars whose points do not carry every tag of the query,
  or hold an id outside the corpus (exact: 0);
* ``repeats``: stars whose set of point ids an earlier star of the same
  answer already has, beyond as many as the reference's top-k repeats
  (exact: 0): a top-k that returns one star twice;
* ``nn_excess``: how much farther a star's point of tag j lies from its
  anchor (a point of the star with the first tag) than tag j's nearest
  point does, in squared distance over the query's ``scale2``, the worst
  tag of the star's best anchor: the neighbours (K6's first stage, the
  gather, the id lookup). Ties cost nothing: a point as near as the
  nearest reads 0;
* ``diam_err``: the gap between a star's reported diameter and its
  points' float64 diameter, squared, over ``scale2``: the diameters (K6's
  second stage, the readback);
* ``rank_excess``: how far the i-th least float64 diameter of the answer's
  stars lies outside the reference's band at rank i, squared, over
  ``scale2``, the worst rank, in either direction: above the i-th least of
  the loosest reading (``reference.loosest_topk``: each star's points may
  be any within the fp32 band of the nearest), or below the i-th least of
  the tightest (``reference.tightest_topk``): the selection and sort, and
  stars that are not the least.

``scale2``, the largest squared distance of a point of the query from
their mean, is the size fp32 rounding of squared distances scales with
once centred: the numbers read in units of it.
"""
from __future__ import annotations

import numpy as np
import torch

from harness.reference import (gather_query, nearest_sq, reference,
                               set_diameter)

EXACT = ("unanswered", "wrong_count", "uncovered", "repeats")
NUMBERS = EXACT + ("nn_excess", "diam_err", "rank_excess")


def _star_numbers(corpus, qr, points, cand, scale2: float):
    """(covers, nn_excess, diam_err, float64 diameter) of one star."""
    ids, diam = cand
    members = np.asarray(ids, dtype=np.int64)
    if not len(members) or members.min() < 0 or members.max() >= corpus.n:
        return False, None, None, None
    tags = [set(corpus.tags_of(int(m)).tolist()) for m in members]
    query = qr.tags
    if not all(any(t in ts for ts in tags) for t in query):
        return False, None, None, None
    pts = points[torch.from_numpy(members).to(points.device)].double()
    best = np.inf
    for ai, ts in enumerate(tags):
        if query[0] not in ts:
            continue
        a, worst = pts[ai], 0.0
        for j in range(1, len(query)):
            near = [mi for mi, ms in enumerate(tags) if query[j] in ms]
            d2 = float((pts[near] - a).square().sum(-1).min())
            worst = max(worst, d2 - nearest_sq(qr, a, j))
        best = min(best, worst)
    exact = float(set_diameter(pts))
    return True, best / scale2, abs(diam * diam - exact * exact) / scale2, \
        exact


def _repeats(ids) -> int:
    sets = [tuple(sorted(int(x) for x in s)) for s in ids]
    return len(sets) - len(set(sets))


def compare_sets(corpus, queries, answer_sets: dict, k: int, sample,
                 device, refs: dict | None = None) -> dict:
    """The numbers above for each of several answer lists to the same
    requests (``{label: answers}``, ``answers[i]`` None for an unanswered
    request), each at ``sample`` (indices into its answered requests),
    with the reference computed once a request (or taken from ``refs``,
    request index -> ``reference.Reference``, where the caller has it)."""
    out = {label: dict.fromkeys(NUMBERS, 0.0) for label in answer_sets}
    answered = {label: [i for i, a in enumerate(ans) if a is not None]
                for label, ans in answer_sets.items()}
    for label, ans in answer_sets.items():
        out[label]["unanswered"] = float(len(ans) - len(answered[label]))
    due: dict[int, list] = {}
    for label in answer_sets:
        for s in sample:
            if int(s) < len(answered[label]):
                due.setdefault(answered[label][int(s)], []).append(label)
    points = corpus.points(device)
    for i in sorted(due):
        qr = gather_query(points, corpus.posting, queries[i])
        ref = refs[i] if refs and i in refs else reference(qr, k)
        scale2 = max(qr.scale2, np.finfo(np.float64).tiny)
        for label in due[i]:
            o, prog = out[label], answer_sets[label][i]
            o["wrong_count"] += float(len(prog) != len(ref.answer.diams))
            o["repeats"] += float(max(0, _repeats([c[0] for c in prog])
                                      - _repeats(ref.answer.ids)))
            exact = []
            for cand in prog:
                covers, nn, de, ex = _star_numbers(corpus, qr, points, cand,
                                                   scale2)
                if not covers:
                    o["uncovered"] += 1.0
                    continue
                o["nn_excess"] = max(o["nn_excess"], nn)
                o["diam_err"] = max(o["diam_err"], de)
                exact.append(ex)
            for got, hi, lo in zip(sorted(exact), ref.loosest, ref.tightest):
                o["rank_excess"] = max(o["rank_excess"],
                                       (got * got - hi * hi) / scale2,
                                       (lo * lo - got * got) / scale2)
    del points
    return out


def compare(corpus, queries, answers, k: int, sample, device) -> dict:
    """The numbers above over the answers at ``sample`` (indices into the
    answered ones; ``answers[i]`` is None for an unanswered request)."""
    return compare_sets(corpus, queries, {"run": answers}, k, sample,
                        device)["run"]
