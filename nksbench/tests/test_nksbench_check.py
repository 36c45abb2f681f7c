"""The check must fail what is wrong: the control (the reference in TF32,
one precision below the configuration's fp32) and faults planted in the
timed path, each driven through a whole run on the CPU at a small size
(``run_cell`` skips the look for a chip). The program's own answers
pass."""
from __future__ import annotations

import pytest
from conftest import BATCH, STREAM, small_cell

from control import control_numbers
from harness.bench import run_cell


def fails(numbers: dict, limits: dict) -> list[str]:
    return [k for k, v in numbers.items() if k in limits and v > limits[k]]


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("workload", [STREAM, BATCH])
def test_control_fails_the_check(workload, seed):
    """The control (the reference in TF32) and each fault planted in the
    reference put in the program's place; ``repeat_first`` only where k
    is over 1."""
    c = small_cell(workload)
    by_way = control_numbers(c, seed, 2.0, "cpu")
    for way, numbers in by_way.items():
        if way == "repeat_first" and c.mix["k"] == 1:
            continue
        assert fails(numbers, c.limits), (way, numbers)


def _alter_ids(monkeypatch):
    from repro_torch.serve import engine as eng

    inner = eng.NKSEngine._device_topk

    def altered(self, keywords, k, *a, **kw):
        out = inner(self, keywords, k, *a, **kw)
        if out:
            c = out[0]
            ids = tuple(sorted({(i + 1) % self.dataset.n for i in c.ids}))
            out[0] = type(c)(ids, c.diameter)
        return out
    monkeypatch.setattr(eng.NKSEngine, "_device_topk", altered)


def _alter_diameter(monkeypatch):
    from repro_torch.serve import engine as eng

    inner = eng.NKSEngine._device_topk

    def altered(self, keywords, k, *a, **kw):
        out = inner(self, keywords, k, *a, **kw)
        if out:
            c = out[-1]
            out[-1] = type(c)(c.ids, c.diameter * 1.001 + 1e-3)
        return out
    monkeypatch.setattr(eng.NKSEngine, "_device_topk", altered)


def _second_best(monkeypatch):
    """The top-k select skips the best star: stars 2 to k + 1."""
    from repro_torch.core import distributed as dist

    inner = dist.anchor_topk

    def skipped(groups, mask, ids, k, **kw):
        diams, cids = inner(groups, mask, ids, k + 1, **kw)
        return diams[1:], cids[1:]
    monkeypatch.setattr(dist, "anchor_topk", skipped)


def _repeat_first(monkeypatch):
    """The top-k gather returns the best star in every row."""
    from repro_torch.core import distributed as dist

    inner = dist.anchor_topk

    def repeated(groups, mask, ids, k, **kw):
        diams, cids = inner(groups, mask, ids, k, **kw)
        return diams[:1].expand_as(diams), cids[:1].expand_as(cids)
    monkeypatch.setattr(dist, "anchor_topk", repeated)


def _not_nearest(monkeypatch):
    """The neighbour stage takes, for every anchor and tag, the
    second-nearest valid point, with the diameters of those stars."""
    import torch

    from repro_torch.kernels import ops

    inner = ops.anchor_star

    def farther(groups, mask, **kw):
        nn, worst, diam = inner(groups, mask, **kw)
        a0 = kw.get("anchor_range", (0, 0))[0] if kw.get("anchor_range") \
            else 0
        anchors = groups[0, a0:a0 + len(diam)]
        nn = nn.clone()
        for j in range(1, groups.shape[0]):
            d2 = torch.cdist(anchors, groups[j]).square()
            d2[:, ~mask[j]] = torch.inf
            if int(mask[j].sum()) > 1:
                nn[:, j] = d2.topk(2, dim=1, largest=False).indices[:, 1]
        pts = torch.stack([groups[j][nn[:, j].long()]
                           for j in range(groups.shape[0])], dim=1)
        pts[:, 0] = anchors
        diam = torch.cdist(pts, pts).amax(dim=(1, 2))
        return nn, worst, diam
    monkeypatch.setattr(ops, "anchor_star", farther)


def _drop_half(monkeypatch):
    from repro_torch.serve import engine as eng

    inner = eng.NKSEngine.query_batch

    def halved(self, queries, *a, **kw):
        out = inner(self, queries, *a, **kw)
        return out[:max(1, len(out) // 2)] if len(out) > 1 else out
    monkeypatch.setattr(eng.NKSEngine, "query_batch", halved)


def _drop_stars(monkeypatch):
    from repro_torch.serve import engine as eng

    inner = eng.NKSEngine._device_topk

    def fewer(self, keywords, k, *a, **kw):
        return inner(self, keywords, k, *a, **kw)[:max(0, k // 2)]
    monkeypatch.setattr(eng.NKSEngine, "_device_topk", fewer)


@pytest.mark.parametrize("workload,fault", [
    (STREAM, _alter_ids), (STREAM, _alter_diameter), (STREAM, _drop_stars),
    (STREAM, _second_best), (STREAM, _repeat_first), (STREAM, _not_nearest),
    (BATCH, _alter_ids), (BATCH, _alter_diameter), (BATCH, _drop_half),
    (BATCH, _second_best), (BATCH, _not_nearest),
])
def test_planted_faults_make_the_run_incorrect(monkeypatch, workload, fault):
    fault(monkeypatch)
    out = run_cell(small_cell(workload), 77, 2.0, False, device="cpu")
    assert out["correct"] is False, out["checks"]


def test_sound_run_is_correct():
    out = run_cell(small_cell(BATCH), 78, 2.0, False, device="cpu")
    assert out["correct"] is True, out["checks"]
