"""The dispatch cost model's two-point fit (``core.backend.fit_cost_model``)
and its probe on the CPU.

The fit takes probe timings and returns the per-cell and fixed terms; the
prune tier is armed only on the card and only where the coarse counts' slope
is below 0.7 of the masked join's. On the card a slope at or under the
1e-13 s floor is a failed measurement and raises; off the card it is
clamped. Timings here are chosen so that the slopes are exact in binary
floating point (probe spans and time differences are powers of two), so the
0.7 boundary is tested exactly.
"""
import pytest
import torch

from repro_torch.core import backend as tbackend
from repro_torch.core.backend import CELL_FLOOR_S, fit_cost_model

CELLS = (2 ** 20, 2 ** 21)           # a span of 2^20 cells
DEV = 2.0 ** -10                     # masked join: 2^-30 s a cell


def _fit(platform, dev_diff, prune_diff, **kw):
    return fit_cost_model(platform, 64, CELLS, (0.0, dev_diff),
                          (0.0, prune_diff), kw.get("dispatch_s", 1e-3),
                          (32 ** 2, 256 ** 2), kw.get("host_s", (1e-4, 2e-3)))


@pytest.mark.parametrize("ratio,armed", [(0.1, True), (0.5, True),
                                         (0.69, True), (0.7, False),
                                         (0.71, False), (1.0, False),
                                         (2.0, False)])
def test_fit_arms_the_prune_tier_below_seven_tenths(ratio, armed):
    model = _fit("cuda", DEV, ratio * DEV)
    assert model.dev_cell_s == DEV / 2 ** 20
    assert model.prune_cell_s == ratio * DEV / 2 ** 20
    assert model.prune_profitable is armed


@pytest.mark.parametrize("ratio", [0.1, 0.5])
def test_fit_never_arms_off_the_card(ratio):
    assert not _fit("cpu", DEV, ratio * DEV).prune_profitable


def test_fit_fixed_and_host_terms():
    model = _fit("cuda", DEV, DEV / 4, dispatch_s=2e-3, host_s=(1e-4, 2e-3))
    assert model.dev_fixed_s == pytest.approx(2e-3 - CELLS[0] * DEV / 2 ** 20)
    host_cell = (2e-3 - 1e-4) / (256 ** 2 - 32 ** 2)
    assert model.host_cell_s == pytest.approx(host_cell)
    assert model.host_fixed_s == pytest.approx(1e-4 - host_cell * 32 ** 2)
    # on the card half of the host join is charged as settlement, off it all
    assert model.settle_cell_s == pytest.approx(0.5 * host_cell)
    cpu = _fit("cpu", DEV, DEV / 4, dispatch_s=2e-3, host_s=(1e-4, 2e-3))
    assert cpu.settle_cell_s == pytest.approx(host_cell)
    # a dispatch cheaper than its cells' slope leaves no negative fixed term
    assert _fit("cuda", DEV, DEV / 4, dispatch_s=0.0).dev_fixed_s == 0.0


# a slope of exactly the floor: 1.0 s over 10^13 cells rounds to 1e-13
AT_FLOOR = (0, 10 ** 13)


@pytest.mark.parametrize("which", ["dev", "prune"])
@pytest.mark.parametrize("diff", [1.0, 0.5, 0.0, -1.0])
def test_fit_raises_on_the_card_at_or_under_the_floor(which, diff):
    dev = (0.0, diff if which == "dev" else 4.0)
    prune = (0.0, diff if which == "prune" else 2.0)
    args = (64, AT_FLOOR, dev, prune, 1e-3, (32 ** 2, 256 ** 2), (1e-4, 2e-3))
    with pytest.raises(RuntimeError, match="no per-cell time"):
        fit_cost_model("cuda", *args)
    # off the card the same timings are clamped at the floor
    model = fit_cost_model("cpu", *args)
    assert min(model.dev_cell_s, model.prune_cell_s) == CELL_FLOOR_S
    assert not model.prune_profitable


def test_fit_just_above_the_floor_does_not_raise():
    model = fit_cost_model("cuda", 64, AT_FLOOR, (0.0, 4.0), (0.0, 2.0),
                           1e-3, (32 ** 2, 256 ** 2), (1e-4, 2e-3))
    assert model.dev_cell_s == 4e-13 and model.prune_cell_s == 2e-13
    assert model.prune_profitable                # 2e-13 < 0.7 * 4e-13


def test_calibrate_on_the_cpu_keeps_small_probes(monkeypatch):
    """Off the card the probes are 8 subsets of 32 and 256 points, timed by
    the host clock, and the prune tier is never armed."""
    monkeypatch.setattr(tbackend, "_COST_MODELS", {})
    seen = {"masked": set(), "counts": set()}
    masked = tbackend.ops.pairwise_l2_join_batched_masked
    counts = tbackend.ops.pairwise_l2_join_batched_counts

    def rec_masked(x, *a, **kw):
        seen["masked"].add(tuple(x.shape))
        return masked(x, *a, **kw)

    def rec_counts(x, *a, **kw):
        seen["counts"].add(tuple(x.shape))
        return counts(x, *a, **kw)

    monkeypatch.setattr(tbackend.ops, "pairwise_l2_join_batched_masked",
                        rec_masked)
    monkeypatch.setattr(tbackend.ops, "pairwise_l2_join_batched_counts",
                        rec_counts)
    model = tbackend.calibrate_cost_model(5, torch.device("cpu"))
    assert seen["masked"] == seen["counts"] == {(8, 32, 5), (8, 256, 5)}
    assert model.platform == "cpu" and model.d == 5
    assert not model.prune_profitable
    assert model.dev_cell_s >= CELL_FLOOR_S
    assert model.prune_cell_s >= CELL_FLOOR_S
    # memoized per (device type, d)
    assert tbackend.calibrate_cost_model(5, torch.device("cpu")) is model
