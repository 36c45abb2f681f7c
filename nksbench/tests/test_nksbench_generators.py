"""The corpora's statistics at small n, against the program's own
generators (``repro_torch.data``) where they share them."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from harness.corpus import make_corpus

BIG_SEED = 2**31 + 12345


def synth(n=50_000, d=8, u=200, t=1, seed=3):
    return make_corpus({"corpus": {"generator": "synthetic", "n": n, "d": d,
                                   "u": u, "t": t,
                                   "coord_range": 10_000.0}}, seed)


def flickr(n=50_000, d=8, u=24_874, seed=3):
    return make_corpus({"corpus": {"generator": "flickr_like", "n": n,
                                   "d": d, "u": u, "t": 11,
                                   "n_clusters": 64, "zipf_a": 1.3,
                                   "affinity": 0.7}}, seed)


@pytest.mark.parametrize("t", [1, 3])
def test_synthetic_postings_are_uniform(t):
    c = synth(t=t)
    sizes = c.posting_sizes()
    assert sizes.sum() == c.n * t
    assert (np.diff(c.kw_offsets) == t).all()
    mean = c.n * t / c.u
    # binomial spread: every posting within 6 sigma of n t / u
    assert np.abs(sizes - mean).max() < 6 * np.sqrt(mean)
    rows = c.kw_values.reshape(c.n, t)
    assert (np.diff(rows, axis=1) > 0).all()          # sorted, distinct
    pts = c.points("cpu")
    assert pts.shape == (c.n, c.d) and pts.dtype == torch.float32
    assert 0.0 <= float(pts.min()) and float(pts.max()) <= 10_000.0
    assert abs(float(pts.mean()) - 5_000.0) < 100.0


def test_same_seed_same_corpus_other_seed_other():
    a, b, c = synth(seed=BIG_SEED), synth(seed=BIG_SEED), synth(seed=7)
    assert np.array_equal(a.kw_values, b.kw_values)
    assert torch.equal(a.points("cpu"), b.points("cpu"))
    assert not np.array_equal(a.kw_values, c.kw_values)
    f1, f2 = flickr(seed=BIG_SEED), flickr(seed=BIG_SEED)
    assert np.array_equal(f1.kw_values, f2.kw_values)
    assert torch.equal(f1.points("cpu"), f2.points("cpu"))


def test_flickr_like_zipf_head_and_tags_per_point():
    c = flickr()
    per_point = np.diff(c.kw_offsets)
    assert per_point.min() >= 8 and per_point.max() <= 11
    rows = [c.tags_of(i) for i in range(0, c.n, 997)]
    assert all((np.diff(r) > 0).all() for r in rows)
    sizes = c.posting_sizes()
    # the head of the Zipf law: popularity falls with the rank
    assert sizes[0] > sizes[5] > sizes[50] > sizes[5000]
    assert np.argmax(sizes) == 0
    assert sizes[0] > 0.5 * c.n          # tag 0 sits in most pools


def test_flickr_like_matches_the_programs_generator():
    """Same statistics as ``repro_torch.data.flickr_like`` (other draws)."""
    from repro_torch.data.flickr_like import flickr_like_dataset

    n = 20_000
    ours = flickr(n=n, d=8)
    theirs = flickr_like_dataset(n=n, d=8, u=24_874, t=11, seed=3)
    mine, ref = ours.posting_sizes(), np.diff(theirs.ikp.offsets)
    assert abs(len(ours.kw_values) / n - theirs.kw.nnz / n) < 0.1
    for rank in (0, 1, 2, 10, 100):
        assert mine[rank] == pytest.approx(ref[rank], rel=0.25, abs=40)
    pts = ours.points("cpu").numpy()
    assert abs(pts.mean() - theirs.points.mean()) < 10.0
    assert pts.std() == pytest.approx(theirs.points.std(), rel=0.1)


def test_postings_invert_the_tags():
    c = flickr(n=5_000)
    for tag in (0, 3, 40):
        ids = c.posting(tag)
        assert (np.diff(ids) > 0).all()
        assert all(tag in c.tags_of(int(i)) for i in ids)
        assert len(ids) == c.posting_sizes()[tag]
