"""The general traffic generator and the frozen log's provenance."""
from __future__ import annotations

import json

import numpy as np
from conftest import BATCH, STREAM, small_cell

from draw_log import draw
from harness.corpus import make_corpus
from harness.traffic import (check_sample, make_traffic, poisson_gaps,
                             warmup_queries)


def test_open_loop_same_gaps_for_every_seed_in_another_order():
    c = small_cell(STREAM)
    corpus = make_corpus(c.config, 1)
    a = make_traffic(c.mix, corpus, 11, 5.0)
    b = make_traffic(c.mix, corpus, 2**31 + 99, 5.0)
    assert len(a.due_s) == len(b.due_s) == round(20.0 * 5.0)
    ga, gb = np.diff(a.due_s), np.diff(b.due_s)
    assert not np.array_equal(ga, gb)
    full = np.sort(poisson_gaps(len(a.due_s), 20.0))
    for g in (ga, gb):
        # every gap but the unused last one is one of the fixed set's
        assert np.isin(np.round(g, 12), np.round(full, 12)).all()
    assert a.due_s[0] == 0.0 and a.due_s[-1] < 5.0
    assert abs(poisson_gaps(10_000, 20.0).mean() - 1 / 20.0) < 1e-3
    for q in a.queries:
        assert len(q) == 9 and len(set(q)) == 9
    assert a.queries != b.queries
    assert a.k == 10 and a.tier == "device"


def test_closed_loop_replays_the_log_and_wraps():
    c = small_cell(BATCH)
    corpus = make_corpus(c.config, 1)
    t = make_traffic(c.mix, corpus, 5, 30.0)
    log = c.mix["query"]["log"]
    assert t.queries == log and t.batch == 8 and t.k == 1
    assert t.batch_at(0) == log[:8]
    n_batches = len(log) // 8
    assert t.batch_at(n_batches) == log[:8]
    assert make_traffic(c.mix, corpus, 6, 30.0).queries == log
    assert warmup_queries(c.mix, corpus, 5, 8) == log[:8]


def test_check_sample_is_seeded():
    a, b = check_sample(500, 48, 3), check_sample(500, 48, 3)
    assert np.array_equal(a, b) and len(a) == 48 and len(set(a)) == 48
    assert (np.diff(a) > 0).all() and a.max() < 500
    assert np.array_equal(check_sample(10, 48, 3), np.arange(10))


def test_frozen_log_is_the_drawn_one():
    c = small_cell(BATCH)
    config = json.loads(json.dumps(c.config))
    config["corpus"]["n"] = 1_000_000
    assert draw(config, 256, 3) == c.mix["query"]["log"]
