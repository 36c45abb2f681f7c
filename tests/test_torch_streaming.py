"""The port's streaming engine against the reference's, on the CPU.

Both engines start from the same seeded corpus with the hash geometry pinned
and go through the cases of the reference's ``tests/test_streaming.py``
(inserts, bulk and delta deletes, an insert/delete/compact interleaving,
external ids across compaction, cache purges across generations,
auto-compaction). After every op they must agree on the external ids
returned, the delta/tombstone/generation counts, the delta's bucket matrices
(K5's keys, settled against the batch's numpy product, against the
reference's numpy binning), the compacted indices, and the answers, bit for
bit per backend: the port's numpy backend against the reference's, the
port's torch backend (``device="cpu"``) against the reference's Pallas
backend pinned to the device route. The port's answers must also equal a
fresh port engine's over the equivalent static corpus, as the reference's
suite holds the reference.
"""
import numpy as np
import pytest
import torch

from repro.core.backend import PallasBackend
from repro.core.index import build_index as ref_build_index
from repro.data.synthetic import random_queries
from repro.data.synthetic import synthetic_dataset as ref_synth
from repro.serve.engine import NKSEngine as RefEngine
from repro_torch.core.backend import TorchBackend
from repro_torch.core.types import make_dataset
from repro_torch.serve.engine import NKSEngine

torch.set_num_threads(1)

U = 18


def _cands(results):
    return [[(c.ids, c.diameter) for c in r.candidates] for r in results]


def _port(ds):
    return make_dataset(ds.points, [ds.kw.row(i).tolist()
                                    for i in range(ds.n)], n_keywords=U)


class Twin:
    """The reference engine and the port's, driven op for op, with the live
    corpus mirrored in external-id order (for fresh comparison engines)."""

    def __init__(self, base, pinned, **kw):
        self.ref = RefEngine(base, **pinned, **kw)
        self.port = NKSEngine(_port(base), device="cpu", **pinned, **kw)
        self.pinned = pinned
        self.pts = [base.points[i] for i in range(base.n)]
        self.kws = [base.kw.row(i).tolist() for i in range(base.n)]
        self.alive = [True] * base.n
        self.check_state()

    def insert(self, pts, kws):
        ext = self.ref.insert(pts, kws)
        got = self.port.insert(pts, kws)
        assert got.tolist() == ext.tolist()
        self.pts += list(pts)
        self.kws += [list(k) for k in kws]
        self.alive += [True] * len(pts)
        self.check_state()
        return got

    def delete(self, ext_ids):
        assert self.port.delete(ext_ids) == self.ref.delete(ext_ids)
        for i in ext_ids:
            self.alive[int(i)] = False
        self.check_state()

    def compact(self):
        done = self.ref.compact()
        assert self.port.compact() == done
        self.check_state()
        return done

    def check_state(self):
        r, p = self.ref, self.port
        assert (p.delta_points, p.tombstone_count, p.corpus_generation,
                p.next_external_id) == \
            (r.delta_points, r.tombstone_count, r.corpus_generation,
             r.next_external_id)
        assert p.ingest.as_dict() == {
            k: v for k, v in r.ingest.as_dict().items()
            if k in p.ingest.as_dict()}
        np.testing.assert_array_equal(p._ext_of, r._ext_of)
        np.testing.assert_array_equal(p.dataset.points, r.dataset.points)
        for key in r._deltas:
            for s in range(r._deltas[key].index.n_scales):
                np.testing.assert_array_equal(
                    p._deltas[key].bucket_matrix(s),
                    r._deltas[key].bucket_matrix(s))
        for mine, theirs in ((p.index_e, r.index_e), (p.index_a, r.index_a)):
            assert mine.w0 == theirs.w0
            for a, b in zip(mine.structures, theirs.structures):
                for x, y in ((a.table, b.table), (a.khb, b.khb)):
                    np.testing.assert_array_equal(x.offsets, y.offsets)
                    np.testing.assert_array_equal(x.values, y.values)

    def fresh(self):
        """A fresh port engine over the live corpus + its row -> external
        id map."""
        ids = np.flatnonzero(self.alive)
        ds = make_dataset(np.stack([self.pts[i] for i in ids]),
                          [self.kws[i] for i in ids], n_keywords=U)
        return NKSEngine(ds, device="cpu", **self.pinned), ids

    def check_answers(self, queries, k=2, pallas=False):
        fresh, ext = self.fresh()
        backends = [("numpy", "numpy")]
        if pallas:
            backends.append(("torch", PallasBackend(route="device",
                                                    interpret=True)))
        for tier in ("exact", "approx"):
            got = {}
            for mine, theirs in backends:
                got[mine] = _cands(self.port.query_batch(
                    queries, k=k, tier=tier, backend=mine))
                assert got[mine] == _cands(self.ref.query_batch(
                    queries, k=k, tier=tier, backend=theirs)), (tier, mine)
            want = [[(tuple(int(ext[i]) for i in ids), dm) for ids, dm in r]
                    for r in _cands(fresh.query_batch(queries, k=k, tier=tier,
                                                      backend="numpy"))]
            assert got["numpy"] == want, tier
            st = self.port.last_batch_stats
            assert (st.corpus_generation, st.delta_points, st.tombstones) \
                == (self.port.corpus_generation, self.port.delta_points,
                    self.port.tombstone_count)


@pytest.fixture(scope="module")
def base():
    return ref_synth(n=260, d=6, u=U, t=2, seed=7)


@pytest.fixture(scope="module")
def pool():
    return ref_synth(n=160, d=6, u=U, t=2, seed=8)


@pytest.fixture(scope="module")
def pinned(base):
    probe = ref_build_index(base, m=2, n_scales=5, exact=True, seed=0)
    return dict(m=2, n_scales=5, seed=0, w0=probe.w0,
                n_buckets=probe.structures[0].n_buckets)


def _chunk(pool, lo, hi):
    return pool.points[lo:hi], [pool.kw.row(i).tolist() for i in range(lo, hi)]


def test_insert_parity(base, pool, pinned):
    twin = Twin(base, pinned, auto_compact=False)
    queries = random_queries(base, 2, 4, seed=3) \
        + random_queries(base, 3, 4, seed=4)
    ext = twin.insert(*_chunk(pool, 0, 60))
    assert ext.tolist() == list(range(260, 320))
    twin.check_answers(queries)


def test_delete_parity_bulk_and_delta(base, pool, pinned):
    twin = Twin(base, pinned, auto_compact=False)
    queries = random_queries(base, 3, 6, seed=5)
    twin.insert(*_chunk(pool, 0, 40))
    first = twin.port.query_batch(queries, k=1, tier="exact", backend="numpy")
    victim = first[0].candidates[0].ids[0]
    twin.delete([victim, 7, 33, 120, 261, 285])
    assert twin.port.tombstone_count == 6
    twin.check_answers(queries)
    for tier in ("exact", "approx"):
        for r in twin.port.query_batch(queries, k=2, tier=tier):
            assert all(victim not in c.ids for c in r.candidates)


def test_interleaved_ops_parity(base, pool, pinned):
    twin = Twin(base, pinned, auto_compact=False)
    queries = random_queries(base, 2, 3, seed=6) \
        + random_queries(base, 3, 3, seed=7)
    rng = np.random.default_rng(11)
    cursor = 0
    for op in ["insert", "delete", "insert", "compact", "delete", "insert",
               "compact", "insert", "delete"]:
        if op == "insert":
            twin.insert(*_chunk(pool, cursor, cursor + 25))
            cursor += 25
        elif op == "delete":
            live = np.flatnonzero(twin.alive)
            twin.delete(rng.choice(live, size=6, replace=False).tolist())
        else:
            assert twin.compact()
            assert twin.port.delta_points == twin.port.tombstone_count == 0
        twin.check_answers(queries)
    assert twin.port.corpus_generation == 2
    assert twin.port.ingest.compactions == 2


def test_parity_with_device_backends(base, pool, pinned):
    twin = Twin(base, pinned, auto_compact=False)
    queries = random_queries(base, 3, 4, seed=8)
    twin.insert(*_chunk(pool, 0, 50))
    twin.delete([3, 262, 290])
    twin.check_answers(queries, pallas=True)


def test_external_ids_stable_across_compaction(base, pool, pinned):
    twin = Twin(base, pinned, auto_compact=False)
    queries = random_queries(base, 2, 4, seed=9)
    twin.insert(*_chunk(pool, 0, 30))
    twin.delete([1, 2, 263])
    before = _cands(twin.port.query_batch(queries, k=2, tier="exact",
                                          backend="numpy"))
    assert twin.compact()
    assert _cands(twin.port.query_batch(queries, k=2, tier="exact",
                                        backend="numpy")) == before
    twin.check_answers(queries)


def test_trailing_trim_compaction_keeps_external_ids(base, pool, pinned):
    twin = Twin(base, pinned, auto_compact=False)
    twin.delete([base.n - 1])
    assert twin.compact()
    ext = twin.insert(pool.points[:1], [pool.kw.row(0).tolist()])
    assert ext.tolist() == [base.n]
    kws = pool.kw.row(0).tolist()
    singles = sum(1 for i in range(base.n - 1)
                  if set(kws) <= set(base.kw.row(i).tolist()))
    res = twin.port.query_batch([kws], k=singles + 2, tier="exact",
                                backend="numpy")[0]
    all_ids = {i for c in res.candidates for i in c.ids}
    assert int(ext[0]) in all_ids and base.n - 1 not in all_ids
    twin.check_answers([kws], k=singles + 2)
    twin.delete([int(ext[0])])
    assert twin.port.tombstone_count == 1


def test_cache_across_generations(base, pool, pinned):
    """Absorbs keep the torch backend's cache (its unit is a dispatch tile:
    entries cached before an insert survive it, and repeated batches hit),
    compaction purges it once, and the first batch after it equals a cold
    engine's."""
    twin = Twin(base, pinned, auto_compact=False)
    queries = random_queries(base, 3, 6, seed=10)
    be = TorchBackend(device="cpu", route="device")
    eng = twin.port
    eng.query_batch(queries, k=2, tier="exact", backend=be)
    h0, m0 = be.stats.cache_hits, be.stats.cache_misses
    eng.query_batch(queries, k=2, tier="exact", backend=be)
    assert be.stats.cache_hits > h0 and be.stats.cache_misses == m0
    before = set(be._cache)
    twin.insert(*_chunk(pool, 0, 40))
    eng.query_batch(queries, k=2, tier="exact", backend=be)
    assert before and before <= set(be._cache)
    h1 = be.stats.cache_hits
    eng.query_batch(queries, k=2, tier="exact", backend=be)
    assert be.stats.cache_hits > h1
    assert be.stats.generation_purges == 0
    assert twin.compact()
    h2, m2 = be.stats.cache_hits, be.stats.cache_misses
    got = _cands(eng.query_batch(queries, k=2, tier="exact", backend=be))
    assert be.stats.generation_purges == 1
    assert be.stats.cache_hits == h2 and be.stats.cache_misses > m2
    want = _cands(twin.ref.query_batch(
        queries, k=2, tier="exact",
        backend=PallasBackend(route="device", interpret=True)))
    assert got == want


def test_auto_compaction_cadence(base, pool, pinned):
    twin = Twin(base, pinned, compact_min=50, compact_ratio=0.1)
    twin.insert(*_chunk(pool, 0, 30))
    assert twin.port.corpus_generation == 0 and twin.port.delta_points == 30
    twin.insert(*_chunk(pool, 30, 60))     # churn 60 >= max(50, 26)
    assert twin.port.corpus_generation == 1
    assert twin.port.ingest.compactions == 1
    twin.port.query_batch(random_queries(base, 2, 2, seed=1), tier="approx",
                          backend="numpy")
    assert twin.port.last_batch_stats.ingest == {
        "generation": 1, "delta_points": 0, "tombstones": 0,
        "compactions": 1}


def test_single_query_path_and_device_tier(base, pool, pinned):
    twin = Twin(base, pinned, auto_compact=False)
    twin.insert(*_chunk(pool, 0, 20))
    twin.delete([0, 261])
    q = random_queries(base, 2, 1, seed=12)[0]
    single = twin.port.query(q, k=2, tier="exact")
    assert [(c.ids, c.diameter) for c in single.candidates] == \
        _cands(twin.ref.query_batch([q], k=2, tier="exact",
                                    backend="numpy"))[0]
    res = twin.port.query(q, k=1, tier="device")
    assert res.candidates
    assert all(0 not in c.ids and 261 not in c.ids for c in res.candidates)
    ref_dev = twin.ref.query(q, k=1, tier="device")
    assert [c.ids for c in res.candidates] == \
        [c.ids for c in ref_dev.candidates]


def test_ingest_validation(base, pinned):
    twin = Twin(base, pinned, auto_compact=False)
    eng = twin.port
    with pytest.raises(ValueError):
        eng.insert(np.zeros((2, 3), np.float32), [[1], [2]])
    with pytest.raises(ValueError):
        eng.insert(np.zeros((1, 6), np.float32), [[U + 5]])
    with pytest.raises(ValueError):
        eng.insert(np.zeros((2, 6), np.float32), [[1]])
    with pytest.raises(KeyError):
        eng.delete([10_000])
    twin.delete([5])
    with pytest.raises(KeyError):
        eng.delete([5])
    with pytest.raises(KeyError):
        eng.delete([6, 6])
    assert eng.tombstone_count == 1 and eng.delete([]) == 0
    # a corpus built without attribute or tenant columns rejects both
    with pytest.raises(ValueError, match="schema"):
        eng.insert(np.zeros((1, 6), np.float32), [[1]],
                   attrs={"a": np.zeros(1)})
    with pytest.raises(ValueError, match="tenant"):
        eng.insert(np.zeros((1, 6), np.float32), [[1]], tenant=0)
    assert eng.delta_points == 0


def test_delete_everything_does_not_autocompact(base, pinned):
    small = make_dataset(base.points[:8],
                         [base.kw.row(i).tolist() for i in range(8)],
                         n_keywords=U)
    eng = NKSEngine(small, device="cpu", compact_min=2, compact_ratio=0.1,
                    **pinned)
    with pytest.raises(ValueError):
        eng.insert(np.zeros((1, 5), np.float32), [[0]])
    eng.delete(list(range(8)))
    assert eng.tombstone_count == 8
    for tier in ("exact", "approx"):
        assert eng.query_batch([[0, 1]], k=1, tier=tier,
                               backend="numpy")[0].candidates == []
    with pytest.raises(ValueError):
        eng.compact()
    ids = eng.insert(base.points[8:10],
                     [base.kw.row(i).tolist() for i in range(8, 10)])
    assert ids.tolist() == [8, 9]
    assert eng.compact() or eng.corpus_generation >= 1
