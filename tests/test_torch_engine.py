"""The port's maintain-and-serve slice, end to end, against the JAX engine.

One seeded TaFeng-shaped stream (scale 0.02: 278 users x 239 items,
basket additions plus basket and item deletions) drives
``repro.streaming.StreamingEngine`` and the port's engine at
``batch_size=16``, with request batches between chunks of the stream so
the serving corpus goes through its full build, row refresh and
threshold rebuild paths.

Tolerances:
  * state — materialized vectors ``rtol=1e-4, atol=1e-5`` against the
    JAX engine and ``repro.core.RefEngine`` (the bar the JAX package
    holds its own engine to); integer leaves exact.
  * corpus — the cached corpus equals a fresh materialization bitwise.
  * recommendations — ``knn.compare_recommendations`` at ``rtol=1e-5``:
    the port returns the JAX ids exactly wherever neighbour k vs k+1
    and item n vs n+1 are separated by more than 1e-5 relative, and
    score-equivalent items elsewhere; at least 90% of the queries must
    fall in the exact class.
"""
import numpy as np
import pytest

from repro.core import RefEngine
from repro.core.types import KIND_ADD_BASKET, KIND_DEL_BASKET
from repro.data import stream as jstream
from repro.data import synthetic as jsynth
from repro.streaming import StateStore as JStore
from repro.streaming import StoreConfig as JConfig
from repro.streaming import StreamingEngine as JEngine
from repro_torch import convert
from repro_torch.core import knn
from repro_torch.core import types as ttypes
from repro_torch.streaming.engine import StreamingEngine
from repro_torch.streaming.state_store import StateStore, StoreConfig

INT_LEAVES = ("history", "group_sizes", "n_baskets", "n_groups")
METRICS = ("events_processed", "batches", "host_fetches", "dropped_adds",
           "refreshes", "renormalizations", "dead_letters",
           "serve_requests")


@pytest.fixture(scope="module")
def run():
    ds = jsynth.generate("tafeng", scale=0.02, seed=0)
    p = ds.params
    tp = ttypes.TifuParams(**{f: getattr(p, f) for f in
                              ("n_items", "group_size", "r_b", "r_g",
                               "k_neighbors", "alpha")})
    events = jstream.make_stream(ds.histories, deletion_user_rate=0.05,
                                 item_deletion_rate=0.02, seed=0)
    n_users = len(ds.histories)
    n_max = max(len(h) for h in ds.histories.values()) + 2
    b_max = max(len(b) for h in ds.histories.values() for b in h)
    shape = dict(n_users=n_users, n_items=p.n_items, max_baskets=n_max,
                 max_basket_size=b_max)
    jeng = JEngine(JStore(JConfig(**shape)), p, batch_size=16)
    teng = StreamingEngine(StateStore(StoreConfig(**shape), device="cpu"),
                           tp, batch_size=16)
    users = np.arange(n_users)
    recs = []
    # bulk first half, then 64-event trickles with a request batch between
    cut = len(events) // 2
    chunks = [events[:cut]] + [events[i:i + 64]
                               for i in range(cut, len(events), 64)]
    for i, chunk in enumerate(chunks):
        for eng in (jeng, teng):
            eng.submit(chunk)
            eng.run_until_drained()
        if i % 4 == 0 or i == len(chunks) - 1:
            req = users if i == len(chunks) - 1 else users[i % 7::3]
            jids, tids = jeng.recommend(req), teng.recommend(req)
            # held against the corpus the request was served from
            res = knn.compare_recommendations(
                teng.store.corpus(), req, jids, tids, k=p.k_neighbors,
                alpha=p.alpha, rtol=1e-5)
            recs.append((req, jids, tids, res))
    return dict(ds=ds, events=events, jeng=jeng, teng=teng, recs=recs,
                p=p)


def test_stream_is_mixed(run):
    kinds = np.array([ev.kind for ev in run["events"]])
    assert len(kinds) >= 520
    assert set(kinds.tolist()) == {1, 2, 3}
    assert run["teng"].metrics.events_processed == len(run["events"])


def test_metrics_match_jax(run):
    for name in METRICS:
        assert getattr(run["teng"].metrics, name) == \
            getattr(run["jeng"].metrics, name), name
    assert run["teng"].watermark == run["jeng"].watermark
    assert run["teng"].n_pending == run["jeng"].n_pending == 0


def test_state_matches_jax_engine(run):
    exp = convert.state_to_numpy(run["jeng"].store.state)
    got = convert.state_to_numpy(run["teng"].store.state)
    for name in INT_LEAVES:
        np.testing.assert_array_equal(got[name], exp[name], err_msg=name)
    tst, jst = run["teng"].store.state, run["jeng"].store.state
    np.testing.assert_allclose(tst.materialized_user_vecs().numpy(),
                               np.asarray(jst.materialized_user_vecs()),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        tst.materialized_last_group_vecs().numpy(),
        np.asarray(jst.materialized_last_group_vecs()), rtol=1e-4,
        atol=1e-5)


def test_state_matches_ref_engine(run):
    """The paper-faithful ragged engine, fed the events the streaming
    engine applied (deletes beyond the current history are quarantined
    there, so they are skipped here)."""
    ref = RefEngine(run["p"], dtype=np.float32)
    for ev in run["events"]:
        nb = ref.state(ev.user).n_baskets
        if ev.kind == KIND_ADD_BASKET:
            ref.add_basket(ev.user, np.unique(np.asarray(ev.items)))
        elif ev.pos >= nb:
            continue
        elif ev.kind == KIND_DEL_BASKET:
            ref.delete_basket(ev.user, ev.pos)
        else:
            ref.delete_item(ev.user, ev.pos, ev.item)
    st = run["teng"].store.state
    mat = st.materialized_user_vecs().numpy()
    lgv = st.materialized_last_group_vecs().numpy()
    for u in range(st.n_users):
        rs = ref.state(u)
        np.testing.assert_allclose(mat[u], rs.user_vec, rtol=1e-4,
                                   atol=1e-5, err_msg=f"u={u}")
        np.testing.assert_allclose(lgv[u], rs.last_group_vec, rtol=1e-4,
                                   atol=1e-5, err_msg=f"lgv u={u}")
        assert int(st.n_baskets[u]) == rs.n_baskets
        assert st.group_sizes[u, :rs.n_groups].tolist() == rs.group_sizes


def test_cached_corpus_equals_fresh_materialization(run):
    store = run["teng"].store
    assert store.corpus_rows_refreshed > 0       # the row-refresh path ran
    np.testing.assert_array_equal(
        store.corpus().numpy(),
        store.state.materialized_user_vecs().numpy())
    assert store.corpus_full_builds == run["jeng"].store.corpus_full_builds
    assert store.corpus_rows_refreshed == \
        run["jeng"].store.corpus_rows_refreshed


def test_recommendations_match_jax(run):
    total = exact = 0
    assert len(run["recs"]) >= 3
    for users, jids, tids, res in run["recs"]:
        assert tids.shape == jids.shape == (len(users), 10)
        assert tids.dtype == np.int32
        assert res["mismatch"] == 0, res
        total += len(users)
        exact += res["exact"]
    assert exact >= 0.9 * total, (exact, total)


def test_ranking_metrics_match_jax(run):
    from repro.core import knn as jknn
    users, jids, tids, _ = run["recs"][-1]
    truth = [run["ds"].histories[int(u)][-1] for u in users]
    for fn in ("recall_at_k", "ndcg_at_k"):
        assert getattr(knn, fn)(tids, truth, 10) == \
            pytest.approx(getattr(jknn, fn)(jids, truth, 10), abs=1e-6)


# ---------------------------------------------------------------------------
# admission: exactly-once log, dead letters, backpressure
# ---------------------------------------------------------------------------

def _engines(max_pending=None):
    from repro.core.types import TifuParams as JParams
    shape = dict(n_users=6, n_items=30, max_baskets=6, max_basket_size=4)
    jp = JParams(n_items=30, group_size=2)
    tp = ttypes.TifuParams(n_items=30, group_size=2)
    return (JEngine(JStore(JConfig(**shape)), jp, batch_size=4,
                    max_pending=max_pending),
            StreamingEngine(StateStore(StoreConfig(**shape), device="cpu"),
                            tp, batch_size=4, max_pending=max_pending))


def _admission_cases():
    from repro.streaming import Event as JEvent
    add = lambda u, items, s=-1: JEvent(1, u, items=np.asarray(items), seqno=s)
    return {
        "redelivery": [[add(0, [1, 2], 0), add(1, [3], 1), add(0, [4], 2)],
                       [add(0, [1, 2], 0), add(2, [5], 3), add(1, [3], 1)]],
        "malformed": [[add(0, [1]), JEvent(7, 0), add(9, [1]),
                       add(1, []), add(1, [1, 2, 3, 4, 5]), add(1, [31]),
                       JEvent(2, 1, pos=6), JEvent(3, 1, pos=0, item=30),
                       add(2, [4])]],
        "poison_delete": [[add(0, [1, 2]), add(1, [3])],
                          [JEvent(2, 0, pos=3), JEvent(3, 1, pos=0, item=3),
                           JEvent(2, 1, pos=0)]],
    }


@pytest.mark.parametrize("case", sorted(_admission_cases()))
def test_admission_matches_jax(case):
    jeng, teng = _engines()
    for rnd in _admission_cases()[case]:
        results = [eng.submit(rnd, on_invalid="quarantine")
                   for eng in (jeng, teng)]
        assert results[1].__dict__ == results[0].__dict__
        assert jeng.run_until_drained() == teng.run_until_drained()
    assert [why for _, why in teng.dead_letter] == \
        [why for _, why in jeng.dead_letter]
    for name in METRICS + ("dedup_skips", "backpressure_rejections"):
        assert getattr(teng.metrics, name) == getattr(jeng.metrics, name)
    assert teng.watermark == jeng.watermark
    np.testing.assert_array_equal(
        teng.store.state.n_baskets.numpy(),
        np.asarray(jeng.store.state.n_baskets))


def test_backpressure_sheds_a_suffix_like_jax():
    from repro.streaming import Backpressure as JBackpressure
    from repro.streaming import Event as JEvent
    from repro_torch.streaming.engine import Backpressure
    jeng, teng = _engines(max_pending=3)
    events = [JEvent(1, u % 6, items=np.asarray([u]), seqno=u)
              for u in range(6)]
    for eng, exc in ((jeng, JBackpressure), (teng, Backpressure)):
        with pytest.raises(exc) as info:
            eng.submit(events)
        assert (info.value.admitted, info.value.rejected,
                info.value.first_rejected_seqno) == (3, 3, 3)
        shed = eng.submit(events[4:], on_overflow="shed")
        assert shed.rejected == 2          # still gapped at seqno 3
        eng.run_until_drained()
        assert eng.submit(events[3:]).admitted == 3
        eng.run_until_drained()
    assert teng.metrics.backpressure_rejections == \
        jeng.metrics.backpressure_rejections
    assert teng.watermark == jeng.watermark == 5


def test_invalidate_all_rebuilds_the_corpus():
    from repro.streaming import Event as JEvent
    jeng, teng = _engines()
    events = [JEvent(1, u, items=np.asarray([u, u + 7])) for u in range(6)]
    for eng in (jeng, teng):
        eng.submit(events)
        eng.run_until_drained()
        eng.store.corpus()
        eng.store.invalidate_all()
        eng.store.corpus()
    store = teng.store
    assert store.corpus_full_builds == jeng.store.corpus_full_builds == 2
    np.testing.assert_array_equal(
        store.corpus().numpy(),
        store.state.materialized_user_vecs().numpy())
    np.testing.assert_allclose(store.corpus().numpy(),
                               np.asarray(jeng.store.corpus()), rtol=1e-6)
