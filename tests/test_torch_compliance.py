"""The port's compliance slice against the JAX package, on the CPU.

Every case of ``tests/test_compliance.py`` runs twice on the same
numpy-seeded stream: through ``repro_torch`` (``forget_user`` on the
single and sharded engines, ``StateStore.scrub_rows`` / ``row_residue``,
``repro_torch.compliance.certify``) and through ``repro.*`` (JAX on the
CPU), and the two are held to each other:

  * receipts equal field for field but ``latency_s``: ``user``,
    ``n_baskets_deleted``, ``seqnos``, ``purged_dead_letters`` and the
    ``residue`` keys and values;
  * reports equal: check names and ``ok`` in order, ``n_users``,
    ``n_events``, ``n_deletion_events``, the three user lists,
    ``envelope_slack`` within 1e-6 and ``overlap_mean`` exactly; where
    a served top-n list differs, it is score-equivalent by
    ``knn.compare_recommendations`` (0 mismatches);
  * the state after the forgets: integer leaves exact, materialized
    vectors ``rtol=1e-4, atol=1e-5``, forgotten rows exactly 0.0.

Also: the ported ragged oracles (``default_group_sizes``,
``user_vector_ragged``, ``basket_weights``, ``divergence_envelope``)
against the reference's on seeded inputs, and checkpoints taken after a
forget restored across the packages both ways, at 1 and 2 shards, and
certified there.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro import compliance as jc
from repro.compliance.certify import _global_leaves as j_leaves
from repro.core import knn as jknn
from repro.core import tifu as jtifu
from repro.streaming import InvalidEventError as JInvalidEventError
from repro_torch import compliance as tc
from repro_torch.compliance.certify import _global_leaves as t_leaves
from repro_torch.core import knn as tknn
from repro_torch.core import tifu as ttifu
from repro_torch.core.types import (KIND_ADD_BASKET, KIND_DEL_BASKET,
                                    KIND_DEL_ITEM, TifuParams)
from repro_torch.launch import make_user_shard_devices
from repro_torch.parallel.sharding import UserShardSpec
from repro_torch.streaming import (Event, ForgetReceipt, InvalidEventError,
                                   ShardedStreamingEngine, StateStore,
                                   StoreConfig, StreamingEngine)
from tests import test_compliance as ref

P, M, N, B = ref.P, ref.M, ref.N, ref.B
TP = TifuParams(**{f.name: getattr(P, f.name)
                   for f in dataclasses.fields(TifuParams)})
INT_LEAVES = ("history", "group_sizes", "n_baskets", "n_groups")


def build(n_shards):
    """The port's engine at the reference module's geometry, on the CPU."""
    if n_shards == 1:
        store = StateStore(StoreConfig(n_users=M, n_items=P.n_items,
                                       max_baskets=N, max_basket_size=B),
                           device="cpu")
        return StreamingEngine(store, TP, batch_size=16)
    return ShardedStreamingEngine.create(
        UserShardSpec(M, n_shards), TP, max_baskets=N, max_basket_size=B,
        devices=make_user_shard_devices(n_shards, ["cpu"]), batch_size=16)


def to_port(events):
    return [Event(ev.kind, ev.user, items=ev.items, pos=ev.pos,
                  item=ev.item, seqno=ev.seqno) for ev in events]


def engines(n_shards):
    """(port engine, JAX engine), both empty."""
    return build(n_shards), ref.build(n_shards)


def feed(t, j, events):
    """Submit the JAX events to the JAX engine, their copies to the
    port's, and drain both; returns both admission results."""
    res = (t.submit(to_port(events)), j.submit(events))
    t.run_until_drained()
    j.run_until_drained()
    return res


def n_baskets(eng, user):
    """One user's basket count in the port's single engine."""
    return int(eng.store.state.n_baskets[user])


def assert_receipts(rt, rj):
    assert isinstance(rt, ForgetReceipt)
    assert (rt.user, rt.n_baskets_deleted, tuple(rt.seqnos),
            rt.purged_dead_letters) == \
        (rj.user, rj.n_baskets_deleted, tuple(rj.seqnos),
         rj.purged_dead_letters)
    assert rt.residue == rj.residue, (rt.residue, rj.residue)
    assert rt.clean == rj.clean
    assert rt.latency_s > 0.0


def forget_both(t, j, user):
    rt, rj = t.forget_user(user), j.forget_user(user)
    assert_receipts(rt, rj)
    return rt


@pytest.fixture
def served(monkeypatch):
    """Records the top-n lists each package's overlap check serves."""
    calls = {"port": [], "jax": []}
    live_t, live_j = tknn.recommend_for_users, jknn.recommend_topn

    def record_t(corpus, user_ids, k, alpha, topn, **kw):
        out = live_t(corpus, user_ids, k=k, alpha=alpha, topn=topn, **kw)
        calls["port"].append((corpus, k, alpha, out.numpy()))
        return out

    def record_j(pred, n):
        out = live_j(pred, n)
        calls["jax"].append(np.asarray(out))
        return out

    monkeypatch.setattr(tknn, "recommend_for_users", record_t)
    monkeypatch.setattr(jknn, "recommend_topn", record_j)
    return calls


def assert_reports(rt, rj, served):
    assert [(c.name, c.ok) for c in rt.checks] == \
        [(c.name, c.ok) for c in rj.checks], (rt.summary(), rj.summary())
    assert (rt.n_users, rt.n_events, rt.n_deletion_events) == \
        (rj.n_users, rj.n_events, rj.n_deletion_events)
    assert rt.pure_add_users == list(rj.pure_add_users)
    assert rt.deletion_users == list(rj.deletion_users)
    assert rt.forgotten_users == list(rj.forgotten_users)
    if np.isfinite(rj.envelope_slack):
        assert abs(rt.envelope_slack - rj.envelope_slack) <= 1e-6
    else:
        assert rt.envelope_slack == rj.envelope_slack
    assert rt.overlap_mean == rj.overlap_mean
    assert len(served["port"]) == len(served["jax"])
    for (corpus, k, alpha, got), want in zip(served["port"],
                                             served["jax"]):
        if not np.array_equal(got, want):
            res = tknn.compare_recommendations(
                corpus, np.arange(corpus.shape[0]), want, got, k=k,
                alpha=alpha)
            assert res["mismatch"] == 0, res


def certify_both(t, j, events, served, tmp_path=None, **kw):
    """Both packages' certificates of one log, held to each other."""
    served["port"].clear()
    served["jax"].clear()
    kt, kj = dict(kw), dict(kw)
    if tmp_path is not None:
        kt["checkpoint_dir"] = str(tmp_path / "port_ck")
        kj["checkpoint_dir"] = str(tmp_path / "jax_ck")
    rt = tc.certify(t, to_port(events), **kt)
    rj = jc.certify(j, events, **kj)
    assert_reports(rt, rj, served)
    return rt


def assert_state(t, j, forgotten=()):
    """Integer leaves exact, materialized vectors rtol=1e-4, atol=1e-5,
    forgotten rows exactly 0.0."""
    lt, lj = t_leaves(t), j_leaves(j)
    for name in INT_LEAVES:
        np.testing.assert_array_equal(lt[name], lj[name], err_msg=name)
    np.testing.assert_allclose(lt["corpus"], lj["corpus"], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(
        lt["last_group_vecs"] * lt["lgv_scale"][:, None],
        lj["last_group_vecs"] * lj["lgv_scale"][:, None], rtol=1e-4,
        atol=1e-5)
    for u in forgotten:
        for name in ("user_vecs", "last_group_vecs", "corpus"):
            assert np.all(lt[name][u] == 0.0), (u, name)


# ---------------------------------------------------------------------------
# The ragged oracles and the envelope, against the reference's
# ---------------------------------------------------------------------------

def test_retained_histories_semantics():
    """Out-of-range/absent deletions noop; baskets dedup, sort, vanish."""
    ev = [Event(KIND_ADD_BASKET, 0, items=[1, 2, 3]),
          Event(KIND_ADD_BASKET, 0, items=[4, 5]),
          Event(KIND_DEL_BASKET, 0, pos=0),
          Event(KIND_DEL_BASKET, 0, pos=5),
          Event(KIND_DEL_ITEM, 0, pos=0, item=4),
          Event(KIND_DEL_ITEM, 0, pos=0, item=9),
          Event(KIND_DEL_ITEM, 0, pos=0, item=5)]
    hist = tc.retained_histories(ev, 2)
    assert hist[0] == [] and hist[1] == []
    ev2 = [Event(KIND_ADD_BASKET, 1, items=[7, 7, 2])]
    hist = tc.retained_histories(ev2, 2)
    assert hist[1][0].tolist() == [2, 7]
    # the seeded burst stream: identical to the reference's replay
    jev = ref.gen_stream(np.random.default_rng(5))
    for got, want in zip(tc.retained_histories(to_port(jev), M),
                         jc.retained_histories(jev, M)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_basket_weights_match_closed_form():
    """Per-basket weights reproduce the Eq. 1+2 ragged oracle."""
    sizes = [3, 3, 2]
    w = tc.basket_weights(sizes, P.r_b, P.r_g)
    assert w.shape == (8,)
    np.testing.assert_array_equal(w, jc.basket_weights(sizes, P.r_b,
                                                       P.r_g))
    hist = [np.array([i % P.n_items]) for i in range(8)]
    v = ttifu.user_vector_ragged(hist, sizes, TP)
    manual = np.zeros(P.n_items)
    for t, b in enumerate(hist):
        manual[b[0]] += w[t]
    np.testing.assert_allclose(v, manual, rtol=1e-12)


def test_divergence_envelope_is_a_bound():
    """E_u bounds the fit gap over random alternative partitions, and
    equals the reference's."""
    rng = np.random.default_rng(0)
    for _ in range(20):
        n = int(rng.integers(1, 12))
        hist = [rng.choice(P.n_items, size=int(rng.integers(1, 4)),
                           replace=False) for _ in range(n)]
        canon = ttifu.default_group_sizes(n, P.group_size)
        alt, left = [], n
        while left:
            tau = int(rng.integers(1, left + 1))
            alt.append(tau)
            left -= tau
        env = tc.divergence_envelope(alt, canon, P.r_b, P.r_g)
        assert env == jc.divergence_envelope(alt, canon, P.r_b, P.r_g)
        d = np.abs(ttifu.user_vector_ragged(hist, alt, TP)
                   - ttifu.user_vector_ragged(hist, canon, TP)).max()
        assert d <= env + 1e-12


def test_divergence_envelope_rejects_mismatched_partitions():
    """Partitions of different basket counts raise ValueError."""
    with pytest.raises(ValueError):
        tc.divergence_envelope([2, 2], [3], P.r_b, P.r_g)


@pytest.mark.parametrize("seed", range(4))
def test_ragged_oracles_match_reference(seed):
    """The ported host oracles are the reference's, bit for bit."""
    rng = np.random.default_rng(seed)
    for n in range(0, 23):
        for m in (1, 2, 3, 7):
            assert ttifu.default_group_sizes(n, m) == \
                jtifu.default_group_sizes(n, m)
    for _ in range(10):
        n = int(rng.integers(1, 16))
        hist = [rng.choice(P.n_items, size=int(rng.integers(1, 5)),
                           replace=False) for _ in range(n)]
        sizes = ttifu.default_group_sizes(n, int(rng.integers(1, 6)))
        np.testing.assert_array_equal(
            ttifu.user_vector_ragged(hist, sizes, TP),
            jtifu.user_vector_ragged(hist, sizes, P))
        for a, b in zip(ttifu.group_vectors_ragged(hist, sizes, TP),
                        jtifu.group_vectors_ragged(hist, sizes, P)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(
            ttifu.multi_hot(np.append(hist[0], -1), P.n_items),
            jtifu.multi_hot(np.append(hist[0], -1), P.n_items))
        r_b, r_g = float(rng.uniform(0.1, 1.0)), float(rng.uniform(0.1, 1))
        np.testing.assert_array_equal(tc.basket_weights(sizes, r_b, r_g),
                                      jc.basket_weights(sizes, r_b, r_g))
        alt = ttifu.default_group_sizes(n, int(rng.integers(1, 6)))
        assert tc.divergence_envelope(sizes, alt, r_b, r_g) == \
            jc.divergence_envelope(sizes, alt, r_b, r_g)


# ---------------------------------------------------------------------------
# Certification: randomized burst streams + violation detection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", [1, 2])
@pytest.mark.parametrize("seed", range(3))
def test_certify_randomized_burst_stream(seed, n_shards, tmp_path, served):
    """Clean burst streams + a forget certify at 1 and 2 shards."""
    rng = np.random.default_rng(seed)
    t, j = engines(n_shards)
    events = ref.gen_stream(rng)
    feed(t, j, events)
    victim = int(rng.integers(0, M))
    receipt = forget_both(t, j, victim)
    assert receipt.clean
    report = certify_both(t, j, events + ref.forget_log(receipt), served,
                          tmp_path, forgotten_users=[victim])
    assert report.compliant, report.summary()
    assert report.envelope_slack <= 0.0
    assert victim in report.forgotten_users
    assert_state(t, j, [victim])


def test_certify_detects_skipped_deletion(served):
    """A deletion the engine never applied fails the certificate."""
    rng = np.random.default_rng(7)
    events = ref.gen_stream(rng)
    skipped = next(e for e in events if e.kind == KIND_DEL_BASKET)
    t, j = engines(1)
    feed(t, j, [e for e in events if e is not skipped])
    report = certify_both(t, j, events, served)
    assert not report.compliant
    assert any(c.name == "structural-retained-equivalence"
               for c in report.violations)


def test_certify_detects_phantom_deletion(served):
    """A deletion absent from the log fails the certificate."""
    rng = np.random.default_rng(8)
    events = ref.gen_stream(rng)
    t, j = engines(1)
    feed(t, j, events)
    u = next(u for u in range(M) if n_baskets(t, u) > 0)
    t.delete_basket(u, 0)
    j.delete_basket(u, 0)
    t.run_until_drained()
    j.run_until_drained()
    report = certify_both(t, j, events, served)
    assert not report.compliant


def test_certify_detects_unforgotten_user(served):
    """Claiming a live user was forgotten fails the no-trace check."""
    rng = np.random.default_rng(9)
    events = ref.gen_stream(rng)
    t, j = engines(1)
    feed(t, j, events)
    u = next(u for u in range(M) if n_baskets(t, u) > 0)
    report = certify_both(t, j, events, served, forgotten_users=[u])
    assert not report.compliant
    assert any(c.name == "no-trace-live" for c in report.violations)


def test_certify_pure_add_stream_is_bitwise(served):
    """A deletion-free stream certifies via the bitwise replay path."""
    rng = np.random.default_rng(3)
    events = [e for e in ref.gen_stream(rng)
              if e.kind == KIND_ADD_BASKET]
    t, j = engines(1)
    feed(t, j, events)
    report = certify_both(t, j, events, served)
    assert report.compliant, report.summary()
    assert report.pure_add_users and not report.deletion_users
    bitwise = next(c for c in report.checks
                   if c.name == "pure-add-bitwise")
    assert "bitwise-equal" in bitwise.detail
    assert_state(t, j)


# ---------------------------------------------------------------------------
# forget_user: receipts, caches, dead letters, seqno discipline
# ---------------------------------------------------------------------------

def test_forget_receipt_and_cache_scrub():
    """forget_user scrubs both serving caches and is idempotent."""
    rng = np.random.default_rng(11)
    t, j = engines(1)
    feed(t, j, ref.gen_stream(rng))
    for eng in (t, j):
        eng.store.corpus()
        eng.store.quantized_corpus()
    nb3 = n_baskets(t, 3)
    assert nb3 > 0
    receipt = forget_both(t, j, 3)
    assert receipt.n_baskets_deleted == nb3
    assert len(receipt.seqnos) == nb3
    assert receipt.clean, receipt.residue
    assert {"corpus_absmax", "quant_nonzero"} <= set(receipt.residue)
    assert float(t.store.corpus()[3].abs().max()) == 0.0
    q, _ = t.store.quantized_corpus()
    assert int((q[3] != 0).sum()) == 0
    again = forget_both(t, j, 3)
    assert again.n_baskets_deleted == 0 and again.clean
    assert_state(t, j, [3])


def test_forget_purges_dead_letters():
    """forget_user drops the user's quarantined dead-letter payloads and
    keeps the queue's bound."""
    t, j = engines(1)
    cap = t.dead_letter.maxlen
    for eng in (t, j):
        eng.add_basket(2, [1, 2])
        eng.run_until_drained()
    t.submit([Event(KIND_DEL_BASKET, 2, pos=17)])
    j.submit([ref.Event(KIND_DEL_BASKET, 2, pos=17)])
    t.run_until_drained()
    j.run_until_drained()
    assert any(ev.user == 2 for ev, _ in t.dead_letter)
    receipt = forget_both(t, j, 2)
    assert receipt.purged_dead_letters >= 1
    assert not any(ev.user == 2 for ev, _ in t.dead_letter)
    assert t.dead_letter.maxlen == cap


def test_forget_during_frozen_serving_reports_residue():
    """A pinned frozen snapshot makes the receipt honestly unclean."""
    t, j = engines(1)
    for eng in (t, j):
        eng.add_basket(1, [4, 5])
        eng.run_until_drained()
        eng.freeze_serving()
    receipt = forget_both(t, j, 1)
    assert not receipt.clean
    assert receipt.residue["frozen_absmax"] > 0.0
    for eng in (t, j):
        eng.thaw_serving()
    assert t.store.row_residue([1])["user_vec_absmax"] == 0.0
    assert t.store.row_residue([1]) == j.store.row_residue([1])


def test_sharded_forget_routes_seqnos_through_router(served):
    """Sharded forget consumes router seqnos; later traffic admits."""
    rng = np.random.default_rng(13)
    t, j = engines(2)
    events = ref.gen_stream(rng)
    feed(t, j, events)
    receipt = forget_both(t, j, 5)
    assert receipt.clean
    more = ref.gen_stream(np.random.default_rng(14), n_events=30,
                          skip=(5,))
    res_t, res_j = feed(t, j, more)
    assert res_t.admitted == len(more) and res_t.deduped == 0
    assert (res_j.admitted, res_j.deduped) == (len(more), 0)
    report = certify_both(t, j, events + ref.forget_log(receipt) + more,
                          served, forgotten_users=[5])
    assert report.compliant, report.summary()
    assert_state(t, j, [5])


def test_sharded_forget_rejects_out_of_range_user():
    """Unknown user ids raise InvalidEventError, not a silent noop."""
    t, j = engines(2)
    with pytest.raises(InvalidEventError):
        t.forget_user(M + 3)
    with pytest.raises(JInvalidEventError):
        j.forget_user(M + 3)


@pytest.mark.parametrize("user", [-1, M])
def test_single_forget_rejects_out_of_range_user(user):
    """The port's single engine raises before any device read (an index
    past the leaf is an error on the card, not a clamp)."""
    t = build(1)
    with pytest.raises(InvalidEventError):
        t.forget_user(user)
    assert t._next_seqno == 0


def test_checkpoint_round_trip_has_no_residue(tmp_path, served):
    """A forgotten row stays zero through checkpoint + restore."""
    rng = np.random.default_rng(17)
    t, j = engines(1)
    events = ref.gen_stream(rng)
    feed(t, j, events)
    receipt = forget_both(t, j, 0)
    t.checkpoint(str(tmp_path / "t"), 1)
    j.checkpoint(str(tmp_path / "j"), 1)
    t2, j2 = engines(1)
    t2.restore(str(tmp_path / "t"))
    j2.restore(str(tmp_path / "j"))
    assert t2.store.row_residue([0])["user_vec_absmax"] == 0.0
    assert n_baskets(t2, 0) == 0
    report = certify_both(t2, j2, events + ref.forget_log(receipt), served,
                          tmp_path / "ck2", forgotten_users=[0])
    assert report.compliant, report.summary()
    assert_state(t2, j2, [0])


# ---------------------------------------------------------------------------
# Commits after a forget, across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", [1, 2])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_forget_commit_restores_across_packages(writer, n_shards,
                                                tmp_path):
    """A commit taken after a forget by one package restores into the
    other, bitwise, and that package's own certificate passes on it."""
    rng = np.random.default_rng(21 + n_shards)
    t, j = engines(n_shards)
    events = ref.gen_stream(rng)
    feed(t, j, events)
    victim = int(rng.integers(0, M))
    receipt = forget_both(t, j, victim)
    log = events + ref.forget_log(receipt)
    ck = str(tmp_path / "ck")
    src = t if writer == "port" else j
    src.checkpoint(ck, 1)
    t2, j2 = engines(n_shards)
    dst, cert, dst_log = ((j2, jc.certify, log) if writer == "port"
                          else (t2, tc.certify, to_port(log)))
    dst.restore(ck)
    want = (t_leaves if writer == "port" else j_leaves)(src)
    got = (j_leaves if writer == "port" else t_leaves)(dst)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    report = cert(dst, dst_log, forgotten_users=[victim],
                  checkpoint_dir=str(tmp_path / "cert_ck"))
    assert report.compliant, report.summary()
    assert victim in report.forgotten_users
    assert all(not (got[name][victim] != 0).any()
               for name in ("user_vecs", "last_group_vecs", "corpus"))
    assert torch.equal(torch.as_tensor(got["n_baskets"][victim]),
                       torch.tensor(0, dtype=torch.int32))
