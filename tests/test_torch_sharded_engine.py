"""The port's user-axis sharded engine against the JAX package, on the CPU.

``repro_torch.streaming.ShardedStreamingEngine`` held against the port's
single engine and ``repro.streaming.ShardedStreamingEngine`` (JAX on the
CPU) on the 520-event mixed stream of ``tests/test_sharded_engine.py``:

  * the ported cases of that file: 2- and 4-shard state bitwise the
    port's single engine (same per-row math, disjoint users), allclose
    the JAX engine and ``RefEngine``, ids identical to JAX's sharded
    ``recommend``; crash, restore and reshard 2→4→2 with the legacy-log
    dedup counts; a flat checkpoint resharded; exactly-once under
    cross-shard redelivery and across torn shard commits; the
    layout-mismatch refusal; seqno-less events shed without burning a
    seqno;
  * interop: a 2-shard checkpoint of either package restores into the
    other at 2 shards (leaves and logs equal) and resharded into 3
    (legacy logs equal), and the same sharded state writes the same
    ``SHARDS`` manifest and the same per-shard npz bytes in both;
  * the three-phase step: every shard dispatches before any waits, and
    a step costs each shard at most one counted transfer;
  * ``make_user_shard_devices``, and ``create`` defaulting to CUDA.

Not ported: the two tile-hint tests (tile hints size Pallas grids only).
Tolerances: integer leaves exact; materialized vectors ``rtol=1e-4,
atol=1e-5`` against the JAX engine and ``atol=1e-4`` against
``RefEngine`` (the JAX package's own bars); the port's sharded state is
bitwise its single engine's.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro.core import RefEngine
from repro.parallel.sharding import UserShardSpec as JSpec
from repro.streaming import ShardedStreamingEngine as JSharded
from repro_torch import convert
from repro_torch.core.types import KIND_ADD_BASKET, TifuParams
from repro_torch.launch import make_user_shard_devices
from repro_torch.parallel.sharding import UserShardSpec
from repro_torch.streaming import (Event, ShardedStreamingEngine, StateStore,
                                   StoreConfig, StreamingEngine, engine)
from tests.test_sharded_engine import B, K_NN, M, N, P, TOPN
from tests.test_sharded_engine import random_mixed_events

INT_LEAVES = ("history", "group_sizes", "n_baskets", "n_groups")
TP = TifuParams(**{f.name: getattr(P, f.name)
                   for f in dataclasses.fields(TifuParams)})


def to_port(events):
    return [Event(ev.kind, ev.user, items=ev.items, pos=ev.pos,
                  item=ev.item, seqno=ev.seqno) for ev in events]


def make_single(batch_size=16):
    store = StateStore(StoreConfig(n_users=M, n_items=P.n_items,
                                   max_baskets=N, max_basket_size=B),
                       device="cpu")
    return StreamingEngine(store, TP, batch_size=batch_size)


def make_sharded(n_shards, batch_size=16, **kw):
    return ShardedStreamingEngine.create(
        UserShardSpec(M, n_shards), TP, max_baskets=N, max_basket_size=B,
        devices=make_user_shard_devices(n_shards, ["cpu"]),
        batch_size=batch_size, **kw)


def make_jsharded(n_shards, batch_size=16):
    return JSharded.create(JSpec(M, n_shards), P, max_baskets=N,
                           max_basket_size=B, batch_size=batch_size)


def global_leaves(eng):
    """The nine leaves of either package's sharded engine, global rows."""
    out = {}
    for s, sh in enumerate(eng.shards):
        rows = eng.spec.owned_users(s)
        for name, a in convert.state_to_numpy(sh.store.state).items():
            if name not in out:
                out[name] = np.zeros((M,) + a.shape[1:], a.dtype)
            out[name][rows] = a
    return out


def global_vecs(eng):
    """Global [M, I] materialized user vectors of either package."""
    out = np.empty((M, P.n_items), np.float32)
    for s, sh in enumerate(eng.shards):
        out[eng.spec.owned_users(s)] = np.asarray(
            sh.store.state.materialized_user_vecs())
    return out


def ref_vecs(ref):
    return np.stack([ref.state(u).user_vec.astype(np.float32)
                     for u in range(M)])


def shard_logs(eng):
    return [(sh.watermark, sorted(sh._processed_above), sh._max_delivered,
             sh._next_seqno) for sh in eng.shards]


def legacy_of(eng):
    return [{"n_shards": e["n_shards"],
             "logs": [(lg["watermark"], sorted(lg["processed_above"]))
                      for lg in e["logs"]]} for e in eng._legacy]


def recs_all(eng, **kw):
    return eng.recommend(np.arange(M), topn=TOPN, k=K_NN, **kw)


@pytest.fixture(scope="module")
def stream():
    """The 520-event mixed stream (JAX and port events, same seqnos), the
    RefEngine that drew it and the port's drained single engine."""
    rng = np.random.default_rng(7)
    ref = RefEngine(P, dtype=np.float32)
    jevents = random_mixed_events(rng, ref, 520, M)
    tevents = to_port(jevents)
    single = make_single()
    single.submit(tevents)
    assert single.run_until_drained() == len(tevents)
    return {"jevents": jevents, "tevents": tevents, "ref": ref,
            "single": single, "recs": recs_all(single),
            "recs_q": recs_all(single, quantized=True)}


# ---------------------------------------------------------------------------
# Devices
# ---------------------------------------------------------------------------

def test_make_user_shard_devices(monkeypatch):
    """Round-robin dealing, sharing when shards outnumber devices, every
    visible card by default, and a raise without one."""
    cpu = torch.device("cpu")
    assert make_user_shard_devices(3, ["cpu"]) == [cpu, cpu, cpu]
    devs = ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]
    assert [str(d) for d in make_user_shard_devices(2, devs)] == \
        ["cuda:0", "cuda:1"]
    assert [str(d) for d in make_user_shard_devices(3, devs[:2])] == \
        ["cuda:0", "cuda:1", "cuda:0"]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert [str(d) for d in make_user_shard_devices(2)] == \
        ["cuda:0", "cuda:0"]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_user_shard_devices(2)
    with pytest.raises(ValueError):
        make_user_shard_devices(0, ["cpu"])


def test_create_defaults_to_cuda():
    """Without ``devices`` every shard's store is on CUDA; without a card
    that raises unless the caller names the CPU."""
    spec = UserShardSpec(M, 2)
    if torch.cuda.is_available():
        eng = ShardedStreamingEngine.create(spec, TP, max_baskets=N,
                                            max_basket_size=B)
        assert all(sh.store.device.type == "cuda" for sh in eng.shards)
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedStreamingEngine.create(spec, TP, max_baskets=N,
                                      max_basket_size=B)
    eng = make_sharded(2)
    assert all(sh.store.state.user_vecs.device.type == "cpu"
               for sh in eng.shards)


def test_constructor_checks_the_spec():
    stores = [StateStore(StoreConfig(n_users=4, n_items=P.n_items,
                                     max_baskets=N, max_basket_size=B),
                         device="cpu") for _ in range(2)]
    with pytest.raises(ValueError, match="stores for 3 shards"):
        ShardedStreamingEngine(stores, TP, UserShardSpec(M, 3))
    with pytest.raises(ValueError, match="spec owns 5"):
        ShardedStreamingEngine(stores, TP, UserShardSpec(9, 2))


# ---------------------------------------------------------------------------
# Engine equivalence on the 520-event stream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_stream_bitwise_vs_single_and_ref(stream, n_shards):
    eng = make_sharded(n_shards)
    eng.submit(stream["tevents"])
    assert eng.run_until_drained() == len(stream["tevents"])
    jeng = make_jsharded(n_shards)
    jeng.submit(stream["jevents"])
    assert jeng.run_until_drained() == len(stream["jevents"])
    # bitwise the port's single engine: every leaf, and the vectors
    got = global_leaves(eng)
    want = convert.state_to_numpy(stream["single"].store.state)
    for name in convert.LEAVES:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    vecs = global_vecs(eng)
    np.testing.assert_array_equal(
        vecs, stream["single"].store.state.materialized_user_vecs().numpy())
    # the JAX sharded engine: integer leaves exact, vectors allclose
    jgot = global_leaves(jeng)
    for name in INT_LEAVES:
        np.testing.assert_array_equal(got[name], jgot[name], err_msg=name)
    np.testing.assert_allclose(vecs, global_vecs(jeng), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(vecs, ref_vecs(stream["ref"]), atol=1e-4)
    # ids: the JAX sharded answer and the port's single engine's
    recs = recs_all(eng)
    np.testing.assert_array_equal(recs, recs_all(jeng))
    np.testing.assert_array_equal(recs, stream["recs"])
    recs_q = recs_all(eng, quantized=True)
    np.testing.assert_array_equal(recs_q, recs_all(jeng, quantized=True))
    np.testing.assert_array_equal(recs_q, stream["recs_q"])
    assert eng.events_processed == len(stream["tevents"])
    assert eng.n_pending == eng.dead_letters == 0
    with pytest.raises(ValueError, match="euclidean-only"):
        eng.recommend([0], quantized=True, metric="cosine")
    assert eng.recommend([], topn=TOPN).shape == (0, TOPN)


def test_sharded_crash_restore_and_reshard(stream, tmp_path):
    """Mid-stream commit → restore (2 shards), reshards 2→4 and 4→2, a
    replay of the whole stream after each: the legacy logs dedup
    exactly the committed half, and the answers stay the single
    engine's."""
    events = stream["tevents"]
    half = len(events) // 2

    eng = make_sharded(2)
    eng.submit(events[:half])
    eng.run_until_drained()
    ck2 = str(tmp_path / "ck2")
    eng.checkpoint(ck2, step=1)

    eng2 = make_sharded(2)
    eng2.restore(ck2)
    assert shard_logs(eng2) == shard_logs(eng)
    eng2.submit(events)          # the first half dedups against the log
    assert eng2.n_pending == len(events) - half
    eng2.run_until_drained()
    np.testing.assert_array_equal(recs_all(eng2), stream["recs"])

    eng4 = make_sharded(4)
    eng4.restore(ck2)
    assert eng4._legacy and eng4._legacy[0]["n_shards"] == 2
    assert eng4._next_seqno == half
    res = eng4.submit(events)
    assert res.deduped == half
    assert eng4.n_pending == len(events) - half   # legacy logs dedup
    eng4.run_until_drained()
    np.testing.assert_array_equal(recs_all(eng4), stream["recs"])
    np.testing.assert_array_equal(
        global_vecs(eng4),
        stream["single"].store.state.materialized_user_vecs().numpy())

    # ... and back: a drained 4-shard commit into 2 shards; a further
    # replay is fully deduplicated through the legacy logs
    ck4 = str(tmp_path / "ck4")
    eng4.checkpoint(ck4, step=2)
    with open(os.path.join(ck4, "SHARDS")) as f:
        man = json.load(f)
    assert (man["n_shards"], man["next_seqno"]) == (4, len(events))
    assert [e["n_shards"] for e in man["legacy_logs"]] == [2]
    eng2b = make_sharded(2)
    eng2b.restore(ck4)
    assert [e["n_shards"] for e in eng2b._legacy] == [2, 4]
    res = eng2b.submit(events)
    assert res.deduped == len(events) and eng2b.n_pending == 0
    np.testing.assert_array_equal(recs_all(eng2b), stream["recs"])


def test_flat_single_engine_checkpoint_reshards(stream, tmp_path):
    """A single engine's flat commit (no manifest) restores into a
    sharded deployment as the N=1 case."""
    ck = str(tmp_path / "flat")
    stream["single"].checkpoint(ck, step=3)
    eng = make_sharded(2)
    eng.restore(ck)
    eng.submit(stream["tevents"])       # all processed before the reshard
    assert eng.n_pending == 0
    np.testing.assert_array_equal(recs_all(eng), stream["recs"])


# ---------------------------------------------------------------------------
# Per-shard exactly-once
# ---------------------------------------------------------------------------

def test_exactly_once_under_cross_shard_redelivery(rng):
    """Redelivery before processing, straddling partial processing and
    after a drain never double-applies on any shard."""
    ref = RefEngine(P, dtype=np.float32)
    events = to_port(random_mixed_events(rng, ref, 60, M))
    eng = make_sharded(2, batch_size=4)
    eng.submit(events)
    n0 = eng.n_pending
    eng.submit(events)                  # before any processing
    assert eng.n_pending == n0
    for _ in range(3):                  # partial progress on both shards
        eng.step()
    done = eng.events_processed
    eng.submit(events)                  # straddles processed and pending
    assert eng.n_pending == n0 - done
    eng.run_until_drained()
    eng.submit(events)                  # after the drain: all duplicates
    assert eng.n_pending == 0
    assert eng.events_processed == len(events)
    np.testing.assert_allclose(global_vecs(eng), ref_vecs(ref), atol=1e-4)


def test_exactly_once_across_torn_shard_commits(rng, tmp_path):
    """Only shard 0 commits step 2 (a crash between shard commits);
    restore and a full replay re-apply exactly what shard 1 lost."""
    ref = RefEngine(P, dtype=np.float32)
    events = to_port(random_mixed_events(rng, ref, 60, M))
    half = len(events) // 2
    ck = str(tmp_path / "torn")

    eng = make_sharded(2)
    eng.submit(events[:half])
    eng.run_until_drained()
    eng.checkpoint(ck, step=1)
    eng.submit(events[half:])
    eng.run_until_drained()
    eng.shards[0].checkpoint(eng._shard_dir(ck, 0), step=2)

    eng2 = make_sharded(2)
    eng2.restore(ck)
    assert eng2.shards[0].watermark > eng2.shards[1].watermark
    eng2.submit(events)
    lost = sum(1 for ev in events[half:] if ev.user % 2 == 1)
    assert eng2.n_pending == lost
    eng2.run_until_drained()
    assert eng2.events_processed == lost
    np.testing.assert_allclose(global_vecs(eng2), ref_vecs(ref), atol=1e-4)


def test_checkpoint_refuses_layout_mismatch(tmp_path):
    eng = make_sharded(2)
    eng.add_basket(0, [1, 2, 3])
    eng.delete_item(0, 0, 2)
    eng.run_until_drained()
    eng.checkpoint(str(tmp_path), step=1)
    other = make_sharded(4)
    with pytest.raises(ValueError, match="layout"):
        other.checkpoint(str(tmp_path), step=2)
    eng.delete_basket(0, 0)
    eng.run_until_drained()
    eng.checkpoint(str(tmp_path), step=2)     # the same layout commits
    assert int(eng.shards[0].store.state.n_baskets[0]) == 0


def test_seqnoless_events_shed_without_burning_a_seqno(rng):
    """A seqno-less event the owner shard sheds gets no global seqno: the
    admitted events' seqnos stay dense, and every shard's watermark
    reaches its last delivery once drained (no gap in any log)."""
    eng = make_sharded(2, max_pending=1)
    events = [Event(KIND_ADD_BASKET, u % M,
                    items=rng.choice(P.n_items, size=3,
                                     replace=False).astype(np.int32))
              for u in range(6)]
    res = eng.submit(events, on_overflow="shed")
    assert (res.admitted, res.rejected) == (2, 4)
    assert eng._next_seqno == 2
    eng.run_until_drained()
    res = eng.submit(events[2:4], on_overflow="shed")
    assert (res.admitted, res.rejected) == (2, 0)
    assert eng._next_seqno == 4
    eng.run_until_drained()
    for sh in eng.shards:
        assert sh.watermark == sh._max_delivered
        assert not sh._processed_above
    assert sorted(sh.watermark for sh in eng.shards) == [2, 3]


# ---------------------------------------------------------------------------
# Interop: sharded commits cross the packages both ways
# ---------------------------------------------------------------------------

def half_drained(eng, events):
    """The first 260 events, 6 steps applied: logs with processed seqnos
    above their watermarks."""
    eng.submit(events[:260])
    for _ in range(6):
        eng.step()
    assert any(sh._processed_above for sh in eng.shards)
    assert eng.n_pending > 0


@pytest.mark.parametrize("n_restore", [2, 3])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_sharded_commit_restores_across_packages(stream, tmp_path, writer,
                                                 n_restore):
    d = str(tmp_path / "ck")
    if writer == "jax":
        src, src_events = make_jsharded(2), stream["jevents"]
        dst, dst_events = make_sharded(n_restore), stream["tevents"]
        again = make_jsharded(n_restore)
    else:
        src, src_events = make_sharded(2), stream["tevents"]
        dst, dst_events = make_jsharded(n_restore), stream["jevents"]
        again = make_sharded(n_restore)
    half_drained(src, src_events)
    src.checkpoint(d, 5)
    dst.restore(d)
    again.restore(d)
    if n_restore == 2:
        for a, b in zip(dst.shards, src.shards):
            sa, sb = (convert.state_to_numpy(x.store.state) for x in (a, b))
            for name in convert.LEAVES:
                assert sa[name].dtype == sb[name].dtype, name
                np.testing.assert_array_equal(sa[name], sb[name], name)
        assert shard_logs(dst) == shard_logs(src)
        assert dst._legacy == []
    else:
        ga, gb = global_leaves(dst), global_leaves(src)
        for name in convert.LEAVES:
            np.testing.assert_array_equal(ga[name], gb[name], name)
        assert legacy_of(dst) == legacy_of(again)
        assert [(e["n_shards"], len(e["logs"])) for e in legacy_of(dst)] \
            == [(2, 2)]
    assert dst._next_seqno == again._next_seqno
    # both resume the whole stream: the same dedup, the same state
    n_dst = dst.submit(dst_events).deduped
    assert n_dst == again.submit(src_events).deduped
    assert dst.n_pending == again.n_pending
    dst.run_until_drained()
    again.run_until_drained()
    for name in INT_LEAVES:
        np.testing.assert_array_equal(global_leaves(dst)[name],
                                      global_leaves(again)[name], name)
    np.testing.assert_allclose(global_vecs(dst), global_vecs(again),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        global_vecs(dst),
        stream["single"].store.state.materialized_user_vecs().numpy(),
        rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(recs_all(dst), stream["recs"])


def test_sharded_state_writes_identical_bytes(stream, tmp_path):
    """The same sharded state commits the same ``SHARDS`` manifest (as
    json), the same per-shard ``LATEST`` fields and the same npz bytes
    in both packages, at 2 shards and after a reshard into 3 (legacy
    logs with sorted ``processed_above``)."""
    jeng = make_jsharded(2)
    half_drained(jeng, stream["jevents"])
    jeng.checkpoint(str(tmp_path / "jax2"), 3)
    teng = make_sharded(2)
    teng.restore(str(tmp_path / "jax2"))
    teng.checkpoint(str(tmp_path / "port2"), 3)
    j3, t3 = make_jsharded(3), make_sharded(3)
    j3.restore(str(tmp_path / "jax2"))
    t3.restore(str(tmp_path / "jax2"))
    j3.checkpoint(str(tmp_path / "jax3"), 4)
    t3.checkpoint(str(tmp_path / "port3"), 4)
    for n, step in ((2, 3), (3, 4)):
        a, b = tmp_path / f"jax{n}", tmp_path / f"port{n}"
        with open(a / "SHARDS") as f, open(b / "SHARDS") as g:
            man_a, man_b = json.load(f), json.load(g)
        assert man_a == man_b
        assert man_a["n_shards"] == n and man_a["step"] == step
        if n == 3:
            assert man_a["legacy_logs"][0]["n_shards"] == 2
            assert any(lg["processed_above"]
                       for lg in man_a["legacy_logs"][0]["logs"])
        for s in range(n):
            sd = f"shard_{s:03d}"
            with open(a / sd / "LATEST") as f, open(b / sd / "LATEST") as g:
                la, lb = json.load(f), json.load(g)
            for key in ("step", "npz_crc32", "npz_bytes", "n_users",
                        "n_items", "max_baskets", "max_basket_size",
                        "max_groups", "engine"):
                assert la[key] == lb[key], (n, s, key)
            npz = f"state_{step:010d}.npz"
            assert (a / sd / npz).read_bytes() == (b / sd / npz).read_bytes()


# ---------------------------------------------------------------------------
# The three-phase step
# ---------------------------------------------------------------------------

def test_step_dispatches_every_shard_before_any_waits(stream, monkeypatch):
    order = []
    for name in ("_prepare_step", "_complete_step", "_finish_step"):
        real = getattr(StreamingEngine, name)

        def spy(sh, *a, _real=real, _name=name):
            order.append((_name, sh.store.cfg.n_users))
            return _real(sh, *a)

        monkeypatch.setattr(StreamingEngine, name, spy)
    eng = make_sharded(2)
    eng.submit(stream["tevents"][:40])
    assert eng.step() > 0
    assert [o[0] for o in order] == ["_prepare_step"] * 2 + \
        ["_complete_step"] * 2 + ["_finish_step"] * 2


def test_one_transfer_per_fetching_step(stream, monkeypatch):
    """Over the whole stream each shard's step dispatches at most one
    counted transfer (no maintenance fires on this stream), every
    dispatched transfer is waited for, and ``host_fetches`` counts them;
    the single engine fetches as often."""
    dispatched, waited = [], []
    real_fetch, real_wait = StreamingEngine._fetch, engine._HostFetch.wait

    def fetch(sh, parts):
        dispatched.append(id(sh))
        return real_fetch(sh, parts)

    def wait(pending):
        waited.append(id(pending))
        return real_wait(pending)

    monkeypatch.setattr(StreamingEngine, "_fetch", fetch)
    monkeypatch.setattr(engine._HostFetch, "wait", wait)
    eng = make_sharded(2)
    eng.submit(stream["tevents"])
    steps = 0
    while True:
        before = len(dispatched)
        n = eng.step()
        per_shard = [dispatched[before:].count(id(sh)) for sh in eng.shards]
        assert max(per_shard) <= 1, per_shard
        steps += 1
        if n == 0:
            break
    assert len(waited) == len(dispatched)
    for sh in eng.shards:
        assert sh.metrics.refreshes == sh.metrics.renormalizations == 0
        assert sh.metrics.host_fetches == dispatched.count(id(sh))
        # the first batch (adds only, nothing deferred) fetches nothing;
        # every later one does, and so does the empty step that settles
        # the last batch's deferred summary
        assert sh.metrics.host_fetches == sh.metrics.batches
    single = stream["single"].metrics
    assert single.host_fetches == single.batches
