"""Faults through the port's sharded engine, on the CPU.

The sharded cases of the JAX package's ``tests/test_faults.py``, ported:
backpressure aggregated across shards (the router probes the owner
shard before burning a global seqno), the router's quarantine of
unroutable users, ``recover_shard`` serving through a recovery and
through a failure, the restore diagnostics (a missing or partial shard
directory named, a torn manifest, the refusal to commit over a corrupt
manifest, invalid UTF-8 read as corruption) and the legacy ``ENGINE``
file through a 1-shard router and resharded into 2.

And the sharded rows of ``tests/test_chaos_soak.py``'s tier-1 quick
schedules (``QUICK``: 2 and 4 shards; ``ASYNC_QUICK``: 2 shards), plus a
crash at each ``SHARDS`` manifest site: the 520-event mixed stream
driven through a crash, a torn shard npz or seeded redelivery, then a
fresh engine restores and takes the stream again with duplicates.  The
recovered state must be BITWISE the port's fault-free single engine and
allclose (``atol=1e-4``) ``RefEngine``, its answers identical.  The
``chaos``-marked soaks and the forget-burst schedules stay out, as in
the reference.
"""
import dataclasses
import json
import os
import shutil

import numpy as np
import pytest

from repro.core import RefEngine
from repro_torch.core.types import KIND_ADD_BASKET, TifuParams
from repro_torch.launch import make_user_shard_devices
from repro_torch.parallel.sharding import UserShardSpec
from repro_torch.streaming import (AsyncCheckpointer, Backpressure,
                                   CorruptCheckpointError, Event,
                                   InvalidEventError, ShardedStreamingEngine,
                                   StateStore, StoreConfig, StreamingEngine,
                                   faults)
from tests import test_chaos_soak as chaos
from tests.test_faults import P as FP

M = 8           # users
NB, BS = 24, 6  # max_baskets, max_basket_size


def tparams(p):
    return TifuParams(**{f.name: getattr(p, f.name)
                         for f in dataclasses.fields(TifuParams)})


def make_engine(p=FP, n_users=M, max_baskets=NB, max_basket_size=BS,
                **kw):
    store = StateStore(StoreConfig(n_users=n_users, n_items=p.n_items,
                                   max_baskets=max_baskets,
                                   max_basket_size=max_basket_size),
                       device="cpu")
    return StreamingEngine(store, tparams(p), batch_size=16, **kw)


def make_sharded(n_shards, p=FP, max_baskets=NB, max_basket_size=BS,
                 **kw):
    return ShardedStreamingEngine.create(
        UserShardSpec(M, n_shards), tparams(p), max_baskets=max_baskets,
        max_basket_size=max_basket_size,
        devices=make_user_shard_devices(n_shards, ["cpu"]), batch_size=16,
        **kw)


def add_events(rng, n, start_seqno=0):
    """n valid add-basket events with explicit consecutive seqnos."""
    return [Event(KIND_ADD_BASKET, int(rng.integers(0, M)),
                  items=rng.choice(FP.n_items, size=3,
                                   replace=False).astype(np.int32),
                  seqno=start_seqno + i)
            for i in range(n)]


def vecs(store):
    return store.state.materialized_user_vecs().numpy()


def global_vecs(eng, n_items):
    out = np.empty((M, n_items), np.float32)
    for s, sh in enumerate(eng.shards):
        out[eng.spec.owned_users(s)] = vecs(sh.store)
    return out


# ---------------------------------------------------------------------------
# Admission through the router
# ---------------------------------------------------------------------------

def test_sharded_backpressure_aggregates_across_shards(rng):
    """The router probes the owner shard before burning a global seqno;
    rejected events stay seqno-less and a later resubmit drains fine."""
    eng = make_sharded(2, max_pending=2)
    events = [Event(KIND_ADD_BASKET, u % M,
                    items=rng.choice(FP.n_items, size=3,
                                     replace=False).astype(np.int32))
              for u in range(12)]
    res = eng.submit(events, on_overflow="shed")
    # 2 shards x max_pending=2 admitted, the rest shed, no seqno burned
    assert (res.admitted, res.rejected) == (4, 8)
    assert eng._next_seqno == 4
    eng.run_until_drained()
    with pytest.raises(Backpressure):
        eng.submit(events)       # default on_overflow="raise"
    eng.run_until_drained()
    res = eng.submit(events[-4:], on_overflow="shed")
    assert res.admitted == 4
    assert eng.backpressure_rejections > 0


def test_sharded_router_quarantines_unroutable_users():
    eng = make_sharded(2)
    bad = Event(KIND_ADD_BASKET, M + 7, items=np.array([1], np.int32))
    with pytest.raises(InvalidEventError, match="global range"):
        eng.submit([bad])
    res = eng.submit([bad], on_invalid="quarantine")
    assert res.quarantined == 1
    assert eng.router_dead_letters == 1 and eng.dead_letters == 1
    assert eng.dead_letter[0][0] is bad
    with pytest.raises(ValueError):
        eng.submit([bad], on_invalid="drop")


# ---------------------------------------------------------------------------
# recover_shard: degraded serving through a recovery and a failure
# ---------------------------------------------------------------------------

def test_recover_shard_serves_through_recovery_and_failure(rng, tmp_path):
    """Success thaws onto the recovered state; a FAILED recovery leaves
    the shard frozen, still answering from the pinned snapshot, with the
    error surfaced to the caller."""
    eng = make_sharded(2)
    events = add_events(rng, 16)
    eng.submit(events[:8])
    eng.run_until_drained()
    eng.checkpoint(str(tmp_path), 1)
    eng.submit(events[8:])
    eng.run_until_drained()
    eng.checkpoint(str(tmp_path), 2)
    users = list(range(M))
    healthy = eng.recommend(users, topn=4, k=3)
    healthy_q = eng.recommend(users, topn=4, k=3, quantized=True)
    # newest commit of shard 0 corrupted -> recover from the prev pair
    shard_dir = os.path.join(str(tmp_path), "shard_000")
    faults.bitflip_file(os.path.join(shard_dir, "LATEST"), seed=5)
    info = eng.recover_shard(0, str(tmp_path))
    assert info["source"] == "LATEST.prev" and info["skipped"]
    assert not eng.shards[0].serving_degraded
    assert eng.shards[0].watermark < eng.shards[1].watermark
    eng.submit(events)                     # replay re-applies the delta
    eng.run_until_drained()
    np.testing.assert_array_equal(eng.recommend(users, topn=4, k=3),
                                  healthy)
    # the whole shard directory unrecoverable: the shard stays frozen
    # and cross-shard serving keeps answering, fp32 and int8
    faults.bitflip_file(os.path.join(shard_dir, "LATEST"), seed=6)
    faults.tear_file(os.path.join(shard_dir, "LATEST.prev"), keep_frac=0.2)
    with pytest.raises(CorruptCheckpointError):
        eng.recover_shard(0, str(tmp_path))
    assert eng.shards[0].serving_degraded
    assert not eng.shards[1].serving_degraded
    np.testing.assert_array_equal(eng.recommend(users, topn=4, k=3),
                                  healthy)
    np.testing.assert_array_equal(
        eng.recommend(users, topn=4, k=3, quantized=True), healthy_q)


# ---------------------------------------------------------------------------
# Sharded restore diagnostics
# ---------------------------------------------------------------------------

def sharded_checkpoint(rng, tmp_path, n_shards=2):
    eng = make_sharded(n_shards)
    eng.submit(add_events(rng, 12))
    eng.run_until_drained()
    eng.checkpoint(str(tmp_path), 1)
    return eng


def test_restore_names_the_missing_shard_directory(rng, tmp_path):
    sharded_checkpoint(rng, tmp_path)
    shutil.rmtree(os.path.join(str(tmp_path), "shard_001"))
    eng = make_sharded(2)
    before = vecs(eng.shards[0].store).copy()
    with pytest.raises(FileNotFoundError,
                       match=r"missing commit\(s\) in: .*shard_001"):
        eng.restore(str(tmp_path))
    # no shard was touched before the check
    np.testing.assert_array_equal(vecs(eng.shards[0].store), before)
    assert eng.shards[0].watermark == -1


def test_restore_names_a_partial_shard_directory(rng, tmp_path):
    """A shard directory that lost its commit files is named, with the
    expected layout."""
    sharded_checkpoint(rng, tmp_path)
    os.remove(os.path.join(str(tmp_path), "shard_000", "LATEST"))
    eng = make_sharded(2)
    with pytest.raises(FileNotFoundError, match="shard_000 … shard_001"):
        eng.restore(str(tmp_path))


def test_restore_of_a_directory_without_a_commit(tmp_path):
    with pytest.raises(FileNotFoundError, match="no SHARDS manifest"):
        make_sharded(2).restore(str(tmp_path))


def test_restore_reports_torn_manifest(rng, tmp_path):
    sharded_checkpoint(rng, tmp_path)
    faults.tear_file(os.path.join(str(tmp_path), "SHARDS"), keep_frac=0.5)
    eng = make_sharded(2)
    with pytest.raises(CorruptCheckpointError, match="manifest"):
        eng.restore(str(tmp_path))


def test_checkpoint_refuses_directory_with_corrupt_manifest(rng,
                                                            tmp_path):
    eng = sharded_checkpoint(rng, tmp_path)
    faults.tear_file(os.path.join(str(tmp_path), "SHARDS"), keep_frac=0.6)
    with pytest.raises(CorruptCheckpointError, match="refusing to commit"):
        eng.checkpoint(str(tmp_path), 2)


def test_bitflip_to_invalid_utf8_reads_as_corruption(rng, tmp_path):
    sharded_checkpoint(rng, tmp_path)
    path = os.path.join(str(tmp_path), "SHARDS")
    with open(path, "rb") as f:
        data = bytearray(f.read())
    data[data.index(b'"n_users"') + 2] |= 0x80    # invalid continuation
    with open(path, "wb") as f:
        f.write(bytes(data))
    eng = make_sharded(2)
    with pytest.raises(CorruptCheckpointError, match="not valid json"):
        eng.restore(str(tmp_path))


def test_restore_refuses_another_user_count(rng, tmp_path):
    sharded_checkpoint(rng, tmp_path)
    other = ShardedStreamingEngine.create(
        UserShardSpec(M + 1, 2), tparams(FP), max_baskets=NB,
        max_basket_size=BS, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="n_users"):
        other.restore(str(tmp_path))


# ---------------------------------------------------------------------------
# Legacy ENGINE-file checkpoints through the sharded engine
# ---------------------------------------------------------------------------

def legacy_flat_checkpoint(rng, tmp_path):
    """A flat checkpoint from before the log moved into LATEST: a
    separate ENGINE file and no CRC fields."""
    eng = make_engine()
    events = add_events(rng, 14)
    eng.submit(events)
    eng.run_until_drained()
    eng.checkpoint(str(tmp_path), 1)
    latest = os.path.join(str(tmp_path), "LATEST")
    with open(latest) as f:
        meta = json.load(f)
    legacy_log = meta.pop("engine")
    for k in ("meta_crc32", "npz_crc32", "npz_bytes"):
        meta.pop(k)
    with open(latest, "w") as f:
        json.dump(meta, f)
    with open(os.path.join(str(tmp_path), "ENGINE"), "w") as f:
        json.dump(legacy_log, f)
    prev = os.path.join(str(tmp_path), "LATEST.prev")
    if os.path.exists(prev):
        os.remove(prev)
    return events, eng


def test_legacy_engine_file_restores_through_one_shard_router(rng,
                                                              tmp_path):
    events, eng1 = legacy_flat_checkpoint(rng, tmp_path)
    eng = make_sharded(1)
    eng.restore(str(tmp_path))
    assert eng.shards[0].watermark == len(events) - 1
    res = eng.submit(events)               # full replay: all duplicates
    assert res.deduped == len(events) and res.admitted == 0
    np.testing.assert_array_equal(vecs(eng.shards[0].store),
                                  vecs(eng1.store))


def test_legacy_engine_file_reshards_into_two_shards(rng, tmp_path):
    """The 1→2 reshard takes the legacy ENGINE log as a legacy log: a
    replay is fully deduped, never double-applied."""
    events, eng1 = legacy_flat_checkpoint(rng, tmp_path)
    eng = make_sharded(2)
    eng.restore(str(tmp_path))
    res = eng.submit(events)
    assert res.deduped == len(events) and res.admitted == 0
    np.testing.assert_array_equal(global_vecs(eng, FP.n_items),
                                  vecs(eng1.store))


def test_reshard_refuses_a_commit_without_a_log(rng, tmp_path):
    legacy_flat_checkpoint(rng, tmp_path)
    os.remove(os.path.join(str(tmp_path), "ENGINE"))
    with pytest.raises(ValueError, match="no exactly-once log"):
        make_sharded(2).restore(str(tmp_path))


# ---------------------------------------------------------------------------
# Chaos: the sharded quick schedules of tests/test_chaos_soak.py
# ---------------------------------------------------------------------------

CP = chaos.P


def build(n_shards, checkpointer=None):
    if n_shards == 1:
        return make_engine(CP, n_users=M, max_baskets=chaos.N,
                           max_basket_size=chaos.B,
                           checkpointer=checkpointer)
    return make_sharded(n_shards, CP, max_baskets=chaos.N,
                        max_basket_size=chaos.B, checkpointer=checkpointer)


def state_rows(eng):
    if isinstance(eng, StreamingEngine):
        return vecs(eng.store)
    return global_vecs(eng, CP.n_items)


@pytest.fixture(scope="module")
def baseline():
    """The 520-event stream drained fault-free through the port's single
    engine, and the RefEngine oracle."""
    rng = np.random.default_rng(7)
    ref = RefEngine(CP, dtype=np.float32)
    events = [Event(ev.kind, ev.user, items=ev.items, pos=ev.pos,
                    item=ev.item, seqno=ev.seqno)
              for ev in chaos.random_mixed_events(rng, ref, 520)]
    eng = build(1)
    eng.submit(events)
    assert eng.run_until_drained() == len(events)
    return {"events": events, "state": state_rows(eng),
            "recs": eng.recommend(np.arange(M), topn=chaos.TOPN,
                                  k=chaos.K_NN),
            "ref_vecs": np.stack([ref.state(u).user_vec.astype(np.float32)
                                  for u in range(M)])}


def replay_and_check(eng2, baseline, redeliver_seed, what):
    """At-least-once catch-up: the stream in order, then shuffled seeded
    duplicates before, during and after the drain; then the bitwise
    check against the fault-free run."""
    events = baseline["events"]
    eng2.submit(events)
    dups = faults.redelivered(events, seed=redeliver_seed)
    eng2.submit(dups)
    eng2.step()
    eng2.submit(dups)
    eng2.run_until_drained()
    eng2.submit(dups)
    assert eng2.run_until_drained() == 0
    got = state_rows(eng2)
    np.testing.assert_array_equal(got, baseline["state"],
                                  err_msg=f"state diverged: {what}")
    np.testing.assert_allclose(got, baseline["ref_vecs"], atol=1e-4,
                               err_msg=f"ref oracle diverged: {what}")
    recs = eng2.recommend(np.arange(M), topn=chaos.TOPN, k=chaos.K_NN)
    np.testing.assert_array_equal(recs, baseline["recs"],
                                  err_msg=f"recs diverged: {what}")
    assert eng2.dead_letters == 0
    assert eng2.backpressure_rejections == 0


def run_schedule(n_shards, sched, baseline, tmp_path):
    kind, a, b, redeliver_seed = sched
    events = baseline["events"]
    ck = str(tmp_path / "ck")
    eng = build(n_shards)
    eng.submit(events[:chaos.SEG1])
    eng.run_until_drained()
    eng.checkpoint(ck, 1)
    eng.submit(events[chaos.SEG1:chaos.SEG2])
    eng.run_until_drained()
    if kind == "crash":
        plan = faults.FaultPlan(crash_site=a, crash_on_hit=b)
        with faults.inject(plan):
            with pytest.raises(faults.InjectedCrash):
                eng.checkpoint(ck, 2)
        assert plan.fired[-1] == a
    else:
        eng.checkpoint(ck, 2)
    if kind == "corrupt":
        assert a == "npz_tear"
        faults.tear_file(os.path.join(ck, f"shard_{b:03d}",
                                      "state_0000000002.npz"),
                         keep_frac=0.5)
    eng2 = build(n_shards)               # "process restart"
    eng2.restore(ck)
    replay_and_check(eng2, baseline, redeliver_seed, sched)
    return eng2


SHARDED_QUICK = [(n, s) for n, s in chaos.QUICK if n > 1]


@pytest.mark.parametrize("n_shards,sched", SHARDED_QUICK,
                         ids=[f"S{n}-{chaos._sched_id(s)}"
                              for n, s in SHARDED_QUICK])
def test_chaos_quick(n_shards, sched, baseline, tmp_path):
    run_schedule(n_shards, sched, baseline, tmp_path)


@pytest.mark.parametrize("site", ["SHARDS.pre_replace",
                                  "SHARDS.post_replace"])
def test_crash_at_a_manifest_site(site, baseline, tmp_path):
    """A crash while the manifest commits: every shard already holds
    step 2, and restore + replay converge whichever manifest survived."""
    assert site in faults.SHARD_CRASH_SITES
    eng2 = run_schedule(2, ("crash", site, 1, 0), baseline, tmp_path)
    with open(tmp_path / "ck" / "SHARDS") as f:
        assert json.load(f)["step"] == (2 if site.endswith("post_replace")
                                        else 1)
    # the shards committed step 2 before the manifest: nothing re-applied
    assert eng2.events_processed == len(baseline["events"]) - chaos.SEG2


SHARDED_ASYNC_QUICK = [(n, s) for n, s in chaos.ASYNC_QUICK if n > 1]


@pytest.mark.parametrize("n_shards,sched", SHARDED_ASYNC_QUICK,
                         ids=[f"S{n}-async-{chaos._sched_id(s)}"
                              for n, s in SHARDED_ASYNC_QUICK])
def test_async_crash_quick(n_shards, sched, baseline, tmp_path):
    """The background writer dies mid-commit while the engine streams
    on; the crash surfaces at the flush, and restore lands on the last
    commit that fully landed, never a torn one."""
    site, hit, redeliver_seed = sched
    events = baseline["events"]
    ck = str(tmp_path / "ck")
    eng = build(n_shards, checkpointer=AsyncCheckpointer())
    eng.submit(events[:chaos.SEG1])
    eng.run_until_drained()
    eng.checkpoint(ck, 1)
    eng.flush_checkpoints()              # commit 1 fully durable
    eng.submit(events[chaos.SEG1:chaos.SEG2])
    eng.run_until_drained()
    plan = faults.FaultPlan(crash_site=site, crash_on_hit=hit)
    with faults.inject(plan):
        eng.checkpoint(ck, 2)            # snapshot + enqueue, returns
        eng.submit(events[chaos.SEG2:])  # the hot path streams past the
        eng.run_until_drained()          # in-flight commit
        with pytest.raises(faults.InjectedCrash):
            eng.flush_checkpoints()      # the writer's crash surfaces here
    assert site in plan.fired
    eng2 = build(n_shards, checkpointer=AsyncCheckpointer())
    eng2.restore(ck)
    with open(os.path.join(ck, "SHARDS")) as f:
        assert json.load(f)["step"] == 1    # the manifest never moved
    replay_and_check(eng2, baseline, redeliver_seed, sched)
