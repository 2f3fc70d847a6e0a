"""The port's durability layer against the JAX package, on the CPU.

Checkpoint, restore, fault injection and degraded serving of the port's
single-shard engine (``repro_torch.streaming``), held against
``repro.streaming`` (JAX on the CPU) and ``repro.core.RefEngine``:

  * the single-engine cases of the JAX package's ``tests/test_faults.py``
    (corrupt newest commit falls back to ``LATEST.prev``, two corrupt
    commits raise naming both, legacy commits without CRCs, transient
    I/O errors absorbed or surfaced, invalid UTF-8 read as corruption,
    frozen serving, the ``FaultPlan`` mechanics), ported;
  * interop: a commit written by either package restores into the other
    with all nine leaves equal bit for bit (and equal dtypes) and the
    same exactly-once log, and identical leaves serialize to identical
    npz bytes; both then resume one redelivered stream;
  * a crash at every commit site a single engine reaches, mid-way
    through the 520-event mixed stream of
    ``tests/test_update_partition.py``, then restore and at-least-once
    redelivery.

Tolerances: integer leaves exact; materialized vectors ``rtol=1e-4,
atol=1e-5`` against the JAX engine, ``RefEngine`` and the port's own
fault-free run (the bar the JAX package holds its engine to); a restore
of a commit is bitwise.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro.core import RefEngine
from repro.core import TifuParams as JParams
from repro.streaming import StateStore as JStore
from repro.streaming import StoreConfig as JConfig
from repro.streaming import StreamingEngine as JEngine
from repro_torch import convert
from repro_torch.core.types import KIND_ADD_BASKET, TifuParams
from repro_torch.streaming import (CorruptCheckpointError, Event, StateStore,
                                   StoreConfig, StreamingEngine, faults,
                                   with_io_retries)
from tests.test_update_partition import B as MB
from tests.test_update_partition import K as MK
from tests.test_update_partition import M as MM
from tests.test_update_partition import N as MN
from tests.test_update_partition import P as MP
from tests.test_update_partition import (assert_matches_ref,
                                         random_mixed_events)

JP = JParams(n_items=29, group_size=3)
M = 8           # users
NB, BS = 24, 6  # max_baskets, max_basket_size
INT_LEAVES = ("history", "group_sizes", "n_baskets", "n_groups")


def tparams(p):
    """The port's TifuParams with the JAX package's values."""
    return TifuParams(**{f.name: getattr(p, f.name)
                         for f in dataclasses.fields(TifuParams)})


def make_engine(n_users=M, batch_size=16, **kw):
    store = StateStore(StoreConfig(n_users=n_users, n_items=JP.n_items,
                                   max_baskets=NB, max_basket_size=BS),
                       device="cpu")
    return StreamingEngine(store, tparams(JP), batch_size=batch_size,
                           **kw), store


def add_events(rng, n, n_users=M, start_seqno=0):
    """n valid add-basket events with explicit consecutive seqnos."""
    return [Event(KIND_ADD_BASKET, int(rng.integers(0, n_users)),
                  items=rng.choice(JP.n_items, size=3,
                                   replace=False).astype(np.int32),
                  seqno=start_seqno + i)
            for i in range(n)]


def vecs(store):
    return store.state.materialized_user_vecs().numpy()


def ref_vecs(events, p=JP, n_users=M):
    """RefEngine's float32 user vectors after the given add events."""
    ref = RefEngine(p, dtype=np.float32)
    for ev in events:
        ref.add_basket(ev.user, ev.items)
    return np.stack([ref.state(u).user_vec.astype(np.float32)
                     for u in range(n_users)])


def assert_same_leaves(got, want):
    """Nine leaves of two states (either package) equal, dtypes too."""
    a, b = convert.state_to_numpy(got), convert.state_to_numpy(want)
    assert set(a) == set(b) == set(convert.LEAVES)
    for name in convert.LEAVES:
        assert a[name].dtype == b[name].dtype, name
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def assert_parity(got, want):
    """Integer leaves exact, materialized vectors rtol=1e-4, atol=1e-5."""
    a, b = convert.state_to_numpy(got), convert.state_to_numpy(want)
    for name in INT_LEAVES:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    for fn in ("materialized_user_vecs", "materialized_last_group_vecs"):
        np.testing.assert_allclose(np.asarray(getattr(got, fn)()),
                                   np.asarray(getattr(want, fn)()),
                                   rtol=1e-4, atol=1e-5, err_msg=fn)


def log_of(eng):
    return (eng.watermark, sorted(eng._processed_above), eng._max_delivered,
            eng._next_seqno)


# ---------------------------------------------------------------------------
# Corruption detection + fallback to the last good commit pair
# ---------------------------------------------------------------------------

def two_commit_dir(rng, tmp_path, n_events=16):
    """Engine with two checkpoints in one dir; returns (events, engine)."""
    eng, _ = make_engine()
    events = add_events(rng, n_events)
    eng.submit(events[:n_events // 2])
    eng.run_until_drained()
    eng.checkpoint(str(tmp_path), 1)
    eng.submit(events[n_events // 2:])
    eng.run_until_drained()
    eng.checkpoint(str(tmp_path), 2)
    return events, eng


@pytest.mark.parametrize("corrupt", ["bitflip_latest", "tear_latest",
                                     "bitflip_npz", "tear_npz"])
def test_corrupt_newest_commit_falls_back_to_prev_pair(rng, tmp_path,
                                                       corrupt):
    """Any corruption of the newest commit (metadata or state payload)
    is caught by its recorded CRC and restore falls back to the previous
    commit PAIR -- state and exactly-once log together -- after which a
    full replay converges to the no-fault state."""
    events, eng1 = two_commit_dir(rng, tmp_path)
    d = str(tmp_path)
    if corrupt == "bitflip_latest":
        faults.bitflip_file(os.path.join(d, "LATEST"), seed=3)
    elif corrupt == "tear_latest":
        faults.tear_file(os.path.join(d, "LATEST"), keep_frac=0.4)
    elif corrupt == "bitflip_npz":
        faults.bitflip_file(os.path.join(d, "state_0000000002.npz"),
                            seed=3, n_bits=4)
    else:
        faults.tear_file(os.path.join(d, "state_0000000002.npz"),
                         keep_frac=0.5)
    eng2, store2 = make_engine()
    eng2.restore(d)
    assert store2.restore_fallbacks == 1
    assert store2.corruption_detected >= 1
    assert store2.last_restored_meta["_recovery"]["source"] == "LATEST.prev"
    assert store2.last_restored_meta["step"] == 1
    assert eng2.watermark == len(events) // 2 - 1     # commit 1's log
    eng2.submit(events)                               # full replay
    eng2.run_until_drained()
    np.testing.assert_array_equal(vecs(store2), vecs(eng1.store))
    np.testing.assert_allclose(vecs(store2), ref_vecs(events), rtol=1e-4,
                               atol=1e-5)


def test_both_commits_corrupt_raises_with_all_errors(rng, tmp_path):
    two_commit_dir(rng, tmp_path)
    faults.bitflip_file(os.path.join(str(tmp_path), "LATEST"), seed=1)
    faults.tear_file(os.path.join(str(tmp_path), "LATEST.prev"),
                     keep_frac=0.3)
    eng, _ = make_engine()
    with pytest.raises(CorruptCheckpointError, match="LATEST.prev") as ei:
        eng.restore(str(tmp_path))
    assert "LATEST: " in str(ei.value)                # both are named


def test_restore_of_an_empty_directory_names_the_missing_commit(tmp_path):
    eng, _ = make_engine()
    with pytest.raises(FileNotFoundError, match="no LATEST"):
        eng.restore(str(tmp_path))


def test_legacy_checkpoint_without_crc_fields_still_restores(rng,
                                                             tmp_path):
    """Checkpoints written before the integrity fields existed carry no
    CRCs: they restore unverified rather than being rejected."""
    events, eng1 = two_commit_dir(rng, tmp_path)
    latest = os.path.join(str(tmp_path), "LATEST")
    with open(latest) as f:
        meta = json.load(f)
    for k in ("meta_crc32", "npz_crc32", "npz_bytes"):
        meta.pop(k)
    with open(latest, "w") as f:
        json.dump(meta, f)
    eng2, store2 = make_engine()
    eng2.restore(str(tmp_path))
    assert store2.restore_fallbacks == 0
    np.testing.assert_array_equal(vecs(store2), vecs(eng1.store))


def test_legacy_engine_file_and_unscaled_npz_restore(rng, tmp_path):
    """The two migrations: a commit whose exactly-once log sits in a
    separate ``ENGINE`` file, and a state npz without ``uv_scale`` /
    ``lgv_scale`` (raw rows were true values then: scales of 1)."""
    eng1, store1 = make_engine()
    events = add_events(rng, 14)
    eng1.submit(events)
    eng1.run_until_drained()
    legacy = convert.state_to_numpy(store1.state)
    # fold the scales into the rows, as a pre-scaling writer stored them
    for vec, scale in (("user_vecs", "uv_scale"),
                       ("last_group_vecs", "lgv_scale")):
        legacy[vec] = (legacy[vec] * legacy[scale][:, None]).astype(
            np.float32)
    del legacy["uv_scale"], legacy["lgv_scale"]
    d = str(tmp_path)
    np.savez_compressed(os.path.join(d, "state_0000000001.npz"), **legacy)
    cfg = dataclasses.asdict(store1.cfg)
    with open(os.path.join(d, "LATEST"), "w") as f:
        json.dump(dict(step=1, **cfg), f)
    with open(os.path.join(d, "ENGINE"), "w") as f:
        json.dump({"watermark": eng1.watermark, "next_seqno": 14}, f)
    eng2, store2 = make_engine()
    eng2.restore(d)
    assert store2.state.uv_scale.dtype == torch.float32
    np.testing.assert_array_equal(store2.state.uv_scale.numpy(),
                                  np.ones(M, np.float32))
    np.testing.assert_allclose(vecs(store2), vecs(store1), rtol=1e-6)
    assert eng2.watermark == 13 and eng2._max_delivered == 13
    assert eng2.submit(events).deduped == len(events)


def test_restore_refuses_another_shape(rng, tmp_path):
    eng, _ = make_engine()
    eng.submit(add_events(rng, 4))
    eng.run_until_drained()
    eng.checkpoint(str(tmp_path), 1)
    other = StateStore(StoreConfig(n_users=M, n_items=JP.n_items + 1,
                                   max_baskets=NB, max_basket_size=BS),
                       device="cpu")
    with pytest.raises(ValueError, match="n_items: checkpoint=29"):
        other.restore(str(tmp_path))


def test_bitflip_to_invalid_utf8_reads_as_corruption(rng, tmp_path):
    """A bit flip that breaks the file's UTF-8 encoding must surface as
    CorruptCheckpointError, not a raw UnicodeDecodeError."""
    eng, _ = make_engine()
    eng.submit(add_events(rng, 6))
    eng.run_until_drained()
    eng.checkpoint(str(tmp_path), 1)       # one commit: no LATEST.prev
    path = os.path.join(str(tmp_path), "LATEST")
    with open(path, "rb") as f:
        data = bytearray(f.read())
    data[data.index(b'"n_users"') + 2] |= 0x80    # invalid continuation
    with open(path, "wb") as f:
        f.write(bytes(data))
    eng2, _ = make_engine()
    with pytest.raises(CorruptCheckpointError, match="not valid json"):
        eng2.restore(str(tmp_path))


# ---------------------------------------------------------------------------
# Transient I/O errors: bounded retry-with-backoff
# ---------------------------------------------------------------------------

def test_transient_write_errors_absorbed_by_retry_budget(rng, tmp_path):
    eng, store = make_engine()
    eng.submit(add_events(rng, 6))
    eng.run_until_drained()
    plan = faults.FaultPlan(io_errors={"npz.pre_write": 2,
                                       "LATEST.pre_replace": 1})
    with faults.inject(plan):
        eng.checkpoint(str(tmp_path), 1)
    assert store.io_retries == 3
    assert plan.io_errors == {"npz.pre_write": 0, "LATEST.pre_replace": 0}
    eng2, store2 = make_engine()
    eng2.restore(str(tmp_path))                 # commit is fully intact
    np.testing.assert_array_equal(vecs(store2), vecs(store))


def test_retry_budget_exhaustion_surfaces_an_oserror(rng, tmp_path):
    eng, store = make_engine()
    eng.submit(add_events(rng, 4))
    eng.run_until_drained()
    plan = faults.FaultPlan(io_errors={"npz.pre_write": 99})
    with faults.inject(plan):
        with pytest.raises(OSError, match="retry budget exhausted"):
            eng.checkpoint(str(tmp_path), 1)
    assert store.io_retries == store.cfg.io_retries


def test_transient_read_errors_absorbed_on_restore(rng, tmp_path):
    eng, store = make_engine()
    eng.submit(add_events(rng, 6))
    eng.run_until_drained()
    eng.checkpoint(str(tmp_path), 1)
    eng2, store2 = make_engine()
    plan = faults.FaultPlan(io_errors={"LATEST.read": 2, "npz.read": 1})
    with faults.inject(plan):
        eng2.restore(str(tmp_path))
    assert plan.io_errors == {"LATEST.read": 0, "npz.read": 0}
    np.testing.assert_array_equal(vecs(store2), vecs(store))


def test_with_io_retries_never_retries_file_not_found(tmp_path):
    calls = []

    def missing():
        calls.append(1)
        raise FileNotFoundError("nope")

    with pytest.raises(FileNotFoundError):
        with_io_retries(missing, "probe")
    assert len(calls) == 1      # deterministic miss, not transient


def test_commit_sites_trip_in_order(rng, tmp_path):
    """The sites of one commit and one restore, in the JAX package's
    order (a second commit also keeps ``LATEST.prev``)."""
    eng, _ = make_engine()
    eng.submit(add_events(rng, 6))
    eng.run_until_drained()
    plan = faults.FaultPlan()
    with faults.inject(plan):
        eng.checkpoint(str(tmp_path), 1)
        eng.checkpoint(str(tmp_path), 2)
        make_engine()[0].restore(str(tmp_path))
    assert plan.fired == list(faults.CRASH_SITES) * 2 + \
        list(faults.READ_SITES)
    assert os.path.exists(os.path.join(str(tmp_path), "LATEST.prev"))


# ---------------------------------------------------------------------------
# Degraded serving: recommend keeps answering during recovery
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quantized", [False, True])
def test_frozen_corpus_serves_stale_answers_until_thaw(rng, quantized):
    eng, store = make_engine()
    eng.submit(add_events(rng, 12))
    eng.run_until_drained()
    users = list(range(M))
    before = eng.recommend(users, topn=4, k=3, quantized=quantized)
    eng.freeze_serving()
    assert eng.serving_degraded
    eng.submit(add_events(rng, 12, start_seqno=12))
    eng.run_until_drained()
    np.testing.assert_array_equal(
        eng.recommend(users, topn=4, k=3, quantized=quantized),
        before)       # stale but well-formed
    eng.thaw_serving()
    assert not eng.serving_degraded
    # after thaw the refreshed caches equal a fresh materialization
    fresh = store.state.materialized_user_vecs()
    assert torch.equal(store.corpus(), fresh)
    q, s = store.quantized_corpus()
    from repro_torch.optim.compression import quantize_int8_rows
    wq, ws = quantize_int8_rows(fresh)
    assert torch.equal(q, wq) and torch.equal(s, ws)
    # and the answer equals an engine that saw everything live
    ctl, _ = make_engine()
    rng2 = np.random.default_rng(0)
    ctl.submit(add_events(rng2, 12))
    ctl.submit(add_events(rng2, 12, start_seqno=12))
    ctl.run_until_drained()
    np.testing.assert_array_equal(
        eng.recommend(users, topn=4, k=3, quantized=quantized),
        ctl.recommend(users, topn=4, k=3, quantized=quantized))


def test_frozen_serving_survives_a_restore(rng, tmp_path):
    """A restore under a freeze keeps serving the pinned snapshot; the
    thaw then serves the restored state."""
    events, eng1 = two_commit_dir(rng, tmp_path)
    eng, store = make_engine()
    eng.submit(add_events(np.random.default_rng(5), 10))
    eng.run_until_drained()
    users = list(range(M))
    before = eng.recommend(users, topn=4, k=3)
    eng.freeze_serving()
    eng.restore(str(tmp_path))
    np.testing.assert_array_equal(eng.recommend(users, topn=4, k=3), before)
    eng.thaw_serving()
    np.testing.assert_array_equal(eng.recommend(users, topn=4, k=3),
                                  eng1.recommend(users, topn=4, k=3))


# ---------------------------------------------------------------------------
# FaultPlan mechanics
# ---------------------------------------------------------------------------

def test_fault_plans_do_not_nest():
    with faults.inject(faults.FaultPlan()):
        with pytest.raises(RuntimeError, match="do not nest"):
            with faults.inject(faults.FaultPlan()):
                pass
    assert faults.active_plan() is None


def test_injected_crash_escapes_except_exception():
    plan = faults.FaultPlan(crash_site="LATEST.pre_replace")
    with faults.inject(plan):
        with pytest.raises(faults.InjectedCrash):
            try:
                faults.trip("LATEST.pre_replace")
            except Exception:      # a retry loop must NOT swallow this
                pytest.fail("InjectedCrash was caught by except Exception")
    assert plan.fired == ["LATEST.pre_replace"]


def test_crash_on_nth_hit_selects_the_shard():
    plan = faults.FaultPlan(crash_site="npz.post_replace", crash_on_hit=2)
    with faults.inject(plan):
        faults.trip("npz.post_replace")        # shard 0: survives
        with pytest.raises(faults.InjectedCrash):
            faults.trip("npz.post_replace")    # shard 1: dies
    assert plan.fired == ["npz.post_replace"] * 2


def test_redelivered_keeps_original_seqnos(rng):
    events = add_events(rng, 20)
    dups = faults.redelivered(events, seed=4, dup_frac=0.5)
    assert 0 < len(dups) < len(events)
    orig = {ev.seqno: ev for ev in events}
    for ev in dups:
        assert dataclasses.asdict(orig[ev.seqno]).keys() == \
            dataclasses.asdict(ev).keys()
        assert orig[ev.seqno].user == ev.user


def test_fault_sites_match_the_jax_package():
    from repro.streaming import faults as jfaults
    for name in ("CRASH_SITES", "SHARD_CRASH_SITES", "READ_SITES",
                 "ASYNC_CRASH_SITES"):
        assert getattr(faults, name) == getattr(jfaults, name), name
    events = add_events(np.random.default_rng(2), 30)
    assert [ev.seqno for ev in faults.redelivered(events, seed=9)] == \
        [ev.seqno for ev in jfaults.redelivered(events, seed=9)]


# ---------------------------------------------------------------------------
# Interop: a commit of either package restores into the other
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mixed():
    """The 520-event mixed stream with explicit seqnos, as port and JAX
    events, and the port's fault-free drain of it."""
    rng = np.random.default_rng(0)
    ref = RefEngine(MP, dtype=np.float32)
    jevents = [dataclasses.replace(ev, seqno=i) for i, ev in
               enumerate(random_mixed_events(rng, ref, 520, MM))]
    tevents = [Event(ev.kind, ev.user, items=ev.items, pos=ev.pos,
                     item=ev.item, seqno=ev.seqno) for ev in jevents]
    clean = make_mixed_port()
    clean.submit(tevents)
    assert clean.run_until_drained() == 520
    assert_matches_ref(clean.store.state, ref, MM)
    return dict(jevents=jevents, tevents=tevents, ref=ref, clean=clean)


SHAPE = dict(n_users=MM, n_items=MP.n_items, max_baskets=MN,
             max_basket_size=MB, max_groups=MK)


def make_mixed_port(**kw):
    return StreamingEngine(StateStore(StoreConfig(**SHAPE), device="cpu"),
                           tparams(MP), batch_size=16, **kw)


def make_mixed_jax():
    return JEngine(JStore(JConfig(**SHAPE)), MP, batch_size=16)


def half_drained(eng, events):
    """Submit the first 260 events and apply only 6 micro-batches: the
    log then has processed seqnos above its watermark."""
    eng.submit(events[:260])
    for _ in range(6):
        eng.step()
    assert eng._processed_above and eng.n_pending > 0


def resume(eng, events, seed=1):
    """At-least-once redelivery: the whole stream, then seeded shuffled
    duplicates before, during and after the drain."""
    eng.submit(events)
    dups = faults.redelivered(events, seed=seed)
    eng.submit(dups)
    eng.step()
    eng.submit(dups)
    eng.run_until_drained()
    eng.submit(dups)
    assert eng.run_until_drained() == 0


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_commit_restores_across_packages(mixed, tmp_path, writer):
    d = str(tmp_path / "ck")
    jeng, teng = make_mixed_jax(), make_mixed_port()
    if writer == "jax":
        src, dst, src_events = jeng, teng, mixed["jevents"]
    else:
        src, dst, src_events = teng, jeng, mixed["tevents"]
    half_drained(src, src_events)
    src.checkpoint(d, 7)
    dst.restore(d)
    assert dst.store.last_restored_meta["step"] == 7
    assert_same_leaves(dst.store.state, src.store.state)
    assert log_of(dst) == log_of(src)
    # both resume from the commit: a fresh engine of the writer's package
    # restored from the same directory, and the reader
    again = make_mixed_jax() if writer == "jax" else make_mixed_port()
    again.restore(d)
    resume(again, src_events)
    resume(dst, mixed["jevents"] if writer == "port" else mixed["tevents"])
    assert_parity(dst.store.state, again.store.state)   # port vs JAX
    assert_parity(dst.store.state, mixed["clean"].store.state)
    assert_matches_ref(dst.store.state, mixed["ref"], MM)
    assert dst.watermark == again.watermark == 519


def test_identical_leaves_write_identical_npz_bytes(mixed, tmp_path):
    """The same state serializes to the same committed bytes in both
    packages (same leaf names, order, dtypes and ``savez_compressed``)."""
    jeng = make_mixed_jax()
    jeng.submit(mixed["jevents"][:300])
    jeng.run_until_drained()
    jeng.checkpoint(str(tmp_path / "jax"), 3)
    teng = make_mixed_port()
    teng.restore(str(tmp_path / "jax"))
    teng.checkpoint(str(tmp_path / "port"), 3)
    metas = []
    for name in ("jax", "port"):
        with open(tmp_path / name / "LATEST") as f:
            metas.append(json.load(f))
    for key in ("step", "npz_crc32", "npz_bytes", "n_users", "n_items",
                "max_baskets", "max_basket_size", "max_groups", "engine"):
        assert metas[0][key] == metas[1][key], key
    assert (tmp_path / "jax" / "state_0000000003.npz").read_bytes() == \
        (tmp_path / "port" / "state_0000000003.npz").read_bytes()


# ---------------------------------------------------------------------------
# Mid-stream crash at every single-engine commit site
# ---------------------------------------------------------------------------

SEG1, SEG2 = 200, 380          # checkpoint boundaries in the 520 stream


@pytest.mark.parametrize("site", faults.CRASH_SITES)
@pytest.mark.parametrize("seed", [0, 1])
def test_crash_restore_redeliver_converges(mixed, tmp_path, site, seed):
    events = mixed["tevents"]
    ck = str(tmp_path / "ck")
    eng = make_mixed_port()
    eng.submit(events[:SEG1])
    eng.run_until_drained()
    eng.checkpoint(ck, 1)
    eng.submit(events[SEG1:SEG2])
    eng.run_until_drained()
    plan = faults.FaultPlan(crash_site=site)
    with faults.inject(plan):
        with pytest.raises(faults.InjectedCrash):
            eng.checkpoint(ck, 2)
    assert plan.fired[-1] == site

    eng2 = make_mixed_port()          # "process restart"
    eng2.restore(ck)
    committed = 2 if site == "LATEST.post_replace" else 1
    assert eng2.store.last_restored_meta["step"] == committed
    assert eng2.watermark == (SEG2 if committed == 2 else SEG1) - 1
    resume(eng2, events, seed)
    assert eng2.metrics.events_processed == 520 - eng2.store \
        .last_restored_meta["engine"]["watermark"] - 1
    assert eng2.metrics.dead_letters == 0
    assert_parity(eng2.store.state, mixed["clean"].store.state)
    assert_matches_ref(eng2.store.state, mixed["ref"], MM)
