"""Deletion-burst (forget) schedules through the port, on the CPU.

The forget rows of ``tests/test_chaos_soak.py``, ported: the first 200
events of the 520-event mixed stream are committed, an explicit-seqno
burst erasing users 2 and 5 is half applied, and the next commit dies at
a crash site; a fresh engine restores, takes the stream, the burst and
seeded duplicates of the burst again, ``forget_user`` is called on the
erased users (idempotent: zero deletions, clean receipts), and the
recovered engine must certify against the whole log, checkpoint round
trip included.  Each schedule also runs through the JAX package, and the
two are held to each other: receipts field for field but ``latency_s``,
reports (check names and ``ok``, counts, user lists, ``envelope_slack``
within 1e-6, ``overlap_mean``), the state after (integer leaves exact,
materialized vectors ``rtol=1e-4, atol=1e-5``, erased rows exactly
0.0).

Tier-1 runs the reference's quick schedule (2 shards, a crash at
``npz.pre_replace``) and one 1-shard schedule; the full sweep at 1, 2
and 4 shards is ``chaos``-marked, deselected by default as in the
reference.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

from repro import compliance as jc
from repro.compliance.certify import _global_leaves as j_leaves
from repro.core import RefEngine
from repro.streaming import faults as jfaults
from repro_torch import compliance as tc
from repro_torch.compliance.certify import _global_leaves as t_leaves
from repro_torch.core.types import TifuParams
from repro_torch.launch import make_user_shard_devices
from repro_torch.parallel.sharding import UserShardSpec
from repro_torch.streaming import (Event, ShardedStreamingEngine, StateStore,
                                   StoreConfig, StreamingEngine, faults)
from tests import test_chaos_soak as chaos

P, M = chaos.P, chaos.M
TP = TifuParams(**{f.name: getattr(P, f.name)
                   for f in dataclasses.fields(TifuParams)})


def build(n_shards):
    """The port's engine at the chaos soak's geometry, on the CPU."""
    if n_shards == 1:
        store = StateStore(StoreConfig(n_users=M, n_items=P.n_items,
                                       max_baskets=chaos.N,
                                       max_basket_size=chaos.B),
                           device="cpu")
        return StreamingEngine(store, TP, batch_size=16)
    return ShardedStreamingEngine.create(
        UserShardSpec(M, n_shards), TP, max_baskets=chaos.N,
        max_basket_size=chaos.B,
        devices=make_user_shard_devices(n_shards, ["cpu"]), batch_size=16)


def to_port(events):
    return [Event(ev.kind, ev.user, items=ev.items, pos=ev.pos,
                  item=ev.item, seqno=ev.seqno) for ev in events]


PORT = SimpleNamespace(build=build, faults=faults, certify=tc.certify,
                       events=to_port, leaves=t_leaves)
JAX = SimpleNamespace(build=chaos.build, faults=jfaults,
                      certify=jc.certify, events=list, leaves=j_leaves)


@pytest.fixture(scope="module")
def stream():
    """The first 200 events of the chaos soak's seeded stream (JAX
    events with seqnos) and the burst erasing FORGET_USERS after them."""
    rng = np.random.default_rng(7)
    events = chaos.random_mixed_events(
        rng, RefEngine(P, dtype=np.float32), 520)[:chaos.SEG1]
    return events, chaos.forget_burst(events)


def run_forget_schedule(pkg, n_shards, sched, stream, tmp_path):
    """One schedule through one package; returns (engine, receipts,
    report)."""
    kind, site, hit, redeliver_seed = sched
    events, burst = (pkg.events(evs) for evs in stream)
    ck = str(tmp_path / "ck")
    eng = pkg.build(n_shards)
    eng.submit(events)
    eng.run_until_drained()
    eng.checkpoint(ck, 1)
    eng.submit(burst)
    eng.step()
    eng.step()                           # burst partially applied
    if kind == "crash":
        plan = pkg.faults.FaultPlan(crash_site=site, crash_on_hit=hit)
        with pkg.faults.inject(plan):
            with pytest.raises(pkg.faults.InjectedCrash):
                eng.checkpoint(ck, 2)
        assert plan.fired[-1] == site
    eng2 = pkg.build(n_shards)           # "process restart"
    eng2.restore(ck)
    eng2.submit(events)
    eng2.submit(burst)
    eng2.submit(pkg.faults.redelivered(burst, seed=redeliver_seed))
    eng2.run_until_drained()
    receipts = []
    for u in chaos.FORGET_USERS:
        receipt = eng2.forget_user(u)
        assert receipt.n_baskets_deleted == 0
        assert receipt.clean, f"user {u} residue: {receipt.residue}"
        receipts.append(receipt)
    report = pkg.certify(eng2, events + burst,
                         forgotten_users=chaos.FORGET_USERS,
                         checkpoint_dir=str(tmp_path / "cert_ck"))
    assert report.compliant, report.summary()
    return eng2, receipts, report


def run_both(n_shards, sched, stream, tmp_path):
    t, rt, pt = run_forget_schedule(PORT, n_shards, sched, stream,
                                    tmp_path / "port")
    j, rj, pj = run_forget_schedule(JAX, n_shards, sched, stream,
                                    tmp_path / "jax")
    for a, b in zip(rt, rj):
        assert (a.user, a.n_baskets_deleted, tuple(a.seqnos),
                a.purged_dead_letters, a.residue) == \
            (b.user, b.n_baskets_deleted, tuple(b.seqnos),
             b.purged_dead_letters, b.residue)
    assert [(c.name, c.ok) for c in pt.checks] == \
        [(c.name, c.ok) for c in pj.checks]
    assert (pt.n_users, pt.n_events, pt.n_deletion_events,
            pt.pure_add_users, pt.deletion_users, pt.forgotten_users) == \
        (pj.n_users, pj.n_events, pj.n_deletion_events,
         list(pj.pure_add_users), list(pj.deletion_users),
         list(pj.forgotten_users))
    assert abs(pt.envelope_slack - pj.envelope_slack) <= 1e-6
    assert pt.overlap_mean == pj.overlap_mean
    lt, lj = t_leaves(t), j_leaves(j)
    for name in ("history", "group_sizes", "n_baskets", "n_groups"):
        np.testing.assert_array_equal(lt[name], lj[name], err_msg=name)
    np.testing.assert_allclose(lt["corpus"], lj["corpus"], rtol=1e-4,
                               atol=1e-5)
    for u in chaos.FORGET_USERS:
        for name in ("user_vecs", "last_group_vecs", "corpus"):
            assert np.all(lt[name][u] == 0.0), (u, name)


FORGET_QUICK = chaos.FORGET_QUICK + [(1, ("crash", "LATEST.pre_replace",
                                          1, 1))]


@pytest.mark.parametrize("n_shards,sched", FORGET_QUICK,
                         ids=[f"S{n}-forget-{chaos._sched_id(s)}"
                              for n, s in FORGET_QUICK])
def test_forget_burst_quick(n_shards, sched, stream, tmp_path):
    run_both(n_shards, sched, stream, tmp_path)


@pytest.mark.chaos
@pytest.mark.parametrize("n_shards,sched",
                         [(n, s) for n in (1, 2, 4)
                          for s in chaos.forget_schedules(n)],
                         ids=[f"S{n}-forget-{chaos._sched_id(s)}"
                              for n in (1, 2, 4)
                              for s in chaos.forget_schedules(n)])
def test_forget_burst_soak(n_shards, sched, stream, tmp_path):
    run_both(n_shards, sched, stream, tmp_path)
