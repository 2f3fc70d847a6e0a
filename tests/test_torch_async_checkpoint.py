"""The port's background commit writer against the JAX package's contract.

Ports of the JAX package's ``tests/test_async_checkpoint.py`` (FIFO
commit order, the first error fencing the queue, sync and async commits
bitwise equal, snapshot isolation, the engine's async round trip), its
single-engine async crash schedules (``tests/test_chaos_soak.py::
ASYNC_QUICK``: the writer killed at ``async.dequeue`` and at
``LATEST.post_replace`` while the engine streams past the in-flight
commit), and the drain-boundary fetch budget of
``tests/test_transfer_budget.py::test_empty_flush_costs_one_then_free``,
counted on the port's ``StreamingEngine._fetch``.

Snapshot isolation matters more here than in the JAX package: the
port's appliers write the state tensors in place, and on a CPU store a
tensor's ``.numpy()`` is a view of them, so a snapshot that did not copy
would show every later micro-batch.

Tolerances: commits and restores bitwise; a recovered engine against
the fault-free one at the parity bar (integer leaves exact, materialized
vectors ``rtol=1e-4, atol=1e-5``) and against ``RefEngine``.
"""
import threading

import numpy as np
import pytest

from repro.core import TifuParams as JParams
from repro.streaming import StateStore as JStore
from repro.streaming import StoreConfig as JConfig
from repro.streaming import StreamingEngine as JEngine
from repro_torch import convert
from repro_torch.core.types import KIND_ADD_BASKET
from repro_torch.streaming import (AsyncCheckpointer, Event, StateStore,
                                   StoreConfig, StreamingEngine, faults,
                                   load_checkpoint_arrays)
from tests.test_torch_durability import mixed  # noqa: F401 (fixture)
from tests.test_torch_durability import (MM, assert_matches_ref,
                                         assert_parity, make_mixed_port,
                                         resume, tparams)

P = JParams(n_items=23, group_size=3, r_b=0.9, r_g=0.7)
SHAPE = dict(n_users=4, n_items=P.n_items, max_baskets=12, max_basket_size=4)
SEG1, SEG2 = 200, 380          # checkpoint boundaries in the 520 stream


def small_store():
    return StateStore(StoreConfig(**SHAPE), device="cpu")


def warmed_engine(n_events=24, checkpointer=None, store=None):
    """An engine with some nontrivial state to checkpoint."""
    rng = np.random.default_rng(3)
    eng = StreamingEngine(store or small_store(), tparams(P), batch_size=4,
                          checkpointer=checkpointer)
    for _ in range(n_events):
        items = rng.choice(P.n_items, size=3, replace=False)
        eng.submit([add(int(rng.integers(0, 4)), items)])
    assert eng.run_until_drained() == n_events
    return eng


def add(user, items):
    return Event(KIND_ADD_BASKET, user, items=np.asarray(items))


# ---------------------------------------------------------------------------
# AsyncCheckpointer unit contract
# ---------------------------------------------------------------------------

def test_fifo_order_and_completed_labels():
    ck = AsyncCheckpointer()
    ran = []
    for i in range(5):
        ck.submit(lambda i=i: ran.append(i), label=f"job{i}")
    ck.flush()
    assert ran == [0, 1, 2, 3, 4]
    assert list(ck.completed_labels) == [f"job{i}" for i in range(5)]
    assert ck.pending == 0
    assert ck.error is None
    ck.close()


def test_error_fences_queue_and_surfaces_everywhere():
    ck = AsyncCheckpointer()
    gate = threading.Event()
    ran_after = []
    ck.submit(lambda: gate.wait(timeout=30), label="blocker")
    ck.submit(lambda: (_ for _ in ()).throw(ValueError("disk gone")),
              label="boom")
    # queued BEHIND the failing job: must be discarded whole, never run
    ck.submit(lambda: ran_after.append(1), label="after")
    gate.set()
    with pytest.raises(ValueError, match="disk gone"):
        ck.flush()
    assert ran_after == []
    assert list(ck.completed_labels) == ["blocker"]
    assert ck.error is not None
    # every later sync point keeps surfacing the recorded failure
    with pytest.raises(ValueError):
        ck.submit(lambda: None)
    with pytest.raises(ValueError):
        ck.flush()
    ck.close()


def test_closed_checkpointer_rejects_submit():
    ck = AsyncCheckpointer()
    ck.submit(lambda: None)
    ck.close()
    with pytest.raises(RuntimeError):
        ck.submit(lambda: None)


# ---------------------------------------------------------------------------
# snapshot-then-write semantics on the store
# ---------------------------------------------------------------------------

def test_async_commit_bitwise_equals_sync(tmp_path):
    store = warmed_engine().store
    ck = AsyncCheckpointer()
    store.checkpoint(str(tmp_path / "sync"), 5)
    path = store.checkpoint_async(ck, str(tmp_path / "async"), 5)
    ck.flush()
    assert path.endswith("state_0000000005.npz")

    meta_s, leaves_s = load_checkpoint_arrays(str(tmp_path / "sync"))
    meta_a, leaves_a = load_checkpoint_arrays(str(tmp_path / "async"))
    assert set(leaves_s) == set(leaves_a) == set(convert.LEAVES)
    for name in leaves_s:
        np.testing.assert_array_equal(leaves_s[name], leaves_a[name])
    # identical leaves serialize to identical committed bytes
    for key in ("step", "npz_crc32", "npz_bytes"):
        assert meta_s[key] == meta_a[key]
    ck.close()


def test_snapshot_isolation_under_later_mutation(tmp_path):
    """The commit lands the SNAPSHOT-time state, not the write-time one.

    The worker is gated shut while the engine keeps applying batches IN
    PLACE to the CPU store's tensors (whose ``.numpy()`` views alias
    them); the commit that then lands must restore bitwise to the state
    at ``checkpoint_async`` time.
    """
    ck = AsyncCheckpointer()
    eng = warmed_engine(checkpointer=ck)
    frozen = convert.state_to_numpy(eng.store.state)
    snap = eng.store._snapshot_leaves()
    for name in convert.LEAVES:
        assert not np.shares_memory(
            snap[name], getattr(eng.store.state, name).numpy()), name

    gate = threading.Event()
    ck.submit(lambda: gate.wait(timeout=30), label="gate")
    eng.store.checkpoint_async(ck, str(tmp_path / "ck"), 1)

    # mutate well past the snapshot while the writer is still gated
    rng = np.random.default_rng(9)
    for _ in range(16):
        eng.submit([add(int(rng.integers(0, 4)),
                                  rng.choice(P.n_items, size=3,
                                             replace=False))])
    eng.run_until_drained()
    gate.set()
    ck.flush()

    _, leaves = load_checkpoint_arrays(str(tmp_path / "ck"))
    for name, want in frozen.items():
        np.testing.assert_array_equal(leaves[name], want)
    # and the post-mutation live state genuinely moved on
    assert not np.array_equal(eng.store.state.n_baskets.numpy(),
                              frozen["n_baskets"])
    assert not np.array_equal(eng.store.state.user_vecs.numpy(),
                              frozen["user_vecs"])
    ck.close()


# ---------------------------------------------------------------------------
# engine-level async roundtrip, across packages too
# ---------------------------------------------------------------------------

def test_engine_async_checkpoint_roundtrip(tmp_path):
    ck = AsyncCheckpointer()
    eng = warmed_engine(checkpointer=ck)
    eng.checkpoint(str(tmp_path / "ck"), 1)
    eng.flush_checkpoints()
    want = eng.store.state.materialized_user_vecs().numpy()

    eng2 = StreamingEngine(small_store(), tparams(P), batch_size=4)
    eng2.restore(str(tmp_path / "ck"))
    np.testing.assert_array_equal(
        eng2.store.state.materialized_user_vecs().numpy(), want)
    assert eng2.watermark == eng.watermark
    # the JAX engine restores the port's async commit bit for bit
    jeng = JEngine(JStore(JConfig(**SHAPE)), P, batch_size=4)
    jeng.restore(str(tmp_path / "ck"))
    np.testing.assert_array_equal(
        np.asarray(jeng.store.state.materialized_user_vecs()), want)
    assert jeng.watermark == eng.watermark
    ck.close()


# ---------------------------------------------------------------------------
# the writer killed mid-flight while the engine streams on
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("site", ["async.dequeue", "LATEST.post_replace"])
def test_async_crash_restore_redeliver_converges(mixed, tmp_path, site):
    events = mixed["tevents"]
    ck = str(tmp_path / "ck")
    eng = make_mixed_port(checkpointer=AsyncCheckpointer())
    eng.submit(events[:SEG1])
    eng.run_until_drained()
    eng.checkpoint(ck, 1)
    eng.flush_checkpoints()              # commit 1 fully durable
    eng.submit(events[SEG1:SEG2])
    eng.run_until_drained()

    plan = faults.FaultPlan(crash_site=site)
    with faults.inject(plan):
        eng.checkpoint(ck, 2)            # snapshot + enqueue, returns
        eng.submit(events[SEG2:])        # hot path streams PAST the
        eng.run_until_drained()          # in-flight commit
        with pytest.raises(faults.InjectedCrash):
            eng.flush_checkpoints()      # writer crash surfaces HERE
    assert site in plan.fired

    # "process restart": fresh engine + fresh writer; restore lands on
    # the last committed LATEST (step 2 committed before the
    # post-replace crash, discarded whole at dequeue)
    eng2 = make_mixed_port(checkpointer=AsyncCheckpointer())
    eng2.restore(ck)
    want = 2 if site == "LATEST.post_replace" else 1
    assert eng2.store.last_restored_meta["step"] == want
    resume(eng2, events)
    assert_parity(eng2.store.state, mixed["clean"].store.state)
    assert_matches_ref(eng2.store.state, mixed["ref"], MM)


# ---------------------------------------------------------------------------
# the drain boundary's fetch budget
# ---------------------------------------------------------------------------

class FetchSpy:
    """Counts calls of ``StreamingEngine._fetch`` from outside."""

    def __init__(self, monkeypatch):
        self.calls = 0
        real = StreamingEngine._fetch

        def spy(eng, parts):
            self.calls += 1
            return real(eng, parts)

        monkeypatch.setattr(StreamingEngine, "_fetch", spy)


def test_empty_flush_costs_one_then_free(monkeypatch, tmp_path):
    """The deferred-maintenance flush is exactly one transfer, once; a
    checkpoint settles it the same way, and a second one is free."""
    spy = FetchSpy(monkeypatch)
    eng = StreamingEngine(small_store(), tparams(P), batch_size=16)

    # a fresh engine has nothing deferred: idle steps are free
    assert eng.step() == 0
    assert spy.calls == 0

    eng.submit([add(0, [1, 2, 3])])
    eng.step()                       # applies; defers the probe
    before = spy.calls
    assert eng.step() == 0           # empty step settles the probe...
    assert spy.calls == before + 1
    before = spy.calls
    assert eng.step() == 0           # ...after which idling is free
    assert spy.calls == before

    eng.submit([add(1, [4, 5])])
    eng.step()
    before = spy.calls
    eng.checkpoint(str(tmp_path), 1)     # settles the deferred summary
    assert spy.calls == before + 1
    eng.checkpoint(str(tmp_path), 2)     # nothing left to settle
    assert eng.step() == 0
    assert spy.calls == before + 1
    assert spy.calls == eng.metrics.host_fetches
