"""The unlearning no-op property on the port: ``delete(add(x)) == identity``.

The seeded sweep of ``tests/test_unlearning_property.py`` (4 seeds x
both deletion kinds), through ``repro_torch``'s engines at 1, 2 and 4
shards on the CPU: a stream with an add and the deletion(s) cancelling
it inserted at a seeded point must leave the port's engine in the state
of the stream without the pair --

* integer leaves (history, group sizes, basket/group counts) bitwise;
* materialized float values allclose (``atol=1e-5``: the raw/scale
  factoring of ``last_group_vecs`` is path-dependent even when the
  value is not);
* every leaf bitwise after ``refresh_users`` on all rows, the
  maintenance pass the engine itself runs.

And the with-pair state is held against the JAX engine's on the same
stream at the same shard count: integer leaves exact, materialized
vectors ``rtol=1e-4, atol=1e-5``.  The reference's hypothesis widening
is not ported.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core.types import KIND_DEL_BASKET, KIND_DEL_ITEM, \
    TifuParams
from repro_torch.core.updates import refresh_users
from repro_torch.launch import make_user_shard_devices
from repro_torch.parallel.sharding import UserShardSpec
from repro_torch.streaming import (Event, ShardedStreamingEngine, StateStore,
                                   StoreConfig, StreamingEngine)
from tests import test_unlearning_property as ref

P, M, N, B = ref.P, ref.M, ref.N, ref.B
TP = TifuParams(**{f.name: getattr(P, f.name)
                   for f in dataclasses.fields(TifuParams)})


def build(n_shards):
    """The port's engine at the reference module's geometry, on the CPU."""
    if n_shards == 1:
        store = StateStore(StoreConfig(n_users=M, n_items=P.n_items,
                                       max_baskets=N, max_basket_size=B),
                           device="cpu")
        return StreamingEngine(store, TP, batch_size=8)
    return ShardedStreamingEngine.create(
        UserShardSpec(M, n_shards), TP, max_baskets=N, max_basket_size=B,
        devices=make_user_shard_devices(n_shards, ["cpu"]), batch_size=8)


def to_port(events):
    return [Event(ev.kind, ev.user, items=ev.items, pos=ev.pos,
                  item=ev.item, seqno=ev.seqno) for ev in events]


def drained(eng, events):
    eng.submit(events)
    eng.run_until_drained()
    return eng


def stores_of(eng):
    """The per-shard StateStores of either of the port's engines."""
    if isinstance(eng, StreamingEngine):
        return [eng.store]
    return [sh.store for sh in eng.shards]


def materialized(st):
    return (st.materialized_user_vecs().numpy(),
            st.materialized_last_group_vecs().numpy())


def assert_noop(seed, cancel_kind, n_events=60):
    """delete(add(x)) == identity on the port, and the with-pair state
    against the JAX engine's, for one seeded stream."""
    rng = np.random.default_rng(seed)
    base, _ = ref.gen_stream(rng, n_events)
    u = int(rng.integers(0, M))
    cut = int(rng.integers(0, len(base) + 1))
    items = rng.choice(P.n_items, size=int(rng.integers(1, B)),
                       replace=False)
    probe = drained(build(1), to_port(base[:cut]))
    nb_u = int(probe.store.state.n_baskets[u])
    if nb_u >= N - 2:
        return                      # capacity edge: pair add would drop
    pair = ref.cancelled_pair(u, nb_u, items, cancel_kind)
    with_pair = base[:cut] + pair + base[cut:]

    for n_shards in (1, 2, 4):
        what = f"seed={seed} kind={cancel_kind} shards={n_shards}"
        eng_a = drained(build(n_shards), to_port(with_pair))
        eng_b = drained(build(n_shards), to_port(base))
        eng_j = drained(ref.build(n_shards), with_pair)
        for sa, sb, sj in zip(stores_of(eng_a), stores_of(eng_b),
                              ref.stores_of(eng_j)):
            for name in ref.INT_LEAVES:
                a = getattr(sa.state, name).numpy()
                np.testing.assert_array_equal(
                    a, getattr(sb.state, name).numpy(),
                    err_msg=f"{name} {what}")
                np.testing.assert_array_equal(
                    a, np.asarray(getattr(sj.state, name)),
                    err_msg=f"{name} vs JAX {what}")
            ma, mb = materialized(sa.state), materialized(sb.state)
            mj = (np.asarray(sj.state.materialized_user_vecs()),
                  np.asarray(sj.state.materialized_last_group_vecs()))
            for x, y, z in zip(ma, mb, mj):
                np.testing.assert_allclose(x, y, atol=1e-5,
                                           err_msg=f"materialized {what}")
                np.testing.assert_allclose(
                    x, z, rtol=1e-4, atol=1e-5,
                    err_msg=f"materialized vs JAX {what}")
            # after the refresh pass the factoring is canonical: EVERY
            # leaf bitwise (refresh_users works in place)
            rows = torch.arange(sa.cfg.n_users)
            ra = refresh_users(sa.state, rows, TP)
            rb = refresh_users(sb.state, rows, TP)
            for name in ref.INT_LEAVES + ref.FLOAT_LEAVES:
                np.testing.assert_array_equal(
                    getattr(ra, name).numpy(), getattr(rb, name).numpy(),
                    err_msg=f"post-refresh {name} {what}")


@pytest.mark.parametrize("cancel_kind", [KIND_DEL_BASKET, KIND_DEL_ITEM],
                         ids=["del_basket", "del_item"])
@pytest.mark.parametrize("seed", range(4))
def test_delete_add_noop_seeded(seed, cancel_kind):
    """Seeded sweep of the cancellation property at 1, 2 and 4 shards."""
    assert_noop(seed, cancel_kind)
