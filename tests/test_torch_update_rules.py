"""The paper's update rules in the port, against the JAX package.

``apply_update_batch`` (the kind-partitioned shim), the dense baseline
``apply_update_batch_dense`` (every rule on every row, one picked) and
the per-kind dense route (``apply_add_batch``, then
``apply_del_basket_batch_dense`` / ``apply_del_item_batch_dense``, as
``benchmarks/bench_update_batch.py::_dense_kind_apply`` routes a batch)
each run beside their JAX twin from one state, carried across with
``convert.state_from_numpy``, on the same numpy-seeded events:

  * single events, 3 seeds x 60 (the pattern of
    ``tests/test_updates_jax.py::test_random_ops_match_ref``), compared
    after every event;
  * the 520-event mixed stream of ``tests/test_update_partition.py`` cut
    into batches of 64 rows (a batch closes early where a user would
    repeat; noop rows fill it), compared after every batch;
  * every branch of the basket deletion (the basket's group keeps
    others; a single-basket group vanishes among others; the last
    basket goes) and of the item deletion (item absent, removed in
    place, basket vanishes) at every position of built histories;
  * noop batches and deletes on empty histories, which change no bit;
  * an add to a full history: the dense route overruns as JAX's does
    (the history's last row overwritten, ``n_baskets`` past N), the shim
    drops it.

Tolerance: integer leaves exact; materialized user and last-group
vectors and ``err_mult`` ``rtol=1e-4, atol=1e-5`` (the bar the JAX
package holds its own engine to, ``tests/test_update_partition.py``:
float32 powers and quotients round in another order than XLA's).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import RefEngine
from repro.core import types as jt
from repro.core import updates as ju
from repro_torch import convert
from repro_torch.core import types as tt
from repro_torch.core import updates as tu
from test_update_partition import random_mixed_events

INT_LEAVES = ("history", "group_sizes", "n_baskets", "n_groups")
ROUTES = ("shim", "dense", "dense_kind")


def params(n_items, group_size=3):
    return (jt.TifuParams(n_items=n_items, group_size=group_size,
                          r_b=0.9, r_g=0.7),
            tt.TifuParams(n_items=n_items, group_size=group_size,
                          r_b=0.9, r_g=0.7))


def both_states(arrays):
    """A JAX state and a port state (on the CPU) of the same arrays."""
    return (jt.StreamState(**{k: jnp.array(v) for k, v in arrays.items()}),
            convert.state_from_numpy(arrays, device="cpu"))


def empty_arrays(m, n_items, n, b, k=None):
    return convert.state_to_numpy(jt.StreamState.zeros(m, n_items, n, b, k))


def update_batches(kind, user, items, pos, item):
    """The same mixed batch in both packages, from numpy rows."""
    cols = dict(kind=kind, user=user, basket_items=items, basket_pos=pos,
                item=item)
    cols = {k: np.asarray(v, np.int32) for k, v in cols.items()}
    return (jt.UpdateBatch(**{k: jnp.asarray(v) for k, v in cols.items()}),
            tt.UpdateBatch(**{k: torch.from_numpy(v.copy())
                              for k, v in cols.items()}))


def one_event(kind, u, b, items=(), pos=0, item=tt.PAD_ID):
    row = np.full((1, b), tt.PAD_ID, np.int32)
    row[0, :len(items)] = items
    return update_batches([kind], [u], row, [pos], [item])


def dense_kind(pkg, state, batch, p):
    """``_dense_kind_apply`` in either package: sparse adds, then the
    dense basket and item deletions."""
    types, upd = (jt, ju) if pkg == "jax" else (tt, tu)
    dev = {} if pkg == "jax" else dict(device="cpu")
    host = (lambda x: np.asarray(x)) if pkg == "jax" else \
        (lambda x: x.numpy())
    kind, user = host(batch.kind), host(batch.user)
    items, pos, item = (host(batch.basket_items), host(batch.basket_pos),
                        host(batch.item))
    cap = int(kind.shape[0])
    adds = np.nonzero(kind == tt.KIND_ADD_BASKET)[0]
    delb = np.nonzero(kind == tt.KIND_DEL_BASKET)[0]
    deli = np.nonzero(kind == tt.KIND_DEL_ITEM)[0]
    if adds.size:
        state = upd.apply_add_batch(state, types.AddBatch.build(
            user[adds], items[adds], items.shape[1], pad_cap=cap, **dev), p)
    if delb.size:
        state = upd.apply_del_basket_batch_dense(
            state, types.DelBasketBatch.build(user[delb], pos[delb],
                                              pad_cap=cap, **dev), p)
    if deli.size:
        state = upd.apply_del_item_batch_dense(
            state, types.DelItemBatch.build(user[deli], pos[deli],
                                            item[deli], pad_cap=cap, **dev),
            p)
    return state


def apply_both(route, jstate, tstate, jb, tb, jp, tp):
    """One batch through ``route`` in both packages; the port's state is
    updated in place and returned as the same object."""
    if route == "shim":
        jstate = ju.apply_update_batch(jstate, jb, jp)
        out = tu.apply_update_batch(tstate, tb, tp)
    elif route == "dense":
        jstate = ju.apply_update_batch_dense(jstate, jb, jp)
        out = tu.apply_update_batch_dense(tstate, tb, tp)
    else:
        jstate = dense_kind("jax", jstate, jb, jp)
        out = dense_kind("torch", tstate, tb, tp)
    assert out is tstate
    return jstate


def assert_states(jstate, tstate, what=""):
    exp = convert.state_to_numpy(jstate)
    got = convert.state_to_numpy(tstate)
    for name in convert.LEAVES:
        assert got[name].dtype == exp[name].dtype, (what, name)
    for name in INT_LEAVES:
        np.testing.assert_array_equal(got[name], exp[name],
                                      err_msg=f"{what} {name}")
    for fn in ("materialized_user_vecs", "materialized_last_group_vecs"):
        np.testing.assert_allclose(
            getattr(tstate, fn)().numpy(), np.asarray(getattr(jstate, fn)()),
            rtol=1e-4, atol=1e-5, err_msg=f"{what} {fn}")
    np.testing.assert_allclose(got["err_mult"], exp["err_mult"], rtol=1e-4,
                               atol=1e-5, err_msg=f"{what} err_mult")


def assert_bitwise(before, state):
    after = convert.state_to_numpy(state)
    for name in convert.LEAVES:
        np.testing.assert_array_equal(after[name], before[name],
                                      err_msg=name)


# ---------------------------------------------------------------------------
# single events, 3 seeds x 60
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_single_events_match_jax(seed, route):
    jp, tp = params(37)
    m, n, b, k = 4, 32, 8, 32
    rng = np.random.default_rng(seed)
    jstate, tstate = both_states(empty_arrays(m, 37, n, b, k))
    ref = RefEngine(jp, dtype=np.float32)
    for t in range(60):
        u = int(rng.integers(0, m))
        st = ref.state(u)
        choices = [tt.KIND_ADD_BASKET]
        if st.n_baskets > 0:
            choices += [tt.KIND_DEL_BASKET, tt.KIND_DEL_ITEM]
        kind = int(rng.choice(choices))
        if kind == tt.KIND_ADD_BASKET and st.n_baskets >= n - 1:
            kind = tt.KIND_DEL_BASKET
        if kind == tt.KIND_ADD_BASKET:
            basket = rng.choice(37, size=int(rng.integers(1, 6)),
                                replace=False)
            ref.add_basket(u, basket)
            jb, tb = one_event(kind, u, b, items=basket)
        elif kind == tt.KIND_DEL_BASKET:
            pos = int(rng.integers(0, st.n_baskets))
            ref.delete_basket(u, pos)
            jb, tb = one_event(kind, u, b, pos=pos)
        else:
            pos = int(rng.integers(0, st.n_baskets))
            item = int(rng.choice(st.history[pos]))
            ref.delete_item(u, pos, item)
            jb, tb = one_event(kind, u, b, pos=pos, item=item)
        jstate = apply_both(route, jstate, tstate, jb, tb, jp, tp)
        assert_states(jstate, tstate, f"event {t} kind {kind}")
    # and both agree with the paper-faithful engine
    mat = tstate.materialized_user_vecs().numpy()
    for u in range(m):
        np.testing.assert_allclose(mat[u], ref.state(u).user_vec, rtol=1e-4,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# mixed batches of 64 on the 520-event stream
# ---------------------------------------------------------------------------

def cut_batches(events, rows, b):
    """Events in order into batches of ``rows`` rows, a batch closed early
    where a user would repeat, each filled with noop rows (user 0)."""
    out, cur = [], []

    def close():
        kind = np.zeros(rows, np.int32)
        user = np.zeros(rows, np.int32)
        items = np.full((rows, b), tt.PAD_ID, np.int32)
        pos = np.zeros(rows, np.int32)
        item = np.full(rows, tt.PAD_ID, np.int32)
        for r, ev in enumerate(cur):
            kind[r], user[r] = ev.kind, ev.user
            if ev.items is not None:
                items[r, :len(ev.items)] = ev.items
            pos[r] = ev.pos
            item[r] = ev.item
        out.append((kind, user, items, pos, item))

    for ev in events:
        if len(cur) == rows or any(e.user == ev.user for e in cur):
            close()
            cur = []
        cur.append(ev)
    if cur:
        close()
    return out


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("seed", [0, 1])
def test_mixed_batches_of_64_match_jax(seed, route):
    """The 520-event stream (``random_mixed_events``: 8 users, 41 items,
    N = K = 48, B = 6) in batches of 64, each route against its JAX twin
    after every batch."""
    from test_update_partition import B, K, M, N, P
    jp, tp = params(P.n_items, P.group_size)
    rng = np.random.default_rng(seed)
    events = random_mixed_events(rng, RefEngine(P, dtype=np.float32), 520, M)
    batches = cut_batches(events, 64, B)
    assert len(batches) > 520 // M            # users repeat: early closes
    jstate, tstate = both_states(empty_arrays(M, P.n_items, N, B, K))
    for i, cols in enumerate(batches):
        jb, tb = update_batches(*cols)
        jstate = apply_both(route, jstate, tstate, jb, tb, jp, tp)
        assert_states(jstate, tstate, f"batch {i}")


def test_the_three_routes_agree_with_each_other():
    """On one mixed stream the shim, the dense baseline and the per-kind
    dense route end in the same state: integer leaves exact, each history
    row as a set (the sparse add stores a basket as ``AddBatch.build``
    makes it, sorted by ``np.unique``; the dense add as it is given, in
    both packages)."""
    from test_update_partition import B, K, M, N, P
    _, tp = params(P.n_items, P.group_size)
    rng = np.random.default_rng(7)
    events = random_mixed_events(rng, RefEngine(P, dtype=np.float32), 520, M)
    finals = []
    for route in ROUTES:
        state = convert.state_from_numpy(empty_arrays(M, P.n_items, N, B, K),
                                         device="cpu")
        for cols in cut_batches(events, 64, B):
            tb = update_batches(*cols)[1]
            if route == "shim":
                tu.apply_update_batch(state, tb, tp)
            elif route == "dense":
                tu.apply_update_batch_dense(state, tb, tp)
            else:
                dense_kind("torch", state, tb, tp)
        finals.append(state)
    for other in finals[1:]:
        for name in ("group_sizes", "n_baskets", "n_groups"):
            assert torch.equal(getattr(other, name), getattr(finals[0], name))
        assert torch.equal(other.history.sort(dim=2).values,
                           finals[0].history.sort(dim=2).values)
        for fn in ("materialized_user_vecs", "materialized_last_group_vecs"):
            torch.testing.assert_close(getattr(other, fn)(),
                                       getattr(finals[0], fn)(), rtol=1e-4,
                                       atol=1e-5)


# ---------------------------------------------------------------------------
# every branch of the deletions, at every position of built histories
# ---------------------------------------------------------------------------

GP = params(29)
BRANCH_B = 5


def built_arrays():
    """Four users built through the JAX shim (group size 3):
    user 0 — 7 baskets of 3 items, groups 3 + 3 + 1;
    user 1 — 1 basket (its deletion empties the state);
    user 2 — 7 baskets, then its 4th and 5th deleted: groups 3 + 1 + 1,
             so a single-basket group sits between others;
    user 3 — 7 one-item baskets (an item deletion vanishes the basket)."""
    jp = GP[0]
    rng = np.random.default_rng(11)
    jstate = jt.StreamState.zeros(4, 29, 10, BRANCH_B, 10)
    plan = [(0, 7, 3), (1, 1, 3), (2, 7, 3), (3, 7, 1)]
    for step in range(7):
        for u, n_b, size in plan:
            if step < n_b:
                basket = rng.choice(29, size=size, replace=False)
                jstate = ju.apply_update_batch(
                    jstate, one_event(tt.KIND_ADD_BASKET, u, BRANCH_B,
                                      items=basket)[0], jp)
    for _ in range(2):
        jstate = ju.apply_update_batch(
            jstate, one_event(tt.KIND_DEL_BASKET, 2, BRANCH_B, pos=3)[0], jp)
    arrays = convert.state_to_numpy(jstate)
    assert list(arrays["group_sizes"][0][:3]) == [3, 3, 1]
    assert list(arrays["group_sizes"][2][:3]) == [3, 1, 1]
    assert int(arrays["n_baskets"][1]) == 1
    return arrays


BUILT = built_arrays()


def basket_branch(u, pos):
    gs = [int(x) for x in BUILT["group_sizes"][u] if x]
    ends = np.cumsum(gs)
    j = int(np.searchsorted(ends, pos, side="right"))
    if gs[j] > 1:
        return "group_keeps_others"
    return "group_vanishes" if len(gs) > 1 else "state_empties"


BASKET_CASES = [(u, pos) for u in (0, 1, 2)
                for pos in range(int(BUILT["n_baskets"][u]))]


def item_cases():
    cases = []
    for u, branch in ((0, "in_place"), (3, "vanish")):
        for pos in range(int(BUILT["n_baskets"][u])):
            cases.append((u, pos, int(BUILT["history"][u, pos, 0]), branch))
    absent = [i for i in range(29) if i not in BUILT["history"][0]][0]
    for pos in range(int(BUILT["n_baskets"][0])):
        cases.append((0, pos, absent, "absent"))
    return cases


def test_the_cases_reach_every_branch():
    assert {basket_branch(u, pos) for u, pos in BASKET_CASES} == \
        {"group_keeps_others", "group_vanishes", "state_empties"}
    # a single-basket group vanishing with groups on both sides
    assert basket_branch(2, 3) == "group_vanishes"
    assert {c[3] for c in item_cases()} == {"in_place", "vanish", "absent"}


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("u,pos", BASKET_CASES,
                         ids=[f"u{u}-pos{p}-{basket_branch(u, p)}"
                              for u, p in BASKET_CASES])
def test_basket_deletion_branches_match_jax(u, pos, route):
    jstate, tstate = both_states(BUILT)
    jb, tb = one_event(tt.KIND_DEL_BASKET, u, BRANCH_B, pos=pos)
    jstate = apply_both(route, jstate, tstate, jb, tb, *GP)
    assert_states(jstate, tstate)
    assert int(tstate.n_baskets[u]) == int(BUILT["n_baskets"][u]) - 1
    assert (tstate.history[u, int(tstate.n_baskets[u]):] == tt.PAD_ID).all()


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("u,pos,item,branch", item_cases(),
                         ids=[f"u{c[0]}-pos{c[1]}-{c[3]}"
                              for c in item_cases()])
def test_item_deletion_branches_match_jax(u, pos, item, branch, route):
    jstate, tstate = both_states(BUILT)
    jb, tb = one_event(tt.KIND_DEL_ITEM, u, BRANCH_B, pos=pos, item=item)
    jstate = apply_both(route, jstate, tstate, jb, tb, *GP)
    assert_states(jstate, tstate)
    n_b = int(tstate.n_baskets[u])
    if branch == "absent":
        assert_bitwise(BUILT, tstate)
    elif branch == "vanish":
        assert n_b == int(BUILT["n_baskets"][u]) - 1
    else:
        assert n_b == int(BUILT["n_baskets"][u])
        assert item not in tstate.history[u, pos].tolist()


# ---------------------------------------------------------------------------
# no-ops, empty histories, set semantics, the add's capacity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", ROUTES)
def test_noop_batches_change_no_bit(route):
    jstate, tstate = both_states(BUILT)
    jb = jt.UpdateBatch.noop(8, BRANCH_B)
    tb = tt.UpdateBatch.noop(8, BRANCH_B, device="cpu")
    jstate = apply_both(route, jstate, tstate, jb, tb, *GP)
    assert_bitwise(BUILT, tstate)
    assert_bitwise(BUILT, jstate)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("kind", [tt.KIND_DEL_BASKET, tt.KIND_DEL_ITEM])
def test_deletes_on_an_empty_history_are_noops(kind, route):
    """User 1 after its only basket went: a delete of either kind, at
    position 0 and past it, changes no bit; beside an add of user 0 in
    the same batch it changes nothing of user 1."""
    jstate, tstate = both_states(BUILT)
    jb, tb = one_event(tt.KIND_DEL_BASKET, 1, BRANCH_B, pos=0)
    jstate = apply_both(route, jstate, tstate, jb, tb, *GP)
    empty = convert.state_to_numpy(tstate)
    assert int(empty["n_baskets"][1]) == 0
    for pos in (0, 3):
        jb, tb = one_event(kind, 1, BRANCH_B, pos=pos, item=7)
        jstate = apply_both(route, jstate, tstate, jb, tb, *GP)
        assert_bitwise(empty, tstate)
    row = np.full((2, BRANCH_B), tt.PAD_ID, np.int32)
    row[1, :2] = [4, 6]
    jb, tb = update_batches([kind, tt.KIND_ADD_BASKET], [1, 0], row, [0, 0],
                            [7, tt.PAD_ID])
    jstate = apply_both(route, jstate, tstate, jb, tb, *GP)
    assert_states(jstate, tstate)
    after = convert.state_to_numpy(tstate)
    for name in convert.LEAVES:
        np.testing.assert_array_equal(after[name][1], empty[name][1])


def test_multi_hot_counts_a_duplicate_once():
    """The dense add's multi-hot has set semantics: [5, 5, 9] adds 5 and
    9 once each, as JAX's ``_multi_hot``."""
    jstate, tstate = both_states(empty_arrays(2, 29, 6, 4))
    jb, tb = one_event(tt.KIND_ADD_BASKET, 1, 4, items=[5, 5, 9])
    jstate = apply_both("dense", jstate, tstate, jb, tb, *GP)
    assert_states(jstate, tstate)
    v = tstate.materialized_user_vecs()[1]
    assert float(v[5]) == float(v[9]) == 1.0
    assert float(v.sum()) == 2.0
    np.testing.assert_array_equal(
        tu._multi_hot(torch.tensor([[5, 5, 9, -1]]), 29).numpy()[0],
        np.asarray(ju._multi_hot(jnp.array([5, 5, 9, -1]), 29)))


def test_dense_add_overruns_a_full_history_as_jax_does():
    """N = 4, group size 3, six adds to user 0.  The dense add has no
    capacity check in either package: it writes the 5th and 6th baskets
    over the last history row, counts 6 baskets and groups [3, 3].  The
    shim's sparse add drops them: 4 baskets, groups [3, 1]."""
    jp, tp = params(23)
    rng = np.random.default_rng(3)
    events = [rng.choice(23, size=3, replace=False) for _ in range(6)]
    out = {}
    for route in ("dense", "shim"):
        jstate, tstate = both_states(empty_arrays(2, 23, 4, 5))
        for basket in events:
            jb, tb = one_event(tt.KIND_ADD_BASKET, 0, 5, items=basket)
            jstate = apply_both(route, jstate, tstate, jb, tb, jp, tp)
            assert_states(jstate, tstate, route)
        out[route] = convert.state_to_numpy(tstate)
    dense, shim = out["dense"], out["shim"]
    assert int(dense["n_baskets"][0]) == 6
    assert list(dense["group_sizes"][0]) == [3, 3, 0, 0]
    assert sorted(dense["history"][0, 3, :3]) == sorted(events[5])
    assert int(shim["n_baskets"][0]) == 4
    assert list(shim["group_sizes"][0]) == [3, 1, 0, 0]
    assert sorted(shim["history"][0, 3, :3]) == sorted(events[3])


def test_dense_route_is_plain_torch():
    """The dense baselines launch no kernel wrapper: on a CUDA-less
    machine they run through the CPU ops alone, and ``kernels.ops`` is
    not reached (its two sparse entry points replaced by traps)."""
    tstate = convert.state_from_numpy(BUILT, device="cpu")
    saved = tu.sparse_row_gather, tu.sparse_row_scatter

    def trap(*a, **k):
        raise AssertionError("the dense route reached kernels.ops")

    tu.sparse_row_gather = tu.sparse_row_scatter = trap
    try:
        tb = one_event(tt.KIND_DEL_ITEM, 0, BRANCH_B, pos=2,
                       item=int(BUILT["history"][0, 2, 0]))[1]
        tu.apply_update_batch_dense(tstate, tb, GP[1])
        tu.apply_del_basket_batch_dense(tstate, tt.DelBasketBatch.build(
            [0], [1], device="cpu"), GP[1])
    finally:
        tu.sparse_row_gather, tu.sparse_row_scatter = saved


@pytest.mark.parametrize("route", ["dense", "shim"])
def test_dense_add_overruns_a_full_group_table_as_jax_does(route):
    """K = 2 groups of up to 3 baskets, N = 12, eight adds to user 0.
    The dense add reads a group size past K at K's last entry and drops
    a write past it, as JAX's indexing does: the 7th add opens a third
    group over slot 1, the 8th appends to it where no slot is, so the
    sizes stay [3, 1] while ``n_groups`` reads 3.  The shim drops both
    adds: 6 baskets, sizes [3, 3]."""
    jp, tp = params(23)
    rng = np.random.default_rng(5)
    jstate, tstate = both_states(empty_arrays(2, 23, 12, 5, 2))
    for _ in range(8):
        jb, tb = one_event(tt.KIND_ADD_BASKET, 0, 5,
                           items=rng.choice(23, size=3, replace=False))
        jstate = apply_both(route, jstate, tstate, jb, tb, jp, tp)
        assert_states(jstate, tstate, route)
    got = convert.state_to_numpy(tstate)
    exp = {"dense": (8, 3, [3, 1]), "shim": (6, 2, [3, 3])}[route]
    assert (int(got["n_baskets"][0]), int(got["n_groups"][0]),
            list(got["group_sizes"][0])) == exp


@pytest.mark.parametrize("route", ["dense", "dense_kind"])
def test_fast_decay_keeps_unpicked_branches_out(route):
    """r_b = r_g = 0.05, six baskets a user in a history of N = 40 rows:
    r_b^(tau_j - p) on the padding rows reaches 0.05^-34, past float32's
    range, in terms no row keeps (``torch.where`` and the scatter's PAD
    mask leave them out); the state stays finite and equal to JAX's."""
    jp = jt.TifuParams(n_items=31, group_size=3, r_b=0.05, r_g=0.05)
    tp = tt.TifuParams(n_items=31, group_size=3, r_b=0.05, r_g=0.05)
    rng = np.random.default_rng(9)
    jstate, tstate = both_states(empty_arrays(4, 31, 40, 4, 40))
    for t in range(24):
        jb, tb = one_event(tt.KIND_ADD_BASKET, t % 4, 4,
                           items=rng.choice(31, size=3, replace=False))
        jstate = apply_both(route, jstate, tstate, jb, tb, jp, tp)
    for pos in (0, 2, 4):
        jb, tb = one_event(tt.KIND_DEL_BASKET, 0, 4, pos=pos)
        jstate = apply_both(route, jstate, tstate, jb, tb, jp, tp)
        item = int(tstate.history[1, pos, 0])
        jb, tb = one_event(tt.KIND_DEL_ITEM, 1, 4, pos=pos, item=item)
        jstate = apply_both(route, jstate, tstate, jb, tb, jp, tp)
        for name in convert.LEAVES:
            assert torch.isfinite(getattr(tstate, name).float()).all(), name
        assert_states(jstate, tstate, f"pos {pos}")
