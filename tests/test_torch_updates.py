"""The port's sparse appliers, batch for batch, against the JAX appliers.

Each case starts both packages from one seeded state (carried across
with ``convert.state_from_numpy``), applies the same sub-batch and
compares all nine leaves.  Every padded batch below holds a VALID row
for user 0 beside padding rows that alias user 0, so a multiply-scatter
that lets the last duplicate win (``t[u] = t[u] * r``) fails here.

Tolerances: float leaves ``rtol=1e-5, atol=1e-6`` (fp32 powers and
quotients may round in another order than XLA's); integer leaves exact.
"""
import numpy as np
import pytest
import torch

from repro.core import types as jtypes
from repro.core import updates as jupd
from repro_torch import convert
from repro_torch.core import types as ttypes
from repro_torch.core import updates as tupd

P = jtypes.TifuParams(n_items=47, group_size=3, r_b=0.9, r_g=0.7)
TP = ttypes.TifuParams(n_items=47, group_size=3, r_b=0.9, r_g=0.7)
M, N, B, K = 10, 12, 5, 12
FLOAT_LEAVES = ("user_vecs", "last_group_vecs", "err_mult", "uv_scale",
                "lgv_scale")


def _seed_state(rng, n_baskets=None):
    """A JAX state where user u holds n_baskets[u] random baskets."""
    if n_baskets is None:
        n_baskets = [7, 1, 3, 4, 0, 6, 2, 9, 5, 3]
    state = jtypes.StreamState.zeros(M, P.n_items, N, B, K)
    for step in range(max(n_baskets)):
        users = [u for u in range(M) if n_baskets[u] > step]
        baskets = [rng.choice(P.n_items, size=int(rng.integers(1, B + 1)),
                              replace=False) for _ in users]
        state = jupd.apply_add_batch(
            state, jtypes.AddBatch.build(users, baskets, B), P)
    return convert.state_to_numpy(state)


def _both(arrays):
    jstate = jtypes.StreamState(**{k: np.array(v) for k, v in
                                   arrays.items()})
    return jstate, convert.state_from_numpy(arrays, device="cpu")


def _assert_states(jstate, tstate):
    exp = convert.state_to_numpy(jstate)
    got = convert.state_to_numpy(tstate)
    for name in convert.LEAVES:
        assert got[name].dtype == exp[name].dtype, name
        if name in FLOAT_LEAVES:
            np.testing.assert_allclose(got[name], exp[name], rtol=1e-5,
                                       atol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(got[name], exp[name],
                                          err_msg=name)
    np.testing.assert_allclose(
        tstate.materialized_user_vecs().numpy(),
        np.asarray(jstate.materialized_user_vecs()), rtol=1e-5, atol=1e-6)


def test_add_batch_matches_jax(rng):
    """Eq. 7 (new group) and Eq. 8+9 (append), a user at k = 0, and a
    padded bucket whose padding rows alias the valid user 0."""
    arrays = _seed_state(rng)
    users = [0, 4, 2, 3, 5]        # 4 holds no basket yet (k = 0)
    baskets = [rng.choice(P.n_items, size=3, replace=False) for _ in users]
    baskets[1] = np.array([5, 5, 9, -1])            # dup + PAD dropped
    jb = jtypes.AddBatch.build(users, baskets, B, pad_to=8)
    tb = ttypes.AddBatch.build(users, baskets, B, pad_to=8, device="cpu")
    jstate, tstate = _both(arrays)
    jstate, jdrop = jupd.apply_add_batch_counted(jstate, jb, P)
    out, tdrop = tupd.apply_add_batch_counted(tstate, tb, TP)
    assert out is tstate                            # updated in place
    assert int(tdrop) == int(jdrop) == 0
    _assert_states(jstate, tstate)


def test_add_batch_capacity_drops_counted(rng):
    """Adds to a user whose history is full are no-ops, counted."""
    arrays = _seed_state(rng, n_baskets=[N, 2, N, 0, 1, 0, 0, 0, 0, 0])
    users = [0, 1, 2, 3]
    baskets = [rng.choice(P.n_items, size=2, replace=False) for _ in users]
    jb = jtypes.AddBatch.build(users, baskets, B, pad_to=8)
    tb = ttypes.AddBatch.build(users, baskets, B, pad_to=8, device="cpu")
    jstate, tstate = _both(arrays)
    jstate, jdrop = jupd.apply_add_batch_counted(jstate, jb, P)
    _, tdrop = tupd.apply_add_batch_counted(tstate, tb, TP)
    assert int(tdrop) == int(jdrop) == 2
    _assert_states(jstate, tstate)
    assert tupd.apply_add_batch(tstate, tb, TP) is tstate


@pytest.mark.parametrize("positions", [
    [0, 0, 2, 3, 0, 5],            # s1 (group shrinks) and more
    [6, 0, 0, 1, 0, 0],            # last basket of user 0, user 1 empties
])
def test_del_basket_batch_matches_jax(rng, positions):
    """Scenario 1 (tau_j > 1), scenario 2 (a single-basket group
    vanishes), scenario 3 (the last basket goes), a user with an empty
    history (no-op) and padding rows aliasing user 0."""
    arrays = _seed_state(rng)
    users = [0, 1, 3, 5, 4, 7]
    jb = jtypes.DelBasketBatch.build(users, positions, pad_to=8)
    tb = ttypes.DelBasketBatch.build(users, positions, pad_to=8,
                                     device="cpu")
    jstate, tstate = _both(arrays)
    jstate = jupd.apply_del_basket_batch(jstate, jb, P)
    assert tupd.apply_del_basket_batch(tstate, tb, TP) is tstate
    _assert_states(jstate, tstate)


def test_del_basket_every_position(rng):
    """Every position of a 7-basket user (groups 3+3+1): all three
    scenarios across the group structure, one batch each."""
    arrays = _seed_state(rng)
    for pos in range(7):
        jb = jtypes.DelBasketBatch.build([0, 9], [pos, 0], pad_to=4)
        tb = ttypes.DelBasketBatch.build([0, 9], [pos, 0], pad_to=4,
                                         device="cpu")
        jstate, tstate = _both(arrays)
        jstate = jupd.apply_del_basket_batch(jstate, jb, P)
        tupd.apply_del_basket_batch(tstate, tb, TP)
        _assert_states(jstate, tstate)


def test_del_item_batch_matches_jax(rng):
    """Eq. 13 in place, the basket-vanish fallback, an absent item (no
    effect) and padding rows aliasing user 0."""
    arrays = _seed_state(rng)
    hist = arrays["history"]
    # the first item of a basket: in place, or the vanish fallback
    users, pos, items = [], [], []
    for u, p in ((0, 2), (1, 0), (3, 1), (5, 4), (7, 8)):
        users.append(u)
        pos.append(p)
        items.append(int(hist[u, p, 0]))
    arrays["history"][1, 0, 1:] = -1        # user 1's basket: one item
    users.append(8)
    pos.append(0)
    items.append(46 if 46 not in hist[8, 0] else 45)   # not in the basket
    jb = jtypes.DelItemBatch.build(users, pos, items, pad_to=8)
    tb = ttypes.DelItemBatch.build(users, pos, items, pad_to=8,
                                   device="cpu")
    jstate, tstate = _both(arrays)
    jstate = jupd.apply_del_item_batch(jstate, jb, P)
    assert tupd.apply_del_item_batch(tstate, tb, TP) is tstate
    _assert_states(jstate, tstate)


def test_refresh_and_renormalize_match_jax(rng):
    arrays = _seed_state(rng)
    arrays["err_mult"][[0, 3]] = 5e4
    users = np.array([0, 3, 7], np.int32)
    jstate, tstate = _both(arrays)
    jstate = jupd.refresh_users(jstate, users, P)
    assert tupd.refresh_users(tstate, torch.from_numpy(users), TP) is tstate
    _assert_states(jstate, tstate)
    jstate, tstate = _both(arrays)
    jstate = jupd.renormalize_users(jstate, users)
    assert tupd.renormalize_users(tstate, torch.from_numpy(users)) is tstate
    _assert_states(jstate, tstate)
    assert np.all(tstate.uv_scale.numpy()[users] == 1.0)


def test_scale_bounds_match_jax():
    assert (tupd.SCALE_FLOOR, tupd.SCALE_CEIL) == \
        (jupd.SCALE_FLOOR, jupd.SCALE_CEIL)


def test_first_occurrence_and_capacity_mask_match_jax(rng):
    import jax.numpy as jnp
    ids = rng.integers(-1, 6, (5, 9)).astype(np.int32)
    got = tupd._first_occurrence(torch.from_numpy(ids)).numpy()
    exp = np.asarray(jupd._first_occurrence(jnp.asarray(ids)))
    # one representative per distinct non-PAD id per row (the slot may
    # differ; consumers depend only on the id)
    for g, e, row in zip(got, exp, ids):
        assert sorted(row[g].tolist()) == sorted(row[e].tolist())
        assert sorted(row[g].tolist()) == sorted(set(row[row >= 0]))
    nb = np.array([0, 3, 12, 5]), np.array([0, 1, 4, 12])
    tau = np.array([0, 2, 3, 3])
    exp = np.asarray(jupd._capacity_mask(jnp.asarray(nb[0]),
                                         jnp.asarray(nb[1]),
                                         jnp.asarray(tau), N, K, 3))
    got = tupd._capacity_mask(torch.from_numpy(nb[0]),
                              torch.from_numpy(nb[1]),
                              torch.from_numpy(tau), N, K, 3).numpy()
    np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("fn", ["user_vector_padded",
                                "last_group_vector_padded"])
def test_from_scratch_vectors_match_jax(rng, fn):
    """The refresh path's Eq. 1+2 rebuild, user by user against the JAX
    per-user function (the port takes the user dimension explicitly)."""
    import jax.numpy as jnp
    from repro.core import tifu as jtifu
    from repro_torch.core import tifu as ttifu
    arrays = _seed_state(rng)
    h, gs, ng = (arrays[k] for k in ("history", "group_sizes", "n_groups"))
    got = getattr(ttifu, fn)(torch.from_numpy(h), torch.from_numpy(gs),
                             torch.from_numpy(ng), TP).numpy()
    for u in range(M):
        exp = getattr(jtifu, fn)(jnp.asarray(h[u]), jnp.asarray(gs[u]),
                                 jnp.asarray(ng[u]), P)
        np.testing.assert_allclose(got[u], np.asarray(exp), rtol=1e-5,
                                   atol=1e-7, err_msg=f"u={u}")


def test_basket_weights_and_suffix_coefficients_match_jax(rng):
    import jax.numpy as jnp
    from repro.core import decay as jdecay
    from repro.core import tifu as jtifu
    from repro_torch.core import decay as tdecay
    from repro_torch.core import tifu as ttifu
    arrays = _seed_state(rng)
    gs, ng = arrays["group_sizes"], arrays["n_groups"]
    got = ttifu.closed_form_basket_weights(
        torch.from_numpy(gs), torch.from_numpy(ng), P.r_b, P.r_g, N).numpy()
    n = torch.tensor([5, 5, 3, 1, 4])
    i = torch.tensor([1, 3, 3, 1, 5])
    coef = tdecay.batched_suffix_coefficients(n, i, P.r_g, K).numpy()
    for u in range(M):
        exp = jtifu.closed_form_basket_weights(
            jnp.asarray(gs[u]), jnp.asarray(ng[u]), P.r_b, P.r_g, N)
        np.testing.assert_allclose(got[u], np.asarray(exp), rtol=1e-6)
    for r in range(len(n)):
        exp = jdecay.batched_suffix_coefficients(int(n[r]), int(i[r]),
                                                 P.r_g, K)
        np.testing.assert_allclose(coef[r], np.asarray(exp), rtol=1e-6)
