"""The port's datatypes, state carrier and data generators vs the JAX package.

Everything here is exact: sub-batch builds, the state round trip and
the seeded generators produce integers or copies, so the port must give
the same arrays bit for bit.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import types as jtypes
from repro.data import stream as jstream
from repro.data import synthetic as jsynth
from repro_torch import convert
from repro_torch.core import types as ttypes
from repro_torch.data import stream as tstream
from repro_torch.data import synthetic as tsynth


def _same(jax_batch, torch_batch):
    for f in dataclasses.fields(jax_batch):
        a = np.asarray(getattr(jax_batch, f.name))
        b = getattr(torch_batch, f.name).numpy()
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)


@pytest.mark.parametrize("pad_cap,pad_to", [(0, 0), (4, 0), (0, 8)])
def test_add_batch_build_matches_jax(pad_cap, pad_to):
    users = [3, 0, 7]
    baskets = [np.array([5, 1, 5, -1]), [2], np.array([9, 8, 7, 6, 5, 4])]
    _same(jtypes.AddBatch.build(users, baskets, 5, pad_cap=pad_cap,
                                pad_to=pad_to),
          ttypes.AddBatch.build(users, baskets, 5, pad_cap=pad_cap,
                                pad_to=pad_to, device="cpu"))


@pytest.mark.parametrize("pad_cap,pad_to", [(0, 0), (2, 0), (0, 4)])
def test_delete_batch_builds_match_jax(pad_cap, pad_to):
    users, pos, items = [4, 1], [0, 3], [11, 2]
    _same(jtypes.DelBasketBatch.build(users, pos, pad_cap=pad_cap,
                                      pad_to=pad_to),
          ttypes.DelBasketBatch.build(users, pos, pad_cap=pad_cap,
                                      pad_to=pad_to, device="cpu"))
    _same(jtypes.DelItemBatch.build(users, pos, items, pad_cap=pad_cap,
                                    pad_to=pad_to),
          ttypes.DelItemBatch.build(users, pos, items, pad_cap=pad_cap,
                                    pad_to=pad_to, device="cpu"))


def test_pad_helpers_match_jax():
    for n in range(0, 70):
        for cap in (0, 1, 16, 64):
            assert ttypes._pow2_pad(n, cap) == jtypes._pow2_pad(n, cap)
    assert ttypes._resolve_pad(3, 0, 8) == jtypes._resolve_pad(3, 0, 8)
    with pytest.raises(ValueError):
        ttypes._resolve_pad(9, 0, 8)


def test_zeros_state_matches_jax():
    j = jtypes.StreamState.zeros(5, 33, 4, 3, 2)
    t = ttypes.StreamState.zeros(5, 33, 4, 3, 2, device="cpu")
    _same(j, t)
    assert (t.n_users, t.n_items, t.max_baskets, t.max_basket_size,
            t.max_groups) == (5, 33, 4, 3, 2)


def test_state_round_trip_is_bitwise(rng):
    m, i, n, b, k = 6, 40, 5, 4, 3
    j = jtypes.StreamState(
        user_vecs=jnp.asarray(rng.normal(size=(m, i)), jnp.float32),
        last_group_vecs=jnp.asarray(rng.normal(size=(m, i)), jnp.float32),
        history=jnp.asarray(rng.integers(-1, i, (m, n, b)), jnp.int32),
        group_sizes=jnp.asarray(rng.integers(0, 4, (m, k)), jnp.int32),
        n_baskets=jnp.asarray(rng.integers(0, n, m), jnp.int32),
        n_groups=jnp.asarray(rng.integers(0, k, m), jnp.int32),
        err_mult=jnp.asarray(rng.random(m) + 1, jnp.float32),
        uv_scale=jnp.asarray(rng.random(m), jnp.float32),
        lgv_scale=jnp.asarray(rng.random(m), jnp.float32))
    t = convert.state_from_numpy(convert.state_to_numpy(j), device="cpu")
    _same(j, t)
    back = convert.state_to_numpy(t)
    for name, arr in convert.state_to_numpy(j).items():
        np.testing.assert_array_equal(back[name], arr)
        assert back[name].dtype == arr.dtype
    # materialized accessors agree bitwise (one f32 multiply each)
    np.testing.assert_array_equal(t.materialized_user_vecs().numpy(),
                                  np.asarray(j.materialized_user_vecs()))
    with pytest.raises(KeyError):
        convert.state_from_numpy({"user_vecs": back["user_vecs"]},
                                 device="cpu")


def test_state_from_numpy_defaults_to_cuda():
    """An entry point runs on the card unless the caller asks for the
    CPU: without a card, the default raises instead of moving on."""
    arrays = convert.state_to_numpy(
        ttypes.StreamState.zeros(2, 8, 2, 2, device="cpu"))
    if torch.cuda.is_available():
        assert convert.state_from_numpy(arrays).user_vecs.is_cuda
    else:
        with pytest.raises(RuntimeError):
            convert.state_from_numpy(arrays)


def test_synthetic_generate_matches_jax():
    j = jsynth.generate("tafeng", seed=3, scale=0.01)
    t = tsynth.generate("tafeng", seed=3, scale=0.01)
    assert t.n_items == j.n_items and t.name == j.name
    assert dataclasses.asdict(t.params) == dataclasses.asdict(j.params)
    assert list(t.histories) == list(j.histories)
    for u in j.histories:
        assert len(t.histories[u]) == len(j.histories[u])
        for a, b in zip(t.histories[u], j.histories[u]):
            np.testing.assert_array_equal(a, b)


def test_make_stream_matches_jax():
    ds = jsynth.generate("tafeng", seed=1, scale=0.01)
    kw = dict(deletion_user_rate=0.05, item_deletion_rate=0.02, seed=4)
    j = jstream.make_stream(ds.histories, **kw)
    t = tstream.make_stream(ds.histories, **kw)
    assert len(t) == len(j)
    for a, b in zip(t, j):
        assert (a.kind, a.user, a.pos, a.item, a.seqno) == \
            (b.kind, b.user, b.pos, b.item, b.seqno)
        if b.items is None:
            assert a.items is None
        else:
            np.testing.assert_array_equal(a.items, b.items)


def test_paper_hyperparams_match_jax():
    for name, p in jtypes.PAPER_HYPERPARAMS.items():
        assert dataclasses.asdict(ttypes.PAPER_HYPERPARAMS[name]) == \
            dataclasses.asdict(p)
    assert (ttypes.PAD_ID, ttypes.KIND_NOOP, ttypes.KIND_ADD_BASKET,
            ttypes.KIND_DEL_BASKET, ttypes.KIND_DEL_ITEM) == \
        (jtypes.PAD_ID, jtypes.KIND_NOOP, jtypes.KIND_ADD_BASKET,
         jtypes.KIND_DEL_BASKET, jtypes.KIND_DEL_ITEM)
