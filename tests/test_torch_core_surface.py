"""The port's small core modules against the JAX package's.

``core.stability``'s four functions on a grid of k, r_g and targets
(the budget exact; the multipliers alpha^n for n < 40 within
``rtol = 40 · 2^-23``: JAX's ``jnp.power`` takes alpha rounded to
float32, whose relative error of up to 2^-24 grows n-fold in alpha^n,
and the port's tensor form is float32 too while its numpy form is
float64), ``BasketDataset.train_test_split``
equal to JAX's on one seeded dataset, ``UpdateBatch.noop`` and
``RaggedUserState.empty`` field for field, and ``repro_torch.core``'s
public names equal to ``repro.core``'s but ``RefEngine`` (which stays a
numpy oracle of the JAX package).
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro.core import stability as jstab
from repro.core import types as jt
from repro.data import synthetic as jsynth
from repro_torch.core import stability as tstab
from repro_torch.core import types as tt
from repro_torch.data import synthetic as tsynth

F32_EPS = float(np.finfo(np.float32).eps)
F64_EPS = float(np.finfo(np.float64).eps)
N_GROWTH = 40
GROWTH_RTOL = N_GROWTH * 2.0 ** -23
GRID = [(k, r_g) for k in (2, 3, 5, 10, 50) for r_g in (0.5, 0.7, 0.9, 1.0)]


@pytest.mark.parametrize("eps", [F32_EPS, F64_EPS])
@pytest.mark.parametrize("target", [1e-4, 1e-2, 0.5])
@pytest.mark.parametrize("k,r_g", GRID)
def test_deletion_budget_matches_jax(k, r_g, target, eps):
    got = tstab.deletion_budget(k, r_g, target, eps)
    assert got == jstab.deletion_budget(k, r_g, target, eps)
    assert isinstance(got, int)


@pytest.mark.parametrize("k,r_g", GRID)
def test_max_error_growth_matches_jax(k, r_g):
    n = np.arange(0, N_GROWTH)
    exp = np.asarray(jstab.max_error_growth(n, k, r_g))
    got_t = tstab.max_error_growth(torch.from_numpy(n), k, r_g)
    assert got_t.dtype == torch.float32
    np.testing.assert_allclose(got_t.numpy(), exp, rtol=GROWTH_RTOL)
    got_np = tstab.max_error_growth(n, k, r_g)
    assert got_np.dtype == np.float64
    np.testing.assert_allclose(got_np, exp, rtol=GROWTH_RTOL)


@pytest.mark.parametrize("target", [1e-4, 1e-2, 0.5])
def test_users_needing_refresh_matches_jax(target):
    em = np.geomspace(1.0, 1e8, 97).astype(np.float32)
    em = np.concatenate([em, [target / F32_EPS, np.nextafter(
        np.float32(target / F32_EPS), np.float32(np.inf))]]).astype(
        np.float32)
    exp = np.asarray(jstab.users_needing_refresh(em, target))
    got = tstab.users_needing_refresh(torch.from_numpy(em), target)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), exp)
    np.testing.assert_array_equal(tstab.users_needing_refresh(em, target),
                                  exp)
    assert 0 < exp.sum() < exp.size
    assert tstab.refresh_threshold(target) == jstab.refresh_threshold(target)


def test_train_test_split_matches_jax():
    jds = jsynth.generate("tafeng", scale=0.02, seed=0)
    tds = tsynth.generate("tafeng", scale=0.02, seed=0)
    jtrain, jtest = jds.train_test_split()
    ttrain, ttest = tds.train_test_split()
    assert list(ttrain) == list(jtrain) and list(ttest) == list(jtest)
    for u in jtrain:
        assert len(ttrain[u]) == len(jtrain[u])
        for a, b in zip(ttrain[u], jtrain[u]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ttest[u], jtest[u])


def test_train_test_split_skips_short_histories():
    ds = tsynth.BasketDataset(
        name="t", n_items=9, params=tt.TifuParams(n_items=9),
        histories={0: [np.array([1])], 1: [np.array([2]), np.array([3, 4])],
                   2: []})
    train, test = ds.train_test_split()
    assert list(train) == [1] and list(test) == [1]
    assert [b.tolist() for b in train[1]] == [[2]]
    assert test[1].tolist() == [3, 4]


def test_update_batch_noop_field_for_field():
    exp = jt.UpdateBatch.noop(8, 5)
    got = tt.UpdateBatch.noop(8, 5, device="cpu")
    assert got.size == exp.size == 8
    for f in dataclasses.fields(jt.UpdateBatch):
        a, b = getattr(got, f.name), np.asarray(getattr(exp, f.name))
        assert a.dtype == torch.int32 and a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), b, err_msg=f.name)
    assert [f.name for f in dataclasses.fields(tt.UpdateBatch)] == \
        [f.name for f in dataclasses.fields(jt.UpdateBatch)]


def test_update_batch_noop_defaults_to_cuda():
    if torch.cuda.is_available():
        assert tt.UpdateBatch.noop(2, 3).kind.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tt.UpdateBatch.noop(2, 3)


def test_ragged_user_state_empty_field_for_field():
    exp = jt.RaggedUserState.empty(11)
    got = tt.RaggedUserState.empty(11)
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(exp)]
    for f in dataclasses.fields(exp):
        a, b = getattr(got, f.name), getattr(exp, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype == np.float64
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b
    assert (got.n_baskets, got.n_groups) == (exp.n_baskets, exp.n_groups)
    st = tt.RaggedUserState.empty(3)
    st.history.append(np.array([0, 2]))
    st.group_sizes.append(1)
    assert (st.n_baskets, st.n_groups) == (1, 1)


def test_core_exports_the_jax_names_but_the_oracle_engine():
    assert tcore.__all__ == [n for n in jcore.__all__ if n != "RefEngine"]
    for name in tcore.__all__:
        assert hasattr(tcore, name), name
    assert not hasattr(tcore, "RefEngine")
    for name in ("PAD_ID", "KIND_NOOP", "KIND_ADD_BASKET", "KIND_DEL_BASKET",
                 "KIND_DEL_ITEM", "SCALE_CEIL", "SCALE_FLOOR"):
        assert getattr(tcore, name) == getattr(jcore, name), name
    assert set(tcore.PAPER_HYPERPARAMS) == set(jcore.PAPER_HYPERPARAMS)
    for name, p in jcore.PAPER_HYPERPARAMS.items():
        assert dataclasses.asdict(tcore.PAPER_HYPERPARAMS[name]) == \
            dataclasses.asdict(p)
