"""The port's embedding substrate and model building blocks against the
JAX package.

``repro_torch.models.embedding`` (``TableSpec``, lookups, bags, the
Eq. 3/4 bag maintenance) and ``repro_torch.models.common`` (the MLP,
layer norm, the cross-entropy, batch chunking) are held against
``repro.models.embedding`` / ``repro.models.common`` on the same
numpy-seeded inputs, the JAX tables and weights carried across as numpy.

Tolerance: gathers are exact; every float result ``rtol=1e-5,
atol=1e-6`` (fp32, the same math with sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import decay as jdecay
from repro.models import common as jcommon
from repro.models import embedding as jemb
from repro_torch.core import decay
from repro_torch.models import common, embedding

TOL = dict(rtol=1e-5, atol=1e-6)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _table(spec, seed=0):
    return np.asarray(jemb.init_table(jax.random.PRNGKey(seed), spec))


@pytest.mark.parametrize("vocabs,dim", [((50, 30), 8), ((1,), 4),
                                        ((1000, 24, 7), 16),
                                        ((1023, 1), 2)])
def test_table_spec_matches_jax(vocabs, dim):
    ours, theirs = embedding.TableSpec(vocabs, dim), jemb.TableSpec(vocabs,
                                                                   dim)
    np.testing.assert_array_equal(ours.offsets, theirs.offsets)
    assert ours.total_rows == theirs.total_rows
    for mult in (1, 512, 1024):
        assert ours.padded_rows(mult) == theirs.padded_rows(mult)


def test_init_table_and_mlp_shapes():
    spec = embedding.TableSpec((1000, 24), 16)
    gen = torch.Generator().manual_seed(0)
    t = embedding.init_table(gen, spec)
    assert t.shape == (1024, 16) and t.dtype == torch.float32
    assert abs(float(t.std()) - 0.25) < 0.01            # N(0, 1/dim)
    again = embedding.init_table(torch.Generator().manual_seed(0), spec)
    assert torch.equal(t, again)
    mlp = common.init_mlp(gen, [12, 8, 3], device="cpu")
    assert [tuple(w.shape) for w in mlp.w] == [(12, 8), (8, 3)]
    assert all(not b.any() for b in mlp.b)
    assert common.mlp_shapes([12, 8, 3]) == jcommon.mlp_shapes([12, 8, 3])
    assert common.mlp_shapes([5, 2], bias=False) == \
        jcommon.mlp_shapes([5, 2], bias=False)


@pytest.mark.parametrize("chunk", [None, 16, 7, 96, 65536])
def test_embedding_lookup_matches_jax(rng, chunk):
    """Chunked (chunks that divide the batch, a ragged last chunk) and
    direct lookups give the reference's rows exactly."""
    spec = jemb.TableSpec((100, 40, 3), dim=4)
    table = _table(spec, 1)
    ids = rng.integers(0, [100, 40, 3], (96, 3)).astype(np.int32)
    exp = np.asarray(jemb.embedding_lookup(jnp.asarray(table),
                                           jnp.asarray(ids), spec,
                                           chunk=chunk))
    got = embedding.embedding_lookup(_t(table), _t(ids),
                                     embedding.TableSpec(spec.vocab_sizes, 4),
                                     chunk=chunk)
    np.testing.assert_array_equal(got.numpy(), exp)


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_matches_jax(rng, mode, weighted):
    spec = jemb.TableSpec((50, 30), dim=8)
    table = _table(spec)
    ids = rng.integers(-1, 30, (6, 2, 5)).astype(np.int32)
    ids[0, 0] = -1                                     # an empty bag
    w = rng.random((6, 2, 5)).astype(np.float32) if weighted else None
    exp = np.asarray(jemb.embedding_bag(
        jnp.asarray(table), jnp.asarray(ids), spec,
        weights=None if w is None else jnp.asarray(w), mode=mode))
    got = embedding.embedding_bag(
        _t(table), _t(ids), embedding.TableSpec((50, 30), 8),
        weights=None if w is None else _t(w), mode=mode)
    np.testing.assert_allclose(got.numpy(), exp, **TOL)
    assert not got[0, 0].any()


def test_bag_maintenance_matches_jax(rng):
    """Eq. 3 and Eq. 4 on a bag of interaction embeddings, against the
    reference's rules and the from-scratch decayed average."""
    vecs = rng.normal(size=(10, 6)).astype(np.float32)
    r = 0.9
    avg9 = decay.decayed_average(_t(vecs[:9]), r)
    np.testing.assert_allclose(
        avg9.numpy(), jdecay.decayed_average(vecs[:9], r, xp=np), **TOL)
    incr = embedding.bag_incremental_add(avg9, 9, _t(vecs[9]), r)
    np.testing.assert_allclose(
        incr.numpy(), np.asarray(jemb.bag_incremental_add(
            jnp.asarray(avg9.numpy()), 9, jnp.asarray(vecs[9]), r)), **TOL)
    np.testing.assert_allclose(incr.numpy(),
                               jdecay.decayed_average(vecs, r, xp=np),
                               rtol=1e-5, atol=1e-6)
    avg10 = decay.decayed_average(_t(vecs), r)
    for i in (1, 3, 10):
        got = embedding.bag_decremental_delete(avg10, 10, _t(vecs[i - 1:]),
                                               i, r)
        exp = np.asarray(jemb.bag_decremental_delete(
            jnp.asarray(avg10.numpy()), 10, jnp.asarray(vecs[i - 1:]), i, r))
        np.testing.assert_allclose(got.numpy(), exp, **TOL)
        np.testing.assert_allclose(
            got.numpy(), jdecay.decayed_average(np.delete(vecs, i - 1, 0), r,
                                                xp=np), rtol=1e-4, atol=1e-5)
    assert not embedding.bag_decremental_delete(avg10[None], 1,
                                                _t(vecs[:1]), 1, r).any()
    np.testing.assert_allclose(decay.suffix_coefficients(10, 4, r).numpy(),
                               jdecay.suffix_coefficients(10, 4, r), **TOL)
    np.testing.assert_allclose(
        decay.inplace_update(avg10, 10, _t(vecs[3]), _t(vecs[0]), 4,
                             r).numpy(),
        jdecay.inplace_update(avg10.numpy(), 10, vecs[3], vecs[0], 4, r),
        **TOL)


@pytest.mark.parametrize("final", [None, "sigmoid"])
def test_mlp_matches_jax(rng, final):
    layers = jcommon.init_mlp(jax.random.PRNGKey(3), [12, 32, 16, 3])
    mlp = common.MLP([12, 32, 16, 3], device="cpu")
    with torch.no_grad():                 # the weights are trainable
        for i, layer in enumerate(layers):
            mlp.w[i].copy_(_t(layer["w"]))
            mlp.b[i].copy_(_t(layer["b"]) + 0.1 * i)
            layer["b"] = layer["b"] + 0.1 * i
    x = rng.normal(size=(9, 12)).astype(np.float32)
    exp = jcommon.apply_mlp(layers, jnp.asarray(x),
                            final_act=None if final is None
                            else jax.nn.sigmoid)
    got = common.apply_mlp(mlp, _t(x), final_act=None if final is None
                           else torch.sigmoid)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(exp), **TOL)


def test_layer_norm_uses_the_population_variance(rng):
    x = rng.normal(size=(4, 5, 7)).astype(np.float32) * 3 + 1
    w = rng.normal(size=(7,)).astype(np.float32)
    b = rng.normal(size=(7,)).astype(np.float32)
    exp = np.asarray(jcommon.layer_norm(jnp.asarray(x), jnp.asarray(w),
                                        jnp.asarray(b)))
    got = common.layer_norm(_t(x), _t(w), _t(b))
    np.testing.assert_allclose(got.numpy(), exp, **TOL)
    # the unbiased variance (torch.var's default) would differ by
    # sqrt(7/6) in the normalised values
    xt = _t(x)
    unbiased = (xt - xt.mean(-1, keepdim=True)) * torch.rsqrt(
        torch.var(xt, dim=-1, keepdim=True) + 1e-6) * _t(w) + _t(b)
    assert not np.allclose(unbiased.numpy(), exp, rtol=1e-3, atol=1e-3)


def test_bce_with_logits_matches_jax(rng):
    z = (rng.normal(size=(64,)) * 30).astype(np.float32)
    y = (rng.random(64) > 0.5).astype(np.float32)
    exp = float(jcommon.bce_with_logits(jnp.asarray(z), jnp.asarray(y)))
    got = float(common.bce_with_logits(_t(z), _t(y)))
    np.testing.assert_allclose(got, exp, **TOL)


@pytest.mark.parametrize("b,chunk", [(24, 8), (24, 7), (6, 8), (24, 24)])
def test_map_batch_chunks_matches_jax(rng, b, chunk):
    """Chunks that divide the batch run chunk by chunk; others and small
    batches in one call; a tuple output is joined per leaf; entries not
    in ``keys`` go whole to every call."""
    x = rng.normal(size=(b, 5)).astype(np.float32)
    s = rng.normal(size=(5,)).astype(np.float32)
    calls = []

    def ours(batch):
        calls.append(batch["x"].shape[0])
        return batch["x"] @ batch["s"], batch["x"] * 2

    def theirs(batch):
        return batch["x"] @ batch["s"], batch["x"] * 2
    got = common.map_batch_chunks(ours, {"x": _t(x), "s": _t(s)}, chunk,
                                  keys=["x"])
    exp = jcommon.map_batch_chunks(theirs, {"x": jnp.asarray(x),
                                            "s": jnp.asarray(s)}, chunk,
                                   keys=["x"])
    for g, e in zip(got, exp):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), **TOL)
    split = b > chunk and b % chunk == 0
    assert calls == ([chunk] * (b // chunk) if split else [b])


def test_out_of_range_ids_raise(rng):
    """A CUDA gather would fault where ``jnp.take`` does not: the port
    raises on a global row outside [0, total_rows); −1 stays a bag's
    padding."""
    spec = embedding.TableSpec((10, 5), 4)
    table = torch.zeros((spec.padded_rows(), 4))
    ok = torch.tensor([[9, 4], [0, 0]])
    embedding.embedding_lookup(table, ok, spec)
    for bad in ([[9, 5]], [[-1, 0]], [[0, 1 << 40]]):
        with pytest.raises(embedding.InvalidIdError):
            embedding.embedding_lookup(table, torch.tensor(bad), spec)
    with pytest.raises(embedding.InvalidIdError):
        embedding.embedding_lookup(table, torch.tensor([[9, 5]] * 40), spec,
                                   chunk=16)
    bag = torch.tensor([[[-1, 3, -1], [4, -1, -1]]])
    assert embedding.embedding_bag(table, bag, spec).shape == (1, 2, 4)
    for bad in ([[[-2, 3, 1], [4, 0, 0]]], [[[1, 3, 1], [4, 5, 0]]]):
        with pytest.raises(embedding.InvalidIdError):
            embedding.embedding_bag(table, torch.tensor(bad), spec)
    assert issubclass(embedding.InvalidIdError, ValueError)
