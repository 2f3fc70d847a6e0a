"""The port's attention and dense LM transformer against the JAX package.

``ref.flash_attention_ref`` (what ``ops.flash_attention`` runs on CPU
tensors) is held against the JAX Pallas kernel in interpret mode, as the
JAX package's own tests call it, and, for grouped-query heads, against
the JAX transformer's own attention lowering.  The dense model
(``models.transformer``) takes the JAX parameter tree through
``convert.transformer_params_from_numpy`` and is held against JAX's
``forward``, ``prefill`` and ``decode_step`` on the same tokens.  The
CUDA kernel runs only on the card (``chip_smoke.py``).

Tolerance ``atol=1e-4`` in f32: the same math with sums in another
order.  Both packages keep bf16 KV caches, so decode steps read the same
rounded keys and values.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import granite_3_2b as jgranite
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro.models import transformer as jtf
from repro_torch import convert
from repro_torch.configs import granite_3_2b
from repro_torch.kernels import ops, ref
from repro_torch.models import transformer as tf


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _qkv(rng, b, s, h, kv, d):
    return [rng.normal(size=(b, s, n, d)).astype(np.float32)
            for n in (h, kv, kv)]


@pytest.mark.parametrize("b,s,h,d,win,bq,bk", [
    (2, 256, 2, 64, 0, 64, 64),
    (1, 128, 4, 32, 32, 64, 32),
    (2, 256, 2, 64, 64, 128, 64),
    (1, 512, 1, 128, 0, 128, 128),
])
def test_flash_attention_ref_matches_jax(rng, b, s, h, d, win, bq, bk):
    q, k, v = _qkv(rng, b, s, h, h, d)
    got = ref.flash_attention_ref(_t(q), _t(k), _t(v), causal=True,
                                  window=win)
    exp = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                 window=win, bq=bq, bk=bk, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=1e-4)
    assert torch.equal(ops.flash_attention(_t(q), _t(k), _t(v), window=win),
                       got)


@pytest.mark.parametrize("s,h,kv,win", [(64, 8, 2, 0), (48, 4, 1, 16),
                                        (40, 6, 3, 0)])
def test_flash_attention_gqa_matches_jax_lowering(rng, s, h, kv, win):
    """K/V with fewer heads than Q: each query head reads its group's KV
    head, as the JAX transformer's ``flash_attention`` does."""
    q, k, v = _qkv(rng, 2, s, h, kv, 16)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=True, window=win)
    exp = jtf.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              0, jnp.asarray(win or tf.FULL), 0.25, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=1e-4)
    # the same as repeating each KV head over its group of query heads
    rep = [np.repeat(x, h // kv, axis=2) for x in (k, v)]
    exp2 = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(rep[0]),
                                    jnp.asarray(rep[1]), causal=True,
                                    window=win)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp2), atol=1e-4)


def test_flash_attention_ref_scale_and_no_causal(rng):
    q, k, v = _qkv(rng, 1, 32, 2, 2, 8)
    for causal in (True, False):
        got = ref.flash_attention_ref(_t(q), _t(k), _t(v), causal=causal,
                                      scale=0.5)
        exp = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), causal=causal,
                                       scale=0.5)
        np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=1e-4)


def _port_config(jc):
    """The port's config with the JAX config's dense-path fields."""
    fields = {f.name for f in dataclasses.fields(tf.TransformerConfig)}
    kw = {n: getattr(jc, n) for n in fields if n != "dtype"}
    return tf.TransformerConfig(**kw, dtype=torch.float32)


CASES = {
    "granite_smoke": jgranite.smoke_config(),
    "dense_gqa": jtf.TransformerConfig(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab_size=97, q_block=4, dtype=jnp.float32),
    "sliding_5to1": jtf.TransformerConfig(
        n_layers=6, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
        d_ff=128, vocab_size=97, q_block=4, sliding_window=4,
        global_every=6, dtype=jnp.float32),
}


def _models(name, seed=1):
    jc = CASES[name]
    params = jtf.init_params(jc, jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, params)
    model = convert.transformer_params_from_numpy(tree, _port_config(jc),
                                                  device="cpu")
    return jc, params, model


@pytest.mark.parametrize("name", list(CASES))
def test_forward_prefill_decode_match_jax(name):
    jc, params, model = _models(name)
    toks = np.random.default_rng(3).integers(0, jc.vocab_size, (2, 12))
    unembed = np.asarray(jtf._unembed(params, jc))
    x, _ = jtf.forward(params, jnp.asarray(toks), jc)
    xt, _ = model(_t(toks))
    np.testing.assert_allclose((xt @ model.unembedding()).numpy(),
                               np.asarray(x) @ unembed, atol=1e-4)
    lg, caches = jtf.prefill(params, jnp.asarray(toks[:, :8]), jc,
                             max_len=16)
    lt, tcaches = model.prefill(_t(toks[:, :8]), max_len=16)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lg), atol=1e-4)
    for kc, tc in zip(caches["dense"], tcaches["dense"]):
        assert tc.dtype == torch.bfloat16 and tuple(tc.shape) == kc.shape
        np.testing.assert_allclose(tc.float().numpy(),
                                   np.asarray(kc, np.float32), atol=1e-2)
    for t in range(8, 12):
        lg, caches = jtf.decode_step(params, caches,
                                     jnp.asarray(toks[:, t:t + 1]), t, jc)
        lt, tcaches = model.decode_step(tcaches, _t(toks[:, t:t + 1]), t)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lg), atol=1e-4)


@pytest.mark.parametrize("name", list(CASES))
def test_prefill_decode_vs_full_forward(name):
    """Prefill + decode agree with the teacher-forced full forward, as
    ``test_lm_consistency.py`` demands of the JAX model."""
    _, _, model = _models(name, seed=2)
    c = model.config
    toks = torch.randint(0, c.vocab_size, (2, 12),
                         generator=torch.Generator().manual_seed(0))
    x, _ = model(toks)
    full = (x @ model.unembedding()).float()
    lg, caches = model.prefill(toks[:, :8], max_len=16)
    errs = [float((lg - full[:, 7]).abs().max())]
    for t in range(8, 12):
        lg, caches = model.decode_step(caches, toks[:, t:t + 1], t)
        errs.append(float((lg - full[:, t]).abs().max()))
    assert max(errs) < 2e-3, errs


def test_granite_config_is_the_jax_one():
    for mine, theirs in ((granite_3_2b.make_config(),
                          jgranite.make_config()),
                         (granite_3_2b.smoke_config(),
                          jgranite.smoke_config())):
        for f in dataclasses.fields(mine):
            if f.name != "dtype":
                assert getattr(mine, f.name) == getattr(theirs, f.name), f
        assert str(mine.dtype).split(".")[-1] == jnp.dtype(theirs.dtype).name
    full = granite_3_2b.make_config()
    # JAX's count, which leaves out the norm weights (two per layer, one
    # final): the model stores that many more
    norms = full.d_model * (2 * full.n_layers + 1)
    assert full.n_params() == jgranite.make_config().n_params()
    assert 2.4e9 < full.n_params() < 2.6e9
    stored = sum(math.prod(s) for s in tf.param_shapes(full)["dense_layers"]
                 .values()) + full.vocab_size * full.d_model + full.d_model
    assert stored == full.n_params() + norms


def test_init_params_and_cache_shapes():
    c = granite_3_2b.smoke_config()
    model = tf.init_params(c, torch.Generator().manual_seed(0), device="cpu")
    shapes = tf.param_shapes(c)
    assert tuple(model.embed.shape) == shapes["embed"]
    for name, shape in shapes["dense_layers"].items():
        for layer in model.layers:
            w = getattr(layer, name)
            assert tuple(w.shape) == shape[1:] and w.dtype == c.dtype
            if name.startswith("ln"):
                assert torch.all(w == 1)
            else:
                assert 0.01 < float(w.std()) < 0.03
    assert not any(p.requires_grad for p in model.parameters())
    caches = tf.init_caches(c, 3, 20, device="cpu")
    want = jtf.cache_shapes(jgranite.smoke_config(), 3, 20)["dense"]
    for got, exp in zip(caches["dense"], want):
        assert tuple(got.shape) == exp.shape and got.dtype == torch.bfloat16
