"""The port's MoE and MLA transformer against the JAX package.

The routed experts (``route``, ``dispatch_slots``, ``_moe_local``,
``moe_block``), multi-head latent attention (prefill through the padded-V
route, the absorbed decode) and whole models (the four LM configs'
``smoke_config()`` and ``tests/test_lm_consistency.py``'s MLA and MoE
cases, carried across by ``convert.transformer_params_from_numpy``) run
on the same seeded numpy inputs through ``repro.models.transformer``
(JAX on the CPU) and ``repro_torch.models.transformer``.  The configs,
parameter shapes and counts are held field for field.  The attention
kernel runs only on the card (``chip_smoke.py`` phase 15); here
``ops.flash_attention`` takes its plain version.

Tolerance ``atol=1e-4`` in f32, as ``tests/test_torch_transformer.py``:
the same math with sums in another order.  Expert choices, drops and
slots are compared exactly, on inputs whose top-k margin (the k-th
routing probability over the next) is asserted above 1e-5, so that a
rounding difference cannot flip a choice and a wrong choice cannot hide.
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import command_r_plus_104b as jcmd
from repro.configs import deepseek_v3_671b as jds
from repro.configs import gemma3_27b as jgem
from repro.configs import granite_3_2b as jgranite
from repro.configs import lm_shapes as jshapes
from repro.configs import qwen2_moe_a2_7b as jqwen
from repro.models import transformer as jtf
from repro_torch import convert
from repro_torch.configs import (command_r_plus_104b, deepseek_v3_671b,
                                 gemma3_27b, granite_3_2b, lm_shapes,
                                 qwen2_moe_a2_7b)
from repro_torch.kernels import ops, ref
from repro_torch.models import transformer as tf

ATOL = 1e-4
MARGIN = 1e-5
CONFIGS = {"qwen2_moe": (qwen2_moe_a2_7b, jqwen),
           "deepseek_v3": (deepseek_v3_671b, jds),
           "gemma3": (gemma3_27b, jgem),
           "command_r_plus": (command_r_plus_104b, jcmd),
           "granite": (granite_3_2b, jgranite)}


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _port_config(jc):
    """The port's config with the JAX config's fields, in f32."""
    fields = {f.name for f in dataclasses.fields(tf.TransformerConfig)}
    kw = {n: getattr(jc, n) for n in fields if n != "dtype"}
    return tf.TransformerConfig(**kw, dtype=torch.float32)


def _moe_cfg(**kw):
    base = dict(n_layers=1, d_model=32, n_heads=2, n_kv_heads=2, d_head=16,
                d_ff=64, vocab_size=64, moe=True, n_experts=8, top_k=2,
                moe_d_ff=16, dtype=jnp.float32)
    base.update(kw)
    return jtf.TransformerConfig(**base)


def _moe_layer(rng, jc, n_local, router_scale=0.5):
    d, f = jc.d_model, jc.moe_d_ff
    layer = {"router": rng.normal(size=(d, jc.n_experts)) * router_scale,
             "we_gate": rng.normal(size=(n_local, d, f)) * 0.2,
             "we_up": rng.normal(size=(n_local, d, f)) * 0.2,
             "we_down": rng.normal(size=(n_local, f, d)) * 0.2}
    if jc.n_shared_experts:
        fs = f * jc.n_shared_experts
        layer.update(ws_gate=rng.normal(size=(d, fs)) * 0.2,
                     ws_up=rng.normal(size=(d, fs)) * 0.2,
                     ws_down=rng.normal(size=(fs, d)) * 0.2)
    return {k: v.astype(np.float32) for k, v in layer.items()}


def _both(layer):
    """The layer for JAX (a dict of arrays) and for the port (attribute
    access, as its modules give)."""
    return ({k: jnp.asarray(v) for k, v in layer.items()},
            SimpleNamespace(**{k: _t(v) for k, v in layer.items()}))


def _jax_route(xf, router, k):
    probs = jax.nn.softmax(jnp.asarray(xf) @ jnp.asarray(router), axis=-1)
    gates, experts = jax.lax.top_k(probs, k)
    return np.asarray(probs), np.asarray(gates), np.asarray(experts)


def _jax_slots(experts, n_local, offset, capacity):
    """JAX's ``_moe_local`` dispatch (its one-hot cumsum), in numpy."""
    flat_e = experts.reshape(-1)
    local = (flat_e >= offset) & (flat_e < offset + n_local)
    le = np.where(local, flat_e - offset, n_local)
    onehot = np.eye(n_local + 1, dtype=np.int64)[le]
    pos = (np.cumsum(onehot, axis=0) * onehot).sum(-1) - 1
    keep = local & (pos < capacity)
    return keep, np.where(keep, le * capacity + pos, n_local * capacity)


def _min_margin(probs, k):
    top = -np.sort(-np.asarray(probs, np.float64), axis=-1)
    return float((top[:, k - 1] - top[:, k]).min())


@pytest.mark.parametrize("case,kw,t,n_local,offset", [
    # capacity 8 against ~16 assignments an expert: many drops
    ("drops", dict(capacity_factor=0.5), 64, 8, 0),
    # 6 routed experts stored as 8, top-3
    ("padded_experts", dict(n_experts=6, n_experts_padded=8, top_k=3,
                            capacity_factor=0.75), 48, 8, 0),
    # the expert-parallel shard body's call: 4 local experts from 2
    ("local_slice", dict(capacity_factor=1.0), 40, 4, 2),
    # no drop at all
    ("roomy", dict(capacity_factor=4.0), 32, 8, 0),
])
def test_moe_local_matches_jax(case, kw, t, n_local, offset):
    rng = np.random.default_rng(11)
    jc = _moe_cfg(**kw)
    c = _port_config(jc)
    xf = rng.normal(size=(t, jc.d_model)).astype(np.float32)
    layer = _moe_layer(rng, jc, n_local)
    probs, gates, experts = _jax_route(xf, layer["router"], jc.top_k)
    assert _min_margin(probs, jc.top_k) > MARGIN, case
    cap = jtf._capacity(t, jc, 1)
    assert tf._capacity(t, c) == cap

    # the choices and gates
    g, e = tf.route(_t(xf), _t(layer["router"]), c)
    assert np.array_equal(e.numpy(), experts)
    np.testing.assert_allclose(g.numpy(), gates / gates.sum(-1, keepdims=True),
                               atol=1e-6)
    # the drops and slots, exactly
    keep, slot = tf.dispatch_slots(e, n_local, offset, cap)
    jkeep, jslot = _jax_slots(experts, n_local, offset, cap)
    assert np.array_equal(keep.numpy(), jkeep)
    assert np.array_equal(slot.numpy(), jslot)
    n_local_assign = int(((experts >= offset)
                          & (experts < offset + n_local)).sum())
    dropped = n_local_assign - int(jkeep.sum())
    assert (dropped > 0) == (case in ("drops", "padded_experts",
                                      "local_slice")), (case, dropped)

    jl, tl = _both(layer)
    exp = jtf._moe_local(jnp.asarray(xf), jl, jc, n_local, offset, cap)
    got = tf._moe_local(_t(xf), tl, c, n_local, offset, cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=ATOL)


def test_router_ties_go_to_the_lowest_index():
    """Router columns that repeat give logits that tie exactly (integer
    tokens, dyadic weights: every product and sum exact); both packages
    take the lowest-index experts of a tie, as ``lax.top_k`` does."""
    rng = np.random.default_rng(12)
    jc = _moe_cfg(n_experts=6, top_k=2, capacity_factor=2.0)
    c = _port_config(jc)
    xf = rng.integers(-2, 3, size=(40, jc.d_model)).astype(np.float32)
    cols = rng.integers(-4, 5, size=(jc.d_model, 3)).astype(np.float32) / 8
    layer = _moe_layer(rng, jc, jc.n_experts)
    # experts 1, 2 and 3 tie; 0 and 5 tie; 4 stands alone
    layer["router"] = cols[:, [0, 1, 1, 1, 2, 0]]
    logits = xf @ layer["router"]
    assert np.array_equal(logits[:, 1], logits[:, 3])
    _, _, experts = _jax_route(xf, layer["router"], jc.top_k)
    want = np.argsort(-logits, axis=-1, kind="stable")[:, :jc.top_k]
    assert np.array_equal(experts, want)
    _, e = tf.route(_t(xf), _t(layer["router"]), c)
    assert np.array_equal(e.numpy(), want)
    # a tie of three at the top takes 1 and 2, of two at the top 0 and 5
    top = logits.max(-1)
    assert ((logits[:, 1] == top) & (logits[:, 0] < top)).any()
    assert ((logits[:, 0] == top) & (logits[:, 1] < top)).any()
    jl, tl = _both(layer)
    cap = jtf._capacity(40, jc, 1)
    exp = jtf._moe_local(jnp.asarray(xf), jl, jc, jc.n_experts, 0, cap)
    got = tf._moe_local(_t(xf), tl, c, jc.n_experts, 0, cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=ATOL)


@pytest.mark.parametrize("b,s,kw", [
    (2, 12, dict(n_shared_experts=2, capacity_factor=1.25)),
    (3, 8, dict(n_shared_experts=1, n_experts=6, n_experts_padded=8,
                capacity_factor=0.5)),
    # a decode step's 4 tokens: capacity max(8, min(0, 4)) = 8 slots
    (4, 1, dict(n_shared_experts=4, n_experts=60, n_experts_padded=64,
                top_k=4)),
])
def test_moe_block_matches_jax(b, s, kw):
    rng = np.random.default_rng(13)
    jc = _moe_cfg(**kw)
    c = _port_config(jc)
    x = rng.normal(size=(b, s, jc.d_model)).astype(np.float32)
    layer = _moe_layer(rng, jc, jc.e_pad)
    probs, _, _ = _jax_route(x.reshape(b * s, -1), layer["router"],
                             jc.top_k)
    assert _min_margin(probs, jc.top_k) > MARGIN
    jl, tl = _both(layer)
    exp = jtf.moe_block(jnp.asarray(x), jl, jc, None, None)
    got = tf.moe_block(_t(x), tl, c)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=ATOL)


@pytest.mark.parametrize("tokens", [1, 4, 37, 16384])
@pytest.mark.parametrize("name", ["qwen2_moe", "deepseek_v3"])
def test_capacity_matches_jax(name, tokens):
    port, jax_mod = CONFIGS[name]
    for mine, theirs in ((port.make_config(), jax_mod.make_config()),
                         (port.smoke_config(), jax_mod.smoke_config())):
        assert tf._capacity(tokens, mine) == \
            jtf._capacity(tokens, theirs, 1)
    assert tf._capacity(4, qwen2_moe_a2_7b.make_config()) == 8


MLA_CASE = jtf.TransformerConfig(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
    d_ff=128, vocab_size=97, q_block=4, mla=True, q_lora_rank=32,
    kv_lora_rank=16, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
    dtype=jnp.float32)


def _mla_layer(seed=3):
    params = jtf.init_params(MLA_CASE, jax.random.PRNGKey(seed))
    layer = {k: np.asarray(v[0]) for k, v in params["dense_layers"].items()}
    rng = np.random.default_rng(seed)
    # norms away from one, so a swapped or missing norm shows
    for name in ("q_ln", "kv_ln"):
        layer[name] = (1 + 0.5 * rng.normal(size=layer[name].shape)
                       ).astype(np.float32)
    for name in ("wq_a", "wq_b", "wkv_a", "wkv_b", "wo"):
        layer[name] = layer[name] * 10   # 0.2·N(0, 1): outputs far over atol
    return layer


def test_attention_mla_prefill_and_absorbed_decode_match_jax():
    jc, c = MLA_CASE, _port_config(MLA_CASE)
    jl, tl = _both(_mla_layer())
    rng = np.random.default_rng(4)
    b, s, max_len = 2, 8, 12
    x = rng.normal(size=(b, max_len, jc.d_model)).astype(np.float32)
    full = jnp.int32(tf.FULL)
    pos = np.broadcast_to(np.arange(s), (b, s))
    # without a cache (the full forward)
    exp, _ = jtf.attention_mla(jnp.asarray(x[:, :s]), jl, jc,
                               jnp.asarray(pos), full)
    got, none = tf.attention_mla(_t(x[:, :s]), tl, c, torch.from_numpy(
        pos.copy()), tf.FULL)
    assert none is None
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=ATOL)
    # prefill into the latent and rotary caches
    jcache = (jnp.zeros((b, max_len, jc.kv_lora_rank), jnp.bfloat16),
              jnp.zeros((b, max_len, jc.qk_rope_dim), jnp.bfloat16))
    exp, jcache = jtf.attention_mla(jnp.asarray(x[:, :s]), jl, jc,
                                    jnp.asarray(pos), full, jcache, 0)
    tcache = tuple(torch.zeros(t.shape, dtype=torch.bfloat16)
                   for t in jcache)
    got, tcache = tf.attention_mla(_t(x[:, :s]), tl, c,
                                   torch.from_numpy(pos.copy()), tf.FULL,
                                   tcache, 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=ATOL)
    for jt, tt in zip(jcache, tcache):
        assert tt.dtype == torch.bfloat16
        np.testing.assert_allclose(tt.float().numpy(),
                                   np.asarray(jt, np.float32), atol=1e-2)
    # absorbed decode steps, each from the same (JAX's) caches
    for t in range(s, max_len):
        for jt, tt in zip(jcache, tcache):
            tt.copy_(torch.from_numpy(np.asarray(jt, np.float32)))
        p1 = np.full((b, 1), t)
        exp, jcache = jtf.attention_mla(jnp.asarray(x[:, t:t + 1]), jl, jc,
                                        jnp.asarray(p1), full, jcache, t)
        got, tcache = tf.attention_mla(_t(x[:, t:t + 1]), tl, c,
                                       torch.from_numpy(p1), tf.FULL,
                                       tcache, t)
        np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=ATOL)
        for jt, tt in zip(jcache, tcache):
            np.testing.assert_allclose(tt.float().numpy(),
                                       np.asarray(jt, np.float32), atol=1e-2)


def test_mla_expansion_is_jax_prefill_attention():
    """``mla_qkv`` (what chip_smoke checks the kernel on) gives the Q, K
    and V whose unpadded attention is the JAX prefill's."""
    jc, c = MLA_CASE, _port_config(MLA_CASE)
    layer = _mla_layer(5)
    _, tl = _both(layer)
    x = np.random.default_rng(6).normal(size=(2, 8, 64)).astype(np.float32)
    pos = torch.arange(8).expand(2, 8)
    q, k, v = tf.mla_qkv(_t(x), tl, c, pos)
    assert q.shape == k.shape == (2, 8, 4, 24) and v.shape == (2, 8, 4, 16)
    out = ref.flash_attention_ref(q, k, v).reshape(2, 8, 64) @ tl.wo
    exp, _ = tf.attention_mla(_t(x), tl, c, pos, tf.FULL)
    np.testing.assert_allclose(out.numpy(), exp.numpy(), atol=ATOL)


@pytest.mark.parametrize("win", [0, 5])
@pytest.mark.parametrize("dq,dv,kv", [(24, 16, 4), (192, 128, 2),
                                      (32, 32, 1)])
def test_padded_v_route_is_the_unpadded_attention(rng, dq, dv, kv, win):
    """V zero-padded to Q's width through ``ops.flash_attention``, the
    first Dv columns kept: the same as attention over the unpadded V,
    scale 1/√Dq (JAX's lowering, and the plain version at V's width)."""
    b, s, h = 2, 40, 4
    q, k = (rng.normal(size=(b, s, n, dq)).astype(np.float32)
            for n in (h, kv))
    v = rng.normal(size=(b, s, kv, dv)).astype(np.float32)
    got = tf.attend_padded_v(_t(q), _t(k), _t(v), window=win)
    assert got.shape == (b, s, h, dv)
    exp = jtf.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              0, jnp.asarray(win or tf.FULL),
                              1.0 / np.sqrt(dq), 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=ATOL)
    plain = ref.flash_attention_ref(_t(q), _t(k), _t(v), window=win)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=ATOL)
    with pytest.raises(ValueError, match="exceeds"):
        tf.attend_padded_v(_t(q)[..., :8], _t(k)[..., :8], _t(v))
    if dv < dq:
        # the dispatcher itself takes V as wide as Q only, on every path
        with pytest.raises(ValueError, match="V width"):
            ops.flash_attention(_t(q), _t(k), _t(v))


def test_plain_attention_scores_in_query_chunks(rng, monkeypatch):
    """The plain version's query-row chunks (its scores budget) change
    nothing but the intermediate's size."""
    q, k, v = (_t(rng.normal(size=(2, 50, n, 16))) for n in (4, 2, 2))
    whole = ref.flash_attention_ref(q, k, v, window=7)
    monkeypatch.setattr(ref, "SCORES_BUDGET", 4 * 50 * 7)   # 7 rows
    np.testing.assert_allclose(ref.flash_attention_ref(q, k, v, window=7),
                               whole, atol=1e-6)


MODEL_CASES = {
    "qwen2_moe_smoke": jqwen.smoke_config(),
    "deepseek_smoke": jds.smoke_config(),
    "gemma3_smoke": jgem.smoke_config(),
    "command_r_smoke": jcmd.smoke_config(),
    "mla_absorbed": MLA_CASE,
    "moe_shared_mtp": jtf.TransformerConfig(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
        d_ff=128, vocab_size=97, q_block=4, moe=True, n_experts=8,
        n_shared_experts=1, top_k=2, moe_d_ff=32, first_dense_layers=1,
        mtp=True, capacity_factor=2.0, dtype=jnp.float32),
}


def _models(name, seed=1):
    jc = MODEL_CASES[name]
    params = jtf.init_params(jc, jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, params)
    model = convert.transformer_params_from_numpy(tree, _port_config(jc),
                                                  device="cpu")
    # serving checks: the trainable weights are frozen, so the full
    # forward builds no autograd graph
    model.requires_grad_(False)
    return jc, params, model


@pytest.mark.parametrize("name", list(MODEL_CASES))
def test_forward_prefill_decode_match_jax(name):
    jc, params, model = _models(name)
    toks = np.random.default_rng(3).integers(0, jc.vocab_size, (2, 12))
    unembed = np.asarray(jtf._unembed(params, jc))
    x, _ = jtf.forward(params, jnp.asarray(toks), jc)
    xt, _ = model(torch.from_numpy(toks))
    np.testing.assert_allclose((xt @ model.unembedding()).numpy(),
                               np.asarray(x) @ unembed, atol=ATOL)
    lg, caches = jtf.prefill(params, jnp.asarray(toks[:, :8]), jc,
                             max_len=16)
    lt, tcaches = model.prefill(torch.from_numpy(toks[:, :8]), max_len=16)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lg), atol=ATOL)
    assert set(tcaches) == set(caches)
    for group in caches:
        for kc, tc in zip(caches[group], tcaches[group]):
            assert tc.dtype == torch.bfloat16 and \
                tuple(tc.shape) == kc.shape
            np.testing.assert_allclose(tc.float().numpy(),
                                       np.asarray(kc, np.float32), atol=1e-2)
    for t in range(8, 12):
        lg, caches = jtf.decode_step(params, caches,
                                     jnp.asarray(toks[:, t:t + 1]), t, jc)
        lt, tcaches = model.decode_step(tcaches,
                                        torch.from_numpy(toks[:, t:t + 1]), t)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lg), atol=ATOL)


def _consistency_errs(forward, prefill, decode, toks):
    """Max |logit| gap of the prefill's last position and of 4 decode
    steps against the teacher-forced full forward's."""
    full = forward(toks)
    lg, caches = prefill(toks[:, :8])
    errs = [float(np.abs(lg - full[:, 7]).max())]
    for t in range(8, 12):
        lg, caches = decode(caches, toks[:, t:t + 1], t)
        errs.append(float(np.abs(lg - full[:, t]).max()))
    return np.array(errs)


@pytest.mark.parametrize("name", list(MODEL_CASES))
def test_prefill_decode_vs_full_forward(name):
    """Prefill + decode against the teacher-forced full forward: each gap
    the JAX model's own on the same tokens, and below 2e-3 where
    ``test_lm_consistency.py`` demands it of the JAX model.  (Capacity
    drops differ between a 24-token forward and a 16-token prefill, so
    qwen2-moe's smoke model has a 3.9e-3 gap in both packages.)"""
    jc, params, model = _models(name, seed=2)
    toks = torch.randint(0, jc.vocab_size, (2, 12),
                         generator=torch.Generator().manual_seed(0)).numpy()
    unembed = jtf._unembed(params, jc)

    def jdecode(caches, tok, t):
        lg, caches = jtf.decode_step(params, caches, jnp.asarray(tok), t, jc)
        return np.asarray(lg), caches
    want = _consistency_errs(
        lambda tk: np.asarray(jtf.forward(params, jnp.asarray(tk), jc)[0]
                              @ unembed),
        lambda tk: (lambda r: (np.asarray(r[0]), r[1]))(
            jtf.prefill(params, jnp.asarray(tk), jc, max_len=16)),
        jdecode, toks)

    def decode(caches, tok, t):
        lg, caches = model.decode_step(caches, torch.from_numpy(tok), t)
        return lg.numpy(), caches
    got = _consistency_errs(
        lambda tk: (model(torch.from_numpy(tk))[0]
                    @ model.unembedding()).numpy(),
        lambda tk: (lambda r: (r[0].numpy(), r[1]))(
            model.prefill(torch.from_numpy(tk), max_len=16)),
        decode, toks)
    np.testing.assert_allclose(got, want, atol=ATOL)
    if name in ("mla_absorbed", "moe_shared_mtp"):
        assert got.max() < 2e-3, got


@pytest.mark.parametrize("name", list(CONFIGS))
def test_configs_are_the_jax_ones(name):
    port, jax_mod = CONFIGS[name]
    for mine, theirs in ((port.make_config(), jax_mod.make_config()),
                         (port.smoke_config(), jax_mod.smoke_config())):
        for f in dataclasses.fields(mine):
            if f.name != "dtype":
                assert getattr(mine, f.name) == getattr(theirs, f.name), f
        assert str(mine.dtype).split(".")[-1] == jnp.dtype(theirs.dtype).name
        for prop in ("e_pad", "qk_dim", "v_dim"):
            assert getattr(mine, prop) == getattr(theirs, prop), prop


def test_lm_shapes_are_the_jax_ones():
    for name in ("TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K"):
        assert getattr(lm_shapes, name) == getattr(jshapes, name), name


def _counted_configs():
    for name, (port, jax_mod) in CONFIGS.items():
        yield name, port.make_config(), jax_mod.make_config()
        yield name + "_smoke", port.smoke_config(), jax_mod.smoke_config()
    for name, jc in MODEL_CASES.items():
        yield name, _port_config(jc), jc


@pytest.mark.parametrize("name,mine,theirs", list(_counted_configs()),
                         ids=lambda x: x if isinstance(x, str) else "")
def test_param_shapes_and_counts_match_jax(name, mine, theirs):
    assert tf.param_shapes(mine) == jtf.param_shapes(theirs)
    assert mine.n_params() == theirs.n_params()
    assert mine.n_active_params() == theirs.n_active_params()
    for batch, max_len in ((3, 20),):
        want = jtf.cache_shapes(theirs, batch, max_len)
        got = tf.cache_shapes(mine, batch, max_len)
        assert set(got) == set(want)
        for group in want:
            assert list(got[group]) == [sd.shape for sd in want[group]]


def test_stored_parameters_of_the_served_cuts():
    """The depth cuts phase 15 of chip_smoke.py serves, counted from the
    shapes: every stored leaf (norms, routers, pad experts and the MTP
    head included)."""
    def stored(c):
        return sum(int(np.prod(s)) for g in tf.param_shapes(c).values()
                   for s in (g.values() if isinstance(g, dict) else [g]))
    qwen = qwen2_moe_a2_7b.make_config()
    ds = dataclasses.replace(deepseek_v3_671b.make_config(), n_layers=2,
                             first_dense_layers=1)
    gem = dataclasses.replace(gemma3_27b.make_config(), n_layers=6)
    cmd = dataclasses.replace(command_r_plus_104b.make_config(), n_layers=2)
    assert tf.layer_groups(ds) == (1, 1)
    assert tf._layer_windows(gem, 6, 0) == [1024] * 5 + [tf.FULL]
    got = [stored(c) / 1e9 for c in (qwen, ds, gem, cmd)]
    np.testing.assert_allclose(got, [14.83, 14.05, 3.89, 6.29], atol=0.01)


def test_init_params_norms_experts_and_caches():
    c = deepseek_v3_671b.smoke_config()
    model = tf.init_params(c, torch.Generator().manual_seed(0), device="cpu")
    names = dict(model.named_parameters())
    for name, p in names.items():
        leaf = name.split(".")[-1]
        assert p.dtype == c.dtype and p.requires_grad
        if leaf in ("ln1", "ln2", "q_ln", "kv_ln", "final_ln", "mtp_ln"):
            assert torch.all(p == 1), name
        else:
            assert 0.01 < float(p.std()) < 0.03, name
    # the dense group first, then the MoE layers
    assert [layer.ffn_dense for layer in model.layers] == [True, False, False]
    assert tuple(names["layers.1.we_gate"].shape) == (8, 64, 32)
    assert tuple(names["mtp_proj"].shape) == (128, 64)
    # each expert drawn on its own: experts differ
    we = names["layers.1.we_gate"]
    assert not torch.equal(we[0], we[1])
    caches = tf.init_caches(c, 3, 20, device="cpu")
    want = jtf.cache_shapes(jds.smoke_config(), 3, 20)
    for group in ("dense", "moe"):
        for got, exp in zip(caches[group], want[group]):
            assert tuple(got.shape) == exp.shape
            assert got.dtype == torch.bfloat16


def test_convert_names_a_wrong_leaf():
    jc = MODEL_CASES["deepseek_smoke"]
    tree = jax.tree.map(np.asarray, jtf.init_params(jc, jax.random.PRNGKey(0)))
    c = _port_config(jc)
    bad = dict(tree, moe_layers=dict(tree["moe_layers"]))
    bad["moe_layers"]["we_up"] = bad["moe_layers"]["we_up"][:, :4]
    with pytest.raises(ValueError, match="moe_layers.we_up"):
        convert.transformer_params_from_numpy(bad, c, device="cpu")
    bad = dict(tree, mtp_proj=tree["mtp_proj"][:3])
    with pytest.raises(ValueError, match="mtp_proj"):
        convert.transformer_params_from_numpy(bad, c, device="cpu")
    bad = {k: v for k, v in tree.items() if k != "unembed"}
    with pytest.raises(KeyError, match="unembed"):
        convert.transformer_params_from_numpy(bad, c, device="cpu")


@pytest.mark.parametrize("name", ["qwen2_moe", "deepseek_v3"])
def test_moe_mla_model_defaults_to_cuda(name):
    """An MoE or MLA model runs on the card unless the caller asks for
    the CPU; without a card it raises rather than carrying on there."""
    c = CONFIGS[name][0].smoke_config()
    if torch.cuda.is_available():
        assert tf.Transformer(c).device.type == "cuda"
        return
    for make in (lambda: tf.Transformer(c),
                 lambda: tf.init_params(c, torch.Generator()),
                 lambda: tf.init_caches(c, 1, 8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert tf.Transformer(c, device="cpu").device.type == "cpu"
