"""The port's LM training half against the JAX package.

Attention's gradient: ``ref.flash_attention_bwd_ref`` against
``jax.vjp`` of the JAX oracle (``repro.kernels.ref.flash_attention_ref``,
H == KV) and of the model-level blocked attention
(``repro.models.transformer.flash_attention``, grouped KV heads, windows,
S off every block), in f32 and bf16; ``ops.FlashAttention`` against
``torch.autograd`` through the plain forward.  The CUDA backward (9b)
runs only on the card (``chip_smoke.py`` phase 16 holds it against the
plain version there).  Then ``chunked_softmax_xent``, ``lm_loss`` (the
MTP head included) and its gradients, and 3 whole AdamW train steps, on
the granite, qwen2-moe, deepseek and gemma3 smoke configs, carried
across with ``convert.transformer_params_from_numpy``, against
``jax.value_and_grad`` and the reference's ``make_train_step`` jitted;
the loss falling over 30 steps as ``tests/test_lm_consistency.py``
demands of the JAX model; remat; the config lookup; the parameter and
AdamW-state conversions both ways.

Tolerance (PR 26's bar, ``tests/test_torch_train.py``): losses
``rtol=1e-5, atol=1e-6``, gradients and moments ``rtol=1e-4,
atol=1e-6``, parameters after 3 steps ``rtol=1e-5, atol=1e-5`` (the
steps at ``lr=3e-6``: Adam moves a parameter whose gradient is ~0 by up
to lr_t a step, whichever sign).  Attention's gradients: ``atol=1e-5``
in f32 (the same math, sums in another order); in bf16 two bf16 steps
of the largest gradient (the JAX vjp rounds dP and dS to bf16 where the
port keeps f32).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import command_r_plus_104b as jcmd
from repro.configs import deepseek_v3_671b as jds
from repro.configs import gemma3_27b as jgem
from repro.configs import get_arch
from repro.configs import granite_3_2b as jgranite
from repro.configs import qwen2_moe_a2_7b as jqwen
from repro.kernels import ref as jref
from repro.models import transformer as jtf
from repro.optim import optimizers as jopt
from repro_torch import convert
from repro_torch.checkpoint import flatten
from repro_torch.configs import LM_ARCHS, get_lm
from repro_torch.kernels import flash_attention, ops, ref
from repro_torch.models import transformer as tf
from repro_torch.optim import optimizers

LOSS = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
STEPS = dict(rtol=1e-5, atol=1e-5)
LR = 3e-6
ATTN_ATOL = 1e-5
BF, F32 = torch.bfloat16, torch.float32
SMOKE = {"granite": jgranite, "qwen2_moe": jqwen, "deepseek": jds,
         "gemma3": jgem}



@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The steps here are many small ops: one torch thread a test keeps
    parallel test workers from oversubscribing the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _bf16_atol(want) -> float:
    """Two bf16 steps of the largest value."""
    top = float(np.abs(want).max())
    return 2 * 2.0 ** (np.floor(np.log2(top)) - 7)


def _inputs(rng, b, s, h, kv, d):
    return [rng.normal(size=(b, s, n, d)).astype(np.float32)
            for n in (h, kv, kv, h)]


def _port_grads(q, k, v, do, dtype, causal, window):
    got = ref.flash_attention_bwd_ref(*(_t(x).to(dtype) for x in
                                        (q, k, v, do)),
                                      causal=causal, window=window)
    assert all(g.dtype == dtype for g in got)
    return [g.float().numpy() for g in got]


def _close(got, want, dtype, what):
    for g, w, n in zip(got, want, ("dq", "dk", "dv")):
        w = np.asarray(w, np.float32)
        atol = ATTN_ATOL if dtype == F32 else _bf16_atol(w)
        np.testing.assert_allclose(g, w, atol=atol, err_msg=f"{what} {n}")


@pytest.mark.parametrize("dtype", [F32, BF])
@pytest.mark.parametrize("s,d,window,causal", [
    (16, 8, 0, True), (37, 16, 0, True), (64, 32, 9, True),
    (33, 16, 0, False), (50, 16, 7, False), (1, 8, 0, True)])
def test_bwd_ref_matches_jax_vjp_of_the_oracle(rng, dtype, s, d, window,
                                               causal):
    q, k, v, do = _inputs(rng, 2, s, 3, 3, d)
    jdt = jnp.float32 if dtype == F32 else jnp.bfloat16
    _, vjp = jax.vjp(lambda a, b, c: jref.flash_attention_ref(
        a, b, c, causal=causal, window=window),
        *(jnp.asarray(x, jdt) for x in (q, k, v)))
    want = [_np(g) for g in vjp(jnp.asarray(do, jdt))]
    if dtype == BF:      # the inputs as both packages see them
        q, k, v, do = (_np(jnp.asarray(x, jdt)) for x in (q, k, v, do))
    _close(_port_grads(q, k, v, do, dtype, causal, window), want, dtype,
           (s, d, window, causal))


@pytest.mark.parametrize("dtype", [F32, BF])
@pytest.mark.parametrize("s,h,kv,d,window,q_block", [
    (24, 4, 2, 16, 0, 8), (37, 6, 3, 8, 0, 512), (40, 4, 1, 16, 5, 8),
    (64, 8, 2, 32, 17, 16)])
def test_bwd_ref_matches_jax_vjp_of_gqa_attention(rng, dtype, s, h, kv, d,
                                                  window, q_block):
    """Grouped KV heads, windows and S off the query block: the JAX
    transformer's blocked attention (each block under
    ``jax.checkpoint``), differentiated by ``jax.vjp``."""
    q, k, v, do = _inputs(rng, 2, s, h, kv, d)
    jdt = jnp.float32 if dtype == F32 else jnp.bfloat16
    _, vjp = jax.vjp(lambda a, b, c: jtf.flash_attention(
        a, b, c, 0, jnp.asarray(window or 2 ** 30), 1.0 / d ** 0.5,
        q_block), *(jnp.asarray(x, jdt) for x in (q, k, v)))
    want = [_np(g) for g in vjp(jnp.asarray(do, jdt))]
    if dtype == BF:
        q, k, v, do = (_np(jnp.asarray(x, jdt)) for x in (q, k, v, do))
    _close(_port_grads(q, k, v, do, dtype, True, window), want, dtype,
           (s, h, kv, d, window))


@pytest.mark.parametrize("dtype", [F32, BF])
@pytest.mark.parametrize("s,h,kv,d,window,causal", [
    (21, 4, 2, 16, 0, True), (30, 6, 3, 8, 4, True), (17, 2, 2, 16, 5,
                                                      False)])
def test_flash_function_matches_autograd_of_the_plain_forward(
        rng, dtype, s, h, kv, d, window, causal):
    """``ops.flash_attention`` with inputs that require grad goes through
    ``ops.FlashAttention`` (the plain route on the CPU): its output is
    the plain forward's, bitwise, and its gradients those
    ``torch.autograd`` takes through ``ref.flash_attention_ref``."""
    q, k, v, do = (_t(x).to(dtype) for x in _inputs(rng, 2, s, h, kv, d))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = ops.flash_attention(*leaves, causal=causal, window=window)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    want_out = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert torch.equal(out.detach(), want_out)
    got = torch.autograd.grad(out, leaves, do)
    plain = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(ref.flash_attention_ref(
        *plain, causal=causal, window=window), plain, do)
    _close([g.float().numpy() for g in got],
           [w.float().numpy() for w in want], dtype, (s, h, kv, d))
    # without grad the call takes the forward alone, as serving does
    with torch.no_grad():
        assert ops.flash_attention(*leaves, causal=causal,
                                   window=window).grad_fn is None


def test_flash_function_on_the_kernel_route_never_takes_the_plain_one():
    """``impl="cuda"`` on CPU tensors that require grad: the Function's
    forward calls the kernel wrapper, which raises (no fallback); the
    backward's route is fixed at the forward."""
    q = torch.rand((1, 5, 2, 8), requires_grad=True)
    k, v = torch.rand((1, 5, 1, 8)), torch.rand((1, 5, 1, 8))
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q, k, v, impl="cuda")
    with ops.default_impl("ref"):
        out = ops.flash_attention(q, k, v)
    with ops.default_impl("cuda"):       # ignored: fixed at the forward
        out.sum().backward()
    assert q.grad is not None and bool(torch.isfinite(q.grad).all())


def _xent_inputs(rng, s=16):
    x = rng.normal(size=(2, s, 8)).astype(np.float32)
    unembed = rng.normal(size=(8, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, s))
    labels[0, 3] = labels[1, s - 1] = -1
    labels[1, :4] = -5
    return x, labels, unembed


@pytest.mark.parametrize("chunk", [4, 16, 512])
def test_chunked_softmax_xent_matches_jax(rng, chunk):
    """Value and gradients (x and the unembedding) with masked labels,
    over several chunks and one."""
    x, labels, unembed = _xent_inputs(rng)
    c = tf.TransformerConfig(dtype=F32)
    jc = jtf.TransformerConfig(dtype=jnp.float32)
    want, (gx, gu) = jax.value_and_grad(
        lambda a, b: jtf.chunked_softmax_xent(a, jnp.asarray(labels), b, jc,
                                              chunk=chunk),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(unembed))
    tx, tu = _t(x).requires_grad_(), _t(unembed).requires_grad_()
    got = tf.chunked_softmax_xent(tx, torch.from_numpy(labels), tu, c,
                                  chunk=chunk)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), **LOSS)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), **GRAD)
    np.testing.assert_allclose(tu.grad.numpy(), np.asarray(gu), **GRAD)
    assert not bool(tx.grad[1, :4].any())           # masked positions
    with torch.no_grad():
        assert float(tf.chunked_softmax_xent(
            _t(x), torch.from_numpy(labels), _t(unembed), c,
            chunk=chunk)) == float(got.detach())


def test_chunked_softmax_xent_refuses_a_ragged_chunk(rng):
    """S not a multiple of the chunk: the reference's reshape fails, and
    the port raises."""
    x, labels, unembed = _xent_inputs(rng, s=10)
    with pytest.raises(Exception):
        jtf.chunked_softmax_xent(jnp.asarray(x), jnp.asarray(labels),
                                 jnp.asarray(unembed),
                                 jtf.TransformerConfig(), chunk=4)
    with pytest.raises(ValueError, match="multiple"):
        tf.chunked_softmax_xent(_t(x), torch.from_numpy(labels),
                                _t(unembed), tf.TransformerConfig(),
                                chunk=4)


def _port_config(jc, **kw):
    fields = {f.name for f in dataclasses.fields(tf.TransformerConfig)}
    args = {n: getattr(jc, n) for n in fields if n != "dtype"}
    args.update(kw)
    return tf.TransformerConfig(**args, dtype=F32)


def _setup(name, seed=0, b=2, s=16):
    jc = SMOKE[name].smoke_config()
    jp = jtf.init_params(jc, jax.random.PRNGKey(seed))
    model = convert.transformer_params_from_numpy(
        jax.tree.map(np.asarray, jp), _port_config(jc), device="cpu")
    rng = np.random.default_rng(seed + 1)
    toks = rng.integers(0, jc.vocab_size, (b, s + 1))
    toks[:, 2::2] = toks[:, 1:-1:2]
    labels = toks[:, 1:].copy()
    labels[0, 5] = -1                                # a masked label
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(labels)}
    jb = {k: jnp.asarray(v.numpy(), jnp.int32) for k, v in batch.items()}
    return jc, jp, model, batch, jb


def _grad_tree(model):
    return convert._lm_tree(
        model, lambda p: torch.zeros_like(p) if p.grad is None else p.grad)


@pytest.mark.parametrize("name", list(SMOKE))
def test_lm_loss_and_gradients_match_jax(name):
    jc, jp, model, batch, jb = _setup(name)
    c = model.config
    want, grads = jax.jit(jax.value_and_grad(
        lambda p: jtf.lm_loss(p, jb, jc)))(jp)
    value = tf.lm_loss(model, batch, c)
    value.backward()
    assert value.dim() == 0 and bool(torch.isfinite(value))
    np.testing.assert_allclose(float(value.detach()), float(want), **LOSS)
    got, exp = flatten(_grad_tree(model)), jax.tree.leaves(grads)
    assert len(got) == len(exp)
    for g, e in zip(got, exp):
        assert tuple(g.shape) == e.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(e), **GRAD)
    # every layer's attention weights carry a gradient
    for i, layer in enumerate(model.layers):
        for w in (("wq_a", "wkv_a", "wo") if c.mla else ("wq", "wk", "wv",
                                                         "wo")):
            assert bool(getattr(layer, w).grad.any()), (i, w)
    if c.mtp:
        assert bool(model.mtp_proj.grad.any()) and \
            bool(model.mtp_ln.grad.any())


@pytest.mark.parametrize("name", list(SMOKE))
def test_three_train_steps_match_jax(name):
    """Losses, parameters and AdamW's state after 3 whole train steps
    (the port's in place, the reference's jitted)."""
    jc, jp, model, batch, jb = _setup(name, seed=2)
    c = model.config
    opt = optimizers.adamw(model.parameters(), lr=LR, warmup_steps=1)
    jo = jopt.adamw(lr=LR, warmup_steps=1)
    step = tf.make_train_step(c, opt)
    jstep = jax.jit(jtf.make_train_step(jc, jo))
    js = jo.init(jp)
    for _ in range(3):
        got = step(model, batch)
        jp, js, want = jstep(jp, js, jb)
        assert not got["loss"].requires_grad
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                                   **LOSS)
    back = convert.transformer_params_to_numpy(model)
    for g, e in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_allclose(g, np.asarray(e), **STEPS)
    state = convert.opt_state_to_numpy(opt, model)
    assert int(state.step) == int(js.step) == 3
    for k in ("m", "v"):
        for g, e in zip(jax.tree.leaves(state.inner[k]),
                        jax.tree.leaves(js.inner[k])):
            np.testing.assert_allclose(g, np.asarray(e), **GRAD)


def test_loss_decreases_with_training():
    """``tests/test_lm_consistency.py``'s run on the port: 30 steps of
    AdamW on a copy-structured batch take the loss below 0.8 of its
    start."""
    jc = jtf.TransformerConfig(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab_size=97, q_block=4, dtype=jnp.float32)
    model = convert.transformer_params_from_numpy(
        jax.tree.map(np.asarray, jtf.init_params(jc, jax.random.PRNGKey(0))),
        _port_config(jc), device="cpu")
    opt = optimizers.adamw(model.parameters(), lr=3e-3, warmup_steps=2,
                           total_steps=40)
    step = tf.make_train_step(model.config, opt)
    toks = np.random.default_rng(0).integers(0, jc.vocab_size, (4, 17))
    toks[:, 1::2] = toks[:, 0:-1:2]
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:])}
    losses = [float(step(model, batch)["loss"]) for _ in range(30)]
    assert losses[-1] < losses[0] * 0.8, losses[::6]


@pytest.mark.parametrize("name", ["granite", "deepseek"])
def test_remat_recomputes_the_same_gradients(name):
    """Per-layer remat (``torch.utils.checkpoint``) gives the gradients
    of the run that keeps every activation, bitwise, under policy
    "full" and under "dots" (``tests/test_torch_remat_dots.py`` holds
    "dots" to the JAX model's); another policy raises."""
    _, _, model, batch, _ = _setup(name)
    grads = []
    for remat, policy in ((True, "full"), (False, "full"), (True, "dots")):
        model.config = dataclasses.replace(model.config, remat=remat,
                                           remat_policy=policy)
        model.zero_grad(set_to_none=True)
        tf.lm_loss(model, batch, model.config).backward()
        grads.append([p.grad.clone() for p in model.parameters()])
    for other in grads[1:]:
        assert all(torch.equal(a, b) for a, b in zip(grads[0], other))
    model.config = dataclasses.replace(model.config, remat=True,
                                       remat_policy="offload")
    with pytest.raises(ValueError, match="offload"):
        tf.lm_loss(model, batch, model.config)
    with torch.no_grad():           # no backward: nothing to rematerialize
        model(batch["tokens"])


def test_serving_entry_points_record_no_graph():
    """Trainable weights, yet prefill and decode answer without an
    autograd graph (their in-place cache writes need none)."""
    _, _, model, batch, _ = _setup("deepseek")
    assert all(p.requires_grad for p in model.parameters())
    logits, caches = model.prefill(batch["tokens"][:, :8], max_len=12)
    step, caches = model.decode_step(caches, batch["tokens"][:, 8:9], 8)
    assert logits.grad_fn is None and step.grad_fn is None
    assert not any(t.requires_grad for pair in caches.values()
                   for t in pair)


@pytest.mark.parametrize("name", sorted(LM_ARCHS))
def test_lm_lookup_is_the_jax_registry(name):
    """``get_lm`` gives each LM arch's published and smoke configs, field
    for field the JAX package's (its registry's ``make_smoke``)."""
    make, smoke = get_lm(name)
    jmod = {"granite-3-2b": jgranite, "qwen2-moe-a2.7b": jqwen,
            "deepseek-v3-671b": jds, "gemma3-27b": jgem,
            "command-r-plus-104b": jcmd}[name]
    for mine, theirs in ((make(), jmod.make_config()),
                         (smoke(), get_arch(name).make_smoke())):
        for f in dataclasses.fields(mine):
            if f.name != "dtype":
                assert getattr(mine, f.name) == getattr(theirs, f.name), \
                    (name, f.name)
    with pytest.raises(KeyError, match="known"):
        get_lm("lm100m")


def test_parameters_and_adamw_state_convert_both_ways():
    """``transformer_params_to_numpy`` inverts ``..._from_numpy`` leaf
    for leaf (MLA, both layer groups, the MTP head); a bf16 model's
    leaves come back widened exactly; AdamW's state after a JAX step
    installs in the port and reads back equal, leaves in the
    reference's order."""
    jc = jds.smoke_config()
    jp = jtf.init_params(jc, jax.random.PRNGKey(3))
    tree = jax.tree.map(np.asarray, jp)
    model = convert.transformer_params_from_numpy(tree, _port_config(jc),
                                                  device="cpu")
    back = convert.transformer_params_to_numpy(model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    assert all(np.array_equal(a, b) for a, b in
               zip(jax.tree.leaves(back), jax.tree.leaves(tree)))
    host = convert.transformer_params_tree(model)
    assert [tuple(x.shape) for x in flatten(host)] == \
        [x.shape for x in jax.tree.leaves(tree)]
    bf = convert.transformer_params_from_numpy(
        tree, dataclasses.replace(model.config, dtype=BF), device="cpu")
    for a, b in zip(jax.tree.leaves(convert.transformer_params_to_numpy(bf)),
                    jax.tree.leaves(tree)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(
            a, np.asarray(jnp.asarray(b, jnp.bfloat16), np.float32))
    jo = jopt.adamw()
    grads = jax.tree.map(lambda p: jnp.full_like(p, 0.5), jp)
    _, js = jax.jit(jo.update)(grads, jo.init(jp), jp)
    opt = optimizers.adamw(model.parameters())
    convert.opt_state_from_numpy(opt, model, jax.tree.map(np.asarray, js))
    assert opt.n_steps == 1
    state = convert.opt_state_to_numpy(opt, model)
    for k in ("m", "v"):
        got, exp = jax.tree.leaves(state.inner[k]), \
            jax.tree.leaves(js.inner[k])
        assert len(got) == len(exp)
        assert all(np.array_equal(a, np.asarray(b)) for a, b in
                   zip(got, exp))
    assert [np.asarray(x).shape for x in flatten(state)] == \
        [x.shape for x in jax.tree.leaves(js)]
