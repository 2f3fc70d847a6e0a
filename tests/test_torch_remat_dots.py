"""The "dots" remat policy against the JAX model's.

``remat_policy="dots"`` checkpoints each layer with
``torch.utils.checkpoint`` and a selective-checkpoint policy that saves
the outputs of the un-batched products, as
``jax.checkpoint_policies.dots_with_no_batch_dims_saveable`` does.

* The smoke LMs' loss and gradients under "dots" against the JAX model
  under "dots" at the bars of ``tests/test_torch_lm_train.py`` (loss
  ``rtol=1e-5, atol=1e-6``, gradients ``rtol=1e-4, atol=1e-6``), and bit
  for bit the port's "full".
* What the policy saves per layer against what
  ``jax.ad_checkpoint``'s saved residuals list for the JAX layer under
  the same policy, for a dense config (granite) and an MLA + MoE one
  (deepseek: the latent expansions reach the policy as einsum's
  ``bmm`` of batch 1, the experts' products as ``bmm`` of batch e).
  Each saved product is compared by its (rows, columns): rows the
  layer's B·S tokens, columns its output width.  The JAX list is the
  saveable products its backward reads (it keeps ``silu``'s output in
  place of the gate product's, of the same shape); the port's also
  holds the two products whose outputs only the residual sum reads
  (the dense FFN's and the shared experts' down projections), which
  torch's replay of the forward would otherwise recompute.
* No un-batched forward product is recomputed in the backward: the
  ``mm`` and batch-1 ``bmm`` calls the backward makes under "dots" are
  those it makes without remat (the gradients' own), while the batched
  ones (attention's heads, the experts) are recomputed.
"""
import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.ad_checkpoint import saved_residuals
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import deepseek_v3_671b as jds
from repro.configs import gemma3_27b as jgem
from repro.configs import granite_3_2b as jgranite
from repro.configs import qwen2_moe_a2_7b as jqwen
from repro.models import transformer as jtf
from repro_torch import convert
from repro_torch.checkpoint import flatten
from repro_torch.models import transformer as tf

LOSS = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
SMOKE = {"granite": jgranite, "qwen2_moe": jqwen, "deepseek": jds,
         "gemma3": jgem}
B, S = 2, 16
MM, BMM = torch.ops.aten.mm.default, torch.ops.aten.bmm.default


@pytest.fixture(autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _setup(name, seed=0):
    jc = dataclasses.replace(SMOKE[name].smoke_config(), remat=True,
                             remat_policy="dots")
    jp = jtf.init_params(jc, jax.random.PRNGKey(seed))
    fields = {f.name for f in dataclasses.fields(tf.TransformerConfig)}
    c = tf.TransformerConfig(**{n: getattr(jc, n) for n in fields
                                if n != "dtype"}, dtype=torch.float32)
    model = convert.transformer_params_from_numpy(
        jax.tree.map(np.asarray, jp), c, device="cpu")
    rng = np.random.default_rng(seed + 1)
    toks = rng.integers(0, jc.vocab_size, (B, S + 1))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:].copy())}
    jb = {k: jnp.asarray(v.numpy(), jnp.int32) for k, v in batch.items()}
    return jc, jp, model, batch, jb


def _grads(model, batch, policy):
    model.config = dataclasses.replace(model.config, remat=policy != "none",
                                       remat_policy=policy if policy
                                       != "none" else "full")
    model.zero_grad(set_to_none=True)
    loss = tf.lm_loss(model, batch, model.config)
    loss.backward()
    return float(loss.detach()), [p.grad.clone() for p in
                                  model.parameters()]


@pytest.mark.parametrize("name", list(SMOKE))
def test_dots_matches_jax_dots_and_the_port_s_full(name):
    jc, jp, model, batch, jb = _setup(name)
    want, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jtf.lm_loss(p, jb, jc)))(jp)
    value, grads = _grads(model, batch, "dots")
    np.testing.assert_allclose(value, float(want), **LOSS)
    got = flatten(convert._lm_tree(model, lambda p: p.grad))
    exp = jax.tree.leaves(jgrads)
    assert len(got) == len(exp)
    for g, e in zip(got, exp):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), **GRAD)
    full_value, full = _grads(model, batch, "full")
    assert full_value == value
    assert all(torch.equal(a, b) for a, b in zip(grads, full))


# ---------------------------------------------------------------------------
# what is saved
# ---------------------------------------------------------------------------

def _jax_layer_saved(jc, jp, group):
    """(rows, columns) of each product output JAX saves for one layer of
    ``group`` under "dots" (the saved residuals that are outputs)."""
    layer = jax.tree.map(lambda a: a[0], jp[group])
    attn = jtf.attention_mla if jc.mla else jtf.attention_dense
    dense = group == "dense_layers"
    pos = jnp.broadcast_to(jnp.arange(S), (B, S))

    def body(h, layer):
        # the scanned layer of the reference's _scan_layers, one mesh-less
        # step of it
        a, _ = attn(jtf.rms_norm(h, layer["ln1"], jc.norm_eps), layer, jc,
                    pos, jnp.int32(2 ** 30))
        h = h + a
        x = jtf.rms_norm(h, layer["ln2"], jc.norm_eps)
        return h + (jtf.ffn_dense(x, layer) if dense
                    else jtf.moe_block(x, layer, jc, None, None))

    fn = jax.checkpoint(
        body, policy=jax.checkpoint_policies.dots_with_no_batch_dims_saveable)
    h = jnp.ones((B, S, jc.d_model), jc.dtype)
    out = []
    for aval, desc in saved_residuals(fn, h, layer):
        if desc.startswith("output of"):
            n = int(np.prod(aval.shape))
            out.append((B * S, n // (B * S)))
    return collections.Counter(out)


class _Recorder:
    """Wraps the policy: (rows, columns) of each product it saves in
    the forward, by checkpointed layer."""

    def __init__(self, policy):
        self.policy, self.layers = policy, []

    def __call__(self, ctx, op, *args, **kwargs):
        decision = self.policy(ctx, op, *args, **kwargs)
        if decision == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE \
                and not ctx.is_recompute:
            a, b = args[0].shape, args[1].shape
            self.layers[-1].append((a[-2], b[-1]))
        return decision


@pytest.mark.parametrize("name", ["granite", "deepseek"])
def test_saved_products_are_jax_s_per_layer(name, monkeypatch):
    jc, jp, model, batch, _ = _setup(name)
    rec = _Recorder(tf._dots_policy)
    monkeypatch.setattr(tf, "_dots_policy", rec)
    layer_fn = tf._layer_output

    def counted(*args, **kwargs):
        # the forward's calls open a layer; the backward's recomputations
        # (after all of them) record nothing
        if len(rec.layers) < len(model.layers):
            rec.layers.append([])
        return layer_fn(*args, **kwargs)
    monkeypatch.setattr(tf, "_layer_output", counted)
    _grads(model, batch, "dots")
    c = model.config
    assert len(rec.layers) == c.n_layers
    n_dense, _ = tf.layer_groups(c)
    for i, saved in enumerate(rec.layers):
        dense = i < n_dense
        group = "dense_layers" if dense else "moe_layers"
        want = _jax_layer_saved(jc, jp, group)
        # the products only the residual sum reads: the dense FFN's down
        # projection, or the shared experts'
        extra = collections.Counter({(B * S, c.d_model): 1}) \
            if dense or c.n_shared_experts else collections.Counter()
        assert collections.Counter(saved) == want + extra, (name, i)
        assert all(rows == B * S for rows, _ in saved)
    if c.mla:   # the latent expansions, einsum's bmm of batch 1
        h = c.n_heads
        assert (B * S, h * c.qk_nope_dim) in rec.layers[0]
        assert (B * S, h * c.v_dim) in rec.layers[0]


class _Products(TorchDispatchMode):
    """Counts the products dispatched: (op, batch, rows, columns)."""

    def __init__(self):
        super().__init__()
        self.seen = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is MM:
            self.seen[("mm", 1, args[0].shape[0], args[1].shape[1])] += 1
        elif func is BMM:
            self.seen[("bmm", args[0].shape[0], args[0].shape[1],
                       args[1].shape[2])] += 1
        return func(*args, **(kwargs or {}))


def _backward_products(model, batch, policy):
    model.config = dataclasses.replace(model.config, remat=policy != "none",
                                       remat_policy=policy if policy
                                       != "none" else "full")
    model.zero_grad(set_to_none=True)
    loss = tf.lm_loss(model, batch, model.config)
    with _Products() as seen:
        loss.backward()
    return seen.seen


@pytest.mark.parametrize("name", ["granite", "deepseek", "qwen2_moe"])
def test_no_unbatched_product_is_recomputed(name):
    _, _, model, batch, _ = _setup(name)
    plain = _backward_products(model, batch, "none")
    dots = _backward_products(model, batch, "dots")
    full = _backward_products(model, batch, "full")
    recomputed = dots - plain
    assert not plain - dots
    assert all(op == "bmm" and batch_ > 1
               for op, batch_, _, _ in recomputed), recomputed
    assert recomputed, "attention's batched products are recomputed"
    unbatched = [k for k in full - plain if k[0] == "mm" or k[1] == 1]
    assert unbatched, "under full the layer's products are recomputed"
