"""The port's recommender training against the JAX package.

Two-tower (in-batch sampled softmax), DLRM and DeepFM (binary
cross-entropy) and BERT4Rec (the full cloze loss and the sampled one)
at each config's ``smoke_config()``: the JAX package's parameters are
carried across with ``convert.recsys_params_from_numpy``, the batches
come from the port's seeded makers with ``train=True`` and go to both
packages.  Held: each loss and every leaf's gradient against
``jax.value_and_grad``; the losses, parameters and AdamW state after 3
whole train steps against the reference's ``make_train_step`` jitted;
the train batch makers; gradients through ``embedding_lookup``'s
chunked path; and the serving entry points, which build no autograd
graph.

Tolerance: losses ``rtol=1e-5, atol=1e-6``; gradients and optimizer
moments ``rtol=1e-4, atol=1e-6``; parameters after 3 steps ``rtol=1e-5,
atol=1e-5``.  Adam divides by √v, so a gradient near 0 whose sign
differs between the packages moves a parameter by up to ``lr_t`` a
step: the steps run at ``lr=3e-6`` so that 3·lr_t stays below that
atol.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import bert4rec_cfg as jbert_cfg
from repro.configs import deepfm_cfg as jdeepfm_cfg
from repro.configs import dlrm_mlperf as jdlrm_cfg
from repro.configs import two_tower_retrieval as jtt_cfg
from repro.models import bert4rec as jbert
from repro.models import deepfm as jdeepfm
from repro.models import dlrm as jdlrm
from repro.models import embedding as jemb
from repro.models import two_tower as jtt
from repro.optim import optimizers as jopt
from repro_torch import convert
from repro_torch.configs import (bert4rec_cfg, deepfm_cfg, dimenet_cfg,
                                 dlrm_mlperf, recsys_shapes,
                                 two_tower_retrieval)
from repro_torch.models import (bert4rec, deepfm, dimenet, dlrm, embedding,
                                two_tower)
from repro_torch.optim import optimizers

LOSS = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
STEPS = dict(rtol=1e-5, atol=1e-5)
LR = 3e-6          # 3·lr_t = 9e-6 <= STEPS' atol

# case: (arch, port module, port config, JAX module, JAX config, batch
# maker, port loss, JAX loss, make_train_step kwargs)
CASES = {
    "two_tower": ("two_tower", two_tower, two_tower_retrieval, jtt, jtt_cfg,
                  recsys_shapes.two_tower_batch,
                  two_tower.sampled_softmax_loss, jtt.sampled_softmax_loss,
                  {}),
    "dlrm": ("dlrm", dlrm, dlrm_mlperf, jdlrm, jdlrm_cfg,
             recsys_shapes.dlrm_batch, dlrm.loss_fn, jdlrm.loss_fn, {}),
    "deepfm": ("deepfm", deepfm, deepfm_cfg, jdeepfm, jdeepfm_cfg,
               recsys_shapes.deepfm_batch, deepfm.loss_fn, jdeepfm.loss_fn,
               {}),
    "bert4rec_cloze": ("bert4rec", bert4rec, bert4rec_cfg, jbert, jbert_cfg,
                       recsys_shapes.bert4rec_batch, bert4rec.cloze_loss,
                       jbert.cloze_loss, {"sampled": False}),
    "bert4rec_sampled": ("bert4rec", bert4rec, bert4rec_cfg, jbert,
                         jbert_cfg, recsys_shapes.bert4rec_batch,
                         bert4rec.sampled_cloze_loss,
                         jbert.sampled_cloze_loss, {"sampled": True}),
}


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _jax(batch):
    return {k: jnp.asarray(v.numpy().astype(np.int32)
                           if v.dtype == torch.int64 else v.numpy())
            for k, v in batch.items()}


def _setup(case, seed=0, n=24):
    arch, mod, cfg, jmod, jcfg, make, loss, jloss, kw = CASES[case]
    c, jc = cfg.smoke_config(), jcfg.smoke_config()
    jp = jmod.init_params(jc, jax.random.PRNGKey(seed))
    model = convert.recsys_params_from_numpy(
        arch, jax.tree.map(np.asarray, jp), c, device="cpu")
    if arch == "bert4rec":
        batch = make(c, n, _gen(seed + 1), train=True, n_masked=4,
                     n_negatives=64)
        if not kw["sampled"]:
            batch = {"ids": batch["ids"],
                     "targets": recsys_shapes.cloze_targets(batch,
                                                            c.seq_len)}
    else:
        batch = make(c, n, _gen(seed + 1), train=True)
    return c, jc, jp, model, batch


def _grad(p):
    return np.zeros(p.shape, np.float32) if p.grad is None \
        else p.grad.numpy()


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_gradients_match_jax(case):
    c, jc, jp, model, batch = _setup(case)
    loss, jloss = CASES[case][6], CASES[case][7]
    value = loss(model, batch, c)
    value.backward()
    jb = _jax(batch)
    want, grads = jax.jit(jax.value_and_grad(
        lambda p: jloss(p, jb, jc)))(jp)
    assert value.dim() == 0 and bool(torch.isfinite(value))
    np.testing.assert_allclose(float(value), float(want), **LOSS)
    nonzero = 0
    for name, p in model.named_parameters():
        g = np.asarray(convert._jax_leaf(grads, name))
        np.testing.assert_allclose(_grad(p), g, err_msg=name, **GRAD)
        nonzero += bool(np.any(g != 0))
    # every leaf but the unread ones carries a gradient (the sampled
    # cloze loss never reads BERT4Rec's output bias)
    assert nonzero >= len(list(model.parameters())) - 1


@pytest.mark.parametrize("case", list(CASES))
def test_three_train_steps_match_jax(case):
    """Losses, parameters and AdamW's state after 3 whole train steps
    (the port's in place, the reference's jitted)."""
    c, jc, jp, model, batch = _setup(case, seed=2)
    mod, jmod, kw = CASES[case][1], CASES[case][3], CASES[case][8]
    opt = optimizers.adamw(model.parameters(), lr=LR, warmup_steps=1)
    jo = jopt.adamw(lr=LR, warmup_steps=1)
    step = mod.make_train_step(c, opt, **kw)
    jstep = jax.jit(jmod.make_train_step(jc, jo, **kw))
    js, jb = jo.init(jp), _jax(batch)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    for _ in range(3):
        got = step(model, batch)
        jp, js, want = jstep(jp, js, jb)
        assert not got["loss"].requires_grad
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                                   **LOSS)
    for name, p in model.named_parameters():
        want = np.asarray(convert._jax_leaf(jp, name))
        np.testing.assert_allclose(p.detach().numpy(), want, err_msg=name,
                                   **STEPS)
        # the leaves the reference moved (all but a zero leaf the loss
        # never reads) moved
        assert torch.equal(p.detach(), before[name]) == \
            np.array_equal(want, before[name].numpy()), name
    state = convert.opt_state_to_numpy(opt, model)
    assert int(state.step) == int(js.step) == 3
    for k in ("m", "v"):
        for name, _ in model.named_parameters():
            np.testing.assert_allclose(
                convert._jax_leaf(state.inner[k], name),
                np.asarray(convert._jax_leaf(js.inner[k], name)),
                err_msg=f"{k}.{name}", **GRAD)


def test_train_batch_makers_are_seeded_and_in_range():
    tt, dl = two_tower_retrieval.make_config(), dlrm_mlperf.make_config()
    b4 = bert4rec_cfg.make_config()
    for make, c in ((recsys_shapes.dlrm_batch, dl),
                    (recsys_shapes.deepfm_batch, deepfm_cfg.make_config())):
        a, b = make(c, 256, _gen(9), train=True), make(c, 256, _gen(9), True)
        assert all(torch.equal(a[k], b[k]) for k in a)
        serve = make(c, 256, _gen(9))
        assert all(torch.equal(a[k], serve[k]) for k in serve)
        lab = a["labels"]
        assert lab.dtype == torch.float32 and lab.shape == (256,)
        assert set(lab.unique().tolist()) == {0.0, 1.0}
    t = recsys_shapes.two_tower_batch(tt, 64, _gen(9), train=True)
    assert torch.allclose(t["logq"], torch.full((64,),
                                                -math.log(tt.n_items)))
    serve = recsys_shapes.bert4rec_batch(b4, 64, _gen(9))["ids"]
    r = recsys_shapes.bert4rec_batch(b4, 64, _gen(9), train=True)
    m, s = recsys_shapes.N_MASKED, b4.seq_len
    assert r["mask_pos"].shape == r["targets"].shape == (64, m)
    assert r["negatives"].shape == (recsys_shapes.N_NEGATIVES,)
    assert int(r["negatives"].min()) >= 2
    assert int(r["negatives"].max()) < b4.n_items + 2
    assert all(len(set(row)) == m for row in r["mask_pos"].tolist())
    assert int(r["mask_pos"].min()) >= 0 and int(r["mask_pos"].max()) < s
    # targets: the item at each masked position, −1 on padding; ids: the
    # mask token there, the sequence elsewhere
    item = torch.gather(serve, 1, r["mask_pos"])
    assert torch.equal(r["targets"], torch.where(item > 0, item, -1))
    assert bool((r["targets"] >= 0).any() and (r["targets"] < 0).any())
    masked = torch.zeros_like(serve, dtype=torch.bool).scatter(
        1, r["mask_pos"], item > 0)
    assert torch.equal(r["ids"], torch.where(masked, 1, serve))
    full = recsys_shapes.cloze_targets(r, s)
    assert int((full >= 0).sum()) == int((r["targets"] >= 0).sum())


@pytest.mark.parametrize("chunk", [None, 7, 32])
def test_embedding_lookup_chunked_path_carries_gradients(rng, chunk):
    """The chunked lookup (ragged and even chunks) gives the table the
    dense gradient ``jax.grad`` of ``jnp.take`` gives."""
    spec = jemb.TableSpec((40, 30, 3), dim=4)
    table = np.asarray(jemb.init_table(jax.random.PRNGKey(0), spec))
    ids = rng.integers(0, [40, 30, 3], (96, 3)).astype(np.int32)
    w = rng.normal(size=(96, 3, 4)).astype(np.float32)
    t = torch.nn.Parameter(torch.from_numpy(table.copy()))
    ours = embedding.embedding_lookup(
        t, torch.from_numpy(ids), embedding.TableSpec((40, 30, 3), 4),
        chunk=chunk)
    torch.sum(ours * torch.from_numpy(w)).backward()
    want = jax.grad(lambda tb: jnp.sum(jemb.embedding_lookup(
        tb, jnp.asarray(ids), spec, chunk=chunk) * w))(jnp.asarray(table))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), **GRAD)
    assert t.grad.shape == t.shape and bool((t.grad != 0).any())


def test_serving_entry_points_leave_no_graph():
    """Trainable weights, yet every serving call answers without an
    autograd graph (the training losses do build one)."""
    g = _gen(4)
    outs = []
    c = two_tower_retrieval.smoke_config()
    m = two_tower.init_params(c, g, "cpu")
    outs += [two_tower.serve_step(m, recsys_shapes.two_tower_batch(c, 8, g),
                                  c),
             *two_tower.retrieval_step(m, recsys_shapes.
                                       two_tower_retrieval_batch(c, g, 300),
                                       c, top_n=5)]
    for mod, cfg, make in ((dlrm, dlrm_mlperf, recsys_shapes.dlrm_batch),
                           (deepfm, deepfm_cfg, recsys_shapes.deepfm_batch)):
        c = cfg.smoke_config()
        outs.append(mod.serve_step(mod.init_params(c, g, "cpu"),
                                   make(c, 8, g), c))
    c = bert4rec_cfg.smoke_config()
    m = bert4rec.init_params(c, g, "cpu")
    outs += [*bert4rec.serve_step(m, recsys_shapes.bert4rec_batch(c, 8, g),
                                  c, top_n=5),
             *bert4rec.retrieval_step(m, recsys_shapes.
                                      bert4rec_retrieval_batch(c, g, 300),
                                      c, top_n=5)]
    c = dimenet_cfg.make_config("molecule", smoke=True)
    m = dimenet.init_params(c, g, "cpu")
    outs.append(dimenet.serve_step(m, dimenet_cfg.cell_batch(
        dimenet_cfg.SMOKE_CELLS["molecule"], 0, "cpu"), c))
    assert all(p.requires_grad for p in m.parameters())
    assert len(outs) == 10
    assert not any(o.requires_grad or o.grad_fn is not None for o in outs)
    assert dimenet.loss_fn(m, dimenet_cfg.cell_batch(
        dimenet_cfg.SMOKE_CELLS["molecule"], 0, "cpu"), c).requires_grad
