"""The port's optimizers against the JAX package's.

``repro_torch.optim.optimizers`` (AdamW, Adafactor and SGD as
``torch.optim.Optimizer`` subclasses updating IN PLACE) against
``repro.optim.optimizers`` (functional ``(init, update)`` pairs), fed
the same numpy-seeded parameters and gradients: one update and five,
each leaf walked whole and in row chunks (``CHUNK`` lowered so that
every leaf but the scalar is chunked), Adafactor on factored 2-D and
stacked 3-D leaves and on unfactored ones; the global-norm clip; the
warmup-cosine schedule at its edges; the reference's quadratic test;
and the ``convert.opt_state_{from,to}_numpy`` round trip.

Tolerance: one update ``rtol=1e-6, atol=1e-7``; five updates and the
schedule ``rtol=1e-5, atol=1e-7`` (float32 with another fusion of the
same operations); the state round trip exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import bert4rec_cfg as jbert_cfg
from repro.configs import two_tower_retrieval as jtt_cfg
from repro.models import bert4rec as jbert
from repro.models import two_tower as jtt
from repro.optim import optimizers as jopt
from repro_torch import convert
from repro_torch.configs import (bert4rec_cfg, recsys_shapes,
                                 two_tower_retrieval)
from repro_torch.models import bert4rec, two_tower
from repro_torch.optim import optimizers

ONE = dict(rtol=1e-6, atol=1e-7)
MANY = dict(rtol=1e-5, atol=1e-7)
# a vector, a 2-D leaf Adafactor factors (both dims >= 128), a stacked
# [L, r, c] one it factors, a narrow matrix it does not, and a scalar
SHAPES = {"vec": (7,), "mat": (200, 160), "stack": (3, 130, 140),
          "thin": (150, 20), "scalar": ()}

MAKERS = {
    "adamw": (lambda p: optimizers.adamw(p, lr=1e-2, warmup_steps=2,
                                         total_steps=4),
              lambda: jopt.adamw(lr=1e-2, warmup_steps=2, total_steps=4)),
    "adafactor": (lambda p: optimizers.adafactor(p, lr=1e-2),
                  lambda: jopt.adafactor(lr=1e-2)),
    "sgd": (lambda p: optimizers.sgd(p, lr=1e-2), lambda: jopt.sgd(lr=1e-2)),
}


def _params(rng):
    return {k: np.asarray(rng.normal(size=s), np.float32)
            for k, s in SHAPES.items()}


def _grads(rng, scale):
    # a global norm above the clip (1.0) at scale 1, below it at 1e-3
    return {k: np.asarray(rng.normal(size=s) * scale * 0.3, np.float32)
            for k, s in SHAPES.items()}


def _run_both(name, n_steps, seed=0):
    rng = np.random.default_rng(seed)
    host = _params(rng)
    params = [torch.nn.Parameter(torch.from_numpy(v.copy()))
              for v in host.values()]
    ours = MAKERS[name][0](params)
    theirs = MAKERS[name][1]()
    update = jax.jit(theirs.update)
    jp = {k: jnp.asarray(v) for k, v in host.items()}
    js = theirs.init(jp)
    for i in range(n_steps):
        g = _grads(rng, 1.0 if i % 2 == 0 else 1e-3)
        for p, v in zip(params, g.values()):
            p.grad = torch.from_numpy(v.copy())
        ours.step()
        jp, js = update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
    return params, ours, jp, js


@pytest.mark.parametrize("chunk", [1 << 24, 997])
@pytest.mark.parametrize("name", list(MAKERS))
@pytest.mark.parametrize("n_steps", [1, 5])
def test_updates_match_jax(name, n_steps, chunk, monkeypatch):
    """Parameters and state after 1 and 5 updates on identical
    gradients, whole leaves and chunked ones."""
    monkeypatch.setattr(optimizers, "CHUNK", chunk)
    params, ours, jp, js = _run_both(name, n_steps)
    tol = ONE if n_steps == 1 else MANY
    for p, k in zip(params, SHAPES):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                   err_msg=k, **tol)
    assert ours.n_steps == int(js.step) == n_steps
    for k, p in zip(SHAPES, params):
        st = ours.state[p]
        if name == "adamw":
            want = {s: js.inner[s][k] for s in ("m", "v")}
        elif name == "sgd":
            want = {"m": js.inner[k]}
        else:
            want = js.inner[k]
        assert set(st) == set(want), (k, set(st))
        for s, v in want.items():
            np.testing.assert_allclose(st[s].numpy(), np.asarray(v),
                                       err_msg=f"{k}.{s}", **tol)


def test_adafactor_factors_as_the_reference():
    ours = optimizers.adafactor([torch.nn.Parameter(torch.zeros(s))
                                 for s in SHAPES.values()])
    kinds = [sorted(st) for st in ours.state.values()]
    assert kinds == [["v"], ["vc", "vr"], ["vc", "vr"], ["v"], ["v"]]
    assert tuple(ours.state[ours.param_groups[0]["params"][2]]["vc"]
                 .shape) == (3, 140)


def test_unused_parameter_takes_a_zero_gradient():
    """A leaf the loss never reads (``.grad`` None) moves as the
    reference's zero gradient moves it: AdamW's decay only."""
    host = np.linspace(-1, 1, 6, dtype=np.float32)
    p = torch.nn.Parameter(torch.from_numpy(host.copy()))
    opt = optimizers.adamw([p], lr=0.1, warmup_steps=1)
    opt.step()
    jp, _ = jopt.adamw(lr=0.1, warmup_steps=1).update(
        jnp.zeros(6), jopt.adamw().init(jnp.asarray(host)),
        jnp.asarray(host))
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), **ONE)


@pytest.mark.parametrize("scale", [10.0, 1e-4])
def test_clip_by_global_norm_matches_jax(scale):
    rng = np.random.default_rng(1)
    g = {k: np.asarray(rng.normal(size=s) * scale, np.float32)
         for k, s in SHAPES.items()}
    ours = [torch.from_numpy(v.copy()) for v in g.values()]
    norm = optimizers.clip_by_global_norm(ours, 1.0)
    want, jnorm = jopt.clip_by_global_norm(
        {k: jnp.asarray(v) for k, v in g.items()}, 1.0)
    assert isinstance(norm, torch.Tensor) and norm.dim() == 0
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
    for t, k in zip(ours, g):
        np.testing.assert_allclose(t.numpy(), np.asarray(want[k]), **ONE)
    # clipped to norm 1 above it, untouched below it
    total = np.sqrt(sum(float(np.sum(t.numpy().astype(np.float64) ** 2))
                        for t in ours))
    np.testing.assert_allclose(total, min(1.0, float(norm)), rtol=1e-6)


@pytest.mark.parametrize("step", [0, 9, 10, 11, 500, 1000, 1001, 5000])
def test_warmup_cosine_matches_jax(step):
    """Steps 0 and warmup-1 (warming up), warmup, mid-cosine, total and
    past it (0)."""
    got = optimizers._warmup_cosine(step, 3e-4, 10, 1000)
    want = float(jopt._warmup_cosine(jnp.asarray(step, jnp.int32), 3e-4, 10,
                                     1000))
    np.testing.assert_allclose(got, want, **MANY)
    if step >= 1000:
        assert got == 0.0


@pytest.mark.parametrize("name,make", [
    ("adamw", lambda p: optimizers.adamw(p, lr=0.1, warmup_steps=1,
                                         total_steps=100, weight_decay=0.0)),
    ("adafactor", lambda p: optimizers.adafactor(p, lr=0.02, clip_norm=1e9)),
    ("sgd", lambda p: optimizers.sgd(p, lr=0.05, clip_norm=1e9)),
])
def test_optimizers_minimize_quadratic(name, make):
    """The reference's test (``tests/test_checkpoint_and_optim.py``):
    60 steps on ‖w‖² + ‖m‖² take the loss below a fifth."""
    w = torch.nn.Parameter(torch.tensor([3.0, -2.0, 1.5]))
    m = torch.nn.Parameter(torch.full((200, 200), 0.3))  # factored
    opt = make([w, m])

    def loss():
        return torch.sum(w ** 2) + torch.sum(m ** 2)
    l0 = float(loss())
    for _ in range(60):
        opt.zero_grad()
        loss().backward()
        opt.step()
    assert float(loss()) < 0.2 * l0, name


ARCHS = {"two_tower": (two_tower, two_tower_retrieval, jtt, jtt_cfg,
                      recsys_shapes.two_tower_batch),
         "bert4rec": (bert4rec, bert4rec_cfg, jbert, jbert_cfg,
                      recsys_shapes.bert4rec_batch)}


# the reference's adafactor takes no tree with lists (its init maps over
# every non-dict node), so it runs on BERT4Rec's tree of dicts only
@pytest.mark.parametrize("arch,name", [
    ("two_tower", "adamw"), ("two_tower", "sgd"), ("bert4rec", "adamw"),
    ("bert4rec", "adafactor")])
def test_opt_state_round_trip(arch, name):
    """A JAX state after two steps installs in the port's optimizer,
    comes back leaf for leaf, and a third step from it agrees."""
    mod, cfg, jmod, jcfg, make = ARCHS[arch]
    c, jc = cfg.smoke_config(), jcfg.smoke_config()
    batch = make(c, 12, torch.Generator().manual_seed(3), train=True)
    jb = {k: jnp.asarray(v.numpy().astype(np.int32)
                         if v.dtype == torch.int64 else v.numpy())
          for k, v in batch.items()}
    kw = {"sampled": True} if arch == "bert4rec" else {}
    jopt_ = MAKERS[name][1]()
    step = jax.jit(jmod.make_train_step(jc, jopt_, **kw))
    jp = jmod.init_params(jc, jax.random.PRNGKey(0))
    js = jopt_.init(jp)
    for _ in range(2):
        jp, js, _ = step(jp, js, jb)
    host = jax.tree.map(np.asarray, js)
    model = convert.recsys_params_from_numpy(
        arch, jax.tree.map(np.asarray, jp), c, device="cpu")
    ours = MAKERS[name][0](model.parameters())
    convert.opt_state_from_numpy(ours, model, host)
    back = convert.opt_state_to_numpy(ours, model)
    assert int(back.step) == int(host.step) == 2
    want = jax.tree_util.tree_leaves_with_path(host.inner)
    got = jax.tree_util.tree_leaves_with_path(back.inner)
    assert sorted(str(p) for p, _ in got) == sorted(str(p) for p, _ in want)
    got = dict((str(p), a) for p, a in got)
    for path, b in want:
        np.testing.assert_array_equal(got[str(path)], b, err_msg=str(path))
    mod.make_train_step(c, ours, **kw)(model, batch)
    jp, js, _ = step(jp, js, jb)
    for name_, p in model.named_parameters():
        np.testing.assert_allclose(
            p.detach().numpy(), np.asarray(convert._jax_leaf(jp, name_)),
            rtol=1e-5, atol=1e-5, err_msg=name_)
