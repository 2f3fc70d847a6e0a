"""The port's DimeNet and graph sampler against the JAX package.

``repro_torch.models.dimenet`` at ``smoke_config()``'s widths in both
input modes (molecules with atom types and geometry; a graph with node
features and per-node classes), the JAX package's parameters carried
across with ``convert.recsys_params_from_numpy("dimenet", ...)`` and
the batches from ``configs.dimenet_cfg.cell_batch`` given to both (a
molecule batch's distances and angles are JAX's geometry of the same
positions): the bases and the geometry, ``forward``, the loss and every leaf's
gradient, and 3 whole AdamW train steps against the reference's
jitted ``make_train_step``.  ``repro_torch.data.graph_sampler`` (the
port's own numpy copy) gives the reference's arrays bit for bit.

Tolerance: bases and losses ``rtol=1e-5, atol=1e-6``; the forward
output and each leaf's gradient held as a whole, ``‖got − want‖ <=
rtol·‖want‖ + atol·√n`` with ``rtol=1e-5`` (forward) or ``1e-4``
(gradients) and ``atol=1e-6``: the messages are float32 sums of terms
up to 10³ times the entries they leave, so an entry that cancels to
~1e-2 carries the sums' rounding (elementwise ratios up to ~20x rtol,
while the whole leaf agrees to ~1e-6); parameters after 3 steps
``rtol=1e-5, atol=1e-5`` elementwise at ``lr=3e-6`` (3·lr_t below that
atol: Adam moves a parameter whose gradient is ~0 by up to lr_t a step,
whichever sign the gradient takes); the sampler's arrays exact.
``graph_sampler.sample_triplets`` (the port's own, with no counterpart
there) gives each edge as many feeders as the reference's
``build_triplets``, each a real feeder, in edge order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dimenet_cfg as jcfg
from repro.data import graph_sampler as jgs
from repro.models import dimenet as jdn
from repro.optim import optimizers as jopt
from repro_torch import convert
from repro_torch.configs import dimenet_cfg
from repro_torch.data import graph_sampler
from repro_torch.models import dimenet
from repro_torch.models.embedding import InvalidIdError
from repro_torch.optim import optimizers

TOL = dict(rtol=1e-5, atol=1e-6)
STEPS = dict(rtol=1e-5, atol=1e-5)
LR = 3e-6
MODES = ["molecule", "full_graph_sm"]


def assert_leaf_close(got, want, rtol, atol=1e-6, what=""):
    """``got`` within ``rtol`` of ``want`` as a whole (L2 norms)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.linalg.norm(got - want)
    assert err <= rtol * np.linalg.norm(want) + atol * np.sqrt(want.size), \
        (what, err, np.linalg.norm(want))


def _jax(batch):
    return {k: jnp.asarray(v.numpy().astype(np.int32)
                           if v.dtype == torch.int64 else v.numpy())
            for k, v in batch.items()}


def _setup(cell, seed=0):
    c = dimenet_cfg.make_config(cell, smoke=True)
    jc = dataclasses.replace(jcfg.smoke_config(), d_node_feat=c.d_node_feat,
                             n_targets=c.n_targets)
    jp = jdn.init_params(jc, jax.random.PRNGKey(seed))
    model = convert.recsys_params_from_numpy(
        "dimenet", jax.tree.map(np.asarray, jp), c, device="cpu")
    batch = dimenet_cfg.cell_batch(dimenet_cfg.SMOKE_CELLS[cell], seed,
                                   "cpu")
    return c, jc, jp, model, batch


def test_configs_match_jax():
    assert dimenet_cfg.CELLS == jcfg.CELLS
    for cell in jcfg.CELLS:
        ours, theirs = dimenet_cfg.make_config(cell), jcfg.make_config(cell)
        for f in dataclasses.fields(theirs):
            if f.name != "dtype":
                assert getattr(ours, f.name) == getattr(theirs, f.name), f
        assert ours.n_params() == theirs.n_params()
        assert dimenet.param_shapes(ours) == jdn.param_shapes(theirs)
    s, js = dimenet_cfg.smoke_config(), jcfg.smoke_config()
    assert (s.n_blocks, s.d_hidden, s.n_bilinear, s.n_spherical,
            s.n_radial) == (js.n_blocks, js.d_hidden, js.n_bilinear,
                            js.n_spherical, js.n_radial)
    _, jc, jp, model, _ = _setup("molecule")
    assert sum(p.numel() for p in model.parameters()) == \
        sum(x.size for x in jax.tree.leaves(jp))
    a = dimenet.init_params(s, torch.Generator().manual_seed(1), "cpu")
    b = dimenet.init_params(s, torch.Generator().manual_seed(1), "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                 b.parameters()))


@pytest.mark.parametrize("seed", [0, 3])
def test_graph_sampler_arrays_equal_jax(seed):
    ours = graph_sampler.CSRGraph.random(300, avg_degree=6, seed=seed)
    theirs = jgs.CSRGraph.random(300, avg_degree=6, seed=seed)
    np.testing.assert_array_equal(ours.indptr, theirs.indptr)
    np.testing.assert_array_equal(ours.indices, theirs.indices)
    seeds = np.arange(0, 300, 17)
    got = graph_sampler.LayeredSampler(ours, [5, 3], seed=seed).sample(seeds)
    want = jgs.LayeredSampler(theirs, [5, 3], seed=seed).sample(seeds)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    src, dst, _ = want
    for parts, cap in ((1, 8), (4, 2)):        # cap 2: the rng's draws
        for a, b in zip(graph_sampler.build_triplets(src, dst, parts, cap,
                                                     seed),
                        jgs.build_triplets(src, dst, parts, cap, seed)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    for a, b in zip(graph_sampler.molecule_batch(3, 7, 11, seed),
                    jgs.molecule_batch(3, 7, 11, seed)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    x = np.arange(10, dtype=np.int32).reshape(5, 2)
    for n in (3, 8):
        np.testing.assert_array_equal(graph_sampler.pad_to(x, n, fill=-1),
                                      jgs.pad_to(x, n, fill=-1))


@pytest.mark.parametrize("seed,n_nodes,n_edges,cap",
                         [(0, 40, 120, 8), (1, 300, 1800, 8),
                          (2, 50, 600, 3)])
def test_sample_triplets_are_the_reference_counts_of_feeders(
        seed, n_nodes, n_edges, cap):
    """Every triplet (f, e) has f feeding e (f = (k→j), e = (j→i)) and
    f ≠ e, no pair twice, triplets in edge order, and each edge as many
    as the reference's ``build_triplets`` takes (its feeders, at most
    ``cap``); seeded; ``limit`` keeps the first triplets whole edges at
    a time."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    dst = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    src[:3] = dst[:3] = 0                        # self-loops, as the ghosts
    kj, ji = graph_sampler.sample_triplets(src, dst, cap, seed)
    assert kj.dtype == ji.dtype == np.int32
    assert (dst[kj] == src[ji]).all() and (kj != ji).all()
    assert len(set(zip(kj.tolist(), ji.tolist()))) == len(kj)
    assert (np.diff(ji) >= 0).all()
    _, want = jgs.build_triplets(src, dst, 1, cap, seed)
    np.testing.assert_array_equal(np.bincount(ji, minlength=n_edges),
                                  np.bincount(want, minlength=n_edges))
    for a, b in zip((kj, ji), graph_sampler.sample_triplets(src, dst, cap,
                                                             seed)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip((kj, ji), graph_sampler.sample_triplets(
            src, dst, cap, seed, limit=len(kj) // 2)):
        np.testing.assert_array_equal(a[:len(b)], b)
        assert len(b) >= len(kj) // 2


def test_bases_and_geometry_match_jax(rng):
    dist = rng.uniform(0.0, 6.0, 50).astype(np.float32)
    dist[:2] = (0.0, 5.0)                      # clamped; at the cutoff
    angle = rng.uniform(0.0, np.pi, 50).astype(np.float32)
    np.testing.assert_allclose(
        dimenet.rbf_basis(torch.from_numpy(dist), 6, 5.0).numpy(),
        np.asarray(jdn.rbf_basis(jnp.asarray(dist), 6, 5.0)), **TOL)
    np.testing.assert_allclose(
        dimenet.sbf_basis(torch.from_numpy(dist), torch.from_numpy(angle),
                          7, 6, 5.0).numpy(),
        np.asarray(jdn.sbf_basis(jnp.asarray(dist), jnp.asarray(angle), 7,
                                 6, 5.0)), rtol=1e-5, atol=1e-5)
    z, pos, src, dst, _ = graph_sampler.molecule_batch(3, 8, 16, seed=2)
    tkj, tji = graph_sampler.build_triplets(src, dst)
    dist, ang = dimenet.geometry_from_positions(
        *(torch.from_numpy(a) for a in (pos, src, dst, tkj, tji)))
    jdist, jang = jdn.geometry_from_positions(
        *(jnp.asarray(a) for a in (pos, src, dst, tkj, tji)))
    np.testing.assert_allclose(dist.numpy(), np.asarray(jdist), **TOL)
    np.testing.assert_allclose(ang.numpy(), np.asarray(jang), **TOL)
    # both pass -1 as norm's second argument, which is ``ord``: each
    # [T, 3] matrix's smallest column sum of |x| divides every dot, so the
    # angles sit near pi/2 (checked in float64)
    vec = pos[dst].astype(np.float64) - pos[src]
    v1, v2 = -vec[tkj], vec[tji]
    mat = np.linalg.norm(v1, -1) * np.linalg.norm(v2, -1)
    np.testing.assert_allclose(np.cos(ang.numpy().astype(np.float64)),
                               np.sum(v1 * v2, -1) / mat, rtol=0, atol=1e-6)
    assert np.abs(ang.numpy() - np.pi / 2).max() < 0.01


@pytest.mark.parametrize("smoke", [True, False])
def test_molecule_batch_geometry_is_jax(smoke):
    """A molecule batch's distances and angles are the reference's
    ``geometry_from_positions`` of the batch's own positions and padded
    triplets (the ghost edge's distance then set to the cutoff)."""
    g = (dimenet_cfg.SMOKE_CELLS if smoke else dimenet_cfg.CELLS)["molecule"]
    batch = dimenet_cfg.cell_batch(g, 5, "cpu")
    k = g["n_graphs"]
    _, pos, _, _, _ = graph_sampler.molecule_batch(
        k, g["n_nodes"] // k, g["n_edges"] // k, seed=5)
    jb = _jax(batch)
    jdist, jang = jdn.geometry_from_positions(
        jnp.asarray(pos), jb["edge_src"], jb["edge_dst"], jb["tri_kj"],
        jb["tri_ji"])
    np.testing.assert_allclose(batch["angle"].numpy(), np.asarray(jang),
                               **TOL)
    np.testing.assert_allclose(batch["dist"][1:].numpy(),
                               np.asarray(jdist)[1:], **TOL)
    assert float(batch["dist"][0]) == dimenet.DimeNetConfig.cutoff


@pytest.mark.parametrize("cell", MODES)
def test_forward_loss_and_gradients_match_jax(cell):
    c, jc, jp, model, batch = _setup(cell)
    jb = _jax(batch)
    out = dimenet.forward(model, batch, c)
    want = jdn.forward(jp, jb, jc)
    assert out.shape == want.shape
    assert_leaf_close(out.detach().numpy(), want, 1e-5, what="forward")
    assert torch.equal(dimenet.serve_step(model, batch, c), out.detach())
    value = dimenet.loss_fn(model, batch, c)
    value.backward()
    jv, grads = jax.jit(jax.value_and_grad(
        lambda p: jdn.loss_fn(p, jb, jc)))(jp)
    np.testing.assert_allclose(float(value), float(jv), **TOL)
    for name, p in model.named_parameters():
        g = np.asarray(convert._jax_leaf(grads, name))
        got = np.zeros_like(g) if p.grad is None else p.grad.numpy()
        assert_leaf_close(got, g, 1e-4, what=name)
    assert model.head.grad is None                 # never read


@pytest.mark.parametrize("cell", MODES)
def test_three_train_steps_match_jax(cell):
    c, jc, jp, model, batch = _setup(cell, seed=1)
    opt = optimizers.adamw(model.parameters(), lr=LR, warmup_steps=1)
    jo = jopt.adamw(lr=LR, warmup_steps=1)
    step = dimenet.make_train_step(c, opt)
    jstep = jax.jit(jdn.make_train_step(jc, jo))
    js, jb = jo.init(jp), _jax(batch)
    for _ in range(3):
        got = step(model, batch)
        jp, js, want = jstep(jp, js, jb)
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                                   **TOL)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(
            p.detach().numpy(), np.asarray(convert._jax_leaf(jp, name)),
            err_msg=name, **STEPS)


@pytest.mark.parametrize("cell", MODES)
def test_cell_batches_at_full_size(cell):
    """The cells' own sizes, every index in range, seeded."""
    g = dimenet_cfg.CELLS[cell]
    batch = dimenet_cfg.cell_batch(g, 0, "cpu")
    again = dimenet_cfg.cell_batch(g, 0, "cpu")
    assert all(torch.equal(batch[k], again[k]) for k in batch)
    assert batch["edge_src"].shape == batch["dist"].shape == (g["n_edges"],)
    assert batch["tri_kj"].shape == batch["angle"].shape == (g["n_tri"],)
    c = dimenet_cfg.make_config(cell)
    dimenet.check_indices(batch, c)
    assert bool(torch.isfinite(batch["dist"]).all())
    assert bool(torch.isfinite(batch["angle"]).all())
    if g["geometric"]:
        assert batch["z"].shape == (g["n_nodes"],)
        assert batch["labels"].shape == (g["n_graphs"],)
    else:
        assert batch["node_feat"].shape == (g["n_nodes"], g["d_feat"])
        assert int(batch["labels"].max()) < g["n_targets"]
        # ghost edges sit at the cutoff, where the radial basis is 0
        ghost = batch["dist"] == c.cutoff
        assert bool(ghost.any())
        assert float(dimenet.rbf_basis(batch["dist"][ghost], c.n_radial,
                                       c.cutoff).abs().max()) < 1e-6


def test_out_of_range_indices_raise():
    c, _, _, model, batch = _setup("molecule")
    for key, bad in (("edge_dst", batch["z"].shape[0]),
                     ("tri_kj", batch["edge_src"].shape[0]),
                     ("z", c.n_species), ("graph_id", 4), ("edge_src", -1)):
        b = dict(batch)
        b[key] = b[key].clone()
        b[key][0] = bad
        with pytest.raises(InvalidIdError, match=key):
            dimenet.forward(model, b, c)
