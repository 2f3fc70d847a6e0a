"""The port's cell registry held against the JAX registry.

``repro_torch.configs`` against ``repro.configs``, whose cells are built
on a one-device ``("data", "model")`` mesh with
``repro.launch.mesh.make_rules``:

* the same 11 arch names, families and 43 (arch, shape) pairs, in the
  same order;
* for each of the 40 LM, recommender and GNN cells at the published
  sizes: ``description`` equal, the uncut model FLOPs
  (``Cell.published_flops``) equal to the JAX ``model_flops_per_step``,
  and every batch, cache and token leaf's shape equal to the JAX
  ``ShapeDtypeStruct``'s, dtypes through ``base.JAX_DTYPES`` (JAX's int32
  ids are the port's int64) -- from the builders' shape functions, so
  nothing is allocated at full size;
* the cut rule at the H100's bytes: deterministic, every cut named with
  its bytes, widths and sequence lengths never cut, the cuts the chip
  phases already took, and nothing cut on a card without bound;
* every cell at a smoke size (``configs.smoke_sizes``) through
  ``dryrun.run_cell(..., device="cpu")``, every field returned, and the
  built inputs as the shape functions give them;
* one cell of each kind (LM train, prefill and decode; recommender
  serve, retrieval and train; DimeNet train) against the JAX package's
  model function on the same parameters (the cell's seeded ones carried
  across with ``convert``) and the cell's inputs.

Tolerance: the existing tests' bars (``PERF.md`` §2): LM logits
``atol=1e-4`` (caches ``atol=1e-2`` in bf16); recommender outputs
``rtol=1e-5, atol=1e-6``; losses ``rtol=1e-5, atol=1e-6``; clipped
gradients ``rtol=1e-4, atol=1e-6``; parameters after one AdamW step
(lr_t 3e-6, the warmup's first) ``rtol=1e-5, atol=1e-5``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED as J_ASSIGNED
from repro.configs import REGISTRY as J_REGISTRY
from repro.configs import all_cells as j_all_cells
from repro.configs import dimenet_cfg as jdimenet_cfg
from repro.launch.mesh import make_rules
from repro.models import bert4rec as jbert
from repro.models import dimenet as jdn
from repro.models import dlrm as jdlrm
from repro.models import two_tower as jtt
from repro.models import transformer as jtf
from repro.optim import optimizers as jopt
from repro_torch import convert
from repro_torch.configs import (ASSIGNED, REGISTRY, all_cells, get_arch,
                                 smoke_sizes)
from repro_torch.configs.base import H100_BYTES, JAX_DTYPES
from repro_torch.launch import dryrun

NEW = [(n, s) for n, s in all_cells() if n != "tifu-knn"]
FIELDS = {"arch", "shape", "build_s", "description", "reduced", "device",
          "run_s", "model_flops", "model_flops_per_s", "peak_bytes",
          "estimate_bytes", "device_bytes", "fits", "roofline", "chips",
          "model_flops_per_device", "useful_flops_ratio"}
LOGITS_ATOL = 1e-4
OUT = dict(rtol=1e-5, atol=1e-6)
LOSS = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
STEPS = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Many small ops: one torch thread a test keeps parallel test
    workers from oversubscribing the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def jax_cells():
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    rules = make_rules(mesh)
    return {(n, s): J_REGISTRY[n].cells[s](mesh, rules) for n, s in NEW}


def _cell(name, shape):
    return get_arch(name).cells[shape]


def _jax_leaves(name, shape, prog):
    """The JAX cell's batch, cache and token leaves by the port's
    names."""
    if J_REGISTRY[name].family == "lm":
        if shape == "train_4k":
            return dict(prog.args[2])
        if shape == "prefill_32k":
            return {"tokens": prog.args[1]}
        out = {f"caches/{g}/{i}": x for g, pair in prog.args[1].items()
               for i, x in enumerate(pair)}
        out["token"] = prog.args[2]
        return out
    return dict(prog.args[-1])


def _port_leaves(name, shape, args):
    """The built inputs' leaves, named as ``Cell.leaves`` names them."""
    if get_arch(name).family == "lm":
        if shape == "train_4k":
            return dict(args[1])
        if shape == "prefill_32k":
            return {"tokens": args[1]}
        out = {f"caches/{g}/{i}": x for g, pair in args[1].items()
               for i, x in enumerate(pair)}
        out["token"] = args[2]
        return out
    return dict(args[1])


def test_registry_is_the_jax_registry():
    assert list(REGISTRY) == list(J_REGISTRY)
    assert ASSIGNED == J_ASSIGNED and len(ASSIGNED) == 10
    assert list(all_cells()) == list(j_all_cells())
    assert len(list(all_cells())) == 43 and len(NEW) == 40
    for name in REGISTRY:
        arch, jarch = get_arch(name), J_REGISTRY[name]
        assert (arch.name, arch.family) == (jarch.name, jarch.family)
        assert list(arch.cells) == list(jarch.cells)
        assert arch.notes
    with pytest.raises(KeyError, match="tifu-knn"):
        get_arch("lm100m")


@pytest.mark.parametrize("name,shape", NEW, ids=lambda x: str(x))
def test_cell_matches_the_jax_cell(jax_cells, name, shape):
    cell, jprog = _cell(name, shape), jax_cells[(name, shape)]
    assert cell.description == jprog.description
    assert cell.published_flops() == pytest.approx(
        jprog.model_flops_per_step, rel=1e-12, abs=0.0)
    got = {k: (tuple(s), JAX_DTYPES[d])
           for k, (s, d) in cell.leaves(cell.published).items()}
    want = {k: (tuple(v.shape), str(v.dtype))
            for k, v in _jax_leaves(name, shape, jprog).items()}
    assert got == want


def test_cut_rule_at_the_h100_is_deterministic_and_named():
    for name, shape in NEW:
        cell = _cell(name, shape)
        sz, reduced, est = cell.choose(H100_BYTES)
        assert cell.choose(H100_BYTES) == (sz, reduced, est)
        assert est <= H100_BYTES, (name, shape, est)
        for key, text in reduced.items():
            assert " → " in text and " GB" in text, (name, shape, key)
        pub = cell.published
        assert sz.seq == pub.seq and sz.batch <= pub.batch \
            or get_arch(name).family == "gnn"
        if get_arch(name).family == "lm":
            for f in ("d_model", "n_heads", "n_kv_heads", "d_head", "d_ff",
                      "vocab_size", "n_experts", "top_k", "moe_d_ff",
                      "kv_lora_rank", "sliding_window"):
                assert getattr(sz.config, f) == getattr(pub.config, f), f
        # every cut is a memory cut; a card without bound cuts nothing
        for text in reduced.values():
            assert "(memory: " in text, (name, shape, text)
        assert cell.choose(None) == (pub, {}, cell.peak(pub))


def _chosen(name, shape):
    return _cell(name, shape).choose(H100_BYTES)


def test_cut_rule_takes_the_chip_phases_cuts():
    """The cuts ``PERF.md`` §4 names: DLRM's vocabularies at 2^24 rows
    serving and 2^22 training, BERT4Rec's sampled cloze at 8,192,
    two-tower's in-batch softmax at 32,768, the LM zoo's serving depths,
    granite at full depth; DimeNet's small graphs uncut and
    ogb_products divided by the least power of two that fits, named as
    waiting for the sharded path."""
    for shape in ("serve_p99", "serve_bulk", "retrieval_cand"):
        sz, red, _ = _chosen("dlrm-mlperf", shape)
        assert max(sz.config.vocab_sizes) == 1 << 24 and "vocab_sizes" in red
    sz, red, _ = _chosen("dlrm-mlperf", "train_batch")
    assert max(sz.config.vocab_sizes) == 1 << 22
    assert sz.batch == 65536 and "2^22" in red["vocab_sizes"]
    assert _chosen("dlrm-mlperf", "retrieval_cand")[0].batch < 1_000_000
    for name, n in (("bert4rec", 8192), ("two-tower-retrieval", 32768)):
        sz, red, _ = _chosen(name, "train_batch")
        assert sz.batch == n
        assert red["batch"].startswith(f"65,536 → {n:,} (memory: ")
    for shape in ("serve_p99", "serve_bulk", "retrieval_cand"):
        for name in ("bert4rec", "two-tower-retrieval", "deepfm"):
            assert _chosen(name, shape)[1] == {}, (name, shape)
    for shape in ("prefill_32k", "decode_32k", "long_500k", "train_4k"):
        ds = _chosen("deepseek-v3-671b", shape)[0].config
        assert (ds.n_layers, ds.first_dense_layers) == (2, 1)
        assert "n_layers" not in _chosen("granite-3-2b", shape)[1]
    for shape in ("prefill_32k", "decode_32k", "long_500k"):
        g = _chosen("gemma3-27b", shape)[0].config
        assert (g.n_layers, g.global_every) == (6, 6)
        assert _chosen("command-r-plus-104b", shape)[0].config.n_layers == 2
    sz, red, _ = _chosen("gemma3-27b", "train_4k")
    assert "(4 local + 1 global)" in red["n_layers"]
    assert sz.config.global_every == sz.config.n_layers
    assert _chosen("qwen2-moe-a2.7b", "prefill_32k")[0].config.n_layers == 24
    # batches: the largest power of two whose estimate fits
    assert _chosen("granite-3-2b", "prefill_32k")[0].batch == 8
    assert _chosen("granite-3-2b", "train_4k")[0].batch == 16
    for shape in ("full_graph_sm", "molecule", "minibatch_lg"):
        assert _chosen("dimenet", shape)[1] == {}, shape
    sz, red, _ = _chosen("dimenet", "ogb_products")
    assert sz.batch == 16 and "sharded path" in red["batch"]


@pytest.mark.parametrize("name,shape", NEW, ids=lambda x: str(x))
def test_smoke_cell_runs_on_the_cpu(name, shape):
    sizes = smoke_sizes(name, shape)
    r = dryrun.run_cell(name, shape, device="cpu", seed=0, sizes=sizes)
    assert set(r) == FIELDS
    assert (r["arch"], r["shape"], r["device"]) == (name, shape, "cpu")
    assert r["build_s"] > 0 and r["run_s"] > 0
    assert r["description"] == _cell(name, shape).description
    assert r["peak_bytes"] is None and r["fits"] is None
    assert r["estimate_bytes"] > 0 and r["reduced"]
    assert all(v.endswith("(the caller's sizes)")
               for v in r["reduced"].values())
    prog = _cell(name, shape)("cpu", 0, sizes)
    got = {k: (tuple(v.shape), v.dtype)
           for k, v in _port_leaves(name, shape, prog.args).items()}
    assert got == {k: (tuple(s), d) for k, (s, d) in
                   _cell(name, shape).leaves(sizes).items()}


# ---------------------------------------------------------------------------
# each kind of cell against the JAX model function
# ---------------------------------------------------------------------------

def _lm(name, shape):
    prog = _cell(name, shape)("cpu", 0, smoke_sizes(name, shape))
    model = prog.args[0]
    jp = jax.tree.map(lambda x: jnp.array(x, copy=True),
                      convert.transformer_params_to_numpy(model))
    return prog, model, jp, J_REGISTRY[name].make_smoke()


def _i32(t):
    return jnp.asarray(t.numpy().astype(np.int32))


def _global_norm(tree):
    return float(jnp.sqrt(sum(jnp.sum(jnp.square(x.astype(jnp.float32)))
                              for x in jax.tree.leaves(tree))))


@pytest.mark.parametrize("name", ["granite-3-2b", "deepseek-v3-671b"])
def test_lm_train_cell_matches_jax(name):
    """One train step of the cell: its loss, the clipped gradients the
    step leaves, and (AdamW) the parameters after it, against
    ``jax.value_and_grad`` and the reference's jitted train step with
    the JAX cell's optimizer."""
    prog, model, jp, jc = _lm(name, "train_4k")
    batch = prog.args[1]
    jb = {k: _i32(v) for k, v in batch.items()}
    adamw = _cell(name, "train_4k").optimizer == "adamw"
    jo = jopt.adamw(total_steps=10000) if adamw else jopt.adafactor()
    want, grads = jax.jit(jax.value_and_grad(
        lambda p: jtf.lm_loss(p, jb, jc)))(jp)
    new_jp, _, jout = jax.jit(jtf.make_train_step(jc, jo))(jp, jo.init(jp),
                                                           jb)
    got = prog.fn(*prog.args)
    np.testing.assert_allclose(float(got["loss"]), float(want), **LOSS)
    np.testing.assert_allclose(float(jout["loss"]), float(want), **LOSS)
    scale = min(1.0, 1.0 / max(_global_norm(grads), 1e-12))
    clipped = convert._lm_tree(
        model, lambda p: torch.zeros_like(p) if p.grad is None else p.grad)
    for g, e in zip(jax.tree.leaves(clipped), jax.tree.leaves(grads)):
        np.testing.assert_allclose(g.numpy(), np.asarray(e) * scale, **GRAD)
    if adamw:
        back = convert.transformer_params_to_numpy(model)
        for g, e in zip(jax.tree.leaves(back), jax.tree.leaves(new_jp)):
            np.testing.assert_allclose(g, np.asarray(e), **STEPS)


@pytest.mark.parametrize("name", ["granite-3-2b", "qwen2-moe-a2.7b",
                                  "gemma3-27b"])
def test_lm_prefill_cell_matches_jax(name):
    prog, model, jp, jc = _lm(name, "prefill_32k")
    tokens = prog.args[1]
    logits, caches = prog.fn(*prog.args)
    jlogits, jcaches = jtf.prefill(jp, _i32(tokens), jc,
                                   max_len=tokens.shape[1])
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=LOGITS_ATOL)
    assert set(caches) == set(jcaches)
    for group in jcaches:
        for tc, jc_ in zip(caches[group], jcaches[group]):
            assert tc.dtype == torch.bfloat16 and tuple(tc.shape) == jc_.shape
            np.testing.assert_allclose(tc.float().numpy(),
                                       np.asarray(jc_, np.float32),
                                       atol=1e-2)


@pytest.mark.parametrize("name", ["granite-3-2b", "deepseek-v3-671b",
                                  "command-r-plus-104b"])
def test_lm_decode_cell_matches_jax(name):
    """One decode step against the cell's seeded bf16 caches at their
    last position: the logits, and the caches it wrote."""
    prog, model, jp, jc = _lm(name, "decode_32k")
    _, caches, token, pos = prog.args
    assert pos == caches[next(iter(caches))][0].shape[2] - 1
    jcaches = {g: tuple(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                        for t in pair) for g, pair in caches.items()}
    jlogits, jcaches = jtf.decode_step(jp, jcaches, _i32(token), pos, jc)
    logits, caches = prog.fn(*prog.args)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=LOGITS_ATOL)
    for group in jcaches:
        for tc, jc_ in zip(caches[group], jcaches[group]):
            np.testing.assert_allclose(tc.float().numpy(),
                                       np.asarray(jc_, np.float32),
                                       atol=1e-2)


def _recsys(name, shape):
    prog = _cell(name, shape)("cpu", 0, smoke_sizes(name, shape))
    # copies: a train step updates the port's parameters in place, and
    # JAX may read a host buffer it was given after that
    tree = {}
    for n, p in prog.args[0].named_parameters():
        convert._set_jax_leaf(tree, n, jnp.array(p.detach().numpy(),
                                                 copy=True))
    batch = prog.args[1]
    jb = {k: _i32(v) if v.dtype == torch.int64
          else jnp.array(v.numpy(), copy=True) for k, v in batch.items()}
    return prog, tree, jb, J_REGISTRY[name].make_smoke()


@pytest.mark.parametrize("name,shape,jmod", [
    ("dlrm-mlperf", "serve_p99", jdlrm),
    ("two-tower-retrieval", "serve_bulk", jtt)])
def test_recsys_serve_cell_matches_jax(name, shape, jmod):
    prog, jp, jb, jc = _recsys(name, shape)
    got = prog.fn(*prog.args)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jmod.serve_step(jp, jb, jc)), **OUT)


@pytest.mark.parametrize("name,jmod", [("two-tower-retrieval", jtt),
                                       ("bert4rec", jbert)])
def test_recsys_retrieval_cell_matches_jax(name, jmod):
    """The top 100 of the candidates: values within the bar, ids equal
    or equal in the candidates' scores rank by rank."""
    prog, jp, jb, jc = _recsys(name, "retrieval_cand")
    vals, ids = prog.fn(*prog.args)
    jvals, jids = jmod.retrieval_step(jp, jb, jc)
    assert ids.shape == (1, 100)
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), **OUT)
    # a rank whose id differs holds a tie: its neighbour's equal score
    v = vals.numpy()[0]
    for r in np.flatnonzero(ids.numpy()[0] != np.asarray(jids)[0]):
        near = [abs(v[r] - v[j]) for j in (r - 1, r + 1) if 0 <= j < 100]
        assert min(near) <= 1e-6, (r, v[r])


@pytest.mark.parametrize("name,jmod,kw", [
    ("dlrm-mlperf", jdlrm, {}), ("bert4rec", jbert, {"sampled": True})])
def test_recsys_train_cell_matches_jax(name, jmod, kw):
    """One step of the cell (AdamW, total_steps 10,000: lr_t 3e-6 at the
    warmup's first step): the loss and every parameter after it."""
    prog, jp, jb, jc = _recsys(name, "train_batch")
    jo = jopt.adamw(total_steps=10000)
    new_jp, _, jout = jax.jit(jmod.make_train_step(jc, jo, **kw))(
        jp, jo.init(jp), jb)
    got = prog.fn(*prog.args)
    np.testing.assert_allclose(float(got["loss"]), float(jout["loss"]),
                               **LOSS)
    for n, p in prog.args[0].named_parameters():
        np.testing.assert_allclose(
            p.detach().numpy(), np.asarray(convert._jax_leaf(new_jp, n)),
            err_msg=n, **STEPS)


@pytest.mark.parametrize("shape", ["molecule", "ogb_products"])
def test_dimenet_train_cell_matches_jax(shape):
    prog, jp, jb, _ = _recsys("dimenet", shape)
    c = smoke_sizes("dimenet", shape).config
    jc = dataclasses.replace(jdimenet_cfg.smoke_config(),
                             d_node_feat=c.d_node_feat,
                             n_targets=c.n_targets)
    jo = jopt.adamw(total_steps=10000)
    new_jp, _, jout = jax.jit(jdn.make_train_step(jc, jo))(
        jp, jo.init(jp), jb)
    got = prog.fn(*prog.args)
    np.testing.assert_allclose(float(got["loss"]), float(jout["loss"]),
                               **LOSS)
    for n, p in prog.args[0].named_parameters():
        np.testing.assert_allclose(
            p.detach().numpy(), np.asarray(convert._jax_leaf(new_jp, n)),
            err_msg=n, **STEPS)
