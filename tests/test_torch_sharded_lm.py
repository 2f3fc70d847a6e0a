"""The port's sharded LM execution against the JAX package, in gloo ranks.

``parallel/spmd.py``'s collectives, layouts and ``shard_map`` on the (2,
4) ("data", "model") mesh (8 ranks) against numpy, gradients included
(JAX's transposes: ``psum`` → identity, ``pvary`` → ``psum``,
``all_gather`` ↔ ``psum_scatter``; a constraint's gradient the reverse
move).  The layout rules ``_bspec`` / ``_hspec`` / ``_head_spec``
against the reference's on the (2, 4) test mesh and the production
meshes.  The expert-parallel ``moe_block`` on DTensors placed as
``tests/test_distributed.py::test_sharded_moe_matches_local`` places
them, forward and the gradients of ``sum(sin(out))``, against JAX's
sharded ``moe_block`` on 8 fake devices at ``capacity_factor`` 4.0 (no
drop: equal to the local route) and 1.0 (assignments dropped per data
shard), within that test's ``1e-4``.  Then the granite, qwen2-moe,
DeepSeek (MLA, MTP) and gemma3 (windows) smoke models, their parameters
placed by ``param_pspecs``: the sharded forward and prefill against the
JAX single-device route (the reference's own sharded train step fails
on this JAX, ROADMAP.md §C item 7), decode and step-1 gradients against
the port's single-device route (held to JAX's by
``tests/test_torch_transformer.py`` and ``tests/test_torch_lm_train.py``),
and 3 AdamW steps (remat "full", and "dots" once) against the JAX and
the port's single-device steps at the training tests' bars (losses
``rtol=1e-5, atol=1e-6``, gradients ``rtol=1e-4, atol=1e-6``,
parameters ``rtol=1e-5, atol=1e-5``), the clip's norm the whole
gradient's; one row served where the data axis does not divide the
batch.  The MoE configs run at ``capacity_factor`` 4.0 there: under a
mesh the capacity comes from each data shard's tokens, so only a factor
that drops nothing gives the single-device answer.
"""
import dataclasses
import pickle
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import deepseek_v3_671b as jds
from repro.configs import gemma3_27b as jgem
from repro.configs import granite_3_2b as jgranite
from repro.configs import qwen2_moe_a2_7b as jqwen
from repro.launch import mesh as jmesh
from repro.models import transformer as jtf
from repro.optim import optimizers as jopt
from repro.parallel import sharding as js
from repro_torch import convert
from repro_torch.launch import mesh as tmesh
from repro_torch.models import transformer as tf
from repro_torch.optim import optimizers
from repro_torch.parallel import sharding as ts
from torch_ranks import run_jax, run_ranks, started

MESH, NAMES = [2, 4], ["data", "model"]
LOSS = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
STEPS = dict(rtol=1e-5, atol=1e-5)
# the sharded route's sums run in another order: f32 rounding only
VALUES = dict(rtol=1e-5, atol=1e-5)
# decode reads the bf16 caches, where K or V computed in another order
# may round to the neighbouring bf16 value (2^-8 of it)
DECODE = dict(rtol=1e-4, atol=1e-4)
LR, N_STEPS, B, S, N_DECODE = 3e-6, 3, 2, 16, 3
# name: (JAX config module, port config changes, seed); "dots" takes
# granite's weights and batch, so granite's single-device runs hold it
CASES = {"granite": (jgranite, {}, 0), "qwen2_moe": (jqwen, {}, 1),
         "deepseek": (jds, {}, 2), "gemma3": (jgem, {}, 3),
         "granite_dots": (jgranite, {"remat_policy": "dots"}, 0)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# parallel/spmd.py
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def spmd_runs(tmp_path_factory):
    return run_ranks("spmd", 8, tmp_path_factory.mktemp("spmd"),
                     {"mesh": MESH, "names": NAMES})


def _x(rank):
    return np.arange(24, dtype=np.float64).reshape(4, 6) + 100 * rank


def test_axis_index_is_the_rank_s_mesh_coordinate(spmd_runs):
    for r, got in enumerate(spmd_runs):
        assert got["index"] == {"data": r // 4, "model": r % 4, "both": r}


def test_psum_sums_and_passes_its_cotangent_through(spmd_runs):
    for r, got in enumerate(spmd_runs):
        y, dx = got["psum"]
        group = [r // 4 * 4 + m for m in range(4)]
        np.testing.assert_array_equal(y, sum(_x(q) for q in group))
        np.testing.assert_array_equal(dx, np.full((4, 6), r + 1.0))


def test_pvary_is_the_identity_whose_gradient_is_a_psum(spmd_runs):
    w = np.arange(24, dtype=np.float64).reshape(4, 6)
    for r, got in enumerate(spmd_runs):
        y, dx = got["pvary"]
        np.testing.assert_array_equal(y, _x(r))
        np.testing.assert_array_equal(dx, w * sum(q + 1 for q in range(8)))


def test_all_gather_and_psum_scatter_are_each_other_s_transpose(spmd_runs):
    for r, got in enumerate(spmd_runs):
        group = [r // 4 * 4 + m for m in range(4)]
        y, dx = got["all_gather"]
        np.testing.assert_array_equal(
            y, np.concatenate([_x(q) for q in group], axis=1))
        weight = np.arange(96, dtype=np.float64).reshape(4, 24)
        m = r % 4
        np.testing.assert_array_equal(
            dx, sum(weight * (q + 1) for q in group)[:, 6 * m:6 * m + 6])
        y, dx = got["psum_scatter"]
        d = r // 4
        np.testing.assert_array_equal(
            y, (_x(r % 4) + _x(r % 4 + 4))[2 * d:2 * d + 2])
        np.testing.assert_array_equal(
            dx, np.concatenate([np.full((2, 6), r % 4 + 1.0),
                                np.full((2, 6), r % 4 + 5.0)]))


def test_redistribute_moves_blocks_and_its_gradient_moves_back(spmd_runs):
    g = np.arange(64, dtype=np.float64).reshape(8, 8)
    for r, got in enumerate(spmd_runs):
        d, m = r // 4, r % 4
        moved, grad = got["redistribute"]
        np.testing.assert_array_equal(moved, g[2 * m:2 * m + 2])
        # the reverse move: the rank's data group's blocks of the
        # cotangent (weights d·4 + m' + 1) gathered, then its own block
        cot = np.zeros((8, 8))
        for mm in range(4):
            cot[2 * mm:2 * mm + 2] = 4 * d + mm + 1
        np.testing.assert_array_equal(
            grad, cot[4 * d:4 * d + 4, 2 * m:2 * m + 2])


def test_constrain_shard_map_and_gather_full(spmd_runs):
    g = np.arange(64, dtype=np.float64).reshape(8, 8)
    for r, got in enumerate(spmd_runs):
        block, placements, identity = got["constrain"]
        np.testing.assert_array_equal(block, g[r:r + 1])
        assert placements == ["S(0)", "S(0)"] and identity
        assert got["spec_of"] == (None, ("data", "model"))
        np.testing.assert_array_equal(got["gather_full"], g)
        r_sum, prod = got["shard_map"]
        np.testing.assert_array_equal(r_sum, g.sum(0, keepdims=True))
        np.testing.assert_array_equal(prod, g * np.arange(8)[None, :])


# ---------------------------------------------------------------------------
# the layout rules
# ---------------------------------------------------------------------------

LAYOUT_MESHES = [((2, 4), ("data", "model")), ((16, 16), ("data", "model")),
                 ((2, 16, 16), ("pod", "data", "model"))]
RULES = [("default", jmesh.make_rules(), tmesh.make_rules()),
         ("data_only", js.ShardingRules(batch=("data",), fsdp=("data",)),
          ts.ShardingRules(batch=("data",), fsdp=("data",)))]


@pytest.mark.parametrize("rules", RULES, ids=[r[0] for r in RULES])
@pytest.mark.parametrize("mesh", LAYOUT_MESHES,
                         ids=["x".join(map(str, m[0])) for m in LAYOUT_MESHES])
def test_layout_specs_are_the_reference_s(mesh, rules):
    shape, names = mesh
    jm = types.SimpleNamespace(axis_names=names,
                               devices=np.empty(shape, object))
    tm = ts.MeshShape(names, shape)
    _, jr, tr = rules
    for batch in (1, 2, 3, 4, 8, 32, 256, 512):
        for extra in (0, 1, 2):
            assert tf._bspec(tm, tr, batch, extra) == \
                ts.Spec(*jtf._bspec(jm, jr, batch, extra)), (batch, extra)
    for batch, seq in ((4, 4096), (4, 1), (1, 32768), (3, 7), (16, 16),
                       (256, 2048), (32, 8)):
        assert tf._hspec(tm, tr, batch, seq) == \
            ts.Spec(*jtf._hspec(jm, jr, batch, seq)), (batch, seq)
    for batch, heads in ((4, 32), (4, 8), (2, 96), (8, 16), (512, 128),
                         (1, 3)):
        assert tf._head_spec(tm, tr, batch, heads) == \
            ts.Spec(*jtf._head_spec(jm, jr, batch, heads)), (batch, heads)


# ---------------------------------------------------------------------------
# the expert-parallel MoE against JAX's sharded moe_block
# ---------------------------------------------------------------------------

MOE_CONFIG = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
                  d_ff=128, vocab_size=97, moe=True, n_experts=8,
                  n_shared_experts=0, top_k=2, moe_d_ff=32)
MOE_SPECS = {"router": [None, None], "we_gate": ["model", "data", None],
             "we_up": ["model", "data", None],
             "we_down": ["model", None, "data"]}
FACTORS = (4.0, 1.0)

MOE_JAX = r"""
import pickle, sys
import numpy as np
from repro import compat
import jax, jax.numpy as jnp
from repro.parallel.sharding import ShardingRules
from repro.models.transformer import TransformerConfig, moe_block
mesh = jax.make_mesh((2, 4), ("data", "model"))
rules = ShardingRules(batch=("data",), fsdp=("data",))
d = np.load(INPUTS)
x = jnp.asarray(d["x"])
layer = {k: jnp.asarray(d[k]) for k in ("router", "we_gate", "we_up",
                                        "we_down")}
out = {}
for cf in FACTORS:
    c = TransformerConfig(**CONFIG, capacity_factor=cf, dtype=jnp.float32)
    f = lambda x, l: jnp.sum(jnp.sin(moe_block(x, l, c, mesh, rules)))
    with compat.set_mesh(mesh):
        y = jax.jit(lambda x, l: moe_block(x, l, c, mesh, rules))(x, layer)
        gx, gl = jax.jit(jax.grad(f, argnums=(0, 1)))(x, layer)
    out[cf] = {"out": np.asarray(y),
               "local": np.asarray(moe_block(x, layer, c, None, None)),
               "grads": {"x": np.asarray(gx),
                         **{k: np.asarray(v) for k, v in gl.items()}}}
pickle.dump(out, open(sys.argv[1], "wb"))
"""


@pytest.fixture(scope="module")
def moe_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("moe")
    rng = np.random.default_rng(0)
    # 128 tokens a data shard: at factor 1.0 the capacity (32) drops
    arrays = {"x": rng.normal(size=(4, 64, 64)),
              "router": rng.normal(size=(64, 8)) * 0.1,
              "we_gate": rng.normal(size=(8, 64, 32)) * 0.1,
              "we_up": rng.normal(size=(8, 64, 32)) * 0.1,
              "we_down": rng.normal(size=(8, 32, 64)) * 0.1}
    path = str(d / "inputs.npz")
    np.savez(path, **{k: v.astype(np.float32) for k, v in arrays.items()})
    script = (MOE_JAX.replace("INPUTS", repr(path))
              .replace("CONFIG", repr(MOE_CONFIG))
              .replace("FACTORS", repr(FACTORS)))
    got = started(run_ranks, "sharded_moe", 8, d, {
        "mesh": MESH, "names": NAMES, "inputs": path, "config": MOE_CONFIG,
        "factors": list(FACTORS), "specs": MOE_SPECS,
        "x_spec": ["data", None, None]})
    want = run_jax(script, d, 8)
    return want, got()


@pytest.mark.parametrize("cf", FACTORS)
def test_ep_moe_block_matches_jax_sharded_forward(moe_runs, cf):
    want, got = moe_runs
    for r in got:
        assert float(np.max(np.abs(r[cf]["out"] - want[cf]["out"]))) < 1e-4


@pytest.mark.parametrize("cf", FACTORS)
def test_ep_moe_block_matches_jax_sharded_gradients(moe_runs, cf):
    want, got = moe_runs
    for k, w in want[cf]["grads"].items():
        err = float(np.max(np.abs(got[0][cf]["grads"][k] - w)))
        assert err < 1e-4 * max(1.0, float(np.max(np.abs(w)))), (k, err)


def test_capacity_is_per_data_shard(moe_runs):
    """At 4.0 nothing drops and the sharded route is the local one; at
    1.0 the shards drop assignments and the answer moves off it."""
    want, got = moe_runs
    assert sum(sum(r[4.0]["dropped"]) for r in got) == 0
    assert float(np.max(np.abs(want[4.0]["out"] - want[4.0]["local"]))) \
        < 1e-4
    assert sum(sum(r[1.0]["dropped"]) for r in got) > 0
    assert float(np.max(np.abs(want[1.0]["out"] - want[1.0]["local"]))) \
        > 1e-3


# ---------------------------------------------------------------------------
# the sharded LM against the single-device routes
# ---------------------------------------------------------------------------

def _port_config(jc, **kw):
    fields = {f.name for f in dataclasses.fields(tf.TransformerConfig)}
    args = {n: getattr(jc, n) for n in fields if n != "dtype"}
    args.update(kw)
    return args


def _jax_config(name):
    module, kw, _ = CASES[name]
    jc = module.smoke_config()
    if jc.moe:
        # no drop: the capacity is per data shard under a mesh
        jc = dataclasses.replace(jc, capacity_factor=4.0)
    return jc, kw


def _inputs(jc, seed, b=B):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jc.vocab_size, (b, S + 1))
    toks[:, 2::2] = toks[:, 1:-1:2]
    labels = toks[:, 1:].copy()
    labels[0, 5] = -1                                # a masked label
    return {"tokens": toks[:, :-1], "labels": labels,
            "next": rng.integers(0, jc.vocab_size, (b, N_DECODE))}


def _jax_single(jc, jp, data):
    """The JAX single-device route: hidden states, prefill logits, 3
    jitted AdamW steps."""
    tokens = jnp.asarray(data["tokens"], jnp.int32)
    out = {"hidden": np.asarray(jax.jit(
        lambda p, t: jtf.forward(p, t, jc)[0])(jp, tokens))}
    logits, _ = jax.jit(lambda p, t: jtf.prefill(
        p, t, jc, S + N_DECODE + 1))(jp, tokens)
    out["prefill"] = np.asarray(logits)
    jb = {k: jnp.asarray(data[k], jnp.int32) for k in ("tokens", "labels")}
    jo = jopt.adamw(lr=LR, warmup_steps=1)
    jstep, js_, p = jax.jit(jtf.make_train_step(jc, jo)), None, jp
    js_ = jo.init(p)
    out["losses"] = []
    for _ in range(N_STEPS):
        p, js_, m = jstep(p, js_, jb)
        out["losses"].append(float(m["loss"]))
    out["params"] = jax.tree.map(np.asarray, p)
    return out


def _port_single(c, tree, data, train=True, max_len=S + N_DECODE + 1):
    """The port's single-device route: hidden states, prefill and decode
    logits, and with ``train`` step-1 gradients, the steps' losses and
    pre-clip norms."""
    model = convert.transformer_params_from_numpy(
        tree, tf.TransformerConfig(**c, dtype=torch.float32), device="cpu")
    tokens = torch.from_numpy(data["tokens"])
    out = {"decode": []}
    with torch.no_grad():
        out["hidden"] = model(tokens)[0].numpy()
        logits, caches = model.prefill(tokens, max_len)
        out["prefill"] = logits.numpy()
        for i in range(N_DECODE):
            logits, caches = model.decode_step(caches, torch.from_numpy(
                data["next"][:, i:i + 1]), S + i)
            out["decode"].append(logits.numpy())
    if not train:
        return out
    batch = {k: torch.from_numpy(data[k]) for k in ("tokens", "labels")}
    tf.lm_loss(model, batch, model.config).backward()
    out["grads"] = {k: p.grad.numpy().copy()
                    for k, p in model.named_parameters()}
    opt = optimizers.adamw(model.parameters(), lr=LR, warmup_steps=1)
    step = tf.make_train_step(model.config, opt)
    losses, norms = [], []
    for _ in range(N_STEPS):
        losses.append(float(step(model, batch)["loss"]))
        norms.append(float(opt.last_gnorm))
    return {**out, "losses": losses, "gnorms": norms}


@pytest.fixture(scope="module")
def lm_runs(tmp_path_factory):
    """The ranks run while this process runs the single-device routes."""
    d = tmp_path_factory.mktemp("lm")
    cases, want, single, first = [], {}, {}, {}
    for name, (module, _, seed) in CASES.items():
        jc, kw = _jax_config(name)
        jp = jtf.init_params(jc, jax.random.PRNGKey(seed))
        tree = jax.tree.map(lambda x: np.array(x, copy=True), jp)
        data = _inputs(jc, seed)
        params, inputs = str(d / f"{name}.pkl"), str(d / f"{name}.npz")
        with open(params, "wb") as f:
            pickle.dump(tree, f)
        np.savez(inputs, **data)
        config = _port_config(jc, **kw)
        cases.append({"name": name, "config": config, "params": params,
                      "inputs": inputs, "max_len": S + N_DECODE + 1,
                      "steps": N_STEPS,
                      "opt": {"lr": LR, "warmup_steps": 1}})
        first.setdefault((module, seed), (name, jc, jp, data, config, tree))
    # serving one row: the data axis does not divide the batch, its
    # tokens do (the MoE splits them), and decode replicates them
    _, _, _, _, q_config, q_tree = first[(jqwen, 1)]
    one = _inputs(jqwen.smoke_config(), 11, b=1)
    np.savez(str(d / "one_row.npz"), **one)
    cases.append({"name": "one_row", "config": q_config,
                  "params": str(d / "qwen2_moe.pkl"),
                  "inputs": str(d / "one_row.npz"),
                  # the cache's L is split over both axes when B is not
                  "max_len": 24, "steps": 0})
    ranks = started(run_ranks, "sharded_lm", 8, d,
                    {"mesh": MESH, "names": NAMES, "cases": cases})
    try:
        for name, jc, jp, data, config, tree in first.values():
            want[name] = _jax_single(jc, jp, data)
            single[name] = _port_single(config, tree, data)
        single["one_row"] = _port_single(q_config, q_tree, one, train=False,
                                         max_len=24)
    finally:
        got = ranks()
    for name, (module, _, seed) in CASES.items():
        done = first[(module, seed)][0]
        want[name], single[name] = want[done], single[done]
    return want, single, got


def _named_leaves(tree):
    """A JAX parameter tree's leaves by the port's parameter names (each
    layer of a stacked group)."""
    out = {}
    n_dense = tree["dense_layers"]["ln1"].shape[0] \
        if "dense_layers" in tree else 0
    for key, v in tree.items():
        if key in ("dense_layers", "moe_layers"):
            lo = 0 if key == "dense_layers" else n_dense
            for leaf, stack in v.items():
                for j in range(stack.shape[0]):
                    out[f"layers.{lo + j}.{leaf}"] = stack[j]
        else:
            out[key] = v
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_forward_and_prefill_match_jax(lm_runs, name):
    want, _, got = lm_runs
    for r in got:
        np.testing.assert_allclose(r[name]["hidden"], want[name]["hidden"],
                                   **VALUES)
        np.testing.assert_allclose(r[name]["prefill"],
                                   want[name]["prefill"], **VALUES)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_decode_matches_single_device(lm_runs, name):
    """Decode steps over the caches placed by ``_cache_pspecs`` (cache
    positions split over "model", the ranks' softmax terms combined)
    against the port's single-device decode (itself held to JAX's by
    ``tests/test_torch_transformer.py``)."""
    _, single, got = lm_runs
    for r in got:
        assert len(r[name]["decode"]) == N_DECODE
        for a, b in zip(r[name]["decode"], single[name]["decode"]):
            np.testing.assert_allclose(a, b, **DECODE)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step1_gradients_match_single_device(lm_runs, name):
    """Against the port's single-device gradients (held to
    ``jax.value_and_grad`` by ``tests/test_torch_lm_train.py``)."""
    _, single, got = lm_runs
    g, want = got[0][name]["grads"], single[name]["grads"]
    assert set(g) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(g[k], v, **GRAD, err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_three_sharded_train_steps_match_single_device(lm_runs, name):
    want, single, got = lm_runs
    for r in got:
        np.testing.assert_allclose(r[name]["losses"], want[name]["losses"],
                                   **LOSS)
        np.testing.assert_allclose(r[name]["losses"],
                                   single[name]["losses"], **LOSS)
    jp = _named_leaves(want[name]["params"])
    for k, v in jp.items():
        np.testing.assert_allclose(got[0][name]["params"][k], v, **STEPS,
                                   err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_the_clip_takes_the_whole_gradient_s_norm(lm_runs, name):
    """Each step's pre-clip norm is the single-device one on every rank,
    larger than the norm of any rank's own blocks."""
    _, single, got = lm_runs
    for r in got:
        np.testing.assert_allclose(r[name]["gnorms"], single[name]["gnorms"],
                                   rtol=1e-5)
        assert r[name]["local_norm"] < r[name]["gnorms"][0] * (1 - 1e-3)


def test_one_row_serves_as_on_one_device(lm_runs):
    """B = 1 on two data ranks: replicated rows, the MoE's 16 prefill
    tokens split over "data" (the reference's ``(b·s) % n_bsh`` rule)
    and each decode token replicated; against the port's single-device
    route (no token drops at factor 4.0 either way)."""
    _, single, got = lm_runs
    for r in got:
        g = r["one_row"]
        np.testing.assert_allclose(g["hidden"], single["one_row"]["hidden"],
                                   **VALUES)
        np.testing.assert_allclose(g["prefill"],
                                   single["one_row"]["prefill"], **VALUES)
        for a, b in zip(g["decode"], single["one_row"]["decode"]):
            np.testing.assert_allclose(a, b, **DECODE)


def test_every_rank_gathers_the_same_values(lm_runs):
    _, _, got = lm_runs
    for name in CASES:
        for r in got[1:]:
            for k in ("hidden", "prefill"):
                np.testing.assert_array_equal(r[name][k], got[0][name][k])
            assert r[name]["losses"] == got[0][name]["losses"]


def test_a_sharded_loss_needs_every_axis_to_split_the_tokens():
    """Batch rows the data axis does not divide would be computed on two
    ranks and their gradients summed twice: the sharded loss refuses
    them (serving takes them, replicated)."""
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 shape=(2, 4))
    rules = ts.ShardingRules(batch=("data",), fsdp=("data",))
    assert tf._Sharded.of(mesh, rules, 3, 16).batch == ()
    assert not tf._Sharded.of(mesh, rules, 2, 6).seq
    c = tf.TransformerConfig(n_layers=1, d_model=16, n_heads=2,
                             n_kv_heads=2, d_head=8, d_ff=32,
                             vocab_size=32, dtype=torch.float32)
    toks = torch.zeros((3, 16), dtype=torch.long)
    with pytest.raises(ValueError, match="every mesh axis"):
        tf.lm_loss(None, {"tokens": toks, "labels": toks}, c, mesh, rules)
    with pytest.raises(ValueError, match="tensor axis"):
        tf._Sharded.of(mesh, ts.ShardingRules(tensor="tp"), 2, 16)
