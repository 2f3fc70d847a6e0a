"""BERT4Rec's sharded top-n and DimeNet's edge-partitioned forward, in
gloo ranks, against the JAX package.

8 ranks on the (2, 4) ("data", "model") mesh, each model from a JAX
parameter tree (``convert.recsys_params_from_numpy``) placed by its
``param_pspecs``.  BERT4Rec's sharded ``serve_step`` (catalogue rows over
"model", local top-n, candidates all-gathered) against the JAX and the
port's single-device scans at a vocabulary that is a multiple of the
chunk, so both routes score every row (ROADMAP.md §C item 8): scores
``atol=1e-4``, items identical or scoring the same; and with every row
tied, the lowest ids, as the single-device routes give them.  (The
reference's own sharded ``serve_step`` fails on this JAX, ROADMAP.md §C
item 7.)  DimeNet's ``forward_sharded`` on 8 equal edge partitions
(``configs/dimenet_cfg.partitioned_batch``, triplet indices local to
their partition): predictions and the loss's gradients against JAX's
``forward_sharded`` on 8 fake devices and against the single-device
forward on the globalized indices (``rtol=1e-4, atol=1e-5``), one AdamW
step against the port's single-device step.  JAX's sharded gradient is
the single-device one (no multiple), and so is the port's.
"""
import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import bert4rec_cfg as jbcfg
from repro.configs import dimenet_cfg as jdcfg
from repro.data import graph_sampler as jgs
from repro.models import bert4rec as jbert4rec
from repro.models import dimenet as jdimenet
from repro_torch import convert
from repro_torch.configs import bert4rec_cfg, dimenet_cfg
from repro_torch.data import graph_sampler as tgs
from repro_torch.models import bert4rec, dimenet
from repro_torch.optim import optimizers
from torch_ranks import run_jax, run_ranks, started

MESH, NAMES = [2, 4], ["data", "model"]
TOL = dict(rtol=1e-4, atol=1e-5)
TOP_N, CHUNK, USERS = 10, 64, 16

JAX_SCRIPT = r"""
import pickle, sys
import numpy as np
from repro import compat
import jax, jax.numpy as jnp
from repro.configs import bert4rec_cfg, dimenet_cfg
from repro.models import bert4rec, dimenet
from repro.parallel.sharding import ShardingRules
mesh = jax.make_mesh((2, 4), ("data", "model"))
rules = ShardingRules(batch=("data",), fsdp=("data",))
d = np.load(INPUTS)
out = {}
tree = lambda t: jax.tree.map(lambda x: np.array(x, copy=True), t)
params = {k: jax.tree.map(jnp.asarray, pickle.load(open(v, "rb")))
          for k, v in PARAMS.items()}

bc = bert4rec_cfg.smoke_config()
ids = {"ids": jnp.asarray(d["ids"], jnp.int32)}
for name in ("bert4rec", "bert4rec_ties"):
    v, i = bert4rec.serve_step(params[name], ids, bc, top_n=TOP_N,
                               vocab_chunk=CHUNK)
    out[name] = {"vals": np.asarray(v), "ids": np.asarray(i)}

dc = dimenet_cfg.smoke_config()
dp = params["dimenet"]
local = {k[6:]: jnp.asarray(d[k]) for k in d.files if k.startswith("local_")}
whole = {k[6:]: jnp.asarray(d[k]) for k in d.files if k.startswith("whole_")}
with compat.set_mesh(mesh):
    pred = jax.jit(lambda p, b: dimenet.forward_sharded(p, b, dc, mesh,
                                                        rules))(dp, local)
    grads = jax.jit(jax.grad(lambda p: dimenet.loss_fn(p, local, dc, mesh,
                                                       rules)))(dp)
out["dimenet"] = {"pred": np.asarray(pred),
                  "grads": tree(grads),
                  "single": np.asarray(dimenet.forward(dp, whole, dc)),
                  "single_grads": tree(jax.grad(
                      lambda p: dimenet.loss_fn(p, whole, dc))(dp))}
pickle.dump(out, open(sys.argv[1], "wb"))
"""


@pytest.fixture(autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _fields(c):
    return {f.name: getattr(c, f.name) for f in dataclasses.fields(c)
            if f.name != "dtype"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("models")
    bc = bert4rec_cfg.smoke_config()
    assert bc.vocab % CHUNK == 0            # both routes score every row
    rng = np.random.default_rng(0)
    ids = rng.integers(2, bc.vocab, (USERS, bc.seq_len))
    ids[0, :5] = 0                                   # padding
    local, whole = dimenet_cfg.partitioned_batch(
        dimenet_cfg.SMOKE_CELLS["molecule"], 8, seed=3, device="cpu")
    inputs = str(d / "inputs.npz")
    np.savez(inputs, ids=ids,
             **{f"local_{k}": v.numpy() for k, v in local.items()},
             **{f"whole_{k}": v.numpy() for k, v in whole.items()})
    # the JAX parameter trees: BERT4Rec's, the same with every row tied,
    # DimeNet's
    bp = jbert4rec.init_params(jbcfg.smoke_config(), jax.random.PRNGKey(1))
    trees = {"bert4rec": bp,
             "bert4rec_ties": dict(bp, item_emb=jnp.broadcast_to(
                 bp["item_emb"][2:3], bp["item_emb"].shape),
                 out_bias=jnp.zeros_like(bp["out_bias"])),
             "dimenet": jdimenet.init_params(jdcfg.smoke_config(),
                                             jax.random.PRNGKey(2))}
    paths = {}
    for name, tree in trees.items():
        paths[name] = str(d / f"{name}.pkl")
        with open(paths[name], "wb") as f:
            pickle.dump(jax.tree.map(lambda x: np.array(x, copy=True), tree),
                        f)
    dc = dimenet_cfg.make_config("molecule", smoke=True)
    got = started(run_ranks, "sharded_models", 8, d, {
        "mesh": MESH, "names": NAMES, "inputs": inputs,
        "bert4rec": [{"name": n, "config": _fields(bc), "params": paths[n],
                      "top_n": TOP_N, "vocab_chunk": CHUNK}
                     for n in ("bert4rec", "bert4rec_ties")],
        "dimenet": {"config": _fields(dc), "params": paths["dimenet"],
                    "lr": 1e-3}})
    want = run_jax(JAX_SCRIPT.replace("INPUTS", repr(inputs))
                   .replace("PARAMS", repr(paths))
                   .replace("TOP_N", str(TOP_N)).replace("CHUNK", str(CHUNK)),
                   d, 8)
    for name, tree in trees.items():
        want[name]["params"] = jax.tree.map(np.asarray, tree)
    return want, got(), ids, _dimenet_single(want["dimenet"]["params"],
                                             whole)


def _bert4rec_single(tree, ids):
    c = bert4rec_cfg.smoke_config()
    model = convert.recsys_params_from_numpy("bert4rec", tree, c, "cpu")
    vals, idx = bert4rec.serve_step(model, {"ids": torch.from_numpy(ids)},
                                    c, top_n=TOP_N, vocab_chunk=CHUNK)
    with torch.no_grad():
        q = bert4rec.encoder(model, torch.from_numpy(ids), c)[:, -1, :]
        scores = (q @ model.item_emb.T + model.out_bias).numpy()
    return vals.numpy(), idx.numpy(), scores


def _same_or_equivalent(ids, want_ids, want_vals, scores):
    """Each item the reference's, or one scoring as the reference's item
    at that rank does (within 1e-4)."""
    same = ids == want_ids
    alt = np.abs(np.take_along_axis(scores, ids.astype(np.int64), 1)
                 - want_vals) <= 1e-4
    assert np.all(same | alt), np.argwhere(~(same | alt))
    return int(same.sum())


def test_bert4rec_sharded_top_n_matches_the_single_device_routes(runs):
    want, got, ids, _ = runs
    vals, idx, scores = _bert4rec_single(want["bert4rec"]["params"], ids)
    np.testing.assert_allclose(vals, want["bert4rec"]["vals"], atol=1e-4)
    for r in got:
        v, i, placements = r["bert4rec"]
        assert placements == ["S(0)", "R"]     # users over "data"
        np.testing.assert_allclose(v, want["bert4rec"]["vals"], atol=1e-4)
        np.testing.assert_allclose(v, vals, atol=1e-4)
        assert _same_or_equivalent(i, want["bert4rec"]["ids"],
                                   want["bert4rec"]["vals"], scores) \
            >= 0.9 * i.size
        _same_or_equivalent(i, idx, vals, scores)


def test_bert4rec_sharded_ties_keep_the_lowest_global_id(runs):
    """Every row scoring the same: the merge keeps the lower shard's
    candidates first, so the n lowest ids, as both scans give them."""
    want, got, ids, _ = runs
    _, idx, _ = _bert4rec_single(want["bert4rec_ties"]["params"], ids)
    lowest = np.broadcast_to(np.arange(TOP_N), (USERS, TOP_N))
    np.testing.assert_array_equal(want["bert4rec_ties"]["ids"], lowest)
    np.testing.assert_array_equal(idx, lowest)
    for r in got:
        np.testing.assert_array_equal(r["bert4rec_ties"][1], lowest)


def _dimenet_single(tree, whole):
    c = dimenet_cfg.make_config("molecule", smoke=True)
    model = convert.recsys_params_from_numpy("dimenet", tree, c, "cpu")
    with torch.no_grad():
        pred = dimenet.forward(model, whole, c).numpy()
    loss = dimenet.loss_fn(model, whole, c)
    loss.backward()
    grads = {k: p.grad.numpy().copy() for k, p in model.named_parameters()
             if p.grad is not None}
    opt = optimizers.adamw(model.parameters(), lr=1e-3, warmup_steps=1)
    step_loss = float(dimenet.make_train_step(c, opt)(model, whole)["loss"])
    return {"pred": pred, "loss": float(loss.detach()), "grads": grads,
            "step_loss": step_loss, "gnorm": float(opt.last_gnorm),
            "params": {k: p.detach().numpy()
                       for k, p in model.named_parameters()}}


def _jax_leaves(tree):
    return {k: np.asarray(convert._jax_leaf(tree, k))
            for k in dict(dimenet.DimeNet(
                dimenet_cfg.make_config("molecule", smoke=True),
                "cpu").named_parameters())}


def test_dimenet_forward_sharded_matches_jax_and_single_device(runs):
    want, got, _, single = runs
    np.testing.assert_allclose(want["dimenet"]["pred"],
                               want["dimenet"]["single"], **TOL)
    for r in got:
        np.testing.assert_allclose(r["dimenet"]["pred"],
                                   want["dimenet"]["pred"], **TOL)
        np.testing.assert_allclose(r["dimenet"]["pred"], single["pred"],
                                   **TOL)
        np.testing.assert_allclose(r["dimenet"]["loss"], single["loss"],
                                   **TOL)


def test_dimenet_sharded_gradients_are_the_single_device_ones(runs):
    """JAX's ``forward_sharded`` gradient equals its single-device one (no
    multiple of it), and the port's sharded gradient equals both."""
    want, got, _, single = runs
    jg = _jax_leaves(want["dimenet"]["grads"])
    js = _jax_leaves(want["dimenet"]["single_grads"])
    g = got[0]["dimenet"]["grads"]
    assert set(g) == set(single["grads"]) == set(jg) - {"head"}
    for k in g:
        scale = max(1.0, float(np.max(np.abs(js[k]))))
        np.testing.assert_allclose(jg[k], js[k], rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=k)
        np.testing.assert_allclose(g[k], jg[k], rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=k)
        np.testing.assert_allclose(g[k], single["grads"][k], rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=k)
    assert not np.any(jg["head"])


def test_dimenet_sharded_step_matches_the_single_device_step(runs):
    want, got, _, single = runs
    for r in got:
        np.testing.assert_allclose(r["dimenet"]["step_loss"],
                                   single["step_loss"], **TOL)
        np.testing.assert_allclose(r["dimenet"]["gnorm"], single["gnorm"],
                                   rtol=1e-5)
        for k, v in single["params"].items():
            np.testing.assert_allclose(r["dimenet"]["params"][k], v,
                                       rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("parts", [1, 4, 8])
def test_partition_triplets_are_build_triplets_and_stay_local(parts):
    """``partition_triplets`` gives the reference's ``build_triplets``
    bit for bit and says where each partition's triplets end; every
    index lies in its own partition."""
    _, _, src, dst, _ = tgs.molecule_batch(4, 10, 24, seed=parts)
    kj, ji, counts = tgs.partition_triplets(src, dst, parts, seed=parts)
    jkj, jji = jgs.build_triplets(src, dst, n_partitions=parts, seed=parts)
    np.testing.assert_array_equal(kj, jkj)
    np.testing.assert_array_equal(ji, jji)
    assert counts.sum() == len(kj) and len(counts) == parts
    assert int(max(kj.max(), ji.max())) < len(src) // parts


def test_partitioned_batch_globalizes_each_partition():
    g = dimenet_cfg.SMOKE_CELLS["molecule"]
    local, whole = dimenet_cfg.partitioned_batch(g, 4, seed=5, device="cpu")
    e = g["n_edges"] // 4
    t = local["tri_kj"].shape[0] // 4
    for k in ("tri_kj", "tri_ji"):
        lo = local[k].view(4, t)
        assert int(lo.max()) < e
        np.testing.assert_array_equal(
            whole[k].view(4, t).numpy(),
            (lo + torch.arange(4)[:, None] * e).numpy())
    for k in ("edge_src", "edge_dst", "dist", "angle", "z", "labels"):
        assert torch.equal(local[k], whole[k]), k
    # each partition's first edge is a ghost at the cutoff
    assert torch.all(whole["dist"][::e] == dimenet.DimeNetConfig.cutoff)
