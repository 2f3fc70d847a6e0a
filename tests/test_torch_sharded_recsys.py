"""The recommenders under a mesh, in gloo ranks, against the JAX package.

8 ranks on the (2, 4) ("data", "model") mesh (batch and FSDP over
"data"), each model from a JAX parameter tree
(``convert.recsys_params_from_numpy``) placed by its ``param_pspecs``,
the batch the global values every rank holds.  DLRM's, DeepFM's,
two-tower's and BERT4Rec's ``serve_step``, their losses and gradients,
two-tower's and BERT4Rec's ``retrieval_step`` (B3's plain version on each
rank's candidate block, the lists merged) against JAX's jitted with the
cells' ``in_shardings`` on 8 fake devices, and against the port's
one-device run; one AdamW step (its loss, gradient norm, the clipped
gradients it applied and the parameters after it) against the port's
one-device step.
BERT4Rec's JAX ``serve_step`` runs without the mesh argument (its
``shard_map`` route fails on this JAX, ROADMAP.md §C item 7): at the
smoke vocabulary its scan scores every row, as the sharded top-n does.

Bars: serving outputs ``rtol=1e-5, atol=1e-6``; top-n ids identical or
scoring the same (0 mismatches); losses ``rtol=1e-5, atol=1e-6``,
gradients ``rtol=1e-4, atol=1e-6``, parameters after a step at lr 3e-6
``rtol=1e-5, atol=1e-5`` (the training tests' bars).  Also: DLRM's table
over the tensor axis only (the layout ``common.row_axes`` gives rows that
4 divides and 8 does not; ``TableSpec`` pads rows to a multiple of 1,024,
so the case places them so by hand, in both packages); a batch of 7 rows,
which the data axis does not divide (the constraint a no-op, the outputs
replicated); two-tower's sharded loss is the global in-batch softmax, not
the mean of the data shards' own; an id out of range in one data shard's
rows raises ``InvalidIdError`` on every rank (the run's timeout is the
proof that no rank waits in a collective).
"""
import dataclasses
import pickle

import jax
import numpy as np
import pytest
import torch

from repro.configs import bert4rec_cfg as jbcfg
from repro.configs import deepfm_cfg as jfcfg
from repro.configs import dlrm_mlperf as jdcfg
from repro.configs import two_tower_retrieval as jtcfg
from repro.models import bert4rec as jbert4rec
from repro.models import deepfm as jdeepfm
from repro.models import dlrm as jdlrm
from repro.models import two_tower as jtwo_tower
from repro_torch import convert
from repro_torch.configs import (bert4rec_cfg, deepfm_cfg, dlrm_mlperf,
                                 recsys_shapes as rs, two_tower_retrieval)
from repro_torch.models import bert4rec, deepfm, dlrm, two_tower
from repro_torch.optim import optimizers
from torch_ranks import run_jax, run_ranks, started

MESH, NAMES = [2, 4], ["data", "model"]
SERVE = dict(rtol=1e-5, atol=1e-6)
LOSS = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
STEPS = dict(rtol=1e-5, atol=1e-5)
LR, TOP_N, N_CAND, B = 3e-6, 20, 128, 16

PORT = {"dlrm": (dlrm, dlrm_mlperf), "deepfm": (deepfm, deepfm_cfg),
        "two_tower": (two_tower, two_tower_retrieval),
        "bert4rec": (bert4rec, bert4rec_cfg)}
JAX = {"dlrm": (jdlrm, jdcfg), "deepfm": (jdeepfm, jfcfg),
       "two_tower": (jtwo_tower, jtcfg), "bert4rec": (jbert4rec, jbcfg)}
MAKERS = {"dlrm": rs.dlrm_batch, "deepfm": rs.deepfm_batch,
          "two_tower": rs.two_tower_batch, "bert4rec": rs.bert4rec_batch}
# the keys each step reads
SERVE_KEYS = {"dlrm": ["dense", "sparse"], "deepfm": ["sparse"],
              "two_tower": ["user_id", "history", "item_id", "item_cat"],
              "bert4rec": ["ids"]}
TRAIN_KEYS = {"dlrm": ["dense", "sparse", "labels"],
              "deepfm": ["sparse", "labels"],
              "two_tower": ["user_id", "history", "item_id", "item_cat",
                            "logq"],
              "bert4rec": ["ids", "mask_pos", "targets", "negatives"]}
QUERY_KEYS = {"two_tower": ["user_id", "history"], "bert4rec": ["ids"]}

# name: (arch, rows, what the ranks run, spec overrides, full cloze)
CASES = {
    "dlrm": ("dlrm", B, ("serve", "train", "step"), None),
    "dlrm_rows_tp": ("dlrm", B, ("serve", "train"), {"table": ["model",
                                                               None]}),
    "deepfm": ("deepfm", B, ("serve", "train", "step"), None),
    "deepfm_odd": ("deepfm", 7, ("serve", "train"), None),
    "two_tower": ("two_tower", B, ("serve", "train", "retrieval", "step"),
                  None),
    "bert4rec": ("bert4rec", B, ("serve", "train", "retrieval", "step"),
                 None),
    "bert4rec_cloze": ("bert4rec", 8, ("train",), None),
}

JAX_SCRIPT = r"""
import pickle, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import compat
from repro.configs import (bert4rec_cfg, deepfm_cfg, dlrm_mlperf,
                           two_tower_retrieval)
from repro.models import bert4rec, deepfm, dlrm, two_tower
from repro.parallel.sharding import ShardingRules
# GSPMD's mesh: Auto axes, where a sharding constraint moves data (on
# Explicit axes it asserts)
auto = getattr(jax.sharding, "AxisType", None)
mesh = jax.make_mesh((2, 4), ("data", "model"), **(
    {"axis_types": (auto.Auto, auto.Auto)} if auto else {}))
rules = ShardingRules(batch=("data",), fsdp=("data",))
SPEC = SPECS
mods = {"dlrm": (dlrm, dlrm_mlperf), "deepfm": (deepfm, deepfm_cfg),
        "two_tower": (two_tower, two_tower_retrieval),
        "bert4rec": (bert4rec, bert4rec_cfg)}
host = lambda t: jax.tree.map(lambda x: np.array(x, copy=True), t)
named = lambda t: jax.tree.map(lambda s: NamedSharding(mesh, s), t,
                               is_leaf=lambda x: isinstance(x, P))
out = {}
for name, (arch, what, override, cloze) in SPEC.items():
    m, cfg = mods[arch]
    c = cfg.smoke_config()
    params = jax.tree.map(jnp.asarray, pickle.load(open(PARAMS[arch], "rb")))
    ps = m.param_pspecs(c, mesh, rules)
    for k, v in (override or {}).items():
        ps[k] = P(*v)
    d = np.load(INPUTS[name])
    def leaf(k):
        x = d[k]
        return jnp.asarray(x, jnp.int32 if x.dtype.kind == "i" else x.dtype)
    batch = {k: leaf(k) for k in d.files}
    n = batch[list(batch)[0]].shape[0]
    bax = ("data",) if n % 2 == 0 else None
    def bs(keys):
        return {k: P(*([None] * batch[k].ndim)) if k == "negatives"
                else P(bax, *([None] * (batch[k].ndim - 1))) for k in keys}
    kw = {"mesh": mesh, "rules": rules}
    got = {}
    with compat.set_mesh(mesh):
        if "serve" in what:
            keys = SERVE_KEYS[arch]
            sub = {k: batch[k] for k in keys}
            if arch == "bert4rec":
                f = lambda p, b: bert4rec.serve_step(p, b, c)
            else:
                f = lambda p, b: m.serve_step(p, b, c, **kw)
            y = jax.jit(f, in_shardings=(named(ps), named(bs(keys))))(
                params, sub)
            got["serve"] = [np.asarray(t) for t in
                            (y if isinstance(y, tuple) else (y,))]
        if "train" in what:
            keys = ["ids", "targets"] if cloze else TRAIN_KEYS[arch]
            sub = {k: batch[k] for k in keys}
            if arch == "two_tower":
                lf = lambda p, b: two_tower.sampled_softmax_loss(p, b, c)
            elif cloze:
                lf = lambda p, b: bert4rec.cloze_loss(p, b, c)
            elif arch == "bert4rec":
                lf = lambda p, b: bert4rec.sampled_cloze_loss(p, b, c, **kw)
            else:
                lf = lambda p, b: m.loss_fn(p, b, c, **kw)
            loss, grads = jax.jit(jax.value_and_grad(lf), in_shardings=(
                named(ps), named(bs(keys))))(params, sub)
            got["loss"], got["grads"] = float(loss), host(grads)
        if "retrieval" in what:
            q = {k: batch["q_" + k] for k in QUERY_KEYS[arch]}
            q["candidates"] = batch["candidates"]
            qs = {k: P(*([None] * q[k].ndim)) for k in q}
            qs["candidates"] = P("model", None)
            v, i = jax.jit(lambda p, b: m.retrieval_step(
                p, b, c, TOP_N, **kw), in_shardings=(named(ps), named(qs)))(
                params, q)
            got["retrieval"] = (np.asarray(v), np.asarray(i))
    out[name] = got
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


def _batch(arch, rows, seed):
    """The arch's train batch of ``rows`` rows, and for the retrievers a
    one-row query (``q_*``) and ``N_CAND`` unit-norm candidates, as
    numpy."""
    c = PORT[arch][1].smoke_config()
    g = torch.Generator().manual_seed(seed)
    batch = MAKERS[arch](c, rows, g, train=True)
    if arch in QUERY_KEYS:
        q = MAKERS[arch](c, 1, g)
        batch.update({f"q_{k}": q[k] for k in QUERY_KEYS[arch]})
        width = c.tower_mlp[-1] if arch == "two_tower" else c.embed_dim
        batch["candidates"] = rs.unit_rows(g, N_CAND, width)
    return {k: v.numpy() for k, v in batch.items()}


def _cloze(data):
    """The full cloze's batch: the targets at every position."""
    t = rs.cloze_targets({k: torch.from_numpy(data[k])
                          for k in ("mask_pos", "targets")},
                         data["ids"].shape[1])
    return {"ids": data["ids"], "targets": t.numpy()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("recsys")
    trees, params = {}, {}
    for i, (arch, (jm, jcfg)) in enumerate(JAX.items()):
        trees[arch] = jax.tree.map(lambda x: np.array(x, copy=True),
                                   jm.init_params(jcfg.smoke_config(),
                                                  jax.random.PRNGKey(i)))
        params[arch] = str(d / f"{arch}.pkl")
        with open(params[arch], "wb") as f:
            pickle.dump(trees[arch], f)
    data, inputs = {}, {}
    for i, (name, (arch, rows, _, _)) in enumerate(CASES.items()):
        data[name] = _batch(arch, rows, seed=10 + i)
        if name == "bert4rec_cloze":
            data[name] = _cloze(data[name])
        inputs[name] = str(d / f"{name}.npz")
        np.savez(inputs[name], **data[name])
    # the bad id, in one row of data shard 1 only: the last feature's
    # vocabulary size, one past the table's last row
    bad = dict(_batch("dlrm", B, seed=99))
    bad["sparse"] = bad["sparse"].copy()
    bad["sparse"][B - 3, -1] = dlrm_mlperf.smoke_config().vocab_sizes[-1]
    np.savez(str(d / "bad.npz"), **bad)

    cases = []
    for name, (arch, rows, what, override) in CASES.items():
        c = PORT[arch][1].smoke_config()
        cloze = name == "bert4rec_cloze"
        cases.append({
            "name": name, "arch": arch, "config": _fields(c),
            "params": params[arch], "inputs": inputs[name],
            "specs": override,
            "serve_keys": SERVE_KEYS[arch] if "serve" in what else [],
            "train_keys": (["ids", "targets"] if cloze else TRAIN_KEYS[arch])
            if "train" in what else [],
            "query_keys": QUERY_KEYS.get(arch, []),
            "retrieval": "retrieval" in what, "top_n": TOP_N, "lr": LR,
            "steps": int("step" in what), "sampled": not cloze})
    cases.append({"name": "dlrm_bad", "arch": "dlrm", "raises": True,
                  "config": _fields(dlrm_mlperf.smoke_config()),
                  "params": params["dlrm"], "inputs": str(d / "bad.npz"),
                  "train_keys": TRAIN_KEYS["dlrm"]})
    got = started(run_ranks, "sharded_recsys", 8, d,
                  {"mesh": MESH, "names": NAMES, "cases": cases})
    spec = {name: (arch, list(what), override, name == "bert4rec_cloze")
            for name, (arch, _, what, override) in CASES.items()}
    script = (JAX_SCRIPT.replace("SPECS", repr(spec))
              .replace("PARAMS", repr(params)).replace("INPUTS", repr(inputs))
              .replace("SERVE_KEYS", repr(SERVE_KEYS))
              .replace("TRAIN_KEYS", repr(TRAIN_KEYS))
              .replace("QUERY_KEYS", repr(QUERY_KEYS))
              .replace("TOP_N", str(TOP_N)))
    want = run_jax(script, d, 8)
    ranks = got()
    one = {name: _one_device(name, trees[CASES[name][0]], data[name])
           for name in CASES}
    return want, ranks, one, data, trees


def _one_device(name, tree, data):
    """The port's one-device run of case ``name``."""
    arch, _, what, _ = CASES[name]
    mod, cfg = PORT[arch]
    c = cfg.smoke_config()
    model = convert.recsys_params_from_numpy(arch, tree, c, "cpu")
    batch = {k: torch.from_numpy(np.array(v)) for k, v in data.items()}
    out = {}
    if "serve" in what:
        y = mod.serve_step(model, {k: batch[k] for k in SERVE_KEYS[arch]}, c)
        out["serve"] = [t.numpy() for t in
                        (y if isinstance(y, tuple) else (y,))]
    if "retrieval" in what:
        q = {k: batch["q_" + k] for k in QUERY_KEYS[arch]}
        v, i = mod.retrieval_step(model, {**q, "candidates":
                                          batch["candidates"]}, c, TOP_N)
        out["retrieval"] = (v.numpy(), i.numpy())
    if "train" not in what:
        return out
    cloze = name == "bert4rec_cloze"
    keys = ["ids", "targets"] if cloze else TRAIN_KEYS[arch]
    tb = {k: batch[k] for k in keys}
    loss = _loss(arch, cloze)(model, tb, c)
    loss.backward()
    out["loss"] = float(loss.detach())
    out["grads"] = {k: p.grad.numpy().copy()
                    for k, p in model.named_parameters() if p.grad is not None}
    if "step" in what:
        opt = optimizers.adamw(model.parameters(), lr=LR, warmup_steps=1)
        kw = {"sampled": True} if arch == "bert4rec" else {}
        step = mod.make_train_step(c, opt, **kw)
        out["step"] = (float(step(model, tb)["loss"]), float(opt.last_gnorm))
        out["step_grads"] = {k: p.grad.numpy().copy()
                             for k, p in model.named_parameters()
                             if p.grad is not None}
        out["params"] = {k: p.detach().numpy()
                         for k, p in model.named_parameters()}
    return out


def _loss(arch, cloze=False):
    return {"dlrm": dlrm.loss_fn, "deepfm": deepfm.loss_fn,
            "two_tower": two_tower.sampled_softmax_loss,
            "bert4rec": bert4rec.cloze_loss if cloze
            else bert4rec.sampled_cloze_loss}[arch]


def _jax_leaves(arch, tree):
    """The JAX tree's leaves by the port's parameter names."""
    c = PORT[arch][1].smoke_config()
    names = dict(convert.RECSYS_MODELS[arch](c, "cpu").named_parameters())
    return {k: np.asarray(convert._jax_leaf(tree, k)) for k in names}


def _same_or_tied(ids, vals, want_ids, want_vals):
    """Each id the reference's, or scoring as the reference's id at that
    rank does (within the serving bar): 0 mismatches."""
    same = ids == want_ids
    tie = np.isclose(vals, want_vals, **SERVE)
    assert np.all(same | tie), np.argwhere(~(same | tie))


@pytest.mark.parametrize("name", [n for n, c in CASES.items()
                                  if "serve" in c[2]])
def test_serve_step_matches_jax_and_one_device(runs, name):
    want, ranks, one, _, _ = runs
    for r, got in enumerate(ranks):
        g = got[name]["serve"]
        for a, b, c in zip(g, want[name]["serve"], one[name]["serve"]):
            if a.dtype.kind == "i":                     # top-n items
                continue
            np.testing.assert_allclose(a, b, **SERVE, err_msg=f"{r}")
            np.testing.assert_allclose(a, c, **SERVE, err_msg=f"{r}")
        if len(g) == 2:
            _same_or_tied(g[1], g[0], want[name]["serve"][1],
                          want[name]["serve"][0])
            _same_or_tied(g[1], g[0], one[name]["serve"][1],
                          one[name]["serve"][0])
        # the batch over "data" where it divides the batch, else whole
        split = CASES[name][1] % MESH[0] == 0
        assert got[name]["serve_placements"] == (["S(0)", "R"] if split
                                                 else ["R", "R"])


@pytest.mark.parametrize("name", [n for n, c in CASES.items()
                                  if "train" in c[2]])
def test_loss_and_gradients_match_jax_and_one_device(runs, name):
    want, ranks, one, _, _ = runs
    arch = CASES[name][0]
    jg = _jax_leaves(arch, want[name]["grads"])
    for r, got in enumerate(ranks):
        g = got[name]
        np.testing.assert_allclose(g["loss"], want[name]["loss"], **LOSS)
        np.testing.assert_allclose(g["loss"], one[name]["loss"], **LOSS)
        assert set(g["grads"]) == set(one[name]["grads"])
        for k, v in g["grads"].items():
            np.testing.assert_allclose(v, jg[k], **GRAD,
                                       err_msg=f"rank {r} {k}")
            np.testing.assert_allclose(v, one[name]["grads"][k], **GRAD,
                                       err_msg=f"rank {r} {k}")


@pytest.mark.parametrize("name", [n for n, c in CASES.items()
                                  if "retrieval" in c[2]])
def test_retrieval_step_matches_jax_and_one_device(runs, name):
    want, ranks, one, _, _ = runs
    wv, wi = want[name]["retrieval"]
    ov, oi = one[name]["retrieval"]
    for got in ranks:
        v, i = got[name]["retrieval"]
        assert v.shape == (1, TOP_N) and i.dtype == np.int32
        np.testing.assert_allclose(v, wv, **SERVE)
        np.testing.assert_allclose(v, ov, **SERVE)
        _same_or_tied(i, v, wi, wv)
        _same_or_tied(i, v, oi, ov)


@pytest.mark.parametrize("name", [n for n, c in CASES.items()
                                  if "step" in c[2]])
def test_adamw_step_matches_one_device(runs, name):
    _, ranks, one, _, _ = runs
    for r, got in enumerate(ranks):
        g = got[name]
        np.testing.assert_allclose(g["steps"][0], one[name]["step"],
                                   **LOSS)
        # at lr 3e-6 the parameters move by less than their bar: the
        # gradients the step applied (clipped) show a wrong step
        assert set(g["step_grads"]) == set(one[name]["step_grads"])
        for k, v in one[name]["step_grads"].items():
            np.testing.assert_allclose(g["step_grads"][k], v, **GRAD,
                                       err_msg=f"rank {r} {k}")
        for k, v in one[name]["params"].items():
            np.testing.assert_allclose(g["params"][k], v, **STEPS,
                                       err_msg=f"rank {r} {k}")


def test_two_tower_loss_is_the_global_in_batch_softmax(runs):
    """Each rank scores its users against all B items: the sharded loss
    is the one-device loss over the whole batch, not the mean of the
    data shards' own in-batch softmaxes (B/2 negatives each)."""
    _, ranks, one, data, trees = runs
    c = two_tower_retrieval.smoke_config()
    model = convert.recsys_params_from_numpy("two_tower", trees["two_tower"],
                                             c, "cpu")
    batch = {k: torch.from_numpy(np.array(data["two_tower"][k]))
             for k in TRAIN_KEYS["two_tower"]}
    half = B // MESH[0]
    with torch.no_grad():
        per_shard = np.mean([float(two_tower.sampled_softmax_loss(
            model, {k: v[s:s + half] for k, v in batch.items()}, c))
            for s in range(0, B, half)])
    global_ = one["two_tower"]["loss"]
    assert abs(global_ - per_shard) > 1e-3 * abs(global_)
    for got in ranks:
        np.testing.assert_allclose(got["two_tower"]["loss"], global_, **LOSS)
        assert abs(got["two_tower"]["loss"] - per_shard) > 1e-3 * abs(
            global_)


def test_an_id_out_of_range_raises_on_every_rank(runs):
    """The bad id lies in data shard 1's rows; the ids' extremes are
    reduced over every rank first, so shard 0's ranks raise too."""
    _, ranks, _, _, _ = runs
    for r, got in enumerate(ranks):
        assert "embedding_lookup" in got["dlrm_bad"].get("raised", ""), r


def test_tables_lie_over_the_axes_the_rows_take(runs):
    """The tables' rows over every mesh axis (``param_pspecs``), DLRM's
    over the tensor axis only in ``dlrm_rows_tp``, the MLPs replicated:
    the serve and train tests above hold both layouts."""
    _, ranks, _, _, _ = runs
    every, tp, whole = ["S(0)", "S(0)"], ["R", "S(0)"], ["R", "R"]
    for got in ranks:
        assert got["dlrm"]["placements"]["table"] == every
        assert got["dlrm_rows_tp"]["placements"]["table"] == tp
        assert got["deepfm"]["placements"]["linear"] == every
        for name in ("user_emb", "item_emb", "cat_emb"):
            assert got["two_tower"]["placements"][name] == every
        assert got["bert4rec"]["placements"]["item_emb"] == every
        assert got["dlrm"]["placements"]["top.w.0"] == whole
