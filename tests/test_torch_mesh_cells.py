"""The dry run's mesh route on gloo ranks on the CPU.

``launch/dryrun.run_ranks`` (what ``--mesh`` starts) runs one cell of
each kind per family at ``configs.smoke_sizes`` in 4 rank processes on
the (2, 2) ("data", "model") mesh: granite-3-2b's train step, prefill
and decode; DeepSeek-V3's train step (MLA, the MoE, Adafactor over
DTensor parameters); DLRM's train step, DeepFM's serving, two-tower's retrieval
and BERT4Rec's bulk serving; DimeNet's molecule train step.  Each cell
is built on every rank from one seed and placed by its own
``in_shardings``, and its gathered outputs are held to the one-device
run of the same seed by ``dryrun.held`` (a train step's loss, gradient
norm, clipped gradients and the parameters after it at the training
tests' bars, serving outputs ``rtol=1e-5, atol=1e-6``, a top-n's ids
identical or tied, a decode step's logits ``rtol=1e-4, atol=1e-4``).
Three of them are also held to the JAX package's own cell functions on
the same seeded parameters and batch, jitted with the cells'
``in_shardings`` on 4 fake devices: DLRM's ``make_train_step`` (AdamW,
one step: its loss and the parameters after it, and ``loss_fn``'s
gradients clipped by their global norm), DeepFM's ``serve_step`` and
two-tower's ``retrieval_step``.  A DLRM step with a doubled gradient, or
with the gradient of half its batch, fails ``dryrun.held`` though its
loss and its parameters after the step pass.
(The other cells' one-device runs are held to JAX by
``tests/test_torch_registry_cells.py``.)  Every cell runs twice in the
ranks: each rank's ``torch.distributed`` collective
bytes by kind (the counted run, ``launch/cost.py``) are above 0, since
every one of these cells splits a parameter or its batch, and the same
in both runs.
"""
import pickle

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_arch, smoke_sizes
from repro_torch.launch import dryrun
from torch_ranks import run_jax, started

MESH = (2, 2)
CELLS = [("granite-3-2b", "train_4k"), ("granite-3-2b", "prefill_32k"),
         ("granite-3-2b", "decode_32k"), ("deepseek-v3-671b", "train_4k"),
         ("dlrm-mlperf", "train_batch"),
         ("deepfm", "serve_p99"), ("two-tower-retrieval", "retrieval_cand"),
         ("bert4rec", "serve_bulk"), ("dimenet", "molecule")]


# the cells held to JAX: (port arch, JAX config module, the call)
JAX_CELLS = {("dlrm-mlperf", "train_batch"): ("dlrm", "dlrm_mlperf"),
             ("deepfm", "serve_p99"): ("deepfm", "deepfm_cfg"),
             ("two-tower-retrieval", "retrieval_cand"):
                 ("two_tower", "two_tower_retrieval")}

JAX_SCRIPT = r"""
import pickle, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import compat
from repro.configs import dlrm_mlperf, deepfm_cfg, two_tower_retrieval
from repro.models import dlrm, deepfm, two_tower
from repro.optim import adamw, adamw_state_pspecs
from repro.optim.optimizers import clip_by_global_norm
from repro.parallel.sharding import ShardingRules
auto = getattr(jax.sharding, "AxisType", None)
mesh = jax.make_mesh((2, 2), ("data", "model"), **(
    {"axis_types": (auto.Auto, auto.Auto)} if auto else {}))
rules = ShardingRules(batch=("data",), fsdp=("data",))
kw = {"mesh": mesh, "rules": rules}
named = lambda t: jax.tree.map(lambda s: NamedSharding(mesh, s), t,
                               is_leaf=lambda x: isinstance(x, P))
host = lambda t: jax.tree.map(lambda x: np.array(x, copy=True), t)
inputs = pickle.load(open(INPUTS, "rb"))
out = {}
with compat.set_mesh(mesh):
    for name, (arch, cfg, tree, batch) in inputs.items():
        m = {"dlrm": dlrm, "deepfm": deepfm, "two_tower": two_tower}[arch]
        c = {"dlrm_mlperf": dlrm_mlperf, "deepfm_cfg": deepfm_cfg,
             "two_tower_retrieval": two_tower_retrieval}[cfg].smoke_config()
        params = jax.tree.map(jnp.asarray, tree)
        batch = {k: jnp.asarray(v, jnp.int32 if v.dtype.kind == "i"
                                else v.dtype) for k, v in batch.items()}
        ps = m.param_pspecs(c, mesh, rules)
        n = batch[list(batch)[0]].shape[0]
        bax = ("data",) if n % 2 == 0 else None
        bs = {k: P(bax, *([None] * (v.ndim - 1))) for k, v in batch.items()}
        if name == "retrieval":
            bs = {k: P(*([None] * v.ndim)) for k, v in batch.items()}
            bs["candidates"] = P("model", None)
            shard = (named(ps), named(bs))
            v, i = jax.jit(lambda p, b: m.retrieval_step(p, b, c, 100, **kw),
                           in_shardings=shard)(
                *jax.device_put((params, batch), shard))
            out[name] = (np.asarray(v), np.asarray(i))
        elif name == "train":
            opt = adamw(total_steps=10000)
            shard = (named(ps), named(adamw_state_pspecs(ps)), named(bs))
            args = jax.device_put((params, opt.init(params), batch), shard)
            step = jax.jit(m.make_train_step(c, opt, **kw),
                           in_shardings=shard)
            p2, _, met = step(*args)

            def grads(p, b):
                g = jax.grad(lambda q: m.loss_fn(q, b, c, **kw))(p)
                return clip_by_global_norm(g, 1.0)
            g, gnorm = jax.jit(grads, in_shardings=(shard[0], shard[2]))(
                args[0], args[2])
            out[name] = (float(met["loss"]), float(gnorm), host(g),
                         host(p2))
        else:
            shard = (named(ps), named(bs))
            out[name] = np.asarray(jax.jit(
                lambda p, b: m.serve_step(p, b, c, **kw),
                in_shardings=shard)(*jax.device_put((params, batch), shard)))
pickle.dump(out, open(sys.argv[1], "wb"))
"""
JAX_NAMES = {("dlrm-mlperf", "train_batch"): "train",
             ("deepfm", "serve_p99"): "serve",
             ("two-tower-retrieval", "retrieval_cand"): "retrieval"}


def _jax_inputs(cell):
    """The cell's seeded parameters (as the JAX tree) and batch, as
    numpy, built on one device as the ranks build them."""
    prog = get_arch(cell[0]).cells[cell[1]]("cpu", 0, smoke_sizes(*cell))
    model, batch = prog.args
    tree = {}
    for name, p in model.named_parameters():
        convert._set_jax_leaf(tree, name, p.detach().numpy().copy())
    return tree, {k: v.numpy() for k, v in batch.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_cells")
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        inputs = {JAX_NAMES[cell]: (*JAX_CELLS[cell], *_jax_inputs(cell))
                  for cell in JAX_CELLS}
        path = str(d / "jax_inputs.pkl")
        with open(path, "wb") as f:
            pickle.dump(inputs, f)
        want = started(run_jax, JAX_SCRIPT.replace("INPUTS", repr(path)),
                       d, 4)
        one = {cell: dryrun.one_device(*cell, int(np.prod(MESH)), "cpu", 0,
                                       dryrun.mesh_sizes(*cell, True))[0]
               for cell in CELLS}
    finally:
        torch.set_num_threads(before)
    ranks = dryrun.run_ranks(CELLS + CELLS, MESH, str(d), "cpu", smoke=True,
                             timeout=240.0)
    n = len(CELLS)
    return (one, [rank[:n] for rank in ranks], [rank[n:] for rank in ranks],
            want())


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: " x ".join(c))
def test_cell_matches_its_one_device_run(runs, cell):
    one, first, second, _ = runs
    i = CELLS.index(cell)
    got = first[0][i]
    assert (got["arch"], got["shape"]) == cell and got["world"] == 4
    assert got["mesh"] == {"data": 2, "model": 2}
    dryrun.held(one[cell], got["kept"], " x ".join(cell),
                decode=dryrun.is_decode(*cell))
    # the cell is built from its seed on every rank: the second run
    # answers as the first
    dryrun.held(got["kept"], second[0][i]["kept"], " x ".join(cell))


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: " x ".join(c))
def test_each_rank_counts_its_collective_bytes(runs, cell):
    _, first, second, _ = runs
    i = CELLS.index(cell)
    for r in range(len(first)):
        a, b = first[r][i], second[r][i]
        assert sum(a["coll"].values()) > 0, (r, a["coll"])
        assert a["coll"] == b["coll"], (r, a["coll"], b["coll"])
        rt = a["roofline"]
        assert rt["coll_bytes"] == sum(a["coll"].values())
        assert rt["t_collective_s"] > 0 and a["chips"] == 4
        assert a["model_flops_per_device"] == a["model_flops"] / 4
        assert a["run_s"] > 0 and a["peak_bytes"] is None    # the CPU's


@pytest.mark.parametrize("cell", list(JAX_CELLS), ids=lambda c: " x ".join(c))
def test_cell_matches_the_jax_cell_on_the_mesh(runs, cell):
    """The mesh run against JAX's cell function jitted with the cell's
    ``in_shardings`` on 4 fake devices, from the same parameters and
    batch: the bars of ``dryrun.held``."""
    _, first, _, want = runs
    got = first[0][CELLS.index(cell)]["kept"]
    jax_out = want[JAX_NAMES[cell]]
    if JAX_NAMES[cell] == "train":
        loss, gnorm, grads, tree = jax_out

        def leaves(t, names):
            return {k: torch.from_numpy(np.asarray(convert._jax_leaf(t, k)))
                    for k in names}
        jax_out = {"loss": loss, "gnorm": gnorm,
                   "grads": leaves(grads, got["grads"]),
                   "params": leaves(tree, got["params"])}
    elif JAX_NAMES[cell] == "retrieval":
        jax_out = tuple(torch.from_numpy(np.asarray(x)) for x in jax_out)
    else:
        jax_out = torch.from_numpy(jax_out)
    dryrun.held(jax_out, got, " x ".join(cell))


DLRM_TRAIN = ("dlrm-mlperf", "train_batch")


@pytest.mark.parametrize("wrong", ["doubled", "half_batch"])
def test_a_wrong_gradient_fails_the_comparison(runs, wrong):
    """At the first step's learning rate (3e-6) the parameters move by
    less than their bar, so a step whose gradient is doubled (a psum over
    "model" counted twice) or taken from half the batch (a psum over
    "data" left out) passes on its loss and parameters alone; the
    gradients and their norm fail it."""
    one = runs[0][DLRM_TRAIN]
    if wrong == "doubled":
        bad = dict(one, grads=dict(one["grads"],
                                   table=2 * one["grads"]["table"]))
    else:
        prog = get_arch(DLRM_TRAIN[0]).cells[DLRM_TRAIN[1]](
            "cpu", 0, smoke_sizes(*DLRM_TRAIN))
        model, batch = prog.args
        n = batch["labels"].shape[0]
        out = prog.fn(model, {k: v[: n // 2] for k, v in batch.items()})
        bad = dict(dryrun.outputs(prog, out), loss=one["loss"])
    dryrun.held(one, dict(bad, grads=one["grads"], gnorm=one["gnorm"]),
                wrong)
    with pytest.raises(AssertionError, match="grad"):
        dryrun.held(one, bad, wrong)


def test_cells_without_a_mesh_route_are_named():
    for shape in ("stream_update", "serve_topk", "serve_topk_opt"):
        assert dryrun.no_mesh_route("tifu-knn", shape, 2) is None
        assert dryrun.no_mesh_route("tifu-knn", shape, 2,
                                    smoke_sizes("tifu-knn", shape)) is None
    assert dryrun.no_mesh_route("deepseek-v3-671b", "train_4k", 2) is None
    assert dryrun.no_mesh_route("deepseek-v3-671b", "train_4k", 2,
                                smoke_sizes("deepseek-v3-671b",
                                            "train_4k")) is None
    c = smoke_sizes("command-r-plus-104b", "prefill_32k")
    assert "heads" in dryrun.no_mesh_route("command-r-plus-104b",
                                           "prefill_32k", 4, c)
    assert dryrun.no_mesh_route("command-r-plus-104b", "prefill_32k", 2,
                                c) is None
    for cell in CELLS:
        assert dryrun.no_mesh_route(*cell, 2, smoke_sizes(*cell)) is None


def test_moe_cells_run_at_a_capacity_that_drops_nothing():
    s = dryrun.mesh_sizes("qwen2-moe-a2.7b", "prefill_32k", True)
    c = s.config
    assert c.capacity_factor == c.e_pad / c.top_k
    assert dryrun.mesh_sizes("granite-3-2b", "prefill_32k", True) == \
        smoke_sizes("granite-3-2b", "prefill_32k")


def test_rank_rows_read_fits_on_a_shared_card():
    rows = [{"rank": r, "run_s": 0.5, "peak_bytes": 30 * 2 ** 30,
             "device_bytes": 80 * 2 ** 30, "coll": {"all-reduce": 1024.0}}
            for r in range(4)]
    assert "fits False (the ranks' peaks summed" in dryrun.rank_rows(
        rows, shared_card=True)
    assert "fits True" in dryrun.rank_rows(rows, shared_card=False)
    assert "all-reduce 1,024 B" in dryrun.rank_rows(rows, False)
