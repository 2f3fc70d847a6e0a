"""tifu-knn's three cells under a mesh, in gloo ranks, against their
one-device twins and against the JAX package's cell functions.

4 ranks on the (2, 2) ("data", "model") mesh (batch over "data", the
tensor axis "model"), at ``tifu_knn.SMOKE_SIZES``:

* ``launch/dryrun.run_ranks`` runs the three seeded cells twice: each
  held by ``dryrun.held`` to its one-device run (a state's integer leaves
  exact, its float leaves ``rtol=1e-4, atol=1e-5``; a prediction
  ``rtol=1e-5, atol=1e-6``), and each rank's collective bytes above 0
  and the same in both runs;
* ``stream_update``'s seeded state after a micro-batch that holds a row
  whose user another data shard holds, padding rows that alias such
  users and an add whose basket spans both item halves, placed by the
  cell's ``in_shardings``: against its one-device twin, and against the
  JAX cell's function (``apply_add_batch`` → ``apply_del_basket_batch``
  → ``apply_del_item_batch``) jitted with ``_state_shardings`` on 4
  fake devices, on the same state and batches;
* ``serve_topk``'s ``knn.predict(mesh=, rules=)`` (with and without
  self-exclusion) against the one-device ``predict_streaming`` and
  JAX's ``knn.predict(mesh=, rules=)``; ``serve_topk_opt``'s
  ``distributed_predict`` mesh route against the one-device row blocks
  and JAX's ``distributed_predict(..., mesh, rules)``; both on an
  integer-valued corpus, so that ties are exact and the selected rows
  must be the same;
* two negative runs fail ``dryrun.held``: the micro-batch applied with
  no exchange (each rank applies only the batch rows it holds), and the
  candidates merged over "model" but not over "data".

The JAX mesh has Auto axes: on jax 0.9.0 ``jax.make_mesh`` gives
Explicit ones, where ``with_sharding_constraint`` asserts.
"""
import pickle

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import tifu_knn
from repro_torch.core import knn
from repro_torch.core.types import (AddBatch, DelBasketBatch, DelItemBatch,
                                    StreamState)
from repro_torch.launch import dryrun
from torch_ranks import run_jax, run_ranks, started

MESH, NAMES = [2, 2], ["data", "model"]
SZ = tifu_knn.SMOKE_SIZES
SEED, K, ALPHA = 5, SZ.topk, 0.7
CELLS = [("tifu-knn", s) for s in ("stream_update", "serve_topk",
                                   "serve_topk_opt")]
# users and batch rows a data shard holds
USERS_A_SHARD = SZ.stream_users // MESH[0]

JAX_SCRIPT = r"""
import dataclasses, pickle, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import compat
from repro.configs import tifu_knn as jcfg
from repro.core import knn
from repro.core import types as jt
from repro.core import updates as ju
from repro.parallel.sharding import ShardingRules
inp = pickle.load(open(INPUTS, "rb"))
auto = getattr(jax.sharding, "AxisType", None)
mesh = jax.make_mesh((2, 2), ("data", "model"), **(
    {"axis_types": (auto.Auto, auto.Auto)} if auto else {}))
rules = ShardingRules(batch=("data",), fsdp=("data",))
k, alpha = inp["k"], inp["alpha"]
params = dataclasses.replace(jcfg.make_params(), n_items=inp["n_items"])
sh = lambda *e: NamedSharding(mesh, P(*e))
out = {}
with compat.set_mesh(mesh):
    state = jt.StreamState(**{n: jnp.asarray(v)
                              for n, v in inp["state"].items()})
    b = inp["batches"]
    adds = jt.AddBatch(*(jnp.asarray(b[f"add.{f}"])
                         for f in ("user", "items", "valid")))
    delb = jt.DelBasketBatch(*(jnp.asarray(b[f"delb.{f}"])
                               for f in ("user", "pos", "valid")))
    deli = jt.DelItemBatch(*(jnp.asarray(b[f"deli.{f}"])
                             for f in ("user", "pos", "item", "valid")))
    u = ("data",)
    shard = (jcfg._state_shardings(mesh, rules),
             jt.AddBatch(sh(u), sh(u, None), sh(u)),
             jt.DelBasketBatch(sh(u), sh(u), sh(u)),
             jt.DelItemBatch(sh(u), sh(u), sh(u), sh(u)))

    def fn(state, adds, delb, deli):
        state = ju.apply_add_batch(state, adds, params)
        state = ju.apply_del_basket_batch(state, delb, params)
        return ju.apply_del_item_batch(state, deli, params)
    st = jax.jit(fn, in_shardings=shard)(
        *jax.device_put((state, adds, delb, deli), shard))
    out["stream"] = {n: np.asarray(getattr(st, n))
                     for n in inp["state"]}
    q, c, ids = inp["queries"], inp["corpus"], inp["self_ids"]

    def run(fn, shardings, *args):
        return np.asarray(jax.jit(fn, in_shardings=shardings)(
            *jax.device_put(args, shardings)))
    qc = (sh(u, "model"), sh(u, "model"))
    out["predict"] = run(
        lambda q, c: knn.predict(q, c, k=k, alpha=alpha, exclude_self=False,
                                 mesh=mesh, rules=rules), qc, q, c)
    out["predict_self"] = run(
        lambda q, c, i: knn.predict(q, c, k=k, alpha=alpha,
                                    exclude_self=True, query_ids=i,
                                    mesh=mesh, rules=rules),
        qc + (sh(None),), c[ids], c, ids)
    out["opt"] = run(
        lambda q, c: knn.distributed_predict(q, c, k, alpha, mesh, rules),
        (sh(None, None), sh(("data", "model"), None)), q, c)
pickle.dump(out, open(sys.argv[1], "wb"))
"""


def _np(t):
    return t.detach().cpu().numpy().copy()


def _batches():
    """The seeded micro-batch of ``stream_update`` at ``SZ``, changed so
    it holds the cases the mesh must get right (see
    :func:`test_the_stream_holds_the_mesh_cases`)."""
    _, adds, delb, deli = tifu_knn.stream_update_cell("cpu", SEED,
                                                      SZ).args
    b = {f"add.{f}": _np(getattr(adds, f)) for f in ("user", "items",
                                                     "valid")}
    b.update({f"delb.{f}": _np(getattr(delb, f))
              for f in ("user", "pos", "valid")})
    b.update({f"deli.{f}": _np(getattr(deli, f))
              for f in ("user", "pos", "item", "valid")})
    n_add = len(b["add.user"])
    # an add whose basket spans both item halves, in the first data
    # shard's rows, of a user the second data shard holds
    held = np.nonzero(b["add.user"][:n_add // 2] >= USERS_A_SHARD)[0]
    row = int(held[0])
    half = SZ.n_items // 2
    b["add.items"][row] = [3, half - 2, half + 1, SZ.n_items - 1]
    # padding rows (in the first data shard's rows) aliasing a user of
    # the second with a valid row there, their fields otherwise live
    other = int(held[1])
    b["add.valid"][other] = False
    b["add.user"][other] = b["add.user"][row]
    for kind in ("delb", "deli"):
        users, valid = b[f"{kind}.user"], b[f"{kind}.valid"]
        n = len(users)
        far = np.nonzero(users[n // 2:] >= USERS_A_SHARD)[0] + n // 2
        near = 0
        valid[near] = False
        users[near] = users[far[0]]
    return b


def _as_batches(b):
    t = {k: torch.from_numpy(v.copy()) for k, v in b.items()}
    return (AddBatch(t["add.user"], t["add.items"], t["add.valid"]),
            DelBasketBatch(t["delb.user"], t["delb.pos"], t["delb.valid"]),
            DelItemBatch(t["deli.user"], t["deli.pos"], t["deli.item"],
                         t["deli.valid"]))


def _integer_corpus():
    """(queries, corpus, self ids): small non-negative integers, most of
    them 0, so many neighbour scores tie exactly; self ids from both
    halves of the corpus."""
    rng = np.random.default_rng(39)

    def rows(n):
        return (rng.integers(0, 4, (n, SZ.n_items))
                * (rng.random((n, SZ.n_items)) < 0.15)).astype(np.float32)
    ids = rng.choice(SZ.n_users, size=8, replace=False).astype(np.int32)
    ids[:2] = (3, SZ.n_users - 5)
    return rows(SZ.n_queries), rows(SZ.n_users), ids


def _state(arrays):
    return StreamState(**{n: torch.from_numpy(np.asarray(v))
                          for n, v in arrays.items()})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_tifu")
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        b = _batches()
        q, c, ids = _integer_corpus()
        prog = tifu_knn.stream_update_cell("cpu", SEED, SZ)
        start = convert.state_to_numpy(prog.args[0])
        jax_in = {"state": start, "batches": b, "queries": q, "corpus": c,
                  "self_ids": ids, "k": K, "alpha": ALPHA,
                  "n_items": SZ.n_items}
        path = str(d / "jax_inputs.pkl")
        with open(path, "wb") as f:
            pickle.dump(jax_in, f)
        want = started(run_jax, JAX_SCRIPT.replace("INPUTS", repr(path)),
                       d, 4)
        inputs = str(d / "inputs.npz")
        np.savez(inputs, queries=q, corpus=c, self_ids=ids, **b)
        mine = started(run_ranks, "mesh_tifu", 4, d, {
            "mesh": MESH, "names": NAMES, "inputs": inputs, "seed": SEED,
            "k": K, "alpha": ALPHA})
        # the one-device twins
        one = {cell: dryrun.one_device(*cell, 4, "cpu", 0,
                                       dryrun.mesh_sizes(*cell, True))[0]
               for cell in CELLS}
        prog.fn(prog.args[0], *_as_batches(b))
        twin = {"stream": dryrun.outputs(prog, prog.args[0])}
        qt, ct, it = (torch.from_numpy(x) for x in (q, c, ids))
        twin["predict"] = knn.predict_streaming(qt, ct, K, ALPHA,
                                                exclude_self=False)
        twin["predict_self"] = knn.predict_streaming(
            ct[it.long()], ct, K, ALPHA, exclude_self=True, query_ids=it)
        twin["opt"] = knn.distributed_predict(qt, list(ct.chunk(4)), K,
                                              ALPHA)
    finally:
        torch.set_num_threads(before)
    ranks = dryrun.run_ranks(CELLS + CELLS, MESH, str(d / "cells"), "cpu",
                             smoke=True, timeout=240.0)
    n = len(CELLS)
    return dict(one=one, first=[r[:n] for r in ranks],
                second=[r[n:] for r in ranks], twin=twin, mine=mine()[0],
                want=want(), batches=b)


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: c[1])
def test_cell_matches_its_one_device_run(runs, cell):
    i = CELLS.index(cell)
    got = runs["first"][0][i]
    assert (got["arch"], got["shape"]) == cell and got["world"] == 4
    assert got["mesh"] == {"data": 2, "model": 2}
    dryrun.held(runs["one"][cell], got["kept"], " x ".join(cell))
    dryrun.held(got["kept"], runs["second"][0][i]["kept"], " x ".join(cell))


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: c[1])
def test_each_rank_counts_its_collective_bytes(runs, cell):
    i = CELLS.index(cell)
    for r in range(4):
        a, b = runs["first"][r][i], runs["second"][r][i]
        assert sum(a["coll"].values()) > 0, (r, a["coll"])
        assert a["coll"] == b["coll"], (r, a["coll"], b["coll"])
        assert a["roofline"]["coll_bytes"] == sum(a["coll"].values())
        assert a["chips"] == 4 and a["peak_bytes"] is None


def test_the_stream_holds_the_mesh_cases(runs):
    b = runs["batches"]
    n = len(b["add.user"])
    first_rows = slice(0, n // 2)            # the first data shard's rows
    elsewhere = b["add.user"][first_rows] >= USERS_A_SHARD
    assert (elsewhere & b["add.valid"][first_rows]).any()
    pad = np.nonzero(~b["add.valid"][first_rows])[0]
    assert any(b["add.user"][p] >= USERS_A_SHARD and
               ((b["add.user"] == b["add.user"][p]) & b["add.valid"]).any()
               for p in pad)
    half = SZ.n_items // 2
    spans = [(row[row >= 0] < half).any() and (row >= half).any()
             for row in b["add.items"]]
    assert any(s and v for s, v in zip(spans, b["add.valid"]))
    for kind in ("delb", "deli"):
        users, valid = b[f"{kind}.user"], b[f"{kind}.valid"]
        assert not valid[0] and users[0] >= USERS_A_SHARD
        assert ((users == users[0]) & valid).sum() == 1


def test_stream_update_matches_its_twin_and_the_jax_cell(runs):
    got = _state(runs["mine"]["stream"])
    dryrun.held(runs["twin"]["stream"], got, "stream_update vs one device")
    dryrun.held(_state(runs["want"]["stream"]), got,
                "stream_update vs the JAX cell")
    start = tifu_knn.stream_update_cell("cpu", SEED, SZ).args[0]
    assert not torch.equal(got.n_baskets, start.n_baskets)


@pytest.mark.parametrize("what", ["predict", "predict_self", "opt"])
def test_serving_matches_its_twin_and_jax(runs, what):
    got = torch.from_numpy(runs["mine"][what])
    dryrun.held(runs["twin"][what], got, f"{what} vs one device")
    dryrun.held(torch.from_numpy(runs["want"][what]), got,
                f"{what} vs JAX")


@pytest.mark.parametrize("what,one", [
    ("stream_no_exchange", "stream"), ("opt_no_data_merge", "opt")])
def test_a_wrong_mesh_route_fails_the_comparison(runs, what, one):
    bad = runs["mine"][what]
    bad = _state(bad) if isinstance(bad, dict) else torch.from_numpy(bad)
    with pytest.raises(AssertionError):
        dryrun.held(runs["twin"][one], bad, what)


def test_a_batch_on_a_user_block_is_padding_elsewhere():
    """``updates.on_user_block``: rows of users outside the block become
    padding rows of user 0, the others local rows; order kept."""
    from repro_torch.core.updates import on_user_block
    batch = DelBasketBatch(torch.tensor([5, 64, 70, 127], dtype=torch.int32),
                           torch.tensor([1, 2, 3, 4], dtype=torch.int32),
                           torch.tensor([True, True, False, True]))
    out = on_user_block(batch, 64, 128)
    assert out.user.tolist() == [0, 0, 6, 63]
    assert out.valid.tolist() == [False, True, False, True]
    assert out.pos.tolist() == [1, 2, 3, 4]
