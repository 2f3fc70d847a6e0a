"""The port's sharding rules and placement against the JAX package's.

Every rule of ``parallel/sharding.py`` (``ShardingRules``'s FSDP axes
and size, ``batch_axes``, ``logical_to_physical``, ``pick_fsdp_dim``,
``param_spec``, ``shard_params_pytree``, ``zero_like_sharded``) against
``repro.parallel.sharding`` over stand-in meshes of (1, 1), (2, 4),
(16, 16) and (2, 16, 16) devices (the JAX rules read only a mesh's axis
names and ``devices.shape``), under ``make_rules`` and
``ShardingRules(batch=("data",), fsdp=("data",))``; every model's
``param_pspecs`` for each registry config, leaf for leaf, through the
conversion's name maps (an LM layer's spec is its stacked JAX leaf's
without the leading ``None``); the three ``*_state_pspecs``
(Adafactor's factored ``vr`` / ``vc`` included) and ``state_shardings``;
``Spec``'s normalization against ``PartitionSpec``'s.  Then, in 8 gloo
ranks, each rank's block of ``distribute`` (specs of every kind, and
the smoke granite's parameters by ``param_pspecs``) equal to the slice
``NamedSharding.devices_indices_map`` gives the device of the same index
(JAX on 8 fake devices), and ``make_user_shard_meshes`` dealing the
devices as JAX's does.  A spec out of mesh order, or naming an axis
twice or one the mesh lacks, raises; so does a dim its axes do not
divide.
"""
import dataclasses
import importlib
import types

import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec as P

from repro.launch import mesh as jmesh
from repro.optim import optimizers as jopt
from repro.parallel import sharding as js
from repro.streaming import state_store as jstore
from repro_torch import convert
from repro_torch.launch import mesh as tmesh
from repro_torch.models import transformer as tf
from repro_torch.optim import optimizers as topt
from repro_torch.parallel import sharding as ts
from repro_torch.streaming import state_store as tstore
from torch_ranks import run_jax, run_ranks

MESHES = [((1, 1), ("data", "model")), ((2, 4), ("data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
RULES = [("default", jmesh.make_rules(), tmesh.make_rules()),
         ("data_only", js.ShardingRules(batch=("data",), fsdp=("data",)),
          ts.ShardingRules(batch=("data",), fsdp=("data",)))]
LM_MODULES = ["granite_3_2b", "command_r_plus_104b", "gemma3_27b",
              "qwen2_moe_a2_7b", "deepseek_v3_671b"]
RECSYS = {"two_tower": "two_tower_retrieval", "dlrm": "dlrm_mlperf",
          "deepfm": "deepfm_cfg", "bert4rec": "bert4rec_cfg",
          "dimenet": "dimenet_cfg"}


def _stand_in(shape, names):
    """What the JAX rules read of a mesh, without its devices."""
    return types.SimpleNamespace(axis_names=names,
                                 devices=np.empty(shape, object))


def _meshes():
    for shape, names in MESHES:
        for rname, jr, tr in RULES:
            yield (f"{shape}-{rname}", _stand_in(shape, names),
                   ts.MeshShape(names, shape), jr, tr)


MESH_CASES = list(_meshes())
MESH_IDS = [c[0] for c in MESH_CASES]


def _spec(p):
    return tuple(p)


def test_spec_normalizes_as_partition_spec():
    for entries in [(), (None,), ("data",), (("data",),), ((),),
                    (("pod", "data"), None), (["pod", "data"], "model"),
                    (None, None, ("model",))]:
        assert tuple(ts.Spec(*entries)) == tuple(P(*entries)), entries
    assert ts.Spec("a", None) == ("a", None)
    assert ts.Spec(("a", "b")).axes(0) == ("a", "b")
    assert ts.Spec("a").axes(3) == ()
    with pytest.raises(TypeError):
        ts.Spec((1, 2))


@pytest.mark.parametrize("case", MESH_CASES, ids=MESH_IDS)
def test_rule_functions_match_jax(case):
    _, jm, tm, jr, tr = case
    assert tr.fsdp_axes(tm) == jr.fsdp_axes(jm)
    assert tr.fsdp_size(tm) == jr.fsdp_size(jm)
    assert ts.batch_axes(tm, tr) == js.batch_axes(jm, jr)
    abstract = AbstractMesh(tm.shape, tm.axis_names)
    for logical in [("batch", None), ("tp", "fsdp"), ("fsdp", "tp"),
                    ("expert", None, "fsdp"), ("batch", "ctx", None),
                    (None,)]:
        got = ts.logical_to_physical(tm, tr, logical)
        assert isinstance(got, ts.Sharding) and got.mesh == tm
        assert got.spec == _spec(js.logical_to_physical(
            abstract, jr, logical).spec), logical
    shapes = [(4096, 8192), (8192, 4096), (7, 256), (256, 7), (3, 5),
              (16,), (64, 64, 64), (2048, 2048, 6), (256, 512)]
    for shape in shapes:
        for taken in [None] + list(range(len(shape))):
            assert ts.pick_fsdp_dim(shape, tm, tr, taken) == \
                js.pick_fsdp_dim(shape, jm, jr, taken), (shape, taken)
            assert ts.param_spec(shape, tm, tr, tp_dim=taken) == \
                _spec(js.param_spec(shape, jm, jr, tp_dim=taken)), \
                (shape, taken)
    tree = {"a": np.zeros((4, 8)), "b": [np.zeros((16,)), np.zeros(2)]}
    fn = lambda path, leaf: ts.Spec("data" if leaf.shape[0] % 2 == 0
                                    else None)
    jfn = lambda path, leaf: P("data" if leaf.shape[0] % 2 == 0 else None)
    got = ts.shard_params_pytree(tree, fn, tm)
    want = js.shard_params_pytree(tree, jfn, abstract)
    assert got["a"] == ts.Sharding(tm, ts.Spec("data"))
    assert [s.spec for s in got["b"]] == [_spec(w.spec) for w in want["b"]]
    assert ts.zero_like_sharded(got) is got


def _module(pkg, name):
    return importlib.import_module(f"{pkg}.configs.{name}")


def _lm_configs(name):
    jmod, tmod = _module("repro", name), _module("repro_torch", name)
    return [(jmod.make_config(), tmod.make_config()),
            (jmod.smoke_config(), tmod.smoke_config())]


def _lm_jax_spec(jtree, c, name):
    """The JAX spec port parameter ``name`` holds: a layer's is its
    group's stacked leaf's without the leading None."""
    if not name.startswith("layers."):
        return _spec(jtree[name])
    _, i, leaf = name.split(".")
    n_dense, _ = tf.layer_groups(c)
    group = "dense_layers" if int(i) < n_dense else "moe_layers"
    full = _spec(jtree[group][leaf])
    assert full[0] is None
    return full[1:]


@pytest.mark.parametrize("name", LM_MODULES)
def test_lm_param_pspecs_match_jax_leaf_for_leaf(name):
    from repro.models import transformer as jtf
    for jc, c in _lm_configs(name):
        names = [n for n, _ in tf.Transformer(
            dataclasses.replace(c, dtype=torch.float32),
            "meta").named_parameters()]
        for _, jm, tm, jr, tr in MESH_CASES:
            got = tf.param_pspecs(c, tm, tr)
            assert list(got) == names
            want = jtf.param_pspecs(jc, jm, jr)
            for n, spec in got.items():
                assert isinstance(spec, ts.Spec)
                assert spec == _lm_jax_spec(want, c, n), (name, n, tm)


def _recsys_configs(arch):
    jmod, tmod = _module("repro", RECSYS[arch]), _module("repro_torch",
                                                          RECSYS[arch])
    if arch == "dimenet":
        return [(jmod.make_config(cell), tmod.make_config(cell))
                for cell in jmod.CELLS]
    return [(jmod.make_config(), tmod.make_config()),
            (jmod.smoke_config(), tmod.smoke_config())]


@pytest.mark.parametrize("arch", list(RECSYS))
def test_recsys_param_pspecs_match_jax_leaf_for_leaf(arch):
    jmodel = importlib.import_module(f"repro.models.{arch}")
    tmodel = importlib.import_module(f"repro_torch.models.{arch}")
    for jc, c in _recsys_configs(arch):
        names = [n for n, _ in convert.RECSYS_MODELS[arch](
            dataclasses.replace(c, dtype=torch.float32)
            if hasattr(c, "dtype") else c, "meta").named_parameters()]
        for _, jm, tm, jr, tr in MESH_CASES:
            got = tmodel.param_pspecs(c, tm, tr)
            assert sorted(got) == sorted(names), arch
            want = jmodel.param_pspecs(jc, jm, jr)
            for n, spec in got.items():
                assert spec == _spec(convert._jax_leaf(want, n)), \
                    (arch, n, tm)


@pytest.mark.parametrize("name", ["granite_3_2b", "deepseek_v3_671b"])
def test_optimizer_state_pspecs_match_jax(name):
    """AdamW's and SGD's state inherit the parameters' specs; Adafactor's
    factored leaves drop the factored dim's axis (``vr`` the last dim's,
    ``vc`` the next-to-last's), the rest keep a full ``v``."""
    from repro.models import transformer as jtf
    jc, c = _lm_configs(name)[0]
    for _, jm, tm, jr, tr in MESH_CASES:
        pspecs = tf.param_pspecs(c, tm, tr)
        jspecs = jtf.param_pspecs(jc, jm, jr)
        ad, jad = topt.adamw_state_pspecs(pspecs), \
            jopt.adamw_state_pspecs(jspecs)
        assert ad.step == _spec(jad.step) == ()
        assert ad.inner["m"] is pspecs and ad.inner["v"] is pspecs
        sg = topt.sgd_state_pspecs(pspecs)
        assert sg.step == () and sg.inner is pspecs
        af = topt.adafactor_state_pspecs(tf.named_param_shapes(c), pspecs)
        jaf = jopt.adafactor_state_pspecs(jtf.abstract_params(jc), jspecs)
        assert af.step == _spec(jaf.step)
        n_dense, _ = tf.layer_groups(c)
        factored = 0
        for n, st in af.inner.items():
            if n.startswith("layers."):
                _, i, leaf = n.split(".")
                grp = "dense_layers" if int(i) < n_dense else "moe_layers"
                want = {k: _spec(v)[1:] for k, v in
                        jaf.inner[grp][leaf].items()}
            else:
                want = {k: _spec(v) for k, v in jaf.inner[n].items()}
            assert st == want, (name, n)
            factored += "vr" in st
        assert factored > 0


def test_recsys_adafactor_state_pspecs_match_jax():
    from repro.models import dlrm as jdlrm
    from repro_torch.models import dlrm
    jc, c = _recsys_configs("dlrm")[0]
    _, jm, tm, jr, tr = MESH_CASES[-2]
    pspecs = dlrm.param_pspecs(c, tm, tr)
    shapes = {n: tuple(p.shape) for n, p in dlrm.DLRM(
        c, "meta").named_parameters()}
    got = topt.adafactor_state_pspecs(shapes, pspecs)
    want = jopt.adafactor_state_pspecs(jdlrm.abstract_params(jc),
                                       jdlrm.param_pspecs(jc, jm, jr))
    for n, st in got.inner.items():
        assert st == {k: _spec(v) for k, v in
                      convert._jax_leaf(want.inner, n).items()}, n
    assert set(got.inner["table"]) == {"vr", "vc"}


def test_state_shardings_match_jax():
    cfg = tstore.StoreConfig(n_users=64, n_items=128, max_baskets=8,
                             max_basket_size=4)
    jcfg = jstore.StoreConfig(n_users=64, n_items=128, max_baskets=8,
                              max_basket_size=4)
    for shape, names in MESHES:
        tm = ts.MeshShape(names, shape)
        got = tstore.state_shardings(cfg, tm)
        want = jstore.state_shardings(jcfg, AbstractMesh(shape, names))
        for f in dataclasses.fields(got):
            s = getattr(got, f.name)
            assert s.mesh == tm
            assert s.spec == _spec(getattr(want, f.name).spec), f.name


def test_placements_refuse_what_dtensor_cannot_place():
    from torch.distributed.tensor import Replicate, Shard
    m = ts.MeshShape(("pod", "data", "model"), (2, 2, 2))
    assert ts.placements(ts.Spec(("pod", "data"), "model"), m) == \
        [Shard(0), Shard(0), Shard(1)]
    assert ts.placements(ts.Spec(None, "data"), m) == \
        [Replicate(), Shard(1), Replicate()]
    assert ts.placements(ts.Spec(), m) == [Replicate()] * 3
    with pytest.raises(ValueError, match="order"):
        ts.placements(ts.Spec(("data", "pod")), m)
    with pytest.raises(ValueError, match="shards dims"):
        ts.placements(ts.Spec("data", "data"), m)
    with pytest.raises(ValueError, match="not one of"):
        ts.placements(ts.Spec("expert"), m)


def test_production_and_test_meshes_are_jax_s():
    assert tmesh.make_production_mesh() == ts.MeshShape(
        ("data", "model"), (16, 16))
    assert tmesh.make_production_mesh(multi_pod=True) == ts.MeshShape(
        ("pod", "data", "model"), (2, 16, 16))
    assert tmesh.make_test_mesh(3, 2) == ts.MeshShape(("data", "model"),
                                                      (3, 2))
    assert tmesh.make_rules() == ts.ShardingRules()
    assert dataclasses.asdict(tmesh.make_rules()) == \
        dataclasses.asdict(jmesh.make_rules())


# ---------------------------------------------------------------------------
# 8 ranks against devices_indices_map
# ---------------------------------------------------------------------------

M24 = ((2, 4), ("pod", "data"))
M222 = ((2, 2, 2), ("pod", "data", "model"))
DM24 = ((2, 4), ("data", "model"))
PLACE_CASES = [
    (M24, (8, 6), (("pod", "data"), None)),
    (M24, (8, 6), ("data", None)),
    (M24, (4, 8), ("pod", "data")),
    (M24, (4, 8), (None, ("pod", "data"))),
    (M24, (6, 8), (None, "data")),
    (M24, (2, 4, 8), ("pod", None, "data")),
    (M24, (8,), ()),
    (M222, (8, 4), (("pod", "data"), "model")),
    (M222, (4, 8), ("model", ("pod", "data"))),
    (M222, (16, 2), (("pod", "data", "model"), None)),
    (M222, (2, 6, 4), ("pod", None, ("data", "model"))),
]

INDEX_SCRIPT = r"""
import pickle, sys
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.launch.mesh import make_user_shard_meshes
cases, deals = pickle.load(open(sys.argv[1] + ".in", "rb"))
out = []
for (mshape, names), shape, spec in cases:
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(mshape), names)
    idx = NamedSharding(mesh, P(*spec)).devices_indices_map(shape)
    out.append({d.id: [(s.start or 0, shape[k] if s.stop is None
                        else s.stop) for k, s in enumerate(sl)]
                for d, sl in idx.items()})
meshes = [[[d.id for d in m.devices.ravel()] + [m.devices.shape]
           for m in make_user_shard_meshes(n, jax.devices()[:k])]
          for n, k in deals]
pickle.dump((out, meshes), open(sys.argv[1], "wb"))
"""
DEALS = [(3, 8), (4, 8), (8, 8), (5, 2), (1, 8)]


def _granite_cases():
    """The smoke granite's parameters by ``param_pspecs`` on a (2, 4)
    ("data", "model") mesh."""
    c = _module("repro_torch", "granite_3_2b").smoke_config()
    tm = ts.MeshShape(DM24[1], DM24[0])
    return [(DM24, shape, tuple(spec)) for (n, spec), shape in zip(
        tf.param_pspecs(c, tm, tmesh.make_rules()).items(),
        tf.named_param_shapes(c).values())]


@pytest.fixture(scope="module")
def placed(tmp_path_factory):
    import pickle
    d = tmp_path_factory.mktemp("place")
    cases = PLACE_CASES + _granite_cases()
    with open(str(d / "jax_result.pkl") + ".in", "wb") as f:
        pickle.dump((cases, DEALS), f)
    index, meshes = run_jax(INDEX_SCRIPT, d, 8)
    bad = [(M24, (6, 8), ("data", None)), (M222, (4, 3), (None, "model"))]
    payload = [{"mesh": m, "names": n, "shape": s, "spec": list(sp)}
               for (m, n), s, sp in cases]
    raising = [{"mesh": m, "names": n, "shape": s, "spec": list(sp)}
               for (m, n), s, sp in bad]
    ranks = run_ranks("distribute", 8, d, {"cases": payload,
                                           "raising": raising})
    return cases, index, meshes, ranks


def test_each_rank_holds_jax_s_block(placed):
    cases, index, _, ranks = placed
    assert len(ranks[0]["blocks"]) == len(cases)
    for i, (_, shape, spec) in enumerate(cases):
        x = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
        for r in range(8):
            want = x[tuple(slice(a, b) for a, b in index[i][r])]
            got = ranks[r]["blocks"][i]
            assert got.shape == want.shape and np.array_equal(got, want), \
                (shape, spec, r)


def test_distribute_refuses_a_dim_its_axes_do_not_divide(placed):
    _, _, _, ranks = placed
    for r in range(8):
        assert all("does not divide" in m for m in ranks[r]["raised"])
        assert len(ranks[r]["raised"]) == 2


def test_user_shard_meshes_deal_devices_as_jax(placed):
    _, _, meshes, _ = placed
    for (n, k), want in zip(DEALS, meshes):
        devs = [torch.device("cuda", i) for i in range(k)]
        got = tmesh.make_user_shard_meshes(n, devs)
        assert len(got) == n
        first = tmesh.make_user_shard_devices(n, devs)
        for s, (m, w) in enumerate(zip(got, want)):
            assert m.axis_names == ("data", "model")
            assert m.shape == tuple(w[-1])
            assert [d.index for d in m.devices] == w[:-1]
            assert m.devices[0] == first[s]


@pytest.mark.parametrize("module", ["parallel.sharding", "launch.mesh",
                                    "optim.compression"])
def test_every_public_name_has_a_counterpart(module):
    """Each public function and class the JAX module defines exists in
    the port's module of the same path."""
    import inspect
    jmod = importlib.import_module(f"repro.{module}")
    tmod = importlib.import_module(f"repro_torch.{module}")
    names = [n for n, v in vars(jmod).items() if not n.startswith("_")
             and (inspect.isfunction(v) or inspect.isclass(v))
             and v.__module__ == jmod.__name__]
    assert names
    assert [n for n in names if not hasattr(tmod, n)] == []
