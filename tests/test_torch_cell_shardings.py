"""Every LM, recommender and GNN cell's ``in_shardings`` against the JAX
cell's at the production mesh.

The JAX cells are built in a subprocess with the 256 fake devices the
single-pod mesh needs (``make_production_mesh()``, ``make_rules``; the
dry run's ``XLA_FLAGS``); only their specs come back.  tifu-knn's three
cells (the paper's own system) against ``configs/tifu_knn.cell_shardings``
field by field, at the single-pod and the multi-pod production meshes.  The port's come
from ``Cell.shardings()`` at the published sizes, from shapes alone:
nothing is allocated on either side.  Parameters are matched through
the conversion's name maps (an LM layer's spec is its stacked JAX
leaf's without the leading ``None``), the optimizer state (AdamW's
``m`` / ``v``, Adafactor's ``vr`` / ``vc`` / ``v``), caches and batch
leaf for leaf.  A cell built at the CPU's sizes records its own sizes'
shardings in ``CellProgram.in_shardings``.
"""
import pytest

from repro_torch import convert
from repro_torch.configs import all_cells, get_arch, smoke_sizes
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer as tf
from repro_torch.parallel.sharding import Sharding
from torch_ranks import run_jax

CELLS = [(a, s) for a, s in all_cells() if get_arch(a).family != "tifu"]

JAX_SCRIPT = r"""
import pickle, sys
import jax
from jax.sharding import NamedSharding
from repro.configs import REGISTRY
from repro.launch.mesh import make_production_mesh, make_rules
mesh = make_production_mesh()
rules = make_rules(mesh)
out = {"mesh": (tuple(mesh.axis_names), tuple(mesh.devices.shape))}
for name, arch in REGISTRY.items():
    if arch.family == "tifu":
        continue
    for shape, build in arch.cells.items():
        prog = build(mesh, rules)
        out[(name, shape)] = jax.tree.map(
            lambda s: tuple(s.spec), prog.in_shardings,
            is_leaf=lambda x: isinstance(x, NamedSharding))
pickle.dump(out, open(sys.argv[1], "wb"))
"""


@pytest.fixture(scope="module")
def jax_cells(tmp_path_factory):
    return run_jax(JAX_SCRIPT, tmp_path_factory.mktemp("cells"), 256)


def _specs(tree):
    """A port shardings tree as specs (every leaf on the production
    mesh)."""
    mesh = make_production_mesh()
    if isinstance(tree, Sharding):
        assert tree.mesh == mesh
        return tuple(tree.spec)
    if isinstance(tree, dict):
        return {k: _specs(v) for k, v in tree.items()}
    assert isinstance(tree, tuple)
    out = [_specs(v) for v in tree]
    return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)


def _param_leaf(family, config):
    """``(jax_tree, port_name) -> spec`` of a cell's parameter tree, and
    ``port_name -> the JAX leaf's name``."""
    if family != "lm":
        return (lambda tree, name: convert._jax_leaf(tree, name),
                lambda name: name)
    n_dense, _ = tf.layer_groups(config)

    def jax_name(name):
        if not name.startswith("layers."):
            return name
        _, i, key = name.split(".")
        group = "dense_layers" if int(i) < n_dense else "moe_layers"
        return f"{group}.{key}"

    def leaf(tree, name):
        full = convert._jax_leaf(tree, jax_name(name))
        if name == jax_name(name):
            return full
        assert full[0] is None
        return full[1:]
    return leaf, jax_name


def _n_specs(tree):
    if isinstance(tree, dict):
        return sum(_n_specs(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_n_specs(v) for v in tree)
    return 1


def _same_params(got, want, leaf):
    """Every port parameter's spec is its JAX leaf's, and every JAX leaf
    is some port parameter's (an LM's stacked leaf, each layer's)."""
    leaf, jax_name = leaf
    assert isinstance(got, dict)
    for name, spec in got.items():
        assert spec == leaf(want, name), name
    assert len({jax_name(n) for n in got}) == _n_specs(want)


STATE_KEYS = {"v", "vr", "vc"}


def _state(tree, k):
    """Adafactor's JAX state tree with each parameter's state dict
    replaced by its ``k`` entry (None where it has none)."""
    if isinstance(tree, dict) and tree and set(tree) <= STATE_KEYS:
        return tree.get(k)
    if isinstance(tree, dict):
        return {n: _state(v, k) for n, v in tree.items()}
    return [_state(v, k) for v in tree]


def _same_opt(got, want, leaf):
    assert got.step == want.step == ()
    if set(got.inner) == {"m", "v"}:          # AdamW
        for k in ("m", "v"):
            _same_params(got.inner[k], want.inner[k], leaf)
        return
    for name, st in got.inner.items():       # Adafactor
        assert set(st) in ({"v"}, {"vr", "vc"}), name
        for k, spec in st.items():
            assert spec == leaf[0](_state(want.inner, k), name), (name, k)


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}/{s}" for a, s in CELLS])
def test_in_shardings_are_the_jax_cell_s(jax_cells, arch, shape):
    assert jax_cells["mesh"] == (make_production_mesh().axis_names,
                                 make_production_mesh().shape)
    a = get_arch(arch)
    cell = a.cells[shape]
    got = _specs(cell.shardings())
    want = jax_cells[(arch, shape)]
    assert len(got) == len(want)
    leaf = _param_leaf(a.family, cell.published.config)
    _same_params(got[0], want[0], leaf)
    rest, jrest = list(got[1:]), list(want[1:])
    if hasattr(rest[0], "_fields"):           # training: the optimizer
        _same_opt(rest.pop(0), jrest.pop(0), leaf)
    if a.family == "lm" and cell.kind == "decode":
        caches, jcaches = rest.pop(0), jrest.pop(0)
        assert caches == {k: tuple(v) for k, v in jcaches.items()}
    assert rest == jrest


@pytest.mark.parametrize("arch,shape", [("granite-3-2b", "train_4k"),
                                        ("deepseek-v3-671b", "decode_32k"),
                                        ("dlrm-mlperf", "train_batch"),
                                        ("bert4rec", "retrieval_cand")])
def test_a_built_cell_records_its_own_sizes(arch, shape):
    cell = get_arch(arch).cells[shape]
    sz = smoke_sizes(arch, shape)
    prog = cell(device="cpu", sizes=sz)
    assert prog.in_shardings == cell.shardings(sz)
    assert _specs(prog.in_shardings)


TIFU_SCRIPT = r"""
import dataclasses, pickle, sys
import jax
from repro.configs import REGISTRY
from repro.launch.mesh import make_production_mesh, make_rules


def specs(x):
    if dataclasses.is_dataclass(x):
        return {f.name: tuple(getattr(x, f.name).spec)
                for f in dataclasses.fields(x)}
    return tuple(x.spec)


out = {}
for pods in (1, 2):
    mesh = make_production_mesh(multi_pod=pods > 1)
    rules = make_rules(mesh)
    out[pods] = {"mesh": (tuple(mesh.axis_names), tuple(mesh.devices.shape))}
    for shape, build in REGISTRY["tifu-knn"].cells.items():
        out[pods][shape] = [specs(a) for a in build(mesh, rules).in_shardings]
pickle.dump(out, open(sys.argv[1], "wb"))
"""


@pytest.fixture(scope="module")
def jax_tifu(tmp_path_factory):
    return run_jax(TIFU_SCRIPT, tmp_path_factory.mktemp("tifu"), 512)


def _tifu_specs(arg):
    import dataclasses
    if not isinstance(arg, Sharding):
        return {f.name: tuple(getattr(arg, f.name).spec)
                for f in dataclasses.fields(arg)}
    return tuple(arg.spec)


@pytest.mark.parametrize("pods", [1, 2])
@pytest.mark.parametrize("shape", ["stream_update", "serve_topk",
                                   "serve_topk_opt"])
def test_tifu_cells_record_the_jax_cell_s_shardings(jax_tifu, shape, pods):
    from repro_torch.configs import tifu_knn
    from repro_torch.launch.mesh import make_rules
    mesh = make_production_mesh(multi_pod=pods > 1)
    assert jax_tifu[pods]["mesh"] == (mesh.axis_names, mesh.shape)
    got = [_tifu_specs(a) for a in tifu_knn.cell_shardings(
        shape, mesh, make_rules(mesh))]
    assert got == jax_tifu[pods][shape]
    if pods == 1:
        default = [_tifu_specs(a) for a in tifu_knn.cell_shardings(shape)]
        assert default == got


@pytest.mark.parametrize("shape", ["stream_update", "serve_topk"])
def test_a_built_tifu_cell_records_the_production_shardings(shape):
    from repro_torch.configs import tifu_knn
    prog = get_arch("tifu-knn").cells[shape](
        device="cpu", sizes=smoke_sizes("tifu-knn", shape))
    assert [_tifu_specs(a) for a in prog.in_shardings] == \
        [_tifu_specs(a) for a in tifu_knn.cell_shardings(shape)]
