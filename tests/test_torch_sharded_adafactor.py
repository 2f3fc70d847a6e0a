"""Adafactor over DTensor parameters in gloo ranks, against the JAX
package's ``adafactor`` under GSPMD and against the port's one device.

4 ranks on the (2, 2) ("data", "model") mesh hold each parameter as a
DTensor placed by its spec, and its state as the blocks
``adafactor_state_pspecs`` lays out.  The JAX side jits ``adafactor()``'s
update with those shardings on 4 fake devices (Auto axes: on jax 0.9.0
``jax.make_mesh`` gives Explicit ones).  ``min_dim_factored`` is lowered
to 8 in both, so leaves of tens of rows are factored: one split by rows,
one by columns, one both ways, one whose rows lie over both axes, two
stacked ``[L, r, c]`` leaves (split on their last two dims, and on L and
the columns), a replicated factored leaf, an unfactored vector split
over "model", a replicated vector and an unfactored matrix split by
rows.  Two steps from seeded gradients, clipped by their global norm:
every parameter and its ``vr`` / ``vc`` (or ``v``) within ``rtol=1e-5,
atol=1e-7`` of JAX's and of the one-device port's.  The smoke DeepSeek
(``d_model`` 64) factors no leaf, so this is the test of the factored
path across shards.
"""
import numpy as np
import pytest
import torch

from repro_torch.optim import optimizers
from repro_torch.parallel.sharding import Spec
from torch_ranks import run_jax, run_ranks, started

MESH, NAMES = [2, 2], ["data", "model"]
HYPER = dict(lr=1e-2, min_dim_factored=8)
STEPS = 2
TOL = dict(rtol=1e-5, atol=1e-7)
# name: (shape, spec entries)
LEAVES = {
    "rows": ((16, 24), ["data", None]),
    "cols": ((24, 16), [None, "model"]),
    "both": ((16, 32), ["data", "model"]),
    "wide": ((32, 8), [["data", "model"], None]),
    "stack": ((4, 16, 16), [None, "data", "model"]),
    "stack_l": ((4, 8, 16), ["data", None, "model"]),
    "repl": ((16, 16), []),
    "vec": ((32,), ["model"]),
    "norm": ((12,), []),
    "thin": ((16, 4), ["data", None]),
}

JAX_SCRIPT = r"""
import pickle, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.optim import adafactor, adafactor_state_pspecs
LEAVES, HYPER, STEPS, INPUTS = ARGS
auto = getattr(jax.sharding, "AxisType", None)
mesh = jax.make_mesh((2, 2), ("data", "model"), **(
    {"axis_types": (auto.Auto, auto.Auto)} if auto else {}))
data = np.load(INPUTS)
spec = {n: P(*[tuple(e) if isinstance(e, list) else e for e in s])
        for n, (_, s) in LEAVES.items()}
named = lambda t: jax.tree.map(lambda s: NamedSharding(mesh, s), t,
                               is_leaf=lambda x: isinstance(x, P))
params = {n: jnp.asarray(data[n]) for n in LEAVES}
opt = adafactor(lr=HYPER["lr"], min_dim_factored=HYPER["min_dim_factored"])
abstract = {n: jax.ShapeDtypeStruct(v.shape, v.dtype)
            for n, v in params.items()}
st_spec = adafactor_state_pspecs(abstract, spec, HYPER["min_dim_factored"])
p_sh, s_sh = named(spec), named(st_spec)
params = jax.device_put(params, p_sh)
state = jax.device_put(opt.init(params), s_sh)
step = jax.jit(lambda g, s, p: opt.update(g, s, p),
               in_shardings=(p_sh, s_sh, p_sh), out_shardings=(p_sh, s_sh))
for t in range(STEPS):
    grads = jax.device_put({n: jnp.asarray(data[f"{n}.g{t}"])
                            for n in LEAVES}, p_sh)
    params, state = step(grads, state, params)
out = {n: {"param": np.asarray(params[n]),
           **{k: np.asarray(v) for k, v in state.inner[n].items()},
           "state_spec": {k: tuple(v) for k, v in st_spec.inner[n].items()}}
       for n in LEAVES}
pickle.dump(out, open(sys.argv[1], "wb"))
"""


def _inputs(path):
    rng = np.random.default_rng(39)
    arrays = {}
    for n, (shape, _) in LEAVES.items():
        arrays[n] = rng.normal(size=shape).astype(np.float32)
        for t in range(STEPS):
            # gradients of differing scales, so the clip and the RMS
            # clip both act
            scale = 10.0 ** rng.integers(-3, 1)
            arrays[f"{n}.g{t}"] = (scale * rng.normal(size=shape)).astype(
                np.float32)
    np.savez(path, **arrays)
    return arrays


def _one_device(arrays):
    names = sorted(LEAVES)
    params = [torch.nn.Parameter(torch.from_numpy(arrays[n].copy()))
              for n in names]
    opt = optimizers.adafactor(params, **HYPER)
    for t in range(STEPS):
        for n, p in zip(names, params):
            p.grad = torch.from_numpy(arrays[f"{n}.g{t}"].copy())
        opt.step()
    return {n: {"param": p.detach().numpy(),
                **{k: v.numpy() for k, v in opt.state[p].items()}}
            for n, p in zip(names, params)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded_adafactor")
    path = str(d / "inputs.npz")
    arrays = _inputs(path)
    script = JAX_SCRIPT.replace(
        "ARGS", repr(({n: (list(s), e) for n, (s, e) in LEAVES.items()},
                      HYPER, STEPS, path)))
    want = started(run_jax, script, d, 4)
    ranks = run_ranks("sharded_adafactor", 4, d, {
        "mesh": MESH, "names": NAMES, "inputs": path, "hyper": HYPER,
        "steps": STEPS, "specs": {n: e for n, (_, e) in LEAVES.items()}})
    return ranks, want(), _one_device(arrays), arrays


def _state_keys(name):
    shape = LEAVES[name][0]
    k = HYPER["min_dim_factored"]
    factored = len(shape) >= 2 and min(shape[-2:]) >= k
    return ("vr", "vc") if factored else ("v",)


@pytest.mark.parametrize("name", sorted(LEAVES))
def test_sharded_leaf_matches_jax_and_one_device(runs, name):
    ranks, want, one, arrays = runs
    got = ranks[0][name]
    keys = ("param",) + _state_keys(name)
    assert set(got) - {"state_spec"} == set(keys)
    for k in keys:
        np.testing.assert_allclose(got[k], want[name][k], **TOL,
                                   err_msg=f"{name}.{k} vs JAX")
        np.testing.assert_allclose(got[k], one[name][k], **TOL,
                                   err_msg=f"{name}.{k} vs one device")
    # every rank gathers the same values
    for r in ranks[1:]:
        for k in keys:
            np.testing.assert_array_equal(r[name][k], got[k])
    # the steps moved the parameter
    assert not np.allclose(got["param"], arrays[name], rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", sorted(LEAVES))
def test_state_lies_as_the_reference_specs_lay_it(runs, name):
    """Each state leaf's placements are ``adafactor_state_pspecs``' spec,
    as JAX's state specs read (a factored leaf's ``vr`` drops the last
    dim's axes, ``vc`` the next-to-last's)."""
    ranks, want, _, _ = runs
    for k in _state_keys(name):
        got = Spec(*ranks[0][name]["state_spec"][k])
        ref = tuple(want[name]["state_spec"][k])
        ref = Spec(*ref) if ref else Spec()
        assert tuple(got.axes(d) for d in range(len(LEAVES[name][0]) + 1)) \
            == tuple(ref.axes(d) for d in range(len(LEAVES[name][0]) + 1)), \
            (name, k, got, ref)


def test_one_device_is_unchanged_by_the_mesh_route():
    """Without DTensors the optimizer keeps its one-device state and
    answers (the factored leaf's state is plain tensors)."""
    p = torch.nn.Parameter(torch.ones(16, 16))
    opt = optimizers.adafactor([p], **HYPER)
    assert set(opt.state[p]) == {"vr", "vc"}
    assert type(opt.state[p]["vr"]) is torch.Tensor
