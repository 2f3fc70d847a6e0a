"""The port's gradient compression against the JAX package's.

The five single-device functions (``quantize_int8``,
``dequantize_int8``, ``init_error_feedback``, ``compress_with_feedback``,
``decompress``) bit for bit against ``repro.optim.compression`` on f32
and bf16 inputs and an all-zero one, and at the bars of
``tests/test_compression.py``.  ``hierarchical_psum_mean`` in 8 gloo
ranks over ``("pod", "data")`` = (2, 4) (and over ``("data", "model")``
inside the pods of a (2, 2, 2) mesh), against JAX's run on 8 fake
devices: without ``err`` within one bf16 step of JAX's mean (the f32
intra-pod sums may round in another order before the bf16 cross-pod
sum) and at JAX's own bar against the plain mean; with ``err``, on
parts whose intra-pod sums are exact and whose maxima differ by pod,
the int32 cross-pod sums exact and each rank's mean and residual equal
to JAX's bit for bit, over 3 steps of error feedback, each pod decoding
with its own scale; on a length the intra-pod ranks do not divide, the
``all_reduce`` route.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import compression as jc
from repro_torch.optim import compression as tc
from torch_ranks import run_jax, run_ranks

BF = torch.bfloat16


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(dtype)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) \
        if not isinstance(x, torch.Tensor) else x.float().numpy()


def _bits(x):
    """A torch or JAX array's dtype name and bytes (bf16 as its bits)."""
    if isinstance(x, torch.Tensor):
        name = str(x.dtype).split(".")[-1]
        x = x.view(torch.int16) if x.dtype == BF else x
        return name, x.numpy().tobytes()
    a = np.asarray(x)
    name = a.dtype.name
    return name, (a.view(np.int16) if name == "bfloat16" else a).tobytes()


def _inputs(rng, dtype):
    x = (rng.normal(size=(37, 19)) * 3.0).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    return _t(x, dtype), jnp.asarray(x, jdt)


@pytest.mark.parametrize("dtype", [torch.float32, BF])
def test_quantize_and_dequantize_are_jax_bitwise(rng, dtype):
    x, jx = _inputs(rng, dtype)
    q, scale = tc.quantize_int8(x)
    jq, jscale = jc.quantize_int8(jx)
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    assert scale.dim() == 0
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert _bits(scale) == _bits(jscale)
    for out_dt, jdt in ((torch.float32, jnp.float32), (BF, jnp.bfloat16)):
        got = tc.dequantize_int8(q, scale, out_dt)
        assert got.dtype == out_dt
        assert _bits(got) == _bits(jc.dequantize_int8(jq, jscale, jdt))


def test_all_zero_tensor_takes_the_floor_scale():
    q, scale = tc.quantize_int8(torch.zeros(5, 3))
    jq, jscale = jc.quantize_int8(jnp.zeros((5, 3)))
    assert not q.any()
    assert float(scale) == np.float32(np.float32(1e-30) / np.float32(127.0))
    assert _bits(scale) == _bits(jscale)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))


@pytest.mark.parametrize("dtype", [torch.float32, BF])
def test_compress_with_feedback_is_jax_bitwise_over_steps(rng, dtype):
    """A tree of leaves (one bf16), 5 steps of error feedback: each
    step's int8 values, scales, residuals and decoded gradients equal
    JAX's, op by op as ``test_compression.py`` runs them."""
    shapes = {"w": (33, 7), "b": (7,), "deep": [(4, 4), (9,)]}
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16

    def draw():
        g = {"w": rng.normal(size=shapes["w"]), "b": rng.normal(size=(7,)),
             "deep": [rng.normal(size=s) * 1e-3 for s in shapes["deep"]]}
        port = {"w": _t(g["w"], dtype), "b": _t(g["b"]),
                "deep": [_t(a) for a in g["deep"]]}
        ref = {"w": jnp.asarray(np.float32(g["w"]), jdt),
               "b": jnp.asarray(np.float32(g["b"])),
               "deep": [jnp.asarray(np.float32(a)) for a in g["deep"]]}
        return port, ref

    g, jg = draw()
    err, jerr = tc.init_error_feedback(g), jc.init_error_feedback(jg)
    assert all(e.dtype == torch.float32 and not e.any()
               for e in (err["w"], err["b"], *err["deep"]))
    for _ in range(5):
        g, jg = draw()
        q, scales, err = tc.compress_with_feedback(g, err)
        jq, jscales, jerr = jc.compress_with_feedback(jg, jerr)
        dec, jdec = tc.decompress(q, scales), jc.decompress(jq, jscales)
        for got, want in ((q, jq), (scales, jscales), (err, jerr),
                          (dec, jdec)):
            for a, b in zip((got["w"], got["b"], *got["deep"]),
                            (want["w"], want["b"], *want["deep"])):
                assert _bits(a) == _bits(b)
    # a bare tensor is a tree of one leaf
    q1, s1, e1 = tc.compress_with_feedback(g["b"], err["b"])
    assert torch.equal(q1, tc.quantize_int8(g["b"] + err["b"])[0])


def test_quantize_roundtrip_error_bound(rng):
    """The bar of ``test_compression.py``: at most half a step."""
    x = _t(rng.normal(size=(256,)) * 3.0)
    q, scale = tc.quantize_int8(x)
    err = float((tc.dequantize_int8(q, scale) - x).abs().max())
    assert err <= float(scale) / 2 + 1e-7


def test_error_feedback_is_unbiased_over_steps(rng):
    """Σ decoded_t ≈ Σ g_t: the residual carries the rounding error, so
    what remains is at most the last step's quantization step."""
    grads = {"w": _t(rng.normal(size=(64,)))}
    err = tc.init_error_feedback(grads)
    total_true, total_sent = np.zeros(64), np.zeros(64)
    for _ in range(30):
        g = {"w": _t(rng.normal(size=(64,)) * 0.01)}
        q, scales, err = tc.compress_with_feedback(g, err)
        total_true += g["w"].numpy()
        total_sent += tc.decompress(q, scales)["w"].numpy()
    resid = np.max(np.abs(total_true - total_sent))
    assert resid <= float(scales["w"]) + 1e-6


# ---------------------------------------------------------------------------
# hierarchical_psum_mean in 8 ranks
# ---------------------------------------------------------------------------

STEPS = 3
# name, mesh, axis names, intra axes, inter axis, local shape, err length
CASES = [
    ("plain", (2, 4), ("pod", "data"), ("data",), "pod", (64,), 0),
    ("feedback", (2, 4), ("pod", "data"), ("data",), "pod", (64,), 16),
    ("ragged", (2, 4), ("pod", "data"), ("data",), "pod", (3, 5), 0),
    ("ragged_fb", (2, 4), ("pod", "data"), ("data",), "pod", (3, 5), 15),
    ("two_axes", (2, 2, 2), ("pod", "data", "model"), ("data", "model"),
     "pod", (4, 8), 8),
]

JAX_SCRIPT = r"""
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro import compat
from repro.optim.compression import hierarchical_psum_mean
inputs, cases = pickle.load(open(sys.argv[1] + ".in", "rb"))
out = {}
for name, shape, names, intra, inter, local, n_err in cases:
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(shape), names)
    rows = P(names, *([None] * len(local)))
    if n_err:
        def body(xl, el):
            m, e = hierarchical_psum_mean(xl[0], intra, inter, err=el[0])
            return m[None], e[None]
        specs = dict(in_specs=(rows, P(names, None)),
                     out_specs=(rows, P(names, None)))
    else:
        def body(xl):
            return hierarchical_psum_mean(xl[0], intra, inter)[0][None]
        specs = dict(in_specs=rows, out_specs=rows)
    fn = jax.jit(compat.shard_map(body, mesh=mesh, check_vma=False, **specs))
    err = jnp.zeros((8, n_err), jnp.float32)
    steps = []
    for x in inputs[name]:
        with compat.set_mesh(mesh):
            if n_err:
                m, err = fn(jnp.asarray(x), err)
                steps.append((np.asarray(m), np.asarray(err)))
            else:
                steps.append((np.asarray(fn(jnp.asarray(x))), None))
    out[name] = steps
pickle.dump(out, open(sys.argv[1], "wb"))
"""


def _case_inputs(rng):
    """Per case [steps, 8 ranks, *local] f32.  "plain": normal values.
    The feedback cases: multiples of 1/16 below 2^6 in size (every
    intra-pod sum exact in f32, whatever its order), pod 1's four times
    pod 0's, so the pods' maxima (and scales) differ."""
    out = {}
    for name, _, _, _, _, local, _ in CASES:
        shape = (STEPS, 8) + local
        if name == "plain" or name == "ragged":
            out[name] = rng.normal(size=shape).astype(np.float32)
            continue
        x = rng.integers(-256, 256, size=shape).astype(np.float32) / 16
        x[:, 4:] *= 4
        out[name] = x
    return out


def _emulate_feedback(xs, mesh, n_intra, n_err):
    """The with-err route in numpy f32, op by op as the port runs it:
    the exact intra-pod sums, each part quantized with its own scale,
    the int32 sums over pods, decoded with the local scale.  Returns per step [8, ...] means and [8, n]
    residuals."""
    n_pods = 2
    flat = xs.reshape(xs.shape[0], n_pods, n_intra, -1)
    length = flat.shape[-1]
    scattered = length % n_intra == 0
    err = np.zeros((n_pods, n_intra, n_err), np.float32)
    steps = []
    for t in range(xs.shape[0]):
        sums = flat[t].sum(axis=1, dtype=np.float64).astype(np.float32)
        part = (sums.reshape(n_pods, n_intra, -1) if scattered
                else np.repeat(sums[:, None], n_intra, axis=1))
        target = part + err
        scale = np.maximum(np.abs(target).max(axis=-1, keepdims=True),
                           np.float32(1e-30)) / np.float32(127.0)
        q = np.clip(np.rint(target / scale), -127, 127).astype(np.int32)
        err = target - q.astype(np.float32) * scale
        dec = q.sum(axis=0, keepdims=True).astype(np.float32) * scale
        full = dec.reshape(n_pods, 1, -1) if scattered else dec[:, :1]
        mean = np.broadcast_to(full / np.float32(n_pods * n_intra),
                               (n_pods, n_intra, length))
        steps.append((mean.reshape((8,) + xs.shape[2:]),
                      err.reshape(8, n_err), scale.reshape(8)))
    return steps


@pytest.fixture(scope="module")
def hierarchical_runs(tmp_path_factory):
    """One 8-rank run of every case, JAX's run on 8 fake devices, and
    the inputs."""
    import pickle
    d = tmp_path_factory.mktemp("hier")
    inputs = _case_inputs(np.random.default_rng(7))
    np.savez(d / "inputs.npz", **inputs)
    with open(str(d / "jax_result.pkl") + ".in", "wb") as f:
        pickle.dump((inputs, CASES), f)
    want = run_jax(JAX_SCRIPT, d, 8)
    cases = [{"name": n, "mesh": m, "names": a, "intra": i, "inter": o,
              "err": e} for n, m, a, i, o, _, e in CASES]
    ranks = run_ranks("hierarchical", 8, d,
                      {"inputs": str(d / "inputs.npz"), "cases": cases})
    return inputs, want, ranks


def _bf16_step(v):
    """One bf16 step (2^-7 of the binade) of each value."""
    a = np.maximum(np.abs(v), np.float32(2.0 ** -120))
    return np.exp2(np.floor(np.log2(a)) - 7)


@pytest.mark.parametrize("name", ["plain", "ragged"])
def test_hierarchical_mean_without_err_meets_jax(hierarchical_runs, name):
    inputs, want, ranks = hierarchical_runs
    xs = inputs[name]
    for t in range(STEPS):
        expect = xs[t].mean(axis=0)
        jax_mean = want[name][t][0]
        for r in range(8):
            got, err = ranks[r][name][t]
            assert err is None and got.shape == xs.shape[2:]
            assert got.dtype == np.float32
            # JAX's own bar against the plain mean
            np.testing.assert_allclose(got, expect, rtol=2e-2, atol=1e-3)
            np.testing.assert_allclose(jax_mean[r], expect, rtol=2e-2,
                                       atol=1e-3)
            assert np.all(np.abs(got - jax_mean[r])
                          <= _bf16_step(jax_mean[r])), (name, t, r)


def _decoded_ints(mean, scale, n_intra):
    """The int32 cross-pod sums a rank's mean decodes: each element
    times the ranks over the scale of the part it came from (its intra
    peer's in the reduce-scatter route, its own in the all-reduce one).
    Exact integers while |q| < 2^22, whatever the scale's last bit."""
    flat = mean.reshape(8, -1)
    pods = scale.reshape(2, n_intra)
    if flat.shape[1] % n_intra == 0:
        per = np.repeat(pods, flat.shape[1] // n_intra, axis=1)
        per = np.repeat(per, n_intra, axis=0)
    else:
        per = np.repeat(scale[:, None], flat.shape[1], axis=1)
    return np.rint(flat.astype(np.float64) * 8 / per).astype(np.int64)


@pytest.mark.parametrize("name", ["feedback", "ragged_fb", "two_axes"])
def test_hierarchical_mean_with_err_meets_jax(hierarchical_runs, name):
    """Each rank's mean and residual bit for bit the numpy emulation of
    the route, step after step of error feedback: the int32 cross-pod
    sums exact, each pod decoding with its own scale (pod 1's mean is
    not pod 0's, as the reference's is not).  Against JAX's run: the
    same int32 sums at the first step (the residual still 0); after
    it XLA's fused multiply-subtract rounds JAX's residual once where
    the port's ops round twice, so a later target may sit across a
    rounding tie from JAX's, and the sums and residuals agree within one
    int8 step."""
    inputs, want, ranks = hierarchical_runs
    _, mesh, _, intra, _, local, n_err = next(c for c in CASES
                                              if c[0] == name)
    n_intra = int(np.prod(mesh[1:]))
    emulated = _emulate_feedback(inputs[name], mesh, n_intra, n_err)
    for t in range(STEPS):
        mean, err, scale = emulated[t]
        jax_mean, jax_err = want[name][t]
        for r in range(8):
            got, got_err = ranks[r][name][t]
            assert got.tobytes() == mean[r].tobytes(), (name, t, r)
            assert got_err.tobytes() == err[r].tobytes(), (name, t, r)
        assert not np.array_equal(mean[0], mean[4])
        assert not np.array_equal(jax_mean[0], jax_mean[4])
        ints = _decoded_ints(mean, scale, n_intra)
        jax_ints = _decoded_ints(jax_mean, scale, n_intra)
        if t == 0:
            np.testing.assert_array_equal(jax_ints, ints)
        assert np.abs(jax_ints - ints).max() <= 1, (name, t)
        assert np.all(np.abs(jax_err - err)
                      <= scale[:, None] * 1.001), (name, t)
