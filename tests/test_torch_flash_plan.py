"""The attention kernel's plan, and its plain version at the plan's edges.

``flash_attention.plan_flash`` decides from the input alone which CUDA
design runs it: ``tma_wgmma`` (128-query tiles, a TMA-fed ring of
128-key K/V tiles, ``wgmma``) for bf16 with D in {64, 128} and 16-byte
aligned rows, ``mma_sync`` for bf16 with D = 32 and aligned rows,
``cuda_cores`` for everything else.  The kernels run only on the card
(``chip_smoke.py`` holds each against the plain version there); here
the plan is held to the rules the C entries apply, its shared memory to
one block's, its query tiles to covering every query once, and its key
tiles to skipping only tiles that the mask hides from every row of the
query tile (the mask computed in numpy).  Then the port's plain
``ref.flash_attention_ref`` is held against the JAX package at the new
tile edges (S around 128, windows across a 128-key edge, D 64 and 128,
grouped KV heads): the Pallas kernel in interpret mode where S divides
its 128-row blocks, the JAX package's plain reference or its
transformer's attention elsewhere.

Tolerance ``atol=1e-4`` in f32: the same math with sums in another
order (as ``test_torch_transformer.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro.models import transformer as jtf
from repro_torch.kernels import flash_attention, ref

SMEM_MAX = 232448            # shared memory one block may use on an H100
ATOL = 1e-4
BF, F32 = torch.bfloat16, torch.float32


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _c_entry_design(q, k, v):
    """The design whose C entry takes these inputs, from the conditions
    written in ``flash_attention_wgmma.cu`` (``flash_wgmma_launch``) and
    ``flash_attention.cu`` (``mma_ok``), independently of the plan."""
    d = q.shape[3]
    bases = all(t.data_ptr() % 16 == 0 for t in (q, k, v))
    strides = [x for t in (q, k, v) for x in t.stride()[:3]]
    rows = bases and all(x > 0 and x % 8 == 0 for x in strides)
    if q.dtype == BF and d in (64, 128) and rows:
        return "tma_wgmma"
    if q.dtype == BF and d == 32 and rows:
        return "mma_sync"
    return "cuda_cores"


def _qkv(b, s, h, kv, d, dtype=BF):
    return (torch.zeros((b, s, h, d), dtype=dtype),
            torch.zeros((b, s, kv, d), dtype=dtype),
            torch.zeros((b, s, kv, d), dtype=dtype))


def _case(name):
    """(q, k, v) of each routing case."""
    if name == "granite":
        return _qkv(4, 64, 32, 8, 64)
    if name == "d128":
        return _qkv(1, 129, 4, 4, 128)
    if name == "d32":
        return _qkv(2, 190, 8, 2, 32)
    if name == "f32":
        return _qkv(2, 64, 4, 2, 64, F32)
    if name in ("d96", "d256", "d16"):
        return _qkv(1, 72, 4, 4, int(name[1:]))
    if name == "strided_heads":
        wide = torch.zeros((2, 77, 8, 64), dtype=BF)
        return wide[:, :, ::2], wide[:, :, 1::4], wide[:, :, 3::4]
    if name == "unaligned_base":
        pad = torch.zeros((2, 90, 4, 72), dtype=BF)
        return pad[:, :, :, 1:65], pad[:, :, :2, 3:67], pad[:, :, 2:, 5:69]
    if name == "head_stride_not_8":
        pad = torch.zeros((2, 40, 4, 68), dtype=BF)
        return pad[..., :64], pad[:, :, :2, :64], pad[:, :, 2:, :64]
    if name == "expanded_kv":
        q, k, v = _qkv(1, 40, 4, 1, 64)
        return q, k.expand(1, 40, 4, 64), v.expand(1, 40, 4, 64)
    if name == "one_token":
        return _qkv(2, 1, 2, 1, 64)
    raise KeyError(name)


@pytest.mark.parametrize("name,design", [
    ("granite", "tma_wgmma"), ("d128", "tma_wgmma"),
    ("strided_heads", "tma_wgmma"), ("one_token", "tma_wgmma"),
    ("d32", "mma_sync"), ("f32", "cuda_cores"), ("d96", "cuda_cores"),
    ("d256", "cuda_cores"), ("d16", "cuda_cores"),
    ("unaligned_base", "cuda_cores"), ("head_stride_not_8", "cuda_cores"),
    ("expanded_kv", "cuda_cores")])
def test_plan_routes_as_the_c_entries(name, design):
    q, k, v = _case(name)
    plan = flash_attention.plan_flash(q, k, v)
    assert plan.design == design == _c_entry_design(q, k, v)
    tiles = {"tma_wgmma": (192 if q.shape[3] == 64 else 128, 128),
             "mma_sync": (64, 64), "cuda_cores": (64, 64)}[design]
    assert (plan.bq, plan.bk) == tiles


@pytest.mark.parametrize("d", range(1, flash_attention.MAX_D + 1, 7))
@pytest.mark.parametrize("dtype", [BF, F32])
def test_shared_memory_fits_one_block(d, dtype):
    plan = flash_attention.plan_flash(*_qkv(1, 8, 2, 2, d, dtype))
    assert 0 < plan.smem_bytes <= SMEM_MAX


@pytest.mark.parametrize("d,stages,bq", [(64, 2, 192), (128, 2, 128)])
def test_wgmma_shared_memory_is_its_layout(d, stages, bq):
    """Two Q tiles of ``bq`` rows and ``stages`` K and V tiles of 128
    rows, each row D bf16, two mbarriers per Q tile and four per stage,
    and the 1024-byte alignment slack of the 128-byte swizzle; both
    kernels built fit one block, and a third stage would not at
    D = 128."""
    assert flash_attention.wgmma_smem_bytes(d, stages) == \
        1024 + (2 * bq + 2 * stages * 128) * d * 2 + 8 * (4 + 4 * stages)
    assert flash_attention.wgmma_smem_bytes(d, stages) <= SMEM_MAX
    assert flash_attention.wgmma_smem_bytes(128, 3) > SMEM_MAX
    assert flash_attention.WGMMA_STAGES == 2
    assert flash_attention.WGMMA_BQ == {64: 192, 128: 128}


def _plans(s, causal, window):
    """One plan of each tile size at this S."""
    return [flash_attention.plan_flash(*_qkv(1, s, 2, 2, d), window=window,
                                       causal=causal) for d in (64, 128, 32)]


@pytest.mark.parametrize("s", [1, 63, 127, 128, 129, 191, 192, 193, 255,
                               256, 257, 640, 4096])
def test_query_tiles_cover_each_query_once(s):
    for plan in _plans(s, True, 0):
        starts = plan.tiles()
        assert starts == sorted(starts, reverse=True)   # longest rows first
        seen = np.zeros(s, dtype=int)
        for q0 in starts:
            assert -plan.bq < q0 < s
            seen[max(q0, 0): q0 + plan.bq] += 1
        assert (seen == 1).all()
        if plan.design == "tma_wgmma":     # only the last tile is partial
            assert all(q0 >= 0 for q0 in starts[:-1])
            assert starts[0] + plan.bq == s


def _mask(s, causal, window):
    qpos, kpos = np.arange(s)[:, None], np.arange(s)[None, :]
    keep = np.ones((s, s), dtype=bool)
    if causal:
        keep &= kpos <= qpos
    if window:
        keep &= kpos > qpos - window
    return keep


@pytest.mark.parametrize("s", [1, 127, 128, 129, 193, 257, 400])
@pytest.mark.parametrize("causal,window", [
    (True, 0), (False, 0), (True, 1), (True, 17), (True, 100), (True, 128),
    (True, 129), (True, 1000), (False, 70), (False, 200)])
def test_key_tiles_skip_only_fully_masked(s, causal, window):
    keep = _mask(s, causal, window)
    for plan in _plans(s, causal, window):
        for q0 in plan.tiles():
            rows = keep[max(q0, 0): q0 + plan.bq]
            walked = set(plan.key_tiles(q0))
            for kt in range(-(-s // plan.bk)):
                seen = rows[:, kt * plan.bk: (kt + 1) * plan.bk].any()
                assert seen <= (kt in walked), (q0, kt)
            # every row has a key in the walked tiles (its own position)
            lo, hi = min(walked) * plan.bk, (max(walked) + 1) * plan.bk
            assert rows[:, lo:hi].any(axis=1).all()


def _np_qkv(rng, b, s, h, kv, d):
    return [rng.normal(size=(b, s, n, d)).astype(np.float32)
            for n in (h, kv, kv)]


@pytest.mark.parametrize("s,d,window", [
    (128, 64, 0), (128, 128, 100), (256, 64, 129), (256, 128, 128)])
def test_ref_matches_pallas_kernel_on_128_blocks(rng, s, d, window):
    """S a multiple of the Pallas kernel's 128-row blocks (the Hopper
    design's tile), windows ending inside and on a 128-key edge."""
    q, k, v = _np_qkv(rng, 1, s, 2, 2, d)
    got = ref.flash_attention_ref(_t(q), _t(k), _t(v), window=window)
    exp = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                 causal=True, window=window, bq=128, bk=128, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=ATOL)


@pytest.mark.parametrize("s,d,window,causal", [
    (127, 64, 0, True), (129, 128, 0, True), (257, 64, 100, True),
    (257, 128, 129, True), (129, 64, 0, False), (257, 64, 70, False)])
def test_ref_matches_jax_reference_at_ragged_s(rng, s, d, window, causal):
    """S off the 128 tile, where the Pallas grid does not divide: the JAX
    package's plain reference."""
    q, k, v = _np_qkv(rng, 1, s, 2, 2, d)
    got = ref.flash_attention_ref(_t(q), _t(k), _t(v), causal=causal,
                                  window=window)
    exp = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal,
                                   window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=ATOL)


@pytest.mark.parametrize("s,h,kv,d,window", [
    (129, 8, 2, 64, 0), (257, 4, 1, 64, 100), (128, 4, 4, 128, 0),
    (127, 6, 3, 128, 129)])
def test_ref_matches_jax_gqa_attention(rng, s, h, kv, d, window):
    """Grouped KV heads at the tile edges: the JAX transformer's own
    causal attention lowering."""
    q, k, v = _np_qkv(rng, 2, s, h, kv, d)
    got = ref.flash_attention_ref(_t(q), _t(k), _t(v), window=window)
    exp = jtf.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              0, jnp.asarray(window or 2 ** 30),
                              1.0 / d ** 0.5, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=ATOL)
