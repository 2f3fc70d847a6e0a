"""B9 and 9b at MLA's widths (Q/K 192, V 128) on the CPU.

DeepSeek-V3's latent attention attends Q and K of width D = 192 over V
of width Dv = 128, scale 1/√D (``repro/models/transformer.py``'s
``flash_attention``, which MLA calls, takes V of its own width).  The
Hopper designs of B9 and 9b (``tma_wgmma``) take that pair with V in
tiles of its own; the CUDA-core designs take V as wide as Q only, so
``models.transformer.attend_padded_v`` pads V for them and for nothing
else.  Here: the plans' routing and shared bytes against the C entries'
conditions and layouts, the plain versions with a narrower V against the
JAX model-level attention and its ``jax.vjp`` (the JAX package's own
route; it has no Pallas kernel at Dv != D), and, with the launches
replaced by recorders, which V the prefill and the training step hand
the kernel route.  The kernels themselves run only on the card
(``chip_smoke.py`` holds them against the plain versions there).

Tolerances, the existing files': outputs ``atol=1e-4`` in f32
(``test_torch_flash_plan.py``), the log-sum-exp and f32 gradients
``atol=1e-5`` (``test_torch_flash_bwd_lse.py``; the same math, sums in
another order), bf16 gradients two bf16 steps of the largest gradient.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as jtf
from repro_torch.kernels import flash_attention, ops, ref
from repro_torch.models import transformer as tf

SMEM_MAX = 232448            # shared memory one block may use on an H100
BF, F32 = torch.bfloat16, torch.float32
OUT_ATOL, GRAD_ATOL = 1e-4, 1e-5
WGMMA_SRC = (flash_attention.build.CSRC
             / "flash_attention_wgmma.cu").read_text()
WGMMA_BWD_SRC = (flash_attention.build.CSRC
                 / "flash_attention_bwd_wgmma.cu").read_text()
CORES_SRCS = [(flash_attention.build.CSRC / n).read_text()
              for n in ("flash_attention.cu", "flash_attention_bwd.cu")]


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _qkv(b, s, h, kv, d, dv, dtype=BF):
    return (torch.zeros((b, s, h, d), dtype=dtype),
            torch.zeros((b, s, kv, d), dtype=dtype),
            torch.zeros((b, s, kv, dv), dtype=dtype))


def _lse(q):
    b, s, h, _ = q.shape
    pitch = flash_attention.lse_pitch(s)
    return torch.zeros((b * h, pitch))[:, :s]


def _case(name):
    """(q, k, v) of each MLA routing case."""
    if name == "bf16 192/128":
        return _qkv(1, 130, 4, 4, 192, 128)
    if name == "bf16 192/128 GQA":
        return _qkv(2, 70, 8, 2, 192, 128)
    if name == "f32 192/128":
        return _qkv(1, 130, 4, 4, 192, 128, F32)
    if name == "bf16 192/192":
        return _qkv(1, 130, 4, 4, 192, 192)
    if name == "bf16 192/64":
        return _qkv(1, 130, 4, 4, 192, 64)
    if name == "bf16 128/64":
        return _qkv(1, 130, 4, 4, 128, 64)
    if name == "unaligned v":
        q, k, _ = _qkv(1, 130, 4, 4, 192, 128)
        return q, k, torch.zeros((1, 130, 4, 129), dtype=BF)[..., 1:]
    if name == "unaligned q":
        _, k, v = _qkv(1, 130, 4, 4, 192, 128)
        return torch.zeros((1, 130, 4, 193), dtype=BF)[..., 1:], k, v
    raise KeyError(name)


ROUTES = [("bf16 192/128", "tma_wgmma"), ("bf16 192/128 GQA", "tma_wgmma"),
          ("f32 192/128", "cuda_cores"), ("bf16 192/192", "cuda_cores"),
          ("bf16 192/64", "cuda_cores"), ("bf16 128/64", "cuda_cores"),
          ("unaligned v", "cuda_cores"), ("unaligned q", "cuda_cores")]


@pytest.mark.parametrize("name,design", ROUTES)
def test_plans_route_mla_as_the_c_entries(name, design):
    """bf16 (192, 128) with aligned rows (and, for 9b, the saved lse)
    takes the Hopper designs, 128-query items and 64-row streamed tiles;
    f32, unaligned rows and every other (D, Dv) the CUDA cores, which take
    only V as wide as Q -- as the C entries' conditions read."""
    for src in (WGMMA_SRC, WGMMA_BWD_SRC):
        assert "((D == 64 || D == 128) && Dv == D) ||" in src
        assert "(D == 192 && Dv == 128)" in src
    assert all("Dv != D" in src for src in CORES_SRCS)
    q, k, v = _case(name)
    d, dv = q.shape[3], v.shape[3]
    plan = flash_attention.plan_flash(q, k, v)
    assert plan.design == design
    do = torch.zeros(q.shape[:3] + (dv,), dtype=q.dtype)
    bwd = flash_attention.plan_flash_bwd(q, k, v, do, 0, True, _lse(q))
    assert bwd.design == design
    assert flash_attention.takes_v_width(design, d, dv) == (
        design == "tma_wgmma" or dv == d)
    if design == "tma_wgmma":
        assert (plan.bq, plan.bk, plan.stages) == (128, 128, 2)
        assert (bwd.item, bwd.step) == (128, 64)
        assert plan.smem_bytes == flash_attention.wgmma_smem_bytes(
            192, 2, 128)
        assert bwd.smem_bytes == flash_attention.wgmma_bwd_smem_bytes(
            192, 128)
    # without the saved lse 9b takes the CUDA cores
    assert flash_attention.plan_flash_bwd(q, k, v, do).design == \
        "cuda_cores"


def test_v_wider_than_q_raises():
    q, k, v = _qkv(1, 16, 2, 2, 64, 128)
    for call in (lambda: flash_attention.plan_flash(q, k, v),
                 lambda: flash_attention.plan_flash_bwd(q, k, v, v),
                 lambda: ops.flash_attention(q, k, v),
                 lambda: tf.attend_padded_v(q, k, v)):
        with pytest.raises(ValueError, match="exceeds"):
            call()


def test_wgmma_shared_memory_at_192_128_is_the_one_q_layout():
    """B9 at (192, 128): one 128 x 192 Q buffer, a 2-stage ring of K 192
    and V 128 tiles of 128 rows, 2 + 4·2 mbarriers, the 1024-byte slack;
    a second Q buffer would pass one block's shared memory.  9b's query
    passes: one Q and one dO buffer of 128 rows, 2 stages of 64-row K and
    V, 2 + 4·2 mbarriers; dK/dV: the item's K and V, 2 stages of Q, dO
    and 64 lse/Δ pairs, 2 + 2·2 mbarriers.  Both fit, and two Q/dO
    buffers would not."""
    assert "NQ_OF = D == 192 ? 1 : 2" in WGMMA_SRC
    assert "NQ_OF = DQK == 192 ? 1 : 2" in WGMMA_BWD_SRC
    assert flash_attention.WGMMA_DV == {64: 64, 128: 128, 192: 128}
    assert flash_attention.WGMMA_Q_BUFS == {64: 2, 128: 2, 192: 1}
    fwd = flash_attention.wgmma_smem_bytes(192, 2, 128)
    assert fwd == 1024 + 49152 + 2 * (49152 + 32768) + 80 == 214096
    assert fwd <= SMEM_MAX < fwd + 128 * 192 * 2 + 16
    dq, dkdv, dq2 = flash_attention.wgmma_bwd_smem_bytes(192, 128)
    assert dq == dq2 == 1024 + (49152 + 32768) + 2 * (24576 + 16384) \
        + 8 * (2 + 4 * 2) == 164944
    assert dkdv == 1024 + (49152 + 32768) + 2 * (24576 + 16384 + 512) \
        + 8 * (2 + 2 * 2) == 165936
    assert max(dq, dkdv) <= SMEM_MAX < dq + 49152 + 32768 + 16


def _inputs(rng, b, s, h, kv, d, dv):
    q, k = (rng.normal(size=(b, s, n, d)).astype(np.float32)
            for n in (h, kv))
    v = rng.normal(size=(b, s, kv, dv)).astype(np.float32)
    do = rng.normal(size=(b, s, h, dv)).astype(np.float32)
    return q, k, v, do


MLA_SHAPES = [(24, 16, 4, 4), (24, 16, 4, 2), (192, 128, 2, 2),
              (192, 128, 4, 1)]


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("d,dv,h,kv", MLA_SHAPES)
def test_plain_forward_with_a_narrower_v_is_jax_attention(rng, d, dv, h,
                                                          kv, window):
    """``ref.flash_attention_ref`` over a V narrower than Q (grouped KV
    heads, windows) against the JAX model-level attention MLA calls."""
    q, k, v, _ = _inputs(rng, 2, 21, h, kv, d, dv)
    want = jtf.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), 0,
                               jnp.asarray(window or tf.FULL),
                               1.0 / d ** 0.5, 8)
    got = ref.flash_attention_ref(_t(q), _t(k), _t(v), window=window)
    assert got.shape == (2, 21, h, dv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=OUT_ATOL, rtol=0)


def _bf16_atol(want) -> float:
    """Two bf16 steps of the largest value."""
    top = float(np.abs(want).max())
    return 2 * 2.0 ** (np.floor(np.log2(top)) - 7)


@pytest.mark.parametrize("dtype", [F32, BF])
@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("d,dv,h,kv", MLA_SHAPES)
def test_plain_gradient_from_the_lse_with_a_narrower_v_is_jax_vjp(
        rng, d, dv, h, kv, window, dtype):
    """9b's plain counterpart (the gradient from the saved log-sum-exp,
    Δ = Σ P·dP) over a narrower V against ``jax.vjp`` of the JAX
    model-level attention: dq and dk at Q's width, dv at V's; f32, and
    bf16 through the values a bf16 cast leaves."""
    s = 21
    q, k, v, do = _inputs(rng, 2, s, h, kv, d, dv)
    jdt = jnp.float32 if dtype == F32 else jnp.bfloat16
    _, vjp = jax.vjp(lambda a, b, c: jtf.flash_attention(
        a, b, c, 0, jnp.asarray(window or tf.FULL), 1.0 / d ** 0.5, 8),
        *(jnp.asarray(x, jdt) for x in (q, k, v)))
    want = [_np(g) for g in vjp(jnp.asarray(do, jdt))]
    if dtype == BF:
        q, k, v, do = (_np(jnp.asarray(x, jnp.bfloat16))
                       for x in (q, k, v, do))
    tq, tk, tv, tdo = (_t(x).to(dtype) for x in (q, k, v, do))
    lse = ref.flash_attention_lse_ref(tq, tk, window=window)
    got = ref.flash_attention_bwd_lse_ref(tq, tk, tv, lse, tdo,
                                          window=window)
    assert [tuple(g.shape) for g in got] == [
        (2, s, h, d), (2, s, kv, d), (2, s, kv, dv)]
    for g, w, n in zip(got, want, ("dq", "dk", "dv")):
        atol = GRAD_ATOL if dtype == F32 else _bf16_atol(w)
        np.testing.assert_allclose(g.float().numpy(), w, atol=atol,
                                   err_msg=f"{n} {(d, dv, h, kv, window)}")


def _recorders(monkeypatch, seen):
    """The kernel route's launches replaced by recorders of the V width
    (and dO's, dv's) each is handed; each returns its plain version."""
    def fwd(q, k, v, causal=True, window=0):
        seen.setdefault("launch", []).append(v.shape[-1])
        return ref.flash_attention_ref(q, k, v, causal, window)

    def fwd_lse(q, k, v, causal=True, window=0):
        # the lse only where B9 would write it: its tma_wgmma design
        seen.setdefault("launch_with_lse", []).append(v.shape[-1])
        lse = None
        if flash_attention.plan_flash(q, k, v, window, causal).design == \
                "tma_wgmma":
            lse = ref.flash_attention_lse_ref(q, k, causal, window)
        return ref.flash_attention_ref(q, k, v, causal, window), lse

    def bwd(q, k, v, dout, causal=True, window=0, lse=None):
        seen.setdefault("launch_bwd", []).append(
            (v.shape[-1], dout.shape[-1], lse is not None))
        if lse is None:
            return ref.flash_attention_bwd_ref(q, k, v, dout, causal, window)
        return ref.flash_attention_bwd_lse_ref(q, k, v, lse, dout, causal,
                                               window)

    monkeypatch.setattr(flash_attention, "launch", fwd)
    monkeypatch.setattr(flash_attention, "launch_with_lse", fwd_lse)
    monkeypatch.setattr(flash_attention, "launch_bwd", bwd)


@pytest.mark.parametrize("name,design", ROUTES[:3] + ROUTES[6:7])
def test_attend_padded_v_hands_the_kernel_v_as_its_plan_takes_it(
        monkeypatch, name, design):
    """On the kernel route (``impl="cuda"``, the launches recorded): V
    reaches the launch unpadded where the plan is ``tma_wgmma`` and
    zero-padded to Q's width where it is ``cuda_cores``; the output has
    V's width either way and equals the plain attention over the unpadded
    V."""
    q, k, v = _case(name)
    gen = torch.Generator().manual_seed(1)
    q, k = (torch.randn(t.shape, generator=gen).to(t.dtype) for t in (q, k))
    v = v.copy_(torch.randn(v.shape, generator=gen))
    seen = {}
    _recorders(monkeypatch, seen)
    with ops.default_impl("cuda"):
        got = tf.attend_padded_v(q, k, v, window=5)
    d, dv = q.shape[3], v.shape[3]
    assert seen == {"launch": [dv if design == "tma_wgmma" else d]}
    want = ref.flash_attention_ref(q, k, v, window=5)
    assert got.shape == want.shape == q.shape[:3] + (dv,)
    assert torch.equal(got, want) or design == "cuda_cores"
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               atol=OUT_ATOL if q.dtype == F32 else 2e-2)


def _mla_config(dtype):
    """One dense MLA layer at DeepSeek-V3's attention widths (Q/K 128
    nope + 64 rope, V 128), narrow elsewhere."""
    return tf.TransformerConfig(
        name="mla-192-128", n_layers=1, d_model=64, n_heads=2,
        n_kv_heads=2, d_head=128, d_ff=64, vocab_size=64, mla=True,
        q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=128, qk_rope_dim=64,
        v_head_dim=128, dtype=dtype)


@pytest.mark.parametrize("dtype,design", [(BF, "tma_wgmma"),
                                          (F32, "cuda_cores")])
def test_mla_prefill_and_training_step_reach_the_kernel_at_v_128(
        monkeypatch, dtype, design):
    """An MLA layer at DeepSeek's attention widths through the kernel
    route, launches recorded: the bf16 prefill's B9 and the training
    step's B9 (with the lse saved) and 9b get V at 128, dO at 128 and the
    saved lse; in f32 (the CUDA cores) V is padded to 192.  Outputs and
    gradients equal the plain route's."""
    c = _mla_config(dtype)
    model = tf.init_params(c, torch.Generator().manual_seed(2), "cpu")
    layer = model.layers[0]
    x = torch.randn((1, 20, 64), generator=torch.Generator().manual_seed(3)
                    ).to(dtype)
    pos = torch.arange(20).expand(1, 20)
    q, _, v = tf.mla_qkv(x, layer, c, pos)
    assert q.shape[-1] == 192 and v.shape[-1] == 128
    assert flash_attention.aligned_rows(v)
    seen = {}
    _recorders(monkeypatch, seen)
    width = 128 if design == "tma_wgmma" else 192
    with torch.no_grad(), ops.default_impl("cuda"):
        got, _ = tf.attention_mla(x, layer, c, pos, tf.FULL)
    assert seen == {"launch": [width]}
    with torch.no_grad(), ops.default_impl("ref"):
        want, _ = tf.attention_mla(x, layer, c, pos, tf.FULL)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               atol=OUT_ATOL if dtype == F32 else 2e-2)
    # the training step: B9 through ops.FlashAttention, then 9b
    seen.clear()
    with ops.default_impl("cuda"):
        out, _ = tf.attention_mla(x, layer, c, pos, tf.FULL)
        out.float().square().sum().backward()
    assert seen == {"launch_with_lse": [width],
                    "launch_bwd": [(width, width, design == "tma_wgmma")]}
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in (layer.wq_b, layer.wkv_b))
