"""9b's ``tma_wgmma`` design on the CPU: its plain counterparts against
the JAX package, and the training route that feeds it.

The design reads what B9's forward saves: each query row's log-sum-exp
(``flash_attention.launch_with_lse``).  Its plain counterparts are
``ref.flash_attention_lse_ref`` (held here against JAX's ``logsumexp`` of
the masked scores as ``repro/models/transformer.py::_attend_block`` and
the JAX oracle ``repro.kernels.ref.flash_attention_ref`` build them) and
``ref.flash_attention_bwd_lse_ref`` (the gradient from q, k, v, the
plain log-sum-exp and dO, with Δ = Σ P·dP, held against ``jax.vjp``
of the oracle and of the model-level blocked attention: f32 and bf16,
grouped KV heads, windows, no causal mask, S off every block, one
token).  The kernels run only on the card (``chip_smoke.py`` phase 16
holds them against the plain versions there); here ``ops.FlashAttention``
on the kernel route is run with the two launches stubbed, to show what
it saves and hands to the backward.

Tolerances (``tests/test_torch_lm_train.py``'s): the log-sum-exp and the
f32 gradients ``atol=1e-5`` (the same math, sums in another order); bf16
gradients two bf16 steps of the largest gradient (the JAX vjp rounds dP
and dS to bf16).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.special import logsumexp

from repro.kernels import ref as jref
from repro.models import transformer as jtf
from repro_torch.kernels import flash_attention, ops, ref

ATOL = 1e-5
BF, F32 = torch.bfloat16, torch.float32


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _bf16_atol(want) -> float:
    """Two bf16 steps of the largest value."""
    top = float(np.abs(want).max())
    return 2 * 2.0 ** (np.floor(np.log2(top)) - 7)


def _inputs(rng, b, s, h, kv, d):
    return [rng.normal(size=(b, s, n, d)).astype(np.float32)
            for n in (h, kv, kv, h)]


def _as_bf16(*xs):
    """The values a bf16 cast leaves, as f32 numpy arrays."""
    return [_np(jnp.asarray(x, jnp.bfloat16)) for x in xs]


def _jax_lse(q, k, causal, window):
    """JAX's log-sum-exp of the masked scaled scores, [B, H, S], built as
    ``_attend_block`` builds them (grouped KV heads, the mask kpos <=
    qpos and kpos > qpos - window, -1e30 where masked); without the
    causal mask as the JAX oracle's optional mask."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    qg = jnp.asarray(q).reshape(b, s, kv, h // kv, d)
    scores = jnp.einsum("bqkgd,bskd->bkgqs", qg, jnp.asarray(k)).astype(
        jnp.float32) * (1.0 / d ** 0.5)
    qpos, kpos = jnp.arange(s), jnp.arange(s)
    mask = jnp.ones((s, s), bool)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window:
        mask &= kpos[None, :] > qpos[:, None] - window
    scores = jnp.where(mask[None, None, None], scores, -1e30)
    return np.asarray(logsumexp(scores, axis=-1)).reshape(b, h, s)


@pytest.mark.parametrize("dtype", [F32, BF])
@pytest.mark.parametrize("s,h,kv,d,window,causal", [
    (16, 2, 2, 8, 0, True), (37, 4, 2, 16, 0, True), (64, 6, 3, 32, 9, True),
    (33, 4, 1, 16, 0, False), (50, 2, 2, 16, 7, False),
    (1, 2, 1, 8, 0, True)])
def test_lse_ref_matches_jax_logsumexp(rng, dtype, s, h, kv, d, window,
                                       causal):
    """[B·H, S], row b·H + h, as the kernel saves it; bf16 inputs are
    compared through their values (both sides take the scores in
    f32)."""
    q, k, _, _ = _inputs(rng, 2, s, h, kv, d)
    if dtype == BF:
        q, k = _as_bf16(q, k)
    got = ref.flash_attention_lse_ref(_t(q).to(dtype), _t(k).to(dtype),
                                      causal=causal, window=window)
    assert got.dtype == F32 and got.shape == (2 * h, s)
    want = _jax_lse(q, k, causal, window)
    np.testing.assert_allclose(got.reshape(2, h, s).numpy(), want,
                               atol=ATOL, rtol=0)


def _lse_grads(q, k, v, do, dtype, causal, window):
    """The counterpart's gradient from the plain log-sum-exp, in
    ``dtype``."""
    q, k, v, do = (_t(x).to(dtype) for x in (q, k, v, do))
    lse = ref.flash_attention_lse_ref(q, k, causal=causal, window=window)
    got = ref.flash_attention_bwd_lse_ref(q, k, v, lse, do, causal=causal,
                                          window=window)
    assert all(g.dtype == dtype for g in got)
    return [g.float().numpy() for g in got]


def _close(got, want, dtype, what):
    for g, w, n in zip(got, want, ("dq", "dk", "dv")):
        w = np.asarray(w, np.float32)
        atol = ATOL if dtype == F32 else _bf16_atol(w)
        np.testing.assert_allclose(g, w, atol=atol, err_msg=f"{what} {n}")


@pytest.mark.parametrize("dtype", [F32, BF])
@pytest.mark.parametrize("s,d,window,causal", [
    (16, 8, 0, True), (37, 16, 0, True), (64, 32, 9, True),
    (33, 16, 0, False), (50, 16, 7, False), (1, 8, 0, True)])
def test_bwd_lse_ref_matches_jax_vjp_of_the_oracle(rng, dtype, s, d, window,
                                                   causal):
    q, k, v, do = _inputs(rng, 2, s, 3, 3, d)
    jdt = jnp.float32 if dtype == F32 else jnp.bfloat16
    _, vjp = jax.vjp(lambda a, b, c: jref.flash_attention_ref(
        a, b, c, causal=causal, window=window),
        *(jnp.asarray(x, jdt) for x in (q, k, v)))
    want = [_np(g) for g in vjp(jnp.asarray(do, jdt))]
    if dtype == BF:
        q, k, v, do = _as_bf16(q, k, v, do)
    _close(_lse_grads(q, k, v, do, dtype, causal, window), want, dtype,
           (s, d, window, causal))


@pytest.mark.parametrize("dtype", [F32, BF])
@pytest.mark.parametrize("s,h,kv,d,window,q_block", [
    (24, 4, 2, 16, 0, 8), (37, 6, 3, 8, 0, 512), (40, 4, 1, 16, 5, 8),
    (64, 8, 2, 32, 17, 16)])
def test_bwd_lse_ref_matches_jax_vjp_of_gqa_attention(rng, dtype, s, h, kv,
                                                      d, window, q_block):
    """Grouped KV heads, windows and S off the query block: the JAX
    transformer's blocked attention (each block under
    ``jax.checkpoint``), differentiated by ``jax.vjp``."""
    q, k, v, do = _inputs(rng, 2, s, h, kv, d)
    jdt = jnp.float32 if dtype == F32 else jnp.bfloat16
    _, vjp = jax.vjp(lambda a, b, c: jtf.flash_attention(
        a, b, c, 0, jnp.asarray(window or 2 ** 30), 1.0 / d ** 0.5,
        q_block), *(jnp.asarray(x, jdt) for x in (q, k, v)))
    want = [_np(g) for g in vjp(jnp.asarray(do, jdt))]
    if dtype == BF:
        q, k, v, do = _as_bf16(q, k, v, do)
    _close(_lse_grads(q, k, v, do, dtype, True, window), want, dtype,
           (s, h, kv, d, window))


def test_flash_function_hands_the_saved_lse_to_9b(monkeypatch):
    """``impl="cuda"`` on CPU tensors with both launches stubbed: the
    Function's forward calls ``launch_with_lse``; where that gives a
    log-sum-exp (B9's ``tma_wgmma`` design) the backward hands
    ``launch_bwd`` that very tensor; the plain versions are never
    called."""
    calls = {}

    def fwd(q, k, v, causal, window):
        calls["fwd"] = (causal, window)
        calls["lse"] = ref.flash_attention_lse_ref(q, k, causal=causal,
                                                   window=window)
        return ref.flash_attention_ref(q, k, v, causal, window), calls["lse"]

    def bwd(q, k, v, dout, causal, window, lse=None):
        calls["bwd"] = (lse, causal, window)
        return ref.flash_attention_bwd_lse_ref(q, k, v, lse, dout, causal,
                                               window)

    def plain(*args, **kwargs):
        raise AssertionError("the kernel route took a plain version")

    monkeypatch.setattr(flash_attention, "launch_with_lse", fwd)
    monkeypatch.setattr(flash_attention, "launch_bwd", bwd)
    monkeypatch.setattr(flash_attention, "launch", plain)
    gen = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn((2, 21, n, 16), generator=gen)
                   for n in (4, 2, 2, 4))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = ops.flash_attention(*leaves, causal=True, window=5, impl="cuda")
    assert calls["fwd"] == (True, 5)
    monkeypatch.setattr(ref, "flash_attention_ref", plain)
    monkeypatch.setattr(ref, "flash_attention_bwd_ref", plain)
    got = torch.autograd.grad(out, leaves, do)
    lse, causal, window = calls["bwd"]
    assert lse is calls["lse"] and (causal, window) == (True, 5)
    want = ref.flash_attention_bwd_lse_ref(q, k, v, calls["lse"], do, True,
                                           5)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_flash_function_without_a_saved_lse_passes_none(monkeypatch):
    """B9's other designs give no log-sum-exp: the backward then hands
    ``launch_bwd`` none (its ``cuda_cores`` design recomputes it)."""
    seen = {}

    def fwd(q, k, v, causal, window):
        return ref.flash_attention_ref(q, k, v, causal, window), None

    def bwd(q, k, v, dout, causal, window, lse=None):
        seen["lse"] = lse
        return ref.flash_attention_bwd_ref(q, k, v, dout, causal, window)

    monkeypatch.setattr(flash_attention, "launch_with_lse", fwd)
    monkeypatch.setattr(flash_attention, "launch_bwd", bwd)
    q = torch.rand((1, 9, 2, 8), requires_grad=True)
    k, v = torch.rand((1, 9, 1, 8)), torch.rand((1, 9, 1, 8))
    ops.flash_attention(q, k, v, impl="cuda").sum().backward()
    assert "lse" in seen and seen["lse"] is None
    assert q.grad is not None and bool(torch.isfinite(q.grad).all())


def test_saved_lse_must_be_launch_with_lses():
    """``launch_bwd`` takes the lse as ``launch_with_lse`` lays it out
    (f32 [B·H, S] at a pitch of S rounded up to 64) and raises otherwise,
    before any launch."""
    q = torch.zeros((1, 70, 2, 64), dtype=BF)
    pitch = flash_attention.lse_pitch(70)
    assert pitch == 128 and flash_attention.lse_pitch(128) == 128
    good = torch.zeros((2, pitch))[:, :70]
    flash_attention._check_saved(q, None)
    for bad in (torch.zeros((2, 70)), torch.zeros((2, pitch))[:1, :70],
                torch.zeros((2, pitch), dtype=BF)[:, :70]):
        with pytest.raises(ValueError, match="lse"):
            flash_attention._check_saved(q, bad)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention._check_saved(q, good)


@pytest.mark.parametrize("dtype", [F32, BF])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 1), (True, 3)])
def test_bwd_lse_ref_rows_that_see_one_key_have_zero_dq(rng, dtype, causal,
                                                        window):
    """A query row that sees one key (row 0 under the causal mask, every
    row at window 1) has softmax 1 there and dS = 0: the counterpart's dq
    row is exactly 0, as the plain version's and JAX's are, though its P
    comes from a log-sum-exp (1 only up to rounding)."""
    q, k, v, do = (_t(x).to(dtype) for x in _inputs(rng, 2, 19, 4, 2, 16))
    lse = ref.flash_attention_lse_ref(q, k, causal=causal, window=window)
    dq, dk, dv = ref.flash_attention_bwd_lse_ref(q, k, v, lse, do,
                                                 causal=causal,
                                                 window=window)
    plain = ref.flash_attention_bwd_ref(q, k, v, do, causal=causal,
                                        window=window)
    one = slice(None) if window == 1 else slice(0, 1)
    assert not dq[:, one].any() and not plain[0][:, one].any()
    if window != 1:
        assert dq[:, 1:].abs().amax(-1).min() > 0
