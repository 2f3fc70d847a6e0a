"""Blocked online-softmax attention (CUDA kernel + wrapper).

    out = softmax(mask(q·kᵀ/√D)) · v          [B, S, H, D], causal (+ window)

Replaces ``repro/kernels/flash_attention.py::flash_attention``, the
prefill attention of the dense LM stack.  The kernel
(``csrc/flash_attention.cu``) keeps one 64-query tile per block, walks
64-key tiles with f32 running max, denominator and accumulator (the
[S, S] scores are never written), rounds ``p`` to the V dtype before
P·V as the TPU kernel does, and skips the key tiles that the causal mask
or the window hide from the whole query tile; bf16 products run on the
tensor cores (``mma.sync``) for D in {32, 64, 128}.  K/V may carry fewer heads
than Q (H % KV == 0), so grouped-query attention reads each KV head in
place.  Its plain version is ``ref.flash_attention_ref``;
``ops.flash_attention`` picks between the two.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

DTYPES = (torch.float32, torch.bfloat16)
MAX_D = 256


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int):
    """Raise on what the kernel does not take; returns (B, S, H, KV, D)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in DTYPES:
            raise TypeError(f"{name}: dtype {t.dtype} not in {list(DTYPES)}")
        if t.dim() != 4:
            raise ValueError(f"{name}: expected [B, S, heads, D], got "
                             f"{tuple(t.shape)}")
        if t.shape[3] > 1 and t.stride(3) != 1:
            raise ValueError(f"{name}: the head dim must be contiguous")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    b, s, h, d = q.shape
    kv = k.shape[2]
    if k.shape != v.shape or k.shape[0] != b or k.shape[1] != s or \
            k.shape[3] != d:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: K/V must be [B, S, KV, D]")
    if kv < 1 or h % kv != 0:
        raise ValueError(f"H={h} is not a multiple of KV={kv}")
    if not 1 <= d <= MAX_D:
        raise ValueError(f"head dim D={d} outside [1, {MAX_D}]")
    if window < 0:
        raise ValueError(f"window={window} < 0")
    if b * h >= 2 ** 31 or (s + 63) // 64 > 65535:
        raise ValueError(f"grid too large for B*H={b * h}, S={s}")
    return b, s, h, kv, d


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool = True, window: int = 0) -> torch.Tensor:
    """Attention of ``q`` [B, S, H, D] over ``k``/``v`` [B, S, KV, D].

    f32 or bf16 (all three alike), 1 <= D <= 256, H % KV == 0, any S,
    any strides with a contiguous last dim; ``window`` 0 means none.
    Returns a contiguous [B, S, H, D] in q's dtype.  bf16 with D in
    {32, 64, 128}, 16-byte aligned bases and strides that are multiples
    of 8 runs on the tensor cores; every other input on the CUDA cores.
    Launches the CUDA kernel; raises on tensors it does not take (CPU
    tensors among them).
    """
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or not t.is_cuda:
            raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors, "
                             f"got {getattr(t, 'device', type(t))}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    b, s, h, kv, d = _check(q, k, v, window)
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    strides = [x for t in (q, k, v) for x in t.stride()[:3]]
    build.check(build.library().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h,
        kv, d, *strides, 1.0 / d ** 0.5, int(bool(causal)), int(window),
        int(q.dtype == torch.bfloat16), build.stream_of(out)),
        "flash_attention")
    build.count_launch("flash_attention")
    return out
