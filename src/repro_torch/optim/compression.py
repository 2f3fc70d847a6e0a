"""Per-row symmetric int8 quantization of the serving corpus.

The int8 serving path (``kernels.ops.fused_recommend_quant``) reads the
corpus as ``(q int8[M, I], scale f32[M])``.  Scales are POWERS OF TWO,
so every scale product the serving kernels apply (``s_q·s_c``,
``s_c²``, ``× acc``) is an exact f32 exponent shift and each int8 score
is rounded exactly once: the D-tiled int8 stage A then agrees with its
plain version bit for bit, whatever the summation order of the exact
integer partials.  The cost is at most one bit of the eight:
per-element round-trip error ≤ ``scale/2`` ≤ ``max|row|/127``.

Per-row scales also make the representation partition invariant: a
row quantizes to the same ``(q, scale)`` on any shard, so sharded int8
scores equal the single-corpus ones and a row refresh re-quantizes
only the touched rows (``StateStore.quantized_corpus``).
"""
from __future__ import annotations

from typing import Tuple

import torch


def quantize_int8_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8: f32[M, I] → (int8[M, I], f32[M]).

    ``scale[r]`` is the power of two ≥ ``max(|x[r]|, 1e-30)/127`` (the
    next one above, or equal when that is already a power of two) and
    ``q[r] = round(x[r]/scale[r])`` (half to even) clipped to ±127.
    O(M·I) elementwise work on ``x``'s device.
    """
    xf = x.to(torch.float32)
    raw = torch.clamp(xf.abs().amax(dim=-1), min=1e-30) / 127.0
    # next power of two >= raw: frexp gives raw = m·2^e with m in
    # [0.5, 1); m == 0.5 means raw IS 2^(e-1), else round up to 2^e.
    # The power of two is assembled from its IEEE-754 exponent bits:
    # an exp2() may be approximate and would void the exactness above.
    mant, exp = torch.frexp(raw)
    e = torch.where(mant == 0.5, exp - 1, exp).to(torch.int32)
    scale = ((e + 127) << 23).view(torch.float32)
    q = torch.clamp(torch.round(xf / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale


def quantize_int8_rows_pitched(x: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`quantize_int8_rows` with the int8 rows at a 16-byte pitch:
    ``(buf[:, :I], scale)`` for a zeroed int8 ``buf[M, ⌈I/16⌉·16]``.
    The D-tiled int8 kernel reads such rows as 16-byte vectors without
    copying them.
    """
    q, scale = quantize_int8_rows(x)
    m, n = q.shape
    buf = torch.zeros((m, n + (-n % 16)), dtype=torch.int8,
                      device=q.device)
    buf[:, :n] = q
    return buf[:, :n], scale


def dequantize_int8_rows(q: torch.Tensor, scale: torch.Tensor,
                         dtype: torch.dtype = torch.float32
                         ) -> torch.Tensor:
    """Inverse of :func:`quantize_int8_rows`: ``q · scale[..., None]``.

    An exact elementwise f32 multiply (the scales are powers of two),
    the same product the serving kernels apply on chip.
    """
    return (q.to(torch.float32) * scale[..., None]).to(dtype)
