"""Int8 quantization: gradient compression for the inter-pod axis, and
the serving corpus's per-row int8.

**Gradient compression** (the port of the JAX package's
``optim/compression.py``).  Per-tensor symmetric int8 with error
feedback (1-bit-Adam-style memory, Seide et al. 2014 / Tang et al.
2021): the rounding error of one step is added to the next step's
gradient, so the transmitted sum stays exact over steps.  Bit for bit
the reference: the scale is ``max(|x|, 1e-30) / 127`` in f32,
``torch.round`` rounds half to even as ``jnp.round`` does, and the clip
is ±127.  :func:`hierarchical_psum_mean` is the hierarchical gradient
mean over a ``torch.distributed`` ``DeviceMesh``: reduce-scatter inside
the pod, all-reduce across pods (bf16, or int32 sums of the int8 values
with error feedback), all-gather inside the pod.

**The serving corpus.**  The int8 serving path
(``kernels.ops.fused_recommend_quant``) reads the
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

from typing import Any, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.parallel.sharding import tree_map


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


# ---------------------------------------------------------------------------
# Gradient compression
# ---------------------------------------------------------------------------

def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8: ``x`` → (int8 ``q``, f32 scalar scale).

    ``scale = max(max|x|, 1e-30) / 127`` and ``q = round(x / scale)``
    (half to even) clipped to ±127, all in f32: the reference's bits.
    O(numel) elementwise work on ``x``'s device.
    """
    xf = x.to(torch.float32)
    # 127 as a tensor on x's device: CUDA divides by a host scalar as a
    # product with its reciprocal, a last bit off the CPU's and JAX's
    # division
    scale = torch.clamp(xf.abs().amax(), min=1e-30) / torch.full(
        (), 127.0, dtype=torch.float32, device=xf.device)
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Invert :func:`quantize_int8`: ``q · scale`` in f32, cast to ``dtype``.

    The round-trip error is at most ``scale / 2`` an element.
    """
    return (q.to(torch.float32) * scale).to(dtype)


Tree = Any


def init_error_feedback(grads: Tree) -> Tree:
    """Zero f32 residuals shaped as ``grads`` (a tensor or a tree).

    Each residual lies on its gradient's device.
    """
    return tree_map(lambda _, g: torch.zeros(g.shape, dtype=torch.float32,
                                             device=g.device), grads)


def compress_with_feedback(grads: Tree, err: Tree
                           ) -> Tuple[Tree, Tree, Tree]:
    """Quantize ``grads + err`` leaf by leaf; the rounding error is the new
    residual.

    ``grads`` and ``err`` are tensors or trees of one structure.
    Returns ``(q, scales, new_err)``, each of that structure: int8
    values, f32 scalar scales and f32 residuals.  Over steps the decoded
    sum equals the true one up to the last step's residual.  Bit for bit
    the reference op by op; under ``jax.jit`` XLA may fuse the
    residual's multiply and subtract into one rounding (an FMA), a last
    bit the port's separate ops do not reproduce.
    """
    def one(_, g, e):
        target = g.to(torch.float32) + e
        q, scale = quantize_int8(target)
        return q, scale, target - dequantize_int8(q, scale)

    out = tree_map(one, grads, err)

    def pick(i):
        return tree_map(lambda _, g, t: t[i], grads, out)
    return pick(0), pick(1), pick(2)


def decompress(q: Tree, scales: Tree,
               dtype: torch.dtype = torch.float32) -> Tree:
    """Dequantize a compressed tensor or tree leaf by leaf."""
    return tree_map(lambda _, a, s: dequantize_int8(a, s, dtype), q, scales)


def _axis_group(mesh: Any, axes: Union[str, Sequence[str]]):
    """(process group, size) of the ranks that differ only along
    ``axes`` of ``mesh``: the axis's own group, or the group of the
    flattened sub-mesh where ``axes`` names several (in the mesh's
    order, the order JAX linearizes them in)."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    names = tuple(mesh.mesh_dim_names)
    idx = []
    for a in axes:
        if a not in names:
            raise ValueError(f"axis {a!r} is not one of the mesh's {names}")
        idx.append(names.index(a))
    if idx != sorted(idx) or len(set(idx)) != len(idx):
        raise ValueError(f"axes {axes} are not in the mesh's order {names}")
    if len(axes) == 1:
        return mesh.get_group(axes[0]), mesh.size(idx[0])
    sub = mesh[axes]._flatten()
    return sub.get_group(), sub.size()


def hierarchical_psum_mean(x: torch.Tensor, mesh: Any,
                           intra_axes: Union[str, Sequence[str]],
                           inter_axis: str,
                           err: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Mean of ``x`` over the ranks of ``intra_axes`` × ``inter_axis``.

    Every rank of ``mesh`` (a ``DeviceMesh``) calls it with its own
    ``x``.  The flat f32 ``x`` is reduce-scattered over the intra-pod
    axes (``all_reduce`` where they do not divide its length), each
    part summed across pods, then all-gathered inside the pod and
    divided by n_intra·n_inter.  The cross-pod sum is in bf16 without
    ``err``; with ``err`` (f32, shaped as this rank's part) it is the
    exact int32 sum of each pod's int8 values
    (:func:`compress_with_feedback`), 4× fewer bytes than f32.  Returns
    ``(mean in x's dtype, new err)``.

    As the reference does, the int32 sum is decoded with this rank's
    own scale, so pods whose parts differ in max|x| decode different
    means (ROADMAP §C).
    """
    g_intra, n_intra = _axis_group(mesh, intra_axes)
    g_inter, n_inter = _axis_group(mesh, inter_axis)
    flat = x.reshape(-1).to(torch.float32).contiguous()
    scattered = flat.numel() % n_intra == 0
    if scattered:
        part = torch.empty(flat.numel() // n_intra, dtype=torch.float32,
                           device=flat.device)
        dist.reduce_scatter_tensor(part, flat, group=g_intra)
    else:
        part = flat.clone()
        dist.all_reduce(part, group=g_intra)
    if err is not None:
        q, scale, err = compress_with_feedback(part, err)
        q32 = q.to(torch.int32)
        dist.all_reduce(q32, group=g_inter)
        part = q32.to(torch.float32) * scale
    else:
        wire = part.to(torch.bfloat16)
        dist.all_reduce(wire, group=g_inter)
        part = wire.to(torch.float32)
    if scattered:
        full = torch.empty_like(flat)
        dist.all_gather_into_tensor(full, part, group=g_intra)
    else:
        full = part
    n = torch.full((), float(n_intra * n_inter), device=full.device)
    return (full.reshape(x.shape) / n).to(x.dtype), err
