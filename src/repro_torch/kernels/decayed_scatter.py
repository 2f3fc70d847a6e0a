"""Weighted multi-hot scatter (CUDA kernel + wrapper).

    out[i] = Σ_{n,b} w[n] · [ids[n, b] == i]        (ids outside [0, I) skipped)

The Eq. 1+2 from-scratch user vector.  Replaces
``repro/kernels/decayed_scatter.py::decayed_scatter`` and its vmap
``batched_decayed_scatter``: one launch takes one row ``[N, B]`` or all
users' rows ``[U, N, B]``.  The kernel (``csrc/decayed_scatter.cu``)
zeroes the output, then one block per row sorts the row's valid entries
by (id, entry) in shared memory and sums each run of equal ids in (n, b)
order: no float atomics, so reruns agree bitwise, and no divisibility
condition on N or I.  Its plain version is ``ref.decayed_scatter_ref``;
``ops.multihot_scatter`` picks between the two.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build


def _check_shapes(ids: torch.Tensor, weights: torch.Tensor,
                  n_items: int):
    """Raise on shapes the kernel does not take; returns (U, N, B)."""
    if ids.dim() not in (2, 3):
        raise ValueError(f"ids must be [N, B] or [U, N, B], got "
                         f"{tuple(ids.shape)}")
    u, n, b = ids.shape if ids.dim() == 3 else (1, *ids.shape)
    if tuple(weights.shape) != tuple(ids.shape[:-1]):
        raise ValueError(f"weights {tuple(weights.shape)} do not match ids "
                         f"{tuple(ids.shape)}")
    if not 0 < n_items < 2 ** 31:
        raise ValueError(f"n_items={n_items} outside [1, 2^31)")
    return u, n, b


def launch(ids: torch.Tensor, weights: torch.Tensor,
           n_items: int) -> torch.Tensor:
    """Scatter the weighted ids of one row or of all users' rows.

    ``ids`` int[N, B] with ``weights`` f32[N] give f32[n_items];
    ``ids`` int[U, N, B] with ``weights`` f32[U, N] give f32[U, n_items].
    Launches the CUDA kernel; raises on tensors it does not take (CPU
    tensors among them).
    """
    ids = build.index_input(ids, "ids", None, ids.dim())
    weights = build.cuda_input(weights.contiguous(), "weights",
                               (torch.float32,), ids.device)
    u, n, b = _check_shapes(ids, weights, n_items)
    out = torch.empty((u, n_items), dtype=torch.float32, device=ids.device)
    build.check(build.library().decayed_scatter_launch(
        out.data_ptr(), ids.data_ptr(), weights.data_ptr(), u, n, b,
        n_items, build.stream_of(out)), "decayed_scatter")
    build.count_launch("decayed_scatter")
    return out[0] if ids.dim() == 2 else out
