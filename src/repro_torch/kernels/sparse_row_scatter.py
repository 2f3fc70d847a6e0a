"""Sparse per-row scatter-add into a [M, I] table (CUDA kernel + wrapper).

    table[rows[r], ids[r, w]] += vals[r, w]        (PAD ids skipped)

The write half of every Eq. 7-13 delta.  Replaces
``repro/kernels/sparse_row_scatter.py::sparse_row_scatter``.  The table
is updated IN PLACE.  The wrapper builds the plan -- flat cell keys
``row·I + id`` (invalid entries get the key ``M·I``) sorted stably, the
counterpart of the JAX wrapper's argsort + tile plan -- and the kernel
(``csrc/sparse_row_scatter.cu``) sums each run of equal keys in the
original entry order with one read and one write per cell: no float
atomics, so reruns agree bitwise.  Its plain version is
``ref.sparse_row_scatter_ref``; ``ops.sparse_row_scatter`` picks between
the two.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build


def launch(table: torch.Tensor, rows: torch.Tensor, ids: torch.Tensor,
           vals: torch.Tensor) -> torch.Tensor:
    """Scatter-add ``vals`` into ``table`` IN PLACE; returns ``table``.

    ``table`` f32[M, I]; ``rows`` int[U] (clamped to [0, M)); ``ids``
    int[U, W], entries outside [0, I) (PAD = -1) skipped; ``vals``
    f32[U, W].  Duplicate (row, id) pairs accumulate.  Builds the
    sorted-key plan and launches the CUDA kernel; raises on tensors it
    does not take (CPU tensors among them).
    """
    build.cuda_input(table, "table", (torch.float32,), ndim=2)
    dev = table.device
    rows = build.index_input(rows, "rows", dev, 1)
    ids = build.index_input(ids, "ids", dev, 2)
    vals = build.cuda_input(vals.contiguous(), "vals", (torch.float32,),
                            dev, 2)
    m, n_items = table.shape
    if rows.shape[0] != ids.shape[0] or vals.shape != ids.shape:
        raise ValueError(f"shapes rows {tuple(rows.shape)}, ids "
                         f"{tuple(ids.shape)}, vals {tuple(vals.shape)}")
    if m == 0:
        raise ValueError("empty table")
    limit = m * n_items
    valid = (ids >= 0) & (ids < n_items)
    keys = (rows.long().clamp(0, m - 1)[:, None] * n_items + ids.long())
    keys = torch.where(valid, keys, torch.full_like(keys, limit))
    skeys, perm = torch.sort(keys.reshape(-1), stable=True)
    svals = vals.reshape(-1)[perm].contiguous()
    build.check(build.library().srs_launch(
        table.data_ptr(), skeys.data_ptr(), svals.data_ptr(), skeys.numel(),
        limit, build.stream_of(table)), "sparse_row_scatter")
    build.count_launch("sparse_row_scatter")
    return table
