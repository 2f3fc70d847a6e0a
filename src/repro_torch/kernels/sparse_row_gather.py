"""Sparse per-row gather from a [M, I] table (CUDA kernel + wrapper).

    vals[r, w] = table[rows[r], ids[r, w]]          (PAD ids give 0)

The read half of the sparse pair: the add path gathers the old
last-group values on its support, both delete paths the old raw values.
Replaces ``repro/kernels/sparse_row_gather.py::sparse_row_gather``; the
kernel (``csrc/sparse_row_gather.cu``) takes any ``n_items`` -- no tile
plan, no ``I % bi`` precondition.  Its plain version is
``ref.sparse_row_gather_ref``; ``ops.sparse_row_gather`` picks between
the two.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build


def launch(table: torch.Tensor, rows: torch.Tensor,
           ids: torch.Tensor) -> torch.Tensor:
    """f32[U, W] = table[rows, ids] by the CUDA kernel.

    ``table`` f32[M, I]; ``rows`` int[U] (clamped to [0, M)); ``ids``
    int[U, W], entries outside [0, I) (PAD = -1) read 0.  ``rows`` and
    ``ids`` are read as given, int32 or int64 each: nothing is cast or,
    when they are contiguous, copied.  Raises on tensors it does not
    take (CPU tensors among them).
    """
    build.cuda_input(table, "table", (torch.float32,), ndim=2)
    dev = table.device
    rows = build.index_as_given(rows, "rows", dev, 1)
    ids = build.index_as_given(ids, "ids", dev, 2)
    m, n_items = table.shape
    u, w = ids.shape
    if rows.shape[0] != u:
        raise ValueError(f"rows has {rows.shape[0]} entries, ids {u} rows")
    if m == 0:
        raise ValueError("empty table")
    out = torch.empty((u, w), dtype=torch.float32, device=dev)
    build.check(build.library().srg_launch(
        table.data_ptr(), rows.data_ptr(), ids.data_ptr(), out.data_ptr(),
        m, n_items, u, w, build.index_bits(rows, ids), build.stream_of(table)),
        "sparse_row_gather")
    build.count_launch("sparse_row_gather")
    return out
