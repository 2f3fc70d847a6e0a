"""Sparse per-row scatter-add into a [M, I] table (CUDA kernel + wrapper).

    table[rows[r], ids[r, w]] += vals[r, w]        (PAD ids skipped)

The write half of every Eq. 7-13 delta.  Replaces
``repro/kernels/sparse_row_scatter.py::sparse_row_scatter``.  The table
is updated IN PLACE.  A call is checks and one launch: the kernel
(``csrc/sparse_row_scatter.cu``) finds the entry rows that name one
table row and sums each cell's deltas in entry order with one read and
one write a cell, so the plan the JAX wrapper builds before its
``pallas_call`` (an argsort and a tile plan) is built on the card.  No
float atomics: the result is bitwise ``ref.sparse_row_scatter_ordered_ref``
and reruns agree.  Its plain version is ``ref.sparse_row_scatter_ref``;
``ops.sparse_row_scatter`` picks between the two.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from repro_torch.kernels import build

# csrc/sparse_row_scatter.cu's kThreads, kPer and kChunk: a run's head
# walks its entries in tiles of PER slabs of THREADS entries and stages
# the valid ones CHUNK at a time
THREADS, PER, CHUNK = 256, 8, 2048


def chunk_flushes(at: Sequence[int], valid: torch.Tensor
                  ) -> List[Tuple[int, int, int]]:
    """Where the kernel's head block flushes a staged chunk before the
    run's end: ``(window, tile, slab)`` for each flush, ``slab > 0`` one
    inside a tile.  ``at`` are the entry rows of one run in order (its
    head first), ``valid`` bool[len(at), W] which of their ids lie in
    [0, I).  The head takes the run's rows THREADS candidate entry rows
    at a time from its own on (a window), each window's entries in
    tiles of PER slabs; a slab that would overfill the chunk flushes it
    first."""
    window = [(a - at[0]) // THREADS for a in at]
    out, n = [], 0
    for win in sorted(set(window)):
        v = valid[[i for i, x in enumerate(window) if x == win]].reshape(-1)
        v = torch.cat([v.long(), v.new_zeros(-v.numel() % THREADS).long()])
        for s, c in enumerate(v.view(-1, THREADS).sum(1).tolist()):
            if n + c > CHUNK:
                out.append((win, *divmod(s, PER)))
                n = 0
            n += c
    return out


def launch(table: torch.Tensor, rows: torch.Tensor, ids: torch.Tensor,
           vals: torch.Tensor) -> torch.Tensor:
    """Scatter-add ``vals`` into ``table`` IN PLACE; returns ``table``.

    ``table`` f32[M, I]; ``rows`` int[U] (clamped to [0, M)); ``ids``
    int[U, W], entries outside [0, I) (PAD = -1) skipped; ``vals``
    f32[U, W].  Duplicate (row, id) pairs accumulate, in entry order.
    ``rows`` and ``ids`` are read as given, int32 or int64 each: nothing
    is cast and, when the inputs are contiguous, nothing is copied.
    Raises on tensors it does not take (CPU tensors among them).

    Sized for the engine's sub-batches (256 rows by default, 512 in
    ``launch.serve.run_trickle``): the kernel's time grows as U^2 (each
    block scans all rows) and with the longest run of one row (its
    first block walks it alone), so a sub-batch of 4,096 rows half
    padding takes longer on the card than the sort the kernel replaced,
    and one of 16,384 distinct rows as long
    (``csrc/sparse_row_scatter.cu``).
    """
    build.cuda_input(table, "table", (torch.float32,), ndim=2)
    dev = table.device
    rows = build.index_as_given(rows, "rows", dev, 1)
    ids = build.index_as_given(ids, "ids", dev, 2)
    vals = build.cuda_input(vals.contiguous(), "vals", (torch.float32,),
                            dev, 2)
    m, n_items = table.shape
    u, w = ids.shape
    if rows.shape[0] != u or vals.shape != ids.shape:
        raise ValueError(f"shapes rows {tuple(rows.shape)}, ids "
                         f"{tuple(ids.shape)}, vals {tuple(vals.shape)}")
    if m == 0:
        raise ValueError("empty table")
    build.check(build.library().srs_launch(
        table.data_ptr(), rows.data_ptr(), ids.data_ptr(), vals.data_ptr(),
        m, n_items, u, w, build.index_bits(rows, ids), build.stream_of(table)),
        "sparse_row_scatter")
    build.count_launch("sparse_row_scatter")
    return table
