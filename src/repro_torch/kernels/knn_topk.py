"""Fused similarity × streaming top-k (serving stage A, CUDA kernel).

Q queries against M corpus rows, returning each query's top-k rows of
the euclidean surrogate ``2q·c − |c|²`` (or the raw dot product) without
writing the [Q, M] score matrix to device memory.  Replaces
``repro/kernels/knn_topk.py::knn_topk``; see ``csrc/knn_topk.cu`` for
the design (corpus slices across blocks, register-tiled fp32 FMA,
per-slice running top-k lists merged by a second kernel).  Ties go to the lowest row, as
``lax.top_k``.  Its plain version is ``ref.knn_topk_ref``;
``ops.fused_recommend`` picks between the two.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, ref

MAX_K = 1024   # largest list the kernel keeps per query
_BQ = 16       # queries per block of csrc/knn_topk.cu
_ROWS = 128    # slices are whole multiples of one warp's 128 rows


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def plan_slices(n_queries: int, m: int, n_sms: int) -> Tuple[int, int]:
    """Cut the corpus into slices for the stage-A grid.

    Returns (rows per slice, number of slices): at most one block per SM
    (the top-k lists fill most of its shared memory), so the grid runs
    in one wave.
    """
    q_tiles = -(-n_queries // _BQ)
    want = max(1, min(n_sms // q_tiles, -(-m // _ROWS)))
    rows = -(-(-(-m // want)) // _ROWS) * _ROWS
    return rows, -(-m // rows)


def launch(queries: torch.Tensor, corpus: torch.Tensor, k: int,
           metric: str = "euclidean",
           query_gids: Optional[torch.Tensor] = None,
           col_offset: int = 0, col_stride: int = 1
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage A: each query's top-k corpus rows, (f32[Q, k], i32[Q, k]).

    ``queries`` f32[Q, D] × ``corpus`` f32[M, D].  The column whose
    global id ``row·col_stride + col_offset`` equals ``query_gids[q]``
    scores −inf (self-exclusion).  Requires ``1 <= k <= min(M, 1024)``.
    Launches the CUDA kernels; raises on input they do not take (CPU
    tensors among them).
    """
    build.cuda_input(corpus, "corpus", (torch.float32,), ndim=2)
    dev = corpus.device
    build.cuda_input(queries, "queries", (torch.float32,), dev, 2)
    q_n, d = queries.shape
    m = corpus.shape[0]
    if corpus.shape[1] != d:
        raise ValueError(f"queries width {d} != corpus width "
                         f"{corpus.shape[1]}")
    if metric not in ("euclidean", "dot"):
        raise ValueError(f"the kernel scores euclidean or dot, not {metric}")
    if not 1 <= k <= min(m, MAX_K):
        raise ValueError(f"k={k} outside [1, min(M={m}, {MAX_K})]")
    if col_offset < 0 or col_stride < 1:
        raise ValueError("col_offset must be >= 0 and col_stride >= 1")
    if query_gids is None:
        gids = torch.full((q_n,), -1, dtype=torch.int32, device=dev)
    else:
        gids = build.index_input(query_gids, "query_gids", dev, 1)
        if gids.shape[0] != q_n:
            raise ValueError("query_gids must have one entry per query")
    out_v = torch.empty((q_n, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((q_n, k), dtype=torch.int32, device=dev)
    if q_n == 0:
        return out_v, out_i
    euclid = metric == "euclidean"
    cn = (ref.corpus_sqnorm(corpus) if euclid
          else torch.zeros((1,), dtype=torch.float32, device=dev))
    n2 = max(64, _pow2_at_least(k))
    rows, n_slices = plan_slices(
        q_n, m, torch.cuda.get_device_properties(dev).multi_processor_count)
    part_v = torch.empty((q_n, n_slices, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((q_n, n_slices, k), dtype=torch.int32, device=dev)
    build.check(build.library().knn_topk_launch(
        queries.data_ptr(), corpus.data_ptr(), cn.data_ptr(),
        gids.data_ptr(), q_n, m, d, k, n2, int(euclid), col_offset,
        col_stride, rows, n_slices, part_v.data_ptr(), part_i.data_ptr(),
        out_v.data_ptr(), out_i.data_ptr(), build.stream_of(corpus)),
        "knn_topk")
    build.count_launch("knn_topk")
    return out_v, out_i
