"""Fused similarity × streaming top-k (serving stage A, CUDA kernels).

Q queries against M corpus rows, returning each query's top-k rows of
the euclidean surrogate ``2q·c − |c|²`` (or the raw dot product) without
writing the [Q, M] score matrix to device memory.  Ties go to the lowest
row, as ``lax.top_k``.  Two kernels, one plan (corpus slices across
blocks, register-tiled products, per-slice running top-k lists merged
by a second kernel):

* :func:`launch` replaces ``repro/kernels/knn_topk.py::knn_topk``
  (``csrc/knn_topk.cu``, fp32 over the whole of D); its plain version is
  ``ref.knn_topk_ref``;
* :func:`launch_dtiled` replaces ``::knn_topk_dtiled``
  (``csrc/knn_topk_dtiled.cu``): D summed in tiles of width ``bd``, for
  an fp32 corpus or an int8 one with power-of-two row scales, where it
  equals its plain version ``ref.dtiled_topk_ref`` bit for bit.

``ops`` picks between each kernel and its plain version.
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


# The JAX package's ``knn_topk.tiled_sqnorm`` counterpart: |q|² of the
# queries for sub_qnorm (the kernel sums |c|² itself, in the same tiles).
tiled_sqnorm = ref.tiled_sqnorm_ref


def _query_gids(query_gids: Optional[torch.Tensor], q_n: int,
                dev: torch.device) -> torch.Tensor:
    if query_gids is None:
        return torch.full((q_n,), -1, dtype=torch.int32, device=dev)
    gids = build.index_input(query_gids, "query_gids", dev, 1)
    if gids.shape[0] != q_n:
        raise ValueError("query_gids must have one entry per query")
    return gids


def _check_common(d: int, m: int, width: int, k: int, col_offset: int,
                  col_stride: int) -> None:
    if width != d:
        raise ValueError(f"queries width {d} != corpus width {width}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} outside [1, {MAX_K}]")
    if m and k > m:
        raise ValueError(f"k={k} > M={m}")
    if col_offset < 0 or col_stride < 1:
        raise ValueError("col_offset must be >= 0 and col_stride >= 1")


def launch(queries: torch.Tensor, corpus: torch.Tensor, k: int,
           metric: str = "euclidean",
           query_gids: Optional[torch.Tensor] = None,
           col_offset: int = 0, col_stride: int = 1,
           sub_qnorm: bool = False
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage A: each query's top-k corpus rows, (f32[Q, k], i32[Q, k]).

    ``queries`` f32[Q, D] × ``corpus`` f32[M, D].  The column whose
    global id ``row·col_stride + col_offset`` equals ``query_gids[q]``
    scores −inf (self-exclusion).  ``sub_qnorm`` subtracts |q|² from the
    euclidean scores (the full −|q−c|² of the per-shard candidates).
    Requires ``1 <= k <= min(M, 1024)``.  Launches the CUDA kernels;
    raises on input they do not take (CPU tensors among them).
    """
    build.cuda_input(corpus, "corpus", (torch.float32,), ndim=2)
    dev = corpus.device
    build.cuda_input(queries, "queries", (torch.float32,), dev, 2)
    q_n, d = queries.shape
    m = corpus.shape[0]
    if metric not in ("euclidean", "dot"):
        raise ValueError(f"the kernel scores euclidean or dot, not {metric}")
    _check_common(d, m, corpus.shape[1], k, col_offset, col_stride)
    if m == 0:
        raise ValueError("the corpus has no rows")
    gids = _query_gids(query_gids, q_n, dev)
    out_v = torch.empty((q_n, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((q_n, k), dtype=torch.int32, device=dev)
    if q_n == 0:
        return out_v, out_i
    euclid = metric == "euclidean"
    cn = (ref.corpus_sqnorm(corpus) if euclid
          else torch.zeros((1,), dtype=torch.float32, device=dev))
    qn = ref.corpus_sqnorm(queries) if euclid and sub_qnorm else None
    n2 = max(64, _pow2_at_least(k))
    rows, n_slices = plan_slices(
        q_n, m, torch.cuda.get_device_properties(dev).multi_processor_count)
    part_v = torch.empty((q_n, n_slices, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((q_n, n_slices, k), dtype=torch.int32, device=dev)
    build.check(build.library().knn_topk_launch(
        queries.data_ptr(), corpus.data_ptr(), cn.data_ptr(),
        None if qn is None else qn.data_ptr(), gids.data_ptr(), q_n, m, d,
        k, n2, int(euclid), col_offset, col_stride, rows, n_slices,
        part_v.data_ptr(), part_i.data_ptr(), out_v.data_ptr(),
        out_i.data_ptr(), build.stream_of(corpus)),
        "knn_topk")
    build.count_launch("knn_topk")
    return out_v, out_i


def launch_dtiled(queries: torch.Tensor, corpus: torch.Tensor, k: int,
                  bd: int = 512,
                  query_gids: Optional[torch.Tensor] = None,
                  col_offset: int = 0, col_stride: int = 1,
                  sub_qnorm: bool = False,
                  q_scale: Optional[torch.Tensor] = None,
                  c_scale: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """D-tiled stage A: each query's top-k rows, (f32[Q, k], i32[Q, k]).

    The q·c contraction is summed per D tile of width ``bd`` and across
    tiles in tile order.  ``queries`` [Q, D] × ``corpus`` [M, D], both
    f32 or both int8; int8 takes the power-of-two row scales ``q_scale``
    f32[Q] and ``c_scale`` f32[M] (``optim.compression
    .quantize_int8_rows``) and ``bd <= 1024`` (a tile's int32 partial
    then converts to f32 exactly).
    Self-exclusion, ``col_offset``/``col_stride`` and ``sub_qnorm`` as
    :func:`launch` (euclidean only).  Requires ``1 <= k <= min(M,
    1024)``; an empty corpus gives −inf scores.  Launches the CUDA
    kernels; raises on input they do not take (CPU tensors among them).
    """
    quantized = corpus.dtype == torch.int8
    if quantized and (q_scale is None or c_scale is None):
        raise ValueError("int8 corpus requires q_scale and c_scale")
    if quantized and bd > 1024:
        raise ValueError(f"bd={bd} > 1024 breaks the exact f32 convert of "
                         "an int8 tile's partial")
    if bd < 1:
        raise ValueError(f"bd={bd} < 1")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} outside [1, {MAX_K}]")
    build.cuda_input(corpus, "corpus", (torch.float32, torch.int8), ndim=2,
                     pitched=True)
    dev = corpus.device
    build.cuda_input(queries, "queries", (corpus.dtype,), dev, 2,
                     pitched=True)
    q_n, d = queries.shape
    m = corpus.shape[0]
    _check_common(d, m, corpus.shape[1], k, col_offset, col_stride)
    gids = _query_gids(query_gids, q_n, dev)
    out_v = torch.full((q_n, k), float("-inf"), dtype=torch.float32,
                       device=dev)
    out_i = torch.zeros((q_n, k), dtype=torch.int32, device=dev)
    if q_n == 0 or m == 0:
        return out_v, out_i
    scales = (None, None)
    if quantized:
        scales = (build.cuda_input(q_scale, "q_scale", (torch.float32,),
                                   dev, 1),
                  build.cuda_input(c_scale, "c_scale", (torch.float32,),
                                   dev, 1))
        if scales[0].shape[0] != q_n or scales[1].shape[0] != m:
            raise ValueError("q_scale / c_scale need one entry per row")
    bd = min(bd, d)
    qn = tiled_sqnorm(queries, bd) if sub_qnorm else None
    # int8 rows go as 16-byte vectors when D tiles start 16-byte aligned;
    # the rows then need a 16-byte pitch.  StateStore.quantized_corpus
    # keeps one; any other int8 corpus is padded into a copy (0.2 GB at
    # I=11,997).  The queries (Q rows) are copied to the corpus's pitch.
    vec = quantized and bd % 16 == 0
    ld = corpus.stride(0) if m > 1 else d
    if vec and (ld % 16 or corpus.data_ptr() % 16):
        ld = d + (-d % 16)
        corpus = torch.nn.functional.pad(corpus, (0, ld - d))
    if queries.stride(0) != ld or (vec and queries.data_ptr() % 16):
        queries = torch.nn.functional.pad(queries, (0, ld - d))
    n2 = max(64, _pow2_at_least(k))
    rows, n_slices = plan_slices(
        q_n, m, torch.cuda.get_device_properties(dev).multi_processor_count)
    part_v = torch.empty((q_n, n_slices, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((q_n, n_slices, k), dtype=torch.int32, device=dev)
    ptr = [None if t is None else t.data_ptr() for t in (qn, *scales)]
    build.check(build.library().knn_topk_dtiled_launch(
        queries.data_ptr(), corpus.data_ptr(), ptr[0], ptr[1], ptr[2],
        gids.data_ptr(), q_n, m, d, ld, k, n2, bd, int(quantized), int(vec),
        col_offset, col_stride, rows, n_slices, part_v.data_ptr(),
        part_i.data_ptr(), out_v.data_ptr(), out_i.data_ptr(),
        build.stream_of(corpus)), "knn_topk_dtiled")
    build.count_launch("knn_topk_dtiled")
    return out_v, out_i
