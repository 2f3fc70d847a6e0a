"""Fused neighbour blend + top-n (serving stage B, CUDA kernels).

Two kernels blend a query's own row with the mean of its k neighbour
rows and keep the top-n items per query (ties to the lowest item id),
without writing the [Q, I] predictions to device memory:

* :func:`launch` replaces ``repro/kernels/serving_topn.py::
  blend_topn_onehot`` (``csrc/serving_topn.cu``)::

      pred[q, i] = α·C[uid_q, i] + ((1 − α)·Σ_j C[idx[q, j], i]) / k

  On Hopper the neighbour sum is a gather of k corpus rows per query,
  not a one-hot matmul, so no [Q, k, I] gather is written either.  Its
  plain version is ``ref.blend_topn_ref``.
* :func:`launch_rows` replaces ``::blend_topn_rows`` (f32) and
  ``::blend_topn_rows_quant`` (int8 rows with power-of-two row scales,
  dequantized on chip), ``csrc/serving_rows.cu``::

      pred[q, i] = α·x_q[i] + (1 − α)·mean_j(r_qj[i])

  over pre-fetched rows [Q, k, I]; :func:`launch_rows_indexed` reads
  the int8 neighbour rows straight from the corpus instead.  Plain
  versions: ``ref.blend_topn_rows_ref`` / ``blend_topn_rows_quant_ref``.

``ops`` picks between each kernel and its plain version.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

MAX_TOPN = 1024   # largest list the merge keeps per query
_BI = 1024        # items per block of csrc/serving_topn.cu


def launch(corpus: torch.Tensor, user_ids: torch.Tensor,
           nbr_idx: torch.Tensor, alpha: float,
           topn: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage B: blend and top-n items per query, (f32[Q, n], i32[Q, n]).

    ``corpus`` f32[M, I] × ``user_ids`` int[Q] × ``nbr_idx`` int[Q, k].
    Neighbour entries outside [0, M) (e.g. −1) add 0 but still count in
    k.  Requires ``1 <= topn <= min(I, 1024)``.  Launches the CUDA
    kernels; raises on input they do not take (CPU tensors among them).
    """
    build.cuda_input(corpus, "corpus", (torch.float32,), ndim=2)
    dev = corpus.device
    uid = build.index_input(user_ids, "user_ids", dev, 1)
    nbr = build.index_input(nbr_idx, "nbr_idx", dev, 2)
    m, n_items = corpus.shape
    q_n, k = nbr.shape
    if uid.shape[0] != q_n:
        raise ValueError("user_ids and nbr_idx disagree on Q")
    if not 1 <= topn <= min(n_items, MAX_TOPN):
        raise ValueError(f"topn={topn} outside [1, min(I={n_items}, "
                         f"{MAX_TOPN})]")
    if k < 1:
        raise ValueError("nbr_idx needs at least one neighbour column")
    out_v = torch.empty((q_n, topn), dtype=torch.float32, device=dev)
    out_i = torch.empty((q_n, topn), dtype=torch.int32, device=dev)
    if q_n == 0:
        return out_v, out_i
    n_tiles = -(-n_items // _BI)
    lst = min(topn, _BI)
    n2 = 1 << max(0, (topn - 1).bit_length())
    part_v = torch.empty((q_n, n_tiles, lst), dtype=torch.float32,
                         device=dev)
    part_i = torch.empty((q_n, n_tiles, lst), dtype=torch.int32, device=dev)
    build.check(build.library().blend_topn_launch(
        corpus.data_ptr(), uid.data_ptr(), nbr.data_ptr(), q_n, m, n_items,
        k, float(alpha), float(1.0 - alpha), topn, lst, n2,
        part_v.data_ptr(), part_i.data_ptr(), out_v.data_ptr(),
        out_i.data_ptr(), build.stream_of(corpus)), "blend_topn_onehot")
    build.count_launch("blend_topn_onehot")
    return out_v, out_i


def _row_addresses(rows: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """Device addresses of rows ``index`` of ``rows``, int64.

    ``rows`` is 2-D with contiguous rows at its row pitch; the result
    has ``index``'s shape.
    """
    row_bytes = rows.stride(0) * rows.element_size()
    return index.to(torch.int64) * row_bytes + rows.data_ptr()


def _scale_input(t: Optional[torch.Tensor], what: str, dev: torch.device,
                 shape: Tuple[int, ...]) -> torch.Tensor:
    if t is None:
        raise ValueError(f"int8 rows require {what}")
    build.cuda_input(t, what, (torch.float32,), dev, len(shape))
    if tuple(t.shape) != shape:
        raise ValueError(f"{what}: shape {tuple(t.shape)}, expected {shape}")
    return t


def _blend_rows(q_rows: torch.Tensor, q_scale: Optional[torch.Tensor],
                nbr_rows: torch.Tensor, nbr_scale: Optional[torch.Tensor],
                n_items: int, alpha: float, topn: int, dev: torch.device,
                name: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/serving_rows.cu`` on row addresses.

    ``q_rows`` i64[Q] and ``nbr_rows`` i64[Q, k]; the rows are int8
    when the scales are given, else f32.
    """
    q_n, k = nbr_rows.shape
    if not 1 <= topn <= min(n_items, MAX_TOPN):
        raise ValueError(f"topn={topn} outside [1, min(I={n_items}, "
                         f"{MAX_TOPN})]")
    if k < 1:
        raise ValueError("need at least one neighbour row per query")
    out_v = torch.empty((q_n, topn), dtype=torch.float32, device=dev)
    out_i = torch.empty((q_n, topn), dtype=torch.int32, device=dev)
    if q_n == 0:
        return out_v, out_i
    n_tiles = -(-n_items // _BI)
    lst = min(topn, _BI)
    n2 = 1 << max(0, (topn - 1).bit_length())
    part_v = torch.empty((q_n, n_tiles, lst), dtype=torch.float32,
                         device=dev)
    part_i = torch.empty((q_n, n_tiles, lst), dtype=torch.int32, device=dev)
    quantized = q_scale is not None
    build.check(build.library().blend_rows_launch(
        q_rows.data_ptr(), q_scale.data_ptr() if quantized else None,
        nbr_rows.data_ptr(), nbr_scale.data_ptr() if quantized else None,
        int(quantized), q_n, n_items, k, float(alpha), float(1.0 - alpha),
        topn, lst, n2, part_v.data_ptr(), part_i.data_ptr(),
        out_v.data_ptr(), out_i.data_ptr(), build.stream_of(q_rows)), name)
    build.count_launch(name)
    return out_v, out_i


def launch_rows(queries: torch.Tensor, neighbor_rows: torch.Tensor,
                alpha: float, topn: int,
                q_scale: Optional[torch.Tensor] = None,
                n_scale: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage B over pre-fetched rows, (f32[Q, n], i32[Q, n]).

    ``queries`` [Q, I] × ``neighbor_rows`` [Q, k, I], both f32
    (``blend_topn_rows``) or both int8 with row scales ``q_scale``
    f32[Q] and ``n_scale`` f32[Q, k] (``blend_topn_rows_quant``).
    Requires ``1 <= topn <= min(I, 1024)``.  Launches the CUDA kernels;
    raises on input they do not take (CPU tensors among them).
    """
    build.cuda_input(neighbor_rows, "neighbor_rows",
                     (torch.float32, torch.int8), ndim=3)
    dev = neighbor_rows.device
    build.cuda_input(queries, "queries", (neighbor_rows.dtype,), dev, 2)
    q_n, k, n_items = neighbor_rows.shape
    if tuple(queries.shape) != (q_n, n_items):
        raise ValueError(f"queries {tuple(queries.shape)} do not match "
                         f"neighbor_rows {tuple(neighbor_rows.shape)}")
    quantized = neighbor_rows.dtype == torch.int8
    if quantized:
        q_scale = _scale_input(q_scale, "q_scale", dev, (q_n,))
        n_scale = _scale_input(n_scale, "n_scale", dev, (q_n, k))
    else:
        q_scale = n_scale = None
    flat = neighbor_rows.reshape(q_n * k, n_items)
    return _blend_rows(
        _row_addresses(queries, torch.arange(q_n, device=dev)), q_scale,
        _row_addresses(flat, torch.arange(q_n * k, device=dev)
                       ).reshape(q_n, k), n_scale, n_items, alpha, topn,
        dev, "blend_topn_rows_quant" if quantized else "blend_topn_rows")


def launch_rows_indexed(queries_q: torch.Tensor, q_scale: torch.Tensor,
                        corpus_q: torch.Tensor, c_scale: torch.Tensor,
                        nbr_idx: torch.Tensor, alpha: float,
                        topn: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 stage B reading the neighbour rows straight from the corpus.

    Neighbour j of query q is row ``corpus_q[nbr_idx[q, j]]`` with scale
    ``c_scale[nbr_idx[q, j]]``.  The same kernel and count as
    :func:`launch_rows` on ``corpus_q[nbr_idx]``, without writing that
    [Q, k, I] gather.  ``nbr_idx`` must lie in [0, M) (checked: one
    host sync).
    """
    build.cuda_input(corpus_q, "corpus_q", (torch.int8,), ndim=2,
                     pitched=True)
    dev = corpus_q.device
    build.cuda_input(queries_q, "queries_q", (torch.int8,), dev, 2)
    nbr = build.index_input(nbr_idx, "nbr_idx", dev, 2)
    m, n_items = corpus_q.shape
    q_n, k = nbr.shape
    if tuple(queries_q.shape) != (q_n, n_items):
        raise ValueError("queries_q must be [Q, I] with Q = nbr_idx rows")
    q_scale = _scale_input(q_scale, "q_scale", dev, (q_n,))
    _scale_input(c_scale, "c_scale", dev, (m,))
    if nbr.numel():
        lo, hi = (int(v) for v in torch.aminmax(nbr))
        if lo < 0 or hi >= m:
            raise ValueError(f"nbr_idx outside [0, {m}): [{lo}, {hi}]")
    return _blend_rows(
        _row_addresses(queries_q, torch.arange(q_n, device=dev)), q_scale,
        _row_addresses(corpus_q, nbr), c_scale[nbr.long()].contiguous(),
        n_items, alpha, topn, dev, "blend_topn_rows_quant")
