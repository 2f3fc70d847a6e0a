"""The work each hand-written kernel must do, counted from its inputs.

One function per kernel call form returns a :class:`Work`: the launch
count's name of the kernel (``build.launch_counts``), its operations (an
FMA as two), the bytes it must move and the class of its operations
(``"bf16"``, ``"f32"`` or ``"int8"``: the peak ``launch/roofline.py``
divides them by).  Each input byte is read once and each output byte
written once; a tensor's bytes are its distinct elements (a broadcast
dimension reads nothing twice).  Where the work depends on the data, the
count is what these inputs need: B1's and B2's valid ids and B2's
distinct cells, B4's and B6's distinct neighbour rows, B8's history
entries.  Those counts read the device (a host sync); the dispatchers
ask for them only while a cost counter is active.

The work is the function's, not the implementation's: a kernel's bound
does not move when its design does, and a cell counts the same work on
the kernel route and on the plain route.

:data:`SINK` is the active cost counter (``launch/cost.py``), ``None``
when no counter is active.  ``ops``'s dispatchers run each route inside
:func:`kernel`, which records the kernel's work with the counter once and
suspends the counter's own counting of aten ops inside; with no counter
active it costs one check of :data:`SINK` and syncs nothing.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

# the active cost counter, or None
SINK = None
_UNCOUNTED = contextlib.nullcontext()

# 9b's products, as (products of width D, of width Dv), each 2·width
# flops per visible (query, key) pair: the gradient's own 5 given the
# log-sum-exp that B9 saves (S, dK and dQ at D; dP and dV at Dv; 2.5x
# the forward's at Dv = D)
GRAD_PRODUCTS = (3, 2)


class Work(NamedTuple):
    kernel: str          # the launch count's name of the kernel
    ops: float           # operations, an FMA as two
    bytes: float         # bytes read once and written once
    dtype: str           # "bf16" | "f32" | "int8"


def kernel(fn, *args, **kw):
    """The context a dispatcher runs a kernel's route in: with a counter
    active, ``fn``'s work on these inputs is recorded once and the
    counter's aten counting is suspended inside; else nothing."""
    if SINK is None:
        return _UNCOUNTED
    SINK.declare(fn, args, kw)
    return SINK.quiet()


def declare(fn, *args, **kw) -> None:
    """Record ``fn``'s work on these inputs with the active counter (a
    composite dispatcher's later kernel, whose inputs the first made)."""
    if SINK is not None:
        SINK.declare(fn, args, kw)


def nbytes(t: Optional[torch.Tensor]) -> int:
    """The bytes of ``t``'s distinct elements (0 for ``None``): a
    dimension of stride 0 (a broadcast) counts once."""
    if t is None:
        return 0
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size() if t.numel() else 0


def dtype_class(dtype: torch.dtype) -> str:
    """The peak that operations on ``dtype`` inputs run at: "bf16"
    (bf16, f16), "int8" (int8, uint8, fp8) or "f32" (f32; f64 at the f32
    peak, which the FP64 tensor cores also reach)."""
    if dtype in (torch.bfloat16, torch.float16):
        return "bf16"
    if dtype in (torch.int8, torch.uint8) or "float8" in str(dtype):
        return "int8"
    return "f32"


def _valid(ids: torch.Tensor, n: int) -> torch.Tensor:
    return (ids >= 0) & (ids < n)


def _distinct_rows(idx: torch.Tensor, m: int) -> int:
    """Distinct rows in [0, M) that ``idx`` names."""
    flat = idx.reshape(-1).long()
    return int(torch.unique(flat[_valid(flat, m)]).numel())


def sparse_row_gather(table: torch.Tensor, rows: torch.Tensor,
                      ids: torch.Tensor) -> Work:
    """B1: rows and ids read, the valid ids' table cells read, [U, W]
    written; no arithmetic."""
    n_valid = int(_valid(ids, table.shape[1]).sum())
    out = ids.numel() * 4
    return Work("sparse_row_gather", 0.0, float(
        nbytes(rows) + nbytes(ids) + n_valid * table.element_size() + out),
        "f32")


def sparse_row_scatter(table: torch.Tensor, rows: torch.Tensor,
                       ids: torch.Tensor, vals: torch.Tensor) -> Work:
    """B2: rows, ids and deltas read, each distinct cell read and written
    once; one add a valid id."""
    n_items = table.shape[1]
    valid = _valid(ids, n_items)
    n_valid = int(valid.sum())
    cells = rows.long().reshape(-1, 1) * n_items + ids.long()
    n_cells = int(torch.unique(cells[valid]).numel())
    return Work("sparse_row_scatter", float(n_valid), float(
        nbytes(rows) + nbytes(ids) + nbytes(vals)
        + 2 * n_cells * table.element_size()), "f32")


def _stage_a(name: str, queries: torch.Tensor, corpus: torch.Tensor,
             k: int, euclidean: bool, sub_qnorm: bool,
             extra: Sequence[Optional[torch.Tensor]]) -> Work:
    """Stage A: queries, corpus and ``extra`` read once, [Q, k] values
    and ids written; the q·c products, with the |c|² sums for euclidean
    scores and the |q|² sums for ``sub_qnorm``."""
    q_n, d = queries.shape
    m = corpus.shape[0]
    ops = 2.0 * q_n * m * d
    if euclidean:
        ops += 2.0 * m * d
        if sub_qnorm:
            ops += 2.0 * q_n * d
    return Work(name, ops, float(
        nbytes(queries) + nbytes(corpus) + sum(nbytes(t) for t in extra)
        + q_n * k * 8), dtype_class(corpus.dtype))


def knn_topk(queries: torch.Tensor, corpus: torch.Tensor, k: int,
             metric: str = "euclidean",
             query_gids: Optional[torch.Tensor] = None,
             sub_qnorm: bool = False) -> Work:
    """B3, fp32."""
    return _stage_a("knn_topk", queries, corpus, k, metric == "euclidean",
                    sub_qnorm, (query_gids,))


def knn_topk_dtiled(queries: torch.Tensor, corpus: torch.Tensor, k: int,
                    query_gids: Optional[torch.Tensor] = None,
                    sub_qnorm: bool = False,
                    q_scale: Optional[torch.Tensor] = None,
                    c_scale: Optional[torch.Tensor] = None) -> Work:
    """B5, euclidean: int8 (with the row scales) or fp32."""
    name = ("knn_topk_dtiled" if corpus.dtype == torch.int8
            else "knn_topk_dtiled_f32")
    return _stage_a(name, queries, corpus, k, True, sub_qnorm,
                    (query_gids, q_scale, c_scale))


def _blend_ops(q_n: int, k: int, n_items: int) -> float:
    # Q·(k+1)·I adds in FMA slots (int8: multiply-adds), two operations
    return 2.0 * q_n * (k + 1) * n_items


def blend_topn_onehot(corpus: torch.Tensor, user_ids: torch.Tensor,
                      nbr_idx: torch.Tensor, topn: int) -> Work:
    """B4: the distinct rows of the queries and their neighbours read
    once, ids read, [Q, n] values and ids written."""
    m, n_items = corpus.shape
    q_n, k = nbr_idx.shape
    rows = _distinct_rows(torch.cat([nbr_idx.reshape(-1).long(),
                                     user_ids.reshape(-1).long()]), m)
    return Work("blend_topn_onehot", _blend_ops(q_n, k, n_items), float(
        rows * n_items * corpus.element_size() + nbytes(user_ids)
        + nbytes(nbr_idx) + q_n * topn * 8), "f32")


def _rows_name(dtype: torch.dtype) -> str:
    return ("blend_topn_rows_quant" if dtype == torch.int8
            else "blend_topn_rows")


def blend_topn_rows(queries: torch.Tensor, neighbor_rows: torch.Tensor,
                    topn: int, q_scale: Optional[torch.Tensor] = None,
                    n_scale: Optional[torch.Tensor] = None) -> Work:
    """B7 (f32) or B6 (int8) over pre-fetched rows [Q, k, I]: queries,
    rows and scales read once, [Q, n] written."""
    q_n, k, n_items = neighbor_rows.shape
    return Work(_rows_name(neighbor_rows.dtype), _blend_ops(q_n, k, n_items),
                float(nbytes(queries) + nbytes(neighbor_rows)
                      + nbytes(q_scale) + nbytes(n_scale) + q_n * topn * 8),
                "f32")


def blend_topn_rows_indexed(queries_q: torch.Tensor, q_scale: torch.Tensor,
                            corpus_q: torch.Tensor, c_scale: torch.Tensor,
                            nbr_idx: torch.Tensor, topn: int) -> Work:
    """B6 reading the neighbour rows from the corpus: queries and their
    scales, the distinct neighbour rows with their scales and the ids
    read once, [Q, n] written."""
    m, n_items = corpus_q.shape
    q_n, k = nbr_idx.shape
    rows = _distinct_rows(nbr_idx, m)
    return Work(_rows_name(corpus_q.dtype), _blend_ops(q_n, k, n_items),
                float(nbytes(queries_q) + nbytes(q_scale)
                      + rows * (n_items * corpus_q.element_size()
                                + c_scale.element_size())
                      + nbytes(nbr_idx) + q_n * topn * 8), "f32")


def blend_topn_rows_at(queries: torch.Tensor, nbr_rows: torch.Tensor,
                       tables: Sequence[torch.Tensor], topn: int,
                       q_scale: Optional[torch.Tensor] = None,
                       n_scale: Optional[torch.Tensor] = None) -> Work:
    """B7 or B6 over rows read where they lie (``nbr_rows`` their
    addresses): the distinct rows read once, with the queries, the
    addresses and the scales, [Q, n] written."""
    q_n, n_items = queries.shape
    k = nbr_rows.shape[1]
    rows = int(torch.unique(nbr_rows.reshape(-1)).numel())
    return Work(_rows_name(queries.dtype), _blend_ops(q_n, k, n_items),
                float(nbytes(queries) + nbytes(q_scale) + nbytes(n_scale)
                      + rows * n_items * queries.element_size()
                      + nbytes(nbr_rows) + q_n * topn * 8), "f32")


def decayed_scatter(ids: torch.Tensor, weights: torch.Tensor,
                    n_items: int) -> Work:
    """B8: ids and weights read, [U, I] (or [I]) written; one add a
    valid history entry."""
    n_rows = ids.shape[0] if ids.dim() == 3 else 1
    n_valid = int(_valid(ids, n_items).sum())
    return Work("decayed_scatter", float(n_valid), float(
        nbytes(ids) + nbytes(weights) + n_rows * n_items * 4), "f32")


def visible_pairs(s: int, causal: bool = True, window: int = 0) -> int:
    """The (query, key) pairs the causal mask and the window leave, per
    (batch, head), for S queries over S keys; key j is seen by query i
    where j <= i (causal) and j > i − window (``window`` > 0)."""
    w = window if 0 < window < s else s
    if causal:
        return w * (w + 1) // 2 + (s - w) * w
    return s * s - (s - w) * (s - w + 1) // 2


def _attention(q: torch.Tensor, v: torch.Tensor, causal: bool,
               window: int) -> Tuple[int, int, int]:
    b, s, h, d = q.shape
    return d, v.shape[-1], b * h * visible_pairs(s, causal, window)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> Work:
    """B9: q, k and v read once, [B, S, H, Dv] written; 2·(D + Dv)
    flops a visible pair (QKᵀ and P·V)."""
    d, dv, pairs = _attention(q, v, causal, window)
    out = q.shape[0] * q.shape[1] * q.shape[2] * dv * v.element_size()
    return Work("flash_attention", 2.0 * (d + dv) * pairs, float(
        nbytes(q) + nbytes(k) + nbytes(v) + out), dtype_class(q.dtype))


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        dout: torch.Tensor, causal: bool = True,
                        window: int = 0,
                        products: Tuple[int, int] = GRAD_PRODUCTS) -> Work:
    """9b, the gradient given the forward's log-sum-exp: q, k, v, dO and
    the lse (f32 a row and head) read once, dq, dk and dv written;
    ``products`` of width D and Dv, 2·width flops a visible pair each."""
    d, dv, pairs = _attention(q, v, causal, window)
    b, s, h = q.shape[:3]
    io = nbytes(q) + nbytes(k) + nbytes(v)
    return Work("flash_attention_bwd",
                2.0 * (products[0] * d + products[1] * dv) * pairs,
                float(2 * io + nbytes(dout) + b * h * s * 4),
                dtype_class(q.dtype))
