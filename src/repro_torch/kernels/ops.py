"""Dispatch surface: the hand-written CUDA kernels or their plain versions.

The rest of the port calls these entry points.  ``impl`` (or the
process-wide :func:`default_impl`) picks the implementation:

* ``auto`` — the CUDA kernel for CUDA tensors, the plain PyTorch version
  for CPU tensors (decided by where the tensor lies, nothing else);
* ``cuda`` — always the kernel; CPU tensors raise;
* ``ref``  — always the plain version, on any device.

This is the one place that maps ``impl`` and the device to an
implementation: the kernel modules hold only their ``launch`` wrappers,
``ref`` only the plain versions.  There is no silent fallback: a kernel
that fails to build or launch, or input it does not take, raises.

Every route runs inside ``work.kernel``: with a cost counter active
(``launch/cost.py``) the kernel's work on these inputs
(``kernels/work.py``) is recorded once, on either route, before the
route runs, and the counter counts none of the route's own operations
(the plain version's sorts and temporaries, a wrapper's allocations).
A composite dispatcher records each kernel it runs.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import decayed_scatter as _multihot
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import knn_topk as _knn
from repro_torch.kernels import ref
from repro_torch.kernels import serving_topn as _blend
from repro_torch.kernels import sparse_row_gather as _gather
from repro_torch.kernels import sparse_row_scatter as _scatter
from repro_torch.kernels import work

IMPLS = ("auto", "cuda", "ref")
_DEFAULT_IMPL = "auto"


@contextlib.contextmanager
def default_impl(impl: str) -> Iterator[None]:
    """Process-wide implementation override (auto | cuda | ref)."""
    global _DEFAULT_IMPL
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    prev = _DEFAULT_IMPL
    _DEFAULT_IMPL = impl
    try:
        yield
    finally:
        _DEFAULT_IMPL = prev


def uses_kernel(x: torch.Tensor, impl: Optional[str]) -> bool:
    """True where ``impl`` (or, for None, the default) asks for the
    kernel on ``x``.  ``impl`` has no default: a public ``impl=None``
    is the dispatchers' signature (rule OR01)."""
    impl = _DEFAULT_IMPL if impl is None else impl
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    return impl == "cuda" or (impl == "auto" and x.device.type != "cpu")


def knn_topk(queries: torch.Tensor, corpus: torch.Tensor, k: int,
             impl: Optional[str] = None, metric: str = "euclidean",
             query_gids: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused similarity + top-k: (f32[Q, k] scores, i32[Q, k] rows).

    ``queries`` f32[Q, D] against ``corpus`` f32[M, D]; euclidean scores
    are the surrogate 2q·c − |c|², dot scores q·c; ties go to the
    lowest row; the column ``query_gids[q]`` scores −inf.  The kernel
    path is ``knn_topk`` (B3: O(Q·M·D) compute, [Q, k] out, the [Q, M]
    scores never written); the plain path is ``ref.knn_topk_ref``.
    Other metrics (cosine) have no kernel and raise on every impl.
    """
    if metric not in ("euclidean", "dot"):
        raise ValueError(f"knn_topk scores euclidean or dot, not {metric}")
    with work.kernel(work.knn_topk, queries, corpus, k, metric=metric,
                     query_gids=query_gids):
        if uses_kernel(corpus, impl):
            return _knn.launch(queries, corpus, k, metric=metric,
                               query_gids=query_gids)
        return ref.knn_topk_ref(queries, corpus, k, metric=metric,
                                query_gids=query_gids)


def sparse_row_gather(table: torch.Tensor, rows: torch.Tensor,
                      ids: torch.Tensor,
                      impl: Optional[str] = None) -> torch.Tensor:
    """Sparse per-row gather ``table[rows, ids]`` → f32[U, W] (PAD → 0).

    O(U·W) elements addressed (the update-path supports, W ≪ I).
    """
    with work.kernel(work.sparse_row_gather, table, rows, ids):
        if uses_kernel(table, impl):
            return _gather.launch(table, rows, ids)
        return ref.sparse_row_gather_ref(table, rows, ids)


def sparse_row_scatter(table: torch.Tensor, rows: torch.Tensor,
                       ids: torch.Tensor, vals: torch.Tensor,
                       impl: Optional[str] = None) -> torch.Tensor:
    """Sparse per-row scatter-add into ``table`` IN PLACE; returns it.

    ``table[rows[r], ids[r, w]] += vals[r, w]`` for valid ids; O(U·W)
    elements addressed (the Eq. 7-13 deltas).
    """
    with work.kernel(work.sparse_row_scatter, table, rows, ids, vals):
        if uses_kernel(table, impl):
            return _scatter.launch(table, rows, ids, vals)
        return ref.sparse_row_scatter_ref(table, rows, ids, vals)


def knn_topk_dtiled(queries: torch.Tensor, corpus: torch.Tensor, k: int,
                    bd: int = 512, impl: Optional[str] = None,
                    query_gids: Optional[torch.Tensor] = None,
                    col_offset: int = 0, col_stride: int = 1,
                    sub_qnorm: bool = False,
                    q_scale: Optional[torch.Tensor] = None,
                    c_scale: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """D-tiled stage A: (f32[Q, k] scores, i32[Q, k] rows), euclidean.

    The contract of stage A with the q·c contraction summed per D tile
    of width ``bd``; int8 ``queries``/``corpus`` take the row scales
    ``q_scale``/``c_scale`` and are bitwise ``ref.dtiled_topk_ref`` on
    every impl.  O(Q·M·I) compute, [Q, k] out.
    """
    kw = dict(query_gids=query_gids, col_offset=col_offset,
              col_stride=col_stride, sub_qnorm=sub_qnorm, q_scale=q_scale,
              c_scale=c_scale)
    with work.kernel(work.knn_topk_dtiled, queries, corpus, k,
                     query_gids=query_gids, sub_qnorm=sub_qnorm,
                     q_scale=q_scale, c_scale=c_scale):
        if uses_kernel(corpus, impl):
            return _knn.launch_dtiled(queries, corpus, k, bd=bd, **kw)
        return ref.dtiled_topk_ref(queries, corpus, k, bd=bd, **kw)


def _serving_k(k: int, topn: int, n_items: int, m: int) -> int:
    """Check ``topn`` and clamp ``k`` to [1, M−1].

    With self-exclusion only M−1 candidates are finite, and a k that
    admits the −inf slot would resolve it differently on the kernel and
    plain paths.
    """
    if topn > n_items:
        raise ValueError(f"topn={topn} > n_items={n_items}")
    return max(1, min(k, m - 1))


def fused_recommend(corpus: torch.Tensor, user_ids: torch.Tensor, k: int,
                    alpha: float, topn: int, metric: str = "euclidean",
                    impl: Optional[str] = None,
                    bd: Optional[int] = None) -> torch.Tensor:
    """Serving path: corpus rows → top-n item ids, i32[Q, topn].

    ``corpus`` f32[M, I] (the cached serving corpus), ``user_ids``
    int[Q] corpus rows, self-excluded from their own neighbourhood.
    The kernel path is stage A (``knn_topk``: O(Q·M·I) compute, [Q, k]
    out; with ``bd`` the D-tiled ``knn_topk_dtiled``, euclidean) then
    stage B (``blend_topn_onehot``: each group's distinct neighbour rows
    read once per item tile, O(Q·k·I) adds, [Q, n] out).  The plain
    path runs the two stages of the JAX reference's unfused pipeline
    (``ref.fused_recommend_ref``'s, or ``ref.fused_recommend_dtiled_ref``'s
    with ``bd``).
    ``k`` is clamped to M−1 (``_serving_k``).  The kernels score
    euclidean and dot only, and no TPU kernel scores cosine either:
    ``metric="cosine"`` takes the plain path on every impl and device,
    ignoring ``bd``, as the JAX package does.  The metric alone decides
    that, before any launch.
    """
    kernel = uses_kernel(corpus, impl)
    q_n, m = user_ids.shape[0], corpus.shape[0]
    k = _serving_k(k, topn, corpus.shape[1], m)
    if q_n == 0 or m == 0:
        return torch.zeros((q_n, topn), dtype=torch.int32,
                           device=corpus.device)
    if metric == "cosine":
        return ref.fused_recommend_ref(corpus, user_ids, k, alpha, topn,
                                       metric)
    queries = corpus[user_ids.long()]
    with (work.kernel(work.knn_topk, queries, corpus, k, metric=metric,
                      query_gids=user_ids) if bd is None else
          work.kernel(work.knn_topk_dtiled, queries, corpus, k,
                      query_gids=user_ids)):
        if not kernel:
            idx = (ref.fused_topk_ref(queries, corpus, user_ids, k, metric)
                   if bd is None else
                   ref.dtiled_topk_ref(queries, corpus, k, bd=bd,
                                       query_gids=user_ids)[1])
        elif bd is None:
            _, idx = _knn.launch(queries, corpus, k, metric=metric,
                                 query_gids=user_ids)
        else:
            _, idx = _knn.launch_dtiled(queries, corpus, k, bd=bd,
                                        query_gids=user_ids)
    with work.kernel(work.blend_topn_onehot, corpus, user_ids, idx, topn):
        if not kernel:
            return ref.blend_topn_rows_ref(queries, corpus[idx.long()],
                                           alpha, topn)[1]
        return _blend.launch(corpus, user_ids, idx, alpha, topn)[1]


def fused_recommend_quant(corpus_q: torch.Tensor, c_scale: torch.Tensor,
                          user_ids: torch.Tensor, k: int, alpha: float,
                          topn: int, bd: int = 512,
                          impl: Optional[str] = None) -> torch.Tensor:
    """int8 serving: quantized corpus → top-n item ids, i32[Q, topn].

    ``corpus_q`` int8[M, I] with power-of-two row scales ``c_scale``
    f32[M] (``StateStore.quantized_corpus``).  The kernel path is the
    D-tiled int8 stage A (exact int32 tile partials, bitwise its plain
    version) then ``blend_topn_rows_quant`` reading the k selected int8
    rows straight from the corpus: O(Q·M·I) compute on int8, O(Q·k·I)
    int8 reads.  The plain path runs ``ref.fused_recommend_quant_ref``'s
    two stages.  ``k`` is clamped to M−1.  Euclidean only.
    """
    kernel = uses_kernel(corpus_q, impl)
    q_n, m = user_ids.shape[0], corpus_q.shape[0]
    k = _serving_k(k, topn, corpus_q.shape[1], m)
    if q_n == 0 or m == 0:
        return torch.zeros((q_n, topn), dtype=torch.int32,
                           device=corpus_q.device)
    uid = user_ids.long()
    queries_q, q_scale = corpus_q[uid], c_scale[uid]
    with work.kernel(work.knn_topk_dtiled, queries_q, corpus_q, k,
                     query_gids=user_ids, q_scale=q_scale, c_scale=c_scale):
        _, idx = (_knn.launch_dtiled if kernel else ref.dtiled_topk_ref)(
            queries_q, corpus_q, k, bd=bd, query_gids=user_ids,
            q_scale=q_scale, c_scale=c_scale)
    with work.kernel(work.blend_topn_rows_indexed, queries_q, q_scale,
                     corpus_q, c_scale, idx, topn):
        if not kernel:
            rows = idx.long()
            return ref.blend_topn_rows_quant_ref(
                queries_q, q_scale, corpus_q[rows], c_scale[rows], alpha,
                topn)[1]
        return _blend.launch_rows_indexed(queries_q, q_scale, corpus_q,
                                          c_scale, idx, alpha, topn)[1]


def _pin_self(vals: torch.Tensor, idx: torch.Tensor, shard: int,
              n_shards: int, query_gids: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Map local rows to global ids, pinning a −inf candidate's id.

    The self column is the only −inf score, and k >= M_s admits it on
    the owner shard, where the plain path names the self row and a
    kernel whatever its list held: both now name the query's own gid.
    """
    gids = idx * n_shards + shard
    return vals, torch.where(torch.isneginf(vals),
                             query_gids[:, None].to(gids.dtype), gids)


def _empty_candidates(q_n: int, k: int, m_s: int, dev: torch.device
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    kk = min(k, m_s)
    return (torch.full((q_n, kk), float("-inf"), dtype=torch.float32,
                       device=dev),
            torch.zeros((q_n, kk), dtype=torch.int32, device=dev))


def shard_topk(queries: torch.Tensor, corpus: torch.Tensor, k: int,
               shard: int, n_shards: int,
               query_gids: Optional[torch.Tensor] = None,
               metric: str = "euclidean", impl: Optional[str] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-shard neighbour candidates ``([Q, k'] scores, global ids)``.

    ``k' = min(k, M_s)``.  One shard's corpus (local row r is global
    user ``r·n_shards + shard``) scored with the full −|q−c|², so
    candidates of different shards compare.  The kernel path is
    ``knn_topk`` with ``sub_qnorm`` and the shard's gid mapping
    (O(Q·M_s·I), the [Q, M_s] scores never written), with −inf
    candidates pinned to the self gid; the plain path is
    ``ref.shard_topk_ref``.  Cosine has no kernel: it takes the plain
    path on every impl and device, as in the JAX package.
    """
    m_s, q_n = corpus.shape[0], queries.shape[0]
    if m_s == 0 or q_n == 0:
        return _empty_candidates(q_n, k, m_s, corpus.device)
    if metric == "cosine":
        return ref.shard_topk_ref(queries, corpus, k, shard, n_shards,
                                  query_gids, metric)
    with work.kernel(work.knn_topk, queries, corpus, min(k, m_s),
                     metric=metric, query_gids=query_gids,
                     sub_qnorm=metric == "euclidean"):
        if not uses_kernel(corpus, impl):
            return ref.shard_topk_ref(queries, corpus, k, shard, n_shards,
                                      query_gids, metric)
        if query_gids is None:
            query_gids = torch.full((q_n,), -1, dtype=torch.int32,
                                    device=corpus.device)
        vals, idx = _knn.launch(queries, corpus, min(k, m_s), metric=metric,
                                query_gids=query_gids, col_offset=shard,
                                col_stride=n_shards, sub_qnorm=True)
        return _pin_self(vals, idx, shard, n_shards, query_gids)


def shard_topk_quant(queries_q: torch.Tensor, q_scale: torch.Tensor,
                     corpus_q: torch.Tensor, c_scale: torch.Tensor, k: int,
                     shard: int, n_shards: int,
                     query_gids: Optional[torch.Tensor] = None,
                     bd: int = 512, impl: Optional[str] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-shard int8 candidates ``([Q, k'] scores, global ids)``.

    The int8 twin of :func:`shard_topk`: D-tiled int8 stage A over one
    shard's quantized corpus with ``sub_qnorm``, so the scores are the
    full −|q̂−ĉ|² of the dequantized rows.  Row-wise quantization is
    partition invariant, so they equal the single-corpus int8 scores,
    and both paths are bitwise the same.  O(Q·M_s·I).
    """
    m_s, q_n = corpus_q.shape[0], queries_q.shape[0]
    if m_s == 0 or q_n == 0:
        return _empty_candidates(q_n, k, m_s, corpus_q.device)
    if query_gids is None:
        query_gids = torch.full((q_n,), -1, dtype=torch.int32,
                                device=corpus_q.device)
    vals, idx = knn_topk_dtiled(
        queries_q, corpus_q, min(k, m_s), bd=bd, impl=impl,
        query_gids=query_gids, col_offset=shard, col_stride=n_shards,
        sub_qnorm=True, q_scale=q_scale, c_scale=c_scale)
    return _pin_self(vals, idx, shard, n_shards, query_gids)


def blend_topn_rows(queries: torch.Tensor, neighbor_rows: torch.Tensor,
                    alpha: float, topn: int,
                    impl: Optional[str] = None) -> torch.Tensor:
    """Cross-shard final stage: fetched rows f32[Q, k, I] → top-n ids.

    Mean over k, α-blend with the query row, top-n: O(Q·k·I) reads, no
    [Q, I] intermediate on the kernel path (``blend_topn_rows``); the
    plain path is ``ref.blend_topn_rows_ref``.
    """
    with work.kernel(work.blend_topn_rows, queries, neighbor_rows, topn):
        if uses_kernel(neighbor_rows, impl):
            return _blend.launch_rows(queries, neighbor_rows, alpha,
                                      topn)[1]
        return ref.blend_topn_rows_ref(queries, neighbor_rows, alpha,
                                       topn)[1]


def blend_topn_rows_quant(queries_q: torch.Tensor, q_scale: torch.Tensor,
                          neighbor_rows_q: torch.Tensor,
                          n_scale: torch.Tensor, alpha: float, topn: int,
                          impl: Optional[str] = None) -> torch.Tensor:
    """int8 cross-shard final stage: rows int8[Q, k, I] → top-n ids.

    The int8 twin of :func:`blend_topn_rows`: a quarter of the bytes,
    dequantized on chip (``blend_topn_rows_quant``); the plain path is
    ``ref.blend_topn_rows_quant_ref``.
    """
    with work.kernel(work.blend_topn_rows, queries_q, neighbor_rows_q, topn,
                     q_scale=q_scale, n_scale=n_scale):
        if uses_kernel(neighbor_rows_q, impl):
            return _blend.launch_rows(queries_q, neighbor_rows_q, alpha,
                                      topn, q_scale=q_scale,
                                      n_scale=n_scale)[1]
        return ref.blend_topn_rows_quant_ref(queries_q, q_scale,
                                             neighbor_rows_q, n_scale, alpha,
                                             topn)[1]


def blend_topn_rows_at(queries: torch.Tensor, nbr_rows: torch.Tensor,
                       tables: Sequence[torch.Tensor], alpha: float,
                       topn: int, q_scale: Optional[torch.Tensor] = None,
                       n_scale: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Cross-shard final stage on rows read where they lie → top-n ids.

    The kernel path of :func:`blend_topn_rows` (f32) and
    :func:`blend_topn_rows_quant` (int8, with ``q_scale`` and the rows'
    ``n_scale``) on ``nbr_rows`` i64[Q, k], the device addresses of the
    neighbour rows in ``tables``: the same answer without the [Q, k, I]
    gather.  Addresses have no plain version; a caller on the plain
    path (``uses_kernel`` False) fetches the rows instead.
    """
    with work.kernel(work.blend_topn_rows_at, queries, nbr_rows, tables,
                     topn, q_scale=q_scale, n_scale=n_scale):
        return _blend.launch_rows_at(queries, nbr_rows, tables, alpha, topn,
                                     q_scale=q_scale, n_scale=n_scale)[1]


def multihot_scatter(ids: torch.Tensor, weights: torch.Tensor, n_items: int,
                     impl: Optional[str] = None) -> torch.Tensor:
    """Weighted multi-hot scatter (the Eq. 1+2 from-scratch user vector).

    ``ids`` int[N, B] with ``weights`` f32[N] → f32[n_items], or all
    users at once: int[U, N, B] with f32[U, N] → f32[U, n_items].  Ids
    outside [0, n_items) (PAD) add nothing.  O(N·B) ids read, O(I) out
    per row; the kernel path (``decayed_scatter``) sums repeated ids in
    (n, b) order, the plain path is ``ref.decayed_scatter_ref``.
    """
    with work.kernel(work.decayed_scatter, ids, weights, n_items):
        if uses_kernel(ids, impl):
            return _multihot.launch(ids, weights, n_items)
        return ref.decayed_scatter_ref(ids, weights, n_items)


class FlashAttention(torch.autograd.Function):
    """Attention with its gradient: the kernel route runs B9 forward and
    9b (``flash_attention.launch_bwd``) backward; the plain route
    ``ref.flash_attention_ref`` and ``ref.flash_attention_bwd_ref``.  The
    route is fixed at the forward (``impl`` and the device, as
    :func:`uses_kernel` decides), so a backward run later, outside an
    ``impl`` override, takes the forward's.  Saves q, k and v; on the
    kernel route, where B9 ran its ``tma_wgmma`` design, also each row's
    log-sum-exp (``flash_attention.launch_with_lse``), which 9b's
    ``tma_wgmma`` design reads."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, kernel):
        ctx.causal, ctx.window, ctx.kernel = causal, window, kernel
        with work.kernel(work.flash_attention, q, k, v, causal, window):
            if not kernel:
                ctx.save_for_backward(q, k, v)
                return ref.flash_attention_ref(q, k, v, causal=causal,
                                               window=window)
            out, lse = _flash.launch_with_lse(q, k, v, causal=causal,
                                              window=window)
        ctx.save_for_backward(q, k, v, *(() if lse is None else (lse,)))
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, *saved = ctx.saved_tensors
        dout = dout.contiguous()
        with work.kernel(work.flash_attention_bwd, q, k, v, dout, ctx.causal,
                         ctx.window):
            if ctx.kernel:
                dq, dk, dv = _flash.launch_bwd(
                    q, k, v, dout, causal=ctx.causal, window=ctx.window,
                    lse=saved[0] if saved else None)
            else:
                dq, dk, dv = ref.flash_attention_bwd_ref(
                    q, k, v, dout, causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    impl: Optional[str] = None) -> torch.Tensor:
    """Blocked attention: q [B, S, H, D], k [B, S, KV, D] and v [B, S,
    KV, Dv] → [B, S, H, Dv].

    Causal (``window`` > 0 adds the sliding window), scale 1/√D (Q's
    width, as MLA's), H % KV == 0, Dv <= D.  O(S²·D) compute with
    O(S·D) memory on the kernel path (``flash_attention``: the [S, S]
    scores are never written); the plain path is
    ``ref.flash_attention_ref``, which takes any Dv <= D.  The kernel
    path takes a narrower V where its planned design does
    (``flash_attention.takes_v_width``: ``tma_wgmma`` at MLA's (192,
    128)) and raises otherwise; ``models.transformer.attend_padded_v``
    pads V for the designs that need it as wide as Q.  With grad mode on
    and an input that requires grad, the call goes through
    :class:`FlashAttention` (backward: 9b on the kernel path); otherwise
    straight to the forward, as serving runs it.
    """
    if v.shape[-1] > q.shape[-1]:
        raise ValueError(f"V width {v.shape[-1]} exceeds the query width "
                         f"{q.shape[-1]}")
    kernel = uses_kernel(q, impl)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window, kernel)
    with work.kernel(work.flash_attention, q, k, v, causal, window):
        if kernel:
            return _flash.launch(q, k, v, causal=causal, window=window)
        return ref.flash_attention_ref(q, k, v, causal=causal,
                                       window=window)
