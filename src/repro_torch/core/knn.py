"""Personalised collaborative-filtering prediction and ranking metrics.

Prediction (paper §2.2): p = alpha · u_target + (1 − alpha) · mean of the
top-k neighbours.  ``nearest_neighbors`` / ``predict`` are the plain
formulation (full [Q, M] scores), ``streaming_topk`` and
``chunked_neighbor_mean`` the same answers in corpus and neighbour
chunks.  ``predict_streaming`` is the reference's ``predict`` on a mesh
(stage A through ``ops.knn_topk``, then the chunked mean), and
``distributed_predict`` its user-sharded form over contiguous row blocks
(one per device: local top-k, one merge, partial neighbour sums added in
block order).  Under a named ``DeviceMesh`` (``mesh=``) both run in
ranks: each rank's rows through B3, the candidate lists merged over each
axis, one all-reduce of the partial neighbour sums.  ``recommend_for_users`` serves through
``kernels.ops.fused_recommend`` (the two CUDA serving kernels on the
card, the plain unfused pipeline on CPU), ``recommend_for_users_quant``
through ``ops.fused_recommend_quant`` (the int8 corpus), and the two
``sharded_recommend_for_users*`` over per-shard corpora: per-shard
candidates, a merge, the selected rows fetched and blended.  Recall@K /
NDCG@K follow §6.1.  ``compare_recommendations`` holds two top-n
answers against each other where fp32 summation order can legitimately
reorder near-ties.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops, ref


def pairwise_scores(queries: torch.Tensor, corpus: torch.Tensor,
                    metric: str = "euclidean") -> torch.Tensor:
    """Similarity scores (higher = closer), [Q, I] × [M, I] → [Q, M].

    euclidean −|q − c|² (as 2q·c − |q|² − |c|²), cosine or dot.
    O(Q·M·I).
    """
    return ref.pairwise_scores(queries, corpus, metric)


def nearest_neighbors(queries: torch.Tensor, corpus: torch.Tensor, k: int,
                      metric: str = "euclidean", exclude_self: bool = False,
                      query_ids: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k neighbours per query: (f32[Q, k] scores, i32[Q, k] rows).

    The full [Q, M] scores, then a stable top-k (ties to the lowest
    row).  ``exclude_self`` scores row ``query_ids[q]`` (default q) −inf.
    O(Q·M·I) compute, O(Q·M) memory.
    """
    scores = pairwise_scores(queries, corpus, metric)
    if exclude_self:
        q_n = queries.shape[0]
        ids = (torch.arange(q_n, device=scores.device) if query_ids is None
               else query_ids.long())
        scores[torch.arange(q_n, device=scores.device), ids] = float("-inf")
    vals, idx = ref.topk_lowest_index(scores, k)
    return vals, idx.to(torch.int32)


def predict(queries: torch.Tensor, corpus: torch.Tensor, k: int,
            alpha: float, metric: str = "euclidean",
            exclude_self: bool = True,
            query_ids: Optional[torch.Tensor] = None, mesh: Any = None,
            rules: Any = None) -> torch.Tensor:
    """TIFU-kNN prediction per query, f32[Q, I].

    α·q + (1−α)·mean of its k nearest corpus rows.  O(Q·M·I) compute, a
    [Q, k, I] gather.

    With a named ``DeviceMesh`` (every rank calls it): the one-device
    :func:`predict_streaming` answer, as a DTensor every rank holds
    whole.  ``queries`` and ``corpus`` are DTensors in any layout (the
    serve cell's: users over the batch axes, items over the tensor axis)
    or the global values every rank holds.  The corpus is moved to whole
    rows of users over every mesh axis, the queries gathered, then
    :func:`distributed_predict`'s mesh route runs on the rank's rows;
    ``rules`` is JAX's argument, which the route does not read.
    Euclidean or dot.
    """
    if mesh is not None:
        from repro_torch.parallel import spmd
        from repro_torch.parallel.sharding import Spec
        gids = None
        if exclude_self:
            gids = (torch.arange(queries.shape[0],
                                 device=spmd.local(corpus).device)
                    if query_ids is None else spmd.gather_full(query_ids))
        out = _predict_on_rows(spmd.enter(queries, mesh, Spec()),
                               spmd.enter(corpus, mesh, _rows_spec(mesh)),
                               k, alpha, mesh, metric, gids)
        return spmd.from_local(out, mesh, Spec())
    _, idx = nearest_neighbors(queries, corpus, k, metric, exclude_self,
                               query_ids)
    neighbors = torch.mean(corpus[idx.long()], dim=1)
    return alpha * queries + (1.0 - alpha) * neighbors


def streaming_topk(queries: torch.Tensor, corpus: torch.Tensor, k: int,
                   metric: str = "euclidean", chunk: int = 65536,
                   exclude_self: bool = False,
                   query_ids: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k without the [Q, M] score matrix: (f32[Q, k], i32[Q, k]).

    Scans the corpus in blocks of ``chunk`` rows with a running top-k:
    each block's scores are appended to the running list and a stable
    descending sort keeps the first k (ties to the lowest row, the
    running entries first).  Remainder rows form one masked tail block
    (padding rows score −inf), never a smaller chunk.  Entries past the
    finite scores hold −inf and row 0.  O(Q·M·I) compute, O(Q·(k +
    chunk)) memory.
    """
    q_n, d = queries.shape
    m = corpus.shape[0]
    dev = queries.device
    chunk = max(1, min(chunk, m))    # m == 0: no block, a −inf result
    nc = m // chunk
    qids = (torch.arange(q_n, device=dev) if query_ids is None
            else query_ids.long())
    vals = torch.full((q_n, k), float("-inf"), dtype=torch.float32,
                      device=dev)
    idx = torch.zeros((q_n, k), dtype=torch.int32, device=dev)

    def merge(vals, idx, block, ci):
        s = pairwise_scores(queries, block, metric)           # [Q, chunk]
        tile = ci * chunk + torch.arange(chunk, device=dev)
        s = torch.where(tile >= m, float("-inf"), s)          # padding rows
        if exclude_self:
            s = torch.where(tile == qids[:, None], float("-inf"), s)
        return ref.merge_topk(vals, idx, s.to(torch.float32), tile, k)

    for ci in range(nc):
        vals, idx = merge(vals, idx, corpus[ci * chunk:(ci + 1) * chunk],
                          ci)
    rem = m - nc * chunk
    if rem:
        tail = torch.zeros((chunk, d), dtype=corpus.dtype, device=dev)
        tail[:rem] = corpus[nc * chunk:]
        vals, idx = merge(vals, idx, tail, nc)
    return vals, idx


def chunked_neighbor_mean(corpus: torch.Tensor, idx: torch.Tensor,
                          chunk_k: int = 8) -> torch.Tensor:
    """mean(corpus[idx], axis=1) summed over neighbour chunks, f32[Q, I].

    Bounds the gather to [Q, chunk_k, I] (the whole [Q, k, I] would be
    80 GB at Q=4096, k=300, I=16k).  Rows of −1 add nothing; the sum is
    divided by k.  The neighbour list is padded with −1 to a multiple of
    ``chunk_k``, never cut to smaller chunks.  O(Q·k·I).
    """
    return _neighbor_sum(corpus, idx, chunk_k) / idx.shape[1]


def _neighbor_sum(corpus: torch.Tensor, idx: torch.Tensor,
                  chunk_k: int = 8) -> torch.Tensor:
    """sum(corpus[idx], axis=1) over neighbour chunks, rows of −1
    adding nothing: the sum :func:`chunked_neighbor_mean` divides."""
    q_n, k = idx.shape
    chunk_k = max(1, min(chunk_k, k))
    pad = (-k) % chunk_k
    if pad:
        idx = torch.cat([idx, torch.full((q_n, pad), -1, dtype=idx.dtype,
                                         device=idx.device)], dim=1)
    acc = torch.zeros((q_n, corpus.shape[1]), dtype=corpus.dtype,
                      device=corpus.device)
    for j in range(0, k + pad, chunk_k):
        ib = idx[:, j:j + chunk_k]
        valid = (ib >= 0)[..., None].to(corpus.dtype)
        rows = torch.where(ib >= 0, ib, torch.zeros_like(ib)).long()
        acc = acc + torch.sum(corpus[rows] * valid, dim=1)
    return acc


# queries a neighbour sum takes at once in the serving predictions: its
# [Q, 8, I] gathers are 512 MiB at I = 16,384 (2 GiB at the 4,096
# queries of a tifu-knn serve cell)
MEAN_QUERY_CHUNK = 1024


def predict_streaming(queries: torch.Tensor, corpus: torch.Tensor, k: int,
                      alpha: float, metric: str = "euclidean",
                      exclude_self: bool = True,
                      query_ids: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """TIFU-kNN prediction per query without a [Q, M] score matrix or a
    [Q, k, I] gather, f32[Q, I].

    The JAX reference's ``predict`` on a mesh: the top-k through
    ``ops.knn_topk`` (stage A, B3 on the card: the scores never leave
    the chip; the plain version on the CPU), then the neighbour mean in
    chunks of 8 neighbours and :data:`MEAN_QUERY_CHUNK` queries, then
    the α-blend.  ``exclude_self`` scores row ``query_ids[q]`` (default
    q) −inf.  Euclidean or dot.  O(Q·M·I) compute, O(Q·k·I) reads.
    """
    gids = None
    if exclude_self:
        gids = (torch.arange(queries.shape[0], dtype=torch.int32,
                             device=corpus.device)
                if query_ids is None else query_ids)
    _, idx = ops.knn_topk(queries, corpus, k, metric=metric,
                          query_gids=gids)
    out = torch.empty_like(queries)
    for q0 in range(0, queries.shape[0], MEAN_QUERY_CHUNK):
        sl = slice(q0, q0 + MEAN_QUERY_CHUNK)
        out[sl] = alpha * queries[sl] + (1.0 - alpha) * \
            chunked_neighbor_mean(corpus, idx[sl])
    return out


def distributed_topk(queries: torch.Tensor,
                     blocks: Sequence[torch.Tensor], k: int,
                     metric: str = "euclidean"
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The global top-k over a corpus held as ``n`` contiguous row
    blocks: (f32[Q, k] scores, i64[Q, k] global rows), on the queries'
    device.

    Block ``s`` holds global rows ``[s·m_loc, (s+1)·m_loc)`` on its own
    device; the blocks must be of one size (the JAX reference needs
    ``M % n == 0``).  Each block gives its local top-k through
    ``ops.knn_topk`` (B3 on the card), ids offset by its first row;
    the ``n`` lists merge once by (score desc, id asc): the list of one
    corpus, as the blocks rise in id and each list is ordered.
    O(Q·M·I) compute, O(n·Q·k) moved between devices.
    """
    m_loc = blocks[0].shape[0]
    if any(b.shape[0] != m_loc for b in blocks):
        raise ValueError(f"row blocks differ in size: "
                         f"{[b.shape[0] for b in blocks]}")
    if k > m_loc:
        raise ValueError(f"k={k} > the {m_loc} rows of a block")
    vals, gids = [], []
    for s, block in enumerate(blocks):
        v, i = ops.knn_topk(queries.to(block.device), block, k,
                            metric=metric)
        vals.append(v.to(queries.device))
        gids.append(i.to(queries.device).long() + s * m_loc)
    return _merge_scored(vals, gids, k)


def distributed_predict(queries: torch.Tensor, blocks: Any, k: int,
                        alpha: float, metric: str = "euclidean",
                        mesh: Any = None, rules: Any = None) -> torch.Tensor:
    """TIFU-kNN prediction over a corpus held as contiguous row blocks,
    one per device, f32[Q, I] on the queries' device.

    The JAX reference's ``distributed_predict`` (users over every mesh
    axis, queries replicated): the merged top-k of
    :func:`distributed_topk`; then each block sums the selected rows it
    holds, in chunks of neighbours and queries (a gather: no [Q, m_loc]
    one-hot); the partial sums are added in block order on the queries'
    device (the reference's psum), divided by k and α-blended.  No
    self-exclusion, as in the reference.  O(Q·M·I) compute, O(n·Q·k·I)
    reads, n [Q, I] partials moved.

    With a named ``DeviceMesh`` (every rank calls it), ``blocks`` is the
    corpus: a DTensor, moved to whole rows of users over every mesh axis
    where it lies otherwise, or the global value every rank holds, of
    which the rank keeps its rows; ``queries`` likewise, gathered.  Each
    rank runs B3 on its own rows (:func:`_predict_on_rows`); the answer
    is a DTensor every rank holds whole.  ``rules`` is JAX's argument,
    which the route does not read.
    """
    if mesh is not None:
        from repro_torch.parallel import spmd
        from repro_torch.parallel.sharding import Spec
        out = _predict_on_rows(spmd.enter(queries, mesh, Spec()),
                               spmd.enter(blocks, mesh, _rows_spec(mesh)),
                               k, alpha, mesh, metric)
        return spmd.from_local(out, mesh, Spec())
    _, sel = distributed_topk(queries, blocks, k, metric)
    m_loc = blocks[0].shape[0]
    total = None
    for s, block in enumerate(blocks):
        local = sel.to(block.device) - s * m_loc
        local = torch.where((local >= 0) & (local < m_loc), local,
                            torch.full_like(local, -1))
        part = torch.empty((sel.shape[0], block.shape[1]),
                           dtype=block.dtype, device=block.device)
        for q0 in range(0, sel.shape[0], MEAN_QUERY_CHUNK):
            sl = slice(q0, q0 + MEAN_QUERY_CHUNK)
            part[sl] = _neighbor_sum(block, local[sl])
        part = part.to(queries.device)
        total = part if total is None else total + part
    return alpha * queries + (1.0 - alpha) * total / k


def _rows_spec(mesh: Any) -> Any:
    """Whole rows of users over every axis of ``mesh``, in its order."""
    from repro_torch.parallel.sharding import Spec
    return Spec(tuple(mesh.mesh_dim_names), None)


def _merge_over(vals: torch.Tensor, gids: torch.Tensor, k: int, mesh: Any,
                axis: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The candidate lists ([Q, k] scores, i64 global ids) of the ranks of
    ``axis`` merged: both all-gathered along the list, then the first k
    by (score desc, id asc) (:func:`_merge_scored`).  Every rank of
    ``axis`` gets the same list."""
    from repro_torch.parallel import spmd
    return _merge_scored([spmd.all_gather(vals, mesh, axis, 1)],
                         [spmd.all_gather(gids, mesh, axis, 1)], k)


def _predict_on_rows(queries: torch.Tensor, rows: torch.Tensor, k: int,
                     alpha: float, mesh: Any, metric: str = "euclidean",
                     query_ids: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """The mesh route of :func:`distributed_predict` on one rank, f32[Q,
    I]: ``rows`` is the rank's block of the corpus (whole rows, users
    over every mesh axis in its order), ``queries`` whole.

    B3 on the block (``ops.knn_topk``; the column of ``query_ids[q]``,
    given, scores −inf), its ids made global; the lists merged over each
    axis, the innermost first (JAX's order): an all-gather of the [Q, k]
    scores and ids, then the first k by (score desc, id asc), the one
    corpus's order; each rank sums the selected rows it holds, in chunks
    of neighbours and queries; one all-reduce of the [Q, I] partial sums
    over every axis; then the α-blend.  No [Q, M] score matrix and no
    reduction of partial scores: O(Q·M·I / n) compute a rank, O(n·Q·k)
    candidates and one [Q, I] sum moved.
    """
    from repro_torch.parallel import spmd
    axes = tuple(mesh.mesh_dim_names)
    # a gathered block is a strided view; B3 reads whole rows
    queries, rows = queries.contiguous(), rows.contiguous()
    m_loc = rows.shape[0]
    if k > m_loc:
        raise ValueError(f"k={k} > the {m_loc} rows of a rank's block")
    lo = spmd.axis_index(mesh, axes) * m_loc
    gids = None if query_ids is None else \
        (query_ids.to(rows.device).long() - lo).to(torch.int32)
    vals, idx = ops.knn_topk(queries, rows, k, metric=metric,
                             query_gids=gids)
    sel = idx.long() + lo
    for axis in reversed(axes):
        vals, sel = _merge_over(vals, sel, k, mesh, axis)
    local = sel - lo
    local = torch.where((local >= 0) & (local < m_loc), local,
                        torch.full_like(local, -1))
    part = torch.empty((sel.shape[0], rows.shape[1]), dtype=rows.dtype,
                       device=rows.device)
    for q0 in range(0, sel.shape[0], MEAN_QUERY_CHUNK):
        sl = slice(q0, q0 + MEAN_QUERY_CHUNK)
        part[sl] = _neighbor_sum(rows, local[sl])
    total = spmd.psum(part, mesh, axes)
    return alpha * queries + (1.0 - alpha) * total / k


def recommend_topn(pred: torch.Tensor, n: int) -> torch.Tensor:
    """Indices of the top-n scored items per user, i32[Q, n].

    Ties go to the lowest item.
    """
    return ref.topk_lowest_index(pred, n)[1].to(torch.int32)


def recommend_for_users(corpus: torch.Tensor, user_ids: torch.Tensor,
                        k: int, alpha: float, topn: int,
                        metric: str = "euclidean") -> torch.Tensor:
    """Serving path: corpus rows → top-n item ids, i32[Q, topn].

    ``corpus`` is the cached materialized corpus f32[M, I]
    (``StateStore.corpus()``); ``user_ids`` int[Q] are the requesting
    users, which are corpus rows (self-excluded from the neighbourhood).
    O(Q·M·I) compute for stage A, O(Q·k·I) reads for stage B.
    """
    return ops.fused_recommend(corpus, user_ids, k=k, alpha=alpha,
                               topn=topn, metric=metric)


def recommend_for_users_quant(corpus_q: torch.Tensor, c_scale: torch.Tensor,
                              user_ids: torch.Tensor, k: int, alpha: float,
                              topn: int, bd: int = 512) -> torch.Tensor:
    """int8 serving path: quantized corpus rows → top-n ids, i32[Q, topn].

    ``corpus_q`` int8[M, I] with power-of-two row scales ``c_scale``
    f32[M] (``StateStore.quantized_corpus()``).  Stage A walks D in
    tiles of width ``bd`` with exact int32 tile partials (bitwise its
    plain version), stage B reads the k selected int8 rows.  Euclidean
    only.  O(Q·M·I) int8 compute, O(Q·k·I) int8 reads.
    """
    return ops.fused_recommend_quant(corpus_q, c_scale, user_ids, k=k,
                                     alpha=alpha, topn=topn, bd=bd)


def shard_topk_candidates(queries: torch.Tensor, corpus: torch.Tensor,
                          k: int, shard: int, n_shards: int,
                          query_ids: Optional[torch.Tensor] = None,
                          metric: str = "euclidean"
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-shard neighbour candidates: ``([Q, k'] scores, global ids)``.

    ``corpus`` is one shard's corpus (local row r is global user
    ``r·n_shards + shard``, the round-robin ``UserShardSpec``); scores
    are the full −|q−c|², comparable across shards; a query user is
    excluded only on its owner shard.  O(Q·M_s·I) compute, O(Q·k) out.
    """
    return ops.shard_topk(queries, corpus, k=k, shard=shard,
                          n_shards=n_shards, query_gids=query_ids,
                          metric=metric)


def _owner_rows(tables: Sequence[torch.Tensor], gids: torch.Tensor,
                n_shards: int) -> torch.Tensor:
    """Rows of a round-robin sharded table, for global ids of any shape.

    ``out[...] = tables[g % n_shards][g // n_shards]`` for each id g.
    """
    out = torch.empty(tuple(gids.shape) + tuple(tables[0].shape[1:]),
                      dtype=tables[0].dtype, device=tables[0].device)
    for s, table in enumerate(tables):
        own = gids % n_shards == s
        out[own] = table[gids[own] // n_shards]
    return out


def _owner_row_addresses(tables: Sequence[torch.Tensor], gids: torch.Tensor,
                         n_shards: int) -> torch.Tensor:
    """Device addresses of the rows :func:`_owner_rows` would fetch.

    ``out[...] = data_ptr + (g // n_shards)·pitch`` of table ``g %
    n_shards`` (its row stride in bytes), int64 of ``gids``' shape; the
    ids are not range-checked.  Nothing is copied and nothing waits on
    the card.
    """
    g = gids.long()
    shard, local = g % n_shards, g // n_shards
    out = torch.zeros_like(g)
    for s, table in enumerate(tables):
        pitch = table.stride(0) * table.element_size()
        out = torch.where(shard == s, local * pitch + table.data_ptr(), out)
    return out


def _merge_candidates(vals: List[torch.Tensor], gids: List[torch.Tensor],
                      k: int) -> torch.Tensor:
    """The global top-k of per-shard candidate lists, [Q, ≤k] gids.

    Ordered by (score desc, global id asc), the single corpus's
    tie-break: a stable sort by gid, then a stable descending sort by
    score (``np.lexsort((gids, -vals))``), keep the first k.
    """
    return _merge_scored(vals, gids, k)[1]


def _merge_scored(vals: List[torch.Tensor], gids: List[torch.Tensor],
                  k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`_merge_candidates` with the kept scores: ([Q, ≤k] scores,
    [Q, ≤k] i64 gids)."""
    v, g = torch.cat(vals, dim=1), torch.cat(gids, dim=1).long()
    g, order = torch.sort(g, dim=1, stable=True)
    v = v.gather(1, order)
    v, order = torch.sort(v, dim=1, descending=True, stable=True)
    return v[:, :k], g.gather(1, order)[:, :k]


def sharded_recommend_for_users(corpora: Sequence[torch.Tensor], user_ids,
                                k: int, alpha: float, topn: int,
                                n_shards: int,
                                metric: str = "euclidean") -> torch.Tensor:
    """Serving over per-shard corpora: top-n ids, i32[Q, topn].

    (1) the query rows are gathered from their owner shards; (2) each
    shard returns its top-k candidate ``(score, global id)`` lists
    (``shard_topk_candidates``); (3) the lists merge by (score desc, gid
    asc), the tie-break of a single corpus; (4) the k selected rows are
    blended: the kernel reads them where they lie in the shard corpora
    (``ops.blend_topn_rows_at``), the plain path fetches them, [Q, k,
    I] (``ops.blend_topn_rows``); both sum them in the same order.  All
    on the corpora's device.  Traffic between shards would be the [Q, k]
    lists and the selected rows, never a corpus.
    """
    dev = corpora[0].device
    uid = torch.as_tensor(np.asarray(user_ids, np.int64), device=dev)
    queries = _owner_rows(corpora, uid, n_shards)
    qids = uid.to(torch.int32)
    vals, gids = zip(*(shard_topk_candidates(queries, c, k, s, n_shards,
                                             query_ids=qids, metric=metric)
                       for s, c in enumerate(corpora)))
    sel = _merge_candidates(list(vals), list(gids), k)
    if ops.uses_kernel(corpora[0], None):
        return ops.blend_topn_rows_at(
            queries, _owner_row_addresses(corpora, sel, n_shards), corpora,
            alpha, topn)
    return ops.blend_topn_rows(queries, _owner_rows(corpora, sel, n_shards),
                               alpha, topn)


def sharded_recommend_for_users_quant(
        quant_corpora: Sequence[Tuple[torch.Tensor, torch.Tensor]], user_ids,
        k: int, alpha: float, topn: int, n_shards: int,
        bd: int = 512) -> torch.Tensor:
    """int8 serving over per-shard quantized corpora: i32[Q, topn].

    The pipeline of :func:`sharded_recommend_for_users` on ``(corpus_q
    int8[M_s, I], scale f32[M_s])`` pairs: D-tiled int8 candidates
    (``ops.shard_topk_quant``), the same merge, then the k selected int8
    rows and their scales blended, in place on the kernel path
    (``ops.blend_topn_rows_at``), fetched on the plain one
    (``ops.blend_topn_rows_quant``).  Row
    quantization is partition invariant, so every candidate score equals
    the single-corpus int8 score bit for bit.
    """
    corpora = [q for q, _ in quant_corpora]
    scales = [s for _, s in quant_corpora]
    dev = corpora[0].device
    uid = torch.as_tensor(np.asarray(user_ids, np.int64), device=dev)
    queries_q = _owner_rows(corpora, uid, n_shards)
    q_scale = _owner_rows(scales, uid, n_shards)
    qids = uid.to(torch.int32)
    vals, gids = zip(*(ops.shard_topk_quant(
        queries_q, q_scale, cq, cs, k, shard=s, n_shards=n_shards,
        query_gids=qids, bd=bd) for s, (cq, cs) in enumerate(quant_corpora)))
    sel = _merge_candidates(list(vals), list(gids), k)
    n_scale = _owner_rows(scales, sel, n_shards)
    if ops.uses_kernel(corpora[0], None):
        return ops.blend_topn_rows_at(
            queries_q, _owner_row_addresses(corpora, sel, n_shards), corpora,
            alpha, topn, q_scale=q_scale, n_scale=n_scale)
    return ops.blend_topn_rows_quant(
        queries_q, q_scale, _owner_rows(corpora, sel, n_shards), n_scale,
        alpha, topn)


def compare_recommendations(corpus: torch.Tensor, user_ids, ref_ids,
                            got_ids, k: int, alpha: float,
                            rtol: float = 1e-5,
                            metric: str = "euclidean") -> Dict[str, int]:
    """Hold ``got_ids`` against ``ref_ids`` (both [Q, n]) in float64.

    For each query the neighbour scores (−|q − c|² for euclidean, the
    serving path's ``metric`` otherwise) and the blended predictions are
    recomputed in float64 from ``corpus``.  A query is
    in the EXACT class when its k-th and (k+1)-th neighbour scores and
    its n-th and (n+1)-th predictions differ by more than ``rtol``
    relative: there both answers must hold identical ids.  Elsewhere the
    answers must be score-equivalent: the sorted float64 predictions of
    the two id lists agree within ``rtol``.  Returns counts ``{"exact",
    "equivalent", "mismatch", "close_neighbours", "close_items"}``:
    ``mismatch`` counts queries that meet neither rule, the last two
    why queries fell outside the exact class.  Runs on ``corpus``'s
    device.
    """
    c = corpus.to(torch.float64)
    dev = c.device
    uid, ref_t, got_t = (torch.as_tensor(np.array(x, np.int64), device=dev)
                         for x in (user_ids, ref_ids, got_ids))
    q = c[uid]
    scores = ref.pairwise_scores(q, c, metric)
    scores[torch.arange(uid.shape[0], device=dev), uid] = float("-inf")
    m, n = c.shape[0], ref_t.shape[1]
    k = max(1, min(k, m - 1))
    svals, sidx = torch.sort(scores, dim=1, descending=True, stable=True)
    sel = torch.zeros((uid.shape[0], m), dtype=torch.float64, device=dev)
    sel.scatter_(1, sidx[:, :k], 1.0)
    pred = alpha * q + (1.0 - alpha) * (sel @ c) / k
    pvals = torch.sort(pred, dim=1, descending=True).values[:, :n + 1]

    def close(a, b):
        return (a - b).abs() <= rtol * torch.maximum(a.abs(), b.abs())

    nbr_sep = (~close(svals[:, k - 1], svals[:, k]) if k < m - 1
               else torch.ones(uid.shape[0], dtype=torch.bool, device=dev))
    item_sep = ~close(pvals[:, n - 1], pvals[:, n])
    exact_class = nbr_sep & item_sep
    same = torch.all(ref_t == got_t, dim=1)
    pr, pg = pred.gather(1, ref_t), pred.gather(1, got_t)
    equiv = torch.all(close(torch.sort(pr, dim=1).values,
                            torch.sort(pg, dim=1).values), dim=1)
    exact = exact_class & same
    ok_else = ~exact_class & (same | equiv)
    return {"exact": int(exact.sum()), "equivalent": int(ok_else.sum()),
            "mismatch": int((~(exact | ok_else)).sum()),
            "close_neighbours": int((~nbr_sep).sum()),
            "close_items": int((~item_sep).sum())}


# ---------------------------------------------------------------------------
# Ranking metrics (numpy; evaluation only)
# ---------------------------------------------------------------------------

def recall_at_k(recommended: np.ndarray, truth: list, k: int) -> float:
    """Mean Recall@k over users. ``truth``: list of item-id arrays."""
    vals = []
    for recs, t in zip(np.asarray(recommended)[:, :k], truth):
        t = set(int(x) for x in np.asarray(t).ravel() if x >= 0)
        if not t:
            continue
        hit = len(t.intersection(int(r) for r in recs))
        vals.append(hit / len(t))
    return float(np.mean(vals)) if vals else 0.0


def ndcg_at_k(recommended: np.ndarray, truth: list, k: int) -> float:
    """Mean NDCG@k over users (binary relevance)."""
    vals = []
    discounts = 1.0 / np.log2(np.arange(2, k + 2))
    for recs, t in zip(np.asarray(recommended)[:, :k], truth):
        t = set(int(x) for x in np.asarray(t).ravel() if x >= 0)
        if not t:
            continue
        rel = np.array([1.0 if int(r) in t else 0.0 for r in recs])
        dcg = float(np.sum(rel * discounts[:len(rel)]))
        idcg = float(np.sum(discounts[:min(len(t), k)]))
        vals.append(dcg / idcg if idcg > 0 else 0.0)
    return float(np.mean(vals)) if vals else 0.0
