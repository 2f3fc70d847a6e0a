"""Personalised collaborative-filtering prediction and ranking metrics.

Prediction (paper §2.2): p = alpha · u_target + (1 − alpha) · mean of the
top-k neighbours.  ``recommend_for_users`` serves through
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

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops, ref


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
    v, g = torch.cat(vals, dim=1), torch.cat(gids, dim=1).long()
    g, order = torch.sort(g, dim=1, stable=True)
    v = v.gather(1, order)
    _, order = torch.sort(v, dim=1, descending=True, stable=True)
    return g.gather(1, order)[:, :k]


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
    if ops.uses_kernel(corpora[0]):
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
    if ops.uses_kernel(corpora[0]):
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
