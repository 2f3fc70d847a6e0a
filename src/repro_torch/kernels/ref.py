"""Plain PyTorch versions of the port's kernels (the correctness contract).

``ops`` runs the function here for a tensor on the CPU,
``ops.default_impl("ref")`` selects them on any device, and the chip
smoke test holds every kernel against them on the card.  Top-k and
top-n break ties toward the LOWEST index, as ``lax.top_k`` does: a
stable descending sort, then a slice (``torch.topk`` does not promise
that order).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def topk_lowest_index(x: torch.Tensor, k: int) -> Tuple[torch.Tensor,
                                                         torch.Tensor]:
    """Top-k along the last dim, ties broken toward the lowest index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def sparse_row_gather_ref(table: torch.Tensor, rows: torch.Tensor,
                          ids: torch.Tensor) -> torch.Tensor:
    """out[r, w] = table[rows[r], ids[r, w]]; ids outside [0, I) read 0.

    table f32[M, I], rows i[U] (clamped to [0, M)), ids i[U, W]."""
    m, n_items = table.shape
    valid = (ids >= 0) & (ids < n_items)
    safe_rows = rows.long().clamp(0, m - 1)
    safe_ids = torch.where(valid, ids, torch.zeros_like(ids)).long()
    vals = table[safe_rows[:, None], safe_ids]
    return torch.where(valid, vals, torch.zeros_like(vals))


def sparse_row_scatter_ref(table: torch.Tensor, rows: torch.Tensor,
                           ids: torch.Tensor,
                           vals: torch.Tensor) -> torch.Tensor:
    """table[rows[r], ids[r, w]] += vals[r, w], IN PLACE; returns table.

    ids outside [0, I) are skipped, rows clamp to [0, M); duplicate
    (row, id) pairs accumulate."""
    m, n_items = table.shape
    valid = (ids >= 0) & (ids < n_items)
    safe_rows = rows.long().clamp(0, m - 1)[:, None].expand_as(ids)
    safe_ids = torch.where(valid, ids, torch.zeros_like(ids)).long()
    v = torch.where(valid, vals, torch.zeros_like(vals))
    table.index_put_((safe_rows, safe_ids), v, accumulate=True)
    return table


def corpus_sqnorm(corpus: torch.Tensor) -> torch.Tensor:
    """|c|² per corpus row, f32[M]."""
    return torch.sum(corpus * corpus, dim=-1)


def knn_topk_ref(queries: torch.Tensor, corpus: torch.Tensor, k: int,
                 metric: str = "euclidean",
                 query_gids: Optional[torch.Tensor] = None,
                 col_offset: int = 0, col_stride: int = 1
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage A: per-query top-k (scores, rows) over the corpus.

    euclidean scores are the monotone surrogate 2q·c − |c|²; dot scores
    are q·c.  The column whose global id ``row·col_stride + col_offset``
    equals ``query_gids[q]`` scores −inf (self-exclusion).
    """
    scores = queries @ corpus.T
    if metric == "euclidean":
        scores = 2.0 * scores - corpus_sqnorm(corpus)[None, :]
    elif metric != "dot":
        raise ValueError(metric)
    if query_gids is not None:
        col_gid = (torch.arange(corpus.shape[0], device=corpus.device)
                   * col_stride + col_offset)
        scores = torch.where(col_gid[None, :] == query_gids[:, None].long(),
                             torch.full_like(scores, float("-inf")), scores)
    vals, idx = topk_lowest_index(scores, k)
    return vals, idx.to(torch.int32)


def blend_topn_ref(corpus: torch.Tensor, user_ids: torch.Tensor,
                   nbr_idx: torch.Tensor, alpha: float,
                   topn: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage B: pred = α·C[uid] + (1−α)·(Σ_j C[idx_j])/k, then top-n.

    Neighbour (and user) rows outside [0, M) add 0; a −1 neighbour still
    counts in k.  Returns (f32[Q, n], i32[Q, n])."""
    m = corpus.shape[0]
    k = nbr_idx.shape[1]
    nvalid = (nbr_idx >= 0) & (nbr_idx < m)
    nrows = torch.where(nvalid, nbr_idx, torch.zeros_like(nbr_idx)).long()
    nbr_sum = torch.sum(corpus[nrows] * nvalid[..., None], dim=1)
    uvalid = (user_ids >= 0) & (user_ids < m)
    urows = torch.where(uvalid, user_ids, torch.zeros_like(user_ids)).long()
    own = corpus[urows] * uvalid[:, None]
    pred = alpha * own + (1.0 - alpha) * nbr_sum / k
    vals, idx = topk_lowest_index(pred, topn)
    return vals, idx.to(torch.int32)


def pairwise_scores(queries: torch.Tensor, corpus: torch.Tensor,
                    metric: str) -> torch.Tensor:
    """Similarity scores (higher = closer), [Q, I] × [M, I] → [Q, M]."""
    if metric == "euclidean":
        qc = queries @ corpus.T
        qn = torch.sum(queries * queries, dim=-1, keepdim=True)
        cn = torch.sum(corpus * corpus, dim=-1)[None, :]
        return 2.0 * qc - qn - cn
    if metric == "cosine":
        qn = queries / torch.clamp(
            torch.linalg.norm(queries, dim=-1, keepdim=True), min=1e-12)
        cn = corpus / torch.clamp(
            torch.linalg.norm(corpus, dim=-1, keepdim=True), min=1e-12)
        return qn @ cn.T
    if metric == "dot":
        return queries @ corpus.T
    raise ValueError(f"unknown metric {metric}")


def fused_recommend_ref(corpus: torch.Tensor, user_ids: torch.Tensor,
                        k: int, alpha: float, topn: int,
                        metric: str = "euclidean") -> torch.Tensor:
    """The unfused serving pipeline, in the JAX reference's operation
    order: row gather, full scores with self exclusion, [Q, k, I]
    neighbour gather + mean, α blend, top-n.  Returns i32[Q, topn]."""
    uid = user_ids.long()
    queries = corpus[uid]
    scores = pairwise_scores(queries, corpus, metric)
    scores[torch.arange(queries.shape[0], device=corpus.device), uid] = \
        float("-inf")
    _, idx = topk_lowest_index(scores, k)
    neighbors = torch.mean(corpus[idx], dim=1)
    pred = alpha * queries + (1.0 - alpha) * neighbors
    return topk_lowest_index(pred, topn)[1].to(torch.int32)
