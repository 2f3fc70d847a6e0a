"""Personalised collaborative-filtering prediction and ranking metrics.

Prediction (paper §2.2): p = alpha · u_target + (1 − alpha) · mean of the
top-k neighbours.  ``recommend_for_users`` serves through
``kernels.ops.fused_recommend`` (the two CUDA serving kernels on the
card, the plain unfused pipeline on CPU).  Recall@K / NDCG@K follow
§6.1.  ``compare_recommendations`` holds two top-n answers against each
other where fp32 summation order can legitimately reorder near-ties.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.kernels import ops


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


def compare_recommendations(corpus: torch.Tensor, user_ids, ref_ids,
                            got_ids, k: int, alpha: float,
                            rtol: float = 1e-5) -> Dict[str, int]:
    """Hold ``got_ids`` against ``ref_ids`` (both [Q, n]) in float64.

    For each query the neighbour scores −|q − c|² and the blended
    predictions are recomputed in float64 from ``corpus``.  A query is
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
    cn = torch.sum(c * c, dim=1)
    scores = 2.0 * (q @ c.T) - torch.sum(q * q, dim=1, keepdim=True) \
        - cn[None, :]
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
