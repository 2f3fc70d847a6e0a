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


# the most cells one sort of :func:`merge_topk` takes: the sort's values,
# int64 positions and scratch stay a few GB
MERGE_CELLS = 1 << 27

# the most f32 scores :func:`flash_attention_ref` holds at once (1 GiB):
# deepseek's 128 heads over a 4,096-token prompt take 512 query rows
SCORES_BUDGET = 1 << 28


def merge_topk(vals: torch.Tensor, idx: torch.Tensor, scores: torch.Tensor,
               cols: torch.Tensor, k: int) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """One step of a running top-k: the list (``vals``, ``idx``) [Q, k]
    and a block's ``scores`` [Q, C] at columns ``cols`` [C] → the first
    k of [list, block] by a stable descending sort (the list's entries
    first on ties, as ``lax.top_k`` over the concatenation).  Rows are
    independent, so more than ``MERGE_CELLS`` cells sort in row blocks."""
    rows = max(1, MERGE_CELLS // (vals.shape[1] + scores.shape[1]))
    if vals.shape[0] > rows:
        parts = [merge_topk(vals[r:r + rows], idx[r:r + rows],
                            scores[r:r + rows], cols, k)
                 for r in range(0, vals.shape[0], rows)]
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]))
    mv = torch.cat([vals, scores], dim=1)
    mi = torch.cat([idx, cols.to(idx.dtype).expand(scores.shape[0], -1)],
                   dim=1)
    tv, pos = topk_lowest_index(mv, k)
    return tv, mi.gather(1, pos)


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


def sparse_row_scatter_ordered_ref(table: torch.Tensor, rows: torch.Tensor,
                                   ids: torch.Tensor,
                                   vals: torch.Tensor) -> torch.Tensor:
    """:func:`sparse_row_scatter_ref` as a sequential scatter-add: each
    cell's deltas added one at a time in entry order (r, w), IN PLACE on
    a contiguous ``table``; returns table.

    The valid entries' cell keys ``row·I + id`` are sorted stably, and
    pass q adds the q-th delta of every cell by one non-accumulating
    indexed update (the keys of one pass are distinct).  The order of
    additions, and so every bit, is that of the CUDA kernel.
    """
    m, n_items = table.shape
    valid = ((ids >= 0) & (ids < n_items)).reshape(-1)
    keys = (rows.long().clamp(0, m - 1)[:, None] * n_items
            + ids.long()).reshape(-1)[valid]
    keys, order = torch.sort(keys, stable=True)
    v = vals.reshape(-1)[valid][order]
    pos = torch.arange(keys.numel(), device=keys.device)
    head = torch.ones_like(keys, dtype=torch.bool)
    head[1:] = keys[1:] != keys[:-1]
    rank = pos - torch.cummax(torch.where(head, pos, 0), 0).values
    flat = table.view(-1)
    for q in range(int(rank.max()) + 1 if keys.numel() else 0):
        at = rank == q
        flat[keys[at]] = flat[keys[at]] + v[at]
    return table


def corpus_sqnorm(corpus: torch.Tensor) -> torch.Tensor:
    """|c|² per corpus row, f32[M]."""
    return torch.sum(corpus * corpus, dim=-1)


def _exclude_self(scores: torch.Tensor, query_gids: Optional[torch.Tensor],
                  col_offset: int, col_stride: int) -> torch.Tensor:
    """−inf where column ``row·col_stride + col_offset`` is the query's
    global id."""
    if query_gids is None:
        return scores
    col_gid = (torch.arange(scores.shape[1], device=scores.device)
               * col_stride + col_offset)
    return torch.where(col_gid[None, :] == query_gids[:, None].long(),
                       torch.full_like(scores, float("-inf")), scores)


def knn_topk_ref(queries: torch.Tensor, corpus: torch.Tensor, k: int,
                 metric: str = "euclidean",
                 query_gids: Optional[torch.Tensor] = None,
                 col_offset: int = 0, col_stride: int = 1,
                 sub_qnorm: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage A: per-query top-k (scores, rows) over the corpus.

    euclidean scores are the monotone surrogate 2q·c − |c|² (with
    ``sub_qnorm`` then minus |q|²: the full −|q−c|² the cross-shard
    merge compares); dot scores are q·c.  The column whose global id
    ``row·col_stride + col_offset`` equals ``query_gids[q]`` scores −inf
    (self-exclusion).
    """
    scores = queries @ corpus.T
    if metric == "euclidean":
        scores = 2.0 * scores - corpus_sqnorm(corpus)[None, :]
        if sub_qnorm:
            scores = scores - corpus_sqnorm(queries)[:, None]
    elif metric != "dot":
        raise ValueError(metric)
    scores = _exclude_self(scores, query_gids, col_offset, col_stride)
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


def blend_passes(nbr_idx: torch.Tensor, m: int, group: int,
                 stage_rows: int) -> torch.Tensor:
    """The staging pass of each neighbour entry, i64[Q, k]: queries in
    groups of ``group``, a group's distinct rows in [0, M) in ascending
    order, ``stage_rows`` of them a pass (entries outside [0, M): 0)."""
    nb = nbr_idx.long()
    valid = (nb >= 0) & (nb < m)
    passes = torch.zeros_like(nb)
    for g0 in range(0, nb.shape[0], group):
        blk, ok = nb[g0:g0 + group], valid[g0:g0 + group]
        _, rank = torch.unique(blk[ok], sorted=True, return_inverse=True)
        passes[g0:g0 + group][ok] = rank // stage_rows
    return passes


def blend_topn_ordered_ref(corpus: torch.Tensor, user_ids: torch.Tensor,
                           nbr_idx: torch.Tensor, alpha: float, topn: int,
                           passes: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`blend_topn_ref` with each query's valid neighbour rows added
    one at a time in order j = 0..k-1 and divided by a tensor of k (not
    a scalar, which CUDA turns into a multiply by 1/k): the CUDA
    kernel's arithmetic, so bitwise its answer where every group fits
    one staging pass.  ``passes`` (:func:`blend_passes`) sums each pass
    in order j and adds the passes in order, as the kernel does where a
    group's rows overflow its staging area."""
    m, n_items = corpus.shape
    q_n, k = nbr_idx.shape
    nb = nbr_idx.long()
    valid = (nb >= 0) & (nb < m)
    safe = torch.where(valid, nb, torch.zeros_like(nb))
    if passes is None:
        passes = torch.zeros_like(nb)
    n_pass = int(passes[valid].max()) + 1 if bool(valid.any()) else 0
    total = torch.zeros((q_n, n_items), dtype=corpus.dtype,
                        device=corpus.device)
    for p in range(n_pass):
        acc = torch.zeros_like(total)
        for j in range(k):
            take = (valid[:, j] & (passes[:, j] == p))[:, None]
            acc = torch.where(take, acc + corpus[safe[:, j]], acc)
        total = total + acc
    uvalid = (user_ids >= 0) & (user_ids < m)
    urows = torch.where(uvalid, user_ids, torch.zeros_like(user_ids)).long()
    own = torch.where(uvalid[:, None], corpus[urows],
                      torch.zeros((), dtype=corpus.dtype,
                                  device=corpus.device))
    pred = alpha * own + ((1.0 - alpha) * total) / torch.full_like(total, k)
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


def shard_topk_ref(queries: torch.Tensor, corpus: torch.Tensor, k: int,
                   shard: int, n_shards: int,
                   query_gids: Optional[torch.Tensor] = None,
                   metric: str = "euclidean"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-shard candidates: ``([Q, k'] scores, global ids)``, k' =
    min(k, M_s).

    One shard's local corpus scored in full (``pairwise_scores``: the
    full −|q−c|² for euclidean); local row r is global user
    ``r·n_shards + shard``, and self-exclusion compares those global ids.
    """
    m_s = corpus.shape[0]
    scores = _exclude_self(pairwise_scores(queries, corpus, metric),
                           query_gids, shard, n_shards)
    vals, idx = topk_lowest_index(scores, min(k, m_s))
    return vals, (idx * n_shards + shard).to(torch.int32)


def blend_topn_rows_ref(queries: torch.Tensor, neighbor_rows: torch.Tensor,
                        alpha: float, topn: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage B over fetched rows: pred = α·q + (1−α)·mean_j(rows_j), then
    top-n.  queries f32[Q, I], neighbor_rows f32[Q, k, I] → (f32[Q, n],
    i32[Q, n])."""
    neighbors = torch.mean(neighbor_rows, dim=1)
    pred = alpha * queries + (1.0 - alpha) * neighbors
    vals, idx = topk_lowest_index(pred, topn)
    return vals, idx.to(torch.int32)


def blend_topn_rows_quant_ref(queries_q: torch.Tensor, q_scale: torch.Tensor,
                              neighbor_rows_q: torch.Tensor,
                              n_scale: torch.Tensor, alpha: float,
                              topn: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 stage B: dequantize (exact f32 multiplies by the power-of-two
    scales) the query rows int8[Q, I] × ``q_scale`` f32[Q] and the
    neighbour rows int8[Q, k, I] × ``n_scale`` f32[Q, k], then
    :func:`blend_topn_rows_ref`."""
    queries = queries_q.to(torch.float32) * q_scale[:, None]
    nbr = neighbor_rows_q.to(torch.float32) * n_scale[:, :, None]
    return blend_topn_rows_ref(queries, nbr, alpha, topn)


# rows of an int8 corpus widened to int32 at a time (64 Mi elements)
_SQNORM_CHUNK = 1 << 26


def tiled_sqnorm_ref(x: torch.Tensor, bd: int) -> torch.Tensor:
    """Per-row |x|², f32[M], summed per D tile of width ``bd`` and
    across tiles in tile order, tile 0 first.

    int8 rows sum each tile exactly in int32 (bd <= 1024 keeps a tile's
    sum below 2^24, so its f32 convert is exact); f32 rows sum each tile
    in f32.  Rows are widened a chunk at a time, so the temporary stays
    at most 256 MB whatever the corpus size.
    """
    m, d = x.shape
    bd = max(1, min(bd, d))
    nt = -(-d // bd)
    per_tile = torch.empty((m, nt), dtype=torch.float32, device=x.device)
    rows = max(1, _SQNORM_CHUNK // max(1, nt * bd))
    for r0 in range(0, m, rows):
        xt = torch.nn.functional.pad(x[r0:r0 + rows], (0, nt * bd - d))
        xt = xt.reshape(-1, nt, bd)
        if x.dtype == torch.int8:
            xi = xt.to(torch.int32)
            per_tile[r0:r0 + rows] = torch.sum(xi * xi, dim=-1).to(
                torch.float32)
        else:
            xf = xt.to(torch.float32)
            per_tile[r0:r0 + rows] = torch.sum(xf * xf, dim=-1)
    acc = torch.zeros((m,), dtype=torch.float32, device=x.device)
    for t in range(nt):
        acc = acc + per_tile[:, t]
    return acc


def dtiled_topk_ref(queries: torch.Tensor, corpus: torch.Tensor, k: int,
                    bd: int = 512,
                    query_gids: Optional[torch.Tensor] = None,
                    col_offset: int = 0, col_stride: int = 1,
                    sub_qnorm: bool = False,
                    q_scale: Optional[torch.Tensor] = None,
                    c_scale: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """D-tiled stage A: top-k (scores, rows) with the q·c contraction
    summed per D tile of width ``bd`` and across tiles in tile order.

    int8 ``queries``/``corpus`` take their power-of-two row scales
    ``q_scale`` f32[Q] / ``c_scale`` f32[M]; the score is
    ``2·(s_q·s_c)·acc − (s_c·s_c)·|c|²`` (then ``− (s_q·s_q)·|q|²``
    under ``sub_qnorm``), the expression tree of the JAX reference and
    of the kernel: every product is exact, so each score rounds once.

    The int8 per-tile partial is an fp32 product of the int8 values cast
    to float.  Every partial sum in it is an integer of magnitude at
    most bd·127² = 16,516,096 < 2^24 (bd <= 1024), so the product is
    exact in any summation order: it equals the exact int32 partial on
    any device, and PyTorch has no int32 matrix product on CUDA.  (Run
    it with TF32 off, as every caller here does; TF32 holds |v| <= 127
    exactly too.)  The cross-tile sum is an f32 sum in tile order, tile
    0 first, as the JAX reference's ``lax.scan`` takes it.  Requires
    ``k <= M``.
    """
    q_n, d = queries.shape
    m = corpus.shape[0]
    quantized = corpus.dtype == torch.int8
    bd = max(1, min(bd, d))
    cn = tiled_sqnorm_ref(corpus, bd)
    acc = torch.zeros((q_n, m), dtype=torch.float32, device=corpus.device)
    for d0 in range(0, d, bd):
        q, c = queries[:, d0:d0 + bd], corpus[:, d0:d0 + bd]
        if quantized:
            q, c = q.to(torch.float32), c.to(torch.float32)
        acc = acc + q @ c.T
    if q_scale is None:
        q_scale = torch.ones((q_n,), dtype=torch.float32,
                             device=corpus.device)
        c_scale = torch.ones((m,), dtype=torch.float32, device=corpus.device)
    scores = (2.0 * (q_scale[:, None] * c_scale[None, :]) * acc
              - (c_scale * c_scale)[None, :] * cn[None, :])
    if sub_qnorm:
        qnorm = tiled_sqnorm_ref(queries, bd)
        scores = scores - (q_scale * q_scale * qnorm)[:, None]
    scores = _exclude_self(scores, query_gids, col_offset, col_stride)
    vals, idx = topk_lowest_index(scores, k)
    return vals, idx.to(torch.int32)


def fused_recommend_dtiled_ref(corpus: torch.Tensor, user_ids: torch.Tensor,
                               k: int, alpha: float, topn: int,
                               bd: int) -> torch.Tensor:
    """The fp32 serving pipeline with a D-tiled stage A: user rows,
    ``dtiled_topk_ref`` with self-exclusion, the [Q, k, I] neighbour
    gather, ``blend_topn_rows_ref``.  Returns i32[Q, topn]."""
    queries = corpus[user_ids.long()]
    _, idx = dtiled_topk_ref(queries, corpus, k, bd=bd,
                             query_gids=user_ids)
    return blend_topn_rows_ref(queries, corpus[idx.long()], alpha, topn)[1]


def fused_recommend_quant_ref(corpus_q: torch.Tensor, c_scale: torch.Tensor,
                              user_ids: torch.Tensor, k: int, alpha: float,
                              topn: int, bd: int = 512) -> torch.Tensor:
    """The int8 serving pipeline: the query is the user's quantized
    corpus row (q_scale = c_scale[user]); D-tiled int8 stage A with
    self-exclusion; the k selected int8 rows gathered and blended
    dequantized.  Requires k <= M − 1.  Returns i32[Q, topn]."""
    uid = user_ids.long()
    queries_q, q_scale = corpus_q[uid], c_scale[uid]
    _, idx = dtiled_topk_ref(queries_q, corpus_q, k, bd=bd,
                             query_gids=user_ids, q_scale=q_scale,
                             c_scale=c_scale)
    idx = idx.long()
    return blend_topn_rows_quant_ref(queries_q, q_scale, corpus_q[idx],
                                     c_scale[idx], alpha, topn)[1]


def decayed_scatter_ref(ids: torch.Tensor, weights: torch.Tensor,
                        n_items: int) -> torch.Tensor:
    """Weighted multi-hot scatter: out[i] = Σ_{n,b} w[n]·[ids[n, b] == i].

    ``ids`` int[N, B] with ``weights`` f32[N] → f32[n_items], or batched
    ``ids`` int[U, N, B] with ``weights`` f32[U, N] → f32[U, n_items].
    Ids outside [0, n_items) (PAD = −1) add nothing.  The Eq. 1+2
    from-scratch user vector, and the EmbeddingBag transpose.
    """
    single = ids.dim() == 2
    if single:
        ids, weights = ids[None], weights[None]
    u, n, b = ids.shape
    flat = ids.reshape(u, n * b).long()
    w = weights.to(torch.float32).repeat_interleave(b, dim=1)
    valid = (flat >= 0) & (flat < n_items)
    rows = torch.arange(u, device=ids.device)[:, None].expand_as(flat)
    out = torch.zeros((u, n_items), dtype=torch.float32, device=ids.device)
    out.index_put_((rows[valid], flat[valid]), w[valid], accumulate=True)
    return out[0] if single else out


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Plain masked softmax attention, [B, S, H, D] → [B, S, H, Dv].

    ``k`` [B, S, KV, D] and ``v`` [B, S, KV, Dv] carry KV heads with
    H % KV == 0 (query head h reads KV head h // (H/KV)); V's width may
    differ from D, as in the JAX oracle.  Scores in f32 times ``scale``
    (default 1/√D), the causal mask ``kpos <= qpos`` and with ``window``
    > 0 also ``kpos > qpos − window``, masked scores −1e30; the softmax
    is cast to the V dtype before P·V, as the JAX oracle does.  One batch
    row and at most ``SCORES_BUDGET`` scores at a time (a long prompt of
    many heads is taken in chunks of query rows), so the scores stay a
    bounded intermediate.
    """
    b, s, h, d = q.shape
    sk, kv, dv = k.shape[1], k.shape[2], v.shape[3]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((s, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    rows = max(1, SCORES_BUDGET // (h * sk))
    out = torch.empty((b, s, h, dv), dtype=v.dtype, device=q.device)
    for i in range(b):
        ki, vi = k[i].float(), v[i].float()
        for r0 in range(0, s, rows):
            r1 = min(s, r0 + rows)
            qg = q[i, r0:r1].float().reshape(r1 - r0, kv, h // kv, d)
            scores = torch.einsum("qkgd,skd->kgqs", qg, ki).mul_(scale)
            scores.masked_fill_(~mask[r0:r1], -1e30)
            p = torch.softmax(scores, dim=-1).to(v.dtype)
            del scores
            o = torch.einsum("kgqs,skd->qkgd", p.float(), vi)
            out[i, r0:r1] = o.reshape(r1 - r0, h, dv)
    return out
