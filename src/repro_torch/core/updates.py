"""Batched incremental/decremental updates on the scaled StreamState.

Kind-partitioned sub-batches, one update rule per entry point:

  * ``apply_add_batch``        — Eq. 7-9 as sparse deltas: O(batch·W)
    state traffic (W = (group_size+1)·max_basket_size), never an
    [n_items] temporary; the whole-vector rescales live in the per-user
    scales.
  * ``apply_del_basket_batch`` — Eq. 10-12, the suffix contractions
    expanded to per-history-slot coefficients: O(batch·N·B) traffic.
  * ``apply_del_item_batch``   — Eq. 13 in place (one cell per table)
    with the basket-vanish fallback through the Eq. 10-12 core.

Every vector-table read and write of these goes through ``kernels.ops``
(``sparse_row_gather`` / ``sparse_row_scatter``).  ``apply_update_batch``
takes a mixed ``UpdateBatch`` and partitions it on the host into the
three.  The paper's per-user rules (``_add_basket``, ``_delete_basket``,
``_delete_item``, ``_single_update``: Algorithm 1 generalised to four
event kinds) run on dense ``[U, n_items]`` rows, one row per user, and
carry the dense baselines: ``apply_update_batch_dense`` (every rule on
every row, then a select per row: ~4x redundant work, O(batch·n_items)
traffic) and ``apply_del_basket_batch_dense`` /
``apply_del_item_batch_dense``.  The dense baselines are plain PyTorch,
as their JAX versions reach no Pallas kernel.

The appliers update the state's tensors IN PLACE and return the same
state.  Padding rows of a sub-batch (and noop rows of an
``UpdateBatch``) carry user 0 and so alias a valid row of user 0: every
write is an accumulating delta — ``index_put_(accumulate=True)`` for
sums, a product scatter with factor 1 for the scales — never a plain
indexed assignment, whose duplicate writes would race.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import decay
from repro_torch.core.decay import f32, fpow
from repro_torch.core.tifu import (last_group_vector_padded,
                                   row_group_geometry, user_vector_padded)
from repro_torch.core.tifu import weighted_multihot_scatter
from repro_torch.core.types import (KIND_ADD_BASKET, KIND_DEL_BASKET,
                                    KIND_DEL_ITEM, KIND_NOOP, PAD_ID,
                                    AddBatch, DelBasketBatch, DelItemBatch,
                                    StreamState, TifuParams, UpdateBatch)
from repro_torch.kernels.ops import sparse_row_gather, sparse_row_scatter

# Adds only shrink the scales; sparse Eq. 12 deletions grow uv_scale by
# k/((k-1)·r_g) > 1.  The engine folds the scales back into the raw rows
# (renormalize_users) well before either bound.
SCALE_FLOOR = 1e-18
SCALE_CEIL = 1e18


def _add_(t: torch.Tensor, index: Tuple[torch.Tensor, ...],
          delta: torch.Tensor) -> None:
    """``t[index] += delta`` in place, duplicates accumulating."""
    t.index_put_(index, delta.to(t.dtype), accumulate=True)


def _mul_(t: torch.Tensor, rows: torch.Tensor, ratio: torch.Tensor) -> None:
    """``t[rows] *= ratio`` in place, every duplicate multiplied in."""
    t.scatter_reduce_(0, rows, ratio.to(t.dtype), reduce="prod")


# ---------------------------------------------------------------------------
# Helpers on padded per-user state
# ---------------------------------------------------------------------------

def _locate(sizes: torch.Tensor, pos: torch.Tensor):
    """Locate global basket index ``pos`` i[U] in the group structure.

    Returns group index j (0-based) and in-group position i (1-based).
    """
    sizes = sizes.long()
    ends = torch.cumsum(sizes, dim=1)
    starts = ends - sizes
    j = torch.searchsorted(ends, pos.long()[:, None].contiguous(),
                           right=True).clamp(0, sizes.shape[1] - 1)
    return j[:, 0], pos.long() - starts.gather(1, j)[:, 0] + 1


def _remove_entry(sizes: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """Remove entry j[u] of each padded row (shift left, zero-fill)."""
    n = sizes.shape[1]
    t = torch.arange(n, device=sizes.device)[None, :]
    src = torch.where(t >= j[:, None], (t + 1).clamp(max=n - 1), t)
    out = sizes.gather(1, src)
    out[:, n - 1] = torch.where(j <= n - 1, torch.zeros_like(out[:, n - 1]),
                                out[:, n - 1])
    return out


def _capacity_mask(nb, k, tau, max_baskets: int, max_groups: int,
                   group_size: int):
    """Adds that would overflow the padded history/group arrays.

    The single source of truth for the add path's no-op guard and the
    engine's dropped_adds metric.
    """
    new_group = (k == 0) | (tau >= group_size)
    return (nb >= max_baskets) | (new_group & (k >= max_groups))


def _first_occurrence(ids: torch.Tensor) -> torch.Tensor:
    """Pick one representative slot per distinct non-PAD id per row.

    Returns bool[U, W], True on the lowest slot of each distinct id (the
    first in a stable sort).
    """
    u, w = ids.shape
    sorted_ids, order = torch.sort(ids, dim=1, stable=True)
    first_sorted = torch.cat(
        [torch.ones((u, 1), dtype=torch.bool, device=ids.device),
         sorted_ids[:, 1:] != sorted_ids[:, :-1]], dim=1)
    first = torch.zeros((u, w), dtype=torch.bool, device=ids.device)
    first.scatter_(1, order, first_sorted)
    return (ids >= 0) & first


def _where0(cond: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.where(cond, x, torch.zeros_like(x))


def _on_cols(ids: torch.Tensor, cols: Optional[Tuple[int, int]]
             ) -> torch.Tensor:
    """Support ids as columns of vector tables that hold the items
    ``[i0, i1)`` of ``cols`` (a rank's item block under a mesh): ``id −
    i0`` inside the block, PAD outside it; ``cols=None``, tables of
    every item: ``ids`` as they are."""
    if cols is None:
        return ids
    i0, i1 = cols
    return torch.where((ids >= i0) & (ids < i1), ids - i0,
                       torch.full_like(ids, PAD_ID))


def on_user_block(batch, u0: int, u1: int):
    """``batch`` (an ``AddBatch``, ``DelBasketBatch`` or ``DelItemBatch``
    of global user ids) as the sub-batch of a state that holds the users
    ``[u0, u1)`` (a rank's block under a mesh): each row of such a user
    with its local row ``user − u0``, every other row a padding row
    (``valid`` False, user 0), which the appliers leave without effect.
    The rows keep their order and everything else of the batch."""
    own = (batch.user >= u0) & (batch.user < u1)
    return dataclasses.replace(
        batch, user=torch.where(own, batch.user - u0,
                                torch.zeros_like(batch.user)),
        valid=batch.valid & own)


# ---------------------------------------------------------------------------
# The paper's per-user rules, batched over rows (one row per user)
# ---------------------------------------------------------------------------
#
# Each rule takes the true (unscaled) per-user state as [U, ...] tensors
# — user_vec f32[U, I], last_group_vec f32[U, I], history i[U, N, B],
# group_sizes i[U, K], n_baskets i[U], n_groups i[U], err_mult f32[U] —
# and returns the updated seven, integer leaves in their own dtype.  As
# in the JAX package every scenario of a rule is computed on every row
# and one is picked per row with ``torch.where``: the branches not picked
# hold r^(tau-p) of rows outside a group and divisions of empty
# histories, which a product with a mask would leak as inf or NaN.
# Indexing follows JAX's: a read past the end of a padded axis reads its
# last entry, a write past it is dropped (an add to a full history).

def _per_row(cond: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """cond[U] shaped to broadcast over x[U, ...]."""
    return cond.reshape(cond.shape + (1,) * (x.dim() - 1))


def _pick(cond: torch.Tensor, a: torch.Tensor,
          b: torch.Tensor) -> torch.Tensor:
    """Per row: ``a`` where ``cond`` else ``b``."""
    return torch.where(_per_row(cond, a), a, b)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[u, idx[u]] of x[U, K], the index clamped into [0, K)."""
    return x.gather(1, idx.clamp(0, x.shape[1] - 1)[:, None])[:, 0]


def _set_row(x: torch.Tensor, idx: torch.Tensor,
             val: torch.Tensor) -> torch.Tensor:
    """A copy of x[U, K, ...] with entry idx[u] of row u set to val[u];
    an index past K is dropped."""
    r = torch.arange(x.shape[0], device=x.device)
    safe = idx.clamp(0, x.shape[1] - 1)
    out = x.clone()
    cur = out[r, safe]
    out[r, safe] = torch.where(_per_row(idx < x.shape[1], cur),
                               val.to(x.dtype), cur)
    return out


def _add_row(x: torch.Tensor, idx: torch.Tensor, val) -> torch.Tensor:
    """A copy of x[U, K] with ``val`` added at entry idx[u] of row u; an
    index past K is dropped."""
    return _set_row(x, idx, _take(x, idx) + val)


def _multi_hot(items: torch.Tensor, n_items: int) -> torch.Tensor:
    """Multi-hot rows of baskets: i[U, B] (PAD_ID padded) → f32[U, I].

    Set semantics (a duplicate id counts once), as ``tifu.multi_hot``
    and the sparse add path's first-occurrence dedup.
    """
    valid = items >= 0
    ids = torch.where(valid, items, torch.zeros_like(items)).long()
    out = torch.zeros((items.shape[0], n_items), dtype=torch.float32,
                      device=items.device)
    return out.scatter_reduce_(1, ids, valid.to(torch.float32),
                               reduce="amax")


def _add_basket(user_vec, last_group_vec, history, group_sizes, n_baskets,
                n_groups, err_mult, items, params: TifuParams):
    """Eq. 7 (a new single-basket group) or Eq. 8+9 (append to the last
    group) for each row's basket ``items`` i[U, B].

    No capacity check, as in the JAX package: an add to a full history
    overwrites its last row and still counts a basket.
    """
    n_items = user_vec.shape[1]
    n_bask, kmax = history.shape[1], group_sizes.shape[1]
    v_b = _multi_hot(items, n_items)
    k = n_groups.long()
    tau = torch.where(k > 0, _take(group_sizes, (k - 1).clamp(min=0)).long(),
                      torch.zeros_like(k))
    new_group = (k == 0) | (tau >= params.group_size)
    kf = k.to(torch.float32)
    kc = kf[:, None]

    # Scenario 1 (Eq. 7): a new single-basket group
    user_a = (kc * params.r_g * user_vec + v_b) / (kc + 1)
    sizes_a = _set_row(group_sizes, k.clamp(max=kmax - 1),
                       torch.ones_like(k))
    err_a = torch.clamp(err_mult * torch.where(
        k > 0, decay.error_shrink_factor(kf, params.r_g),
        torch.zeros_like(kf)), min=1e-30)

    # Scenario 2 (Eq. 8 + Eq. 9): append to the last group
    safe_tau = tau.clamp(min=1).to(torch.float32)[:, None]
    lgv_b = (safe_tau * params.r_b * last_group_vec + v_b) / (safe_tau + 1)
    user_b = user_vec + (lgv_b - last_group_vec) / kf.clamp(min=1)[:, None]
    sizes_b = _add_row(group_sizes, (k - 1).clamp(min=0), 1)

    history = _set_row(history, n_baskets.long().clamp(max=n_bask - 1),
                       items)
    return (_pick(new_group, user_a, user_b),
            _pick(new_group, v_b, lgv_b),
            history,
            _pick(new_group, sizes_a, sizes_b),
            n_baskets + 1,
            n_groups + new_group.to(n_groups.dtype),
            torch.where(new_group, err_a, err_mult))


def _delete_basket(user_vec, last_group_vec, history, group_sizes,
                   n_baskets, n_groups, err_mult, pos, params: TifuParams):
    """Eq. 10-12 for each row's basket at global index ``pos`` i[U].

    Scenario 1 (the basket's group keeps others: Eq. 10 + 11), scenario
    2 (its group vanishes, k > 1: Eq. 12) and scenario 3 (the last basket
    goes: the state empties); then the history shifts up one row from
    ``pos`` with a PAD row refilled at the end, and the last-group
    vector is recomputed from the new geometry.
    """
    dev = user_vec.device
    n_items = user_vec.shape[1]
    n_bask = history.shape[1]
    kmax = group_sizes.shape[1]
    rb = f32(params.r_b, dev)
    rg = f32(params.r_g, dev)
    k = n_groups.long()
    nb = n_baskets.long()
    pos = pos.long()
    j, i = _locate(group_sizes, pos)
    tau_j = _take(group_sizes, j).long()
    g, p, tau, _ = row_group_geometry(group_sizes, n_bask)
    t = torch.arange(n_bask, device=dev)[None, :]
    valid_row = t < nb[:, None]
    in_group_j = valid_row & (g == j[:, None])
    kf = k.clamp(min=1).to(torch.float32)[:, None]

    # ---- Scenario 1 (Eq. 10 + Eq. 11): tau_j > 1 -------------------------
    safe_tau = tau_j.clamp(min=2)
    pow_tp = fpow(rb, tau_j[:, None] - p)
    w_gj = _where0(in_group_j,
                   pow_tp / tau_j.clamp(min=1).to(torch.float32)[:, None])
    v_gj = weighted_multihot_scatter(history, w_gj, n_items)
    c_row = torch.where(p == i[:, None], -pow_tp, pow_tp * (params.r_b - 1.0))
    c_row = _where0(in_group_j & (p >= i[:, None]), c_row)
    suffix_g = weighted_multihot_scatter(history, c_row, n_items)
    v_gj_new = ((tau_j.to(torch.float32)[:, None] * v_gj + suffix_g)
                / ((safe_tau - 1).to(torch.float32) * params.r_b)[:, None])
    user_s1 = user_vec + (fpow(rg, k - 1 - j)[:, None] * (v_gj_new - v_gj)
                          / kf)
    sizes_s1 = _add_row(group_sizes, j, -1)

    # ---- Scenario 2 (Eq. 12): tau_j == 1, k > 1 ---------------------------
    cg = decay.batched_suffix_coefficients(k, j + 1, params.r_g, kmax)
    w_row_s2 = _where0(valid_row,
                       cg.gather(1, g) * fpow(rb, tau - p)
                       / tau.clamp(min=1).to(torch.float32))
    suffix_u = weighted_multihot_scatter(history, w_row_s2, n_items)
    safe_k = k.clamp(min=2).to(torch.float32)
    user_s2 = ((k.to(torch.float32)[:, None] * user_vec + suffix_u)
               / ((safe_k - 1) * params.r_g)[:, None])
    sizes_s2 = _remove_entry(group_sizes, j)
    err_s2 = err_mult * decay.error_growth_factor(safe_k, params.r_g)

    # ---- Scenario 3: tau_j == 1 and k == 1 → empty state ------------------
    single = tau_j == 1
    last = k == 1
    user_vec = _pick(single, _pick(last, torch.zeros_like(user_vec),
                                   user_s2), user_s1)
    group_sizes = _pick(single, _pick(last, torch.zeros_like(group_sizes),
                                      sizes_s2), sizes_s1)
    n_groups = torch.where(single, torch.where(last, torch.zeros_like(k),
                                               k - 1), k).to(n_groups.dtype)
    err_mult = torch.where(single, torch.where(last, torch.ones_like(err_mult),
                                               err_s2), err_mult)

    # ---- history compaction: shift rows > pos up by one --------------------
    src = torch.where(t >= pos[:, None], (t + 1).clamp(max=n_bask - 1), t)
    history = history.gather(1, src[:, :, None].expand(history.shape))
    history = _set_row(history, (nb - 1).clamp(min=0),
                       torch.full_like(history[:, 0], PAD_ID))
    last_group_vec = last_group_vector_padded(history, group_sizes,
                                              n_groups, params)
    return (user_vec, last_group_vec, history, group_sizes, n_baskets - 1,
            n_groups, err_mult)


def _delete_item(user_vec, last_group_vec, history, group_sizes, n_baskets,
                 n_groups, err_mult, pos, item, params: TifuParams):
    """Scenario 3 of §4.3 (Eq. 13 + Eq. 11) for each row's ``item`` i[U]
    in its basket at ``pos`` i[U], with the basket-vanish fallback (a
    one-item basket goes through ``_delete_basket``); an item absent from
    the basket changes nothing."""
    dev = user_vec.device
    n_items = user_vec.shape[1]
    rb = f32(params.r_b, dev)
    rg = f32(params.r_g, dev)
    pos = pos.long()
    item = item.to(history.dtype)
    r = torch.arange(history.shape[0], device=dev)
    row = history[r, pos.clamp(max=history.shape[1] - 1)]      # [U, B]
    present = torch.any(row == item[:, None], dim=1)
    blen = torch.sum(row >= 0, dim=1)
    vanish = present & (blen == 1)

    # --- Eq. 13 path: remove the item from the basket in place -------------
    j, i = _locate(group_sizes, pos)
    k = n_groups.long()
    tau_j = _take(group_sizes, j).long().clamp(min=1)
    delta = -_multi_hot(item[:, None], n_items)
    scale_g = fpow(rb, tau_j - i) / tau_j.to(torch.float32)
    dg = scale_g[:, None] * delta                        # v'_gj - v_gj
    user_ip = user_vec + (fpow(rg, k - 1 - j)[:, None] * dg
                          / k.clamp(min=1).to(torch.float32)[:, None])
    lgv_ip = _pick(j == k - 1, last_group_vec + dg, last_group_vec)
    new_row = torch.where(row == item[:, None], torch.full_like(row, PAD_ID),
                          row)
    hist_ip = _set_row(history, pos, new_row)

    # --- fallback: basket vanishes → full basket deletion -------------------
    (user_db, lgv_db, hist_db, sizes_db, nb_db, ng_db, err_db) = \
        _delete_basket(user_vec, last_group_vec, history, group_sizes,
                       n_baskets, n_groups, err_mult, pos, params)

    apply_ip = present & ~vanish
    apply_db = vanish
    return (_pick(apply_ip, user_ip, _pick(apply_db, user_db, user_vec)),
            _pick(apply_ip, lgv_ip, _pick(apply_db, lgv_db, last_group_vec)),
            _pick(apply_ip, hist_ip, _pick(apply_db, hist_db, history)),
            _pick(apply_db, sizes_db, group_sizes),
            torch.where(apply_db, nb_db, n_baskets),
            torch.where(apply_db, ng_db, n_groups),
            torch.where(apply_db, err_db, err_mult))


def _single_update(user_vec, last_group_vec, history, group_sizes,
                   n_baskets, n_groups, err_mult, kind, items, pos, item,
                   params: TifuParams):
    """One update per row (Algorithm 1 generalised to four kinds).

    Every rule runs on every row and ``kind`` i[U] picks one; a delete
    on an empty history is a no-op, and delete positions are clipped
    into the history so its reads stay in bounds.
    """
    state = (user_vec, last_group_vec, history, group_sizes, n_baskets,
             n_groups, err_mult)
    add = _add_basket(*state, items, params)
    nb = n_baskets.long()
    safe_pos = torch.minimum(pos.long().clamp(min=0), (nb - 1).clamp(min=0))
    delb = _delete_basket(*state, safe_pos, params)
    deli = _delete_item(*state, safe_pos, item, params)

    # suppress deletes on empty histories (no-op)
    deleting = (kind == KIND_DEL_BASKET) | (kind == KIND_DEL_ITEM)
    kind = torch.where((nb == 0) & deleting,
                       torch.full_like(kind, KIND_NOOP), kind)
    return tuple(
        _pick(kind == KIND_ADD_BASKET, a,
              _pick(kind == KIND_DEL_BASKET, b,
                    _pick(kind == KIND_DEL_ITEM, c, s)))
        for s, a, b, c in zip(state, add, delb, deli))


# ---------------------------------------------------------------------------
# Sparse-delta add path (Eq. 7-9)
# ---------------------------------------------------------------------------

def apply_add_batch_counted(state: StreamState, batch: AddBatch,
                            params: TifuParams,
                            cols: Optional[Tuple[int, int]] = None
                            ) -> Tuple[StreamState, torch.Tensor]:
    """Apply a basket-addition sub-batch with sparse deltas (Eq. 7–9).

    O(batch · W) state traffic, W = (group_size+1)·max_basket_size: the
    support of one addition is the new basket plus the last group's
    items; the Eq. 7 rescale ``k·r_g/(k+1)`` and the Eq. 8 rescale
    ``tau·r_b/(tau+1)`` multiply ``uv_scale``/``lgv_scale``.  Adds to a
    user whose history or group table is full are no-ops.  Updates
    ``state`` in place; returns ``(state, dropped)`` with ``dropped`` the
    device count of valid rows the capacity guard masked.

    ``cols``: the vector tables hold the items ``[i0, i1)`` only (a
    rank's block under a mesh); the dedup and every per-row scalar still
    run on the global ids, and B1/B2 address the block's columns.

    INVARIANT: each user appears at most once among valid rows.
    """
    dev = state.device
    u = batch.user.long()
    n_bask, bh = state.max_baskets, state.max_basket_size
    kmax = state.max_groups
    m = params.group_size
    n_rows = u.shape[0]

    k = state.n_groups[u].long()
    nb = state.n_baskets[u].long()
    s = state.uv_scale[u]
    sig = state.lgv_scale[u]
    em = state.err_mult[u]
    tau = torch.where(
        k > 0, state.group_sizes[u, (k - 1).clamp(min=0)].long(),
        torch.zeros_like(k))
    new_group = (k == 0) | (tau >= m)
    at_capacity = _capacity_mask(nb, k, tau, n_bask, kmax, m)
    valid = batch.valid & ~at_capacity
    items = torch.where(valid[:, None], batch.items,
                        torch.full_like(batch.items, PAD_ID))
    kf = k.clamp(min=1).to(torch.float32)
    tauf = tau.to(torch.float32)
    r_b = f32(params.r_b, dev)
    r_g = f32(params.r_g, dev)

    # --- sparse support: last group's history rows + the new basket --------
    start = nb - tau
    row_t = torch.arange(m, device=dev)[None, :]
    rows_valid = ((row_t < tau[:, None]) & (k > 0)[:, None]
                  & valid[:, None])
    grp_rows = (start[:, None] + row_t).clamp(0, n_bask - 1)
    old_ids = state.history[u[:, None], grp_rows]               # [U, m, Bh]
    old_ids = torch.where(rows_valid[:, :, None], old_ids,
                          torch.full_like(old_ids, PAD_ID)
                          ).reshape(n_rows, m * bh)
    ids_all = torch.cat([old_ids, items], dim=1)                 # [U, W]
    first = _first_occurrence(ids_all)
    bfirst = _first_occurrence(items)
    zeros_old = torch.zeros(old_ids.shape, dtype=torch.float32, device=dev)

    lraw = sparse_row_gather(state.last_group_vecs, u,
                             _on_cols(ids_all, cols))
    ltrue = lraw * sig[:, None]

    # --- scale updates (the dense part of Eq. 7/8, now scalar) -------------
    one = torch.ones_like(kf)
    s_ratio = torch.where(new_group & (k > 0), kf * r_g / (kf + 1.0), one)
    s_new = s * s_ratio
    sig_ratio = torch.where(new_group, 1.0 / sig,
                            tauf * r_b / (tauf.clamp(min=1.0) + 1.0))
    sig_ratio = torch.where(valid, sig_ratio, one)
    sig_new = sig * sig_ratio

    # --- sparse deltas into the raw user rows ------------------------------
    alpha = tauf * r_b / (tauf + 1.0)
    beta = 1.0 / (tauf + 1.0)
    l_part = torch.where(new_group[:, None], torch.zeros_like(ltrue),
                         first * (alpha - 1.0)[:, None] * ltrue
                         / (kf * s)[:, None])
    b_coeff = torch.where(new_group, 1.0 / ((kf * (k > 0) + 1.0) * s_new),
                          beta / (kf * s))
    user_vals = l_part + torch.cat([zeros_old, bfirst * b_coeff[:, None]],
                                   dim=1)

    # --- sparse deltas into the raw last-group rows ------------------------
    lgv_reset = first * (-lraw) + torch.cat(
        [zeros_old, bfirst / sig_new[:, None]], dim=1)
    lgv_append = torch.cat(
        [zeros_old, bfirst / ((tauf + 1.0) * sig_new)[:, None]], dim=1)
    lgv_vals = torch.where(new_group[:, None], lgv_reset, lgv_append)

    on_cols = _on_cols(ids_all, cols)
    sparse_row_scatter(state.user_vecs, u, on_cols, user_vals)
    sparse_row_scatter(state.last_group_vecs, u, on_cols, lgv_vals)

    # --- per-row scalar / bookkeeping deltas -------------------------------
    valid_i = valid.to(torch.int32)
    err_new = torch.clamp(
        em * torch.where(k > 0, decay.error_shrink_factor(kf, params.r_g),
                         torch.zeros_like(kf)), min=1e-30)
    err_ratio = torch.where(valid & new_group, err_new / em, one)
    gs_slot = torch.where(new_group, k.clamp(max=kmax - 1),
                          (k - 1).clamp(min=0))
    hist_slot = nb.clamp(max=n_bask - 1)
    # the target history row is all PAD (-1): adding (item - PAD) writes
    # the basket without a dense [batch, N, B] delta block
    hist_delta = _where0(valid[:, None], items - PAD_ID)
    dropped = torch.sum((at_capacity & batch.valid).to(torch.int32))

    _add_(state.history, (u[:, None], hist_slot[:, None],
                          torch.arange(bh, device=dev)[None, :]),
          hist_delta)
    _add_(state.group_sizes, (u, gs_slot), valid_i)
    _add_(state.n_baskets, (u,), valid_i)
    _add_(state.n_groups, (u,), valid_i * new_group.to(torch.int32))
    _mul_(state.err_mult, u, err_ratio)
    _mul_(state.uv_scale, u, torch.where(valid, s_ratio, one))
    _mul_(state.lgv_scale, u, sig_ratio)
    return state, dropped


def apply_add_batch(state: StreamState, batch: AddBatch,
                    params: TifuParams,
                    cols: Optional[Tuple[int, int]] = None) -> StreamState:
    """Apply a basket-addition sub-batch with sparse deltas (Eq. 7–9).

    As :func:`apply_add_batch_counted` — O(batch · W) state traffic —
    without the drop count.  Updates ``state`` in place.
    """
    return apply_add_batch_counted(state, batch, params, cols)[0]


# ---------------------------------------------------------------------------
# Sparse decremental sub-batches (Eq. 10-13)
# ---------------------------------------------------------------------------

def _slots(c_row: torch.Tensor, bh: int) -> torch.Tensor:
    """[U, N] per-history-row coefficients → [U, N·B] per-slot values."""
    u, n = c_row.shape
    return c_row[:, :, None].expand(u, n, bh).reshape(u, n * bh)


def _del_basket_sparse_core(state: StreamState, u, hist, gs, nb, k, s, sig,
                            em, pos, valid, params: TifuParams, cols=None):
    """Shared sparse basket-deletion math (Eq. 10-12 on the support).

    Rows with ``valid`` False produce all-PAD support ids, zero scatter
    values and unit ratios.  The support ids are global; the gathers read
    the columns ``cols`` holds (:func:`_on_cols`).  Returns ``(ids, u_vals, l_vals, s_ratio,
    em_ratio, new_hist, new_gs, d_nb, d_ng)``.
    """
    dev = state.device
    n_rows = u.shape[0]
    n_bask, bh = hist.shape[1], hist.shape[2]
    kmax = gs.shape[1]
    rb = f32(params.r_b, dev)
    rg = f32(params.r_g, dev)

    g, p, tau, _ = row_group_geometry(gs, n_bask)                 # [U, N]
    j, i = _locate(gs, pos)                                       # [U]
    tau_j = gs.long().gather(1, j[:, None])[:, 0]

    t = torch.arange(n_bask, device=dev)[None, :]
    valid_row = (t < nb[:, None]) & valid[:, None]
    in_gj = valid_row & (g == j[:, None])

    single = tau_j == 1
    last_g = k <= 1
    s1 = valid & ~single                   # Eq. 10+11: group j shrinks
    s2 = valid & single & ~last_g          # Eq. 12: group j vanishes
    s3 = valid & single & last_g           # last basket: state empties

    kf = k.clamp(min=1).to(torch.float32)
    safe_k = k.clamp(min=2).to(torch.float32)
    tjf = tau_j.to(torch.float32)
    safe_tau = tau_j.clamp(min=2).to(torch.float32)
    tau_f = tau.clamp(min=1).to(torch.float32)

    # --- support: the user's masked history window -------------------------
    ids = torch.where(valid_row[:, :, None], hist,
                      torch.full_like(hist, PAD_ID)).reshape(n_rows,
                                                             n_bask * bh)
    first = _first_occurrence(ids).to(torch.float32)
    on_cols = _on_cols(ids, cols)
    uraw = sparse_row_gather(state.user_vecs, u, on_cols)
    lraw = sparse_row_gather(state.last_group_vecs, u, on_cols)

    # --- scenario 1: per-slot expansion of r_g^(k-1-j)·(v'_gj - v_gj)/k ----
    pow_tp = fpow(rb, _where0(in_gj, tau_j[:, None] - p))
    w_gj = _where0(in_gj, pow_tp / tau_f)
    sc = torch.where(p == i[:, None], -pow_tp, pow_tp * (rb - 1.0))
    sc = _where0(in_gj & (p >= i[:, None]), sc)
    dvg = (((tjf - (tjf - 1.0) * rb)[:, None] * w_gj + sc)
           / ((safe_tau - 1.0) * rb)[:, None])
    cu1 = (fpow(rg, (k - 1 - j).clamp(min=0)) / kf)[:, None] * dvg

    # --- scenario 2: suffix over groups j..k-1; the rescale folds into s ---
    cg = decay.batched_suffix_coefficients(k, j + 1, params.r_g, kmax)
    cu2 = _where0(valid_row, cg.gather(1, g)
                  * fpow(rb, _where0(valid_row, tau - p)) / tau_f)
    s_ratio = torch.where(s2, kf / ((safe_k - 1.0) * rg),
                          torch.ones_like(kf))

    # --- user-vector scatter values (raw storage) --------------------------
    zero = torch.zeros_like(uraw)
    u_vals = torch.where(s1[:, None], _slots(cu1, bh) / s[:, None],
                         torch.where(s2[:, None],
                                     _slots(cu2, bh) / (kf * s)[:, None],
                                     torch.where(s3[:, None], -uraw * first,
                                                 zero)))

    # --- last-group row: reset to the new true value on the support --------
    lgv_new_1 = s1 & (j == k - 1)
    lgv_new_2 = s2 & (j == k - 1)
    lgv_change = lgv_new_1 | lgv_new_2 | s3
    cl1 = w_gj + dvg
    cl2 = _where0(valid_row & (g == (k - 2)[:, None]),
                  fpow(rb, _where0(valid_row, tau - p)) / tau_f)
    cl = torch.where(lgv_new_1[:, None], cl1,
                     torch.where(lgv_new_2[:, None], cl2,
                                 torch.zeros_like(cl1)))
    l_vals = _where0(lgv_change[:, None],
                     -lraw * first + _slots(cl, bh) / sig[:, None])

    # --- history compaction + group-size bookkeeping (O(N·B)) --------------
    src = torch.where(t >= pos[:, None], (t + 1).clamp(max=n_bask - 1),
                      t.expand(n_rows, n_bask))
    new_hist = hist.gather(1, src[:, :, None].expand(n_rows, n_bask, bh))
    new_hist[torch.arange(n_rows, device=dev), (nb - 1).clamp(min=0)] = \
        PAD_ID
    gs_s1 = gs.clone()
    gs_s1[torch.arange(n_rows, device=dev), j] -= 1
    gs_s2 = _remove_entry(gs, j)
    new_gs = torch.where(single[:, None],
                         torch.where(last_g[:, None], torch.zeros_like(gs),
                                     gs_s2), gs_s1)

    em_ratio = torch.where(
        s2, decay.error_growth_factor(safe_k, params.r_g),
        torch.ones_like(safe_k))
    em_ratio = torch.where(s3, 1.0 / em, em_ratio)
    d_nb = -valid.to(torch.int32)
    d_ng = -(valid & single).to(torch.int32)
    return (ids, u_vals, l_vals, s_ratio, em_ratio, new_hist, new_gs,
            d_nb, d_ng)


def _gather_rows(state: StreamState, u: torch.Tensor):
    return (state.history[u], state.group_sizes[u],
            state.n_baskets[u].long(), state.n_groups[u].long(),
            state.uv_scale[u], state.lgv_scale[u], state.err_mult[u])


def apply_del_basket_batch(state: StreamState, batch: DelBasketBatch,
                           params: TifuParams,
                           cols: Optional[Tuple[int, int]] = None
                           ) -> StreamState:
    """Apply a basket-deletion sub-batch with sparse deltas (Eq. 10–12).

    The suffix contractions are expanded to per-history-slot
    coefficients, so state traffic is O(batch · N·B) — the deleted
    user's history window — not O(batch · n_items).  Updates ``state``
    in place.  ``cols``: as :func:`apply_add_batch_counted`'s.
    """
    u = batch.user.long()
    hist, gs, nb, k, s, sig, em = _gather_rows(state, u)
    valid = batch.valid & (nb > 0)
    pos = torch.minimum(batch.pos.long().clamp(min=0),
                        (nb - 1).clamp(min=0))
    (ids, u_vals, l_vals, s_ratio, em_ratio, new_hist, new_gs, d_nb,
     d_ng) = _del_basket_sparse_core(state, u, hist, gs, nb, k, s, sig, em,
                                     pos, valid, params, cols)
    on_cols = _on_cols(ids, cols)
    sparse_row_scatter(state.user_vecs, u, on_cols, u_vals)
    sparse_row_scatter(state.last_group_vecs, u, on_cols, l_vals)
    _add_(state.history, (u,), _where0(valid[:, None, None],
                                       new_hist - hist))
    _add_(state.group_sizes, (u,), _where0(valid[:, None], new_gs - gs))
    _add_(state.n_baskets, (u,), d_nb)
    _add_(state.n_groups, (u,), d_ng)
    one = torch.ones_like(em_ratio)
    _mul_(state.err_mult, u, torch.where(valid, em_ratio, one))
    _mul_(state.uv_scale, u, torch.where(valid, s_ratio, one))
    return state


def apply_del_item_batch(state: StreamState, batch: DelItemBatch,
                         params: TifuParams,
                         cols: Optional[Tuple[int, int]] = None
                         ) -> StreamState:
    """Apply an item-deletion sub-batch with sparse deltas (Eq. 13).

    The in-place branch touches one (user, item) cell of each vector
    table, O(1) per event; the basket-vanish fallback reuses the Eq.
    10–12 core on the history window, O(N·B) per event.  Updates
    ``state`` in place.  ``cols``: as :func:`apply_add_batch_counted`'s.
    """
    dev = state.device
    u = batch.user.long()
    hist, gs, nb, k, s, sig, em = _gather_rows(state, u)
    n_rows = u.shape[0]
    valid = batch.valid & (nb > 0)
    pos = torch.minimum(batch.pos.long().clamp(min=0),
                        (nb - 1).clamp(min=0))
    item = batch.item.to(hist.dtype)

    row = hist[torch.arange(n_rows, device=dev), pos]             # [U, B]
    present = valid & torch.any(row == item[:, None], dim=1)
    blen = torch.sum(row >= 0, dim=1)
    apply_db = present & (blen == 1)                               # vanishes
    apply_ip = present & (blen > 1)                                # Eq. 13

    (ids_db, u_db, l_db, s_ratio, em_ratio, hist_db, gs_db, d_nb,
     d_ng) = _del_basket_sparse_core(state, u, hist, gs, nb, k, s, sig, em,
                                     pos, apply_db, params, cols)

    # --- Eq. 13 in place: one cell per table -------------------------------
    j, i = _locate(gs, pos)
    tau_j = gs.long().gather(1, j[:, None])[:, 0].clamp(min=1)
    rb = f32(params.r_b, dev)
    rg = f32(params.r_g, dev)
    kf = k.clamp(min=1).to(torch.float32)
    dg = -fpow(rb, (tau_j - i).clamp(min=0)) / tau_j.to(torch.float32)
    du_ip = _where0(apply_ip, fpow(rg, (k - 1 - j).clamp(min=0)) * dg
                    / (kf * s))
    dl_ip = _where0(apply_ip & (j == k - 1), dg / sig)

    ids = torch.cat([ids_db, torch.where(apply_ip, item, torch.full_like(
        item, PAD_ID))[:, None]], dim=1)
    u_vals = torch.cat([u_db, du_ip[:, None]], dim=1)
    l_vals = torch.cat([l_db, dl_ip[:, None]], dim=1)

    # --- history/bookkeeping: in-place row edit vs fallback compaction -----
    row_ip = torch.where(row == item[:, None], torch.full_like(row, PAD_ID),
                         row)
    hist_ip = hist.clone()
    hist_ip[torch.arange(n_rows, device=dev), pos] = row_ip
    new_hist = torch.where(apply_db[:, None, None], hist_db,
                           torch.where(apply_ip[:, None, None], hist_ip,
                                       hist))
    new_gs = torch.where(apply_db[:, None], gs_db, gs)
    touched = apply_db | apply_ip

    on_cols = _on_cols(ids, cols)
    sparse_row_scatter(state.user_vecs, u, on_cols, u_vals)
    sparse_row_scatter(state.last_group_vecs, u, on_cols, l_vals)
    _add_(state.history, (u,), _where0(touched[:, None, None],
                                       new_hist - hist))
    _add_(state.group_sizes, (u,), _where0(apply_db[:, None], new_gs - gs))
    _add_(state.n_baskets, (u,), d_nb)
    _add_(state.n_groups, (u,), d_ng)
    one = torch.ones_like(em_ratio)
    _mul_(state.err_mult, u, torch.where(apply_db, em_ratio, one))
    _mul_(state.uv_scale, u, torch.where(apply_db, s_ratio, one))
    return state


# ---------------------------------------------------------------------------
# Dense masked decremental sub-batches (their support IS the history)
# ---------------------------------------------------------------------------

def _gather_true(state: StreamState, u: torch.Tensor):
    """Per-user state rows with the scales folded in (true values),
    then the scales themselves."""
    s = state.uv_scale[u]
    sig = state.lgv_scale[u]
    return (state.user_vecs[u] * s[:, None],
            state.last_group_vecs[u] * sig[:, None],
            state.history[u], state.group_sizes[u], state.n_baskets[u],
            state.n_groups[u], state.err_mult[u], s, sig)


def _scatter_del_deltas(state: StreamState, u: torch.Tensor,
                        valid: torch.Tensor, old, new) -> StreamState:
    """Write masked true-value deltas back into the scaled raw storage.

    Raw deltas are divided by the (unchanged) per-user scales; rows not
    ``valid`` carry zero deltas and a factor 1, so padding rows may
    alias any user.  The last-group raw row is *set* to new_true/sigma
    (its support after a deletion is recomputed from history), as a
    delta against the row read before any write.
    """
    uv, lgv, hist, gs, nb, ng, em, s, sig = old
    n_uv, n_lgv, n_hist, n_gs, n_nb, n_ng, n_em = new
    vf = valid[:, None]
    duv = _where0(vf, (n_uv - uv) / s[:, None])
    dlgv = _where0(vf, n_lgv / sig[:, None] - state.last_group_vecs[u])
    _add_(state.user_vecs, (u,), duv)
    _add_(state.last_group_vecs, (u,), dlgv)
    _add_(state.history, (u,), _where0(valid[:, None, None], n_hist - hist))
    _add_(state.group_sizes, (u,), _where0(vf, n_gs - gs))
    _add_(state.n_baskets, (u,), _where0(valid, n_nb - nb))
    _add_(state.n_groups, (u,), _where0(valid, n_ng - ng))
    _mul_(state.err_mult, u, torch.where(valid, n_em / em,
                                         torch.ones_like(em)))
    return state


def _dense_delete(state: StreamState, batch, rule, *args) -> StreamState:
    """Gather the batch's rows, run ``rule`` at the clipped positions on
    the rows of users with a history, scatter the deltas back."""
    u = batch.user.long()
    old = _gather_true(state, u)
    nb = old[4].long()
    valid = batch.valid & (nb > 0)
    safe_pos = torch.minimum(batch.pos.long().clamp(min=0),
                             (nb - 1).clamp(min=0))
    new = rule(*old[:7], safe_pos, *args)
    return _scatter_del_deltas(state, u, valid, old, new)


def apply_del_basket_batch_dense(state: StreamState, batch: DelBasketBatch,
                                 params: TifuParams) -> StreamState:
    """Apply a basket-deletion sub-batch (Eq. 10-12), densely.

    Gathers the [batch, n_items] state rows, runs the per-user rule on
    them and writes dense deltas — O(batch · n_items) state traffic.
    The correctness and benchmark baseline of the sparse path
    (:func:`apply_del_basket_batch`), which touches only the history
    window.  Updates ``state`` in place.
    """
    return _dense_delete(state, batch,
                         lambda *a: _delete_basket(*a, params))


def apply_del_item_batch_dense(state: StreamState, batch: DelItemBatch,
                               params: TifuParams) -> StreamState:
    """Apply an item-deletion sub-batch (Eq. 13 + basket vanish), densely.

    Dense [batch, n_items] rows — O(batch · n_items) state traffic; the
    correctness and benchmark baseline of the sparse path
    (:func:`apply_del_item_batch`).  Updates ``state`` in place.
    """
    return _dense_delete(state, batch,
                         lambda *a: _delete_item(*a, params), batch.item)


# ---------------------------------------------------------------------------
# Mixed-batch entry points
# ---------------------------------------------------------------------------

def apply_update_batch(state: StreamState, batch: UpdateBatch,
                       params: TifuParams) -> StreamState:
    """Apply a mixed micro-batch through the kind-partitioned appliers.

    Reads ``batch.kind`` on the host once (and the other fields only
    where a kind needs them), builds the homogeneous sub-batches, each
    padded within ``batch.size`` rows, on the state's device, and
    applies adds, then basket deletions, then item deletions — so each
    event pays its own kind's cost (adds O(batch·W), deletions
    O(batch·N·B): Eq. 7–13 through the sparse appliers).  INVARIANT:
    each user appears at most once among the non-noop rows, so the
    sub-batches touch disjoint users.  Updates ``state`` in place.
    """
    kind = batch.kind.cpu().numpy()
    add_rows = np.nonzero(kind == KIND_ADD_BASKET)[0]
    delb_rows = np.nonzero(kind == KIND_DEL_BASKET)[0]
    deli_rows = np.nonzero(kind == KIND_DEL_ITEM)[0]
    if not (add_rows.size or delb_rows.size or deli_rows.size):
        return state
    cap = int(kind.shape[0])
    dev = state.device
    user = batch.user.cpu().numpy()
    if add_rows.size:
        items = batch.basket_items.cpu().numpy()
        apply_add_batch(state, AddBatch.build(
            user[add_rows], items[add_rows], items.shape[1], pad_cap=cap,
            device=dev), params)
    if delb_rows.size or deli_rows.size:
        pos = batch.basket_pos.cpu().numpy()
    if delb_rows.size:
        apply_del_basket_batch(state, DelBasketBatch.build(
            user[delb_rows], pos[delb_rows], pad_cap=cap, device=dev),
            params)
    if deli_rows.size:
        item = batch.item.cpu().numpy()
        apply_del_item_batch(state, DelItemBatch.build(
            user[deli_rows], pos[deli_rows], item[deli_rows], pad_cap=cap,
            device=dev), params)
    return state


def apply_update_batch_dense(state: StreamState, batch: UpdateBatch,
                             params: TifuParams) -> StreamState:
    """Apply a mixed micro-batch through the dense compute-all path.

    Gathers [batch, n_items] rows, computes ALL update rules (Eq. 7–13)
    on every row, picks one per row and adds dense deltas — ~4x
    redundant compute and O(batch · n_items) traffic whatever the kind
    mix.  The benchmark baseline of :func:`apply_update_batch` and a
    second oracle.  As in the JAX package an add has no capacity check
    (an add to a full history overwrites its last row and counts a
    basket), and ``err_mult`` takes its delta as a sum.  Updates
    ``state`` in place.
    """
    u = batch.user.long()
    *gathered, s, sig = _gather_true(state, u)
    updated = _single_update(*gathered, batch.kind, batch.basket_items,
                             batch.basket_pos, batch.item, params)
    d = [new - old for new, old in zip(updated, gathered)]
    _add_(state.user_vecs, (u,), d[0] / s[:, None])
    _add_(state.last_group_vecs, (u,), d[1] / sig[:, None])
    _add_(state.history, (u,), d[2])
    _add_(state.group_sizes, (u,), d[3])
    _add_(state.n_baskets, (u,), d[4])
    _add_(state.n_groups, (u,), d[5])
    _add_(state.err_mult, (u,), d[6])
    return state


# ---------------------------------------------------------------------------
# Maintenance passes
# ---------------------------------------------------------------------------

def refresh_users(state: StreamState, users: torch.Tensor,
                  params: TifuParams) -> StreamState:
    """Recompute the given (distinct) users from scratch, in place.

    The exact Eq. 1+2 closed-form rebuild on the padded history —
    O(|users| · (N·B + n_items)) — resetting their error trackers and
    scales to 1 (the fresh rows are true values).
    """
    users = users.long()
    h = state.history[users]
    gs = state.group_sizes[users]
    ng = state.n_groups[users]
    state.user_vecs[users] = user_vector_padded(h, gs, ng, params)
    state.last_group_vecs[users] = last_group_vector_padded(h, gs, ng,
                                                            params)
    state.err_mult[users] = 1.0
    state.uv_scale[users] = 1.0
    state.lgv_scale[users] = 1.0
    return state


def renormalize_users(state: StreamState,
                      users: torch.Tensor) -> StreamState:
    """Fold the given (distinct) users' scales into their raw rows.

    In place; their scales become 1.

    Dense per selected user — O(|users| · n_items) — but
    value-preserving and rare: the engine triggers it only when a scale
    approaches SCALE_FLOOR/SCALE_CEIL.
    """
    users = users.long()
    s = state.uv_scale[users]
    sig = state.lgv_scale[users]
    state.user_vecs[users] = state.user_vecs[users] * s[:, None]
    state.last_group_vecs[users] = (state.last_group_vecs[users]
                                    * sig[:, None])
    state.uv_scale[users] = 1.0
    state.lgv_scale[users] = 1.0
    return state
