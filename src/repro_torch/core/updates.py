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

Every vector-table read and write goes through ``kernels.ops``
(``sparse_row_gather`` / ``sparse_row_scatter``).  The appliers update
the state's tensors IN PLACE and return the same state.  Padding rows of
a sub-batch carry user 0 and so alias a valid row of user 0: every
write is an accumulating delta — ``index_put_(accumulate=True)`` for
sums, a product scatter with factor 1 for the scales — never a plain
indexed assignment, whose duplicate writes would race.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import decay
from repro_torch.core.decay import f32, fpow
from repro_torch.core.tifu import (last_group_vector_padded,
                                   row_group_geometry, user_vector_padded)
from repro_torch.core.types import (PAD_ID, AddBatch, DelBasketBatch,
                                    DelItemBatch, StreamState, TifuParams)
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


# ---------------------------------------------------------------------------
# Sparse-delta add path (Eq. 7-9)
# ---------------------------------------------------------------------------

def apply_add_batch_counted(state: StreamState, batch: AddBatch,
                            params: TifuParams
                            ) -> Tuple[StreamState, torch.Tensor]:
    """Apply a basket-addition sub-batch with sparse deltas (Eq. 7–9).

    O(batch · W) state traffic, W = (group_size+1)·max_basket_size: the
    support of one addition is the new basket plus the last group's
    items; the Eq. 7 rescale ``k·r_g/(k+1)`` and the Eq. 8 rescale
    ``tau·r_b/(tau+1)`` multiply ``uv_scale``/``lgv_scale``.  Adds to a
    user whose history or group table is full are no-ops.  Updates
    ``state`` in place; returns ``(state, dropped)`` with ``dropped`` the
    device count of valid rows the capacity guard masked.

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

    lraw = sparse_row_gather(state.last_group_vecs, u, ids_all)
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

    sparse_row_scatter(state.user_vecs, u, ids_all, user_vals)
    sparse_row_scatter(state.last_group_vecs, u, ids_all, lgv_vals)

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
                    params: TifuParams) -> StreamState:
    """Apply a basket-addition sub-batch with sparse deltas (Eq. 7–9).

    As :func:`apply_add_batch_counted` — O(batch · W) state traffic —
    without the drop count.  Updates ``state`` in place.
    """
    return apply_add_batch_counted(state, batch, params)[0]


# ---------------------------------------------------------------------------
# Sparse decremental sub-batches (Eq. 10-13)
# ---------------------------------------------------------------------------

def _slots(c_row: torch.Tensor, bh: int) -> torch.Tensor:
    """[U, N] per-history-row coefficients → [U, N·B] per-slot values."""
    u, n = c_row.shape
    return c_row[:, :, None].expand(u, n, bh).reshape(u, n * bh)


def _del_basket_sparse_core(state: StreamState, u, hist, gs, nb, k, s, sig,
                            em, pos, valid, params: TifuParams):
    """Shared sparse basket-deletion math (Eq. 10-12 on the support).

    Rows with ``valid`` False produce all-PAD support ids, zero scatter
    values and unit ratios.  Returns ``(ids, u_vals, l_vals, s_ratio,
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
    uraw = sparse_row_gather(state.user_vecs, u, ids)
    lraw = sparse_row_gather(state.last_group_vecs, u, ids)

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
                           params: TifuParams) -> StreamState:
    """Apply a basket-deletion sub-batch with sparse deltas (Eq. 10–12).

    The suffix contractions are expanded to per-history-slot
    coefficients, so state traffic is O(batch · N·B) — the deleted
    user's history window — not O(batch · n_items).  Updates ``state``
    in place.
    """
    u = batch.user.long()
    hist, gs, nb, k, s, sig, em = _gather_rows(state, u)
    valid = batch.valid & (nb > 0)
    pos = torch.minimum(batch.pos.long().clamp(min=0),
                        (nb - 1).clamp(min=0))
    (ids, u_vals, l_vals, s_ratio, em_ratio, new_hist, new_gs, d_nb,
     d_ng) = _del_basket_sparse_core(state, u, hist, gs, nb, k, s, sig, em,
                                     pos, valid, params)
    sparse_row_scatter(state.user_vecs, u, ids, u_vals)
    sparse_row_scatter(state.last_group_vecs, u, ids, l_vals)
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
                         params: TifuParams) -> StreamState:
    """Apply an item-deletion sub-batch with sparse deltas (Eq. 13).

    The in-place branch touches one (user, item) cell of each vector
    table, O(1) per event; the basket-vanish fallback reuses the Eq.
    10–12 core on the history window, O(N·B) per event.  Updates
    ``state`` in place.
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
                                     pos, apply_db, params)

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

    sparse_row_scatter(state.user_vecs, u, ids, u_vals)
    sparse_row_scatter(state.last_group_vecs, u, ids, l_vals)
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
