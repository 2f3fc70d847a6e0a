"""From-scratch TIFU-kNN user vectors (paper §2.2).

Two implementations, as in the JAX package:

* ragged numpy (``user_vector_ragged``), float64 on the host — mirrors
  the paper text step by step (multi-hot → group vectors → user
  vector); the oracle of the compliance certificate;

* padded torch (``user_vector_padded`` and friends), batched — the
  refresh path of the stability tracker: a user vector is one weighted
  multi-hot scatter of the padded history with the closed-form
  per-basket weight

      w(basket at in-group position p of group j) =
          r_b^(tau_j - p) / tau_j * r_g^(k - j) / k .

  Every padded function takes a leading user dimension (the JAX package
  vmaps a per-user version).
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from repro_torch.core.decay import f32, fpow
from repro_torch.core.types import TifuParams


# ---------------------------------------------------------------------------
# Ragged numpy oracles (float64, host)
# ---------------------------------------------------------------------------

def multi_hot(basket: np.ndarray, n_items: int,
              dtype=np.float64) -> np.ndarray:
    """Multi-hot encode one basket (set of item ids) into a |I| vector."""
    v = np.zeros(n_items, dtype=dtype)
    ids = np.asarray(basket, dtype=np.int64)
    ids = ids[ids >= 0]
    v[ids] = 1.0
    return v


def default_group_sizes(n_baskets: int, m: int) -> List[int]:
    """Initial (fixed-size) grouping: ceil(n/m) groups.

    Groups of length m, the last one holding the remainder; each group
    of size tau is averaged over its own tau baskets (the
    varying-group-size relaxation of the paper's §4.3).
    """
    if n_baskets == 0:
        return []
    k = int(np.ceil(n_baskets / m))
    sizes = [m] * (k - 1)
    sizes.append(n_baskets - m * (k - 1))
    return sizes


def group_vector_ragged(baskets: Sequence[np.ndarray], n_items: int,
                        r_b: float, dtype=np.float64) -> np.ndarray:
    """Eq. 1: time-decayed average of the multi-hot basket vectors."""
    tau = len(baskets)
    v = np.zeros(n_items, dtype=dtype)
    for p, b in enumerate(baskets, start=1):
        v += (r_b ** (tau - p)) * multi_hot(b, n_items, dtype)
    return v / tau


def user_vector_ragged(history: Sequence[np.ndarray],
                       group_sizes: Sequence[int], params: TifuParams,
                       dtype=np.float64) -> np.ndarray:
    """Eq. 2: decayed average of group vectors. The from-scratch oracle."""
    if len(history) == 0:
        return np.zeros(params.n_items, dtype=dtype)
    assert sum(group_sizes) == len(history), (group_sizes, len(history))
    k = len(group_sizes)
    v_u = np.zeros(params.n_items, dtype=dtype)
    start = 0
    for j, tau in enumerate(group_sizes, start=1):
        v_g = group_vector_ragged(history[start:start + tau],
                                  params.n_items, params.r_b, dtype)
        v_u += (params.r_g ** (k - j)) * v_g
        start += tau
    return v_u / k


def group_vectors_ragged(history: Sequence[np.ndarray],
                         group_sizes: Sequence[int], params: TifuParams,
                         dtype=np.float64) -> List[np.ndarray]:
    """All group vectors (needed by decremental scenario 2)."""
    out, start = [], 0
    for tau in group_sizes:
        out.append(group_vector_ragged(history[start:start + tau],
                                       params.n_items, params.r_b, dtype))
        start += tau
    return out


# ---------------------------------------------------------------------------
# Padded torch path
# ---------------------------------------------------------------------------

def row_group_geometry(sizes: torch.Tensor, n_rows: int):
    """Per history row t: group index g, 1-based in-group position p and
    group size tau, for group sizes ``sizes`` i[U, K].  Also returns the
    per-group end offsets ``ends`` i64[U, K]."""
    sizes = sizes.long()
    ends = torch.cumsum(sizes, dim=1)
    starts = ends - sizes
    t = torch.arange(n_rows, device=sizes.device).expand(sizes.shape[0],
                                                         n_rows)
    g = torch.searchsorted(ends, t.contiguous(), right=True).clamp(
        0, sizes.shape[1] - 1)
    tau = sizes.gather(1, g)
    p = t - starts.gather(1, g) + 1
    return g, p, tau, ends


def closed_form_basket_weights(group_sizes: torch.Tensor,
                               n_groups: torch.Tensor, r_b: float,
                               r_g: float, max_baskets: int) -> torch.Tensor:
    """Per-basket weight of every history row, f32[U, max_baskets].

    ``group_sizes`` i[U, K] (zero padded), ``n_groups`` i[U].  Padding
    rows get weight 0.
    """
    dev = group_sizes.device
    k = n_groups.long()
    g, p, tau, ends = row_group_geometry(group_sizes, max_baskets)
    t = torch.arange(max_baskets, device=dev)[None, :]
    # a group count past K (a dense add that overran its group table)
    # reads K's last entry, as the JAX package's indexing does
    last = (k - 1).clamp(0, group_sizes.shape[1] - 1)
    n_total = ends.gather(1, last[:, None])[:, 0] * (k > 0)
    valid = (t < n_total[:, None]) & (tau > 0)
    w_b = fpow(f32(r_b, dev), tau - p) / tau.clamp(min=1)
    w_g = fpow(f32(r_g, dev), k[:, None] - 1 - g) / k.clamp(min=1)[:, None]
    return torch.where(valid, w_b * w_g, torch.zeros_like(w_b))


def weighted_multihot_scatter(history: torch.Tensor, weights: torch.Tensor,
                              n_items: int) -> torch.Tensor:
    """sum_t weights[u, t] · multihot(history[u, t]) → f32[U, n_items].

    ``history`` i32[U, N, B] (PAD_ID padded), ``weights`` f32[U, N].
    """
    u, n, b = history.shape
    ids = history.reshape(u, n * b).long()
    w = weights.repeat_interleave(b, dim=1)
    valid = ids >= 0
    ids = torch.where(valid, ids, torch.zeros_like(ids))
    w = torch.where(valid, w, torch.zeros_like(w))
    out = torch.zeros((u, n_items), dtype=torch.float32,
                      device=history.device)
    return out.scatter_add_(1, ids, w)


def user_vector_padded(history: torch.Tensor, group_sizes: torch.Tensor,
                       n_groups: torch.Tensor,
                       params: TifuParams) -> torch.Tensor:
    """From-scratch user vectors (Eq. 1 + 2) on padded tensors."""
    w = closed_form_basket_weights(group_sizes, n_groups, params.r_b,
                                   params.r_g, history.shape[1])
    return weighted_multihot_scatter(history, w, params.n_items)


def last_group_basket_weights(group_sizes: torch.Tensor,
                              n_groups: torch.Tensor, r_b: float,
                              max_baskets: int) -> torch.Tensor:
    """Per-basket weight of every history row in its user's last-group
    vector (Eq. 1 over the last group alone), f32[U, max_baskets].

    ``r_b^(tau - p) / tau`` on the last group's rows, 0 elsewhere.
    """
    dev = group_sizes.device
    sizes = group_sizes.long()
    ends = torch.cumsum(sizes, dim=1)
    last = (n_groups.long()[:, None] - 1).clamp(0, sizes.shape[1] - 1)
    tau = sizes.gather(1, last)
    start = ends.gather(1, last) - tau
    t = torch.arange(max_baskets, device=dev)[None, :]
    p = t - start + 1
    valid = (p >= 1) & (p <= tau)
    w = fpow(f32(r_b, dev), tau - p) / tau.clamp(min=1)
    return torch.where(valid, w, torch.zeros_like(w))


def last_group_vector_padded(history: torch.Tensor,
                             group_sizes: torch.Tensor,
                             n_groups: torch.Tensor,
                             params: TifuParams) -> torch.Tensor:
    """Recompute each user's last-group vector from padded history."""
    w = last_group_basket_weights(group_sizes, n_groups, params.r_b,
                                  history.shape[1])
    out = weighted_multihot_scatter(history, w, params.n_items)
    return torch.where((n_groups > 0)[:, None], out, torch.zeros_like(out))


# From-scratch user vectors of many users, [M, N, B], [M, K], [M] →
# f32[M, I]: the JAX package's name for the same plain torch scatter (it
# leaves the scatter to XLA).  The kernel path of this rebuild is
# ``ops.multihot_scatter`` over ``closed_form_basket_weights``.
batch_user_vectors = user_vector_padded
