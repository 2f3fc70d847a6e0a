"""From-scratch TIFU-kNN vectors on padded tensors (paper §2.2), batched.

The refresh path of the stability tracker: a user vector is one weighted
multi-hot scatter of the padded history with the closed-form per-basket
weight

    w(basket at in-group position p of group j) =
        r_b^(tau_j - p) / tau_j * r_g^(k - j) / k .

Every function takes a leading user dimension (the JAX package vmaps a
per-user version).
"""
from __future__ import annotations

import torch

from repro_torch.core.decay import f32, fpow
from repro_torch.core.types import TifuParams


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
    n_total = ends.gather(1, (k - 1).clamp(min=0)[:, None])[:, 0] * (k > 0)
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


def last_group_vector_padded(history: torch.Tensor,
                             group_sizes: torch.Tensor,
                             n_groups: torch.Tensor,
                             params: TifuParams) -> torch.Tensor:
    """Recompute each user's last-group vector from padded history."""
    dev = history.device
    sizes = group_sizes.long()
    ends = torch.cumsum(sizes, dim=1)
    k = n_groups.long().clamp(min=1)[:, None]
    tau = sizes.gather(1, k - 1)
    start = ends.gather(1, k - 1) - tau
    t = torch.arange(history.shape[1], device=dev)[None, :]
    p = t - start + 1
    valid = (p >= 1) & (p <= tau)
    w = fpow(f32(params.r_b, dev), tau - p) / tau.clamp(min=1)
    w = torch.where(valid, w, torch.zeros_like(w))
    out = weighted_multihot_scatter(history, w, params.n_items)
    return torch.where((n_groups > 0)[:, None], out, torch.zeros_like(out))


# From-scratch user vectors of many users, [M, N, B], [M, K], [M] →
# f32[M, I]: the JAX package's name for the same plain torch scatter (it
# leaves the scatter to XLA).  The kernel path of this rebuild is
# ``ops.multihot_scatter`` over ``closed_form_basket_weights``.
batch_user_vectors = user_vector_padded
