"""Numerical-stability tracking for decremental updates (beyond-paper).

Each decremental group-vanish update (Eq. 12) scales the user vector's
error by ``alpha = k / ((k-1) r_g) > 1`` (paper §6.3).  Each engine keeps
a per-user worst-case error multiplier ``err_mult``; users whose bound
``err_mult · eps`` exceeds a target relative error are recomputed from
their history (``core.updates.refresh_users``).  ``deletion_budget``
says how many such deletions a target allows, ``max_error_growth`` the
multiplier after ``n`` of them.
"""
from __future__ import annotations

import numpy as np
import torch


def deletion_budget(k_groups: int, r_g: float, target_rel_err: float,
                    eps: float) -> int:
    """Consecutive group-vanish deletions until the worst-case relative
    error bound crosses ``target_rel_err``.

    err_n = eps · alpha^n with alpha = k/((k-1) r_g), so
    n = floor(log(target/eps) / log(alpha)); no limit (the largest
    int64) where alpha <= 1.
    """
    alpha = k_groups / ((k_groups - 1.0) * r_g)
    if alpha <= 1.0:
        return np.iinfo(np.int64).max
    return int(np.floor(np.log(target_rel_err / eps) / np.log(alpha)))


def users_needing_refresh(err_mult, target_rel_err: float = 1e-2,
                          eps: float = float(np.finfo(np.float32).eps)):
    """Boolean mask of users whose error bound crossed the target.

    ``err_mult`` a tensor (the mask is a tensor on its device) or a numpy
    array.
    """
    return err_mult * eps > target_rel_err


def refresh_threshold(target_rel_err: float = 1e-2,
                      eps: float = float(np.finfo(np.float32).eps)) -> float:
    """``err_mult`` above which a user is refreshed from scratch."""
    return target_rel_err / eps


def max_error_growth(n_deletions, k_groups, r_g):
    """Worst-case error multiplier after ``n_deletions`` consecutive
    group-vanish deletions, alpha^n.

    Tensor arguments give a float32 tensor (as the JAX package's float32
    ``jnp.power``); numpy arrays and Python numbers give float64 numpy.
    """
    alpha = k_groups / ((k_groups - 1.0) * r_g)
    tensors = [x for x in (n_deletions, k_groups, r_g)
               if isinstance(x, torch.Tensor)]
    if tensors:
        f32 = dict(dtype=torch.float32, device=tensors[0].device)
        return torch.pow(torch.as_tensor(alpha, **f32),
                         torch.as_tensor(n_deletions, **f32))
    return np.power(alpha, n_deletions)
