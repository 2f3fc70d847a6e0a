"""Maintenance rules for time-decayed averages (paper §4.1), batched.

Only the pieces the batched update path needs: the closed-form suffix
coefficients of the Eq. 4 contraction and the per-update error factors.
Where the JAX package vmaps a scalar rule, these take the batch
dimension explicitly.
"""
from __future__ import annotations

import torch


def f32(x: float, device) -> torch.Tensor:
    """A float32 0-dim tensor (the counterpart of ``jnp.asarray(x, f32)``,
    so products with it round in float32, not float64)."""
    return torch.tensor(x, dtype=torch.float32, device=device)


def fpow(base: torch.Tensor, exp: torch.Tensor) -> torch.Tensor:
    """``base ** exp`` in float32 for a 0-dim float32 base and an
    integer exponent tensor."""
    return torch.pow(base, exp.to(torch.float32))


def batched_suffix_coefficients(n: torch.Tensor, i: torch.Tensor, r: float,
                                length: int) -> torch.Tensor:
    """Eq. 4 suffix coefficients per row over positions t = 1..length.

    ``n``, ``i``: i[U] series lengths and 1-based deleted positions.
    Returns f32[U, length]: c_i = -r^(n-i), c_t = r^(n-t)·(r-1) for
    i < t <= n, zero elsewhere.
    """
    t = torch.arange(1, length + 1, device=n.device)[None, :]
    pow_nt = fpow(f32(r, n.device), n[:, None] - t)
    coeff = torch.where(t == i[:, None], -pow_nt, pow_nt * (r - 1.0))
    return torch.where((t < i[:, None]) | (t > n[:, None]),
                       torch.zeros_like(coeff), coeff)


def error_growth_factor(n, r: float):
    """Worst-case error factor of one decremental update, n/((n-1)·r)."""
    return n / ((n - 1.0) * r)


def error_shrink_factor(n, r: float):
    """Error factor of one incremental update: r n / (n+1) < 1."""
    return r * n / (n + 1.0)
