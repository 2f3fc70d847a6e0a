"""Maintenance rules for time-decayed averages (paper §4.1).

The decaying average of a series ``S = [x_1 .. x_n]`` with decay ``r``
is ``avg_n = (1/n) * sum_i r^(n-i) * x_i``.  The three maintenance
rules work on a series of stacked tensors (``x_i`` of any trailing
shape): ``incremental_add`` (Eq. 3, O(1)), ``decremental_delete``
(Eq. 4, O(n - i): the suffix only) and ``inplace_update`` (Eq. 5,
O(1)); ``decayed_average`` is the from-scratch oracle and
``suffix_coefficients`` expands Eq. 4's suffix term per position.  The
batched update path needs the closed-form suffix coefficients of the
Eq. 4 contraction and the per-update error factors: where the JAX
package vmaps a scalar rule, those take the batch dimension explicitly.
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


def decayed_average(xs: torch.Tensor, r: float) -> torch.Tensor:
    """From-scratch decaying average. ``xs``: [n, ...]; returns [...]."""
    n = xs.shape[0]
    if n == 0:
        raise ValueError("decayed_average of an empty series")
    weights = r ** torch.arange(n - 1, -1, -1, dtype=xs.dtype,
                                device=xs.device)
    return torch.tensordot(weights, xs, dims=([0], [0])) / n


def incremental_add(avg_n, n, x_new, r: float):
    """Eq. 3:  avg_{n+1} = (r * n * avg_n + x_{n+1}) / (n + 1).

    O(1): only the current average, the count and the new element are
    touched.  Exact (no approximation).
    """
    return (r * n * avg_n + x_new) / (n + 1)


def suffix_coefficients(n: int, i: int, r: float,
                        dtype: torch.dtype = torch.float64,
                        device=None) -> torch.Tensor:
    """Coefficients c_t with  D([x_i..x_n])^T R(r, n-i) = sum_t c_t x_t.

    1-based positions; c_t = 0 for t < i, c_i = -r^(n-i),
    c_t = r^(n-t+1) - r^(n-t) for i < t <= n.  Returns [n] in ``dtype``
    (float64 by default, as the reference's numpy default).
    """
    t = torch.arange(1, n + 1, device=device)
    pow_nt = torch.tensor(r, dtype=dtype, device=device) ** (n - t)
    coeff = torch.where(t == i, -pow_nt, pow_nt * (r - 1.0))
    return torch.where(t < i, torch.zeros_like(coeff), coeff)


def decremental_delete(avg_n: torch.Tensor, n: int,
                       xs_suffix: torch.Tensor, i: int,
                       r: float) -> torch.Tensor:
    """Eq. 4: delete the i-th (1-based) element of an n-series.

    ``xs_suffix`` must be the slice ``[x_i .. x_n]`` (length n - i + 1):
    only this suffix is read, O(n - i).  Numerically *unstable*: the
    result multiplies the incoming error by n / ((n-1) r) > 1 (paper
    §6.3).  Deleting the only element returns zeros (callers
    special-case it).  Returns avg'_{n-1}.
    """
    if n <= 1:
        return torch.zeros_like(avg_n)
    m = xs_suffix.shape[0]          # == n - i + 1
    # D = [x_{i+1}-x_i, ..., x_n - x_{n-1}, -x_n]   (length m)
    diffs = torch.cat([xs_suffix[1:] - xs_suffix[:-1], -xs_suffix[-1:]],
                      dim=0)
    # R = [r^(n-i), ..., r, 1]                      (length m)
    decays = torch.tensor(r, dtype=diffs.dtype, device=diffs.device) \
        ** torch.arange(m - 1, -1, -1, device=diffs.device)
    suffix_term = torch.tensordot(decays.to(diffs.dtype), diffs,
                                  dims=([0], [0]))
    return (n * avg_n + suffix_term) / ((n - 1) * r)


def inplace_update(avg_n, n, x_old, x_new, i, r: float):
    """Eq. 5:  avg'_n = avg_n + r^(n-i) (x'_i - x_i) / n.   O(1)."""
    return avg_n + (r ** (n - i)) * (x_new - x_old) / n


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
