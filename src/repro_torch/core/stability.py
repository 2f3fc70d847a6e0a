"""Numerical-stability threshold for decremental updates (beyond-paper).

Each engine keeps a per-user worst-case error multiplier ``err_mult``;
users whose bound ``err_mult · eps`` exceeds a target relative error
are recomputed from their history (``core.updates.refresh_users``).
"""
from __future__ import annotations

import numpy as np


def refresh_threshold(target_rel_err: float = 1e-2,
                      eps: float = float(np.finfo(np.float32).eps)) -> float:
    """``err_mult`` above which a user is refreshed from scratch."""
    return target_rel_err / eps
