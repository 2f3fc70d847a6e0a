"""User-axis partitioning contract of the sharded deployment.

A copy of ``UserShardSpec`` from the JAX package's
``parallel/sharding.py`` (whose module imports JAX for its mesh rules,
which the port does not use).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class UserShardSpec:
    """Round-robin assignment of users to shards.

    Global user ``u`` lives on shard ``u % n_shards`` at local row
    ``u // n_shards``: a bijection between global ids and ``(shard,
    row)`` pairs, stable as ``n_users`` grows, with shard sizes that
    differ by at most one row.  Interleaving the ids is what lets
    per-shard candidate lists merge with a single corpus's tie-break
    order (``core.knn.sharded_recommend_for_users``).
    """

    n_users: int
    n_shards: int

    def __post_init__(self) -> None:
        if self.n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {self.n_shards}")
        if self.n_users < 1:
            raise ValueError(f"n_users must be >= 1, got {self.n_users}")

    def shard_of(self, user):
        """Owning shard of global user id(s) ``user`` (int or array)."""
        return user % self.n_shards

    def local_row(self, user):
        """Local state-store row of global user id(s) ``user``."""
        return user // self.n_shards

    def global_user(self, shard, row):
        """Inverse mapping: global id of local ``row`` on ``shard``."""
        return row * self.n_shards + shard

    def shard_users(self, shard: int) -> int:
        """Number of users owned by ``shard`` (its state-store size)."""
        return (self.n_users - shard + self.n_shards - 1) // self.n_shards

    def owned_users(self, shard: int) -> np.ndarray:
        """Global ids owned by ``shard``, in local-row order."""
        return np.arange(shard, self.n_users, self.n_shards)
