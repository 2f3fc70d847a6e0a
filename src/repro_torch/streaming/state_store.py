"""State store for per-user TIFU-kNN state and its serving corpus cache.

The store owns the ``StreamState`` on one device and the materialized
``[n_users, n_items]`` true-value corpus that kNN queries read.  A
micro-batch touches a handful of users; the engine marks those rows
dirty (``invalidate_users``) and ``corpus()`` refreshes only them, or
rebuilds the whole corpus once more than ``corpus_rebuild_frac`` of the
rows are dirty.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Set

import numpy as np
import torch

from repro_torch.core.types import StreamState, resolve_device


@dataclasses.dataclass
class StoreConfig:
    """Shapes and cache policy of one state store."""

    n_users: int
    n_items: int
    max_baskets: int
    max_basket_size: int
    max_groups: Optional[int] = None
    # corpus cache: once more than this fraction of user rows is dirty,
    # one full materialize beats a scattered refresh of most rows
    corpus_rebuild_frac: float = 0.25


def _refresh_corpus_rows(corpus: torch.Tensor, user_vecs: torch.Tensor,
                         uv_scale: torch.Tensor,
                         rows: torch.Tensor) -> torch.Tensor:
    """``corpus[rows] = uv_scale[rows] * user_vecs[rows]``, IN PLACE.

    O(|rows| · n_items); ``rows`` are distinct.
    """
    corpus[rows] = user_vecs[rows] * uv_scale[rows, None]
    return corpus


class StateStore:
    """Owns the StreamState and the serving corpus cache on one device.

    ``device`` defaults to CUDA; without a card that raises (pass
    ``device="cpu"`` to run on the CPU).
    """

    def __init__(self, cfg: StoreConfig, device: Any = None) -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        self.state = StreamState.zeros(
            cfg.n_users, cfg.n_items, cfg.max_baskets, cfg.max_basket_size,
            cfg.max_groups, device=self.device)
        self._corpus: Optional[torch.Tensor] = None
        self._dirty: Set[int] = set()
        self.corpus_full_builds = 0
        self.corpus_rows_refreshed = 0
        self.corpus_threshold_rebuilds = 0

    def invalidate_users(self, users: Any) -> None:
        """Mark user rows of the serving corpus stale.

        The engine calls this after every micro-batch and stability
        refresh with the touched users; O(|users|) set inserts.
        """
        if self._corpus is None:
            return            # no cache yet: the first corpus() builds it
        self._dirty.update(int(x) for x in np.asarray(users).ravel())

    def invalidate_all(self) -> None:
        """Drop the cache entirely (out-of-band state edits)."""
        self._corpus = None
        self._dirty.clear()

    def corpus(self) -> torch.Tensor:
        """The materialized true-value corpus f32[n_users, n_items].

        The first call (or one after ``invalidate_all``) densifies
        everything; later calls refresh only the rows dirtied since the
        last call, IN PLACE, so the returned tensor changes under the
        caller at the next refreshing call.
        """
        if self._corpus is None:
            self._corpus = self.state.materialized_user_vecs()
            self._dirty.clear()
            self.corpus_full_builds += 1
        elif len(self._dirty) > self.cfg.corpus_rebuild_frac \
                * self.cfg.n_users:
            self._corpus = self.state.materialized_user_vecs()
            self._dirty.clear()
            self.corpus_full_builds += 1
            self.corpus_threshold_rebuilds += 1
        elif self._dirty:
            rows = torch.as_tensor(np.fromiter(self._dirty, np.int64,
                                               len(self._dirty)),
                                   device=self.device)
            self.corpus_rows_refreshed += rows.numel()
            _refresh_corpus_rows(self._corpus, self.state.user_vecs,
                                 self.state.uv_scale, rows)
            self._dirty.clear()
        return self._corpus
