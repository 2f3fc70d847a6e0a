"""State store for per-user TIFU-kNN state and its serving corpus cache.

The store owns the ``StreamState`` on one device and the materialized
``[n_users, n_items]`` true-value corpus that kNN queries read, plus
its int8 quantization for the int8 serving path.  A micro-batch touches
a handful of users; the engine marks those rows dirty
(``invalidate_users``) and ``corpus()`` / ``quantized_corpus()`` each
refresh only them (each cache has its own dirty set), or rebuild
whole once more than ``corpus_rebuild_frac`` of the rows are dirty.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.core.types import StreamState, resolve_device
from repro_torch.optim.compression import (quantize_int8_rows,
                                           quantize_int8_rows_pitched)


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


def _requantize_rows(corpus_q: torch.Tensor, scales: torch.Tensor,
                     corpus: torch.Tensor, rows: torch.Tensor) -> None:
    """Re-quantize exactly ``rows`` of the int8 corpus, IN PLACE.

    Per-row scaling makes a row's ``(q, scale)`` depend on that row
    alone, so this equals a from-scratch quantization.  O(|rows| · I).
    """
    corpus_q[rows], scales[rows] = quantize_int8_rows(corpus[rows])


def _dirty_rows(dirty: Set[int], device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.fromiter(dirty, np.int64, len(dirty)),
                           device=device)


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
        self._corpus_q: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._q_dirty: Set[int] = set()
        self.quant_full_builds = 0
        self.quant_rows_refreshed = 0
        self.quant_threshold_rebuilds = 0

    def invalidate_users(self, users: Any) -> None:
        """Mark user rows of the serving caches stale.

        The engine calls this after every micro-batch and stability
        refresh with the touched users; O(|users|) set inserts into the
        dirty set of each cache that exists.
        """
        if self._corpus is None and self._corpus_q is None:
            return            # no cache yet: the first call builds it
        rows = [int(x) for x in np.asarray(users).ravel()]
        if self._corpus is not None:
            self._dirty.update(rows)
        if self._corpus_q is not None:
            self._q_dirty.update(rows)

    def invalidate_all(self) -> None:
        """Drop both caches entirely (out-of-band state edits)."""
        self._corpus = None
        self._dirty.clear()
        self._corpus_q = None
        self._q_dirty.clear()

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
            rows = _dirty_rows(self._dirty, self.device)
            self.corpus_rows_refreshed += rows.numel()
            _refresh_corpus_rows(self._corpus, self.state.user_vecs,
                                 self.state.uv_scale, rows)
            self._dirty.clear()
        return self._corpus

    def quantized_corpus(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The int8 serving corpus: ``(q int8[M, I], scale f32[M])``.

        ``optim.compression.quantize_int8_rows`` of :meth:`corpus`
        (which this refreshes first), with its own dirty set: the first
        call (or one after ``invalidate_all``, or with more than
        ``corpus_rebuild_frac`` of the rows dirty) quantizes everything,
        later calls re-quantize only the rows dirtied since the last
        call, IN PLACE (same lifetime as :meth:`corpus`).  Either way
        the result equals a from-scratch quantization of ``corpus()``
        bit for bit.  ``q`` is a ``[:, :I]`` view of rows at a 16-byte
        pitch (zero pad columns), which the D-tiled kernel reads as
        16-byte vectors without a copy.
        """
        corpus = self.corpus()
        if self._corpus_q is None or len(self._q_dirty) > \
                self.cfg.corpus_rebuild_frac * self.cfg.n_users:
            if self._corpus_q is not None:
                self.quant_threshold_rebuilds += 1
            self._corpus_q = quantize_int8_rows_pitched(corpus)
            self.quant_full_builds += 1
        elif self._q_dirty:
            rows = _dirty_rows(self._q_dirty, self.device)
            self.quant_rows_refreshed += rows.numel()
            _requantize_rows(*self._corpus_q, corpus, rows)
        self._q_dirty.clear()
        return self._corpus_q
