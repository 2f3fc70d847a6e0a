"""Embedding tables and EmbeddingBag of the recommender models.

The port of ``repro/models/embedding.py``.  Tables of many features are
concatenated row-wise into ONE ``[padded_rows, dim]`` matrix with
per-feature offsets (``TableSpec``).  A lookup is a row gather; a bag is
a gather plus a masked (weighted) sum over the bag, with −1 as padding.
A bag sum is the r = 1 case of the paper's decayed average, so a user's
bag is maintained under additions and deletions with Eq. 3 and Eq. 4
(``bag_incremental_add``, ``bag_decremental_delete``).

Where ``jnp.take`` reads an out-of-range id without faulting, a CUDA
gather would fault: ``embedding_lookup`` and ``embedding_bag`` raise
:class:`InvalidIdError` on a global row outside ``[0, total_rows)``.
The check reads the ids' extremes back to the host once a call.

The gathers run through ``F.embedding``: its backward sums each row's
gradient by segments of the sorted ids, where the backward of indexing
(``index_put_`` with accumulation) walks a run of equal ids serially,
and a bag's padding (clamped to row 0) makes runs as long as half the
batch.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import decay
from repro_torch.models.common import normal_

PAD = -1    # a bag's padding id


class InvalidIdError(ValueError):
    """An id outside its table was passed to a lookup."""


@dataclasses.dataclass(frozen=True)
class TableSpec:
    """Rows per feature of one concatenated table, and its width."""

    vocab_sizes: tuple        # rows per feature
    dim: int
    dtype: str = "float32"

    @property
    def offsets(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.vocab_sizes)[:-1]])

    @property
    def total_rows(self) -> int:
        return int(np.sum(self.vocab_sizes))

    def padded_rows(self, multiple: int = 1024) -> int:
        t = self.total_rows
        return (t + multiple - 1) // multiple * multiple


def init_table(generator: torch.Generator, spec: TableSpec,
               dtype: torch.dtype = torch.float32,
               device: Any = None) -> torch.Tensor:
    """[padded_rows, dim] of N(0, 1/dim), drawn in f32 from
    ``generator`` on ``device`` (the generator's device by default)."""
    device = generator.device if device is None else device
    t = torch.empty((spec.padded_rows(), spec.dim), dtype=dtype,
                    device=device)
    return normal_(t, generator, 1.0 / math.sqrt(spec.dim))


def flat_ids(ids: torch.Tensor, spec: TableSpec) -> torch.Tensor:
    """Per-feature local ids [B, F] (or [B, F, H]) → global rows, int64."""
    offs = torch.as_tensor(spec.offsets, dtype=torch.int64,
                           device=ids.device)
    if ids.dim() == 2:
        return ids.long() + offs[None, :]
    return ids.long() + offs[None, :, None]


def check_ids(ids: torch.Tensor, hi: int, what: str, lo: int = 0) -> None:
    """Raise :class:`InvalidIdError` unless every id is in [lo, hi)."""
    if ids.numel() == 0:
        return
    mn, mx = (int(v) for v in torch.aminmax(ids.long()))
    if mn < lo or mx >= hi:
        raise InvalidIdError(f"{what}: ids span [{mn}, {mx}], outside "
                             f"[{lo}, {hi})")


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor,
                     spec: TableSpec, chunk: int = 65536) -> torch.Tensor:
    """Single-hot lookup: ids [B, F] → [B, F, dim].

    Batches of more than ``chunk`` rows gather ``chunk`` rows at a time
    into the output (the last chunk may be shorter), the same rows as
    one gather.  Raises on a global row outside ``[0, total_rows)``.
    """
    gids = flat_ids(ids, spec)
    check_ids(gids, spec.total_rows, "embedding_lookup")
    b = ids.shape[0]
    if not chunk or b <= chunk:
        return F.embedding(gids, table)
    out = torch.empty((b, *ids.shape[1:], table.shape[1]), dtype=table.dtype,
                      device=table.device)
    for s in range(0, b, chunk):
        out[s:s + chunk] = F.embedding(gids[s:s + chunk], table)
    return out


def embedding_bag(table: torch.Tensor, ids: torch.Tensor, spec: TableSpec,
                  weights: Optional[torch.Tensor] = None,
                  mode: str = "sum") -> torch.Tensor:
    """Multi-hot bag: ids [B, F, H] (−1 padded) → [B, F, dim].

    Gather plus a masked (weighted) sum over H; ``mode="mean"`` divides
    by the bag's weight (at least 1).  Raises on an id below −1 or a
    global row outside ``[0, total_rows)``.
    """
    gids = flat_ids(torch.clamp(ids, min=0), spec)
    check_ids(torch.where(ids >= 0, gids, ids.long()), spec.total_rows,
              "embedding_bag", lo=PAD)
    emb = F.embedding(gids, table)                        # [B, F, H, dim]
    mask = (ids >= 0).to(emb.dtype)[..., None]
    if weights is not None:
        mask = mask * weights[..., None]
    out = torch.sum(emb * mask, dim=2)
    if mode == "mean":
        out = out / torch.clamp(torch.sum(mask, dim=2), min=1.0)
    return out


def bag_incremental_add(bag_sum, count, new_vec, r: float = 1.0):
    """Paper Eq. 3 applied to a bag (r = 1: a plain running mean): the
    decayed average of a user's interaction embeddings after one more."""
    return decay.incremental_add(bag_sum, count, new_vec, r)


def bag_decremental_delete(bag_avg: torch.Tensor, count: int,
                           suffix_vecs: torch.Tensor, i: int,
                           r: float = 1.0) -> torch.Tensor:
    """Paper Eq. 4 applied to a bag of interaction embeddings: delete
    the i-th (1-based) of ``count``, reading only ``suffix_vecs``."""
    return decay.decremental_delete(bag_avg, count, suffix_vecs, i, r)
