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

Under a mesh (``mesh=``, ``rules=``) the table is a DTensor whose rows
lie over ``common.row_axes``' axes and the ids are split over the batch
axes where they divide the batch (``common.batch_split``; a DTensor or
the global ids every rank holds).  Each rank returns the rows of its
batch block, equal to ``F.embedding`` on the whole table
(:func:`gather_rows`): the ids are all-gathered over the row axes that
also split the batch, each rank takes the rows it owns (zeros
elsewhere), and the partial results are ``psum_scatter``-ed back over
those axes and ``psum``-ed over the other row axes.  Those are JAX's
transposes, so a row's gradient lands on the rank that owns it, summed
over every batch shard.  A bag sums its owned rows on each rank before
the reduction, so only ``[B, F, D]`` crosses ranks, not ``[B, F, H,
D]``.  The id check reduces the ids' extremes over every rank first
(``spmd.pmax``): every rank raises together, or none does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import decay
from repro_torch.models.common import batch_split, normal_
from repro_torch.parallel import spmd
from repro_torch.parallel.sharding import Spec

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


def check_ids(ids: torch.Tensor, hi: int, what: str, lo: int = 0,
              mesh: Any = None) -> None:
    """Raise :class:`InvalidIdError` unless every id is in [lo, hi).
    With a mesh, ``ids`` is this rank's block and the extremes are
    reduced over every rank first, so all ranks raise or none does."""
    if mesh is not None:
        if ids.numel():
            mn, mx = torch.aminmax(ids.long())
        else:
            mn = mx = torch.tensor(lo, device=ids.device)
        ext = spmd.pmax(torch.stack([mx, -mn]), mesh,
                        tuple(mesh.mesh_dim_names))
        mx, mn = int(ext[0]), -int(ext[1])
    elif ids.numel() == 0:
        return
    else:
        mn, mx = (int(v) for v in torch.aminmax(ids.long()))
    if mn < lo or mx >= hi:
        raise InvalidIdError(f"{what}: ids span [{mn}, {mx}], outside "
                             f"[{lo}, {hi})")


def row_block(table: Any, mesh: Any) -> Tuple[torch.Tensor, tuple, int]:
    """(this rank's block, the axes its rows lie over, its first global
    row) of DTensor ``table`` (rows sharded on dim 0 or replicated)."""
    rows = spmd.spec_of(table).axes(0)
    w = table.to_local()
    return w, rows, spmd.axis_index(mesh, rows) * w.shape[0]


def _axes(w: torch.Tensor, rows: tuple, mesh: Any, vary: tuple
          ) -> Tuple[torch.Tensor, tuple, tuple]:
    """(block ``w`` as the batch-varying lookup uses it, the row axes that
    also split the batch, the other row axes): the rows kept whole where
    the batch varies enter through ``pvary``, their gradients summed
    there."""
    share = tuple(a for a in rows if a in vary)
    own = tuple(a for a in rows if a not in vary)
    w = spmd.pvary(w, mesh, tuple(a for a in vary if a not in rows))
    return w, share, own


def _owned(w: torch.Tensor, off: int, g: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rows of block ``w`` (from global row ``off``) named by global
    ids ``g``, and where they are owned."""
    local = g - off
    hit = (local >= 0) & (local < w.shape[0])
    return F.embedding(torch.clamp(local, 0, w.shape[0] - 1), w), hit


def _reduced(part: torch.Tensor, mesh: Any, share: tuple,
             own: tuple) -> torch.Tensor:
    """The partial rows summed over the row axes: ``psum_scatter`` back to
    the batch block over ``share``, ``psum`` over ``own``."""
    if share:
        part = spmd.psum_scatter(part, mesh, share, 0)
    if own:
        part = spmd.psum(part, mesh, own)
    return part


def gather_rows(w: torch.Tensor, rows: tuple, off: int, gids: torch.Tensor,
                mesh: Any, vary: tuple, chunk: int = 0) -> torch.Tensor:
    """``F.embedding(gids, whole table)`` for this rank's batch block
    ``gids`` [b, ...] (global rows, the batch split over ``vary``) from
    the block ``w`` of a table whose rows lie over ``rows`` (``w`` from
    row ``off``; :func:`row_block`).  ``chunk``: rows of the block a step
    (0: all).  See the module docstring for the route; ``gids`` is read
    unchecked."""
    w, share, own = _axes(w, rows, mesh, vary)

    def one(g):
        if share:
            g = spmd.all_gather(g, mesh, share, 0)
        emb, hit = _owned(w, off, g)
        return _reduced(torch.where(hit[..., None], emb, 0), mesh, share,
                        own)
    b = gids.shape[0]
    if not chunk or b <= chunk:
        return one(gids)
    out = torch.empty((b, *gids.shape[1:], w.shape[1]), dtype=w.dtype,
                      device=w.device)
    for s in range(0, b, chunk):
        out[s:s + chunk] = one(gids[s:s + chunk])
    return out


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor,
                     spec: TableSpec, chunk: int = 65536, mesh: Any = None,
                     rules: Any = None) -> torch.Tensor:
    """Single-hot lookup: ids [B, F] → [B, F, dim].

    Batches of more than ``chunk`` rows gather ``chunk`` rows at a time
    into the output (the last chunk may be shorter), the same rows as
    one gather.  Raises on a global row outside ``[0, total_rows)``.
    With a mesh (``table`` a DTensor): a DTensor [B, F, dim], this rank's
    batch block over ``common.batch_split``'s axes (module docstring).
    """
    if mesh is not None:
        vary = batch_split(mesh, rules, ids.shape[0])
        gids = flat_ids(spmd.enter(ids, mesh, Spec(vary, None)), spec)
        check_ids(gids, spec.total_rows, "embedding_lookup", mesh=mesh)
        out = gather_rows(*row_block(table, mesh), gids, mesh, vary, chunk)
        return spmd.from_local(out, mesh, Spec(vary, None, None))
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
                  mode: str = "sum", mesh: Any = None,
                  rules: Any = None) -> torch.Tensor:
    """Multi-hot bag: ids [B, F, H] (−1 padded) → [B, F, dim].

    Gather plus a masked (weighted) sum over H; ``mode="mean"`` divides
    by the bag's weight (at least 1).  Raises on an id below −1 or a
    global row outside ``[0, total_rows)``.  With a mesh (``table`` a
    DTensor; ``weights``, where given, laid out as ``ids``): a DTensor
    [B, F, dim] of this rank's batch block, each rank's owned rows summed
    over H before the reduction over the row axes.
    """
    if mesh is not None:
        return _bag_sharded(table, ids, spec, weights, mode, mesh, rules)
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


def _bag_sharded(table: Any, ids: Any, spec: TableSpec,
                 weights: Optional[Any], mode: str, mesh: Any,
                 rules: Any) -> Any:
    vary = batch_split(mesh, rules, ids.shape[0])
    bspec = Spec(vary, None, None)
    ids = spmd.enter(ids, mesh, bspec)
    gids = flat_ids(torch.clamp(ids, min=0), spec)
    check_ids(torch.where(ids >= 0, gids, ids.long()), spec.total_rows,
              "embedding_bag", lo=PAD, mesh=mesh)
    w, rows, off = row_block(table, mesh)
    w, share, own = _axes(w, rows, mesh, vary)
    mask = (ids >= 0).to(w.dtype)
    if weights is not None:
        mask = mask * spmd.enter(weights, mesh, bspec)
    g, m = gids, mask
    if share:
        g = spmd.all_gather(g, mesh, share, 0)
        m = spmd.all_gather(m, mesh, share, 0)
    emb, hit = _owned(w, off, g)
    part = torch.sum(emb * (m * hit.to(w.dtype))[..., None], dim=2)
    out = _reduced(part, mesh, share, own)
    if mode == "mean":
        out = out / torch.clamp(torch.sum(mask, dim=2), min=1.0)[..., None]
    return spmd.from_local(out, mesh, bspec)


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
