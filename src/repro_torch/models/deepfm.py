"""DeepFM (Guo et al., arXiv:1703.04247).

The port of ``repro/models/deepfm.py``, serving half: 39 categorical
fields, embed_dim 10; the FM's second-order term by the
sum-square / square-sum identity, its first-order term from a per-row
linear weight, and a deep MLP 400-400-400 over the concatenated field
embeddings; the logits summed.

``serve_step`` runs under ``torch.no_grad()``.  ``loss_fn`` is the
binary cross-entropy of :func:`forward`'s logits against
``batch["labels"]``; ``make_train_step(c, optimizer)`` gives
``train_step(model, batch) -> {"loss"}`` (``common.train_step_of``).

With ``mesh=``, ``rules=`` (DTensor parameters by :func:`param_pspecs`):
the field table's and the first-order weights' lookups run
``embedding``'s row-sharded route, the embeddings are pinned to the
batch axes (``common.constrain_batchwise``), as the reference pins
them, and the rest runs on each rank's batch block; as DLRM's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.types import resolve_device
from repro_torch.models.common import (MLP, apply_mlp, batch_split,
                                       batch_sum, bce_terms,
                                       bce_with_logits, constrain_batchwise,
                                       he_init_, mlp_on, mlp_pspecs,
                                       normal_, row_axes, train_step_of,
                                       whole)
from repro_torch.models.embedding import (TableSpec, embedding_lookup,
                                          flat_ids, gather_rows, row_block)
from repro_torch.parallel import spmd
from repro_torch.parallel.sharding import MeshShape, ShardingRules, Spec

# Criteo-Kaggle style field cardinalities for 39 fields (13 bucketised
# numeric + 26 categorical, hashed): the public DeepFM setup.
DEEPFM_VOCABS = tuple([64] * 13 + [
    1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145, 5683,
    8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4, 7046547, 18, 15,
    286181, 105, 142572])


@dataclasses.dataclass(frozen=True)
class DeepFMConfig:
    """The published DeepFM widths: 39 fields, D = 10, MLP 400-400-400."""

    name: str = "deepfm"
    vocab_sizes: tuple = DEEPFM_VOCABS
    embed_dim: int = 10
    mlp: tuple = (400, 400, 400)
    dtype: torch.dtype = torch.float32

    @property
    def n_fields(self) -> int:
        return len(self.vocab_sizes)

    @property
    def table(self) -> TableSpec:
        return TableSpec(self.vocab_sizes, self.embed_dim)

    def deep_dims(self) -> list:
        return [self.n_fields * self.embed_dim, *self.mlp, 1]

    def n_params(self) -> int:
        n = self.table.padded_rows() * (self.embed_dim + 1)
        dims = self.deep_dims()
        return n + sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))


class DeepFM(nn.Module):
    """The field table, the first-order weights, the deep MLP and the
    global bias."""

    def __init__(self, c: DeepFMConfig, device: Any = None):
        super().__init__()
        device = resolve_device(device)
        self.config = c
        rows = c.table.padded_rows()
        like = dict(dtype=c.dtype, device=device)
        self.table = nn.Parameter(torch.empty((rows, c.embed_dim), **like))
        self.linear = nn.Parameter(torch.empty((rows,), **like))
        self.deep = MLP(c.deep_dims(), dtype=c.dtype, device=device)
        self.bias = nn.Parameter(torch.zeros((), **like))


def param_pspecs(c: DeepFMConfig, mesh: MeshShape,
                 rules: ShardingRules) -> Dict[str, Spec]:
    """The spec of each parameter, by its name in ``named_parameters``:
    the table's and the first-order weights' rows as DLRM's, the deep
    MLP and the bias replicated."""
    rows = row_axes(c.table.padded_rows(), mesh, rules)
    return {"table": Spec(rows, None), "linear": Spec(rows),
            **mlp_pspecs("deep", c.deep_dims()), "bias": Spec()}


def init_params(c: DeepFMConfig, generator: torch.Generator,
                device: Any = None) -> DeepFM:
    """A model with an N(0, 1/dim) table, N(0, 1e-4) first-order weights,
    a He-initialised MLP and a zero bias, drawn from ``generator``
    (which must live on ``device``; CUDA unless the caller names
    another)."""
    model = DeepFM(c, device)
    normal_(model.table, generator, 1.0 / math.sqrt(c.embed_dim))
    normal_(model.linear, generator, 0.01)
    he_init_(model.deep, generator)
    return model


def forward(params: DeepFM, batch: Dict[str, torch.Tensor],
            c: DeepFMConfig, mesh: Any = None, rules: Any = None) -> Any:
    """batch: {"sparse": int[B, 39]} → logits [B] (with a mesh a
    DTensor)."""
    if mesh is not None:
        logits, vary = _forward_sharded(params, batch, c, mesh, rules)
        return spmd.from_local(logits, mesh, Spec(vary))
    ids = batch["sparse"]
    emb = embedding_lookup(params.table, ids, c.table)         # [B, F, K]
    # FM 1st order (embedding_lookup has checked the ids)
    fm1 = torch.sum(F.embedding(flat_ids(ids, c.table),
                                params.linear[:, None])[..., 0], dim=1)
    return _logits(emb, fm1, params.deep, params.bias)


def _logits(emb: torch.Tensor, fm1: torch.Tensor, deep: Any,
            bias: torch.Tensor) -> torch.Tensor:
    # FM 2nd order: 0.5 * ((Σ v)² − Σ v²) summed over K
    s = torch.sum(emb, dim=1)
    fm2 = 0.5 * torch.sum(torch.square(s)
                          - torch.sum(torch.square(emb), dim=1), dim=-1)
    out = apply_mlp(deep, emb.reshape(emb.shape[0], -1))[..., 0]
    return fm1 + fm2 + out + bias


def _forward_sharded(params: DeepFM, batch: Dict[str, Any],
                     c: DeepFMConfig, mesh: Any, rules: Any
                     ) -> Tuple[torch.Tensor, tuple]:
    """This rank's block of the logits, and the axes the batch is split
    over."""
    b = batch["sparse"].shape[0]
    vary = batch_split(mesh, rules, b)
    emb = embedding_lookup(params.table, batch["sparse"], c.table,
                           mesh=mesh, rules=rules)
    emb = constrain_batchwise(emb, mesh, rules, b).to_local()
    gids = flat_ids(spmd.enter(batch["sparse"], mesh, Spec(vary, None)),
                    c.table)
    w, rows, off = row_block(params.linear, mesh)
    fm1 = torch.sum(gather_rows(w[:, None], rows, off, gids, mesh, vary
                                )[..., 0], dim=1)
    return _logits(emb, fm1, mlp_on(params.deep, mesh, vary),
                   whole(params.bias, mesh, vary)), vary


def loss_fn(params: DeepFM, batch: Dict[str, torch.Tensor],
            c: DeepFMConfig, mesh: Any = None, rules: Any = None
            ) -> torch.Tensor:
    """Binary cross-entropy of the logits against ``batch["labels"]``
    [B] (0/1); with a mesh the whole batch's mean on every rank."""
    if mesh is not None:
        logits, vary = _forward_sharded(params, batch, c, mesh, rules)
        labels = spmd.enter(batch["labels"], mesh, Spec(vary))
        return batch_sum(bce_terms(logits, labels), mesh, vary) \
            / batch["labels"].shape[0]
    return bce_with_logits(forward(params, batch, c), batch["labels"])


def make_train_step(c: DeepFMConfig, optimizer: torch.optim.Optimizer,
                    mesh: Any = None, rules: Any = None) -> Callable:
    """``train_step(model, batch) -> {"loss"}`` on :func:`loss_fn`."""
    return train_step_of(lambda m, b: loss_fn(m, b, c, mesh, rules),
                         optimizer)


@torch.no_grad()
def serve_step(params: DeepFM, batch: Dict[str, torch.Tensor],
               c: DeepFMConfig, mesh: Any = None, rules: Any = None) -> Any:
    """Click probabilities [B]: sigmoid of :func:`forward` (with a mesh a
    DTensor)."""
    if mesh is not None:
        logits, vary = _forward_sharded(params, batch, c, mesh, rules)
        return spmd.from_local(torch.sigmoid(logits), mesh, Spec(vary))
    return torch.sigmoid(forward(params, batch, c))
