"""DLRM (Naumov et al., arXiv:1906.00091), the MLPerf Criteo-1TB config.

The port of ``repro/models/dlrm.py``, serving half:

    dense [B, 13] → bottom MLP → [B, 128]
    sparse ids [B, 26] → embedding lookup → [B, 26, 128]
    dot interaction over the 27 vectors → lower triangle (351) ++ dense
    → top MLP → CTR logit.

``serve_step`` runs under ``torch.no_grad()``.  ``loss_fn`` is the
binary cross-entropy of :func:`forward`'s logits against
``batch["labels"]``; ``make_train_step(c, optimizer)`` gives
``train_step(model, batch) -> {"loss"}`` (``common.train_step_of``: the
reference's ``(params, opt_state, batch) -> (params, opt_state,
{"loss"})`` with the model and the optimizer's state updated IN PLACE).

Each entry point takes ``mesh=``, ``rules=``: the parameters are then
DTensors placed by :func:`param_pspecs` (``spmd.shard_module``) and the
batch DTensors or the global values every rank holds.  The lookup is
``embedding.embedding_lookup``'s row-sharded route and its output is
pinned to the batch axes (``common.constrain_batchwise``), as the
reference's ``forward`` does; the MLPs run data-parallel on each rank's
batch block.  :func:`forward` and :func:`serve_step` return DTensors
(the batch over ``common.batch_split``'s axes), the loss the whole
batch's mean on every rank.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.core.types import resolve_device
from repro_torch.models.common import (MLP, apply_mlp, batch_split,
                                       batch_sum, bce_terms,
                                       bce_with_logits, constrain_batchwise,
                                       he_init_, mlp_on, mlp_pspecs,
                                       normal_, row_axes, train_step_of)
from repro_torch.models.embedding import TableSpec, embedding_lookup
from repro_torch.parallel import spmd
from repro_torch.parallel.sharding import MeshShape, ShardingRules, Spec

# Public Criteo-Terabyte per-feature cardinalities (facebookresearch/dlrm).
CRITEO_1TB_VOCABS = (
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771, 25641295,
    39664984, 585935, 12972, 108, 36)


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    """The MLPerf DLRM widths: 13 dense, 26 sparse features, D = 128."""

    name: str = "dlrm-mlperf"
    n_dense: int = 13
    vocab_sizes: tuple = CRITEO_1TB_VOCABS
    embed_dim: int = 128
    bot_mlp: tuple = (512, 256, 128)
    top_mlp: tuple = (1024, 1024, 512, 256, 1)
    dtype: torch.dtype = torch.float32

    @property
    def n_sparse(self) -> int:
        return len(self.vocab_sizes)

    @property
    def table(self) -> TableSpec:
        return TableSpec(self.vocab_sizes, self.embed_dim)

    @property
    def n_interactions(self) -> int:
        f = self.n_sparse + 1
        return f * (f - 1) // 2

    def bot_dims(self) -> list:
        return [self.n_dense, *self.bot_mlp]

    def top_dims(self) -> list:
        return [self.n_interactions + self.embed_dim, *self.top_mlp]

    def n_params(self) -> int:
        n = self.table.padded_rows() * self.embed_dim
        for d in (self.bot_dims(), self.top_dims()):
            n += sum(a * b + b for a, b in zip(d[:-1], d[1:]))
        return n


class DLRM(nn.Module):
    """The concatenated table and the bottom and top MLPs."""

    def __init__(self, c: DLRMConfig, device: Any = None):
        super().__init__()
        device = resolve_device(device)
        self.config = c
        self.table = nn.Parameter(torch.empty(
            (c.table.padded_rows(), c.embed_dim), dtype=c.dtype,
            device=device))
        self.bot = MLP(c.bot_dims(), dtype=c.dtype, device=device)
        self.top = MLP(c.top_dims(), dtype=c.dtype, device=device)


def param_pspecs(c: DLRMConfig, mesh: MeshShape,
                 rules: ShardingRules) -> Dict[str, Spec]:
    """The spec of each parameter, by its name in ``named_parameters``:
    the table's rows over EVERY mesh axis (the classic model-parallel
    embeddings, across pods too) where the devices divide them, else
    over the tensor axis; the MLPs small, replicated."""
    return {"table": Spec(row_axes(c.table.padded_rows(), mesh, rules),
                          None),
            **mlp_pspecs("bot", c.bot_dims()),
            **mlp_pspecs("top", c.top_dims())}


def init_params(c: DLRMConfig, generator: torch.Generator,
                device: Any = None) -> DLRM:
    """A model with an N(0, 1/dim) table and He-initialised MLPs drawn
    from ``generator`` (which must live on ``device``; CUDA unless the
    caller names another)."""
    model = DLRM(c, device)
    normal_(model.table, generator, 1.0 / math.sqrt(c.embed_dim))
    he_init_(model.bot, generator)
    he_init_(model.top, generator)
    return model


def dot_interaction(vectors: torch.Tensor) -> torch.Tensor:
    """vectors [B, F, D] → lower-triangle pairwise dots [B, F(F-1)/2], in
    ``np.tril_indices(F, k=-1)``'s row-major pair order."""
    f = vectors.shape[1]
    z = torch.einsum("bfd,bgd->bfg", vectors, vectors)
    iu, ju = (torch.as_tensor(a, device=vectors.device)
              for a in np.tril_indices(f, k=-1))
    return z[:, iu, ju]


def forward(params: DLRM, batch: Dict[str, torch.Tensor],
            c: DLRMConfig, mesh: Any = None, rules: Any = None) -> Any:
    """batch: {"dense": f32[B, 13], "sparse": int[B, 26]} → logits [B]
    (with a mesh a DTensor)."""
    if mesh is not None:
        logits, vary = _forward_sharded(params, batch, c, mesh, rules)
        return spmd.from_local(logits, mesh, Spec(vary))
    dense = apply_mlp(params.bot, batch["dense"].to(c.dtype))
    sparse = embedding_lookup(params.table, batch["sparse"], c.table)
    return _top(params.top, dense, sparse)


def _top(top: Any, dense: torch.Tensor, sparse: torch.Tensor
         ) -> torch.Tensor:
    feats = torch.cat([dense[:, None, :], sparse], dim=1)      # [B, 27, D]
    top_in = torch.cat([dense, dot_interaction(feats)], dim=-1)
    return apply_mlp(top, top_in)[..., 0]


def _forward_sharded(params: DLRM, batch: Dict[str, Any], c: DLRMConfig,
                     mesh: Any, rules: Any) -> Tuple[torch.Tensor, tuple]:
    """This rank's block of the logits, and the axes the batch is split
    over."""
    b = batch["dense"].shape[0]
    vary = batch_split(mesh, rules, b)
    dense = spmd.enter(batch["dense"], mesh, Spec(vary, None)).to(c.dtype)
    dense = apply_mlp(mlp_on(params.bot, mesh, vary), dense)
    sparse = embedding_lookup(params.table, batch["sparse"], c.table,
                              mesh=mesh, rules=rules)
    sparse = constrain_batchwise(sparse, mesh, rules, b).to_local()
    return _top(mlp_on(params.top, mesh, vary), dense, sparse), vary


def loss_fn(params: DLRM, batch: Dict[str, torch.Tensor],
            c: DLRMConfig, mesh: Any = None, rules: Any = None
            ) -> torch.Tensor:
    """Binary cross-entropy of the logits against ``batch["labels"]``
    [B] (0/1); with a mesh the whole batch's mean on every rank."""
    if mesh is not None:
        logits, vary = _forward_sharded(params, batch, c, mesh, rules)
        labels = spmd.enter(batch["labels"], mesh, Spec(vary))
        return batch_sum(bce_terms(logits, labels), mesh, vary) \
            / batch["labels"].shape[0]
    return bce_with_logits(forward(params, batch, c), batch["labels"])


def make_train_step(c: DLRMConfig, optimizer: torch.optim.Optimizer,
                    mesh: Any = None, rules: Any = None) -> Callable:
    """``train_step(model, batch) -> {"loss"}`` on :func:`loss_fn`."""
    return train_step_of(lambda m, b: loss_fn(m, b, c, mesh, rules),
                         optimizer)


@torch.no_grad()
def serve_step(params: DLRM, batch: Dict[str, torch.Tensor],
               c: DLRMConfig, mesh: Any = None, rules: Any = None) -> Any:
    """Click probabilities [B]: sigmoid of :func:`forward` (with a mesh a
    DTensor)."""
    if mesh is not None:
        logits, vary = _forward_sharded(params, batch, c, mesh, rules)
        return spmd.from_local(torch.sigmoid(logits), mesh, Spec(vary))
    return torch.sigmoid(forward(params, batch, c))
