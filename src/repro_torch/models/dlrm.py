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
Not ported here: the mesh constraints.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict

import numpy as np
import torch
from torch import nn

from repro_torch.core.types import resolve_device
from repro_torch.models.common import (MLP, apply_mlp, bce_with_logits,
                                       he_init_, normal_, train_step_of)
from repro_torch.models.embedding import TableSpec, embedding_lookup

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
            c: DLRMConfig) -> torch.Tensor:
    """batch: {"dense": f32[B, 13], "sparse": int[B, 26]} → logits [B]."""
    dense = apply_mlp(params.bot, batch["dense"].to(c.dtype))
    sparse = embedding_lookup(params.table, batch["sparse"], c.table)
    feats = torch.cat([dense[:, None, :], sparse], dim=1)      # [B, 27, D]
    top_in = torch.cat([dense, dot_interaction(feats)], dim=-1)
    return apply_mlp(params.top, top_in)[..., 0]


def loss_fn(params: DLRM, batch: Dict[str, torch.Tensor],
            c: DLRMConfig) -> torch.Tensor:
    """Binary cross-entropy of the logits against ``batch["labels"]``
    [B] (0/1)."""
    return bce_with_logits(forward(params, batch, c), batch["labels"])


def make_train_step(c: DLRMConfig, optimizer: torch.optim.Optimizer
                    ) -> Callable:
    """``train_step(model, batch) -> {"loss"}`` on :func:`loss_fn`."""
    return train_step_of(lambda m, b: loss_fn(m, b, c), optimizer)


@torch.no_grad()
def serve_step(params: DLRM, batch: Dict[str, torch.Tensor],
               c: DLRMConfig) -> torch.Tensor:
    """Click probabilities [B]: sigmoid of :func:`forward`."""
    return torch.sigmoid(forward(params, batch, c))
