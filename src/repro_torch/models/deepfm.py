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
Not ported here: the mesh constraints.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.types import resolve_device
from repro_torch.models.common import (MLP, apply_mlp, bce_with_logits,
                                       he_init_, normal_, train_step_of)
from repro_torch.models.embedding import (TableSpec, embedding_lookup,
                                          flat_ids)

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
            c: DeepFMConfig) -> torch.Tensor:
    """batch: {"sparse": int[B, 39]} → logits [B]."""
    ids = batch["sparse"]
    emb = embedding_lookup(params.table, ids, c.table)         # [B, F, K]
    # FM 2nd order: 0.5 * ((Σ v)² − Σ v²) summed over K
    s = torch.sum(emb, dim=1)
    fm2 = 0.5 * torch.sum(torch.square(s)
                          - torch.sum(torch.square(emb), dim=1), dim=-1)
    # FM 1st order (embedding_lookup has checked the ids)
    fm1 = torch.sum(F.embedding(flat_ids(ids, c.table),
                                params.linear[:, None])[..., 0], dim=1)
    deep = apply_mlp(params.deep, emb.reshape(ids.shape[0], -1))[..., 0]
    return fm1 + fm2 + deep + params.bias


def loss_fn(params: DeepFM, batch: Dict[str, torch.Tensor],
            c: DeepFMConfig) -> torch.Tensor:
    """Binary cross-entropy of the logits against ``batch["labels"]``
    [B] (0/1)."""
    return bce_with_logits(forward(params, batch, c), batch["labels"])


def make_train_step(c: DeepFMConfig, optimizer: torch.optim.Optimizer
                    ) -> Callable:
    """``train_step(model, batch) -> {"loss"}`` on :func:`loss_fn`."""
    return train_step_of(lambda m, b: loss_fn(m, b, c), optimizer)


@torch.no_grad()
def serve_step(params: DeepFM, batch: Dict[str, torch.Tensor],
               c: DeepFMConfig) -> torch.Tensor:
    """Click probabilities [B]: sigmoid of :func:`forward`."""
    return torch.sigmoid(forward(params, batch, c))
