"""Two-tower retrieval (Yi et al., RecSys'19; Covington RecSys'16).

The port of ``repro/models/two_tower.py``, serving half.  User tower:
the user's id embedding beside the mean of an embedding bag over the
user's history (a TIFU-style user vector over item embeddings, kept up
to date with Eq. 3/4) → MLP → L2-normalised e_u.  Item tower: id and
category embeddings → MLP → e_i.  ``serve_step`` scores user × item
pairs; ``retrieval_step`` takes one query's top n of a candidate matrix
through ``ops.knn_topk`` with the dot metric (B3 on the card).  Both
run under ``torch.no_grad()``; an index build calls ``item_tower``
inside ``torch.no_grad()``.

Training: ``sampled_softmax_loss`` is the in-batch softmax at
temperature 0.05 with the logQ correction, and ``make_train_step(c,
optimizer)`` gives ``train_step(model, batch) -> {"loss"}``, the port's
form of the reference's ``train_step(params, opt_state, batch) ->
(params, opt_state, {"loss"})``: the model and the optimizer's state
are updated IN PLACE.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Tuple

import torch
from torch import nn

from repro_torch.core.types import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.common import (MLP, apply_mlp, he_init_, normal_,
                                       train_step_of)
from repro_torch.models.embedding import (TableSpec, embedding_bag,
                                          embedding_lookup)


@dataclasses.dataclass(frozen=True)
class TwoTowerConfig:
    """The published two-tower widths (embed_dim 256, towers
    1024-512-256)."""

    name: str = "two-tower-retrieval"
    n_users: int = 5_000_000
    n_items: int = 2_000_000
    n_item_cats: int = 10_000
    hist_len: int = 50
    embed_dim: int = 256
    tower_mlp: tuple = (1024, 512, 256)
    dtype: torch.dtype = torch.float32

    @property
    def user_table(self) -> TableSpec:
        return TableSpec((self.n_users,), self.embed_dim)

    @property
    def item_table(self) -> TableSpec:
        return TableSpec((self.n_items,), self.embed_dim)

    @property
    def cat_table(self) -> TableSpec:
        return TableSpec((self.n_item_cats,), self.embed_dim)

    def tower_dims(self) -> list:
        return [2 * self.embed_dim, *self.tower_mlp]

    def n_params(self) -> int:
        n = (self.user_table.padded_rows() + self.item_table.padded_rows()
             + self.cat_table.padded_rows()) * self.embed_dim
        dims = self.tower_dims()
        return n + 2 * sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))


class TwoTower(nn.Module):
    """The three tables and two tower MLPs."""

    def __init__(self, c: TwoTowerConfig, device: Any = None):
        super().__init__()
        device = resolve_device(device)
        self.config = c
        for name, spec in (("user_emb", c.user_table),
                           ("item_emb", c.item_table),
                           ("cat_emb", c.cat_table)):
            self.register_parameter(name, nn.Parameter(torch.empty(
                (spec.padded_rows(), c.embed_dim), dtype=c.dtype,
                device=device)))
        self.user_mlp = MLP(c.tower_dims(), dtype=c.dtype, device=device)
        self.item_mlp = MLP(c.tower_dims(), dtype=c.dtype, device=device)


def init_params(c: TwoTowerConfig, generator: torch.Generator,
                device: Any = None) -> TwoTower:
    """A model with N(0, 1/dim) tables and He-initialised towers drawn
    from ``generator`` (which must live on ``device``; CUDA unless the
    caller names another)."""
    model = TwoTower(c, device)
    for table in (model.user_emb, model.item_emb, model.cat_emb):
        normal_(table, generator, 1.0 / math.sqrt(c.embed_dim))
    he_init_(model.user_mlp, generator)
    he_init_(model.item_mlp, generator)
    return model


def _normalize(e: torch.Tensor) -> torch.Tensor:
    return e / torch.clamp(torch.linalg.norm(e, dim=-1, keepdim=True),
                           min=1e-6)


def user_tower(params: TwoTower, batch: Dict[str, torch.Tensor],
               c: TwoTowerConfig) -> torch.Tensor:
    """batch: {"user_id": [B], "history": [B, hist_len] (−1 padded)} →
    unit-norm e_u [B, D]."""
    uid = embedding_lookup(params.user_emb, batch["user_id"][:, None],
                           c.user_table)[:, 0, :]
    hist = embedding_bag(params.item_emb, batch["history"][:, None, :],
                         c.item_table, mode="mean")[:, 0, :]
    return _normalize(apply_mlp(params.user_mlp,
                                torch.cat([uid, hist], dim=-1)))


def item_tower(params: TwoTower, batch: Dict[str, torch.Tensor],
               c: TwoTowerConfig) -> torch.Tensor:
    """batch: {"item_id": [B], "item_cat": [B]} → unit-norm e_i [B, D]."""
    iid = embedding_lookup(params.item_emb, batch["item_id"][:, None],
                           c.item_table)[:, 0, :]
    cat = embedding_lookup(params.cat_emb, batch["item_cat"][:, None],
                           c.cat_table)[:, 0, :]
    return _normalize(apply_mlp(params.item_mlp,
                                torch.cat([iid, cat], dim=-1)))


def sampled_softmax_loss(params: TwoTower, batch: Dict[str, torch.Tensor],
                         c: TwoTowerConfig,
                         temperature: float = 0.05) -> torch.Tensor:
    """In-batch softmax: user b's positive is item b, every other item of
    the batch a negative, logits ``e_u·e_i / temperature`` minus
    ``batch["logq"]`` [B] (the sampler's log-probability of each item)
    where given.  The mean over the batch of ``lse − gold``, f32."""
    eu = user_tower(params, batch, c)
    ei = item_tower(params, batch, c)
    logits = (eu @ ei.T).float() / temperature                 # [B, B]
    if "logq" in batch:
        logits = logits - batch["logq"][None, :]
    lse = torch.logsumexp(logits, dim=-1)
    return torch.mean(lse - torch.diagonal(logits))


def make_train_step(c: TwoTowerConfig, optimizer: torch.optim.Optimizer
                    ) -> Callable:
    """``train_step(model, batch) -> {"loss"}`` on
    :func:`sampled_softmax_loss` (see ``common.train_step_of``)."""
    return train_step_of(lambda m, b: sampled_softmax_loss(m, b, c),
                         optimizer)


@torch.no_grad()
def serve_step(params: TwoTower, batch: Dict[str, torch.Tensor],
               c: TwoTowerConfig) -> torch.Tensor:
    """Online scoring: user × item pairs → dot scores [B]."""
    return torch.sum(user_tower(params, batch, c)
                     * item_tower(params, batch, c), dim=-1)


@torch.no_grad()
def retrieval_step(params: TwoTower, batch: Dict[str, torch.Tensor],
                   c: TwoTowerConfig, top_n: int = 100
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """retrieval_cand: the query's top ``top_n`` of ``candidates`` [N, D]
    by dot score, (f32[1, n], i32[1, n]); ties to the lowest row.
    Through ``ops.knn_topk`` (B3 on the card): O(N·D), the [1, N]
    scores never written."""
    eu = user_tower(params, batch, c)                 # [1, D]
    return ops.knn_topk(eu, batch["candidates"], top_n, metric="dot")
