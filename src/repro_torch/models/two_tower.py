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

Each entry point takes ``mesh=``, ``rules=`` (DTensor parameters by
:func:`param_pspecs`; the batch DTensors or the global values every
rank holds): the towers' lookups and the history's bag run
``embedding``'s row-sharded routes on each rank's batch block.  The
in-batch softmax stays the GLOBAL batch's: each rank scores its users
against every item of the batch (the item tower's rows all-gathered over
the batch axes, the logQ correction indexed globally), so a rank sees
all B − 1 negatives, not only its block's.  ``retrieval_step`` runs B3
on each rank's block of ``candidates`` (its rows over the tensor axis),
offsets the ids by ``axis_index · N_local`` and merges the ranks' lists
(``common.merge_topk_over``: ties to the lowest global id).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Tuple

import torch
from torch import nn

from repro_torch.core.types import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.common import (MLP, apply_mlp, batch_split,
                                       batch_sum, he_init_, mlp_on,
                                       mlp_pspecs, normal_, row_axes,
                                       sharded_retrieval, train_step_of)
from repro_torch.models.embedding import (TableSpec, embedding_bag,
                                          embedding_lookup)
from repro_torch.parallel import spmd
from repro_torch.parallel.sharding import MeshShape, ShardingRules, Spec


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


def param_pspecs(c: TwoTowerConfig, mesh: MeshShape,
                 rules: ShardingRules) -> Dict[str, Spec]:
    """The spec of each parameter, by its name in ``named_parameters``:
    each table's rows as DLRM's, the towers replicated."""
    return {"user_emb": Spec(row_axes(c.user_table.padded_rows(), mesh,
                                      rules), None),
            "item_emb": Spec(row_axes(c.item_table.padded_rows(), mesh,
                                      rules), None),
            "cat_emb": Spec(row_axes(c.cat_table.padded_rows(), mesh,
                                     rules), None),
            **mlp_pspecs("user_mlp", c.tower_dims()),
            **mlp_pspecs("item_mlp", c.tower_dims())}


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


def _dt(x: torch.Tensor, mesh: Any, vary: tuple) -> Any:
    """Batch block ``x`` as a DTensor."""
    return spmd.from_local(x, mesh, Spec(vary, *([None] * (x.dim() - 1))))


def _ids(batch: Dict[str, Any], key: str, mesh: Any, vary: tuple) -> Any:
    """Ids ``batch[key]`` [B] or [B, H] as the one-feature lookup's [B,
    1] or the bag's [B, 1, H] (a DTensor of the batch block with a
    mesh)."""
    x = batch[key]
    if mesh is None:
        return x[:, None]
    block = spmd.enter(x, mesh, Spec(vary, *([None] * (x.dim() - 1))))
    return _dt(block[:, None], mesh, vary)


def user_tower(params: TwoTower, batch: Dict[str, torch.Tensor],
               c: TwoTowerConfig, mesh: Any = None, rules: Any = None
               ) -> Any:
    """batch: {"user_id": [B], "history": [B, hist_len] (−1 padded)} →
    unit-norm e_u [B, D] (with a mesh a DTensor of the batch block)."""
    vary = None if mesh is None else batch_split(mesh, rules,
                                                 batch["user_id"].shape[0])
    e = _user_tower(params, batch, c, mesh, rules, vary)
    return e if mesh is None else _dt(e, mesh, vary)


def _user_tower(params: TwoTower, batch: Dict[str, Any], c: TwoTowerConfig,
                mesh: Any, rules: Any, vary: tuple) -> torch.Tensor:
    kw = {} if mesh is None else {"mesh": mesh, "rules": rules}
    uid = spmd.local(embedding_lookup(
        params.user_emb, _ids(batch, "user_id", mesh, vary), c.user_table,
        **kw))[:, 0, :]
    hist = spmd.local(embedding_bag(
        params.item_emb, _ids(batch, "history", mesh, vary), c.item_table,
        mode="mean", **kw))[:, 0, :]
    mlp = params.user_mlp if mesh is None else mlp_on(params.user_mlp,
                                                      mesh, vary)
    return _normalize(apply_mlp(mlp, torch.cat([uid, hist], dim=-1)))


def item_tower(params: TwoTower, batch: Dict[str, torch.Tensor],
               c: TwoTowerConfig, mesh: Any = None, rules: Any = None
               ) -> Any:
    """batch: {"item_id": [B], "item_cat": [B]} → unit-norm e_i [B, D]
    (with a mesh a DTensor of the batch block)."""
    vary = None if mesh is None else batch_split(mesh, rules,
                                                 batch["item_id"].shape[0])
    e = _item_tower(params, batch, c, mesh, rules, vary)
    return e if mesh is None else _dt(e, mesh, vary)


def _item_tower(params: TwoTower, batch: Dict[str, Any], c: TwoTowerConfig,
                mesh: Any, rules: Any, vary: tuple) -> torch.Tensor:
    kw = {} if mesh is None else {"mesh": mesh, "rules": rules}
    iid = spmd.local(embedding_lookup(
        params.item_emb, _ids(batch, "item_id", mesh, vary), c.item_table,
        **kw))[:, 0, :]
    cat = spmd.local(embedding_lookup(
        params.cat_emb, _ids(batch, "item_cat", mesh, vary), c.cat_table,
        **kw))[:, 0, :]
    mlp = params.item_mlp if mesh is None else mlp_on(params.item_mlp,
                                                      mesh, vary)
    return _normalize(apply_mlp(mlp, torch.cat([iid, cat], dim=-1)))


def sampled_softmax_loss(params: TwoTower, batch: Dict[str, torch.Tensor],
                         c: TwoTowerConfig, temperature: float = 0.05,
                         mesh: Any = None, rules: Any = None
                         ) -> torch.Tensor:
    """In-batch softmax: user b's positive is item b, every other item of
    the batch a negative, logits ``e_u·e_i / temperature`` minus
    ``batch["logq"]`` [B] (the sampler's log-probability of each item)
    where given.  The mean over the batch of ``lse − gold``, f32.  With a
    mesh each rank's users against every item of the global batch: the
    same loss on every rank."""
    b = batch["item_id"].shape[0]
    vary = () if mesh is None else batch_split(mesh, rules, b)
    eu = _user_tower(params, batch, c, mesh, rules, vary)
    ei = _item_tower(params, batch, c, mesh, rules, vary)
    if vary:
        ei = spmd.all_gather(ei, mesh, vary, 0)                # [B, D]
    logits = (eu @ ei.T).float() / temperature                 # [b, B]
    if "logq" in batch:
        logq = batch["logq"] if mesh is None \
            else spmd.enter(batch["logq"], mesh, Spec(None))
        logits = logits - logq[None, :]
    lse = torch.logsumexp(logits, dim=-1)
    if mesh is None:
        return torch.mean(lse - torch.diagonal(logits))
    rows = torch.arange(eu.shape[0], device=eu.device)
    off = spmd.axis_index(mesh, vary) * eu.shape[0]
    return batch_sum(lse - logits[rows, rows + off], mesh, vary) / b


def make_train_step(c: TwoTowerConfig, optimizer: torch.optim.Optimizer,
                    mesh: Any = None, rules: Any = None) -> Callable:
    """``train_step(model, batch) -> {"loss"}`` on
    :func:`sampled_softmax_loss` (see ``common.train_step_of``)."""
    return train_step_of(
        lambda m, b: sampled_softmax_loss(m, b, c, mesh=mesh, rules=rules),
        optimizer)


@torch.no_grad()
def serve_step(params: TwoTower, batch: Dict[str, torch.Tensor],
               c: TwoTowerConfig, mesh: Any = None, rules: Any = None
               ) -> Any:
    """Online scoring: user × item pairs → dot scores [B] (with a mesh a
    DTensor of the batch block)."""
    if mesh is None:
        return torch.sum(user_tower(params, batch, c)
                         * item_tower(params, batch, c), dim=-1)
    vary = batch_split(mesh, rules, batch["user_id"].shape[0])
    s = torch.sum(_user_tower(params, batch, c, mesh, rules, vary)
                  * _item_tower(params, batch, c, mesh, rules, vary), dim=-1)
    return _dt(s, mesh, vary)


@torch.no_grad()
def retrieval_step(params: TwoTower, batch: Dict[str, torch.Tensor],
                   c: TwoTowerConfig, top_n: int = 100, mesh: Any = None,
                   rules: Any = None) -> Tuple[Any, Any]:
    """retrieval_cand: the query's top ``top_n`` of ``candidates`` [N, D]
    by dot score, (f32[1, n], i32[1, n]); ties to the lowest row.
    Through ``ops.knn_topk`` (B3 on the card): O(N·D), the [1, N]
    scores never written.  With a mesh: B3 on each rank's block of the
    candidates' rows (over the tensor axis), the lists merged (module
    docstring); DTensors."""
    if mesh is None:
        eu = user_tower(params, batch, c)                 # [1, D]
        return ops.knn_topk(eu, batch["candidates"], top_n, metric="dot")
    vary = batch_split(mesh, rules, batch["user_id"].shape[0])
    eu = _user_tower(params, batch, c, mesh, rules, vary)
    return sharded_retrieval(eu, batch["candidates"], top_n, mesh, rules,
                             vary)

