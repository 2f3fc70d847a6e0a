"""Shared building blocks of the recommender models (the PyTorch port).

The port of ``repro/models/common.py``: an MLP whose layers hold
``x @ w + b`` in the JAX package's layout, the binary cross-entropy on
logits, batch chunking for bulk scoring, and layer norm with the
population variance (``jnp.var``; ``torch.var`` defaults to the
unbiased one).

Every model's parameters are trainable (``requires_grad``).  Their
initialisers write them IN PLACE under ``torch.no_grad()``, and every
serving entry point runs under ``torch.no_grad()``, so serving records
no autograd graph.

Under a mesh (a named ``DeviceMesh`` and ``ShardingRules``), a
recommender's sharded route runs each rank on its block of the batch:
the rows over the batch axes where they divide the batch
(:func:`batch_split`), else the whole batch on every rank.  The values
then vary over those axes only and are the same on every rank of the
others, so a cotangent is per-rank partial over the batch axes and whole
over the rest: a replicated parameter enters through ``spmd.pvary`` over
the batch axes (:func:`whole`: its gradient summed over them), and a
loss is the ``psum`` over them of the ranks' partial sums
(:func:`batch_sum`).  :func:`constrain_batchwise` is the reference's
``_constrain_batchwise``, :func:`merge_topk_over` the merge of each
rank's top-k over a mesh axis.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.types import resolve_device
from repro_torch.parallel import spmd
from repro_torch.parallel.sharding import (MeshShape, ShardingRules, Spec,
                                           batch_axes)


class MLP(nn.Module):
    """The weights of layers ``x @ w[i] + b[i]`` (``w[i]`` is [in, out]
    as in JAX); :func:`apply_mlp` runs them.  On ``device``: CUDA unless
    the caller names another."""

    def __init__(self, dims: Sequence[int], bias: bool = True,
                 dtype: torch.dtype = torch.float32, device: Any = None):
        super().__init__()
        device = resolve_device(device)
        self.w = nn.ParameterList(
            nn.Parameter(torch.zeros((a, b), dtype=dtype, device=device))
            for a, b in zip(dims[:-1], dims[1:]))
        self.b = nn.ParameterList(
            nn.Parameter(torch.zeros((b,), dtype=dtype, device=device))
            for b in dims[1:]) if bias else None


@torch.no_grad()
def normal_(p: torch.Tensor, generator: torch.Generator,
            std: float) -> torch.Tensor:
    """Fill ``p`` IN PLACE with N(0, std²) drawn in f32 from
    ``generator`` (on ``p``'s device); an f32 ``p`` takes no temporary."""
    if p.dtype == torch.float32:
        # out= takes no tensor that requires grad: write through a view
        torch.randn(p.shape, generator=generator, device=p.device,
                    out=p.detach())
        return p.mul_(std)
    return p.copy_(torch.randn(p.shape, generator=generator,
                               device=p.device) * std)


@torch.no_grad()
def he_init_(mlp: MLP, generator: torch.Generator) -> MLP:
    """Weights N(0, 2/in) from ``generator`` (He init), biases zero, IN
    PLACE."""
    for w in mlp.w:
        normal_(w, generator, math.sqrt(2.0 / w.shape[0]))
    for b in mlp.b if mlp.b is not None else ():
        b.zero_()
    return mlp


def init_mlp(generator: torch.Generator, dims: Sequence[int],
             dtype: torch.dtype = torch.float32, bias: bool = True,
             device: Any = None) -> MLP:
    """dims = [in, h1, ..., out]: weights N(0, 2/in) drawn in f32 from
    ``generator`` (He init), biases zero, on ``device`` (CUDA unless the
    caller names another; ``generator`` must live there)."""
    return he_init_(MLP(dims, bias, dtype, device), generator)


def apply_mlp(mlp: MLP, x: torch.Tensor, act: Callable = F.relu,
              final_act: Optional[Callable] = None) -> torch.Tensor:
    """``act`` between layers, ``final_act`` (if any) after the last."""
    n = len(mlp.w)
    for i, w in enumerate(mlp.w):
        x = x @ w
        if mlp.b is not None:
            x = x + mlp.b[i]
        if i < n - 1:
            x = act(x)
        elif final_act is not None:
            x = final_act(x)
    return x


def mlp_shapes(dims: Sequence[int], bias: bool = True) -> List[Dict]:
    """Shapes of each layer's ``{"w", "b"}``."""
    return [{"w": (a, b), "b": (b,)} if bias else {"w": (a, b)}
            for a, b in zip(dims[:-1], dims[1:])]


def replicated(shape: Sequence[int]) -> Spec:
    """The spec of a leaf kept whole on every device."""
    return Spec(*([None] * len(shape)))


def mlp_pspecs(name: str, dims: Sequence[int],
               bias: bool = True) -> Dict[str, Spec]:
    """The specs of :class:`MLP` ``name``'s parameters (``name.w.i``,
    ``name.b.i``), all replicated: the recommender MLPs are small, data
    parallel."""
    out = {f"{name}.w.{i}": Spec(None, None) for i in range(len(dims) - 1)}
    if bias:
        out.update({f"{name}.b.{i}": Spec(None)
                    for i in range(len(dims) - 1)})
    return out


def row_axes(n_rows: int, mesh: MeshShape, rules: ShardingRules) -> Any:
    """An embedding table's row sharding: over EVERY mesh axis where the
    devices divide the rows (model-parallel embeddings, across pods
    too), else the tensor axis (where the mesh has it)."""
    if n_rows % mesh.size == 0:
        return tuple(mesh.axis_names)
    return rules.tensor if rules.tensor in mesh.axis_names else None


def bce_terms(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each row's binary cross-entropy on its logit, in f32."""
    z, y = logits.float(), labels.float()
    return torch.clamp(z, min=0) - z * y + torch.log1p(torch.exp(-z.abs()))


def bce_with_logits(logits: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy on logits (f32 accumulation)."""
    return torch.mean(bce_terms(logits, labels))


# ---------------------------------------------------------------------------
# The sharded route's layout
# ---------------------------------------------------------------------------

def batch_split(mesh: Any, rules: Optional[ShardingRules],
                n: int) -> tuple:
    """The axes a batch of ``n`` rows is split over: the batch axes where
    they hold more than one device and divide ``n``, else none."""
    if rules is None:
        raise ValueError("a sharded call needs its ShardingRules")
    ax = batch_axes(mesh, rules)
    k = spmd.axis_size(mesh, ax) if ax else 1
    return ax if k > 1 and n % k == 0 else ()


def constrain_batchwise(x: Any, mesh: Any, rules: Optional[ShardingRules],
                        batch_size: int) -> Any:
    """The reference's ``_constrain_batchwise``: ``x``'s leading dim laid
    over the batch axes (``spmd.constrain``) where their product is above
    1 and divides ``batch_size``; else ``x`` unchanged (also without a
    mesh)."""
    if mesh is None:
        return x
    ax = batch_split(mesh, rules, batch_size)
    if not ax:
        return x
    return spmd.constrain(x, mesh, Spec(ax, *([None] * (x.dim() - 1))))


def whole(p: Any, mesh: Any, vary: tuple) -> torch.Tensor:
    """The whole value of DTensor parameter ``p`` on this rank, for a
    computation that varies over the axes ``vary`` only: its sharded dims
    gathered (``spmd.redistribute``), then ``spmd.pvary`` over ``vary``.
    The gradient sums the ranks' partial cotangents over ``vary`` and
    keeps this rank's block."""
    from torch.distributed.tensor import DTensor
    if not isinstance(p, DTensor):
        raise TypeError("the sharded route takes DTensor parameters "
                        "(spmd.shard_module with param_pspecs)")
    w = spmd.redistribute(p.to_local(), mesh, spmd.spec_of(p), Spec())
    return spmd.pvary(w, mesh, vary)


def mlp_on(mlp: MLP, mesh: Any, vary: tuple) -> Any:
    """``mlp``'s weights as :func:`whole` gives them, in the layout
    :func:`apply_mlp` reads."""
    import types
    return types.SimpleNamespace(
        w=[whole(w, mesh, vary) for w in mlp.w],
        b=None if mlp.b is None else [whole(b, mesh, vary) for b in mlp.b])


def batch_sum(x: torch.Tensor, mesh: Any, vary: tuple) -> torch.Tensor:
    """The sum of ``x`` over the whole batch: this rank's block's sum,
    ``psum``-ed over the axes the batch is split over (the same value on
    every rank)."""
    total = torch.sum(x)
    return spmd.psum(total, mesh, vary) if vary else total


def merge_topk_over(vals: torch.Tensor, gids: torch.Tensor, mesh: Any,
                    axis: str, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top ``k`` of each rank's candidates over the ranks of
    ``axis``: ``vals`` f32[Q, n] (each row sorted, ties by the lowest id)
    and their global ids ``gids`` [Q, n], a rank's ids above the lower
    ranks'.  The lists are all-gathered in rank order and the first
    ``k`` kept by a stable sort, so ties go to the lowest global id, as
    ``lax.top_k`` over the whole row.  Returns (f32[Q, k], i32[Q, k])."""
    from repro_torch.kernels import ref
    cv = spmd.all_gather(vals, mesh, axis, 1)
    ci = spmd.all_gather(gids.long(), mesh, axis, 1)
    tv, pos = ref.topk_lowest_index(cv, k)
    return tv, ci.gather(1, pos).to(torch.int32)


def _tree_map(fn: Callable, *trees: Any) -> Any:
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return fn(*trees)
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    return type(first)(_tree_map(fn, *xs) for xs in zip(*trees))


def map_batch_chunks(fn: Callable, batch: Dict[str, torch.Tensor],
                     chunk: int, keys: Optional[Sequence[str]] = None
                     ) -> Any:
    """``fn(sub_batch)`` over chunks of ``chunk`` rows, outputs joined.

    Bounds serve-time transients (attention scores, gathers) of bulk
    scoring.  ``keys``: the batch entries that carry the batch dim
    (default: all); the others go to every call whole.  A batch of at
    most ``chunk`` rows, or one ``chunk`` does not divide, runs in one
    call, as the reference's ``lax.map`` does.
    """
    keys = list(batch) if keys is None else list(keys)
    b = batch[keys[0]].shape[0]
    if b <= chunk or b % chunk:
        return fn(batch)
    outs = [fn({**batch, **{k: batch[k][s:s + chunk] for k in keys}})
            for s in range(0, b, chunk)]
    return _tree_map(lambda *xs: torch.cat(xs, dim=0), *outs)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """Layer norm over the last dim in f32 with the POPULATION variance
    (``jnp.var``), cast back to ``x``'s dtype, then ``* w + b``."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * w + b


def masked_xent(logits: torch.Tensor, labels: torch.Tensor,
                mesh: Any = None, vary: tuple = ()) -> torch.Tensor:
    """Mean softmax cross-entropy over the positions whose label is
    >= 0 (−1 marks padding), in f32: ``Σ (lse − gold)·mask / max(Σ mask,
    1)`` as the reference writes it.  With a mesh both sums run over the
    whole batch (:func:`batch_sum` over ``vary``)."""
    logits = logits.float()
    mask = (labels >= 0).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        torch.clamp(labels, min=0).long()[..., None])[..., 0]
    if mesh is not None:
        return batch_sum((lse - gold) * mask, mesh, vary) / torch.clamp(
            batch_sum(mask, mesh, vary), min=1.0)
    return torch.sum((lse - gold) * mask) / torch.clamp(torch.sum(mask),
                                                        min=1.0)


def train_step_of(loss: Callable, optimizer: torch.optim.Optimizer
                  ) -> Callable:
    """The port's form of the reference's ``train_step(params, opt_state,
    batch) -> (params, opt_state, {"loss"})``: ``train_step(model,
    batch) -> {"loss": tensor}`` zeroes the gradients, runs ``loss(model,
    batch)`` backward and calls ``optimizer.step()``, which updates the
    model's parameters and the optimizer's state IN PLACE.  The step's
    ``optimizer`` attribute is ``optimizer`` (its ``last_gnorm`` and the
    parameters' clipped ``.grad`` are what the last step applied)."""
    def train_step(model: nn.Module, batch: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad(set_to_none=True)
        value = loss(model, batch)
        value.backward()
        optimizer.step()
        return {"loss": value.detach()}
    train_step.optimizer = optimizer
    return train_step


def sharded_retrieval(q: torch.Tensor, candidates: Any, top_n: int,
                      mesh: Any, rules: Any, vary: tuple
                      ) -> Tuple[Any, Any]:
    """The top ``top_n`` by dot score of queries ``q`` (this rank's
    block over ``vary``) against ``candidates`` [N, D] whose rows lie
    over the tensor axis: ``ops.knn_topk`` on the rank's rows (at most
    ``top_n`` of them), ids offset by ``axis_index · N_local``, the lists
    merged by :func:`merge_topk_over`.  (f32[Q, n], i32[Q, n])
    DTensors."""
    from repro_torch.kernels import ops
    tp = rules.tensor
    cand = spmd.enter(candidates, mesh, Spec(tp, None)).to(q.dtype)
    vals, idx = ops.knn_topk(q, cand, min(top_n, cand.shape[0]),
                             metric="dot")
    gids = idx.long() + spmd.axis_index(mesh, tp) * cand.shape[0]
    vals, ids = merge_topk_over(vals, gids, mesh, tp, top_n)
    return (spmd.from_local(vals, mesh, Spec(vary, None)),
            spmd.from_local(ids, mesh, Spec(vary, None)))
