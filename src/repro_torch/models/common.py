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
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.types import resolve_device


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


def bce_with_logits(logits: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy on logits (f32 accumulation)."""
    z, y = logits.float(), labels.float()
    return torch.mean(torch.clamp(z, min=0) - z * y
                      + torch.log1p(torch.exp(-z.abs())))


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


def masked_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over the positions whose label is
    >= 0 (−1 marks padding), in f32: ``Σ (lse − gold)·mask / max(Σ mask,
    1)`` as the reference writes it."""
    logits = logits.float()
    mask = (labels >= 0).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        torch.clamp(labels, min=0).long()[..., None])[..., 0]
    return torch.sum((lse - gold) * mask) / torch.clamp(torch.sum(mask),
                                                        min=1.0)


def train_step_of(loss: Callable, optimizer: torch.optim.Optimizer
                  ) -> Callable:
    """The port's form of the reference's ``train_step(params, opt_state,
    batch) -> (params, opt_state, {"loss"})``: ``train_step(model,
    batch) -> {"loss": tensor}`` zeroes the gradients, runs ``loss(model,
    batch)`` backward and calls ``optimizer.step()``, which updates the
    model's parameters and the optimizer's state IN PLACE."""
    def train_step(model: nn.Module, batch: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad(set_to_none=True)
        value = loss(model, batch)
        value.backward()
        optimizer.step()
        return {"loss": value.detach()}
    return train_step
