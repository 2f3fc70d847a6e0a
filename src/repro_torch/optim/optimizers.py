"""AdamW, Adafactor and SGD with the JAX package's update formulas.

The port of ``repro/optim/optimizers.py``.  There an optimizer is an
``(init, update)`` pair over pytrees and ``update(grads, state, params)
-> (params, state)`` is functional.  Here each factory takes the
parameters (an iterable of ``nn.Parameter``) and returns a
``torch.optim.Optimizer`` whose ``step()`` applies the same update IN
PLACE to the parameters' ``.grad``:

- the gradients are first scaled IN PLACE to a global L2 norm of at most
  ``clip_norm`` over ALL parameters (:func:`clip_by_global_norm`);
- a parameter whose ``.grad`` is ``None`` (unused by the loss) takes a
  zero gradient, as ``jax.grad`` gives it: its moments still decay and
  AdamW's weight decay still applies;
- the step count is a Python int (``n_steps``); the learning rate, the
  bias corrections and Adafactor's decay are float32 scalars computed
  from it on the host, so ``step()`` reads nothing back from the card
  (the clip scale stays a device tensor);
- leaves of more than ``CHUNK`` elements are walked in row chunks, so no
  temporary exceeds a few ``CHUNK``-element buffers (about 256 MB).

The state mirrors ``OptState(step, inner)``: per parameter ``m`` and
``v`` (AdamW), ``v`` or the factored ``vr`` / ``vc`` (Adafactor) or
``m`` (SGD's momentum), all float32 and allocated when the optimizer is
built.  ``convert.opt_state_{from,to}_numpy`` carry it to and from a
JAX ``OptState``.  The ``*_state_pspecs`` of the reference wait for the
port's sharding.

Do not swap in ``torch.optim.AdamW`` / ``SGD``: their formulas (decoupled
decay scaled differently, no global clip, no warmup-cosine) are not
these.
"""
from __future__ import annotations

from typing import Any, Iterable, List, NamedTuple, Optional

import numpy as np
import torch

CHUNK = 1 << 24          # elements of a leaf updated at a time

_F32 = np.float32


class OptState(NamedTuple):
    """The JAX package's optimizer state: the step count and the
    per-leaf state tree (numpy leaves when carried across)."""

    step: Any
    inner: Any


def row_slices(t: torch.Tensor) -> List[Any]:
    """Index expressions over ``t``'s first dim, each covering about
    ``CHUNK`` elements (``[...]``, the whole, for a leaf of at most
    ``CHUNK`` elements)."""
    if t.numel() <= CHUNK or t.dim() == 0:
        return [...]
    rows = max(1, CHUNK * t.shape[0] // t.numel())
    return [slice(s, s + rows) for s in range(0, t.shape[0], rows)]


def clip_by_global_norm(grads: Iterable[torch.Tensor],
                        max_norm: float) -> torch.Tensor:
    """Scale ``grads`` IN PLACE by ``min(1, max_norm / max(‖g‖,
    1e-12))``, ``‖g‖`` the L2 norm over all of them; returns ``‖g‖`` (a
    device tensor: nothing is read back)."""
    grads = list(grads)
    norms = torch.stack([torch.linalg.vector_norm(g, dtype=torch.float32)
                         for g in grads])
    gnorm = torch.linalg.vector_norm(norms)
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return gnorm


def _warmup_cosine(step: int, lr: float, warmup: int, total: int) -> float:
    """The learning rate at ``step`` (0-based), in float32 as the
    reference computes it: linear warmup to ``lr`` over ``warmup``
    steps, then a cosine to 0 at ``total``, and 0 after."""
    if step < warmup:
        return float(_F32(lr) * _F32(step + 1) / _F32(max(warmup, 1)))
    t = _F32(step - warmup) / _F32(max(total - warmup, 1))
    t = min(max(t, _F32(0.0)), _F32(1.0))
    return float(_F32(lr * 0.5) * (_F32(1.0) + np.cos(_F32(np.pi) * t)))


def _sub(p: torch.Tensor, update: torch.Tensor) -> None:
    """``p = p - update`` IN PLACE, in float32 (the reference's
    ``(p.astype(f32) - update).astype(p.dtype)``)."""
    if p.dtype == torch.float32:
        p.sub_(update)
    else:
        p.copy_(p.float() - update)


class ClippedOptimizer(torch.optim.Optimizer):
    """The steps every optimizer here shares: the gradients (zeros for
    an unused parameter) clipped by their global norm, then
    :meth:`_update` of each parameter, then the step count."""

    def __init__(self, params, defaults: dict):
        super().__init__(params, defaults)
        self.n_steps = 0
        # the global gradient norm of the last step, before its clip
        self.last_gnorm: Optional[torch.Tensor] = None
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p] = self._init_state(p, group)

    def _init_state(self, p: torch.Tensor, group: dict) -> dict:
        raise NotImplementedError

    def _update(self, p, g, state, group) -> None:
        raise NotImplementedError

    @torch.no_grad()
    def step(self, closure=None) -> Optional[torch.Tensor]:
        """One update of every parameter from its ``.grad``; returns the
        closure's loss, if one was given."""
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        pairs = [(p, group, torch.zeros_like(p) if p.grad is None
                  else p.grad)
                 for group in self.param_groups for p in group["params"]]
        self.last_gnorm = clip_by_global_norm(
            [g for _, _, g in pairs], self.defaults["clip_norm"])
        for p, group, g in pairs:
            self._update(p, g, self.state[p], group)
        self.n_steps += 1
        return loss


class AdamW(ClippedOptimizer):
    """The reference's ``adamw``: ``p -= lr_t·(m̂/(√v̂ + eps) + wd·p)``
    on every leaf, ``lr_t`` the warmup-cosine schedule."""

    def _init_state(self, p, group):
        return {"m": torch.zeros_like(p, dtype=torch.float32),
                "v": torch.zeros_like(p, dtype=torch.float32)}

    def _update(self, p, g, state, group):
        b1, b2, eps, wd = (group[k] for k in ("b1", "b2", "eps",
                                              "weight_decay"))
        t = _F32(self.n_steps + 1)
        lr_t = _warmup_cosine(self.n_steps, group["lr"],
                              group["warmup_steps"], group["total_steps"])
        bc1 = float(_F32(1.0) - _F32(b1) ** t)
        bc2 = float(_F32(1.0) - _F32(b2) ** t)
        m, v = state["m"], state["v"]
        for sl in row_slices(p):
            ps, gs, ms, vs = p[sl], g[sl].float(), m[sl], v[sl]
            ms.mul_(b1).add_(gs, alpha=1 - b1)
            vs.mul_(b2).addcmul_(gs, gs, value=1 - b2)
            delta = (ms / bc1).div_((vs / bc2).sqrt_().add_(eps))
            delta.add_(ps.float(), alpha=wd)
            _sub(ps, delta.mul_(lr_t))


def adamw(params, lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1,
          warmup_steps: int = 100, total_steps: int = 10_000,
          clip_norm: float = 1.0) -> AdamW:
    """AdamW over ``params`` with the reference's defaults."""
    return AdamW(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                              weight_decay=weight_decay,
                              warmup_steps=warmup_steps,
                              total_steps=total_steps, clip_norm=clip_norm))


class Adafactor(ClippedOptimizer):
    """The reference's ``adafactor`` (Shazeer & Stern, 2018): factored
    second moments ``vr`` / ``vc`` for a leaf whose last two dims are
    both at least ``min_dim_factored``, a full ``v`` otherwise, and the
    update clipped to an RMS of at most 1."""

    def _factored(self, p, group) -> bool:
        k = group["min_dim_factored"]
        return p.dim() >= 2 and p.shape[-1] >= k and p.shape[-2] >= k

    def _init_state(self, p, group):
        f32 = dict(dtype=torch.float32, device=p.device)
        if self._factored(p, group):
            return {"vr": torch.zeros(p.shape[:-1], **f32),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
        return {"v": torch.zeros_like(p, dtype=torch.float32)}

    def _update(self, p, g, state, group):
        eps = group["eps"]
        beta = float(_F32(1.0) - (_F32(self.n_steps) + _F32(1.0))
                     ** _F32(-group["decay"]))
        slices = row_slices(p)
        if "v" in state:
            def precond(sl):
                return g[sl].float() * torch.rsqrt(state["v"][sl] + eps)
            for sl in slices:
                g2 = torch.square(g[sl].float()).add_(eps)
                state["v"][sl].mul_(beta).add_(g2, alpha=1 - beta)
        else:
            vr, vc = state["vr"], state["vc"]
            # a 2-D leaf's column means run over every row chunk; a
            # stacked [L, r, c] leaf's chunks hold whole matrices
            col_sum = torch.zeros_like(vc) if p.dim() == 2 else None
            for sl in slices:
                g2 = torch.square(g[sl].float()).add_(eps)
                vr[sl].mul_(beta).add_(torch.mean(g2, dim=-1),
                                       alpha=1 - beta)
                if col_sum is None:
                    vc[sl].mul_(beta).add_(torch.mean(g2, dim=-2),
                                           alpha=1 - beta)
                else:
                    col_sum.add_(torch.sum(g2, dim=0))
            if col_sum is not None:
                vc.mul_(beta).add_(col_sum / p.shape[0], alpha=1 - beta)
            r_norm = torch.clamp(torch.mean(vr, dim=-1, keepdim=True),
                                 min=eps)
            cfac = torch.rsqrt(vc + eps).unsqueeze(-2)

            def precond(sl):
                rn = r_norm if p.dim() == 2 else r_norm[sl]
                rfac = torch.rsqrt(vr[sl] / rn + eps).unsqueeze(-1)
                cf = cfac if p.dim() == 2 else cfac[sl]
                return g[sl].float() * rfac * cf
        # update clipping (RMS <= 1) over the whole leaf, then the update
        sq = sum(torch.sum(torch.square(precond(sl))) for sl in slices)
        rms = torch.sqrt(sq / max(p.numel(), 1) + 1e-12)
        denom = torch.clamp(rms, min=1.0)
        for sl in slices:
            _sub(p[sl], (precond(sl) / denom).mul_(group["lr"]))


def adafactor(params, lr: float = 1e-3, decay: float = 0.8,
              eps: float = 1e-30, clip_norm: float = 1.0,
              min_dim_factored: int = 128) -> Adafactor:
    """Adafactor over ``params`` with the reference's defaults."""
    return Adafactor(params, dict(lr=lr, decay=decay, eps=eps,
                                  clip_norm=clip_norm,
                                  min_dim_factored=min_dim_factored))


class SGD(ClippedOptimizer):
    """The reference's ``sgd``: ``m = momentum·m + g; p -= lr·m``."""

    def _init_state(self, p, group):
        return {"m": torch.zeros_like(p, dtype=torch.float32)}

    def _update(self, p, g, state, group):
        m = state["m"]
        for sl in row_slices(p):
            ms = m[sl]
            ms.mul_(group["momentum"]).add_(g[sl].float())
            _sub(p[sl], group["lr"] * ms)


def sgd(params, lr: float = 1e-2, momentum: float = 0.9,
        clip_norm: float = 1.0) -> SGD:
    """SGD with momentum over ``params`` with the reference's
    defaults."""
    return SGD(params, dict(lr=lr, momentum=momentum, clip_norm=clip_norm))
