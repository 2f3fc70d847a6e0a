"""Decoder-only LM transformer, dense subset (the PyTorch port).

The port of ``repro/models/transformer.py`` for the dense GQA archs
(granite-3-2b; the sliding-window pattern of gemma3 through
``sliding_window`` / ``global_every``): parameters in the JAX package's
layout (``x @ w``, layers stacked ``[L, ...]`` when converted), RMS norm,
rotary embedding, GQA attention with bf16 KV caches, a SwiGLU FFN, tied
unembedding, prefill and greedy-decode steps.  Prefill and the full
forward attend through ``ops.flash_attention`` (the hand-written kernel
on the card); a decode step attends one query row against the cache with
plain torch ops, as the JAX package does outside any kernel.  The caches
are updated IN PLACE.

Not ported here: MoE, MLA, sharding constraints, the chunked
cross-entropy, ``lm_loss`` and the train step.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.types import resolve_device
from repro_torch.kernels import ops

# the JAX package's "no window" sentinel (``_layer_windows``)
FULL = 2 ** 30

Caches = Dict[str, Tuple[torch.Tensor, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The fields of the JAX ``TransformerConfig`` that the dense path
    reads."""

    name: str = "lm"
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_head: int = 64
    d_ff: int = 1024
    vocab_size: int = 1024
    sliding_window: int = 0   # 0 = full attention everywhere
    global_every: int = 0     # layer i is global iff (i+1) % global_every == 0
    tie_embeddings: bool = True
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16

    def n_params(self) -> int:
        """Parameter count."""
        emb = self.vocab_size * self.d_model * (1 if self.tie_embeddings
                                                else 2)
        return emb + self.d_model + self.n_layers * sum(
            math.prod(s) for s in _dense_layer_shapes(self).values())


def _dense_layer_shapes(c: TransformerConfig) -> Dict[str, Tuple[int, ...]]:
    """Shapes of one dense layer's parameters."""
    return {"ln1": (c.d_model,), "ln2": (c.d_model,),
            "wq": (c.d_model, c.n_heads * c.d_head),
            "wk": (c.d_model, c.n_kv_heads * c.d_head),
            "wv": (c.d_model, c.n_kv_heads * c.d_head),
            "wo": (c.n_heads * c.d_head, c.d_model),
            "w_gate": (c.d_model, c.d_ff), "w_up": (c.d_model, c.d_ff),
            "w_down": (c.d_ff, c.d_model)}


def param_shapes(c: TransformerConfig) -> Dict[str, Any]:
    """Shapes of the JAX parameter tree (layers stacked ``[L, ...]``)."""
    shapes: Dict[str, Any] = {"embed": (c.vocab_size, c.d_model),
                              "final_ln": (c.d_model,)}
    if not c.tie_embeddings:
        shapes["unembed"] = (c.d_model, c.vocab_size)
    shapes["dense_layers"] = {k: (c.n_layers,) + v for k, v in
                              _dense_layer_shapes(c).items()}
    return shapes


def _is_norm(name: str) -> bool:
    return name in ("ln1", "ln2", "final_ln")


def _param(shape: Tuple[int, ...], c: TransformerConfig,
           device: torch.device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=c.dtype, device=device),
                        requires_grad=False)


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm in f32, cast back to x's dtype, then times ``w``."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding over the last dim of ``x`` [B, S, heads, D] at
    ``positions`` [B, S] (the two halves rotated, in f32)."""
    half = x.shape[-1] // 2
    exps = torch.arange(0, half, dtype=torch.float32,
                        device=x.device) / half
    freqs = 1.0 / theta ** exps          # a Python base: no host copy
    ang = positions[..., None].to(torch.float32) * freqs      # [B, S, half]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def kernel_window(window: int) -> int:
    """The kernel's window argument for a JAX layer window (``FULL`` or
    more means none, which the kernel spells 0)."""
    return 0 if window >= FULL else int(window)


def project_qkv(x: torch.Tensor, layer: "DenseLayer", c: TransformerConfig,
                positions: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Q [B, S, H, Dh], K and V [B, S, KV, Dh] of ``x``, rotary applied
    to Q and K."""
    b, s, _ = x.shape
    q = (x @ layer.wq).reshape(b, s, c.n_heads, c.d_head)
    k = (x @ layer.wk).reshape(b, s, c.n_kv_heads, c.d_head)
    v = (x @ layer.wv).reshape(b, s, c.n_kv_heads, c.d_head)
    return (rope(q, positions, c.rope_theta),
            rope(k, positions, c.rope_theta), v)


def attention_dense(x: torch.Tensor, layer: "DenseLayer",
                    c: TransformerConfig, positions: torch.Tensor,
                    window: int,
                    kv_cache: Optional[Tuple[torch.Tensor,
                                             torch.Tensor]] = None,
                    cache_pos: Optional[int] = None
                    ) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor,
                                                            torch.Tensor]]]:
    """GQA attention; returns (out, kv cache).

    With a cache, this step's K/V are written into it at ``cache_pos``
    (IN PLACE; the start is clamped so the slice fits, as
    ``dynamic_update_slice`` does).  A prefill (S > 1) attends over its
    own K/V through ``ops.flash_attention``; a decode step (S == 1)
    attends one query row against the whole cache.
    """
    b, s, _ = x.shape
    q, k, v = project_qkv(x, layer, c, positions)
    if kv_cache is None:
        out = ops.flash_attention(q, k, v, causal=True,
                                  window=kernel_window(window))
        return out.reshape(b, s, c.n_heads * c.d_head) @ layer.wo, None
    ck, cv = kv_cache
    start = min(max(int(cache_pos), 0), ck.shape[1] - s)
    ck[:, start:start + s] = k.to(ck.dtype)
    cv[:, start:start + s] = v.to(cv.dtype)
    if s > 1:
        out = ops.flash_attention(q, k, v, causal=True,
                                  window=kernel_window(window))
    else:
        scale = 1.0 / math.sqrt(c.d_head)
        kpos = torch.arange(ck.shape[1], device=x.device)
        qpos = positions[0]                               # [1]
        qg = q.reshape(b, s, c.n_kv_heads, c.n_heads // c.n_kv_heads,
                       c.d_head)
        scores = torch.einsum("bqkgd,bskd->bkgqs", qg,
                              ck.to(q.dtype)).float() * scale
        mask = (kpos[None, :] <= qpos[:, None]) \
            & (kpos[None, :] > qpos[:, None] - window)
        scores = torch.where(mask[None, None, None], scores,
                             torch.full_like(scores, -1e30))
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        out = torch.einsum("bkgqs,bskd->bqkgd", probs, cv.to(x.dtype))
    out = out.reshape(b, s, c.n_heads * c.d_head)
    return out @ layer.wo, (ck, cv)


def ffn_dense(x: torch.Tensor, layer: "DenseLayer") -> torch.Tensor:
    """SwiGLU feed-forward: (silu(x·W_gate) ⊙ x·W_up)·W_down."""
    return (F.silu(x @ layer.w_gate) * (x @ layer.w_up)) @ layer.w_down


def _layer_windows(c: TransformerConfig, n_layers: int,
                   offset: int) -> List[int]:
    """Per-layer attention window (``FULL`` = full causal)."""
    out = []
    for i in range(offset, offset + n_layers):
        if c.sliding_window and c.global_every:
            out.append(FULL if (i + 1) % c.global_every == 0
                       else c.sliding_window)
        elif c.sliding_window:
            out.append(c.sliding_window)
        else:
            out.append(FULL)
    return out


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

class DenseLayer(nn.Module):
    """One pre-norm layer: x + attn(norm(x)), then + ffn(norm(x))."""

    def __init__(self, c: TransformerConfig, device: torch.device):
        super().__init__()
        for name, shape in _dense_layer_shapes(c).items():
            self.register_parameter(name, _param(shape, c, device))

    def forward(self, h: torch.Tensor, c: TransformerConfig,
                positions: torch.Tensor, window: int,
                kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                cache_pos: Optional[int] = None):
        a, new_cache = attention_dense(rms_norm(h, self.ln1, c.norm_eps),
                                       self, c, positions, window, kv_cache,
                                       cache_pos)
        h = h + a
        h = h + ffn_dense(rms_norm(h, self.ln2, c.norm_eps), self)
        return h, new_cache


class Transformer(nn.Module):
    """The dense decoder-only LM: embedding, ``n_layers`` dense layers,
    final norm, (tied) unembedding.  Inference only: the parameters do
    not require grad."""

    def __init__(self, c: TransformerConfig, device: Any = None):
        super().__init__()
        device = resolve_device(device)
        self.config = c
        self.embed = _param((c.vocab_size, c.d_model), c, device)
        self.final_ln = _param((c.d_model,), c, device)
        if not c.tie_embeddings:
            self.unembed = _param((c.d_model, c.vocab_size), c, device)
        self.layers = nn.ModuleList(DenseLayer(c, device)
                                    for _ in range(c.n_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def unembedding(self) -> torch.Tensor:
        """[D, V]: the embedding's transpose when tied."""
        return self.embed.T if self.config.tie_embeddings else self.unembed

    def forward(self, tokens: torch.Tensor, caches: Optional[Caches] = None,
                cache_pos: Optional[int] = None,
                positions: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[Caches]]:
        """Token ids [B, S] → final hidden states [B, S, D] (and the
        caches, updated in place, when given)."""
        c = self.config
        x = self.embed[tokens].to(c.dtype) * math.sqrt(c.d_model)
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device
                                     ).expand(tokens.shape)
        windows = _layer_windows(c, c.n_layers, 0)
        for i, layer in enumerate(self.layers):
            cache = None if caches is None else (caches["dense"][0][i],
                                                 caches["dense"][1][i])
            x, _ = layer(x, c, positions, windows[i], cache, cache_pos)
        return rms_norm(x, self.final_ln, c.norm_eps), caches

    def prefill(self, tokens: torch.Tensor,
                max_len: int) -> Tuple[torch.Tensor, Caches]:
        """Run the prompt ``tokens`` [B, S] through; returns the last
        position's f32 logits [B, V] and the filled caches."""
        caches = init_caches(self.config, tokens.shape[0], max_len,
                             self.device)
        x, _ = self(tokens, caches=caches, cache_pos=0)
        return (x[:, -1, :] @ self.unembedding()).float(), caches

    def decode_step(self, caches: Caches, token: torch.Tensor,
                    pos: int) -> Tuple[torch.Tensor, Caches]:
        """One decode step: ``token`` [B, 1] at position ``pos`` → f32
        logits [B, V]; the caches are updated in place."""
        positions = torch.full(token.shape, pos, dtype=torch.long,
                               device=token.device)
        x, _ = self(token, caches=caches, cache_pos=pos,
                    positions=positions)
        return (x[:, -1, :] @ self.unembedding()).float(), caches


def init_params(c: TransformerConfig, generator: torch.Generator,
                device: Any = None) -> Transformer:
    """A model with norms at one and every other weight 0.02·N(0, 1)
    drawn in f32 from ``generator`` (on ``device``), cast to
    ``c.dtype``."""
    model = Transformer(c, device)
    for name, p in model.named_parameters():
        if _is_norm(name.split(".")[-1]):
            p.fill_(1.0)
        else:
            p.copy_(torch.randn(p.shape, generator=generator,
                                device=p.device) * 0.02)
    return model


def cache_shapes(c: TransformerConfig, batch: int,
                 max_len: int) -> Dict[str, Tuple[Tuple[int, ...],
                                                  Tuple[int, ...]]]:
    """Shapes of the (bf16) K and V caches, stacked over the layers."""
    one = (c.n_layers, batch, max_len, c.n_kv_heads, c.d_head)
    return {"dense": (one, one)}


def init_caches(c: TransformerConfig, batch: int, max_len: int,
                device: Any = None) -> Caches:
    """Zeroed bf16 K/V caches (the JAX package's cache dtype)."""
    device = resolve_device(device)
    return {name: tuple(torch.zeros(s, dtype=torch.bfloat16, device=device)
                        for s in shapes)
            for name, shapes in cache_shapes(c, batch, max_len).items()}
