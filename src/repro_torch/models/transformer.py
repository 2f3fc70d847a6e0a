"""Decoder-only LM transformer (the PyTorch port).

The port of ``repro/models/transformer.py`` for serving and training
every LM arch the JAX package registers: dense GQA (granite-3-2b,
command-r-plus-104b; gemma3-27b's 5:1 sliding-window pattern through
``sliding_window`` / ``global_every``), routed top-k experts with shared
experts (qwen2-moe-a2.7b) and DeepSeek's multi-head latent attention
(MLA) with its leading dense layers and its next-next-token (MTP) head
(deepseek-v3-671b).  Parameters are in the JAX package's layout (``x @
w``, layers stacked ``[L, ...]`` per group when converted), with RMS
norm, rotary embedding, bf16 KV caches, SwiGLU FFNs, a tied or separate
unembedding, prefill and greedy-decode steps.  Prefill and the full
forward attend through ``ops.flash_attention`` (the hand-written kernel
on the card); MLA reaches it with V at its own width where the planned
design takes that (bf16 on the Hopper design), else zero-padded.  A
decode step attends one query row against the cache with plain torch ops
(MLA's absorbed path scores in latent space), as the JAX package does
outside any kernel.  The caches are updated IN PLACE.  The MoE runs
JAX's single-device route (``mesh is None``): every expert local,
capacity-dropped dispatch, batched expert matmuls.

Training: the parameters are trainable; :func:`lm_loss` (the forward,
:func:`chunked_softmax_xent` and, with ``mtp``, the MTP head's loss at
weight 0.3) and :func:`make_train_step` mirror the reference's.  With
``remat`` each layer of the forward runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of the
scanned layer), as does each cross-entropy chunk: policy "full"
recomputes the whole layer, "dots" saves the outputs of its un-batched
products (selective checkpointing, :func:`unbatched_product`).
Attention's gradient is 9b on the card (``ops.FlashAttention``).
``prefill`` and ``decode_step`` run under ``torch.no_grad()``.

:func:`param_pspecs` gives every parameter's sharding spec as the JAX
package's does.  Not ported here: the sharded execution (the LM's
sharding constraints and the expert-parallel ``shard_map`` MoE).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.core.types import resolve_device
from repro_torch.kernels import flash_attention, ops, ref
from repro_torch.models.common import train_step_of
from repro_torch.parallel.sharding import MeshShape, ShardingRules, Spec

# the JAX package's "no window" sentinel (``_layer_windows``)
FULL = 2 ** 30

Caches = Dict[str, Tuple[torch.Tensor, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The fields of the JAX ``TransformerConfig`` that serving and
    training read."""

    name: str = "lm"
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_head: int = 64
    d_ff: int = 1024
    vocab_size: int = 1024
    # --- MoE ---
    moe: bool = False
    n_experts: int = 0
    n_experts_padded: int = 0  # storage padding; pad experts get no route
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0  # leading dense layers (deepseek)
    capacity_factor: float = 1.25
    # --- MLA (deepseek) ---
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # --- attention pattern ---
    sliding_window: int = 0   # 0 = full attention everywhere
    global_every: int = 0     # layer i is global iff (i+1) % global_every == 0
    # --- misc ---
    tie_embeddings: bool = True
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    mtp: bool = False         # next-next-token head (deepseek; training)
    dtype: torch.dtype = torch.bfloat16
    # training: per-layer rematerialization, policy "full" (recompute the
    # whole layer in backward) or "dots" (keep its un-batched products)
    remat: bool = True
    remat_policy: str = "full"

    @property
    def e_pad(self) -> int:
        return self.n_experts_padded or self.n_experts

    @property
    def qk_dim(self) -> int:
        return (self.qk_nope_dim + self.qk_rope_dim) if self.mla \
            else self.d_head

    @property
    def v_dim(self) -> int:
        return self.v_head_dim if self.mla else self.d_head

    def _attn_params(self) -> int:
        c = self
        if c.mla:
            return (c.d_model * c.q_lora_rank
                    + c.q_lora_rank * c.n_heads * c.qk_dim
                    + c.d_model * (c.kv_lora_rank + c.qk_rope_dim)
                    + c.kv_lora_rank * c.n_heads * (c.qk_nope_dim + c.v_dim)
                    + c.n_heads * c.v_dim * c.d_model)
        return c.d_model * (c.n_heads + 2 * c.n_kv_heads) * c.d_head \
            + c.n_heads * c.d_head * c.d_model

    def n_params(self) -> int:
        """The JAX package's parameter count (norms, the router, expert
        padding and the MTP head left out)."""
        c = self
        emb = c.vocab_size * c.d_model * (1 if c.tie_embeddings else 2)
        moe_ffn = 3 * c.d_model * c.moe_d_ff * (c.n_experts
                                                + c.n_shared_experts)
        n_dense, n_moe = layer_groups(c)
        return emb + c.n_layers * self._attn_params() \
            + n_dense * 3 * c.d_model * c.d_ff + n_moe * moe_ffn

    def n_active_params(self) -> int:
        """Parameters a token reads (MoE: the routed top-k and the shared
        experts only), as the JAX package counts them."""
        c = self
        if not c.moe:
            return self.n_params()
        emb = c.vocab_size * c.d_model * (1 if c.tie_embeddings else 2)
        act_moe = 3 * c.d_model * c.moe_d_ff * (c.top_k + c.n_shared_experts)
        return emb + c.n_layers * self._attn_params() \
            + c.first_dense_layers * 3 * c.d_model * c.d_ff \
            + (c.n_layers - c.first_dense_layers) * act_moe


def layer_groups(c: TransformerConfig) -> Tuple[int, int]:
    """(dense layers, MoE layers): the dense group comes first."""
    n_moe = (c.n_layers - c.first_dense_layers) if c.moe else 0
    return c.n_layers - n_moe, n_moe


def _dense_layer_shapes(c: TransformerConfig,
                        ffn_dense: bool) -> Dict[str, Tuple[int, ...]]:
    """Shapes of one layer's parameters; ``ffn_dense``: a dense FFN, else
    the MoE FFN."""
    s: Dict[str, Tuple[int, ...]] = {"ln1": (c.d_model,),
                                     "ln2": (c.d_model,)}
    if c.mla:
        s.update({
            "wq_a": (c.d_model, c.q_lora_rank),
            "q_ln": (c.q_lora_rank,),
            "wq_b": (c.q_lora_rank, c.n_heads * c.qk_dim),
            "wkv_a": (c.d_model, c.kv_lora_rank + c.qk_rope_dim),
            "kv_ln": (c.kv_lora_rank,),
            "wkv_b": (c.kv_lora_rank,
                      c.n_heads * (c.qk_nope_dim + c.v_dim)),
            "wo": (c.n_heads * c.v_dim, c.d_model),
        })
    else:
        s.update({
            "wq": (c.d_model, c.n_heads * c.d_head),
            "wk": (c.d_model, c.n_kv_heads * c.d_head),
            "wv": (c.d_model, c.n_kv_heads * c.d_head),
            "wo": (c.n_heads * c.d_head, c.d_model),
        })
    if ffn_dense:
        s.update({"w_gate": (c.d_model, c.d_ff), "w_up": (c.d_model, c.d_ff),
                  "w_down": (c.d_ff, c.d_model)})
    else:
        s.update({
            "router": (c.d_model, c.n_experts),
            "we_gate": (c.e_pad, c.d_model, c.moe_d_ff),
            "we_up": (c.e_pad, c.d_model, c.moe_d_ff),
            "we_down": (c.e_pad, c.moe_d_ff, c.d_model),
        })
        if c.n_shared_experts:
            f = c.moe_d_ff * c.n_shared_experts
            s.update({"ws_gate": (c.d_model, f), "ws_up": (c.d_model, f),
                      "ws_down": (f, c.d_model)})
    return s


def param_shapes(c: TransformerConfig) -> Dict[str, Any]:
    """Shapes of the JAX parameter tree (layers stacked ``[L, ...]`` per
    group)."""
    n_dense, n_moe = layer_groups(c)
    shapes: Dict[str, Any] = {"embed": (c.vocab_size, c.d_model),
                              "final_ln": (c.d_model,)}
    if not c.tie_embeddings:
        shapes["unembed"] = (c.d_model, c.vocab_size)
    if n_dense:
        shapes["dense_layers"] = {k: (n_dense,) + v for k, v in
                                  _dense_layer_shapes(c, True).items()}
    if n_moe:
        shapes["moe_layers"] = {k: (n_moe,) + v for k, v in
                                _dense_layer_shapes(c, False).items()}
    if c.mtp:
        shapes["mtp_proj"] = (2 * c.d_model, c.d_model)
        shapes["mtp_ln"] = (c.d_model,)
    return shapes


def named_param_shapes(c: TransformerConfig) -> Dict[str, Tuple[int, ...]]:
    """The shape of each of the port's parameters, by the name and in
    the order ``Transformer.named_parameters`` gives them (one entry per
    layer, unstacked)."""
    shapes: Dict[str, Tuple[int, ...]] = {"embed": (c.vocab_size, c.d_model),
                                          "final_ln": (c.d_model,)}
    if not c.tie_embeddings:
        shapes["unembed"] = (c.d_model, c.vocab_size)
    if c.mtp:
        shapes["mtp_proj"] = (2 * c.d_model, c.d_model)
        shapes["mtp_ln"] = (c.d_model,)
    n_dense, n_moe = layer_groups(c)
    for i in range(n_dense + n_moe):
        for name, shape in _dense_layer_shapes(c, i < n_dense).items():
            shapes[f"layers.{i}.{name}"] = shape
    return shapes


def _is_norm(name: str) -> bool:
    return name in ("ln1", "ln2", "final_ln", "q_ln", "kv_ln", "mtp_ln")


def _param(shape: Tuple[int, ...], c: TransformerConfig,
           device: torch.device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=c.dtype, device=device))


# ---------------------------------------------------------------------------
# Sharding specs
# ---------------------------------------------------------------------------

# the JAX package's tables, by the dim of a layer leaf STACKED [L, ...]:
# the dim carrying the TP axis, and the one carrying the FSDP axes
_TP_DIMS = {
    "wq": 2, "wk": 2, "wv": 2, "wo": 1,
    "wq_b": 2, "wkv_b": 2,
    "w_gate": 2, "w_up": 2, "w_down": 1,
    "ws_gate": 2, "ws_up": 2, "ws_down": 1,
    "we_gate": 1, "we_up": 1, "we_down": 1,   # experts over model axis
    "router": None, "wq_a": None, "wkv_a": None,
    "ln1": None, "ln2": None, "q_ln": None, "kv_ln": None,
}
_FSDP_DIMS = {
    "wq": 1, "wk": 1, "wv": 1, "wo": 2,
    "wq_a": 1, "wq_b": 1, "wkv_a": 1, "wkv_b": 1,
    "w_gate": 1, "w_up": 1, "w_down": 2,
    "ws_gate": 1, "ws_up": 1, "ws_down": 2,
    "we_gate": 2, "we_up": 2, "we_down": 3,   # D over data (gathered)
    "router": None,
    "ln1": None, "ln2": None, "q_ln": None, "kv_ln": None,
}


def param_pspecs(c: TransformerConfig, mesh: MeshShape,
                 rules: ShardingRules) -> Dict[str, Spec]:
    """The :class:`Spec` of each of the port's parameters, by the name
    ``Transformer.named_parameters`` gives it, as the JAX package's
    ``param_pspecs`` computes it.  A layer's leaf takes the spec of its
    JAX group's stacked ``[L, ...]`` leaf without the leading ``None``
    (the port keeps one module per layer).

    TP over attention heads only where the KV heads divide the model
    axis (else attention is FSDP-only, e.g. command-r-plus's 8 KV heads
    on a 16-way axis); an axis only where its size divides the dim.
    """
    msize = mesh.sizes()
    tp = rules.tensor if rules.tensor in mesh.axis_names else None
    fsa = rules.fsdp_axes(mesh)
    fsn = rules.fsdp_size(mesh)
    kv_tp_ok = tp is not None and (c.mla or c.n_kv_heads % msize[tp] == 0)

    def spec_for(name: str, shape: Tuple[int, ...]) -> Spec:
        axes: List[Any] = [None] * len(shape)
        tpd = _TP_DIMS.get(name)
        if name in ("wq", "wk", "wv", "wo") and not kv_tp_ok:
            tpd = None
        if tp and tpd is not None and tpd < len(shape) \
                and shape[tpd] % msize[tp] == 0:
            axes[tpd] = tp
        else:
            tpd = None
        fsd = _FSDP_DIMS.get(name)
        if fsa and fsd is not None and fsd < len(shape) and fsd != tpd \
                and shape[fsd] % fsn == 0:
            axes[fsd] = fsa
        return Spec(*axes)

    d, v = c.d_model, c.vocab_size
    vocab_tp = tp if tp and v % msize[tp] == 0 else None
    d_fs = fsa if fsa and d % fsn == 0 else None
    out: Dict[str, Spec] = {}
    for name, shape in named_param_shapes(c).items():
        leaf = name.split(".")[-1]
        if name == "embed":
            out[name] = Spec(vocab_tp, d_fs)
        elif name == "unembed":
            out[name] = Spec(d_fs, vocab_tp)
        elif name in ("final_ln", "mtp_ln"):
            out[name] = Spec(None)
        elif name == "mtp_proj":
            # the reference gives the head wo's stacked dims, unstacked
            out[name] = spec_for("wo", shape)
        else:
            out[name] = Spec(*spec_for(leaf, (1,) + shape)[1:])
    return out


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


def _write_cache(cache: torch.Tensor, new: torch.Tensor,
                 cache_pos: Optional[int]) -> None:
    """``new`` [B, S, ...] into ``cache`` [B, L, ...] at ``cache_pos``, IN
    PLACE; the start is clamped so the slice fits, as
    ``dynamic_update_slice`` does."""
    s = new.shape[1]
    start = min(max(int(cache_pos), 0), cache.shape[1] - s)
    cache[:, start:start + s] = new.to(cache.dtype)


def _decode_mask(scores: torch.Tensor, positions: torch.Tensor,
                 window: int) -> torch.Tensor:
    """One query row's scores [..., 1, L] with the cache slots past its
    position (and before its window) at −1e30."""
    kpos = torch.arange(scores.shape[-1], device=scores.device)
    qpos = positions[0]                                   # [1]
    mask = (kpos[None, :] <= qpos[:, None]) \
        & (kpos[None, :] > qpos[:, None] - window)
    return torch.where(mask, scores, torch.full_like(scores, -1e30))


def project_qkv(x: torch.Tensor, layer: "Layer", c: TransformerConfig,
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


def attention_dense(x: torch.Tensor, layer: "Layer",
                    c: TransformerConfig, positions: torch.Tensor,
                    window: int,
                    kv_cache: Optional[Tuple[torch.Tensor,
                                             torch.Tensor]] = None,
                    cache_pos: Optional[int] = None
                    ) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor,
                                                            torch.Tensor]]]:
    """GQA attention; returns (out, kv cache).

    With a cache, this step's K/V are written into it at ``cache_pos``
    (IN PLACE).  A prefill (S > 1) attends over its own K/V through
    ``ops.flash_attention``; a decode step (S == 1) attends one query row
    against the whole cache.
    """
    b, s, _ = x.shape
    q, k, v = project_qkv(x, layer, c, positions)
    if kv_cache is None:
        out = ops.flash_attention(q, k, v, causal=True,
                                  window=kernel_window(window))
        return out.reshape(b, s, c.n_heads * c.d_head) @ layer.wo, None
    ck, cv = kv_cache
    _write_cache(ck, k, cache_pos)
    _write_cache(cv, v, cache_pos)
    if s > 1:
        out = ops.flash_attention(q, k, v, causal=True,
                                  window=kernel_window(window))
    else:
        scale = 1.0 / math.sqrt(c.d_head)
        qg = q.reshape(b, s, c.n_kv_heads, c.n_heads // c.n_kv_heads,
                       c.d_head)
        scores = torch.einsum("bqkgd,bskd->bkgqs", qg,
                              ck.to(q.dtype)).float() * scale
        scores = _decode_mask(scores, positions, window)
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        out = torch.einsum("bkgqs,bskd->bqkgd", probs, cv.to(x.dtype))
    out = out.reshape(b, s, c.n_heads * c.d_head)
    return out @ layer.wo, (ck, cv)


def mla_project(x: torch.Tensor, layer: "Layer", c: TransformerConfig,
                positions: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """MLA's per-token projections of ``x`` [B, S, D]: ``q_nope`` [B, S,
    H, nope], ``q_rope`` [B, S, H, rope] (rotary applied), the normed
    latent ``c_kv`` [B, S, kv_lora_rank] and the shared rotary key
    ``k_rope`` [B, S, 1, rope]."""
    b, s, _ = x.shape
    h, dn, dr = c.n_heads, c.qk_nope_dim, c.qk_rope_dim
    r = c.kv_lora_rank
    q_lat = rms_norm(x @ layer.wq_a, layer.q_ln, c.norm_eps)
    q = (q_lat @ layer.wq_b).reshape(b, s, h, dn + dr)
    q_rope = rope(q[..., dn:], positions, c.rope_theta)
    kv_a = x @ layer.wkv_a                                   # [B, S, r+dr]
    c_kv = rms_norm(kv_a[..., :r], layer.kv_ln, c.norm_eps)
    k_rope = rope(kv_a[..., None, r:], positions, c.rope_theta)
    return q[..., :dn], q_rope, c_kv, k_rope


def _mla_wkv(layer: "Layer", c: TransformerConfig
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``wkv_b`` split per head: W_k [r, H, nope] and W_v [r, H, v]."""
    wkv_b = layer.wkv_b.reshape(c.kv_lora_rank, c.n_heads,
                                c.qk_nope_dim + c.v_dim)
    return wkv_b[..., :c.qk_nope_dim], wkv_b[..., c.qk_nope_dim:]


def mla_qkv(x: torch.Tensor, layer: "Layer", c: TransformerConfig,
            positions: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """MLA's expanded prefill Q and K [B, S, H, nope + rope] and V [B, S,
    H, v] of ``x``: the per-head keys and values of the latent."""
    return _mla_expand(*mla_project(x, layer, c, positions), layer, c)


def _mla_expand(q_nope: torch.Tensor, q_rope: torch.Tensor,
                c_kv: torch.Tensor, k_rope: torch.Tensor, layer: "Layer",
                c: TransformerConfig
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Q = [q_nope, q_rope], K = [c_kv·W_k, k_rope shared by the heads]
    and V = c_kv·W_v, per head."""
    b, s, h = q_nope.shape[0], q_nope.shape[1], c.n_heads
    w_k, w_v = _mla_wkv(layer, c)
    k_nope = torch.einsum("bsr,rhd->bshd", c_kv, w_k)
    v = torch.einsum("bsr,rhd->bshd", c_kv, w_v)
    if not flash_attention.aligned_rows(v):
        # the Hopper design reads V by TMA at 16-byte rows: one copy of V,
        # less than the zero padding to Q's width it replaces
        v = v.contiguous()
    k = torch.cat([k_nope, k_rope.expand(b, s, h, c.qk_rope_dim)], dim=-1)
    return torch.cat([q_nope, q_rope], dim=-1), k, v


def kernel_v(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             window: int = 0, causal: bool = True) -> torch.Tensor:
    """The V that :func:`attend_padded_v` hands ``ops.flash_attention``:
    ``v`` [..., Dv] itself where the design ``flash_attention.plan_flash``
    picks for it takes V of its own width (``tma_wgmma`` at MLA's bf16
    (192, 128)), else ``v`` zero-padded to Q's width D (f32, unaligned
    rows and other widths run designs that take V as wide as Q).  Raises
    on Dv > D."""
    plan = flash_attention.plan_flash(q, k, v, window, causal)
    d, dv = q.shape[-1], v.shape[-1]
    if flash_attention.takes_v_width(plan.design, d, dv):
        return v
    return F.pad(v, (0, d - dv))


def attend_padded_v(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    window: int = 0) -> torch.Tensor:
    """Causal attention of ``q``, ``k`` [B, S, H, D] over ``v`` [B, S, H,
    Dv] with Dv <= D through ``ops.flash_attention``, V as
    :func:`kernel_v` sends it: unpadded where the planned design takes V
    of its own width (MLA's bf16 prefill and training step), else
    zero-padded to D with the first Dv columns of the output kept.  Exact
    either way: the padded columns of P·V are 0, and the scale 1/√D is
    Q's."""
    out = ops.flash_attention(q, k, kernel_v(q, k, v, window), causal=True,
                              window=window)
    return out[..., :v.shape[-1]]


def attention_mla(x: torch.Tensor, layer: "Layer", c: TransformerConfig,
                  positions: torch.Tensor, window: int,
                  kv_cache: Optional[Tuple[torch.Tensor,
                                           torch.Tensor]] = None,
                  cache_pos: Optional[int] = None
                  ) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor,
                                                          torch.Tensor]]]:
    """DeepSeek's multi-head latent attention; returns (out, cache).

    The cache holds the normed latent [B, L, kv_lora_rank] and the rotary
    key [B, L, rope] only, written at ``cache_pos`` IN PLACE.  A prefill
    (or the full forward) expands per-head keys and values and attends
    through :func:`attend_padded_v`; a decode step (S == 1) takes the
    absorbed path: ``q_nope`` projected into the latent space, scores
    against the cached latent, the per-head expansion never formed.
    """
    b, s, _ = x.shape
    h, dv = c.n_heads, c.v_dim
    q_nope, q_rope, c_kv, k_rope = mla_project(x, layer, c, positions)
    if kv_cache is not None:
        cl, cr = kv_cache
        _write_cache(cl, c_kv, cache_pos)
        _write_cache(cr, k_rope[:, :, 0, :], cache_pos)
        if s == 1:
            w_k, w_v = _mla_wkv(layer, c)
            scale = 1.0 / math.sqrt(c.qk_dim)
            q_abs = torch.einsum("bqhd,rhd->bqhr", q_nope, w_k)
            scores = (torch.einsum("bqhr,bsr->bhqs", q_abs, cl.to(q_abs.dtype))
                      + torch.einsum("bqhd,bsd->bhqs", q_rope,
                                     cr.to(q_rope.dtype))).float() * scale
            scores = _decode_mask(scores, positions, window)
            probs = torch.softmax(scores, dim=-1).to(x.dtype)
            out_lat = torch.einsum("bhqs,bsr->bqhr", probs, cl.to(x.dtype))
            out = torch.einsum("bqhr,rhd->bqhd", out_lat, w_v)
            return out.reshape(b, s, h * dv) @ layer.wo, (cl, cr)
    q, k, v = _mla_expand(q_nope, q_rope, c_kv, k_rope, layer, c)
    out = attend_padded_v(q, k, v, kernel_window(window))
    out = out.reshape(b, s, h * dv) @ layer.wo
    return out, (None if kv_cache is None else (cl, cr))


def ffn_dense(x: torch.Tensor, layer: Any) -> torch.Tensor:
    """SwiGLU feed-forward: (silu(x·W_gate) ⊙ x·W_up)·W_down."""
    return (F.silu(x @ layer.w_gate) * (x @ layer.w_up)) @ layer.w_down


def _capacity(tokens_local: int, c: TransformerConfig) -> int:
    """Slots per expert: the tokens' share of top-k assignments times the
    capacity factor, at least 8 and at most the tokens (JAX's
    ``_capacity``, whose unused row count is left out)."""
    cap = int(tokens_local * c.top_k / max(c.n_experts, 1)
              * c.capacity_factor)
    return max(8, min(cap, tokens_local))


def route(xf: torch.Tensor, router: torch.Tensor, c: TransformerConfig
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each token's top-k experts [T, k] over the softmaxed f32 router
    logits, ties to the lowest index (``lax.top_k``'s order), and their
    gates [T, k] renormalized to sum to 1 (f32)."""
    probs = torch.softmax((xf @ router).float(), dim=-1)
    gates, experts = ref.topk_lowest_index(probs, c.top_k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, experts


def dispatch_slots(experts: torch.Tensor, n_local: int, expert_offset: int,
                   capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(keep, slot) [T·k] of each flat (token, k) assignment: an
    assignment to a local expert keeps slot ``e·capacity + rank``, its
    rank the count of earlier assignments (in flat order) to the same
    expert, if that rank is below ``capacity``; every other one is
    dropped to slot ``n_local·capacity``.  JAX's one-hot cumsum, through
    a stable sort."""
    flat_e = experts.reshape(-1)
    local = (flat_e >= expert_offset) & (flat_e < expert_offset + n_local)
    le = torch.where(local, flat_e - expert_offset,
                     torch.full_like(flat_e, n_local))
    order = torch.sort(le, stable=True).indices
    # a scatter, not ``bincount``: no host read of the largest id
    counts = torch.zeros(n_local + 1, dtype=le.dtype, device=le.device
                         ).scatter_add_(0, le, torch.ones_like(le))
    starts = torch.cumsum(counts, 0) - counts
    ranks = torch.arange(le.numel(), device=le.device) - starts[le[order]]
    pos = torch.empty_like(le)
    pos[order] = ranks
    keep = local & (pos < capacity)
    slot = torch.where(keep, le * capacity + pos,
                       torch.full_like(le, n_local * capacity))
    return keep, slot


def _moe_local(xf: torch.Tensor, layer: Any, c: TransformerConfig,
               n_local: int, expert_offset: int,
               capacity: int) -> torch.Tensor:
    """Top-k dispatch → expert matmuls → combine over the ``n_local``
    experts from ``expert_offset`` (``layer.we_*`` [n_local, ...]).

    xf [T, D] → [T, D].  Each kept assignment's token is copied into its
    slot of an [n_local·capacity, D] buffer (dropped ones into a trash
    row past it), the experts run as batched matmuls over [n_local,
    capacity, D], and each token sums its gated kept outputs over k in
    order, as JAX's scatter-add over the flat assignments does.
    """
    t, d = xf.shape
    k = c.top_k
    gates, experts = route(xf, layer.router, c)
    keep, slot = dispatch_slots(experts, n_local, expert_offset, capacity)
    keep, slot = keep.view(t, k), slot.view(t, k)
    buf = torch.zeros((n_local * capacity + 1, d), dtype=xf.dtype,
                      device=xf.device)
    for j in range(k):
        # kept slots are distinct; dropped ones all land in the trash row
        buf.index_copy_(0, slot[:, j], xf)
    eb = buf[:n_local * capacity].view(n_local, capacity, d)
    hid = F.silu(torch.bmm(eb, layer.we_gate)) * torch.bmm(eb, layer.we_up)
    del buf, eb
    flat_out = torch.bmm(hid, layer.we_down).view(n_local * capacity, d)
    del hid
    g = gates.to(xf.dtype)
    out = torch.zeros_like(xf)
    for j in range(k):
        rows = flat_out[torch.clamp(slot[:, j], max=n_local * capacity - 1)]
        out = out + torch.where(keep[:, j, None], rows, 0) * g[:, j, None]
    return out


def moe_block(x: torch.Tensor, layer: Any,
              c: TransformerConfig) -> torch.Tensor:
    """Routed top-k MoE plus the shared experts, on one device: JAX's
    ``moe_block`` without a mesh (every expert local, capacity from all
    B·S tokens)."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    out = _moe_local(xf, layer, c, n_local=c.e_pad, expert_offset=0,
                     capacity=_capacity(b * s, c))
    if c.n_shared_experts:
        out = out + (F.silu(xf @ layer.ws_gate)
                     * (xf @ layer.ws_up)) @ layer.ws_down
    return out.reshape(b, s, d)


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

class Layer(nn.Module):
    """One pre-norm layer: x + attn(norm(x)) (GQA or MLA), then + ffn(norm
    (x)) (dense SwiGLU or MoE)."""

    def __init__(self, c: TransformerConfig, ffn_dense: bool,
                 device: torch.device):
        super().__init__()
        self.ffn_dense = ffn_dense
        for name, shape in _dense_layer_shapes(c, ffn_dense).items():
            self.register_parameter(name, _param(shape, c, device))

    def forward(self, h: torch.Tensor, c: TransformerConfig,
                positions: torch.Tensor, window: int,
                kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                cache_pos: Optional[int] = None):
        attn = attention_mla if c.mla else attention_dense
        a, new_cache = attn(rms_norm(h, self.ln1, c.norm_eps), self, c,
                            positions, window, kv_cache, cache_pos)
        h = h + a
        x = rms_norm(h, self.ln2, c.norm_eps)
        h = h + (ffn_dense(x, self) if self.ffn_dense
                 else moe_block(x, self, c))
        return h, new_cache


class Transformer(nn.Module):
    """The decoder-only LM: embedding, ``layer_groups(c)`` dense then MoE
    layers (in ``layers``, in that order), final norm, unembedding.  The
    parameters are trainable; in-place writes to them go under
    ``torch.no_grad()``."""

    def __init__(self, c: TransformerConfig, device: Any = None):
        super().__init__()
        device = resolve_device(device)
        self.config = c
        self.embed = _param((c.vocab_size, c.d_model), c, device)
        self.final_ln = _param((c.d_model,), c, device)
        if not c.tie_embeddings:
            self.unembed = _param((c.d_model, c.vocab_size), c, device)
        if c.mtp:
            self.mtp_proj = _param((2 * c.d_model, c.d_model), c, device)
            self.mtp_ln = _param((c.d_model,), c, device)
        n_dense, n_moe = layer_groups(c)
        self.layers = nn.ModuleList(
            [Layer(c, True, device) for _ in range(n_dense)]
            + [Layer(c, False, device) for _ in range(n_moe)])

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def unembedding(self) -> torch.Tensor:
        """[D, V]: the embedding's transpose when tied."""
        return self.embed.T if self.config.tie_embeddings else self.unembed

    def groups(self) -> List[Tuple[str, List[Layer], List[int]]]:
        """(cache key, layers, windows) of the dense and the MoE group,
        those that have layers."""
        c = self.config
        n_dense, n_moe = layer_groups(c)
        out = []
        for name, lo, n in (("dense", 0, n_dense), ("moe", n_dense, n_moe)):
            if n:
                out.append((name, list(self.layers[lo:lo + n]),
                            _layer_windows(c, n, lo)))
        return out

    def forward(self, tokens: torch.Tensor, caches: Optional[Caches] = None,
                cache_pos: Optional[int] = None,
                positions: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[Caches]]:
        """Token ids [B, S] → final hidden states [B, S, D] (and the
        caches, updated in place, when given)."""
        c = self.config
        # F.embedding: the same rows as indexing, and a backward that
        # does not serialize on runs of one row
        x = F.embedding(tokens, self.embed).to(c.dtype) * math.sqrt(c.d_model)
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device
                                     ).expand(tokens.shape)
        remat = c.remat and caches is None and torch.is_grad_enabled()
        if remat and c.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy={c.remat_policy!r}: one of "
                             f"{REMAT_POLICIES}")
        for name, layers, windows in self.groups():
            for i, layer in enumerate(layers):
                if remat:
                    # the reference's jax.checkpoint of the scanned layer:
                    # "full" keeps only the layer's input for the
                    # backward, "dots" also its un-batched products
                    x = checkpoint(_layer_output, layer, x, c, positions,
                                   windows[i], use_reentrant=False,
                                   **REMAT_POLICIES[c.remat_policy])
                    continue
                cache = None if caches is None else (caches[name][0][i],
                                                     caches[name][1][i])
                x, _ = layer(x, c, positions, windows[i], cache, cache_pos)
        return rms_norm(x, self.final_ln, c.norm_eps), caches

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor,
                max_len: int) -> Tuple[torch.Tensor, Caches]:
        """Run the prompt ``tokens`` [B, S] through; returns the last
        position's f32 logits [B, V] and the filled caches."""
        caches = init_caches(self.config, tokens.shape[0], max_len,
                             self.device)
        x, _ = self(tokens, caches=caches, cache_pos=0)
        return (x[:, -1, :] @ self.unembedding()).float(), caches

    @torch.no_grad()
    def decode_step(self, caches: Caches, token: torch.Tensor,
                    pos: int) -> Tuple[torch.Tensor, Caches]:
        """One decode step: ``token`` [B, 1] at position ``pos`` → f32
        logits [B, V]; the caches are updated in place."""
        positions = torch.full(token.shape, pos, dtype=torch.long,
                               device=token.device)
        x, _ = self(token, caches=caches, cache_pos=pos,
                    positions=positions)
        return (x[:, -1, :] @ self.unembedding()).float(), caches


def unbatched_product(op: Any, args: tuple) -> bool:
    """Whether aten ``op`` on ``args`` is a contraction with no batch
    dims, what ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``
    saves.  The policy sees aten ops, not contractions: ``x @ w`` reaches
    it as ``mm`` (``matmul`` folds the leading dims into rows), and
    ``torch.einsum`` lowers every two-operand contraction to ``bmm``,
    with a batch of 1 where the einsum has no batch letters (MLA's
    ``bsr,rhd->bshd``, a dot_general without batch dims in JAX).  So a
    ``bmm`` of batch 1 counts as un-batched and one of a larger batch
    (the experts' ``[e, capacity, d]`` products, attention's heads) does
    not."""
    if op is torch.ops.aten.mm.default:
        return True
    return op is torch.ops.aten.bmm.default and args[0].shape[0] == 1


def _dots_policy(ctx: Any, op: Any, *args: Any, **kwargs: Any):
    """Save the outputs of the un-batched products, recompute the rest."""
    if unbatched_product(op, args):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return create_selective_checkpoint_contexts(_dots_policy)


# each remat policy's extra ``checkpoint`` arguments: "full" recomputes
# the whole layer in the backward; "dots" keeps the outputs of its
# un-batched products (q, k, v and the output projection, MLA's latent
# projections and expansions, the router, the dense and shared FFNs'
# products) and recomputes the rest.  Kernels reached through ctypes
# (B9's forward) are not aten ops and are recomputed under both.
REMAT_POLICIES = {"full": {}, "dots": {"context_fn": _dots_context}}


def _layer_output(layer: Layer, h: torch.Tensor, c: TransformerConfig,
                  positions: torch.Tensor, window: int) -> torch.Tensor:
    """One layer's output without a cache (the checkpointed function)."""
    return layer(h, c, positions, window)[0]


@torch.no_grad()
def init_params(c: TransformerConfig, generator: torch.Generator,
                device: Any = None) -> Transformer:
    """A model with norms at one and every other weight 0.02·N(0, 1)
    drawn in f32 from ``generator`` (on ``device``), cast to ``c.dtype``;
    the expert stacks one expert at a time (DeepSeek's [256, 7168, 2048]
    would need a 15 GB f32 draw)."""
    model = Transformer(c, device)
    for name, p in model.named_parameters():
        leaf = name.split(".")[-1]
        if _is_norm(leaf):
            p.fill_(1.0)
            continue
        for dst in (p if leaf.startswith("we_") else [p]):
            dst.copy_(torch.randn(dst.shape, generator=generator,
                                  device=p.device) * 0.02)
    return model


def cache_shapes(c: TransformerConfig, batch: int,
                 max_len: int) -> Dict[str, Tuple[Tuple[int, ...],
                                                  Tuple[int, ...]]]:
    """Shapes of the (bf16) caches of each layer group, stacked over its
    layers: K and V [n, B, L, KV, Dh], or MLA's latent [n, B, L,
    kv_lora_rank] and rotary key [n, B, L, rope]."""
    out = {}
    for name, n in zip(("dense", "moe"), layer_groups(c)):
        if not n:
            continue
        if c.mla:
            out[name] = ((n, batch, max_len, c.kv_lora_rank),
                         (n, batch, max_len, c.qk_rope_dim))
        else:
            one = (n, batch, max_len, c.n_kv_heads, c.d_head)
            out[name] = (one, one)
    return out


def init_caches(c: TransformerConfig, batch: int, max_len: int,
                device: Any = None) -> Caches:
    """Zeroed bf16 caches (the JAX package's cache dtype)."""
    device = resolve_device(device)
    return {name: tuple(torch.zeros(s, dtype=torch.bfloat16, device=device)
                        for s in shapes)
            for name, shapes in cache_shapes(c, batch, max_len).items()}


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def _xent_chunk(xc: torch.Tensor, yc: torch.Tensor, unembed: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One chunk's (summed loss, label count): logits [B, chunk, V] in
    f32 from the model dtype's product, log-sum-exp minus the gold logit
    where the label is >= 0."""
    logits = (xc @ unembed).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, torch.clamp(yc, min=0)[..., None]
                        )[..., 0]
    mask = (yc >= 0).float()
    return torch.sum((lse - gold) * mask), torch.sum(mask)


def chunked_softmax_xent(x: torch.Tensor, labels: torch.Tensor,
                         unembed: torch.Tensor, c: TransformerConfig,
                         chunk: int = 512) -> torch.Tensor:
    """Mean next-token cross-entropy of ``x`` [B, S, D] against
    ``labels`` [B, S] (< 0: masked) without the whole [B, S, V] logits:
    chunks of ``min(chunk, S)`` positions, each under
    ``torch.utils.checkpoint`` (its logits recomputed in backward), the
    f32 sum and count accumulated chunk by chunk in the reference's
    order.  Raises where ``S`` is not a multiple of the chunk (the
    reference's reshape fails there)."""
    b, s, _ = x.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"cross-entropy chunk {chunk}")
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, s, chunk):
        xc, yc = x[:, i:i + chunk], labels[:, i:i + chunk]
        if torch.is_grad_enabled():
            loss, n = checkpoint(_xent_chunk, xc, yc, unembed,
                                 use_reentrant=False)
        else:
            loss, n = _xent_chunk(xc, yc, unembed)
        tot, cnt = tot + loss, cnt + n
    return tot / torch.clamp(cnt, min=1.0)


def lm_loss(model: Transformer, batch: Dict[str, torch.Tensor],
            c: TransformerConfig) -> torch.Tensor:
    """The reference's ``lm_loss``: the chunked cross-entropy of the
    final hidden states against ``batch["labels"]``; with ``c.mtp`` plus
    0.3 times the MTP head's (``[rms_norm(x, mtp_ln), emb(t+1)] @
    mtp_proj`` against the labels shifted one further, the last -1)."""
    tokens, labels = batch["tokens"], batch["labels"]
    x, _ = model(tokens)
    unembed = model.unembedding()
    loss = chunked_softmax_xent(x, labels, unembed, c)
    if c.mtp:
        # next-next-token prediction: h_t with emb(t + 1), one projection
        emb_next = torch.roll(F.embedding(tokens, model.embed).to(c.dtype),
                              -1, dims=1)
        h2 = torch.cat([rms_norm(x, model.mtp_ln, c.norm_eps), emb_next],
                       dim=-1) @ model.mtp_proj
        labels2 = torch.roll(labels, -1, dims=1)
        labels2[:, -1] = -1
        loss = loss + 0.3 * chunked_softmax_xent(h2, labels2, unembed, c)
    return loss


def make_train_step(c: TransformerConfig, optimizer: torch.optim.Optimizer
                    ) -> Any:
    """``train_step(model, batch) -> {"loss"}`` on :func:`lm_loss`: the
    gradients zeroed, the loss run backward, ``optimizer.step()`` (the
    model and the optimizer's state updated IN PLACE; see
    ``common.train_step_of``)."""
    return train_step_of(lambda m, b: lm_loss(m, b, c), optimizer)
