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
package's does.  The sharded execution: the entry points (``forward``,
``prefill``, ``decode_step``, :func:`lm_loss`, :func:`make_train_step`,
:func:`moe_block`) take ``mesh`` (a ``DeviceMesh`` with named dims) and
``rules`` as the JAX functions do; ``mesh=None`` is the single-device
route above, unchanged.  Under a mesh the parameters are DTensors placed
by :func:`param_pspecs` (``spmd.shard_module``) and every rank runs the
JAX package's layouts on its local blocks with explicit collectives
(``parallel/spmd.py``): the residual stream by ``_hspec`` (batch over
the batch axes, S over "model"), attention on each rank's heads
(``_head_spec``; B9 and 9b on the local heads), the expert-parallel MoE
(``n_local`` experts a rank, one ``psum`` over "model"), the caches by
``configs/base._cache_pspecs`` (decode combines each rank's cache
positions through a max and two sums over the context axes).
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
from repro_torch.parallel import spmd
from repro_torch.parallel.sharding import (MeshShape, ShardingRules, Spec,
                                           batch_axes)

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


def moe_block(x: torch.Tensor, layer: Any, c: TransformerConfig,
              mesh: Any = None, rules: Optional[ShardingRules] = None
              ) -> torch.Tensor:
    """Routed top-k MoE plus the shared experts.  Without a mesh, on one
    device: JAX's ``moe_block`` without a mesh (every expert local,
    capacity from all B·S tokens).  With one, the expert-parallel route
    (:func:`_moe_sharded`): ``x`` a DTensor [B, S, D], ``layer``'s
    weights DTensors (``router``, ``we_*``, ``ws_*``); returns a DTensor
    laid out by ``_hspec``."""
    if mesh is not None:
        return _moe_block_dtensor(x, layer, c, mesh, rules)
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
                cache_pos: Optional[int] = None,
                sh: Optional["_Sharded"] = None):
        if sh is not None:
            return _layer_sharded(self, h, c, positions, window, kv_cache,
                                  cache_pos, sh)
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
                positions: Optional[torch.Tensor] = None,
                mesh: Any = None, rules: Optional[ShardingRules] = None
                ) -> Tuple[torch.Tensor, Optional[Caches]]:
        """Token ids [B, S] → final hidden states [B, S, D] (and the
        caches, updated in place, when given).  With a mesh: the rank's
        block of the hidden states under ``_hspec`` (:func:`_forward_sharded`;
        ``tokens`` the global ids every rank holds, the caches DTensors)."""
        if mesh is not None:
            return _forward_sharded(self, tokens, caches, cache_pos,
                                    positions, mesh, rules)
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
    def prefill(self, tokens: torch.Tensor, max_len: int, mesh: Any = None,
                rules: Optional[ShardingRules] = None
                ) -> Tuple[torch.Tensor, Caches]:
        """Run the prompt ``tokens`` [B, S] through; returns the last
        position's f32 logits [B, V] and the filled caches.  With a mesh
        the logits are a DTensor (batch over the batch axes) and the
        caches DTensors placed by ``_cache_pspecs``."""
        if mesh is not None:
            caches = init_caches(self.config, tokens.shape[0], max_len,
                                 self.device, mesh, rules)
            x, _ = self(tokens, caches=caches, cache_pos=0, mesh=mesh,
                        rules=rules)
            return _last_logits(self, x, tokens, mesh, rules), caches
        caches = init_caches(self.config, tokens.shape[0], max_len,
                             self.device)
        x, _ = self(tokens, caches=caches, cache_pos=0)
        return (x[:, -1, :] @ self.unembedding()).float(), caches

    @torch.no_grad()
    def decode_step(self, caches: Caches, token: torch.Tensor, pos: int,
                    mesh: Any = None, rules: Optional[ShardingRules] = None
                    ) -> Tuple[torch.Tensor, Caches]:
        """One decode step: ``token`` [B, 1] at position ``pos`` → f32
        logits [B, V]; the caches are updated in place (with a mesh: as
        :meth:`prefill`)."""
        positions = torch.full(token.shape, pos, dtype=torch.long,
                               device=token.device)
        if mesh is not None:
            x, _ = self(token, caches=caches, cache_pos=pos,
                        positions=positions, mesh=mesh, rules=rules)
            return _last_logits(self, x, token, mesh, rules), caches
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
                device: Any = None, mesh: Any = None,
                rules: Optional[ShardingRules] = None) -> Caches:
    """Zeroed bf16 caches (the JAX package's cache dtype).  With a mesh,
    DTensors of ``configs/base._cache_pspecs``'s specs (each rank's block
    zeroed)."""
    device = resolve_device(device)
    if mesh is not None:
        return _init_caches_sharded(c, batch, max_len, device, mesh, rules)
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
                         chunk: int = 512, mesh: Any = None,
                         rules: Optional[ShardingRules] = None
                         ) -> torch.Tensor:
    """Mean next-token cross-entropy of ``x`` [B, S, D] against
    ``labels`` [B, S] (< 0: masked) without the whole [B, S, V] logits:
    chunks of ``min(chunk, S)`` positions, each under
    ``torch.utils.checkpoint`` (its logits recomputed in backward), the
    f32 sum and count accumulated chunk by chunk in the reference's
    order.  Raises where ``S`` is not a multiple of the chunk (the
    reference's reshape fails there).

    With a mesh, ``x`` [B, S, D] and ``labels`` [B, S] are DTensors of
    the same spec and ``unembed`` is the whole table on every rank: each
    rank sums its own tokens' losses and labels, and both sums are
    ``psum``-ed over the axes the tokens are split over before the
    division.  (The reference constrains the logits to [batch, -, vocab
    over "model"]; here each rank scores its own tokens against the whole
    vocabulary: the same values.)"""
    if mesh is not None:
        spec = spmd.spec_of(x)
        axes = tuple(a for a in mesh.mesh_dim_names
                     if a in spec.axes(0) + spec.axes(1))
        tot, cnt = _xent_sums(x.to_local(), spmd.local(labels), unembed,
                              chunk)
        return spmd.psum(tot, mesh, axes) / torch.clamp(
            spmd.psum(cnt, mesh, axes), min=1.0)
    tot, cnt = _xent_sums(x, labels, unembed, chunk)
    return tot / torch.clamp(cnt, min=1.0)


def _xent_sums(x: torch.Tensor, labels: torch.Tensor, unembed: torch.Tensor,
               chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The f32 (summed loss, label count) of :func:`chunked_softmax_xent`,
    chunk by chunk in the reference's order."""
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
    return tot, cnt


def lm_loss(model: Transformer, batch: Dict[str, torch.Tensor],
            c: TransformerConfig, mesh: Any = None,
            rules: Optional[ShardingRules] = None) -> torch.Tensor:
    """The reference's ``lm_loss``: the chunked cross-entropy of the
    final hidden states against ``batch["labels"]``; with ``c.mtp`` plus
    0.3 times the MTP head's (``[rms_norm(x, mtp_ln), emb(t+1)] @
    mtp_proj`` against the labels shifted one further, the last -1).
    With a mesh: :func:`_lm_loss_sharded` (the same loss on every
    rank)."""
    if mesh is not None:
        return _lm_loss_sharded(model, batch, c, mesh, rules)
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


def make_train_step(c: TransformerConfig, optimizer: torch.optim.Optimizer,
                    mesh: Any = None, rules: Optional[ShardingRules] = None
                    ) -> Any:
    """``train_step(model, batch) -> {"loss"}`` on :func:`lm_loss`: the
    gradients zeroed, the loss run backward, ``optimizer.step()`` (the
    model and the optimizer's state updated IN PLACE; see
    ``common.train_step_of``).  With a mesh the parameters are DTensors
    (``spmd.shard_module`` by :func:`param_pspecs`), AdamW's state takes
    their placements, and each gradient is the whole batch's: no
    compression, the exact mean the reference's GSPMD step takes."""
    return train_step_of(lambda m, b: lm_loss(m, b, c, mesh, rules),
                         optimizer)


# ---------------------------------------------------------------------------
# Sharded execution
# ---------------------------------------------------------------------------
#
# Every rank runs the reference's layouts on its local blocks:
#
# * the residual stream [B, S, D] by ``_hspec``: batch over the batch axes
#   (where they divide it), S over "model" (sequence parallelism, where it
#   divides S > 1); the embedding lookup and the loss on those tokens;
# * attention by ``_head_spec``: S gathered over "model" (``all_gather``,
#   whose gradient is ``psum_scatter``), each rank's heads (q/k/v and the
#   output projection's rows), B9 / 9b on the local heads, the partial
#   output ``psum_scatter``-ed back to S over "model";
# * the dense and the shared-expert FFNs the same way over their hidden
#   dim; the routed experts in ``_moe_sharded`` (the reference's
#   ``shard_map`` body, ``psum`` over "model");
# * a weight's FSDP dims gathered where it is used (``all_gather`` over
#   the FSDP axes, gradient ``psum_scatter``), and every weight entering
#   through ``pvary`` over the axes its spec does not name (gradient
#   ``psum``): every use is a per-rank partial, so each gradient is the
#   whole batch's, as the reference's.


def _mesh_sizes(mesh: Any) -> Dict[str, int]:
    names = getattr(mesh, "axis_names", None) or mesh.mesh_dim_names
    return dict(zip(names, tuple(mesh.shape)))


def _bspec(mesh: Any, rules: ShardingRules, batch: int,
           extra_dims: int) -> Spec:
    """The reference's ``_bspec``: the batch dim over the batch axes
    where they hold more than one device and divide it, then
    ``extra_dims`` replicated dims."""
    ax = batch_axes(mesh, rules)
    sizes = _mesh_sizes(mesh)
    n = math.prod(sizes[a] for a in ax) if ax else 1
    first = ax if (n > 1 and batch % n == 0) else None
    return Spec(first, *([None] * extra_dims))


def _hspec(mesh: Any, rules: ShardingRules, batch: int, seq: int) -> Spec:
    """The residual stream's spec [B, S, D] (the reference's ``_hspec``):
    batch by :func:`_bspec`, S over the tensor axis where it divides S >
    1 (sequence parallelism)."""
    b = _bspec(mesh, rules, batch, 0)[0]
    sizes = _mesh_sizes(mesh)
    tp = rules.tensor if rules.tensor in sizes else None
    s_ax = tp if (tp and seq > 1 and seq % sizes[tp] == 0) else None
    return Spec(b, s_ax, None)


def _head_spec(mesh: Any, rules: ShardingRules, batch: int,
               n_heads: int) -> Spec:
    """Attention tensors [B, S, H, D] (the reference's ``_head_spec``):
    batch by :func:`_bspec`, S gathered, heads over the tensor axis where
    it divides them."""
    b = _bspec(mesh, rules, batch, 0)[0]
    sizes = _mesh_sizes(mesh)
    tp = rules.tensor if rules.tensor in sizes else None
    h_ax = tp if (tp and n_heads % sizes[tp] == 0) else None
    return Spec(b, None, h_ax, None)


@dataclasses.dataclass(frozen=True)
class _Sharded:
    """One sharded call's layout: the batch axes the batch is split over
    (none: replicated), and whether the residual's S is split over the
    tensor axis ``tp``."""

    mesh: Any
    rules: ShardingRules
    batch: Tuple[str, ...]
    seq: bool

    @classmethod
    def of(cls, mesh: Any, rules: Optional[ShardingRules], b: int,
           s: int) -> "_Sharded":
        if rules is None or rules.tensor not in mesh.mesh_dim_names:
            raise ValueError(f"a sharded LM call needs rules whose tensor "
                             f"axis is one of {mesh.mesh_dim_names}")
        h = _hspec(mesh, rules, b, s)
        return cls(mesh, rules, h.axes(0), h[1] is not None)

    @property
    def tp(self) -> str:
        return self.rules.tensor

    @property
    def n_tp(self) -> int:
        return spmd.axis_size(self.mesh, self.tp)

    @property
    def mi(self) -> int:
        return spmd.axis_index(self.mesh, self.tp)

    @property
    def hspec(self) -> Spec:
        return Spec(self.batch, self.tp if self.seq else None, None)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """The residual block → all S of the rank's rows, entering a
        computation split by head or hidden unit (gradient: the partial
        cotangents summed, S's block kept)."""
        if self.seq:
            return spmd.all_gather(x, self.mesh, self.tp, 1)
        return spmd.pvary(x, self.mesh, self.tp)

    def leave(self, a: torch.Tensor) -> torch.Tensor:
        """A per-rank partial [b, S, D] summed over the tensor axis into
        the residual's block."""
        if self.seq:
            return spmd.psum_scatter(a, self.mesh, self.tp, 1)
        return spmd.psum(a, self.mesh, self.tp)


def _body_weight(p: Any, mesh: Any, keep: Optional[str]) -> torch.Tensor:
    """The tensor a rank computes with for DTensor parameter ``p``: its
    block with every dim sharded over axes other than ``keep`` gathered,
    entering through ``pvary`` over the axes its spec does not name."""
    from torch.distributed.tensor import DTensor
    if not isinstance(p, DTensor):
        raise TypeError("the sharded route takes DTensor parameters "
                        "(spmd.shard_module with param_pspecs)")
    spec = spmd.spec_of(p)
    w = p.to_local()
    for d in range(p.dim()):
        axes = spec.axes(d)
        gather = tuple(a for a in axes if a != keep)
        if gather and gather != axes:
            raise ValueError(f"{spec}: dim {d} mixes {keep!r} with other "
                             f"axes")
        if gather:
            w = spmd.all_gather(w, mesh, gather, d)
    named = {a for d in range(len(spec)) for a in spec.axes(d)}
    return spmd.pvary(w, mesh, tuple(a for a in mesh.mesh_dim_names
                                     if a not in named))


def _weights(params: Dict[str, Any], sh: _Sharded) -> Any:
    """:func:`_body_weight` of each parameter with the tensor axis kept;
    ``tp_local`` names those whose block is split over it."""
    import types
    out = types.SimpleNamespace(**{k: _body_weight(p, sh.mesh, sh.tp)
                                   for k, p in params.items()})
    out.tp_local = frozenset(
        k for k, p in params.items()
        if any(sh.tp in spmd.spec_of(p).axes(d) for d in range(p.dim())))
    return out


def _tp_slice(w: Any, name: str, dim: int, lo: int, n: int) -> torch.Tensor:
    """Rows or columns [lo, lo + n) along ``dim`` of weight ``name``: the
    rank's block itself where the weight is split over the tensor axis
    (``lo`` is then the block's start), else a slice of the whole."""
    t = getattr(w, name)
    if name in w.tp_local:
        if t.shape[dim] != n:
            raise ValueError(f"{name}: a block of {t.shape[dim]} along dim "
                             f"{dim}, {n} wanted")
        return t
    if lo + n > t.shape[dim]:
        raise ValueError(f"{name}: [{lo}, {lo + n}) past {t.shape[dim]}")
    return t.narrow(dim, lo, n)


def _head_split(c: TransformerConfig, sh: _Sharded
                ) -> Tuple[int, int, int, int]:
    """(local heads, first local head, local KV heads, first local KV
    head): each rank takes ``n_heads / n_tp`` consecutive heads and the
    KV heads of their groups."""
    n = sh.n_tp
    if c.n_heads % n:
        raise ValueError(f"{c.n_heads} heads do not divide the "
                         f"{sh.tp!r} axis ({n})")
    hl = c.n_heads // n
    lo = sh.mi * hl
    if c.mla:
        return hl, lo, hl, lo
    g = c.n_heads // c.n_kv_heads
    if hl % g and g % hl:
        raise ValueError(f"{hl} heads a rank split KV groups of {g}")
    return hl, lo, max(1, hl // g), lo // g


def _ffn_sharded(x: torch.Tensor, w: Any, sh: _Sharded,
                 names: Tuple[str, str, str] = ("w_gate", "w_up", "w_down")
                 ) -> torch.Tensor:
    """The SwiGLU FFN on the rank's hidden units: the residual block
    gathered over S, the gate/up columns and the down rows of the rank,
    the partial output summed back into the residual's block."""
    gate, up, down = names
    f = getattr(w, gate).shape[1] * (sh.n_tp if gate in w.tp_local else 1)
    if f % sh.n_tp:
        raise ValueError(f"{gate}: {f} hidden units do not divide the "
                         f"{sh.tp!r} axis ({sh.n_tp})")
    fl = f // sh.n_tp
    lo = sh.mi * fl
    xf = sh.enter(x)
    hid = F.silu(xf @ _tp_slice(w, gate, 1, lo, fl)) \
        * (xf @ _tp_slice(w, up, 1, lo, fl))
    return sh.leave(hid @ _tp_slice(w, down, 0, lo, fl))


def _moe_sharded(x: torch.Tensor, w: Any, c: TransformerConfig,
                 sh: _Sharded) -> torch.Tensor:
    """The reference's expert-parallel ``moe_block`` on the residual
    block ``x`` [b, s, D] (returned in the same layout).

    Each rank holds ``n_local = e_pad / n_tp`` experts (from
    ``axis_index("model") · n_local``), their FSDP dim gathered; the
    tokens are the rank's batch rows with S gathered (all tokens where
    B·S is fewer than the batch shards), the capacity from that LOCAL
    token count; ``_moe_local`` on them, one ``psum`` over "model", the
    result cut back to the residual's S block.  The shared experts run
    outside that body, split over their hidden dim."""
    b, s, d = x.shape
    mesh, tp = sh.mesh, sh.tp
    if c.e_pad % sh.n_tp or "we_gate" not in w.tp_local:
        raise ValueError(f"{c.e_pad} experts are not split over the "
                         f"{tp!r} axis ({sh.n_tp})")
    n_local = c.e_pad // sh.n_tp
    bax = batch_axes(mesh, sh.rules)
    n_bsh = spmd.axis_size(mesh, bax)
    big_b = b * (n_bsh if sh.batch else 1)
    big_s = s * (sh.n_tp if sh.seq else 1)
    t = big_b * big_s
    # decode (tokens < batch shards): the tokens replicated over the data
    # axes too
    tok_split = t % n_bsh == 0 and t >= n_bsh
    cap = _capacity(t // n_bsh if tok_split else t, c)
    xf = sh.enter(x).reshape(-1, d)
    split_here = tok_split and n_bsh > 1 and not sh.batch
    if split_here:
        # the batch dim does not divide, its B·S tokens do
        xf = spmd.redistribute(xf, mesh, Spec(), Spec(bax, None))
    routed = spmd.psum(_moe_local(xf, w, c, n_local=n_local,
                                  expert_offset=sh.mi * n_local,
                                  capacity=cap), mesh, tp)
    if split_here:
        routed = spmd.redistribute(routed, mesh, Spec(bax, None), Spec())
    routed = routed.reshape(b, big_s, d)
    if sh.seq:
        routed = spmd.redistribute(routed, mesh, Spec(), Spec(None, tp))
    if c.n_shared_experts:
        routed = routed + _ffn_sharded(x, w, sh,
                                       ("ws_gate", "ws_up", "ws_down"))
    return routed


_MOE_WEIGHTS = ("router", "we_gate", "we_up", "we_down", "ws_gate",
                "ws_up", "ws_down")


def _moe_block_dtensor(x: Any, layer: Any, c: TransformerConfig, mesh: Any,
                       rules: Optional[ShardingRules]) -> Any:
    """:func:`moe_block` under a mesh: DTensor ``x`` moved to ``_hspec``,
    :func:`_moe_sharded`, a DTensor back."""
    b, s, _ = x.shape
    sh = _Sharded.of(mesh, rules, b, s)
    params = (dict(layer.named_parameters(recurse=False))
              if isinstance(layer, nn.Module) else dict(vars(layer)))
    w = _weights({k: v for k, v in params.items() if k in _MOE_WEIGHTS}, sh)
    xl = spmd.redistribute(x.to_local(), mesh, spmd.spec_of(x), sh.hspec)
    return spmd.from_local(_moe_sharded(xl, w, c, sh), mesh, sh.hspec)


def _write_cache_sharded(cache: torch.Tensor, new: torch.Tensor,
                         cache_pos: int, ctx: Tuple[str, ...],
                         sh: _Sharded) -> None:
    """``new`` [b, S, ...] (the rank's batch rows, every position) into
    the rank's block [b, L_loc, ...] of a cache whose L is split over
    ``ctx``, IN PLACE; the start clamped as :func:`_write_cache`'s."""
    n = spmd.axis_size(sh.mesh, ctx)
    l_loc = cache.shape[1]
    lo = spmd.axis_index(sh.mesh, ctx) * l_loc if n > 1 else 0
    s = new.shape[1]
    start = min(max(int(cache_pos), 0), l_loc * n - s)
    a, z = max(start, lo), min(start + s, lo + l_loc)
    if a < z:
        cache[:, a - lo:z - lo] = new[:, a - start:z - start].to(cache.dtype)


def _decode_softmax(scores: torch.Tensor, positions: torch.Tensor,
                    window: int, lo: int, ctx: Tuple[str, ...],
                    sh: _Sharded) -> Tuple[torch.Tensor, torch.Tensor]:
    """(exp(scores − max), their sum) over the cache positions the ranks
    of ``ctx`` hold between them: the rank's [..., 1, L_loc] f32 scores
    masked as :func:`_decode_mask` at positions ``lo + j``, the max the
    ranks' ``pmax``, the sum their ``psum``."""
    kpos = lo + torch.arange(scores.shape[-1], device=scores.device)
    qpos = positions[0]
    mask = (kpos[None, :] <= qpos[:, None]) \
        & (kpos[None, :] > qpos[:, None] - window)
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    m = spmd.pmax(torch.amax(scores, dim=-1, keepdim=True), sh.mesh, ctx)
    p = torch.exp(scores - m)
    return p, spmd.psum(p.sum(-1, keepdim=True), sh.mesh, ctx)


def _cache_lo(cache: torch.Tensor, ctx: Tuple[str, ...],
              sh: _Sharded) -> int:
    return spmd.axis_index(sh.mesh, ctx) * cache.shape[1] if ctx else 0


def _all_kv(xf: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: Any,
            c: TransformerConfig, positions: torch.Tensor, sh: _Sharded
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K and V of every KV head (what the cache holds): the ranks' heads
    gathered, or recomputed from the whole weights where these are not
    split over the tensor axis."""
    if "wk" in w.tp_local:
        return (spmd.all_gather(k, sh.mesh, sh.tp, 2),
                spmd.all_gather(v, sh.mesh, sh.tp, 2))
    b, s = xf.shape[:2]
    kk = (xf @ w.wk).reshape(b, s, c.n_kv_heads, c.d_head)
    return (rope(kk, positions, c.rope_theta),
            (xf @ w.wv).reshape(b, s, c.n_kv_heads, c.d_head))


def _attention_dense_sharded(x: torch.Tensor, w: Any, c: TransformerConfig,
                             positions: torch.Tensor, window: int,
                             kv_cache: Any, cache_pos: Optional[int],
                             sh: _Sharded) -> Tuple[torch.Tensor, Any]:
    """GQA attention on the rank's heads (the reference's
    ``attention_dense`` under a mesh: q/k/v to ``_head_spec``).  A
    prefill or training step runs B9 (9b backward) on the local heads; a
    decode step scores every head's query against the rank's cache
    positions and combines the ranks' (:func:`_decode_softmax`)."""
    import types
    hl, lo, kvl, kv_lo = _head_split(c, sh)
    dh = c.d_head
    lw = types.SimpleNamespace(
        wq=_tp_slice(w, "wq", 1, lo * dh, hl * dh),
        wk=_tp_slice(w, "wk", 1, kv_lo * dh, kvl * dh),
        wv=_tp_slice(w, "wv", 1, kv_lo * dh, kvl * dh))
    wo = _tp_slice(w, "wo", 0, lo * dh, hl * dh)
    cl = dataclasses.replace(c, n_heads=hl, n_kv_heads=kvl)
    xf = sh.enter(x)
    b, s = xf.shape[:2]
    q, k, v = project_qkv(xf, lw, cl, positions)
    if kv_cache is None:
        out = ops.flash_attention(q, k, v, causal=True,
                                  window=kernel_window(window))
        return sh.leave(out.reshape(b, s, hl * dh) @ wo), None
    ck, cv, ctx = kv_cache
    k_all, v_all = _all_kv(xf, k, v, w, c, positions, sh)
    _write_cache_sharded(ck, k_all, cache_pos, ctx, sh)
    _write_cache_sharded(cv, v_all, cache_pos, ctx, sh)
    if s > 1:
        out = ops.flash_attention(q, k, v, causal=True,
                                  window=kernel_window(window))
    else:
        q_all = spmd.all_gather(q, sh.mesh, sh.tp, 2)
        g = c.n_heads // c.n_kv_heads
        qg = q_all.reshape(b, s, c.n_kv_heads, g, dh)
        scores = torch.einsum("bqkgd,bskd->bkgqs", qg,
                              ck.to(q.dtype)).float() / math.sqrt(dh)
        p, tot = _decode_softmax(scores, positions, window,
                                 _cache_lo(ck, ctx, sh), ctx, sh)
        o = spmd.psum(torch.einsum("bkgqs,bskd->bqkgd", p, cv.float()),
                      sh.mesh, ctx)
        o = (o / tot.permute(0, 3, 1, 2, 4)).to(x.dtype)
        out = o.reshape(b, s, c.n_heads, dh).narrow(2, lo, hl)
    return sh.leave(out.reshape(b, s, hl * dh) @ wo), kv_cache


def _attention_mla_sharded(x: torch.Tensor, w: Any, c: TransformerConfig,
                           positions: torch.Tensor, window: int,
                           kv_cache: Any, cache_pos: Optional[int],
                           sh: _Sharded) -> Tuple[torch.Tensor, Any]:
    """MLA on the rank's heads (the reference's ``attention_mla`` under a
    mesh: S gathered on the latent, q and the per-head expansion on the
    local heads).  Decode: the absorbed path, every head's latent query
    scored against the rank's cache positions, the ranks' combined."""
    import types
    hl, lo, _, _ = _head_split(c, sh)
    qk, nv = c.qk_dim, c.qk_nope_dim + c.v_dim
    lw = types.SimpleNamespace(
        wq_a=w.wq_a, q_ln=w.q_ln, wkv_a=w.wkv_a, kv_ln=w.kv_ln,
        wq_b=_tp_slice(w, "wq_b", 1, lo * qk, hl * qk),
        wkv_b=_tp_slice(w, "wkv_b", 1, lo * nv, hl * nv))
    wo = _tp_slice(w, "wo", 0, lo * c.v_dim, hl * c.v_dim)
    cl = dataclasses.replace(c, n_heads=hl, n_kv_heads=hl)
    xf = sh.enter(x)
    b, s = xf.shape[:2]
    q_nope, q_rope, c_kv, k_rope = mla_project(xf, lw, cl, positions)
    if kv_cache is not None:
        lat, rot, ctx = kv_cache
        _write_cache_sharded(lat, c_kv, cache_pos, ctx, sh)
        _write_cache_sharded(rot, k_rope[:, :, 0, :], cache_pos, ctx, sh)
        if s == 1:
            w_k, w_v = _mla_wkv(lw, cl)
            q_abs = spmd.all_gather(
                torch.einsum("bqhd,rhd->bqhr", q_nope, w_k), sh.mesh,
                sh.tp, 2)
            q_rot = spmd.all_gather(q_rope, sh.mesh, sh.tp, 2)
            scores = (torch.einsum("bqhr,bsr->bhqs", q_abs,
                                   lat.to(q_abs.dtype))
                      + torch.einsum("bqhd,bsd->bhqs", q_rot,
                                     rot.to(q_rot.dtype))
                      ).float() / math.sqrt(c.qk_dim)
            p, tot = _decode_softmax(scores, positions, window,
                                     _cache_lo(lat, ctx, sh), ctx, sh)
            o = spmd.psum(torch.einsum("bhqs,bsr->bqhr", p, lat.float()),
                          sh.mesh, ctx)
            o = (o / tot.permute(0, 2, 1, 3)).to(x.dtype).narrow(2, lo, hl)
            out = torch.einsum("bqhr,rhd->bqhd", o, w_v)
            return sh.leave(out.reshape(b, s, hl * c.v_dim) @ wo), kv_cache
    q, k, v = _mla_expand(q_nope, q_rope, c_kv, k_rope, lw, cl)
    out = attend_padded_v(q, k, v, kernel_window(window))
    return sh.leave(out.reshape(b, s, hl * c.v_dim) @ wo), kv_cache


def _layer_sharded(layer: Layer, h: torch.Tensor, c: TransformerConfig,
                   positions: torch.Tensor, window: int, kv_cache: Any,
                   cache_pos: Optional[int], sh: _Sharded):
    """One layer on the rank's residual block (``Layer.forward`` under a
    mesh)."""
    w = _weights(dict(layer.named_parameters(recurse=False)), sh)
    attn = _attention_mla_sharded if c.mla else _attention_dense_sharded
    a, new_cache = attn(rms_norm(h, w.ln1, c.norm_eps), w, c, positions,
                        window, kv_cache, cache_pos, sh)
    h = h + a
    x = rms_norm(h, w.ln2, c.norm_eps)
    h = h + (_ffn_sharded(x, w, sh) if layer.ffn_dense
             else _moe_sharded(x, w, c, sh))
    return h, new_cache


def _layer_output_sharded(layer: Layer, h: torch.Tensor,
                          c: TransformerConfig, positions: torch.Tensor,
                          window: int, sh: _Sharded) -> torch.Tensor:
    return _layer_sharded(layer, h, c, positions, window, None, None, sh)[0]


def _forward_sharded(model: Transformer, tokens: torch.Tensor,
                     caches: Optional[Caches], cache_pos: Optional[int],
                     positions: Optional[torch.Tensor], mesh: Any,
                     rules: Optional[ShardingRules]
                     ) -> Tuple[torch.Tensor, Optional[Caches]]:
    """``Transformer.forward`` under a mesh: the rank's block of the final
    hidden states under ``_hspec`` (``tokens`` and ``positions`` the
    global values every rank holds; ``caches`` DTensors updated IN
    PLACE)."""
    c = model.config
    b, s = tokens.shape
    sh = _Sharded.of(mesh, rules, b, s)
    if positions is None:
        positions = torch.arange(s, device=tokens.device).expand(b, s)
    pos = spmd.local_block(positions, mesh, Spec(sh.batch, None))
    tok = spmd.local_block(tokens, mesh, Spec(*sh.hspec[:2]))
    table = _body_weight(model.embed, mesh, None)
    x = F.embedding(tok, table).to(c.dtype) * math.sqrt(c.d_model)
    remat = c.remat and caches is None and torch.is_grad_enabled()
    if remat and c.remat_policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy={c.remat_policy!r}: one of "
                         f"{REMAT_POLICIES}")
    for name, layers, windows in model.groups():
        if caches is not None:
            ck, cv = caches[name]
            ctx = spmd.spec_of(ck).axes(2)
            ck, cv = ck.to_local(), cv.to_local()
        for i, layer in enumerate(layers):
            if remat:
                x = checkpoint(_layer_output_sharded, layer, x, c, pos,
                               windows[i], sh, use_reentrant=False,
                               **REMAT_POLICIES[c.remat_policy])
                continue
            cache = None if caches is None else (ck[i], cv[i], ctx)
            x, _ = layer(x, c, pos, windows[i], cache, cache_pos, sh)
    final_ln = _body_weight(model.final_ln, mesh, None)
    return rms_norm(x, final_ln, c.norm_eps), caches


def _unembedding_sharded(model: Transformer, mesh: Any) -> torch.Tensor:
    """The whole [D, V] unembedding on every rank (gathered)."""
    if model.config.tie_embeddings:
        return _body_weight(model.embed, mesh, None).T
    return _body_weight(model.unembed, mesh, None)


def _last_logits(model: Transformer, x: torch.Tensor, tokens: torch.Tensor,
                 mesh: Any, rules: Optional[ShardingRules]) -> Any:
    """The last position's f32 logits [B, V] of the hidden-state block
    ``x`` as a DTensor (batch over the batch axes): the position lives on
    the last rank of the tensor axis where S is split."""
    sh = _Sharded.of(mesh, rules, *tokens.shape)
    last = x[:, -1]
    if sh.seq:
        last = spmd.all_gather(x[:, -1:], mesh, sh.tp, 1)[:, -1]
    logits = (last @ _unembedding_sharded(model, mesh)).float()
    return spmd.from_local(logits, mesh, Spec(sh.batch, None))


def _init_caches_sharded(c: TransformerConfig, batch: int, max_len: int,
                         device: torch.device, mesh: Any,
                         rules: Optional[ShardingRules]) -> Caches:
    from repro_torch.configs.base import _cache_pspecs
    shape = MeshShape(tuple(mesh.mesh_dim_names), tuple(mesh.shape))
    specs = _cache_pspecs(c, batch, max_len, shape, rules)
    sizes = _mesh_sizes(mesh)
    out = {}
    for name, shapes in cache_shapes(c, batch, max_len).items():
        pair = []
        for full, spec in zip(shapes, specs[name]):
            loc = []
            for d, n in enumerate(full):
                k = math.prod(sizes[a] for a in spec.axes(d)) \
                    if d < len(spec) else 1
                if n % k:
                    raise ValueError(f"cache dim {d} of {full} does not "
                                     f"divide over {spec.axes(d)} ({k})")
                loc.append(n // k)
            pair.append(spmd.from_local(
                torch.zeros(loc, dtype=torch.bfloat16, device=device),
                mesh, spec))
        out[name] = tuple(pair)
    return out


def _lm_loss_sharded(model: Transformer, batch: Dict[str, torch.Tensor],
                     c: TransformerConfig, mesh: Any,
                     rules: Optional[ShardingRules]) -> torch.Tensor:
    """:func:`lm_loss` under a mesh, on every rank.  The tokens must be
    split over every mesh axis of more than one device (the batch over
    the batch axes, S over the tensor axis): each weight's gradient is
    the sum of the ranks' partial ones, which is the whole batch's only
    where no two ranks compute on the same tokens."""
    tokens, labels = batch["tokens"], batch["labels"]
    b, s = tokens.shape
    sh = _Sharded.of(mesh, rules, b, s)
    split = set(sh.batch) | ({sh.tp} if sh.seq else set())
    idle = [a for a, n in _mesh_sizes(mesh).items()
            if n > 1 and a not in split]
    if idle:
        raise ValueError(f"a sharded LM loss needs its [{b}, {s}] tokens "
                         f"split over every mesh axis; {idle} are not")
    tspec = Spec(*sh.hspec[:2])
    x, _ = model(tokens, mesh=mesh, rules=rules)
    unembed = _unembedding_sharded(model, mesh)
    loss = chunked_softmax_xent(spmd.from_local(x, mesh, sh.hspec),
                                spmd.constrain(labels, mesh, tspec),
                                unembed, c, mesh=mesh, rules=rules)
    if c.mtp:
        table = _body_weight(model.embed, mesh, None)
        nxt = spmd.local_block(torch.roll(tokens, -1, dims=1), mesh, tspec)
        h2 = torch.cat([rms_norm(x, _body_weight(model.mtp_ln, mesh, None),
                                 c.norm_eps),
                        F.embedding(nxt, table).to(c.dtype)], dim=-1) \
            @ _body_weight(model.mtp_proj, mesh, None)
        labels2 = torch.roll(labels, -1, dims=1)
        labels2[:, -1] = -1
        loss = loss + 0.3 * chunked_softmax_xent(
            spmd.from_local(h2, mesh, sh.hspec),
            spmd.constrain(labels2, mesh, tspec), unembed, c, mesh=mesh,
            rules=rules)
    return loss
