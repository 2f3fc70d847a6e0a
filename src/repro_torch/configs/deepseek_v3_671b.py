"""deepseek-v3-671b [arXiv:2412.19437]
61L d_model=7168 128H MLA, 1 shared + 256 routed experts top-8
(per-expert d_ff=2048), first 3 layers dense (d_ff=18432),
vocab=129280, MTP head.  MLA: q_lora=1536, kv_lora=512, nope=128,
rope=64, v=128.

The port's copy of ``repro/configs/deepseek_v3_671b.py``: ``make_config``,
``smoke_config`` and ``ARCH``, the four LM cells of ``lm_shapes``.
"""
import torch

from repro_torch.configs.base import ArchDef
from repro_torch.configs.lm_shapes import standard_lm_cells
from repro_torch.models.transformer import TransformerConfig


def make_config() -> TransformerConfig:
    """The published widths and depth, bf16, untied, with the MTP
    head's parameters."""
    return TransformerConfig(
        name="deepseek-v3-671b", n_layers=61, d_model=7168, n_heads=128,
        n_kv_heads=128, d_head=128, d_ff=18432, vocab_size=129280,
        moe=True, n_experts=256, n_shared_experts=1, top_k=8,
        moe_d_ff=2048, first_dense_layers=3,
        mla=True, q_lora_rank=1536, kv_lora_rank=512, qk_nope_dim=128,
        qk_rope_dim=64, v_head_dim=128,
        mtp=True, tie_embeddings=False, dtype=torch.bfloat16)


def smoke_config() -> TransformerConfig:
    """Three narrow layers (one dense, two MoE) in f32, for tests on the
    CPU."""
    return TransformerConfig(
        name="deepseek-smoke", n_layers=3, d_model=64, n_heads=4,
        n_kv_heads=4, d_head=16, d_ff=192, vocab_size=256,
        moe=True, n_experts=8, n_shared_experts=1, top_k=2, moe_d_ff=32,
        first_dense_layers=1, mla=True, q_lora_rank=32, kv_lora_rank=16,
        qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16, mtp=True,
        capacity_factor=2.0, tie_embeddings=False, dtype=torch.float32)


ARCH = ArchDef(
    name="deepseek-v3-671b", family="lm",
    cells=standard_lm_cells(make_config, optimizer="adafactor",
                            serve_depth=2),
    make_smoke=smoke_config,
    notes=(
        "MLA latent KV cache (decode on the absorbed path); MTP head; "
        "Adafactor, as the JAX arch (Adam's m and v would not fit); 1 dense "
        "+ 1 MoE layer on one card, B9 and 9b at Q/K 192 and V 128 on "
        "the Hopper designs."))
