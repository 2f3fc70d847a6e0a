"""qwen2-moe-a2.7b [hf:Qwen/Qwen1.5-MoE-A2.7B]
24L d_model=2048 16H (GQA kv=16) per-expert d_ff=1408 vocab=151936,
60 routed experts top-4 + 4 shared experts (shared ffn 4*1408=5632).

The port's copy of ``repro/configs/qwen2_moe_a2_7b.py``: ``make_config``,
``smoke_config`` and ``ARCH``, the four LM cells of ``lm_shapes``.
"""
import torch

from repro_torch.configs.base import ArchDef
from repro_torch.configs.lm_shapes import standard_lm_cells
from repro_torch.models.transformer import TransformerConfig


def make_config() -> TransformerConfig:
    """The published widths and depth, bf16; the 60 routed experts stored
    as 64 (the pad experts receive no route: the router stays 60-wide)."""
    return TransformerConfig(
        name="qwen2-moe-a2.7b", n_layers=24, d_model=2048, n_heads=16,
        n_kv_heads=16, d_head=128, d_ff=5632, vocab_size=151936,
        moe=True, n_experts=60, n_experts_padded=64,
        n_shared_experts=4, top_k=4, moe_d_ff=1408,
        tie_embeddings=True, dtype=torch.bfloat16)


def smoke_config() -> TransformerConfig:
    """Two narrow layers in f32, for tests on the CPU."""
    return TransformerConfig(
        name="qwen2-moe-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_head=16, d_ff=128, vocab_size=256,
        moe=True, n_experts=6, n_experts_padded=8, n_shared_experts=2,
        top_k=2, moe_d_ff=32, capacity_factor=2.0, dtype=torch.float32)


ARCH = ArchDef(
    name="qwen2-moe-a2.7b", family="lm",
    cells=standard_lm_cells(make_config),
    make_smoke=smoke_config,
    notes=(
        "60 routed experts padded to 64 (the pad experts receive no route: "
        "the router stays 60-wide); JAX's single-device MoE route; train_4k "
        "and long_500k cut in depth to fit one card."))
