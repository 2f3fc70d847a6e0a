"""qwen2-moe-a2.7b [hf:Qwen/Qwen1.5-MoE-A2.7B]
24L d_model=2048 16H (GQA kv=16) per-expert d_ff=1408 vocab=151936,
60 routed experts top-4 + 4 shared experts (shared ffn 4*1408=5632).

The port's copy of ``repro/configs/qwen2_moe_a2_7b.py``: ``make_config``
and ``smoke_config`` only (the arch registry and mesh cells stay with
the JAX package).
"""
import torch

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
