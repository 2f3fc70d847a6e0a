"""granite-3-2b [hf:ibm-granite/granite-3.0-2b-base]
40L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=49155 (padded to 49408).

The port's copy of ``repro/configs/granite_3_2b.py``: ``make_config``
and ``smoke_config`` only (the arch registry and mesh cells stay with
the JAX package).
"""
import torch

from repro_torch.models.transformer import TransformerConfig


def make_config() -> TransformerConfig:
    """The published widths and depth, bf16."""
    return TransformerConfig(
        name="granite-3-2b", n_layers=40, d_model=2048, n_heads=32,
        n_kv_heads=8, d_head=64, d_ff=8192,
        vocab_size=49408,   # 49155 padded to a multiple of 256 (TP)
        tie_embeddings=True, dtype=torch.bfloat16)


def smoke_config() -> TransformerConfig:
    """Two narrow layers in f32, for tests on the CPU."""
    return TransformerConfig(
        name="granite-smoke", n_layers=2, d_model=64, n_heads=8,
        n_kv_heads=2, d_head=8, d_ff=128, vocab_size=128,
        tie_embeddings=True, dtype=torch.float32)
