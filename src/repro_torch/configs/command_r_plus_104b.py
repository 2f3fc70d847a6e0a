"""command-r-plus-104b [hf:CohereForAI/c4ai-command-r-plus]
64L d_model=12288 96H (GQA kv=8) d_ff=33792 vocab=256000, no-bias.

The port's copy of ``repro/configs/command_r_plus_104b.py``:
``make_config`` and ``smoke_config`` only (the arch registry and mesh
cells stay with the JAX package).
"""
import torch

from repro_torch.models.transformer import TransformerConfig


def make_config() -> TransformerConfig:
    """The published widths and depth, bf16."""
    return TransformerConfig(
        name="command-r-plus-104b", n_layers=64, d_model=12288, n_heads=96,
        n_kv_heads=8, d_head=128, d_ff=33792, vocab_size=256000,
        tie_embeddings=True, dtype=torch.bfloat16)


def smoke_config() -> TransformerConfig:
    """Two narrow layers in f32, for tests on the CPU."""
    return TransformerConfig(
        name="command-r-smoke", n_layers=2, d_model=96, n_heads=6,
        n_kv_heads=2, d_head=16, d_ff=256, vocab_size=128,
        dtype=torch.float32)
