"""gemma3-27b [hf:google/gemma-3-*]
62L d_model=5376 32H (GQA kv=16) d_ff=21504 vocab=262144,
5:1 local:global sliding-window attention (window 1024), 128k context.

The port's copy of ``repro/configs/gemma3_27b.py``: ``make_config``,
``smoke_config`` and ``ARCH``, the four LM cells of ``lm_shapes``.
"""
import torch

from repro_torch.configs.base import ArchDef
from repro_torch.configs.lm_shapes import standard_lm_cells
from repro_torch.models.transformer import TransformerConfig


def make_config() -> TransformerConfig:
    """The published widths and depth, bf16; layers 6, 12, ... global."""
    return TransformerConfig(
        name="gemma3-27b", n_layers=62, d_model=5376, n_heads=32,
        n_kv_heads=16, d_head=128, d_ff=21504, vocab_size=262144,
        sliding_window=1024, global_every=6,
        tie_embeddings=True, dtype=torch.bfloat16)


def smoke_config() -> TransformerConfig:
    """Six narrow layers (5 local, 1 global) in f32, for tests on the
    CPU."""
    return TransformerConfig(
        name="gemma3-smoke", n_layers=6, d_model=64, n_heads=4,
        n_kv_heads=2, d_head=16, d_ff=128, vocab_size=256,
        sliding_window=4, global_every=6, dtype=torch.float32)


ARCH = ArchDef(
    name="gemma3-27b", family="lm",
    cells=standard_lm_cells(make_config, serve_depth=6),
    make_smoke=smoke_config,
    notes=(
        "5:1 local:global sliding-window attention (window 1024); 5 local + "
        "1 global layers on one card (train_4k 4 + 1); long_500k is one "
        "decode step for every LM arch."))
