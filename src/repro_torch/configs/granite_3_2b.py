"""granite-3-2b [hf:ibm-granite/granite-3.0-2b-base]
40L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=49155 (padded to 49408).

The port's copy of ``repro/configs/granite_3_2b.py``: ``make_config``,
``smoke_config`` and ``ARCH``, the four LM cells of ``lm_shapes``.
"""
import torch

from repro_torch.configs.base import ArchDef
from repro_torch.configs.lm_shapes import standard_lm_cells
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


ARCH = ArchDef(
    name="granite-3-2b", family="lm",
    cells=standard_lm_cells(make_config),
    make_smoke=smoke_config,
    notes=(
        "dense GQA (8 KV heads of 64); vocab padded 49155→49408; B9's "
        "Hopper design at D 64; runs at full depth on one card, its batches "
        "cut to fit."))
