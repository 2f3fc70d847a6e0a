"""command-r-plus-104b [hf:CohereForAI/c4ai-command-r-plus]
64L d_model=12288 96H (GQA kv=8) d_ff=33792 vocab=256000, no-bias.

The port's copy of ``repro/configs/command_r_plus_104b.py``: ``make_config``,
``smoke_config`` and ``ARCH``, the four LM cells of ``lm_shapes``.
"""
import torch

from repro_torch.configs.base import ArchDef
from repro_torch.configs.lm_shapes import standard_lm_cells
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


ARCH = ArchDef(
    name="command-r-plus-104b", family="lm",
    cells=standard_lm_cells(make_config, serve_depth=2),
    make_smoke=smoke_config,
    notes=(
        "dense GQA 104B (8 KV heads of 128), no bias; 2 of 64 layers on one "
        "card (train_4k 1)."))
