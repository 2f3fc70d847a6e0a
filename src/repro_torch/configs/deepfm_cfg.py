"""deepfm [arXiv:1703.04247]: 39 fields, embed_dim=10, FM + 400-400-400.

The port's copy of ``repro/configs/deepfm_cfg.py``: ``make_config`` and
``smoke_config`` only.
"""
from repro_torch.models import deepfm


def make_config() -> deepfm.DeepFMConfig:
    """The published widths and field cardinalities."""
    return deepfm.DeepFMConfig()


def smoke_config() -> deepfm.DeepFMConfig:
    """39 fields of 32 rows and a narrow MLP, for tests on the CPU."""
    return deepfm.DeepFMConfig(vocab_sizes=tuple([32] * 39), embed_dim=10,
                               mlp=(32, 32))
