"""bert4rec [arXiv:1904.06690]: embed_dim=64, 2 blocks, 2 heads,
seq=200; a 1M-item catalogue (vocab padded to 1,000,448).

The port's copy of ``repro/configs/bert4rec_cfg.py``: ``make_config``
and ``smoke_config`` only.
"""
from repro_torch.models import bert4rec


def make_config() -> bert4rec.Bert4RecConfig:
    """The published widths."""
    return bert4rec.Bert4RecConfig()


def smoke_config() -> bert4rec.Bert4RecConfig:
    """500 items, D = 32, sequences of 16, for tests on the CPU."""
    return bert4rec.Bert4RecConfig(n_items=500, embed_dim=32, n_blocks=2,
                                   n_heads=2, seq_len=16, d_ff=64)
