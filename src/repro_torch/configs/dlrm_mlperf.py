"""dlrm-mlperf [arXiv:1906.00091]: MLPerf / Criteo-1TB DLRM.
n_dense=13 n_sparse=26 embed_dim=128 bot=13-512-256-128
top=1024-1024-512-256-1 interaction=dot.

The port's copy of ``repro/configs/dlrm_mlperf.py``: ``make_config``
and ``smoke_config`` only.
"""
from repro_torch.models import dlrm


def make_config() -> dlrm.DLRMConfig:
    """The published widths and the Criteo-1TB vocabularies."""
    return dlrm.DLRMConfig()


def smoke_config() -> dlrm.DLRMConfig:
    """26 vocabularies of 64 rows and narrow MLPs, for tests on the CPU."""
    return dlrm.DLRMConfig(vocab_sizes=tuple([64] * 26), embed_dim=16,
                           bot_mlp=(32, 16), top_mlp=(64, 32, 1))
