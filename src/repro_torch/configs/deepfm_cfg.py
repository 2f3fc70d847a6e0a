"""deepfm [arXiv:1703.04247]: 39 fields, embed_dim=10, FM + 400-400-400.

The port's copy of ``repro/configs/deepfm_cfg.py``: ``make_config``,
``smoke_config`` and ``ARCH`` (train_batch, serve_p99, serve_bulk and
retrieval_cand: a 10⁶-row forward).
"""
from repro_torch.configs import recsys_shapes as rs
from repro_torch.configs.base import ArchDef, recsys_cell
from repro_torch.models import deepfm


def make_config() -> deepfm.DeepFMConfig:
    """The published widths and field cardinalities."""
    return deepfm.DeepFMConfig()


def smoke_config() -> deepfm.DeepFMConfig:
    """39 fields of 32 rows and a narrow MLP, for tests on the CPU."""
    return deepfm.DeepFMConfig(vocab_sizes=tuple([32] * 39), embed_dim=10,
                               mlp=(32, 32))


def _flops_train(c, n: int = rs.TRAIN_BATCH) -> float:
    mlp = c.n_params() - c.table.padded_rows() * (c.embed_dim + 1)
    return 6.0 * mlp * n


def peak_bytes(c, n: int, train: bool = False) -> float:
    """The estimated peak: the f32 parameters (with their gradient, m and
    v when training) and per row the ids and their flat copies, three
    copies of the field embeddings and linear weights (lookup, sum,
    square), and the deep MLP (twice when training)."""
    row = 4 * (3 * c.n_fields * (c.embed_dim + 1) + 2 * c.embed_dim
               + sum(c.deep_dims())) + 24 * c.n_fields
    p = 4 * c.n_params()
    return 4 * p + 2 * row * n if train else p + row * n


def _cell(batch, kind, train=False, **kw):
    return recsys_cell(deepfm, make_config, batch, kind, train=train,
                       peak_fn=lambda c, n: peak_bytes(c, n, train), **kw)


ARCH = ArchDef(
    name="deepfm", family="recsys",
    cells={
        "train_batch": _cell(rs.deepfm_cell_batch(rs.TRAIN_BATCH),
                             "train B=65536", train=True,
                             flops_fn=_flops_train),
        "serve_p99": _cell(rs.deepfm_cell_batch(rs.SERVE_P99, train=False),
                           "serve B=512"),
        "serve_bulk": _cell(rs.deepfm_cell_batch(rs.SERVE_BULK,
                                                 train=False),
                            "serve B=262144"),
        "retrieval_cand": _cell(
            rs.deepfm_cell_batch(rs.N_CANDIDATES, train=False),
            "score 1M candidates"),
    },
    make_smoke=smoke_config,
    notes="FM sum-square identity; every cell at its published size.")
