"""dlrm-mlperf [arXiv:1906.00091]: MLPerf / Criteo-1TB DLRM.
n_dense=13 n_sparse=26 embed_dim=128 bot=13-512-256-128
top=1024-1024-512-256-1 interaction=dot.

The port's copy of ``repro/configs/dlrm_mlperf.py``: ``make_config``,
``smoke_config`` and ``ARCH`` (train_batch, serve_p99, serve_bulk and
retrieval_cand: a 10⁶-row forward where the candidate column varies).
The Criteo-1TB tables are 89.5 GiB of f32, so on one card each
vocabulary is capped (2^24 rows serving, 2^22 training: the table, its
gradient and AdamW's m and v).
"""
import dataclasses

from repro_torch.configs import recsys_shapes as rs
from repro_torch.configs.base import (ArchDef, PEAK_SHARE, Sizes, gb,
                                      recsys_cell)
from repro_torch.models import dlrm

SERVE_VOCAB_CAP = 1 << 24
TRAIN_VOCAB_CAP = 1 << 22


def make_config() -> dlrm.DLRMConfig:
    """The published widths and the Criteo-1TB vocabularies."""
    return dlrm.DLRMConfig()


def smoke_config() -> dlrm.DLRMConfig:
    """26 vocabularies of 64 rows and narrow MLPs, for tests on the CPU."""
    return dlrm.DLRMConfig(vocab_sizes=tuple([64] * 26), embed_dim=16,
                           bot_mlp=(32, 16), top_mlp=(64, 32, 1))


def _flops_train(c, n: int = rs.TRAIN_BATCH) -> float:
    # fwd+bwd MLP flops dominate compute; 6 × (MLP params) × batch
    mlp = c.n_params() - c.table.padded_rows() * c.embed_dim
    return 6.0 * mlp * n


def peak_bytes(c, n: int, train: bool = False) -> float:
    """The estimated peak: the f32 parameters (with their gradient, m and
    v when training) and per row the ids and their flat copies, the
    bottom MLP, the looked-up and concatenated vectors, the pairwise dots
    and their lower triangle, and the top MLP (twice when training, for
    the gradients)."""
    f = c.n_sparse + 1
    row = 4 * (c.n_dense + sum(c.bot_mlp) + (2 * f - 1) * c.embed_dim
               + f * f + f * (f - 1) // 2 + sum(c.top_dims())) \
        + 24 * c.n_sparse
    p = 4 * c.n_params()
    return 4 * p + 2 * row * n if train else p + row * n


def vocab_cap(cap: int, train: bool):
    """The named cut of each vocabulary to ``cap`` rows, where the
    uncapped tables do not fit the card."""
    def apply(sz: Sizes, device_bytes: float):
        c = sz.config
        if peak_bytes(c, 1, train) <= PEAK_SHARE * device_bytes:
            return None
        cut = dataclasses.replace(c, vocab_sizes=tuple(
            min(v, cap) for v in c.vocab_sizes))
        what = ("the table, its gradient and AdamW's m and v" if train
                else "the table")

        def words(x):
            return (f"{x.table.total_rows:,} rows "
                    f"({gb(4 * x.table.padded_rows() * x.embed_dim)})")
        return (dataclasses.replace(sz, config=cut), words(c), words(cut),
                f"memory: each vocabulary capped at 2^{cap.bit_length() - 1}"
                f" rows; {what} {gb(peak_bytes(c, 0, train))} uncapped, "
                f"{gb(peak_bytes(cut, 0, train))} capped")
    return [("vocab_sizes", apply)]


def _cell(batch, kind, train=False, **kw):
    return recsys_cell(
        dlrm, make_config, batch, kind, train=train,
        peak_fn=lambda c, n: peak_bytes(c, n, train),
        named=vocab_cap(TRAIN_VOCAB_CAP if train else SERVE_VOCAB_CAP,
                        train), **kw)


ARCH = ArchDef(
    name="dlrm-mlperf", family="recsys",
    cells={
        "train_batch": _cell(rs.dlrm_cell_batch(rs.TRAIN_BATCH),
                             "train B=65536", train=True,
                             flops_fn=_flops_train),
        "serve_p99": _cell(rs.dlrm_cell_batch(rs.SERVE_P99, train=False),
                           "serve B=512"),
        "serve_bulk": _cell(rs.dlrm_cell_batch(rs.SERVE_BULK, train=False),
                            "serve B=262144"),
        # ranking model: candidate scoring = 1M-row forward where the
        # candidate-item feature column varies
        "retrieval_cand": _cell(
            rs.dlrm_cell_batch(rs.N_CANDIDATES, train=False),
            "score 1M candidates"),
    },
    make_smoke=smoke_config,
    notes="embedding lookup is the hot path; vocabularies capped at 2^24 "
          "rows serving and 2^22 training on one card; retrieval_cand's "
          "10⁶ rows cut to fit beside the tables.")
