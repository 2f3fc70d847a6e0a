"""bert4rec [arXiv:1904.06690]: embed_dim=64, 2 blocks, 2 heads,
seq=200; a 1M-item catalogue (vocab padded to 1,000,448).

The port's copy of ``repro/configs/bert4rec_cfg.py``: ``make_config``,
``smoke_config`` and ``ARCH`` (the sampled-cloze train_batch, serve_p99,
serve_bulk, and retrieval_cand through ``retrieval_step``: B3, dot).
The serving cells scan the vocabulary in whole chunks
(:func:`whole_chunks`), where the JAX cells take ``serve_step``'s
default chunk.
"""
from repro_torch.configs import recsys_shapes as rs
from repro_torch.configs.base import ArchDef, recsys_cell
from repro_torch.models import bert4rec

# serve_step's scan: users a call and item rows a step (its defaults)
BATCH_CHUNK, VOCAB_CHUNK = 16384, 65536


def make_config() -> bert4rec.Bert4RecConfig:
    """The published widths."""
    return bert4rec.Bert4RecConfig()


def smoke_config() -> bert4rec.Bert4RecConfig:
    """500 items, D = 32, sequences of 16, for tests on the CPU."""
    return bert4rec.Bert4RecConfig(n_items=500, embed_dim=32, n_blocks=2,
                                   n_heads=2, seq_len=16, d_ff=64)


def _flops_train(c, n: int = rs.TRAIN_BATCH) -> float:
    per_tok = c.n_blocks * (4 * c.embed_dim ** 2 + 2 * c.embed_dim * c.d_ff)
    return 6.0 * per_tok * n * c.seq_len


def _encoder_row(c) -> int:
    """A sequence's encoder activations: ~20 [S, D] f32 copies and four
    of each block's [heads, S, S] f32 scores."""
    s = c.seq_len
    return 4 * (20 * s * c.embed_dim + 4 * c.n_heads * s * s)


def peak_bytes(c, n: int, kind: str) -> float:
    """The estimated peak: the f32 parameters (with their gradient, m and
    v when training); serving, a chunk of ``BATCH_CHUNK`` users' encoder
    and one vocab step's f32 scores and the running top-n's sort and
    merge temporaries; retrieval, the [n, D] candidates (three copies as
    the draw makes them unit-norm) and the query's scores; training (the
    sampled cloze), the encoder and the [20, 8,192] scores, softmax and
    gradient of each row."""
    p = 4 * c.n_params()
    if kind == "train":
        return 4 * p + n * (_encoder_row(c)
                            + 16 * rs.N_MASKED * rs.N_NEGATIVES)
    if kind == "retrieval":
        return p + n * (12 * c.embed_dim + 12)
    m = min(n, BATCH_CHUNK)
    return p + m * (_encoder_row(c) + 16 * VOCAB_CHUNK)


def whole_chunks(c) -> dict:
    """The serving cells' scan: the largest vocab chunk up to
    ``VOCAB_CHUNK`` that divides the vocabulary (62,528 of the published
    1,000,448 rows), so that every item is scored on one device as on the
    mesh.  The default chunk leaves the rows past the last whole chunk
    unscored on one device (17,408 at the published config), while the
    sharded top-n scores every row."""
    return {"vocab_chunk": max(d for d in range(1, min(VOCAB_CHUNK,
                                                       c.vocab) + 1)
                               if c.vocab % d == 0)}


def _cell(batch, kind, what, **kw):
    return recsys_cell(bert4rec, make_config, batch, what,
                       peak_fn=lambda c, n: peak_bytes(c, n, kind), **kw)


ARCH = ArchDef(
    name="bert4rec", family="recsys",
    cells={
        "train_batch": _cell(
            rs.bert4rec_cell_batch(rs.TRAIN_BATCH), "train",
            "sampled-cloze train B=65536", train=True,
            train_kwargs={"sampled": True}, flops_fn=_flops_train),
        "serve_p99": _cell(
            rs.bert4rec_cell_batch(rs.SERVE_P99, train=False), "serve",
            "serve B=512", serve_kwargs=whole_chunks),
        "serve_bulk": _cell(
            rs.bert4rec_cell_batch(rs.SERVE_BULK, train=False), "serve",
            "serve B=262144", serve_kwargs=whole_chunks),
        "retrieval_cand": _cell(
            rs.bert4rec_retrieval_cell_batch(), "retrieval",
            "1 query vs 1M candidates", serve_fn="retrieval_step"),
    },
    make_smoke=smoke_config,
    notes="encoder only (no decode shapes); the sampled cloze's batch cut "
          "to fit one card; retrieval_cand through B3 (dot).")
