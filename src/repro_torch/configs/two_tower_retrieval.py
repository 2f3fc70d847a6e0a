"""two-tower-retrieval [RecSys'19 YouTube]: embed_dim=256, towers
1024-512-256, dot interaction, in-batch sampled softmax.

The port's copy of ``repro/configs/two_tower_retrieval.py``:
``make_config``, ``smoke_config`` and ``ARCH`` (train_batch, serve_p99,
serve_bulk, and retrieval_cand through ``retrieval_step``: B3, dot).
"""
from repro_torch.configs import recsys_shapes as rs
from repro_torch.configs.base import ArchDef, recsys_cell
from repro_torch.models import two_tower


def make_config() -> two_tower.TwoTowerConfig:
    """The published widths: 5M users, 2M items, D = 256."""
    return two_tower.TwoTowerConfig()


def smoke_config() -> two_tower.TwoTowerConfig:
    """Narrow tables and towers, for tests on the CPU."""
    return two_tower.TwoTowerConfig(n_users=1000, n_items=500,
                                    n_item_cats=20, hist_len=8,
                                    embed_dim=16, tower_mlp=(32, 16))


def _flops_train(c, n: int = rs.TRAIN_BATCH) -> float:
    tower = sum(a * b for a, b in zip([2 * c.embed_dim, *c.tower_mlp[:-1]],
                                      c.tower_mlp))
    # two towers fwd+bwd + BxB in-batch logits fwd+bwd
    return 6.0 * 2 * tower * n + 6.0 * n ** 2 * c.tower_mlp[-1]


def peak_bytes(c, n: int, kind: str) -> float:
    """The estimated peak: the f32 parameters (with their gradient, m and
    v when training) and per pair the history's gathered rows and their
    masked copy, both towers' layers and the ids; training twice that
    and the [n, n] logits, their softmax and gradient; retrieval the
    [n, D] candidates (three copies as the draw makes them unit-norm)
    and the query's scores."""
    p = 4 * c.n_params()
    if kind == "retrieval":
        return p + n * (12 * c.tower_mlp[-1] + 12)
    row = 4 * (2 * c.hist_len * c.embed_dim + 4 * c.embed_dim
               + 4 * sum(c.tower_mlp)) + 8 * (c.hist_len + 3)
    if kind == "train":
        return 4 * p + 2 * row * n + 16 * n * n
    return p + row * n


def _cell(batch, kind, what, **kw):
    return recsys_cell(two_tower, make_config, batch, what,
                       peak_fn=lambda c, n: peak_bytes(c, n, kind), **kw)


ARCH = ArchDef(
    name="two-tower-retrieval", family="recsys",
    cells={
        "train_batch": _cell(
            rs.two_tower_cell_batch(rs.TRAIN_BATCH), "train",
            "in-batch softmax B=65536", train=True, flops_fn=_flops_train),
        "serve_p99": _cell(
            rs.two_tower_cell_batch(rs.SERVE_P99, train=False), "serve",
            "pair scoring B=512"),
        "serve_bulk": _cell(
            rs.two_tower_cell_batch(rs.SERVE_BULK, train=False), "serve",
            "pair scoring B=262144"),
        "retrieval_cand": _cell(
            rs.two_tower_retrieval_cell_batch(), "retrieval",
            "1 query vs 1M candidates", serve_fn="retrieval_step"),
    },
    make_smoke=smoke_config,
    notes="CLOSEST match to the paper: user tower = embedding-bag user "
          "vector; the in-batch softmax's batch cut to fit one card; "
          "retrieval_cand through B3 (dot).")
