"""The recommender models' serving shapes, and seeded batches of them.

The constants of ``repro/configs/recsys_shapes.py`` (train_batch=65536,
serve_p99=512, serve_bulk=262144, retrieval_cand: 1 query × 1M
candidates).  Where the reference builds abstract shapes for a dry run,
the makers here build real tensors: each draws from an explicit
``torch.Generator`` on its device, so a seed gives the same batch.
Ids are uniform over each feature's vocabulary; a user history holds
−1 padding at its end, a BERT4Rec sequence item 0 (padding) at its
start; candidate rows are unit-norm.
"""
from typing import Dict

import torch

TRAIN_BATCH = 65536
SERVE_P99 = 512
SERVE_BULK = 262144
N_CANDIDATES = 1_000_000

Batch = Dict[str, torch.Tensor]


def _ints(gen: torch.Generator, hi, shape) -> torch.Tensor:
    """int64 ids uniform in [0, hi) (``hi`` per column for a 2-D shape)."""
    u = torch.rand(shape, generator=gen, device=gen.device,
                   dtype=torch.float64)
    hi_t = torch.as_tensor(hi, dtype=torch.float64, device=gen.device)
    return torch.minimum((u * hi_t).long(), hi_t.long() - 1)


def _padded_tail(gen: torch.Generator, ids: torch.Tensor, pad: int,
                 at_start: bool) -> torch.Tensor:
    """Each row keeps a random length in [1, S]; the rest is ``pad``."""
    n, s = ids.shape
    length = _ints(gen, s, (n, 1)) + 1
    pos = torch.arange(s, device=ids.device)[None, :]
    keep = pos >= s - length if at_start else pos < length
    return torch.where(keep, ids, torch.full_like(ids, pad))


def unit_rows(gen: torch.Generator, n: int, d: int) -> torch.Tensor:
    """``n`` rows of width ``d``, N(0, 1) then scaled to unit norm."""
    x = torch.randn((n, d), generator=gen, device=gen.device)
    return x / torch.linalg.norm(x, dim=-1, keepdim=True)


def dlrm_batch(c, n: int, gen: torch.Generator) -> Batch:
    """{"dense": f32[n, 13] (N(0, 1)), "sparse": int64[n, 26]}."""
    return {"dense": torch.randn((n, c.n_dense), generator=gen,
                                 device=gen.device),
            "sparse": _ints(gen, list(c.vocab_sizes), (n, c.n_sparse))}


def deepfm_batch(c, n: int, gen: torch.Generator) -> Batch:
    """{"sparse": int64[n, 39]}."""
    return {"sparse": _ints(gen, list(c.vocab_sizes), (n, c.n_fields))}


def bert4rec_batch(c, n: int, gen: torch.Generator) -> Batch:
    """{"ids": int64[n, seq_len]}: items in [2, n_items + 2), padding
    (0) before each sequence."""
    ids = _ints(gen, c.n_items, (n, c.seq_len)) + 2
    return {"ids": _padded_tail(gen, ids, 0, at_start=True)}


def bert4rec_retrieval_batch(c, gen: torch.Generator,
                             n_cand: int = N_CANDIDATES) -> Batch:
    """One sequence and ``n_cand`` unit-norm candidate rows [N, D]."""
    return {**bert4rec_batch(c, 1, gen),
            "candidates": unit_rows(gen, n_cand, c.embed_dim)}


def two_tower_batch(c, n: int, gen: torch.Generator) -> Batch:
    """n user × item pairs: user ids, −1-padded histories, item ids and
    categories."""
    hist = _ints(gen, c.n_items, (n, c.hist_len))
    return {"user_id": _ints(gen, c.n_users, (n,)),
            "history": _padded_tail(gen, hist, -1, at_start=False),
            "item_id": _ints(gen, c.n_items, (n,)),
            "item_cat": _ints(gen, c.n_item_cats, (n,))}


def two_tower_items(c, n: int, gen: torch.Generator) -> Batch:
    """The item tower's input for an index of ``n`` items."""
    return {"item_id": _ints(gen, c.n_items, (n,)),
            "item_cat": _ints(gen, c.n_item_cats, (n,))}


def two_tower_retrieval_batch(c, gen: torch.Generator,
                              n_cand: int = N_CANDIDATES) -> Batch:
    """One user and ``n_cand`` unit-norm candidate rows [N, tower out]."""
    pair = two_tower_batch(c, 1, gen)
    return {"user_id": pair["user_id"], "history": pair["history"],
            "candidates": unit_rows(gen, n_cand, c.tower_mlp[-1])}
