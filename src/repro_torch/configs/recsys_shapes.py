"""The recommender models' serving shapes, and seeded batches of them.

The constants of ``repro/configs/recsys_shapes.py`` (train_batch=65536,
serve_p99=512, serve_bulk=262144, retrieval_cand: 1 query × 1M
candidates).  Where the reference builds abstract shapes for a dry run,
the makers here build real tensors: each draws from an explicit
``torch.Generator`` on its device, so a seed gives the same batch.
Ids are uniform over each feature's vocabulary; a user history holds
−1 padding at its end, a BERT4Rec sequence item 0 (padding) at its
start; candidate rows are unit-norm.

``train=True`` adds the keys of the reference's train shapes, drawn
after the serving keys (so a seed gives the same serving keys either
way): ``labels`` (Bernoulli ½) for DLRM and DeepFM, ``logq`` (the
uniform sampler's −log n_items) for two-tower, and for BERT4Rec
``mask_pos`` (distinct positions), ``targets`` (the item there, −1
where the position is padding), ``negatives`` (in [2, n_items + 2)),
with ``ids`` holding the mask token 1 at each masked item.
"""
import math
from typing import Dict

import torch

TRAIN_BATCH = 65536
N_MASKED, N_NEGATIVES = 20, 8192      # BERT4Rec's sampled cloze
MASK = 1                              # BERT4Rec's mask token
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


def _labels(gen: torch.Generator, n: int) -> torch.Tensor:
    """f32[n] of 0/1, each 1 with probability ½."""
    return (torch.rand((n,), generator=gen, device=gen.device)
            < 0.5).float()


def dlrm_batch(c, n: int, gen: torch.Generator, train: bool = False
               ) -> Batch:
    """{"dense": f32[n, 13] (N(0, 1)), "sparse": int64[n, 26]}, and
    "labels" f32[n] when ``train``."""
    batch = {"dense": torch.randn((n, c.n_dense), generator=gen,
                                  device=gen.device),
             "sparse": _ints(gen, list(c.vocab_sizes), (n, c.n_sparse))}
    if train:
        batch["labels"] = _labels(gen, n)
    return batch


def deepfm_batch(c, n: int, gen: torch.Generator, train: bool = False
                 ) -> Batch:
    """{"sparse": int64[n, 39]}, and "labels" f32[n] when ``train``."""
    batch = {"sparse": _ints(gen, list(c.vocab_sizes), (n, c.n_fields))}
    if train:
        batch["labels"] = _labels(gen, n)
    return batch


def bert4rec_batch(c, n: int, gen: torch.Generator, train: bool = False,
                   n_masked: int = N_MASKED,
                   n_negatives: int = N_NEGATIVES) -> Batch:
    """{"ids": int64[n, seq_len]}: items in [2, n_items + 2), padding
    (0) before each sequence.  With ``train``: "mask_pos" int64[n, M]
    (M distinct positions a row), "targets" int64[n, M] (the item at
    each, −1 at padding), "negatives" int64[K] (in [2, n_items + 2)),
    and the mask token 1 in ``ids`` at every masked item."""
    ids = _padded_tail(gen, _ints(gen, c.n_items, (n, c.seq_len)) + 2, 0,
                       at_start=True)
    if not train:
        return {"ids": ids}
    order = torch.rand((n, c.seq_len), generator=gen, device=gen.device)
    mask_pos = torch.argsort(order, dim=1)[:, :n_masked]
    item = torch.gather(ids, 1, mask_pos)
    targets = torch.where(item > 0, item, torch.full_like(item, -1))
    ids = ids.scatter(1, mask_pos, torch.where(item > 0, MASK, item))
    return {"ids": ids, "mask_pos": mask_pos, "targets": targets,
            "negatives": _ints(gen, c.n_items, (n_negatives,)) + 2}


def cloze_targets(batch: Batch, seq_len: int) -> torch.Tensor:
    """The full cloze loss's targets [n, seq_len] of a train batch: the
    item at each masked position, −1 elsewhere."""
    mp, t = batch["mask_pos"], batch["targets"]
    out = torch.full((mp.shape[0], seq_len), -1, dtype=t.dtype,
                     device=t.device)
    return out.scatter(1, mp, t)


def bert4rec_retrieval_batch(c, gen: torch.Generator,
                             n_cand: int = N_CANDIDATES) -> Batch:
    """One sequence and ``n_cand`` unit-norm candidate rows [N, D]."""
    return {**bert4rec_batch(c, 1, gen),
            "candidates": unit_rows(gen, n_cand, c.embed_dim)}


def two_tower_batch(c, n: int, gen: torch.Generator, train: bool = False
                    ) -> Batch:
    """n user × item pairs: user ids, −1-padded histories, item ids and
    categories; and "logq" f32[n] (−log n_items, the uniform sampler's)
    when ``train``."""
    hist = _ints(gen, c.n_items, (n, c.hist_len))
    batch = {"user_id": _ints(gen, c.n_users, (n,)),
             "history": _padded_tail(gen, hist, -1, at_start=False),
             "item_id": _ints(gen, c.n_items, (n,)),
             "item_cat": _ints(gen, c.n_item_cats, (n,))}
    if train:
        batch["logq"] = torch.full((n,), -math.log(c.n_items),
                                   device=gen.device)
    return batch


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
