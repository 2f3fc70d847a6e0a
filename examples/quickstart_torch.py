"""Quickstart on the PyTorch port: TIFU-kNN next-basket recommendation
with O(1) learning and low-latency forgetting, the paper's full loop.
The port of ``examples/quickstart.py``, step for step; the user vectors
are built and maintained through ``apply_update_batch`` (the paper's
update rules on the port's batched state).  It runs on the CUDA card
unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import (KIND_ADD_BASKET, KIND_DEL_BASKET,
                              KIND_DEL_ITEM, PAD_ID, StreamState,
                              UpdateBatch, apply_update_batch, knn)
from repro_torch.core.tifu import user_vector_ragged
from repro_torch.data import synthetic

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda",
                help="torch device of the state and the serving path")
args = ap.parse_args()
dev = torch.device(args.device)


def sync() -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def event_batch(kinds, rows, baskets=None, pos=None, items=None):
    """One UpdateBatch on ``dev``: a row per event."""
    n = len(kinds)
    basket_items = np.full((n, max_b), PAD_ID, np.int32)
    for r, b in enumerate(baskets or []):
        basket_items[r, :len(b)] = b

    def col(x, fill):
        return torch.tensor(x if x is not None else [fill] * n,
                            dtype=torch.int32, device=dev)

    return UpdateBatch(kind=col(kinds, 0), user=col(rows, 0),
                       basket_items=torch.from_numpy(basket_items).to(dev),
                       basket_pos=col(pos, 0), item=col(items, PAD_ID))


# 1. a TaFeng-statistics synthetic dataset
ds = synthetic.generate("tafeng", scale=0.03, seed=0)
params = ds.params
train, test = ds.train_test_split()
users = sorted(train)
print(f"dataset: {len(users)} users, {params.n_items} items")

# 2. "train" = build user vectors incrementally (Eq. 7-9): one
# UpdateBatch per basket index, so every user appears once per batch
max_n = max(len(train[u]) for u in users)
max_b = max(len(b) for u in users for b in train[u])
state = StreamState.zeros(len(users), params.n_items, max_n, max_b,
                          device=dev)
sync()
t0 = time.perf_counter()
for t in range(max_n):
    rows = [r for r, u in enumerate(users) if t < len(train[u])]
    apply_update_batch(state, event_batch(
        [KIND_ADD_BASKET] * len(rows), rows,
        baskets=[train[users[r]][t] for r in rows]), params)
sync()
print(f"built {sum(len(train[u]) for u in users)} baskets in "
      f"{time.perf_counter()-t0:.2f}s (O(1) per basket)")

# 3. recommend: personal component + k nearest neighbours
corpus = state.materialized_user_vecs()
pred = knn.predict(corpus, corpus, k=params.k_neighbors,
                   alpha=params.alpha, exclude_self=True)
recs = knn.recommend_topn(pred, 10).cpu().numpy()
truth = [test[u] for u in users]
print(f"Recall@10 = {knn.recall_at_k(recs, truth, 10):.4f}   "
      f"NDCG@10 = {knn.ndcg_at_k(recs, truth, 10):.4f}")

# 4. a user exercises the right to be forgotten: delete their 1st basket
victim = users[0]
delete = event_batch([KIND_DEL_BASKET], [0], pos=[0])
sync()
t0 = time.perf_counter_ns()
apply_update_batch(state, delete, params)
sync()
dt_us = (time.perf_counter_ns() - t0) / 1e3
print(f"deleted basket 0 of user {victim} in {dt_us:.0f} µs (Eq. 10-12)")

# 5. verify: identical to retraining from scratch on the surviving data
n_groups = int(state.n_groups[0])
sizes = state.group_sizes[0, :n_groups].tolist()
scratch = user_vector_ragged(train[victim][1:], sizes, params)
maintained = state.materialized_user_vecs()[0].double().cpu().numpy()
err = np.max(np.abs(maintained - scratch))
print(f"max |maintained − retrained| = {err:.2e}  (same model, "
      f"{dt_us:.0f} µs instead of a full retrain)")

# 6. and forget a single item from a basket (Eq. 13)
item = int(state.history[0, 0, 0])
apply_update_batch(state, event_batch([KIND_DEL_ITEM], [0], pos=[0],
                                      items=[item]), params)
print(f"forgot item {item} from user {victim}'s basket 0 — done.")
