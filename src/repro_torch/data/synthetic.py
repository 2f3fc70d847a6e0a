"""Synthetic next-basket datasets matching the paper's dataset statistics
(Table 1); TaFeng/Instacart/ValuedShopper are modelled by their
published statistics:

  dataset        #users  #items  #baskets  avg |b|  avg #b/user
  TaFeng          13949   11997    79423     6.2       5.7
  Instacart       19935    7999   158933     8.9       8.0
  ValuedShopper   10000    7874   568573     9.1      56.9

Zipf item popularity + per-user preference pools with repeat-purchase
bias, Poisson basket counts/sizes around the dataset means; ``scale``
shrinks users/items proportionally.  The same seed gives the same
histories as the JAX package's generator.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from repro_torch.core.types import PAPER_HYPERPARAMS, TifuParams

DATASET_STATS = {
    "tafeng": dict(n_users=13949, n_items=11997, avg_baskets=5.7,
                   avg_basket_size=6.2),
    "instacart": dict(n_users=19935, n_items=7999, avg_baskets=8.0,
                      avg_basket_size=8.9),
    "valuedshopper": dict(n_users=10000, n_items=7874, avg_baskets=56.9,
                          avg_basket_size=9.1),
}


@dataclasses.dataclass
class BasketDataset:
    """Per-user chronological baskets plus the dataset's parameters."""

    name: str
    n_items: int
    histories: Dict[int, List[np.ndarray]]   # user → chronological baskets
    params: TifuParams


def generate(name: str, seed: int = 0, scale: float = 1.0,
             repeat_bias: float = 0.6) -> BasketDataset:
    """Generate a dataset with the named dataset's statistics."""
    stats = DATASET_STATS[name]
    rng = np.random.default_rng(seed)
    n_users = max(int(stats["n_users"] * scale), 16)
    n_items = max(int(stats["n_items"] * scale), 64)
    pop = 1.0 / np.arange(1, n_items + 1) ** 1.1      # Zipf popularity
    pop /= pop.sum()

    histories: Dict[int, List[np.ndarray]] = {}
    for u in range(n_users):
        n_b = max(2, rng.poisson(stats["avg_baskets"]))
        pool_size = max(8, int(stats["avg_basket_size"] * 3))
        pool = rng.choice(n_items, size=pool_size, replace=False, p=pop)
        baskets = []
        for _ in range(n_b):
            size = max(1, rng.poisson(stats["avg_basket_size"]))
            size = min(size, n_items)
            n_rep = int(size * repeat_bias)
            rep = rng.choice(pool, size=min(n_rep, pool_size), replace=False)
            n_new = size - len(rep)
            fresh = rng.choice(n_items, size=max(n_new, 0), replace=False,
                               p=pop)
            basket = np.unique(np.concatenate([rep, fresh]))[:size]
            baskets.append(basket.astype(np.int64))
        histories[u] = baskets

    base = PAPER_HYPERPARAMS[name]
    params = TifuParams(
        n_items=n_items, group_size=base.group_size, r_b=base.r_b,
        r_g=base.r_g,
        k_neighbors=min(base.k_neighbors, max(n_users // 4, 1)),
        alpha=base.alpha)
    return BasketDataset(name=name, n_items=n_items, histories=histories,
                         params=params)
