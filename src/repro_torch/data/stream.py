"""Event-stream generation for the streaming engine (paper §6.1 setup).

~1/1000 users issue deletion requests, each deleting 10% of their
baskets; item deletions are optional.  The same seed gives the same
events as the JAX package's ``make_stream``.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.core.types import (KIND_ADD_BASKET, KIND_DEL_BASKET,
                                    KIND_DEL_ITEM)
from repro_torch.streaming.engine import Event


def make_stream(histories: Dict[int, List[np.ndarray]],
                deletion_user_rate: float = 1e-3,
                deletion_basket_frac: float = 0.10,
                item_deletion_rate: float = 0.0,
                seed: int = 0) -> List[Event]:
    """Basket additions round-robin over users (each user's baskets in
    order), then deletion requests."""
    rng = np.random.default_rng(seed)
    events: List[Event] = []
    cursors = {u: 0 for u in histories}
    added = {u: 0 for u in histories}
    active = [u for u in histories if histories[u]]
    while active:
        nxt = []
        for u in active:
            events.append(Event(KIND_ADD_BASKET, u,
                                items=histories[u][cursors[u]]))
            cursors[u] += 1
            added[u] += 1
            if cursors[u] < len(histories[u]):
                nxt.append(u)
        active = nxt

    users = list(histories)
    n_del_users = max(1, int(len(users) * deletion_user_rate))
    del_users = rng.choice(users, size=n_del_users, replace=False)
    for u in del_users:
        n = added[u]
        n_del = max(1, int(n * deletion_basket_frac))
        remaining = n          # positions follow the shrinking history
        for _ in range(n_del):
            if remaining == 0:
                break
            pos = int(rng.integers(0, remaining))
            events.append(Event(KIND_DEL_BASKET, int(u), pos=pos))
            remaining -= 1
    if item_deletion_rate > 0:
        for u in rng.choice(users, size=max(1, int(len(users)
                                                   * item_deletion_rate)),
                            replace=False):
            if added[u] == 0:
                continue
            pos = int(rng.integers(0, max(added[u] - 1, 1)))
            item = int(histories[u][pos][0])
            events.append(Event(KIND_DEL_ITEM, int(u), pos=pos, item=item))
    return events
