"""two-tower-retrieval [RecSys'19 YouTube]: embed_dim=256, towers
1024-512-256, dot interaction.

The port's copy of ``repro/configs/two_tower_retrieval.py``:
``make_config`` and ``smoke_config`` only (the arch registry and its
cells stay with the JAX package).
"""
from repro_torch.models import two_tower


def make_config() -> two_tower.TwoTowerConfig:
    """The published widths: 5M users, 2M items, D = 256."""
    return two_tower.TwoTowerConfig()


def smoke_config() -> two_tower.TwoTowerConfig:
    """Narrow tables and towers, for tests on the CPU."""
    return two_tower.TwoTowerConfig(n_users=1000, n_items=500,
                                    n_item_cats=20, hist_len=8,
                                    embed_dim=16, tower_mlp=(32, 16))
