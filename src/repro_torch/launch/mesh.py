"""Per-shard device assignment of the user-axis sharded engine.

The JAX package gives each user shard a device mesh
(``launch/mesh.py::make_user_shard_meshes``); the port gives each shard
one ``torch.device``, on which its ``StateStore`` keeps its state and
serving caches.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence

import torch


def make_user_shard_devices(n_shards: int,
                            devices: Optional[Sequence[Any]] = None
                            ) -> List[torch.device]:
    """One device per user shard, dealt round-robin.

    Shard ``s`` gets ``devices[s % len(devices)]``: with at least as many
    devices as shards each shard has its own, with fewer they share them,
    so on one H100 every shard gets ``cuda:0``.  ``devices`` defaults to every
    visible CUDA device and raises when there is none: pass
    ``devices=["cpu"]`` to run the shards on the CPU.
    """
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("no CUDA device: pass devices=['cpu'] to "
                               "run the shards on the CPU")
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("devices is empty")
    return [devices[s % len(devices)] for s in range(n_shards)]
