"""Drivers of the PyTorch port (the serving trickle demo) and the
per-shard device assignment of the sharded engine."""
from repro_torch.launch.mesh import make_user_shard_devices

__all__ = ["make_user_shard_devices"]
