"""Drivers of the PyTorch port (the serving trickle demo) and the
per-shard device assignment of the sharded engine."""
__all__ = ["make_user_shard_devices"]


def __getattr__(name: str):
    # resolved at first use, so that the kernel modules can import
    # launch.mesh's constants without loading core
    if name == "make_user_shard_devices":
        from repro_torch.launch.mesh import make_user_shard_devices
        return make_user_shard_devices
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
