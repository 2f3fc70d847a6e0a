"""Launch: production meshes, the dry run, training and serving drivers,
roofline analysis, and the per-shard device assignment of the sharded
engine."""
from repro_torch.launch.mesh import (make_production_mesh, make_rules,
                                     make_test_mesh, make_user_shard_meshes)

__all__ = ["make_production_mesh", "make_rules", "make_test_mesh",
           "make_user_shard_meshes", "make_user_shard_devices"]


def __getattr__(name: str):
    # resolved at first use, so that the kernel modules can import
    # launch.mesh's constants without loading core
    if name == "make_user_shard_devices":
        from repro_torch.launch.mesh import make_user_shard_devices
        return make_user_shard_devices
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
