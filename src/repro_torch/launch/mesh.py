"""Per-shard device assignment of the user-axis sharded engine.

The JAX package gives each user shard a device mesh
(``launch/mesh.py::make_user_shard_meshes``); the port gives each shard
one ``torch.device``, on which its ``StateStore`` keeps its state and
serving caches.  The dealing itself lives in ``core/types.py`` beside
``resolve_device``, so that the config layer can deal devices without
importing the launch layer.
"""
from repro_torch.core.types import make_user_shard_devices

__all__ = ["make_user_shard_devices"]
