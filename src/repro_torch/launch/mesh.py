"""Per-shard device assignment of the user-axis sharded engine, and the
H100's constants for the roofline model.

The JAX package gives each user shard a device mesh
(``launch/mesh.py::make_user_shard_meshes``); the port gives each shard
one ``torch.device``, on which its ``StateStore`` keeps its state and
serving caches.  The dealing itself lives in ``core/types.py`` beside
``resolve_device``, so that the config layer can deal devices without
importing the launch layer.

The constants are the counterpart of the JAX package's TPU v5e ones:
the NVIDIA H100 SXM's published dense peaks at its 700 W limit (NVIDIA
data sheet).  ``launch/roofline.py`` divides counted work by them.
"""
from repro_torch.core.types import make_user_shard_devices

PEAK_FLOPS_BF16 = 989e12   # bf16/f16 on the tensor cores, FLOP/s per card
PEAK_FLOPS_FP32 = 67e12    # fp32 outside the tensor cores (TF32 is off)
PEAK_OPS_INT8 = 1979e12    # int8 on the tensor cores, OP/s per card
HBM_BW = 3.35e12           # HBM3, bytes/s per card
LINK_BW = 450e9            # NVLink, bytes/s per card and direction

__all__ = ["make_user_shard_devices", "PEAK_FLOPS_BF16", "PEAK_FLOPS_FP32",
           "PEAK_OPS_INT8", "HBM_BW", "LINK_BW"]
