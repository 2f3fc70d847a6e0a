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
data sheet).  ``launch/roofline.py`` divides counted work by them.  The
shared-memory sizes are the H100's (CUDA C++ Programming Guide, compute
capability 9.0): the kernels' plans and the static analysis's KC03 read
them here, and ``chip_smoke.py`` holds them to the device's properties.
"""
PEAK_FLOPS_BF16 = 989e12   # bf16/f16 on the tensor cores, FLOP/s per card
PEAK_FLOPS_FP32 = 67e12    # fp32 outside the tensor cores (TF32 is off)
PEAK_OPS_INT8 = 1979e12    # int8 on the tensor cores, OP/s per card
HBM_BW = 3.35e12           # HBM3, bytes/s per card
LINK_BW = 450e9            # NVLink, bytes/s per card and direction
# shared memory one block may opt in to (cudaDevAttrMaxSharedMemoryPerBlockOptin:
# 227 KB), and one SM's (228 KB, of which the card reserves 1 KB a block)
SMEM_PER_BLOCK_OPTIN = 232_448
SMEM_PER_SM = 233_472


def __getattr__(name: str):
    # resolved at first use: the kernel modules read the constants above,
    # and core (which imports the kernels) must not load with them
    if name == "make_user_shard_devices":
        from repro_torch.core.types import make_user_shard_devices
        return make_user_shard_devices
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

__all__ = ["make_user_shard_devices", "PEAK_FLOPS_BF16", "PEAK_FLOPS_FP32",
           "PEAK_OPS_INT8", "HBM_BW", "LINK_BW", "SMEM_PER_BLOCK_OPTIN",
           "SMEM_PER_SM"]
