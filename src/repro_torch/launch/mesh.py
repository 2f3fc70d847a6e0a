"""Production meshes, per-shard device assignment of the user-axis
sharded engine, and the H100's constants for the roofline model.

The meshes are the JAX package's, as logical ``MeshShape`` objects: the
single-pod (16, 16) ``("data", "model")`` and the multi-pod (2, 16, 16)
``("pod", "data", "model")``, so every spec the rules give at them is
the JAX package's.  ``MeshShape.device_mesh`` builds the
``torch.distributed`` mesh of one where a process group of its size
exists.

:func:`make_user_shard_meshes` gives each user shard a mesh as the JAX
package does; the sharded engine keeps each shard's state and serving
caches on the first device of its mesh, the one
``make_user_shard_devices`` deals it.  That dealing lives in
``core/types.py`` beside ``resolve_device``, so that the config layer
can deal devices without importing the launch layer.

The constants are the counterpart of the JAX package's TPU v5e ones:
the NVIDIA H100 SXM's published dense peaks at its 700 W limit (NVIDIA
data sheet).  ``launch/roofline.py`` divides counted work by them.  The
shared-memory sizes are the H100's (CUDA C++ Programming Guide, compute
capability 9.0): the kernels' plans and the static analysis's KC03 read
them here, and ``chip_smoke.py`` holds them to the device's properties.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence

import torch

from repro_torch.parallel.sharding import MeshShape, ShardingRules

PEAK_FLOPS_BF16 = 989e12   # bf16/f16 on the tensor cores, FLOP/s per card
PEAK_FLOPS_FP32 = 67e12    # fp32 outside the tensor cores (TF32 is off)
PEAK_OPS_INT8 = 1979e12    # int8 on the tensor cores, OP/s per card
HBM_BW = 3.35e12           # HBM3, bytes/s per card
LINK_BW = 450e9            # NVLink, bytes/s per card and direction
# shared memory one block may opt in to (cudaDevAttrMaxSharedMemoryPerBlockOptin:
# 227 KB), and one SM's (228 KB, of which the card reserves 1 KB a block)
SMEM_PER_BLOCK_OPTIN = 232_448
SMEM_PER_SM = 233_472




def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """(16, 16) ``("data", "model")``, or with ``multi_pod`` (2, 16, 16)
    ``("pod", "data", "model")``: 256 or 512 devices."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_rules(mesh: Any = None) -> ShardingRules:
    """The default rules: batch and FSDP over (pod, data), TP over
    model."""
    return ShardingRules(batch=("pod", "data"), fsdp=("pod", "data"),
                         tensor="model", expert="model", context="model")


def make_test_mesh(n_data: int = 2, n_model: int = 4) -> MeshShape:
    """A small ``("data", "model")`` mesh for CI-size runs."""
    return MeshShape(("data", "model"), (n_data, n_model))


def make_user_shard_meshes(n_shards: int,
                           devices: Optional[Sequence[Any]] = None
                           ) -> List[MeshShape]:
    """One ``("data", "model")`` mesh per user shard (DESIGN.md §7):
    shard ``s`` gets ``devices[s::n_shards]`` (or ``devices[s %
    len(devices)]`` where that is empty, so shards share devices when
    there are fewer devices than shards) as a (len, 1) mesh.  The first
    device of each is the one ``make_user_shard_devices`` deals the
    shard.  ``devices`` defaults to every visible CUDA device and raises
    when there is none (pass ``devices=["cpu"]``)."""
    from repro_torch.core.types import make_user_shard_devices
    firsts = make_user_shard_devices(n_shards, devices)
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    groups = [devices[s::n_shards] or [firsts[s]] for s in range(n_shards)]
    return [MeshShape(("data", "model"), (len(g), 1), tuple(g))
            for g in groups]


def __getattr__(name: str):
    # resolved at first use: the kernel modules read the constants above,
    # and core (which imports the kernels) must not load with them
    if name == "make_user_shard_devices":
        from repro_torch.core.types import make_user_shard_devices
        return make_user_shard_devices
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

__all__ = ["make_production_mesh", "make_rules", "make_test_mesh",
           "make_user_shard_meshes", "make_user_shard_devices",
           "PEAK_FLOPS_BF16", "PEAK_FLOPS_FP32",
           "PEAK_OPS_INT8", "HBM_BW", "LINK_BW", "SMEM_PER_BLOCK_OPTIN",
           "SMEM_PER_SM"]
