"""Sharding rules, their specs as DTensor placements, the user-axis
partitioning of the sharded deployment, and SPMD execution over a named
``DeviceMesh`` (``spmd``)."""
from repro_torch.parallel.sharding import (MeshShape, Sharding,
                                           ShardingRules, Spec,
                                           UserShardSpec, batch_axes,
                                           distribute, logical_to_physical,
                                           param_spec, pick_fsdp_dim,
                                           placements, shard_params_pytree,
                                           zero_like_sharded)
from repro_torch.parallel.spmd import (all_gather, axis_index, axis_size,
                                       constrain, enter, gather_full,
                                       pmax, psum, psum_scatter, pvary,
                                       redistribute, shard_map,
                                       shard_module)

__all__ = ["ShardingRules", "logical_to_physical", "shard_params_pytree",
           "zero_like_sharded", "pick_fsdp_dim", "param_spec", "batch_axes",
           "Spec", "MeshShape", "Sharding", "placements", "distribute",
           "UserShardSpec", "shard_map", "constrain", "redistribute",
           "axis_index", "axis_size", "psum", "pmax", "pvary", "all_gather",
           "psum_scatter", "gather_full", "shard_module", "enter"]
