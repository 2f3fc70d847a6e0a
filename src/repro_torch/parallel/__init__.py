"""Sharding rules, their specs as DTensor placements, and the user-axis
partitioning of the sharded deployment."""
from repro_torch.parallel.sharding import (MeshShape, Sharding,
                                           ShardingRules, Spec,
                                           UserShardSpec, batch_axes,
                                           distribute, logical_to_physical,
                                           param_spec, pick_fsdp_dim,
                                           placements, shard_params_pytree,
                                           zero_like_sharded)

__all__ = ["ShardingRules", "logical_to_physical", "shard_params_pytree",
           "zero_like_sharded", "pick_fsdp_dim", "param_spec", "batch_axes",
           "Spec", "MeshShape", "Sharding", "placements", "distribute",
           "UserShardSpec"]
