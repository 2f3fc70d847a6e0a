"""Pytree checkpoints in the JAX package's on-disk format (the port of
``repro/checkpoint``)."""
from repro_torch.checkpoint.pytree import (AsyncCheckpointer, flatten,
                                           latest_step, restore_pytree,
                                           save_pytree)

__all__ = ["AsyncCheckpointer", "flatten", "latest_step", "restore_pytree",
           "save_pytree"]
