"""Optimizers and their state specs; int8 gradient compression and the
serving corpus's row-wise int8 quantization (``optim.compression``)."""
from repro_torch.optim.optimizers import (OptState, adafactor,
                                          adafactor_state_pspecs, adamw,
                                          adamw_state_pspecs,
                                          clip_by_global_norm, sgd,
                                          sgd_state_pspecs)

__all__ = ["adamw", "adafactor", "sgd", "clip_by_global_norm", "OptState",
           "adamw_state_pspecs", "adafactor_state_pspecs",
           "sgd_state_pspecs"]
