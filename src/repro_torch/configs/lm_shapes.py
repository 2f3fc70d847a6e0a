"""The LM shape cells (train_4k / prefill_32k / decode_32k / long_500k).

The port's copy of ``repro/configs/lm_shapes.py``: the four shape dicts
and :func:`standard_lm_cells`, on the port's builders
(``configs/base.py``).
"""
from typing import Callable, Dict, Optional

from repro_torch.configs.base import (LMCell, lm_decode_cell,
                                      lm_prefill_cell, lm_train_cell)

TRAIN_4K = dict(seq=4096, global_batch=256)
PREFILL_32K = dict(seq=32768, global_batch=32)
DECODE_32K = dict(cache=32768, global_batch=128)
LONG_500K = dict(cache=524288, global_batch=1)


def standard_lm_cells(make_config: Callable, optimizer: str = "adamw",
                      serve_depth: Optional[int] = None
                      ) -> Dict[str, LMCell]:
    """The four cells of an LM arch; ``serve_depth``: the depth its cells
    run at where one card cannot hold the model (``LMCell``)."""
    return {
        "train_4k": lm_train_cell(make_config, TRAIN_4K["global_batch"],
                                  TRAIN_4K["seq"], optimizer, serve_depth),
        "prefill_32k": lm_prefill_cell(make_config,
                                       PREFILL_32K["global_batch"],
                                       PREFILL_32K["seq"], serve_depth),
        "decode_32k": lm_decode_cell(make_config, DECODE_32K["global_batch"],
                                     DECODE_32K["cache"], serve_depth),
        # long_500k is ONE decode step against a 524,288-token cache, as
        # in the JAX package (a 500k prefill would be quadratic)
        "long_500k": lm_decode_cell(make_config, LONG_500K["global_batch"],
                                    LONG_500K["cache"], serve_depth),
    }
