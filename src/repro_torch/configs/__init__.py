"""Model configurations of the port (plain data: the JAX package's
``configs`` modules import JAX, so the port keeps its own copies).

:func:`get_lm` resolves an LM arch name, as the training driver's
``--arch`` takes it, to its config module's ``(make_config,
smoke_config)``: the counterpart of the reference's ``get_arch`` for the
five LM archs.  The arch registry (``ArchDef``) and its mesh cells stay
with the JAX package.
"""
import importlib
from typing import Callable, Tuple

# arch name -> the config module (imported when asked for)
LM_ARCHS = {"granite-3-2b": "granite_3_2b",
            "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
            "deepseek-v3-671b": "deepseek_v3_671b",
            "gemma3-27b": "gemma3_27b",
            "command-r-plus-104b": "command_r_plus_104b"}


def get_lm(name: str) -> Tuple[Callable, Callable]:
    """``(make_config, smoke_config)`` of LM arch ``name``; raises
    ``KeyError`` naming the known archs for another name."""
    if name not in LM_ARCHS:
        raise KeyError(f"unknown LM arch {name!r}; known: "
                       f"{sorted(LM_ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{LM_ARCHS[name]}")
    return mod.make_config, mod.smoke_config
