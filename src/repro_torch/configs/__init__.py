"""Model configurations of the port (plain data: the JAX package's
``configs`` modules import JAX, so the port keeps its own copies).

``REGISTRY`` maps each registered architecture's name to the config
module whose ``ARCH`` (an ``ArchDef``, ``configs/base.py``) maps shape
names to cell builders: ``tifu-knn``, the paper's system at production
width, so far.  Like ``LM_ARCHS`` it imports a module only when asked,
so importing a config loads no cell builder (tifu-knn's import the
core and kernel layers).  :func:`get_arch` resolves a name, as
``launch/dryrun.py``'s ``--arch`` takes it, and :func:`all_cells` lists
every (arch, shape) pair.  The LM and recommender cells of the JAX
registry wait for the port's sharded paths.

:func:`get_lm` resolves an LM arch name, as the training driver's
``--arch`` takes it, to its config module's ``(make_config,
smoke_config)``.
"""
import importlib
from typing import Callable, Iterator, Tuple

from repro_torch.configs.base import ArchDef

# arch name -> the module holding its ARCH (imported when asked for)
REGISTRY = {"tifu-knn": "tifu_knn"}

# arch name -> the config module (imported when asked for)
LM_ARCHS = {"granite-3-2b": "granite_3_2b",
            "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
            "deepseek-v3-671b": "deepseek_v3_671b",
            "gemma3-27b": "gemma3_27b",
            "command-r-plus-104b": "command_r_plus_104b"}


def get_arch(name: str) -> ArchDef:
    """The registered ``ArchDef`` of ``name``; raises ``KeyError``
    naming the known archs for another name."""
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return importlib.import_module(
        f"repro_torch.configs.{REGISTRY[name]}").ARCH


def all_cells() -> Iterator[Tuple[str, str]]:
    """Every registered (arch, shape) pair."""
    for name in REGISTRY:
        for shape in get_arch(name).cells:
            yield name, shape


def get_lm(name: str) -> Tuple[Callable, Callable]:
    """``(make_config, smoke_config)`` of LM arch ``name``; raises
    ``KeyError`` naming the known archs for another name."""
    if name not in LM_ARCHS:
        raise KeyError(f"unknown LM arch {name!r}; known: "
                       f"{sorted(LM_ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{LM_ARCHS[name]}")
    return mod.make_config, mod.smoke_config
