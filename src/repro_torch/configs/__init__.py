"""Model configurations of the port (plain data: the JAX package's
``configs`` modules import JAX, so the port keeps its own copies).

``REGISTRY`` maps each registered architecture's name (the JAX
registry's, in its order) to the config module whose ``ARCH`` (an
``ArchDef``, ``configs/base.py``) maps shape names to cell builders:
the five LM archs, DimeNet, the four recommenders and tifu-knn, the
paper's system at production width.  Like ``LM_ARCHS`` it imports a
module only when asked, so importing a config loads no cell builder.
:func:`get_arch` resolves a name, as ``launch/dryrun.py``'s ``--arch``
takes it, and :func:`all_cells` lists every (arch, shape) pair: the 40
cells of the ten assigned archs (``ASSIGNED``) and tifu-knn's 3.
:func:`smoke_sizes` gives a cell's sizes for a run on the CPU
(``dryrun.run_cell(name, shape, device="cpu", sizes=...)``).

:func:`get_lm` resolves an LM arch name, as the training driver's
``--arch`` takes it, to its config module's ``(make_config,
smoke_config)``.
"""
import importlib
from typing import Any, Callable, Iterator, Tuple

from repro_torch.configs.base import ArchDef, Sizes

# arch name -> the module holding its ARCH (imported when asked for)
REGISTRY = {"qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
            "deepseek-v3-671b": "deepseek_v3_671b",
            "command-r-plus-104b": "command_r_plus_104b",
            "gemma3-27b": "gemma3_27b",
            "granite-3-2b": "granite_3_2b",
            "dimenet": "dimenet_cfg",
            "dlrm-mlperf": "dlrm_mlperf",
            "deepfm": "deepfm_cfg",
            "bert4rec": "bert4rec_cfg",
            "two-tower-retrieval": "two_tower_retrieval",
            "tifu-knn": "tifu_knn"}

ASSIGNED = [n for n in REGISTRY if n != "tifu-knn"]   # the 10 assigned archs

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
    """Every registered (arch, shape) pair, in the JAX registry's
    order."""
    for name in REGISTRY:
        for shape in get_arch(name).cells:
            yield name, shape


# the CPU's sizes: LM sequences (and caches), recommender rows and
# candidates, and the divisor of each DimeNet graph (tens of nodes)
SMOKE_SEQ, SMOKE_ROWS, SMOKE_CANDIDATES = 16, 8, 128
SMOKE_GRAPH = {"full_graph_sm": 64, "minibatch_lg": 1024,
               "ogb_products": 65536, "molecule": 32}


def smoke_sizes(name: str, shape: str) -> Any:
    """Cell (``name``, ``shape``) at a size for the CPU: the arch's
    smoke config; 2 sequences of 16 tokens (or a 16-token cache) for an
    LM, 8 rows (128 candidates: the retrievals take the top 100) for
    a recommender, the graph divided to
    tens of nodes for DimeNet (the smoke widths of its kind of graph),
    ``tifu_knn.SMOKE_SIZES`` for tifu-knn."""
    arch = get_arch(name)
    if arch.family == "tifu":
        from repro_torch.configs import tifu_knn
        return tifu_knn.SMOKE_SIZES
    if arch.family == "lm":
        return Sizes(arch.make_smoke(), 2, SMOKE_SEQ)
    if arch.family == "gnn":
        from repro_torch.configs import dimenet_cfg
        kind = "molecule" if dimenet_cfg.CELLS[shape]["geometric"] \
            else "full_graph_sm"
        return Sizes(dimenet_cfg.make_config(kind, smoke=True),
                     SMOKE_GRAPH[shape])
    rows = SMOKE_CANDIDATES if shape == "retrieval_cand" else SMOKE_ROWS
    return Sizes(arch.make_smoke(), rows)


def get_lm(name: str) -> Tuple[Callable, Callable]:
    """``(make_config, smoke_config)`` of LM arch ``name``; raises
    ``KeyError`` naming the known archs for another name."""
    if name not in LM_ARCHS:
        raise KeyError(f"unknown LM arch {name!r}; known: "
                       f"{sorted(LM_ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{LM_ARCHS[name]}")
    return mod.make_config, mod.smoke_config
