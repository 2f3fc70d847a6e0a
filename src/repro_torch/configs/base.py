"""Cell programs: (architecture × input shape) → a runnable program.

The port's counterpart of the JAX package's ``configs/base.py``.  Each
registered architecture has an ``ArchDef`` whose ``cells`` map a shape
name to a builder ``(device=None, seed=0, sizes=None) -> CellProgram``:
the builder makes the cell's inputs as concrete tensors on ``device``
(CUDA unless the caller names another) from ``seed``, and
``prog.fn(*prog.args)`` runs the cell once (``launch/dryrun.py``).
There is no sharding spec and no donation: the port places each tensor
on its device, and its appliers update the state in place.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict


@dataclasses.dataclass
class CellProgram:
    """One runnable cell: ``fn(*args)``.

    ``reduced`` names each cut of the published configuration as
    ``{what: "published → used (why)"}``; empty where nothing is cut.
    ``model_flops_per_step`` counts the model's operations for one call
    (an FMA as two), as the JAX cell defines them.
    """
    fn: Callable
    args: tuple
    description: str = ""
    model_flops_per_step: float = 0.0
    reduced: Dict[str, str] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ArchDef:
    name: str
    family: str                   # "tifu" (the port's registered family)
    cells: Dict[str, Callable]    # shape -> builder -> CellProgram
    make_smoke: Callable          # () -> the smoke config
    notes: str = ""
