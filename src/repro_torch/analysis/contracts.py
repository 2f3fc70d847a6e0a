"""Kernel contracts of the port: the declared side of the KC rules.

Every C entry of ``kernels/csrc/`` registers one :class:`KernelContract`
at import time, in a sidecar ``register(...)`` block at the bottom of
the kernel module whose wrapper calls it (as the JAX package's kernel
modules do for their ``pallas_call`` sites).  The contract states what
the entry promises: the ``__global__`` kernels it launches, their
shared memory at the largest shapes the plan accepts, each
ceil-division or persistent grid's tail guard, exact-parity status, the
tensor-core accumulate types and the running accumulators' types, and
how many instances ptxas compiles of each kernel; ``kernel_rules``
checks the sources against it, ``resources`` the compiled library.

The registry key is ``(module, entry)``; ``repro_torch.analysis.linter``
imports :data:`KERNEL_MODULES` to fill it before scanning.  This module
imports nothing but the standard library, so a kernel module registers
its contracts at no cost.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Tuple

# C types a running accumulator may have (KC08)
ACCUMULATOR_TYPES = ("float", "int", "int32_t")


@dataclasses.dataclass(frozen=True)
class Accumulators:
    """``mma``: the accumulate (D) types of the tensor-core instructions
    the entry's source and its headers hold (``"f32"``, ``"s32"``);
    ``running``: kernel -> ((name, C type), ...) of its running
    accumulators, each declared in the kernel's body (or a function it
    calls in its source) in that type."""

    mma: Tuple[str, ...] = ()
    running: Mapping[str, Tuple[Tuple[str, str], ...]] = \
        dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class KernelContract:
    """Declared invariants of one C entry of ``kernels/csrc/``.

    ``module`` is the port's kernel module whose wrapper calls ``entry``
    (the ``extern "C"`` name, a key of ``build.SIGNATURES``), defined in
    ``source`` (a file of ``csrc/``); ``kernels`` are the ``__global__``
    kernels it launches (a header's kernel is named by every contract
    whose source launches it).  ``smem_model(**max_shapes)`` gives each
    kernel's dynamic shared memory at the largest shapes the plan
    accepts (kernels it leaves out take none), ``static_smem`` each
    kernel's ``__shared__`` arrays; their sum must fit a block's opt-in
    (KC03).  ``tail`` maps each kernel launched on a ceil-division or
    persistent grid to the guard (a source snippet, whitespace aside)
    that its body holds (KC04).  ``exact_parity=False`` exempts the
    source and its headers from KC07: only the flash attention sources,
    whose oracle is allclose, take it.  ``instantiations`` is how many
    entries ptxas compiles of each kernel and ``spill_bytes`` the bytes
    each instance may spill (ptxas's spill stores; 0 where absent), both
    checked against the verbose build's log on the card
    (``resources.check_compiled``).
    """

    module: str
    entry: str
    source: str
    kernels: Tuple[str, ...]
    smem_model: Optional[Callable[..., Mapping[str, int]]] = None
    max_shapes: Optional[Mapping[str, int]] = None
    static_smem: Mapping[str, int] = dataclasses.field(default_factory=dict)
    tail: Mapping[str, str] = dataclasses.field(default_factory=dict)
    exact_parity: bool = True
    accumulators: Accumulators = Accumulators()
    instantiations: Mapping[str, int] = \
        dataclasses.field(default_factory=dict)
    spill_bytes: Mapping[str, int] = dataclasses.field(default_factory=dict)

    def max_smem_bytes(self) -> Dict[str, int]:
        """Each kernel's dynamic shared memory at the declared max
        shapes (0 for a kernel the model leaves out)."""
        if self.smem_model is None or self.max_shapes is None:
            raise ValueError(
                f"{self.module}.{self.entry}: no shared-memory model")
        model = dict(self.smem_model(**dict(self.max_shapes)))
        return {k: int(model.get(k, 0)) for k in self.kernels}


REGISTRY: Dict[Tuple[str, str], KernelContract] = {}


def register(contract: KernelContract) -> KernelContract:
    """Register ``contract`` under ``(module, entry)`` (idempotent)."""
    REGISTRY[(contract.module, contract.entry)] = contract
    return contract


# The port's kernel modules: the linter imports them to fill the
# registry, and only their C entries may launch a kernel.
KERNEL_MODULES = (
    "repro_torch.kernels.knn_topk",
    "repro_torch.kernels.serving_topn",
    "repro_torch.kernels.sparse_row_scatter",
    "repro_torch.kernels.sparse_row_gather",
    "repro_torch.kernels.decayed_scatter",
    "repro_torch.kernels.flash_attention",
)

# The sources that may set exact_parity=False: B9's and 9b's, whose
# oracle is allclose (their softmax takes ex2.approx).
INEXACT_SOURCES = ("flash_attention.cu", "flash_attention_wgmma.cu",
                   "flash_attention_bwd.cu", "flash_attention_bwd_wgmma.cu")

# Intentionally duplicated function pairs that must stay AST-identical
# (OR03).  The JAX package's two pairs have no counterpart here: the
# port's knn_topk.tiled_sqnorm is ref.tiled_sqnorm_ref itself, and
# core/knn.py calls ref.pairwise_scores.
DUPLICATE_PAIRS: Tuple = ()
