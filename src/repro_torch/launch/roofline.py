"""Roofline terms of a counted run on the H100, and the kernels' bounds.

The port's counterpart of the JAX package's ``launch/roofline.py``.
Three terms per cell, in seconds, from the work ``launch/cost.py``
counts (per card; on the mesh route per rank, the collective bytes
those of the rank's ``torch.distributed`` collectives):

  compute    = Σ_dtype FLOPs / peak(dtype)
  memory     = HBM bytes / HBM bandwidth
  collective = collective bytes / link bandwidth

at the H100's published peaks (``launch/mesh.py``).  With bf16 FLOPs
only, ``compute`` is the JAX formula.  :func:`kernel_bound` is the least
time the card could take for one call of a hand-written kernel, from
the work ``kernels/work.py`` counts on its inputs: the larger of its
bytes over the HBM bandwidth and its operations over their peak.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.kernels import work
from repro_torch.launch.cost import Costs
from repro_torch.launch.mesh import (HBM_BW, LINK_BW, PEAK_FLOPS_BF16,
                                     PEAK_FLOPS_FP32, PEAK_OPS_INT8)

# the peak of each dtype class of operations
PEAKS = {"bf16": PEAK_FLOPS_BF16, "f32": PEAK_FLOPS_FP32,
         "int8": PEAK_OPS_INT8}


@dataclasses.dataclass
class RooflineTerms:
    flops: float
    hbm_bytes: float
    coll_bytes: float
    chips: int
    coll_detail: Dict[str, float]
    flops_by_dtype: Optional[Dict[str, float]] = None

    @property
    def t_compute(self) -> float:
        by = self.flops_by_dtype or {"bf16": self.flops}
        return sum(n / PEAKS[cls] for cls, n in by.items())

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    def as_dict(self) -> dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes, "chips": self.chips,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "coll_detail": {k: v for k, v in self.coll_detail.items()
                            if k != "_counts"},
            "coll_counts": self.coll_detail.get("_counts", {}),
            "flops_by_dtype": dict(self.flops_by_dtype or {}),
        }


def analyze(costs: Costs, chips: int = 1) -> RooflineTerms:
    """The roofline terms of ``costs`` (one card's counted run)."""
    coll = dict(costs.coll)
    coll["_counts"] = dict(costs.coll_counts)
    return RooflineTerms(flops=costs.flops, hbm_bytes=costs.bytes,
                         coll_bytes=costs.coll_bytes, chips=chips,
                         coll_detail=coll,
                         flops_by_dtype=dict(costs.flops_by_dtype))


def kernel_terms(name: str, **inputs) -> Tuple[float, float]:
    """(bytes' seconds, operations' seconds) of one call of
    ``kernels/work.py``'s ``name`` (a kernel's call form, e.g.
    ``"knn_topk"``) on ``inputs``."""
    w = getattr(work, name)(**inputs)
    return w.bytes / HBM_BW, w.ops / PEAKS[w.dtype]


def kernel_bound(name: str, **inputs) -> Tuple[float, str]:
    """(seconds, "bytes" | "operations"): the bound of one call of
    ``name`` on ``inputs``, the larger of :func:`kernel_terms`."""
    t_bytes, t_ops = kernel_terms(name, **inputs)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")
