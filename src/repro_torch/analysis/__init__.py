"""Static analysis of the port: kernel contracts and engine invariants.

The port's counterpart of ``repro.analysis``, in the same three rule
families and with the same rule ids:

* ``KC*`` — kernel contracts: every C entry of ``kernels/csrc/``
  carries a registered :class:`~repro_torch.analysis.contracts.KernelContract`,
  and its prototype, launches, shared memory, tail guards, tensor-core
  accumulate types, exactness and accumulators match the CUDA text
  (``cuda_src`` reads it; ``kernel_rules`` checks it); on the card,
  ``resources`` holds ptxas's report of the build to the same contracts;
* ``OR*`` — oracle pairing: every dispatcher in ``kernels/ops.py``
  reaches a plain version in ``kernels/ref.py`` and a test uses both;
* ``EN*`` — engine invariants of ``streaming/``: durable writes reach
  the atomic commit, fault sites form a closed registry, BENCH keys
  follow the naming rule.

The rule modules use only the standard library and read text (``ast``
for Python, a lexical reader for CUDA), so kernel modules register
their contracts at import time at no cost.  The driver is
``repro_torch.analysis.linter`` (CLI: ``tools/lint_torch_kernels.py``).
Nothing here imports JAX or the JAX package.
"""
from repro_torch.analysis import bench_schema, contracts, report
from repro_torch.analysis.contracts import Accumulators, KernelContract, \
    register
from repro_torch.analysis.report import Finding, Report

__all__ = ["bench_schema", "contracts", "report", "Accumulators",
           "KernelContract", "register", "Finding", "Report"]
