"""Repo-level driver: run every rule family over the port and collect a
Report.

This is the only analysis module that imports the port's code (the
kernel modules, to fill the contract registry, and ``launch/mesh.py``
for the card's shared-memory constant); the rule modules stay pure
text, so the corpus can drive known-bad snippets through them without
importing them.
"""
from __future__ import annotations

import importlib
from pathlib import Path
from typing import List, Optional

from repro_torch.analysis import engine_rules, kernel_rules, oracle_rules, \
    resources
from repro_torch.analysis.contracts import (DUPLICATE_PAIRS, KERNEL_MODULES,
                                            REGISTRY)
from repro_torch.analysis.report import Finding, Report
from repro_torch.launch.mesh import SMEM_PER_BLOCK_OPTIN


def default_root() -> Path:
    """The repo root, resolved from this file (src/repro_torch/analysis/)."""
    return Path(__file__).resolve().parents[3]


def load_contracts() -> None:
    """Import every kernel module so its register() blocks run."""
    for module in KERNEL_MODULES:
        importlib.import_module(module)


def lint_repo(root: Optional[Path] = None) -> Report:
    """Run all KC/OR/EN rules over the port at ``root``."""
    root = Path(root) if root is not None else default_root()
    load_contracts()
    findings: List[Finding] = []
    findings += kernel_rules.check_kernels(root, REGISTRY,
                                           SMEM_PER_BLOCK_OPTIN)
    findings += oracle_rules.check_oracle_pairing(root)
    findings += oracle_rules.check_duplicates(root, DUPLICATE_PAIRS)
    findings += engine_rules.check_commit_paths(root)
    findings += engine_rules.check_fault_registry(root)
    findings += engine_rules.check_bench_keys(root / "BENCH_torch.json")
    return Report(findings=sorted(findings))


def check_build_log(log: str, smem_optin: int) -> Report:
    """The compiled library (a ``-Xptxas -v`` build log) against the
    registry, at the card's per-block opt-in ``smem_optin``."""
    load_contracts()
    return Report(findings=sorted(resources.check_compiled(
        REGISTRY, resources.parse_ptxas(log), smem_optin)))
