"""Seeded-violation corpus runner for the port's rules.

Each file under ``tests/analysis_corpus_torch/`` is a known-bad snippet
(``.cu`` for the KC rules, ``.py`` for OR/EN, ``.json`` for EN03) —
parsed, never compiled or imported — and ``manifest.json`` maps it to
the checker that must flag it and the rule ids it must raise, exactly:
a case passes when the checker reports those rules and no other.  The
corpus is the analyzer's own regression suite
(``tools/lint_torch_kernels.py --selftest``).
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List

from repro_torch.analysis import astutil, cuda_src, engine_rules, \
    kernel_rules, oracle_rules
from repro_torch.analysis.contracts import Accumulators, KernelContract
from repro_torch.launch.mesh import SMEM_PER_BLOCK_OPTIN

# Closed fault-site registry the corpus `faults` checker validates
# against (a fixed stand-in for the real faults.py registries).
CORPUS_FAULT_SITES = frozenset({"npz.pre_write", "LATEST.pre_replace"})

# ctypes argtypes of the corpus entry
# ``extern "C" int thing_launch(float* out, int n, void* stream)``
CORPUS_SIGNATURE = ["c_void_p", "c_int", "c_void_p"]


def _no_smem() -> Dict[str, int]:
    return {}


def _tile_smem(rows: int) -> Dict[str, int]:
    return {"thing_kernel": rows * 64 * 4}


def _contract(source: str, **kw) -> KernelContract:
    base: Dict[str, object] = dict(
        module="corpus", entry="thing_launch", source=source,
        kernels=("thing_kernel",), smem_model=_no_smem, max_shapes={},
        tail={"thing_kernel": "if (i >= n) return"},
        accumulators=Accumulators(running={
            "thing_kernel": (("acc", "float"),)}))
    base.update(kw)
    return KernelContract(**base)  # type: ignore[arg-type]


# Contract overrides per `kernel` case — written so that only the seeded
# defect fires (the base contract fits ok_clean.cu).
CORPUS_OVERRIDES: Dict[str, Dict[str, object]] = {
    "kc03_smem_blowup.cu": dict(smem_model=_tile_smem,
                                max_shapes={"rows": 1024}),
    "kc03_no_attribute.cu": dict(smem_model=_tile_smem,
                                 max_shapes={"rows": 256}),
    "kc04_missing_guard.cu": dict(tail={}),
    "kc05_f16_accum.cu": dict(accumulators=Accumulators(
        mma=("f32",), running={"thing_kernel": (("acc", "float"),)})),
    "kc05_tf32.cu": dict(accumulators=Accumulators(
        mma=("f32",), running={"thing_kernel": (("acc", "float"),)})),
}


def corpus_contract(path: Path) -> KernelContract:
    """The contract the `kernel` checker pairs with one case."""
    return _contract(path.name, **CORPUS_OVERRIDES.get(path.name, {}))


def corpus_build(path: Path) -> kernel_rules.BuildInfo:
    """A build that compiles just the case, with the corpus entry's
    argtypes."""
    return kernel_rules.BuildInfo(
        path=path, sources=(path.name,), headers=(), nvcc_flags=(),
        signatures={"thing_launch": list(CORPUS_SIGNATURE)},
        lines={"thing_launch": 1})


@dataclasses.dataclass
class CaseResult:
    """One corpus case: expected rule ids vs what the checker found."""

    name: str
    expected: List[str]
    found: List[str]

    @property
    def ok(self) -> bool:
        """True when the checker reported exactly the expected rules."""
        return set(self.expected) == set(self.found)

    def __str__(self) -> str:
        mark = "ok  " if self.ok else "FAIL"
        return (f"{mark} {self.name}: expected {sorted(self.expected)}, "
                f"found {sorted(set(self.found))}")


def run_case(path: Path, spec: Dict) -> CaseResult:
    """Run the checker named by ``spec['checker']`` over one case file."""
    checker = spec["checker"]
    if checker == "bench":
        findings = engine_rules.check_bench_keys(path)
    elif checker == "kernel":
        findings = kernel_rules.check_sources(
            {path.name: cuda_src.CudaSource(path)}, corpus_build(path),
            [corpus_contract(path)], SMEM_PER_BLOCK_OPTIN)
    else:
        sf = astutil.load(path)
        if checker == "ops":
            findings = oracle_rules.check_dispatchers_in_tree(
                sf.tree, path, ref_names=set())
        elif checker == "duplicate":
            a, b = spec["pair"]
            findings = oracle_rules.check_duplicate_pair(
                (path, a), (path, b))
        elif checker == "store":
            findings = engine_rules.check_commit_paths_in_tree(
                sf.tree, path)
        elif checker == "faults":
            findings, _ = engine_rules.check_trip_calls_in_tree(
                sf.tree, path, set(CORPUS_FAULT_SITES))
        else:
            raise ValueError(f"{path.name}: unknown checker {checker!r}")
    return CaseResult(name=path.name, expected=list(spec["rules"]),
                      found=[f.rule for f in findings])


def run_corpus(corpus_dir: Path) -> List[CaseResult]:
    """Run every case listed in ``corpus_dir/manifest.json``."""
    manifest = json.loads((corpus_dir / "manifest.json").read_text())
    return [run_case(corpus_dir / name, manifest[name])
            for name in sorted(manifest)]
