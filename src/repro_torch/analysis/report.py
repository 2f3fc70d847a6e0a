"""Findings and the machine-readable lint report of the port.

A :class:`Finding` is one rule violation anchored to a file/line; a
:class:`Report` is the full result of a lint run and serializes to the
JSON document ``tools/lint_torch_kernels.py --json`` writes.  The rule
ids are the JAX package's (``repro/analysis/report.py``); the KC rules
are restated for the CUDA sources under ``kernels/csrc/``.
"""
from __future__ import annotations

import dataclasses
import json
from typing import List

# Rule-id -> one-line description (the authoritative rule list).
RULES = {
    "KC01": "__global__ kernel or C entry without a registered "
            "KernelContract (or a stale contract, or a compiled instance "
            "count that differs from the contract's)",
    "KC02": "extern \"C\" prototype does not map parameter for parameter "
            "onto its ctypes argtypes in build.SIGNATURES",
    "KC03": "shared-memory model missing, inconsistent with max_shapes, "
            "or over a block's opt-in at declared max shapes (dynamic + "
            "static; compiled spills past the contract; a launch past "
            "48 KiB without raising its limit)",
    "KC04": "ceil-division or persistent grid without its declared tail "
            "guard in the kernel body, or a stale guard",
    "KC05": "mma.sync / wgmma accumulating outside f32/s32 or the "
            "contract's types, or a tf32 operand in an exact-parity "
            "source",
    "KC06": "double in a kernel source or a header it includes",
    "KC07": "approximate intrinsic or PTX .approx reachable from an "
            "exact-parity kernel (or a fast-math nvcc flag)",
    "KC08": "running accumulator declared in another type than the "
            "contract's (running accumulators must be float/int)",
    "OR01": "ops.py dispatcher with no reachable kernels/ref.py oracle",
    "OR02": "dispatcher/oracle pair never exercised together by a test",
    "OR03": "intentional duplicate pair has drifted (AST-normalized "
            "bodies differ)",
    "EN01": "state-store write path does not reach the atomic commit "
            "primitive (atomic_write_json)",
    "EN02": "fault-site registry not closed (unknown trip site, or a "
            "registered site with no hook)",
    "EN03": "BENCH summary key matches neither the gated nor the "
            "parity naming convention",
}


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One rule violation: ``rule`` id, location, human message."""

    rule: str
    path: str
    line: int
    message: str

    def to_dict(self) -> dict:
        """Plain-dict form for the JSON report."""
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "message": self.message,
                "description": RULES.get(self.rule, "")}

    def __str__(self) -> str:
        """``path:line: RULE message`` (compiler-style)."""
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


@dataclasses.dataclass
class Report:
    """A full lint run: sorted findings plus per-family counts."""

    findings: List[Finding] = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        """True when the run produced no findings."""
        return not self.findings

    def counts(self) -> dict:
        """Finding count per rule id (only rules that fired)."""
        out: dict = {}
        for f in self.findings:
            out[f.rule] = out.get(f.rule, 0) + 1
        return out

    def to_json(self) -> str:
        """The machine-readable report document."""
        return json.dumps({
            "ok": self.ok,
            "counts": self.counts(),
            "findings": [f.to_dict() for f in sorted(self.findings)],
        }, indent=2, sort_keys=True)
