#!/usr/bin/env python
"""Static analysis of the PyTorch/CUDA port: kernel contracts and engine
invariants (``repro_torch.analysis``).

Usage::

    python tools/lint_torch_kernels.py             # lint the port
    python tools/lint_torch_kernels.py --json out.json
    python tools/lint_torch_kernels.py --selftest  # the seeded-bad corpus
    python tools/lint_torch_kernels.py --compiled  # + what nvcc built

``--compiled`` builds the kernel library verbosely (``nvcc -Xptxas
-v``) and also holds every compiled instance to its contract (instance
counts, static + modelled shared memory against the card's per-block
opt-in, spills); it needs ``nvcc`` and a CUDA device, and raises
without them.  Exit status is 0 only when the port lints clean (or,
with --selftest, when every corpus case is flagged with exactly its
rule ids).
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.analysis import corpus as corpus_mod  # noqa: E402
from repro_torch.analysis import linter  # noqa: E402
from repro_torch.analysis.report import Report  # noqa: E402


def _selftest(root: Path) -> int:
    results = corpus_mod.run_corpus(root / "tests" / "analysis_corpus_torch")
    for r in results:
        print(r)
    bad = [r for r in results if not r.ok]
    print(f"{len(results) - len(bad)}/{len(results)} corpus cases ok")
    return 1 if bad else 0


def compiled_report() -> Report:
    """Build the library verbosely and check ptxas's report against the
    contracts at this device's per-block shared-memory opt-in."""
    import torch

    from repro_torch.kernels import build
    if not torch.cuda.is_available():
        raise RuntimeError("--compiled needs a CUDA device")
    build.library(verbose=True)
    optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    return linter.check_build_log(build.last_build_log, optin)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=ROOT,
                    help="repo root to lint (default: this checkout)")
    ap.add_argument("--json", type=Path, default=None, metavar="PATH",
                    help="also write the machine-readable report here")
    ap.add_argument("--selftest", action="store_true",
                    help="run the seeded-violation corpus instead")
    ap.add_argument("--compiled", action="store_true",
                    help="also check the compiled library (nvcc, a card)")
    args = ap.parse_args(argv)

    if args.selftest:
        return _selftest(args.root)

    report = linter.lint_repo(args.root)
    if args.compiled:
        report = Report(findings=sorted(report.findings
                                        + compiled_report().findings))
    if args.json is not None:
        args.json.write_text(report.to_json() + "\n")
    for finding in report.findings:
        print(finding)
    if report.ok:
        kernels = {k for c in linter.REGISTRY.values() for k in c.kernels}
        print(f"lint_torch_kernels: clean ({len(linter.REGISTRY)} contracts, "
              f"{len(kernels)} kernels checked"
              + (", compiled instances too" if args.compiled else "") + ")")
        return 0
    print(f"lint_torch_kernels: {len(report.findings)} finding(s) "
          f"{report.counts()}")
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
