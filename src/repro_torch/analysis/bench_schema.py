"""The BENCH summary-key naming convention (rule EN03).

The port's copy of the JAX package's ``repro/analysis/bench_schema.py``
(the port imports nothing of that package).  Every ``summary`` key a
benchmark records in ``BENCH_torch.json``, once the port has one, must
classify as one of:

* ``gated-ratio`` — contains ``speedup``: a relative-performance claim
  the trend gate (benchmarks/bench_trend.py) enforces with a tolerance
  ratio above its floor (interpret-backend runs never enforced).
* ``gated-bound`` — contains ``compiled``: a compiled-program count the
  trend gate enforces as a hard upper bound (bucketing regressions).
* ``gated-slo`` — contains ``slo``: a normalized service-level
  fraction (measured / objective) the trend gate enforces as a hard
  ``<= 1.0`` bound — the SLO itself is the contract, not the committed
  baseline value (interpret-backend runs never enforced).
* ``parity`` — an informational fact the trend report prints but does
  not gate: latency/recovery percentiles and means (``_ms``), growth
  ratios, throughput (``qps``/``per_s``), capacity/extent markers
  (``max_``, ``vmem``, ``hbm``), agreement metrics (``parity``,
  ``overlap``), sweep descriptors (``swept``, ``grid``, ``shards``),
  robustness counters (``dead_letters``, ``rejections``) and the
  compliance arm's drift/certification facts (``drift``,
  ``certified``).

Anything else is ``unknown`` — EN03 in the linter, and a hard failure
in ``bench_trend.py`` (a silently-ignored key is how a renamed speedup
metric escapes the regression gate).
"""
from __future__ import annotations

# Substrings that mark a key as an ungated informational (parity) fact.
PARITY_MARKERS = (
    "parity", "growth", "qps", "per_s", "overlap", "hbm", "vmem",
    "swept", "grid", "dead_letters", "rejections", "max_", "_ms",
    "drift", "certified",
)

# Keys that are parity facts by exact name (no marker substring).
PARITY_EXACT = frozenset({"shards"})


def classify_summary_key(key: str) -> str:
    """Classify ``key`` under the EN03 naming convention.

    Returns one of 'gated-ratio' | 'gated-bound' | 'gated-slo' |
    'parity' | 'unknown'.
    """
    if "speedup" in key:
        return "gated-ratio"
    if "compiled" in key:
        return "gated-bound"
    if "slo" in key:
        return "gated-slo"
    if key in PARITY_EXACT or any(m in key for m in PARITY_MARKERS):
        return "parity"
    return "unknown"
