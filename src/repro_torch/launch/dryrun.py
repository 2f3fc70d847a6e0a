"""Dry run of the registered cells: build each cell's inputs on the card
from a seed, run it once, and report what it took.

    python -m repro_torch.launch.dryrun --arch tifu-knn --shape serve_topk
    python -m repro_torch.launch.dryrun --all [--out results.json]

The port's counterpart of the JAX package's ``launch/dryrun.py``.  PyTorch
has no lower-and-compile step, so a cell is measured by running it:
``run_cell`` reports the cell's description and cuts (``reduced``), its
model FLOPs, the seconds its inputs took to build and the seconds of
one run (host clock, ended by a device synchronize), the achieved
model FLOP/s, and on a CUDA card the peak bytes
(``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats``,
inputs included) and whether they fit the card's memory
(``torch.cuda.mem_get_info``), beside the peak the cut rule estimated
for the sizes it chose (``estimate_bytes``, ``configs/base.py``; a run
on the card checks it).  On the CPU (``device="cpu"``, the tests)
the measured memory fields are ``None``: a CPU run measures no device
memory.  Cells run on the card unless the caller names another device.

The cell is then freed, built again from the same seed and run once
more under ``launch/cost.py``'s ``CostCounter`` (the counterpart of the
JAX dry run's ``extract_hlo=True``), so
the counted run sees the same call also where a cell changes its state
(``stream_update``, the train steps).  That adds the JAX dry run's
roofline fields: ``roofline`` (``launch/roofline.py``'s terms on the
H100's peaks: compute, memory and collective seconds, the bottleneck,
FLOPs by dtype), ``chips`` (1), ``model_flops_per_device`` and
``useful_flops_ratio`` (model FLOPs over counted FLOPs).  On the CPU the
counts are the same; the terms are the card's, not the CPU's.
"""
from __future__ import annotations

import argparse
import gc
import json
import time
import traceback
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs import all_cells, get_arch
from repro_torch.configs.base import CellProgram
from repro_torch.core.types import resolve_device
from repro_torch.launch import roofline
from repro_torch.launch.cost import CostCounter, Costs


def _gib(n_bytes: Optional[float]) -> str:
    return "none" if n_bytes is None else f"{n_bytes / 2 ** 30:.2f} GiB"


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def build_cell(arch_name: str, shape: str, device: Any = None,
               seed: int = 0, sizes: Any = None
               ) -> Tuple[CellProgram, float]:
    """The cell's program with its inputs built on ``device`` from
    ``seed``, and the build's seconds.  On CUDA the peak memory counter
    is reset first, so :func:`run_program`'s peak holds the inputs."""
    dev = resolve_device(device)
    builder = get_arch(arch_name).cells[shape]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    prog = builder(device, seed, sizes)
    _sync(dev)
    return prog, time.perf_counter() - t0


def run_program(prog: CellProgram, device: Any = None
                ) -> Tuple[Dict[str, Any], Any]:
    """Run ``prog`` once; returns (readings, its output)."""
    dev = resolve_device(device)
    _sync(dev)
    t0 = time.perf_counter()
    out = prog.fn(*prog.args)
    _sync(dev)
    seconds = time.perf_counter() - t0
    peak = total = None
    if dev.type == "cuda":
        peak = torch.cuda.max_memory_allocated(dev)
        total = torch.cuda.mem_get_info(dev)[1]
    return {
        "description": prog.description,
        "reduced": dict(prog.reduced),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
        "run_s": seconds,
        "model_flops": prog.model_flops_per_step,
        "model_flops_per_s": prog.model_flops_per_step / seconds
        if seconds > 0 else None,
        "peak_bytes": peak,
        "estimate_bytes": prog.estimate_bytes,
        "device_bytes": total,
        "fits": None if peak is None else bool(peak <= total),
    }, out


def count_program(prog: CellProgram, device: Any = None) -> Costs:
    """Run ``prog`` once under a ``CostCounter`` on ``device``; returns
    the work it dispatched."""
    dev = resolve_device(device)
    _sync(dev)
    with CostCounter(dev) as counter:
        prog.fn(*prog.args)
    _sync(dev)
    return counter.costs


def roofline_fields(costs: Costs, model_flops: float) -> Dict[str, Any]:
    """The JAX dry run's roofline fields of a counted run
    (``useful_flops_ratio`` ``None`` where nothing was counted)."""
    terms = roofline.analyze(costs, chips=1)
    return {"roofline": terms.as_dict(), "chips": 1,
            "model_flops_per_device": model_flops,
            "useful_flops_ratio": model_flops / terms.flops
            if terms.flops else None}


def t_bound(fields: Dict[str, Any]) -> float:
    """The largest roofline term of ``roofline_fields``' output, s."""
    rt = fields["roofline"]
    return max(rt["t_compute_s"], rt["t_memory_s"], rt["t_collective_s"])


def run_cell(arch_name: str, shape: str, device: Any = None, seed: int = 0,
             sizes: Any = None) -> Dict[str, Any]:
    """Build the cell on ``device`` (the card by default) and run it
    once, then build it again and count a second run; returns its
    readings (see the module docstring)."""
    dev = resolve_device(device)
    prog, build_s = build_cell(arch_name, shape, dev, seed, sizes)
    result, out = run_program(prog, dev)
    del prog, out
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    prog, _ = build_cell(arch_name, shape, dev, seed, sizes)
    costs = count_program(prog, dev)
    return {"arch": arch_name, "shape": shape, "build_s": build_s,
            **result, **roofline_fields(costs, result["model_flops"])}


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args(argv)
    if args.all:
        cells = list(all_cells())
    elif args.arch is None:
        ap.error("give --arch (and --shape) or --all")
    else:
        shapes = ([args.shape] if args.shape
                  else list(get_arch(args.arch).cells))
        cells = [(args.arch, s) for s in shapes]

    results = []
    for name, shape in cells:
        tag = f"{name} x {shape}"
        try:
            r = run_cell(name, shape)
            rt = r["roofline"]
            print(f"[OK] {tag}: {r['description']}; build {r['build_s']:.2f}"
                  f" s, run {r['run_s']:.4f} s, "
                  f"{r['model_flops_per_s']:.4g} model FLOP/s, peak "
                  f"{r['peak_bytes'] / 2 ** 30:.2f} GiB (estimate "
                  f"{_gib(r['estimate_bytes'])}) of "
                  f"{r['device_bytes'] / 2 ** 30:.2f} (fits {r['fits']}) "
                  f"on {r['device']}; cuts {r['reduced'] or 'none'}; "
                  f"t_comp={rt['t_compute_s']:.2e}s "
                  f"t_mem={rt['t_memory_s']:.2e}s "
                  f"t_coll={rt['t_collective_s']:.2e}s "
                  f"bound={rt['bottleneck']} "
                  f"t_bound/run={t_bound(r) / r['run_s']:.3f}", flush=True)
        except Exception as e:  # noqa: BLE001 -- reported, the next cell runs
            r = {"arch": name, "shape": shape,
                 "error": f"{type(e).__name__}: {e}",
                 "traceback": traceback.format_exc()[-2000:]}
            print(f"[FAIL] {tag}: {type(e).__name__}: {e}", flush=True)
        results.append(r)
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1, default=str)
        print(f"wrote {args.out}")
    n_ok = sum(1 for r in results if "error" not in r)
    print(f"{n_ok}/{len(results)} cells passed")
    return 0 if n_ok == len(results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
