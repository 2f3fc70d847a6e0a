#!/usr/bin/env python3
"""Where the D-tiled stage A's time goes: products against the top-k merge.

Builds the kernel of ``knn_topk_dtiled`` (``knn_topk_dtiled.cu`` with
``topk_common.cuh``) twice -- as it is, and with the fold of every score
tile into the per-query lists compiled out -- and times both on the card
at TaFeng's request shape: Q=256 users against M=13,949 rows x
D=11,997 items, k=300, bd=512, on a sparse corpus like the kernel checks
of ``chip_smoke.py`` (about 1% of the items set), int8 on the store's
16-byte row pitch and fp32.  The difference of the two is the merge.

    python3 tools/dtiled_phase_split.py [--root DIR]

``--root`` names another checkout of the repository (for example a
``git archive`` of an earlier commit, unpacked under ``build/``): its
``src/repro_torch`` and kernel sources are measured instead.  Needs a
CUDA card and nvcc; prints the card and one JSON line.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

MERGE_CALL = re.compile(r"^(\s*)(merge_score_tile\w*<)", re.M)


def time_ms(fn, reps: int = 7) -> float:
    """Median device time of ``fn`` after a warm-up (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[1])
    root = ap.parse_args().root.resolve()
    if not torch.cuda.is_available():
        raise SystemExit("dtiled_phase_split: no CUDA device")
    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels import build, knn_topk
    from repro_torch.optim.compression import quantize_int8_rows_pitched

    csrc = root / "src" / "repro_torch" / "kernels" / "csrc"
    src = (csrc / "knn_topk_dtiled.cu").read_text()
    variants = {"whole": src,
                "products": MERGE_CALL.sub(r"\1if (0) \2", src)}
    assert variants["products"] != src, "no merge call found"
    out = root / "build" / "dtiled_phase_split"
    procs = {}
    for name, text in variants.items():
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "knn_topk_dtiled.cu").write_text(text)
        shutil.copy(csrc / "topk_common.cuh", d / "topk_common.cuh")
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-shared",
             str(d / "knn_topk_dtiled.cu"), "-o", str(d / "lib.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        lib = ctypes.CDLL(str(out / name / "lib.so"))
        fn = lib.knn_topk_dtiled_launch
        fn.argtypes = build.SIGNATURES["knn_topk_dtiled_launch"]
        fn.restype = ctypes.c_int
        libs[name] = lib

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    m, d, q_n, k, bd = 13949, 11997, 256, 300, 512
    corpus = torch.rand((m, d), generator=gen, device=dev)
    corpus *= torch.rand((m, d), generator=gen, device=dev) < 0.01
    uid = torch.randperm(m, generator=gen, device=dev)[:q_n].to(torch.int32)
    u = uid.long()
    cq, cs = quantize_int8_rows_pitched(corpus)
    calls = {
        "int8": lambda: knn_topk.launch_dtiled(
            cq[u], cq, k, bd=bd, query_gids=uid, q_scale=cs[u],
            c_scale=cs),
        "fp32": lambda: knn_topk.launch_dtiled(corpus[u], corpus, k, bd=bd,
                                               query_gids=uid),
    }
    res = {"root": str(root)}
    for order in (("whole", "products"), ("products", "whole")):
        for name in order:
            build._lib = libs[name]
            for mode, fn in calls.items():
                res.setdefault(f"{mode}_{name}_ms", []).append(time_ms(fn))
    for mode in calls:
        whole = float(np.median(res[f"{mode}_whole_ms"]))
        products = float(np.median(res[f"{mode}_products_ms"]))
        res[f"{mode}_merge_ms"] = whole - products
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
