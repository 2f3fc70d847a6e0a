#!/usr/bin/env python3
"""Where a stage-A kernel's time goes: products against the top-k merge.

Builds one stage-A kernel's source twice -- as it is, and with the fold
of every score tile into the per-query lists compiled out -- and times
both on the card at TaFeng's request shape: Q=256 users against
M=13,949 rows x D=11,997 items, k=300, on a sparse corpus like the
kernel checks of ``chip_smoke.py`` (about 1% of the items set).  The
difference of the two is the merge.

* ``--kernel knn_topk_dtiled`` (the default): ``knn_topk_dtiled.cu``,
  bd=512, int8 on the store's 16-byte row pitch and fp32;
* ``--kernel knn_topk``: ``knn_topk.cu``, fp32 over the whole of D.
  Where the source plans its grid with ``knn_topk.plan_knn``, the
  products are split further into the chunk copies alone (``feed``: the
  multiply compiled out) and the multiply alone (``fma``: the copies
  compiled out), and whole and products are timed again with one query
  repeated 256 times (``same``: every block merges alike).  The whole
  call is also profiled (``torch.profiler``): the device time of the
  kernel's own two kernels, and of every kernel the call launched.

    python3 tools/dtiled_phase_split.py [--kernel NAME] [--root DIR]
        [--k K]

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
# knn_topk.cu's products, split: the chunk copies alone (the multiply
# compiled out) and the multiply alone (on whatever the ring holds)
PRODUCTS = re.compile(r"mul_chunk<[^;]*;")
COPIES = "auto issue = [&](int ch) {"
ENTRIES = {"knn_topk_dtiled": "knn_topk_dtiled_launch",
           "knn_topk": "knn_topk_launch"}
M, D, Q, K, BD = 13949, 11997, 256, 300, 512


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


def device_ms(fn, names, reps: int = 5) -> tuple:
    """Device time per call of ``fn`` under ``torch.profiler`` after a
    warm-up: (kernels whose names contain one of ``names``, all
    kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    own = every = 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        every += us
        if any(n in e.key for n in names):
            own += us
    return own / reps / 1e3, every / reps / 1e3


def build_variants(build, csrc: Path, out: Path, kernel: str,
                   variants: dict) -> dict:
    """Compile each variant source of ``kernel`` (with topk_common.cuh)
    in parallel; returns the loaded libraries by variant name."""
    procs = {}
    for name, text in variants.items():
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        (d / f"{kernel}.cu").write_text(text)
        shutil.copy(csrc / "topk_common.cuh", d / "topk_common.cuh")
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-shared",
             str(d / f"{kernel}.cu"), "-o", str(d / "lib.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        lib = ctypes.CDLL(str(out / name / "lib.so"))
        fn = getattr(lib, ENTRIES[kernel])
        fn.argtypes = build.SIGNATURES[ENTRIES[kernel]]
        fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    global K
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", choices=sorted(ENTRIES),
                    default="knn_topk_dtiled")
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[1])
    ap.add_argument("--k", type=int, default=K,
                    help="neighbours per query (TaFeng's 300 by default)")
    args = ap.parse_args()
    K = args.k
    root, kernel = args.root.resolve(), args.kernel
    if not torch.cuda.is_available():
        raise SystemExit("dtiled_phase_split: no CUDA device")
    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels import build, knn_topk
    from repro_torch.optim.compression import quantize_int8_rows_pitched

    csrc = root / "src" / "repro_torch" / "kernels" / "csrc"
    src = (csrc / f"{kernel}.cu").read_text()
    variants = {"whole": src,
                "products": MERGE_CALL.sub(r"\1if (0) \2", src)}
    assert variants["products"] != src, "no merge call found"
    split = kernel == "knn_topk" and hasattr(knn_topk, "plan_knn")
    if split and PRODUCTS.search(src) and COPIES in src:
        prod = variants["products"]
        variants["feed"] = PRODUCTS.sub(";", prod)
        variants["fma"] = prod.replace(COPIES, COPIES + " return;")
    libs = build_variants(build, csrc, root / "build" / "phase_split" /
                          kernel, kernel, variants)

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    corpus = torch.rand((M, D), generator=gen, device=dev)
    corpus *= torch.rand((M, D), generator=gen, device=dev) < 0.01
    uid = torch.randperm(M, generator=gen, device=dev)[:Q].to(torch.int32)
    u = uid.long()
    qf = corpus[u]
    # (variant library, call) per timed mode
    runs = {}
    if kernel == "knn_topk_dtiled":
        cq, cs = quantize_int8_rows_pitched(corpus)
        calls = {
            "int8": lambda: knn_topk.launch_dtiled(
                cq[u], cq, K, bd=BD, query_gids=uid, q_scale=cs[u],
                c_scale=cs),
            "fp32": lambda: knn_topk.launch_dtiled(qf, corpus, K, bd=BD,
                                                   query_gids=uid),
        }
        for mode, fn in calls.items():
            runs[f"{mode}_whole"] = ("whole", fn)
            runs[f"{mode}_products"] = ("products", fn)
    else:
        runs["fp32_whole"] = ("whole", lambda: knn_topk.launch(
            qf, corpus, K, query_gids=uid))
        runs["fp32_products"] = ("products", runs["fp32_whole"][1])
    res = {"root": str(root), "kernel": kernel, "k": K}
    if split:
        n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = knn_topk.plan_knn(Q, M, K, n_sms)
        res["plan"] = list(plan)
        for v in ("feed", "fma"):
            if v in libs:
                runs[f"fp32_{v}"] = (v, runs["fp32_whole"][1])
        # one query 256 times: every block merges alike, so the query
        # tiles of a slice cannot drift apart in their merges
        same = uid[:1].expand(Q).contiguous()
        qs = corpus[same.long()]
        runs["fp32_same_whole"] = ("whole", lambda: knn_topk.launch(
            qs, corpus, K, query_gids=same))
        runs["fp32_same_products"] = ("products",
                                      runs["fp32_same_whole"][1])
    for rnd in range(2):   # each variant twice, in turns
        for name, (lib, fn) in (runs.items() if rnd == 0
                                else reversed(list(runs.items()))):
            build._lib = libs[lib]
            res.setdefault(f"{name}_ms", []).append(time_ms(fn))
    for name in runs:
        if name.endswith("_whole"):
            mode = name[:-len("_whole")]
            whole = float(np.median(res[f"{mode}_whole_ms"]))
            products = float(np.median(res[f"{mode}_products_ms"]))
            res[f"{mode}_merge_ms"] = whole - products
    if kernel == "knn_topk":
        # the whole call's device time: the kernel's own two kernels,
        # and every kernel the wrapper launched (a |c|^2 pass included)
        build._lib = libs["whole"]
        res["fp32_device_own_ms"], res["fp32_device_all_ms"] = device_ms(
            runs["fp32_whole"][1], ("knn_tile_kernel", "merge_lists_kernel"))
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
