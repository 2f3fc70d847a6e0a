#!/usr/bin/env python3
"""Where a serving kernel's time goes: products against the top-k merge.

Builds one stage-A kernel's source twice -- as it is, and with the fold
of every score tile into the per-query lists compiled out -- and times
both on the card at TaFeng's request shape: Q=256 users against
M=13,949 rows x D=11,997 items, k=300, on a sparse corpus like the
kernel checks of ``chip_smoke.py`` (about 1% of the items set).  The
difference of the two is the merge.

* ``--kernel knn_topk_dtiled`` (the default): ``knn_topk_dtiled.cu``,
  bd=512, int8 on the store's 16-byte row pitch and fp32;
* ``--kernel blend_topn_rows``: ``serving_rows.cu`` (stage B over
  rows, n=10, k=300 random neighbours a query) on f32 pre-fetched rows
  [Q, k, I], f32 rows read in place from the corpus and int8 rows read
  from the store's pitched cache, each timed whole, with the sum alone
  (``sum``: the blend and selection compiled out) and with the
  selection and merge alone (``select``: the row feed and sum compiled
  out), beside gather + mean + ``topk`` on the pre-fetched rows; where
  the source plans them by element type, other tile widths and ring
  depths too; the parent's design (``--root``) split the same way (its
  sort compiled out, its rows loop run no time).  Every whole answer is
  held bitwise against the sum in order j = 0..k-1 in torch, and every
  call's kernels are profiled (``torch.profiler``);
* ``--kernel sparse_row_gather``: ``sparse_row_gather.cu`` at the add
  path's sub-batch (U=512, W=168, int64 rows and int32 ids, as the
  applier passes them) beside indexing: one call by events, a burst of
  100 by events, the host time of a call (a burst of 100 on the host
  clock, no sync) and the profiler's device time;
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
           "knn_topk": "knn_topk_launch",
           "blend_topn_rows": "blend_rows_launch",
           "sparse_row_gather": "srg_launch"}
SOURCES = {"blend_topn_rows": "serving_rows.cu"}
# serving_rows.cu's phases: the blend and selection (finish_tile) in
# place of a store of the sums, or the row feed and sum left out
FINISH_CALL = re.compile(r"finish_tile<[^;]*;")
SUM_SINK = ("if (threadIdx.x < NT) part_v[(size_t)blockIdx.y * gridDim.x "
            "+ blockIdx.x] = acc[0] + acc[1] + acc[2] + acc[3];")
FEED_CALLS = re.compile(r"(produce_rows|consume_rows)<T>\([^;]*;")
# the parent's design: its sort, and its rows loop run no time
PARENT_SORT = "bitonic_sort_desc<true>(tv, ti, BI, tid, NT);"
PARENT_LOOP = "for (int j = 0; j < k; ++j) {"
PARENT_NO_LOOP = "for (int j = 0; j < 0; ++j) {"
# serving_rows.cu's tile width by element type and ring depth, and the
# other plans timed: (f32 tile, int8 tile, depth)
TILE_LINE = re.compile(
    r"constexpr int kTile = sizeof\(T\) == 1 \? \d+ : \d+;")
STAGES_LINE = re.compile(r"constexpr int STAGES = \d+;")
ROWS_PLANS = ((1024, 1024, 8), (2048, 2048, 4), (1024, 4096, 4),
              (1024, 4096, 16))
M, D, Q, K, BD = 13949, 11997, 256, 300, 512
ALPHA, TOPN = 0.7, 10
GATHER_U, GATHER_W = 512, 168     # the add path's sub-batch


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
    warm-up: (kernels whose names contain one of ``names``, per call the
    trace holds a record of the first, which launches once a call; all
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
    first = 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        every += us
        if any(n in e.key for n in names):
            own += us
        if names[0] in e.key:
            first += e.count
    # a trace can miss a launch: per launch of the first named kernel
    # the trace recorded, where it holds one a call
    calls = first if 0 < first <= reps else reps
    return own / calls / 1e3, every / reps / 1e3


def build_variants(build, csrc: Path, out: Path, kernel: str,
                   variants: dict) -> dict:
    """Compile each variant source of ``kernel`` (with topk_common.cuh)
    in parallel; returns the loaded libraries by variant name."""
    procs = {}
    for name, text in variants.items():
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        (d / SOURCES.get(kernel, f"{kernel}.cu")).write_text(text)
        shutil.copy(csrc / "topk_common.cuh", d / "topk_common.cuh")
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-shared",
             str(d / SOURCES.get(kernel, f"{kernel}.cu")), "-o",
             str(d / "lib.so")],
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


def ordered_blend(x, rows, topn):
    """The row blend summed in order j = 0..k-1 by separate round-to-
    nearest torch ops (the kernel's arithmetic): (values, items) of the
    top ``topn``, ties to the lower item."""
    acc = torch.zeros_like(x)
    for j in range(rows.shape[1]):
        acc = acc + rows[:, j]
    pred = ALPHA * x + (1.0 - ALPHA) * (acc / torch.full_like(
        acc, rows.shape[1]))
    v, i = torch.sort(pred, dim=1, descending=True, stable=True)
    return v[:, :topn], i[:, :topn].to(torch.int32)


def rows_variants(src: str) -> dict:
    """serving_rows.cu's variants: whole, the sum alone, the selection
    alone and, where the source plans its tile by element type and its
    ring depth, the other plans of ``ROWS_PLANS`` (named ``plan_<f32
    tile>_<int8 tile>_<depth>``).  The parent's design (one rows
    loop and a bitonic sort of the tile) gets the same two phases."""
    variants = {"whole": src}
    if FINISH_CALL.search(src) and FEED_CALLS.search(src):
        variants["sum"] = FINISH_CALL.sub(SUM_SINK, src)
        variants["select"] = FEED_CALLS.sub(";", src)
    elif PARENT_SORT in src and PARENT_LOOP in src:
        variants["sum"] = src.replace(PARENT_SORT, "")
        variants["select"] = src.replace(PARENT_LOOP, PARENT_NO_LOOP)
    if TILE_LINE.search(src) and STAGES_LINE.search(src):
        for t32, t8, depth in ROWS_PLANS:
            variants[f"plan_{t32}_{t8}_{depth}"] = STAGES_LINE.sub(
                f"constexpr int STAGES = {depth};", TILE_LINE.sub(
                    f"constexpr int kTile = sizeof(T) == 1 ? {t8} : {t32};",
                    src))
    return variants


def rows_main(root: Path, csrc: Path, build) -> int:
    """``--kernel blend_topn_rows``: see the module's docstring."""
    from repro_torch.kernels import ref, serving_topn
    from repro_torch.optim.compression import quantize_int8_rows_pitched

    variants = rows_variants((csrc / SOURCES["blend_topn_rows"]).read_text())
    libs = build_variants(build, csrc, root / "build" / "phase_split" /
                          "blend_topn_rows", "blend_topn_rows", variants)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    corpus = torch.rand((M, D), generator=gen, device=dev)
    corpus *= torch.rand((M, D), generator=gen, device=dev) < 0.01
    u = torch.randperm(M, generator=gen, device=dev)[:Q]
    nbr = torch.argsort(torch.rand((Q, M), generator=gen, device=dev),
                        dim=1)[:, :K].to(torch.int32)
    qf, rows = corpus[u], corpus[nbr.long()]
    cq, cs = quantize_int8_rows_pitched(corpus)
    qq, qs = cq[u], cs[u]
    calls = {
        "f32": lambda: serving_topn.launch_rows(qf, rows, ALPHA, TOPN),
        "int8_indexed": lambda: serving_topn.launch_rows_indexed(
            qq, qs, cq, cs, nbr, ALPHA, TOPN),
    }
    if hasattr(serving_topn, "launch_rows_at"):
        addr = serving_topn._row_addresses(corpus, nbr)
        calls["f32_in_place"] = lambda: serving_topn.launch_rows_at(
            qf, addr, [corpus], ALPHA, TOPN)
        calls["f32_n33"] = lambda: serving_topn.launch_rows(qf, rows, ALPHA,
                                                            33)
    # (variant library, call, (tiles by element size, depth) or None)
    runs = {}
    for mode, fn in calls.items():
        for v in variants:
            if v.startswith("plan"):
                if mode in ("f32", "int8_indexed"):
                    t32, t8, depth = (int(x) for x in v.split("_")[1:])
                    runs[f"{mode}_{v}"] = (v, fn, ({4: t32, 1: t8}, depth))
            else:
                runs[f"{mode}_{v}"] = (v, fn, None)
    res = {"root": str(root), "kernel": "blend_topn_rows", "k": K}
    default_plan = (getattr(serving_topn, "ROWS_TILE", None),
                    getattr(serving_topn, "ROWS_STAGES", None))

    def use(lib, plan):
        build._lib = libs[lib]
        if default_plan[0] is not None:
            serving_topn.ROWS_TILE, serving_topn.ROWS_STAGES = \
                plan or default_plan

    # each whole answer against the plain version and, bit for bit,
    # against the sum in order j = 0..k-1
    deq = (cq[nbr.long()].float() * cs[nbr.long()][..., None],
           qq.float() * qs[:, None])
    want = {"f32": (ref.blend_topn_rows_ref(qf, rows, ALPHA, TOPN),
                    ordered_blend(qf, rows, TOPN)),
            "int8": (ref.blend_topn_rows_quant_ref(
                qq, qs, cq[nbr.long()], cs[nbr.long()], ALPHA, TOPN),
                ordered_blend(deq[1], deq[0], TOPN))}
    del deq
    for name, (v, fn, stages) in runs.items():
        if v in ("sum", "select") or "n33" in name:
            continue
        use(v, stages)
        got_v, got_i = fn()
        torch.cuda.synchronize()
        plain, exact = want["int8" if name.startswith("int8") else "f32"]
        res[f"{name}_max_abs_err"] = float((got_v - plain[0]).abs().max())
        res[f"{name}_bitwise_ordered_sum"] = bool(
            torch.equal(got_v, exact[0]) and torch.equal(got_i, exact[1]))
    runs["f32_library"] = ("whole", lambda: torch.topk(
        ALPHA * qf + (1.0 - ALPHA) * rows.mean(1), TOPN), None)
    for rnd in range(2):   # each variant twice, in turns
        for name, (lib, fn, stages) in (runs.items() if rnd == 0
                                        else reversed(list(runs.items()))):
            use(lib, stages)
            res.setdefault(f"{name}_ms", []).append(time_ms(fn))
    # device time of the kernels alone (the event times above hold the
    # wrapper's host time on an idle card)
    for name, (lib, fn, stages) in runs.items():
        use(lib, stages)
        names = ("",) if name.endswith("library") else \
            ("rows_", "merge_lists_kernel")
        res[f"{name}_device_ms"] = device_ms(fn, names)[0]
    use("whole", None)
    res["f32_bytes_bound_ms"] = Q * (K + 1) * D * 4 / 3.35e12 * 1e3
    print(json.dumps(res), flush=True)
    return 0


def gather_main(root: Path, csrc: Path, build) -> int:
    """``--kernel sparse_row_gather``: see the module's docstring."""
    import time
    from repro_torch.kernels import sparse_row_gather

    libs = build_variants(build, csrc, root / "build" / "phase_split" /
                          "sparse_row_gather", "sparse_row_gather",
                          {"whole": (csrc / "sparse_row_gather.cu")
                           .read_text()})
    build._lib = libs["whole"]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    table = torch.rand((M, D), generator=gen, device=dev)
    # the add applier's inputs: int64 users (batch.user.long()), int32
    # support ids with PAD = -1
    rows = torch.randint(0, M, (GATHER_U,), generator=gen, device=dev)
    ids = torch.randint(0, D, (GATHER_U, GATHER_W), generator=gen,
                        device=dev, dtype=torch.int32)
    ids[torch.rand(ids.shape, generator=gen, device=dev) < 0.4] = -1
    safe = torch.where(ids >= 0, ids, 0).long()
    rows2d = rows[:, None].expand(GATHER_U, GATHER_W)
    calls = {"gather": lambda: sparse_row_gather.launch(table, rows, ids),
             "indexing": lambda: table[rows2d, safe]}
    res = {"root": str(root), "kernel": "sparse_row_gather",
           "shape": f"U={GATHER_U} W={GATHER_W} rows int64 ids int32"}
    for rnd in range(2):
        for name, fn in (calls.items() if rnd == 0
                         else reversed(list(calls.items()))):
            res.setdefault(f"{name}_ms", []).append(time_ms(fn))
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            h0 = time.perf_counter()
            for _ in range(100):
                fn()
            host = (time.perf_counter() - h0) * 10
            end.record()
            end.synchronize()
            res.setdefault(f"{name}_burst100_ms", []).append(
                start.elapsed_time(end) / 100)
            res.setdefault(f"{name}_host_ms", []).append(host)
    for name, fn in calls.items():
        own, _ = device_ms(fn, ("sparse_row_gather_kernel",)
                                  if name == "gather" else ("",))
        res[f"{name}_device_ms"] = own
    print(json.dumps(res), flush=True)
    return 0


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
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    if kernel == "blend_topn_rows":
        return rows_main(root, csrc, build)
    if kernel == "sparse_row_gather":
        return gather_main(root, csrc, build)
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

    dev = torch.device("cuda")
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
