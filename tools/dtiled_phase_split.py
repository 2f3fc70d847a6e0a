#!/usr/bin/env python3
"""Where a serving kernel's time goes: products against the top-k merge.

Builds one stage-A kernel's source twice -- as it is, and with the fold
of every score tile into the per-query lists compiled out -- and times
both on the card at TaFeng's request shape: Q=256 users against
M=13,949 rows x D=11,997 items, k=300, on a sparse corpus like the
kernel checks of ``chip_smoke.py`` (about 1% of the items set).  The
difference of the two is the merge.

* ``--kernel knn_topk_dtiled`` (the default): ``knn_topk_dtiled.cu``,
  bd=512, int8 on the store's 16-byte row pitch and fp32.  Where the
  fp32 design runs stage A's ring (``"ring_f32"``), its products are
  split further as ``--kernel knn_topk``'s are (``feed``, ``fma``), and
  the fp32 call's kernels are profiled;
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
* ``--kernel sparse_row_scatter``: first the main path's load
  (``serve.run_trickle`` on TaFeng's published size, as ``chip_smoke.py``
  drives it) with each of its B2 calls' rows and ids read back: the
  calls, their sub-batch sizes, the runs of entry rows that name one
  table row, and how many of a run's rows carry a valid id.  Then
  ``sparse_row_scatter.cu`` at the add path's sub-batch (U=512, W=168)
  and the delete path's (W=526), int64 rows and int32 ids as the
  appliers pass them, beside ``index_put_``, and with ``--parent DIR
  [DIR ...]`` the wrapper and sources of other checkouts too (each
  built by its own ``build`` module), every reading taken in turns
  (the parents, the change, ``index_put_``, then the other way round):
  one call by events, a burst of 100 by events, the host time of a
  call, and the profiler's device time of a call's own kernel and of
  every kernel it launched.  The sub-batches: those two (a run of 33
  rows of one user with valid ids among random users), the appliers'
  shape (distinct users, then padding rows of user 0 with PAD ids), 512
  distinct users, and larger ones for the cost of the row scan and of
  a long padding run (U=4,096 as the add path; 4,096, 8,192 and 16,384
  distinct users; the fullest pow2 buckets of 4,096 and 16,384, half
  of them padding).  The trees' tables are held bitwise equal first.
  Then this tree's kernel by the profiler with phases compiled out
  (``scan``: the row scan alone; ``stage``: the scan and the staging,
  no sort or add; ``nosort``: no sort) and with 16 loads a thread a
  tile (``kper16``);
* ``--kernel blend_topn_onehot``: ``serving_topn.cu`` (stage B from
  stage A's indices, n=10) at the kernel checks' input (Q=256, k=300
  neighbours chosen by ``knn_topk`` on the sparse corpus), on a corpus
  of equal-norm rows (120 items of value 1 a row: stage A's lists share
  few rows) and at Q=32 and Q=1,024, with ``--parent DIR [DIR ...]``
  the wrappers of other checkouts too, every reading in turns (the
  parents, the change, then the other way round): one call by events,
  a burst of 100 by events, the host time of a call and the profiler's
  device time, beside gather + mean + ``topk`` where Q <= 256; each
  input's plan (``serving_topn.plan_blend``) and its groups' distinct
  rows and staging passes; every answer held against
  ``ref.blend_topn_ref`` and, bit for bit, against
  ``ref.blend_topn_ordered_ref`` in the kernel's passes.  Then this
  tree's kernel by the profiler with phases compiled out (``kPhases``:
  ``stage`` the staging alone, ``stage_sum`` no selection,
  ``sum_select`` no staging, ``select`` the selection alone);
* ``--kernel knn_topk``: ``knn_topk.cu``, fp32 over the whole of D.
  Where the source plans its grid with ``knn_topk.plan_knn``, the
  products are split further into the chunk copies alone (``feed``: the
  multiply compiled out) and the multiply alone (``fma``: the copies
  compiled out), and whole and products are timed again with one query
  repeated 256 times (``same``: every block merges alike).  The whole
  call is also profiled (``torch.profiler``): the device time of the
  kernel's own two kernels, and of every kernel the call launched.

    python3 tools/dtiled_phase_split.py [--kernel NAME] [--root DIR]
        [--k K] [--parent DIR [DIR ...]]

``--root`` names another checkout of the repository (for example a
``git archive`` of an earlier commit, unpacked under ``build/``): its
``src/repro_torch`` and kernel sources are measured instead.  Needs a
CUDA card and nvcc; prints the card and one JSON line.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

MERGE_CALL = re.compile(r"^(\s*)(merge_score_tile\w*<)", re.M)
# the ring's products (knn_topk.cu, and knn_topk_dtiled.cu's fp32
# design), split: the chunk copies alone (the multiply compiled out) and
# the multiply alone (on whatever the ring holds)
PRODUCTS = re.compile(r"mul_chunk<[^;]*;")
COPIES = "auto issue = [&](int ch) {"
ENTRIES = {"knn_topk_dtiled": "knn_topk_dtiled_launch",
           "knn_topk": "knn_topk_launch",
           "blend_topn_rows": "blend_rows_launch",
           "sparse_row_gather": "srg_launch",
           "sparse_row_scatter": "srs_launch",
           "blend_topn_onehot": "blend_topn_launch"}
SOURCES = {"blend_topn_rows": "serving_rows.cu",
           "blend_topn_onehot": "serving_topn.cu"}
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
SCATTER_W_DEL = 526               # the delete path's ids a row (TaFeng)
SCATTER_M = 16384                 # table rows: 16,384 distinct users fit


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
    """Compile each variant source of ``kernel`` (with the headers of
    ``build.HEADERS``) in parallel; returns the loaded libraries by
    variant name."""
    procs = {}
    for name, text in variants.items():
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        (d / SOURCES.get(kernel, f"{kernel}.cu")).write_text(text)
        for header in build.HEADERS:
            shutil.copy(csrc / header, d / header)
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


def load_tree(tree: Path, module: str = "sparse_row_scatter"):
    """Another checkout's ``module.launch`` (a kernel module of
    ``repro_torch.kernels``), bound to that checkout's own ``build``
    module: its sources, its C signatures and its build directory."""
    import importlib.util

    def load(name, path):
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    kdir = tree / "src" / "repro_torch" / "kernels"
    tag = "tree_" + re.sub(r"\W", "_", str(tree))
    tree_build = load(f"{tag}_build", kdir / "build.py")
    wrapper = load(f"{tag}_{module}", kdir / f"{module}.py")
    wrapper.build = tree_build
    return wrapper.launch


def scatter_runs(dev) -> dict:
    """The main path's B2 calls (``serve.run_trickle`` on TaFeng, as
    ``chip_smoke.py`` drives it), each one's rows and ids read back:
    calls by sub-batch size, runs of entry rows naming one table row by
    length, and the runs in which more than one row carries a valid id
    (the only ones whose cells take deltas from several rows)."""
    from repro_torch.data import synthetic
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    launch, seen = ops._scatter.launch, []

    def record(table, rows, ids, vals):
        m, n_items = table.shape
        seen.append((rows.long().clamp(0, m - 1).cpu(),
                     ((ids >= 0) & (ids < n_items)).any(1).cpu()))
        return launch(table, rows, ids, vals)

    ops._scatter.launch = record
    try:
        serve.run_trickle(synthetic.generate("tafeng", seed=0, scale=1.0),
                          device=dev)
    finally:
        ops._scatter.launch = launch
    sizes, lengths, live_rows = {}, {}, {}
    for rows, live in seen:
        sizes[rows.numel()] = sizes.get(rows.numel(), 0) + 1
        uniq, inv, count = torch.unique(rows, return_inverse=True,
                                        return_counts=True)
        n_live = torch.zeros(uniq.numel(), dtype=torch.long).index_add_(
            0, inv, live.long())
        for c, nl in zip(count.tolist(), n_live.tolist()):
            if c > 1:
                lengths[c] = lengths.get(c, 0) + 1
                live_rows[nl] = live_rows.get(nl, 0) + 1
    return {"calls": len(seen), "calls_by_U": sizes,
            "runs_by_length": dict(sorted(lengths.items())),
            "runs_by_rows_with_a_valid_id": dict(sorted(live_rows.items()))}


# sparse_row_scatter.cu's phases: the row scan alone, the scan and the
# staging (no sort or add), everything but the sort, and 16 loads a
# thread a tile in place of 8
SCATTER_PHASES = {
    "scan": ("  if (__syncthreads_or(before)) return;",
             "  if (__syncthreads_or(before) || U > 0) return;"),
    "stage": ("  int n2 = 1;\n", "  if (n > 0) {\n    __syncthreads();\n"
              "    return;\n  }\n  int n2 = 1;\n"),
    "nosort": ("for (int k = 2; k <= n2; k <<= 1)",
               "for (int k = 2; k <= 0; k <<= 1)"),
    "kper16": ("constexpr int kPer = 8;", "constexpr int kPer = 16;"),
}


def scatter_inputs(gen, m, u, w, padded, dev):
    """A sub-batch of the sparse scatter into ``m`` table rows: int64
    rows, int32 ids (PAD = -1 on 40% and ``ids[:, 1] == ids[:, 0]``),
    f32 deltas.  ``padded`` has the appliers' shape: distinct users,
    then ``padded`` padding rows of user 0 with PAD ids and zero deltas
    (-1: none); else a run of 33 rows of one user with valid ids among
    random users."""
    ids = torch.randint(0, D, (u, w), generator=gen, device=dev,
                        dtype=torch.int32)
    ids[torch.rand(ids.shape, generator=gen, device=dev) < 0.4] = -1
    ids[:, 1] = ids[:, 0]
    vals = torch.randn((u, w), generator=gen, device=dev)
    if padded:
        rows = torch.randperm(m, generator=gen, device=dev)[:u]
        if padded < 0:                     # distinct users, no padding
            return rows, ids, vals
        rows[u - padded:] = 0
        ids[u - padded:] = -1
        vals[u - padded:] = 0.0
    else:
        rows = torch.randint(0, m, (u,), generator=gen, device=dev)
        rows[u // 2: u // 2 + 32] = rows[0].item()
    return rows, ids, vals


def scatter_main(root: Path, parents, build) -> int:
    """``--kernel sparse_row_scatter``: see the module's docstring."""
    import time
    from repro_torch.kernels import sparse_row_scatter

    dev = torch.device("cuda")
    res = {"root": str(root), "parents": [str(p) for p in parents],
           "kernel": "sparse_row_scatter", "runs": scatter_runs(dev)}
    print(json.dumps(res["runs"]), flush=True)
    wrappers = {**{f"parent_{p.name}": load_tree(p)
                   for p in parents},
                "change": sparse_row_scatter.launch}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    table = torch.rand((SCATTER_M, D), generator=gen, device=dev)
    shapes = {"add": (GATHER_U, GATHER_W, 0),
              "delete": (GATHER_U, SCATTER_W_DEL, 0),
              "add_padded": (GATHER_U, GATHER_W, 212),
              "add_distinct": (GATHER_U, GATHER_W, -1),
              "add_4096": (4096, GATHER_W, 0),
              "add_4096_distinct": (4096, GATHER_W, -1),
              "add_4096_padded": (4096, GATHER_W, 2047),
              "add_8192_distinct": (8192, GATHER_W, -1),
              "add_16384_distinct": (16384, GATHER_W, -1),
              "add_16384_padded": (16384, GATHER_W, 8191)}
    for label, (u, w, padded) in shapes.items():
        rows, ids, vals = scatter_inputs(gen, SCATTER_M, u, w, padded, dev)
        outs = [fn(table.clone(), rows, ids, vals)
                for fn in wrappers.values()]
        assert all(torch.equal(o.view(torch.int32), outs[0].view(
            torch.int32)) for o in outs), "the trees' tables differ"
        del outs
        valid = ids >= 0
        safe = torch.where(valid, ids, 0).long()
        safe_vals = torch.where(valid, vals, torch.zeros_like(vals))
        rows2d = rows[:, None].expand(u, w)
        t = table.clone()
        calls = {name: (lambda fn=fn: fn(t, rows, ids, vals))
                 for name, fn in wrappers.items()}
        calls["index_put"] = lambda: t.index_put_((rows2d, safe), safe_vals,
                                                  accumulate=True)
        shape = (f"{label}: U={u} W={w} rows int64 ids int32"
                 + {0: "", -1: ", distinct users"}.get(
                     padded, f", {padded} padding rows"))
        out = res.setdefault(label, {"shape": shape})
        for rnd in range(2):
            for name, fn in (calls.items() if rnd == 0
                             else reversed(list(calls.items()))):
                out.setdefault(f"{name}_ms", []).append(time_ms(fn))
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
                out.setdefault(f"{name}_burst100_ms", []).append(
                    start.elapsed_time(end) / 100)
                out.setdefault(f"{name}_host_ms", []).append(host)
        for name, fn in calls.items():
            own, every = device_ms(fn, ("sparse_row_scatter",)
                                   if name != "index_put" else ("",))
            out[f"{name}_device_own_ms"] = own
            out[f"{name}_device_all_ms"] = every
        del t
    # this tree's kernel with phases compiled out, by the profiler
    src = (root / "src" / "repro_torch" / "kernels" / "csrc" /
           "sparse_row_scatter.cu").read_text()
    variants = {name: src.replace(a, b) for name, (a, b)
                in SCATTER_PHASES.items() if a in src}
    if variants:
        libs = build_variants(build, root / "src" / "repro_torch" /
                              "kernels" / "csrc", root / "build" /
                              "phase_split" / "sparse_row_scatter",
                              "sparse_row_scatter",
                              {"whole": src, **variants})
        whole = build._lib
        gen.manual_seed(1)
        for label, (u, w, padded) in shapes.items():
            rows, ids, vals = scatter_inputs(gen, SCATTER_M, u, w, padded,
                                             dev)
            t = table.clone()
            for rnd in range(2):
                for name, lib in (libs.items() if rnd == 0
                                  else reversed(list(libs.items()))):
                    build._lib = lib
                    res[label].setdefault(f"phase_{name}_device_ms",
                                          []).append(device_ms(
                        lambda: sparse_row_scatter.launch(t, rows, ids,
                                                          vals),
                        ("sparse_row_scatter",))[0])
            del t
        build._lib = whole
    print(json.dumps(res), flush=True)
    return 0


# serving_topn.cu's phases (kPhases): 1 staging, 2 sums, 4 selection
BLEND_PHASES = {"stage": 1, "stage_sum": 3, "sum_select": 6, "select": 4}
PHASES_LINE = "constexpr int kPhases = 7;"


def blend_inputs(gen, dev) -> dict:
    """Stage B's inputs: (corpus, user ids, stage A's neighbours) at the
    kernel checks' input, on equal-norm rows, and at Q=32 and 1,024."""
    from repro_torch.kernels import knn_topk
    sparse = torch.rand((M, D), generator=gen, device=dev)
    sparse *= torch.rand((M, D), generator=gen, device=dev) < 0.01
    equal = torch.zeros((M, D), device=dev)
    for r0 in range(0, M, 1024):   # 120 items of value 1 a row
        r1 = min(M, r0 + 1024)
        cols = torch.rand((r1 - r0, D), generator=gen,
                          device=dev).argsort(1)[:, :120]
        equal[r0:r1].scatter_(1, cols, 1.0)
    out = {}
    for name, corpus, q in (("check", sparse, Q), ("equal_norms", equal, Q),
                            ("q32", sparse, 32), ("q1024", sparse, 1024)):
        uid = torch.randperm(M, generator=gen, device=dev)[:q]
        uid[0] = 1
        uid = uid.to(torch.int32)
        _, nbr = knn_topk.launch(corpus[uid.long()], corpus, K,
                                 query_gids=uid)
        out[name] = (corpus, uid, nbr)
    return out


def blend_main(root: Path, parents, build) -> int:
    """``--kernel blend_topn_onehot``: see the module's docstring."""
    import time
    from repro_torch.kernels import ref, serving_topn

    dev = torch.device("cuda")
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    res = {"root": str(root), "parents": [str(p) for p in parents],
           "kernel": "blend_topn_onehot", "k": K}
    wrappers = {**{f"parent_{p.name}": load_tree(p, "serving_topn")
                   for p in parents},
                "change": serving_topn.launch}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    inputs = blend_inputs(gen, dev)
    for label, (corpus, uid, nbr) in inputs.items():
        q = uid.shape[0]
        plan = serving_topn.plan_blend(q, M, D, K, TOPN, n_sms)
        passes = ref.blend_passes(nbr, M, plan.group, plan.stage_rows)
        distinct = [int(torch.unique(nbr[g0:g0 + plan.group]).numel())
                    for g0 in range(0, q, plan.group)]
        out = res.setdefault(label, {
            "shape": f"Q={q} M={M} I={D} k={K} n={TOPN}",
            "plan": plan._asdict(), "distinct_rows_max": max(distinct),
            "distinct_rows_min": min(distinct),
            "passes_max": int(passes.max()) + 1,
            "rows_used": int(torch.unique(torch.cat(
                [nbr.reshape(-1).long(), uid.long()])).numel())})
        exp = ref.blend_topn_ref(corpus, uid, nbr, ALPHA, TOPN)
        ordered = ref.blend_topn_ordered_ref(corpus, uid, nbr, ALPHA, TOPN,
                                             passes)
        for name, fn in wrappers.items():
            got = fn(corpus, uid, nbr, ALPHA, TOPN)
            torch.cuda.synchronize()
            assert torch.allclose(got[0], exp[0], rtol=1e-5, atol=1e-6), \
                (label, name)
            out[f"{name}_bitwise_ordered"] = bool(
                torch.equal(got[0].view(torch.int32),
                            ordered[0].view(torch.int32))
                and torch.equal(got[1], ordered[1]))
        assert out["change_bitwise_ordered"], label
        calls = {name: (lambda fn=fn: fn(corpus, uid, nbr, ALPHA, TOPN))
                 for name, fn in wrappers.items()}
        if q <= Q:
            u, nb = uid.long(), nbr.long()
            calls["library"] = lambda: torch.topk(
                ALPHA * corpus[u] + (1.0 - ALPHA) * corpus[nb].mean(1), TOPN)
        for rnd in range(2):
            for name, fn in (calls.items() if rnd == 0
                             else reversed(list(calls.items()))):
                out.setdefault(f"{name}_ms", []).append(time_ms(fn))
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
                out.setdefault(f"{name}_burst100_ms", []).append(
                    start.elapsed_time(end) / 100)
                out.setdefault(f"{name}_host_ms", []).append(host)
        for name, fn in calls.items():
            own, every = device_ms(fn, ("blend_", "merge_")
                                   if name != "library" else ("",))
            out[f"{name}_device_ms"] = own
            out[f"{name}_device_all_ms"] = every
        print(json.dumps({label: out}), flush=True)
    # this tree's kernel with phases compiled out, by the profiler
    csrc = root / "src" / "repro_torch" / "kernels" / "csrc"
    src = (csrc / SOURCES["blend_topn_onehot"]).read_text()
    if PHASES_LINE in src:
        variants = {"whole": src, **{
            name: src.replace(PHASES_LINE,
                              f"constexpr int kPhases = {mask};")
            for name, mask in BLEND_PHASES.items()}}
        libs = build_variants(build, csrc, root / "build" / "phase_split" /
                              "blend_topn_onehot", "blend_topn_onehot",
                              variants)
        whole = build._lib
        for label, (corpus, uid, nbr) in inputs.items():
            for rnd in range(2):
                for name, lib in (libs.items() if rnd == 0
                                  else reversed(list(libs.items()))):
                    build._lib = lib
                    res[label].setdefault(f"phase_{name}_device_ms",
                                          []).append(device_ms(
                        lambda: serving_topn.launch(corpus, uid, nbr, ALPHA,
                                                    TOPN),
                        ("blend_group",))[0])
        build._lib = whole
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
    ap.add_argument("--parent", type=Path, nargs="+", default=[],
                    help="with --kernel sparse_row_scatter or "
                         "blend_topn_onehot: checkouts timed in turns "
                         "with --root")
    args = ap.parse_args()
    if args.parent and args.kernel not in ("sparse_row_scatter",
                                           "blend_topn_onehot"):
        ap.error("--parent is read by --kernel sparse_row_scatter and "
                 "blend_topn_onehot only")
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
    if kernel == "sparse_row_scatter":
        return scatter_main(root, [p.resolve() for p in args.parent],
                            build)
    if kernel == "blend_topn_onehot":
        return blend_main(root, [p.resolve() for p in args.parent], build)
    src = (csrc / f"{kernel}.cu").read_text()
    variants = {"whole": src,
                "products": MERGE_CALL.sub(r"\1if (0) \2", src)}
    assert variants["products"] != src, "no merge call found"
    # the ring's products split further: B3's, and B5's fp32 design
    split = (kernel == "knn_topk" and hasattr(knn_topk, "plan_knn")) or \
        (kernel == "knn_topk_dtiled" and
         "ring_f32" in getattr(knn_topk, "_DESIGNS", {}))
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
        for v in ("feed", "fma"):
            if v in libs:
                runs[f"fp32_{v}"] = (v, runs["fp32_whole"][1])
    if split and kernel == "knn_topk_dtiled":
        res["plan"] = dataclasses.asdict(knn_topk.plan_for(qf, corpus, K, BD))
    elif split:
        n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = knn_topk.plan_knn(Q, M, K, n_sms)
        res["plan"] = list(plan)
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
    if kernel == "knn_topk" or split:
        # the whole fp32 call's device time: the kernel's own two
        # kernels, and every kernel the wrapper launched
        build._lib = libs["whole"]
        own = ("knn_tile_kernel" if kernel == "knn_topk"
               else "dtiled_ring_kernel", "merge_lists_kernel")
        res["fp32_device_own_ms"], res["fp32_device_all_ms"] = device_ms(
            runs["fp32_whole"][1], own)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
