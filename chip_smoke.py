#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (nothing is caught):

1. environment -- the card's name and power limit, torch and CUDA
   versions, TF32 off for every plain matrix product;
2. build -- the port's CUDA kernels, compiled from ``src/repro_torch/
   kernels/csrc`` with nvcc for sm_90a into ``build/repro_torch_kernels``;
3. kernel checks -- each kernel against its plain PyTorch version on the
   card at the main path's shapes (TaFeng at its published size), with
   the kernel's, the plain version's and one PyTorch yardstick's median
   times, and the kernel's bound from this run's bytes and operations;
4. main path -- the port's serving trickle (``launch/serve.py``) at full
   width: 13,949 users x 11,997 items, m=7, k=300, alpha=0.7, a bulk
   load of one mixed stream in micro-batches of 512, then 4 request
   batches of 256 users with 64 new baskets between them; once with the
   kernels (launch counts reset just before, read just after) and once
   with every kernel replaced by its plain version, the two runs held
   against each other;
5. summary -- every kernel's launches, then one JSON line of kernel
   records, and last the ``{"ok": true, ...}`` line.

It needs a CUDA card and the rest of the repository; anywhere else it
exits non-zero without printing a result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import convert  # noqa: E402
from repro_torch.core import knn  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels import (build, knn_topk, ops, ref,  # noqa: E402
                                 serving_topn, sparse_row_gather,
                                 sparse_row_scatter)
from repro_torch.launch import serve  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, HBM3
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
Q, TOPN, ALPHA = 256, 10, 0.7
REPS = 5

KERNELS = {
    "sparse_row_gather": dict(
        source="src/repro_torch/kernels/csrc/sparse_row_gather.cu",
        replaces="src/repro/kernels/sparse_row_gather.py:64"),
    "sparse_row_scatter": dict(
        source="src/repro_torch/kernels/csrc/sparse_row_scatter.cu",
        replaces="src/repro/kernels/sparse_row_scatter.py:81"),
    "knn_topk": dict(
        source="src/repro_torch/kernels/csrc/knn_topk.cu",
        replaces="src/repro/kernels/knn_topk.py:113"),
    "blend_topn_onehot": dict(
        source="src/repro_torch/kernels/csrc/serving_topn.cu",
        replaces="src/repro/kernels/serving_topn.py:116"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = REPS) -> float:
    """Median device time of ``fn`` over ``reps`` runs after a warm-up
    (CUDA events around each run)."""
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


def bound(n_bytes: float, n_ops: float) -> tuple:
    t_bytes, t_ops = n_bytes / PEAK_BYTES, n_ops / PEAK_FP32
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def card_line() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# kernel checks at the main path's shapes
# ---------------------------------------------------------------------------

def sparse_inputs(gen, m, n_items, u, w, dev):
    rows = torch.randint(0, m, (u,), generator=gen, device=dev)
    rows[u // 2: u // 2 + 32] = rows[0]           # duplicate rows
    ids = torch.randint(0, n_items, (u, w), generator=gen, device=dev)
    ids[torch.rand((u, w), generator=gen, device=dev) < 0.4] = -1   # PAD
    ids[:, 1] = ids[:, 0]                          # duplicate ids in a row
    vals = torch.randn((u, w), generator=gen, device=dev)
    return rows.to(torch.int32), ids.to(torch.int32), vals


def check_sparse(gen, table, u, w_add, w_del, records):
    m, n_items = table.shape
    dev = table.device
    for label, w in (("add", w_add), ("delete", w_del)):
        rows, ids, vals = sparse_inputs(gen, m, n_items, u, w, dev)
        got = sparse_row_gather.launch(table, rows, ids)
        exp = ref.sparse_row_gather_ref(table, rows, ids)
        torch.cuda.synchronize()
        g_err = float((got - exp).abs().max())
        assert torch.equal(got, exp), f"gather ({label}) differs: {g_err}"

        t_k, t_p = table.clone(), table.clone()
        sparse_row_scatter.launch(t_k, rows, ids, vals)
        ref.sparse_row_scatter_ref(t_p, rows, ids, vals)
        t_again = table.clone()
        sparse_row_scatter.launch(t_again, rows, ids, vals)
        torch.cuda.synchronize()
        s_err = float((t_k - t_p).abs().max())
        # the plain version sums a cell's deltas in another order
        assert torch.allclose(t_k, t_p, rtol=1e-6, atol=1e-6), s_err
        assert torch.equal(t_k, t_again), "scatter reruns differ"
        ti, tpi = table.round(), table.round()      # integer-valued: exact
        sparse_row_scatter.launch(ti, rows, ids, vals.round())
        ref.sparse_row_scatter_ref(tpi, rows, ids, vals.round())
        torch.cuda.synchronize()
        assert torch.equal(ti, tpi), "integer scatter differs"
        del t_k, t_p, t_again, ti, tpi

        valid = ids >= 0
        cells = rows.long()[:, None] * n_items + ids.long()
        n_valid = int(valid.sum())
        n_cells = int(torch.unique(cells[valid]).numel())
        idx_bytes = u * 4 + u * w * 4
        safe_ids = torch.where(valid, ids, torch.zeros_like(ids)).long()
        safe_vals = torch.where(valid, vals, torch.zeros_like(vals))
        rows2d = rows.long()[:, None].expand(u, w)
        t_bench = table.clone()
        timings = dict(
            gather=time_ms(lambda: sparse_row_gather.launch(table, rows,
                                                            ids)),
            gather_plain=time_ms(lambda: ref.sparse_row_gather_ref(
                table, rows, ids)),
            gather_lib=time_ms(lambda: table[rows2d, safe_ids]),
            scatter=time_ms(lambda: sparse_row_scatter.launch(
                t_bench, rows, ids, vals)),
            scatter_plain=time_ms(lambda: ref.sparse_row_scatter_ref(
                t_bench, rows, ids, vals)),
            scatter_lib=time_ms(lambda: t_bench.index_put_(
                (rows2d, safe_ids), safe_vals, accumulate=True)))
        del t_bench
        log(f"  sparse pair, {label} path U={u} W={w} "
            f"({n_valid} valid ids, {n_cells} distinct cells): gather "
            f"{timings['gather']:.4f} ms (plain "
            f"{timings['gather_plain']:.4f}, indexing "
            f"{timings['gather_lib']:.4f}), scatter "
            f"{timings['scatter']:.4f} ms (plain "
            f"{timings['scatter_plain']:.4f}, index_put_ "
            f"{timings['scatter_lib']:.4f}); max |err| gather {g_err} "
            f"scatter {s_err}")
        if label == "add":       # the add path launches most: it is timed
            records["sparse_row_gather"] = dict(
                max_abs_err=g_err, ms=timings["gather"],
                plain_ms=timings["gather_plain"],
                library_ms=timings["gather_lib"],
                shape=f"U={u} W={w}",
                bound=bound(idx_bytes + n_valid * 4 + u * w * 4, 0))
            records["sparse_row_scatter"] = dict(
                max_abs_err=s_err, ms=timings["scatter"],
                plain_ms=timings["scatter_plain"],
                library_ms=timings["scatter_lib"],
                shape=f"U={u} W={w}",
                bound=bound(idx_bytes + u * w * 4 + n_cells * 8, n_valid))


def int_corpus(gen, m, d, dev):
    """Small-integer corpus with duplicate rows and columns: exact fp32
    scores, with true ties."""
    c = torch.randint(0, 3, (m, d), generator=gen, device=dev).float()
    c[1::4] = c[0]
    c[:, 1] = c[:, 0]
    return c


def plain_scores(q, c, uid):
    s = 2.0 * (q @ c.T) - ref.corpus_sqnorm(c)[None, :]
    s[torch.arange(q.shape[0], device=q.device), uid.long()] = \
        float("-inf")
    return s


def check_stage_a_edges(gen, dev):
    """Stage A on a small integer corpus cut into several slices with a
    partial last tile and a D that is no multiple of the kernel's chunk,
    up to k = M (the self column's −inf in the last slot): ids and
    values exact."""
    m, d, q_n = 1000, 211, 13
    c = int_corpus(gen, m, d, dev)
    uid = torch.randperm(m, generator=gen, device=dev)[:q_n].to(torch.int32)
    for k in (1, 7, 300, m - 1, m):
        vk, ik = knn_topk.launch(c[uid.long()], c, k, query_gids=uid)
        vp, ip = ref.knn_topk_ref(c[uid.long()], c, k, query_gids=uid)
        torch.cuda.synchronize()
        assert torch.equal(ik, ip) and torch.equal(vk, vp), \
            f"stage A edge case k={k} differs"
    log(f"  stage A M={m} D={d} Q={q_n} k in (1, 7, 300, M-1, M): exact")


def check_stage_a(corpus, c_int, uid, records):
    q, q_int = corpus[uid.long()], c_int[uid.long()]
    for k in (300, min(900, corpus.shape[0] - 1)):      # k=900: instacart
        vk, ik = knn_topk.launch(q, corpus, k, query_gids=uid)
        vp, ip = ref.knn_topk_ref(q, corpus, k, query_gids=uid)
        s = plain_scores(q, corpus, uid)
        torch.cuda.synchronize()
        err = float((vk - vp).abs().max())
        # fp32 sums of 11,997 products in another order: values agree to
        # rtol 1e-5; an id may differ only where its plain score equals
        # the plain version's at that rank (score-equivalent)
        assert torch.allclose(vk, vp, rtol=1e-5, atol=1e-5), err
        assert torch.allclose(s.gather(1, ik.long()), vp, rtol=1e-5,
                              atol=1e-5), "stage A ids not equivalent"
        assert not bool((ik == uid[:, None]).any()), "self not excluded"
        assert all(len(set(r)) == k for r in ik.tolist())
        vki, iki = knn_topk.launch(q_int, c_int, k, query_gids=uid)
        vpi, ipi = ref.knn_topk_ref(q_int, c_int, k, query_gids=uid)
        torch.cuda.synchronize()
        assert torch.equal(iki, ipi), f"stage A tie-break (k={k}) differs"
        assert torch.equal(vki, vpi), f"stage A integer values (k={k})"
        log(f"  stage A k={k}: max |err| {err}, integer ties exact")
        if k == 300:
            records["knn_topk"] = dict(max_abs_err=err, nbr=ip,
                                       nbr_int=ipi)
    m, d = corpus.shape
    cn = ref.corpus_sqnorm(corpus)
    rec = records["knn_topk"]
    rec.update(
        ms=time_ms(lambda: knn_topk.launch(q, corpus, 300, query_gids=uid)),
        plain_ms=time_ms(lambda: ref.knn_topk_ref(q, corpus, 300,
                                                  query_gids=uid)),
        library_ms=time_ms(lambda: torch.topk(2.0 * (q @ corpus.T)
                                              - cn[None, :], 300)),
        shape=f"Q={Q} M={m} D={d} k=300",
        bound=bound((Q * d + m * d + m + Q) * 4 + Q * 300 * 8,
                    2.0 * Q * m * d))
    log(f"  stage A timed: {rec['ms']:.4f} ms (plain {rec['plain_ms']:.4f}, "
        f"matmul + topk {rec['library_ms']:.4f})")


def check_stage_b(corpus, c_int, uid, records):
    m, n_items = corpus.shape
    nbr, nbr_int = records["knn_topk"].pop("nbr"), \
        records["knn_topk"].pop("nbr_int")
    k = nbr.shape[1]
    vk, ik = serving_topn.launch(corpus, uid, nbr, ALPHA, TOPN)
    vp, ip = ref.blend_topn_ref(corpus, uid, nbr, ALPHA, TOPN)
    pred = ALPHA * corpus[uid.long()] + (1.0 - ALPHA) \
        * corpus[nbr.long()].sum(1) / k
    torch.cuda.synchronize()
    err = float((vk - vp).abs().max())
    # fp32 sums of k rows in another order
    assert torch.allclose(vk, vp, rtol=1e-5, atol=1e-6), err
    assert torch.allclose(pred.gather(1, ik.long()), vp, rtol=1e-5,
                          atol=1e-6), "stage B ids not equivalent"
    vki, iki = serving_topn.launch(c_int, uid, nbr_int, ALPHA, TOPN)
    vpi, ipi = ref.blend_topn_ref(c_int, uid, nbr_int, ALPHA, TOPN)
    torch.cuda.synchronize()
    assert torch.equal(iki, ipi), "stage B tie-break differs"
    assert torch.allclose(vki, vpi, rtol=1e-6), "stage B integer values"
    log(f"  stage B k={k} n={TOPN}: max |err| {err}, integer ties exact")
    used = torch.unique(torch.cat([nbr.reshape(-1), uid.long()]))
    records["blend_topn_onehot"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: serving_topn.launch(corpus, uid, nbr, ALPHA,
                                               TOPN)),
        plain_ms=time_ms(lambda: ref.blend_topn_ref(corpus, uid, nbr,
                                                    ALPHA, TOPN)),
        library_ms=time_ms(lambda: torch.topk(
            ALPHA * corpus[uid.long()]
            + (1.0 - ALPHA) * corpus[nbr.long()].mean(1), TOPN)),
        shape=f"Q={Q} M={m} I={n_items} k={k} n={TOPN}",
        # Q·(k+1)·I fp32 adds; an add takes an FMA's issue slot, which
        # the peak counts as two operations
        bound=bound(used.numel() * n_items * 4 + Q * (k + 1) * 4
                    + Q * TOPN * 8, 2.0 * Q * (k + 1) * n_items))
    rec = records["blend_topn_onehot"]
    log(f"  stage B timed: {rec['ms']:.4f} ms (plain {rec['plain_ms']:.4f}, "
        f"gather + mean + topk {rec['library_ms']:.4f})")


# ---------------------------------------------------------------------------
# the main path, with the kernels and with the plain versions
# ---------------------------------------------------------------------------

def request_breakdown(run, p):
    """Device time of each request's two serving stages on the corpus it
    was served from (CUDA events), beside the plain pipeline's."""
    for i, (users, corpus) in enumerate(zip(run.requests, run.corpora)):
        uid = torch.as_tensor(users, dtype=torch.int32, device=corpus.device)
        q = corpus[uid.long()]
        k = min(p.k_neighbors, corpus.shape[0] - 1)
        _, nbr = knn_topk.launch(q, corpus, k, query_gids=uid)
        t_a = time_ms(lambda: knn_topk.launch(q, corpus, k, query_gids=uid),
                      3)
        t_b = time_ms(lambda: serving_topn.launch(corpus, uid, nbr, p.alpha,
                                                  TOPN), 3)
        t_p = time_ms(lambda: ref.fused_recommend_ref(corpus, uid, k,
                                                      p.alpha, TOPN), 3)
        log(f"  request {i} on its corpus: stage A {t_a:.4f} ms, stage B "
            f"{t_b:.4f} ms; plain pipeline {t_p:.4f} ms")


def main_path(ds, records, dev):
    build.reset_launch_counts()
    kern = serve.run_trickle(ds, device=dev, keep_corpora=True)
    torch.cuda.synchronize()
    launches = dict(build.launch_counts)
    log("main path with the kernels:\n" + serve.summary(kern))
    build.reset_launch_counts()
    with ops.default_impl("ref"):
        plain = serve.run_trickle(ds, device=dev)
    torch.cuda.synchronize()
    log("main path with the plain versions:\n" + serve.summary(plain))
    assert not any(build.launch_counts.values()), \
        ("the plain run launched kernels", build.launch_counts)
    for name, n in launches.items():
        assert n > 0, f"kernel {name} was not launched on the main path"
        records[name]["launches"] = n
    request_breakdown(kern, ds.params)

    a = convert.state_to_numpy(kern.engine.store.state)
    b = convert.state_to_numpy(plain.engine.store.state)
    for name in ("history", "group_sizes", "n_baskets", "n_groups"):
        assert np.array_equal(a[name], b[name]), f"state leaf {name}"
    ks, ps = kern.engine.store.state, plain.engine.store.state
    for fn in ("materialized_user_vecs", "materialized_last_group_vecs"):
        x, y = getattr(ks, fn)(), getattr(ps, fn)()
        assert torch.allclose(x, y, rtol=1e-4, atol=1e-5), \
            (fn, float((x - y).abs().max()))
    for name in ("events_processed", "batches", "host_fetches",
                 "dropped_adds", "refreshes", "renormalizations"):
        assert getattr(kern.engine.metrics, name) == \
            getattr(plain.engine.metrics, name), name

    p = ds.params
    total = exact = 0
    for users, corpus, kr, pr in zip(kern.requests, kern.corpora,
                                     kern.recs, plain.recs):
        res = knn.compare_recommendations(corpus, users, pr, kr,
                                          k=p.k_neighbors, alpha=p.alpha,
                                          rtol=1e-5)
        log(f"  request of {len(users)} users: {res}")
        assert res["mismatch"] == 0, res
        total += len(users)
        exact += res["exact"]
    assert exact >= 0.9 * total, ("exact class", exact, total)
    m = kern.engine.metrics
    log(f"main path: {kern.n_events / kern.load_seconds:.0f} load "
        f"events/s with the kernels, {plain.n_events / plain.load_seconds:.0f}"
        f" with the plain versions; request latency (ms) kernels "
        f"{[round(t * 1e3, 3) for t in kern.request_seconds]}, plain "
        f"{[round(t * 1e3, 3) for t in plain.request_seconds]}; "
        f"{m.host_fetches / m.batches:.3f} host fetches per step; "
        f"{exact}/{total} queries in the exact class (identical ids)")


def kernel_checks(ds, dev) -> dict:
    """Phase 3: every kernel against its plain version at the shapes the
    main path gives it (the store shapes ``serve.run_trickle`` builds
    for ``ds``).  Returns one record per kernel."""
    p = ds.params
    n_users, n_items = len(ds.histories), p.n_items
    n_max = max(len(h) for h in ds.histories.values()) + 8
    b_max = max(len(b) for h in ds.histories.values() for b in h) + 2
    log("kernel checks (kernel vs plain version on the card):")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    records: dict = {}
    table = torch.rand((n_users, n_items), generator=gen, device=dev)
    check_sparse(gen, table, 512, (p.group_size + 1) * b_max,
                 n_max * b_max + 1, records)
    del table
    # serving corpora: sparse non-negative rows like TIFU user vectors
    # (about 120 of 11,997 items set), and a small-integer one for ties
    corpus = torch.rand((n_users, n_items), generator=gen, device=dev)
    corpus *= torch.rand((n_users, n_items), generator=gen,
                         device=dev) < 0.01
    c_int = int_corpus(gen, n_users, n_items, dev)
    uid = torch.randperm(n_users, generator=gen, device=dev)[:Q]
    uid[0] = 1                                   # a duplicated row
    uid = uid.to(torch.int32)
    check_stage_a_edges(gen, dev)
    check_stage_a(corpus, c_int, uid, records)
    check_stage_b(corpus, c_int, uid, records)
    del corpus, c_int
    torch.cuda.empty_cache()
    return records


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs on "
                         "a GPU only")
    t_start = time.perf_counter()
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    log(f"card: {card}; {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, Python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    build.library(verbose=True)
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for line in build.last_build_log.splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas: " + line.strip())

    t0 = time.perf_counter()
    ds = synthetic.generate("tafeng", seed=0, scale=1.0)
    p = ds.params
    n_users, n_items = len(ds.histories), p.n_items
    assert (n_users, n_items, p.group_size, p.k_neighbors, p.alpha) == \
        (13949, 11997, 7, 300, 0.7), (n_users, n_items, p)
    log(f"data: TaFeng {n_users} users x {n_items} items generated in "
        f"{time.perf_counter() - t0:.1f} s")

    records = kernel_checks(ds, dev)

    t0 = time.perf_counter()
    main_path(ds, records, dev)
    log(f"main path: {time.perf_counter() - t0:.1f} s")

    log("kernels launched on the main path: " + ", ".join(
        f"{name}={records[name]['launches']}" for name in KERNELS))
    out = []
    for name, meta in KERNELS.items():
        r = records[name]
        bound_ms, bound_by = r["bound"]
        log(f"  {name} at {r['shape']}: {r['ms']:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}), plain {r['plain_ms']:.4f} "
            f"ms, library {r['library_ms']:.4f} ms")
        out.append(dict(name=name, route="cuda", source=meta["source"],
                         replaces=meta["replaces"],
                         launches=r["launches"],
                         max_abs_err=r["max_abs_err"], ms=r["ms"],
                         plain_ms=r["plain_ms"], bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=r["library_ms"]))
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": out}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
