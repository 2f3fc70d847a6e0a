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
   times, and the kernel's bound from this run's bytes and operations
   (the sparse pair at the appliers' int64 rows and int32 ids, also by
   a burst of 100, the profiler and the host clock, beside indexing and
   ``index_put_`` read the same way; the sparse scatter bitwise the sum
   in entry order at every pair of index dtypes, one kernel a call, and
   timed at U=4,096 too; the neighbour blend bitwise the sum in order
   j = 0..k-1 in its staging passes, with its plan, the distinct rows
   it reads and four readings beside gather + mean + ``topk``'s; the
   row blend bitwise the sum in order j = 0..k-1, also by a burst of 10
   and the profiler; the D-tiled stage A's fp32 design, B5's own record,
   also by a burst of 100, the profiler and the host clock); then the
   edge cases of the D-tiled stage A (every design and query tile, split
   and unsplit), of the neighbour blend (a
   group over one pass, n = 33 and 1,024, k = 1, PAD rows, users out of
   range, M = 1, I = 31), of the sparse scatter (one row's long run,
   U=1, W=1, I=1, M*I > 2^31), of the multi-hot scatter and of
   attention;
4. main path -- the port's serving trickle (``launch/serve.py``,
   ``run_trickle(quantized=True)``) at full width: 13,949 users x 11,997
   items, m=7, k=300, alpha=0.7, a bulk load of one mixed stream in
   micro-batches of 512, then 4 request batches of 256 users with 64 new
   baskets between them, each batch served from the fp32 corpus and
   again from the int8 cache (bd=512); once with the kernels (launch
   counts reset just before, read just after) and once with every kernel
   replaced by its plain version, the two runs held against each other,
   the int8 cache held bitwise against a fresh quantization after every
   request and the int8 answers against the plain int8 pipeline;
5. fp32 D-tiled serving -- ``ops.fused_recommend(bd=512)`` on the main
   path's last corpus (counts reset before, read after; B5's D-tiled
   launches there are all its fp32 design's), held against the
   ``bd=None`` answer, and the request timed on the host clock;
6. cross-shard serving -- that corpus split round-robin into 2 shards
   on the one card, ``knn.sharded_recommend_for_users`` and
   ``sharded_recommend_for_users_quant`` for the last request's users
   (counts reset before, read after; the selected rows read in place
   from the shard corpora), held against the single-corpus answers, the
   plain versions and, identical, the pre-fetched route (the selected
   rows gathered first), each shard's int8 candidates bitwise; both
   routes' request times on the host clock;
7. from-scratch rebuild -- every user's Eq. 1+2 vector rebuilt from the
   main path's final state in one batched ``ops.multihot_scatter``
   (counts reset before, read after), held against its plain version
   and against the maintained state (rtol=1e-4, atol=1e-5), and timed;
8. durability -- the main path's mixed stream at full width, each event
   with its seqno (counts reset before, read after): engine E1 loads the
   first half, takes a synchronous checkpoint (timed), loads the rest
   and dies at ``LATEST.pre_replace`` in its second checkpoint (the one
   exception caught, asserted raised); a fresh engine E2 restores commit
   1 (timed) and replays the whole stream with seeded duplicates
   (``faults.redelivered``; timed in events/s), held to E1's state
   (integer leaves exact, vectors rtol=1e-4, atol=1e-5) with each event
   applied once; a checkpoint of E1 restores into E3 with the nine
   leaves bitwise and the last request's fp32 and int8 (bd=512) ids
   identical; an ``AsyncCheckpointer`` commit (caller-thread time beside
   the synchronous one) restores to the snapshot-time leaves after 64
   more baskets; a frozen E1 answers identically after 64 more, a thawed
   one as a fresh corpus; a cosine request answers as the plain pipeline
   with no kernel launched.  Logs checkpoint and restore seconds, npz
   bytes, replay events/s and the async caller-thread seconds beside the
   card's name and power limit;
9. sharded engine -- the same stream, each event with its seqno,
   through ``ShardedStreamingEngine.create(UserShardSpec(13949, 2), ...,
   devices=make_user_shard_devices(2))`` on the one card in micro-batches
   of 512 a shard (counts reset after the single engine that is its
   yardstick has loaded the stream and answered the requests, read at
   the end, the fresh corpus's answers left out; B1 and B2 launched by
   the load, the replay and the reshard's drain, B3, B5, B6 and B7 by
   the requests, B4 not at all): the state mapped back through the spec
   held against that single engine (integer leaves exact,
   vectors bitwise; users that differ in any bit are named with both
   engines' maintenance counters and held to rtol=1e-4, atol=1e-5); 4
   requests of 256 users, fp32 and int8 (bd=512), held by
   ``compare_recommendations`` against the single engine's answers and
   the same engine's under ``ops.default_impl("ref")`` and timed on the
   host clock; a synchronous commit after the first half, then a crash
   at ``LATEST.pre_replace``'s 2nd hit in the next commit (shard 0's
   lands, shard 1's does not); a restore into 2 shards and a replay with
   ``faults.redelivered`` duplicates (each event applied once); the
   first-half commit resharded into 3 shards, the whole stream submitted
   (the second half pending: legacy-log dedup) and drained; then
   ``recover_shard(1)``, answering from its frozen snapshot during the
   recovery and as a fresh corpus after the thaw.  Logs the load rate
   beside phase 4's, the request ms, the commit seconds and bytes, the
   restore and reshard seconds and the replay events/s beside the card's
   name and power limit (commits under ``build/chip_smoke_shard_ckpt/``,
   removed after);
10. compliance -- the same stream, each event with its seqno, through a
   single engine (micro-batches of 512) with both serving caches warm
   and one out-of-range deletion quarantined for a victim; then
   ``forget_user`` on 64 users drawn with a seeded generator from those
   with a retained history, the longest history among them (counts
   reset before, read after: B1 and B2 launched), each receipt clean,
   its deletions the user's ``retained_histories`` length, its seqnos
   contiguous from the engine's next seqno, the victim's dead letter
   purged; ``certify`` over the log and the forgets with a checkpoint
   round trip (counts reset before, read after: B3 and B4 launched at
   the active-user query count, B5, B6, B7 and B9 not), compliant with
   its envelope slack <= 0, and its two serving calls (the maintained
   and the canonical retained-only corpus) held against the plain
   route on the same rows in query chunks by ``compare_recommendations``
   (0 mismatches, >= 90% exact); then a 2-shard engine of the same
   stream: the same users forgotten through the router, 64 new baskets
   of other users admitted with no dedup, ``certify`` reading both
   shards' commits.  Logs the receipts' median and maximum latency,
   the slowest user's deletions, both routes' overlap means and the
   certify seconds beside the card's name and power limit (commits
   under ``build/chip_smoke_compliance_ckpt/``, removed after);
11. million-item point -- M=256 random rows, Q=32, I=1,048,576, k=16,
   bd=1024 (the top point of benchmarks/bench_serving.py::ScaleConfig):
   the D-tiled stage A in both modes against its plain version (fp32
   in one query tile, split over the SMs) and timed, then
   ``knn.recommend_for_users_quant`` (counts reset before, read after)
   held against its plain pipeline on the dequantized corpus;
12. granite-3-2b serving -- the dense LM at its published widths and
   depth (40 layers, bf16, weights from a seeded generator): layer 0's
   prefill attention kernel against plain and timed, then 4 prompts of
   4,096 tokens prefilled and 16 greedy decode steps, once with the
   kernels (counts reset before, read after) and once with the plain
   versions; last-position logits held by the gate against an f32 run
   of the same weights, greedy tokens reported;
13. recommender serving -- two-tower, BERT4Rec, DeepFM and DLRM at their
   published widths (weights from a seeded generator): first the four
   ``smoke_config()`` models on the card against the CPU, and B3 (dot)
   against its plain version at D = 64, 80 and 256, Q = 1 and 64,
   200,000 rows; then two-tower's ``serve_step`` at 512 and 262,144
   pairs, its index build (``item_tower`` over 1,000,000 items) and
   ``retrieval_step`` (1 query against them, top 100, B3); BERT4Rec's
   ``serve_step`` at 512 and 262,144 users (top 20) and
   ``retrieval_step`` against 1,000,000 candidates (B3); DeepFM's and
   DLRM's ``serve_step`` at 512 and 262,144 (DLRM's vocabularies capped
   at 2^24 rows: 45 GB of the 89.5 GiB of tables); the retrieval
   example's 64 queries against 200,000 candidates (B3).  Every serving
   call counted (only the three retrievals launch, B3 once each), timed
   on the host clock with its peak memory; B3 held to its plain version
   by the parity rule and timed beside it, matmul + ``topk`` and its
   bound (the phase runs under ``torch.no_grad()``, as serving does);
14. recommender and GNN training -- two-tower, DLRM, DeepFM, BERT4Rec
   and DimeNet with the port's AdamW (launch counts reset before, read
   after: no kernel of the port is on this path, and none launches).
   First each ``smoke_config()`` model (BERT4Rec with the full and the
   sampled cloze loss, DimeNet on molecules and on a feature graph)
   takes 3 steps (warmup 1, lr 3e-6) on the card and on the CPU from
   the same seeded weights and batch, losses and parameters held to
   rtol=1e-5, atol=1e-5 (3 lr_t at or below that atol: Adam moves a
   parameter whose gradient is ~0 by up to lr_t a step, whichever sign
   the card's unordered segment sums give that gradient).  Then each at its published widths, weights
   from a seeded generator, fp32 with TF32 off, 5 steps of the cells'
   ``adamw(total_steps=10000)``: two-tower at 32,768 pairs (the cell's
   65,536 would need ~51 GB of [B, B] logits and their gradients),
   DLRM at 65,536 with each vocabulary capped at 2^22 rows (table,
   gradient, m and v 4 x 12.8 GB), DeepFM at 65,536, BERT4Rec's sampled
   cloze at 8,192 sequences (20 masked, 8,192 negatives), DimeNet's
   ``molecule`` and ``full_graph_sm`` cells at their own sizes; each
   loss finite, the parameters moved, the global gradient norm of step
   1 finite and above 0 with every parameter the loss reads given a
   gradient that is not all 0 after the clip (``molecule`` alone may
   fail this, and is then logged as a step with no update: ROADMAP.md
   §C item 8), the median of steps 2-5 on the host clock, the peak memory and
   one more step under the profiler, beside the card's name and power
   limit;
15. LM zoo serving (run right after phase 12: after phase 14's
   traces ``torch.profiler`` records no kernel) -- qwen2-moe-a2.7b (24 layers, 60 routed experts
   stored as 64, top-4, 4 shared), deepseek-v3-671b (MLA and routed
   experts; depth cut to 1 dense + 1 MoE layer), gemma3-27b (cut to 5
   local + 1 global layer) and command-r-plus-104b (cut to 2 layers), at
   their published widths, bf16, weights from a seeded generator, one
   model on the card at a time, each through phase 12's steps (the
   helper ``lm_path`` both phases share): layer 0's prefill attention
   kernel against plain and timed (qwen2-moe at D = 128 on
   ``tma_wgmma``, DeepSeek's MLA at D = 192 on ``cuda_cores``, V padded
   from 128 for the kernel and unpadded for the plain version), 4
   prompts of 4,096 tokens and 16 greedy steps with the kernels (counts
   reset before, read after: B9 once per layer, nothing else) and with
   the plain versions (no launch), the last MoE layer's prefill expert
   choices compared between the two runs, the logit gate against an f32
   run of the same weights rebuilt from the seed after the bf16 model is
   freed, a profile of one prefill and one decode step;
16. LM training (run after phase 15, before phase 13) -- 9b, the
   gradient of B9, alone at granite-3-2b's layer 0 (B 4, S 4,096, H 32,
   KV 8, D 64, bf16, causal), qwen2-moe's (D 128), a gemma3 local layer
   (window 1,024), f32, an odd S, MLA's D 192 without the causal mask,
   D 32 and one token: dq, dk and dv held to ``ref.flash_attention_bwd_ref``
   by the LM logits row's layer-0 bounds, bitwise from run to run, timed
   by events, the profiler, a burst and the host clock beside the plain
   version and SDPA's backward; then (counts reset before, read after: B9
   and 9b only) the gradient gate (granite at full width cut to 4
   layers, B 4 x S 4,096: step-1 gradients with the kernels against the
   plain versions per leaf within 2x the plain run's own error against
   an f32 run, every layer's attention weights given a gradient),
   granite-3-2b at full width and depth taking 5 AdamW steps (step ms,
   tokens/s, peak memory, one more step under the profiler), the
   training driver on ``lm100m`` (20 steps with a checkpoint, a resume to
   30), and the granite, qwen2-moe, deepseek and gemma3 smoke models'
   3 steps card against CPU;
17. summary -- every kernel's launches, then one JSON line of kernel
   records, and last the ``{"ok": true, ...}`` line.

It needs a CUDA card and the rest of the repository; anywhere else it
exits non-zero without printing a result.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import importlib.util
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import convert  # noqa: E402
from repro_torch.compliance import certify, retained_histories  # noqa: E402
from repro_torch.configs import (bert4rec_cfg,  # noqa: E402
                                 command_r_plus_104b, deepfm_cfg,
                                 deepseek_v3_671b, dimenet_cfg, dlrm_mlperf,
                                 gemma3_27b, granite_3_2b, qwen2_moe_a2_7b,
                                 recsys_shapes, two_tower_retrieval)
from repro_torch.core import knn  # noqa: E402
from repro_torch.core.tifu import closed_form_basket_weights  # noqa: E402
from repro_torch.core.types import (KIND_ADD_BASKET,  # noqa: E402
                                    KIND_DEL_BASKET)
from repro_torch.data import stream, synthetic  # noqa: E402
from repro_torch.kernels import (build, decayed_scatter,  # noqa: E402
                                 flash_attention, knn_topk, ops, ref,
                                 serving_topn, sparse_row_gather,
                                 sparse_row_scatter)
from repro_torch.models import (bert4rec, deepfm, dimenet,  # noqa: E402
                                dlrm, transformer, two_tower)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train as train_lm  # noqa: E402
from repro_torch.launch.mesh import make_user_shard_devices  # noqa: E402
from repro_torch.optim import optimizers  # noqa: E402
from repro_torch.optim.compression import (  # noqa: E402
    dequantize_int8_rows, quantize_int8_rows, quantize_int8_rows_pitched)
from repro_torch.parallel.sharding import UserShardSpec  # noqa: E402
from repro_torch.streaming import (AsyncCheckpointer, Event,  # noqa: E402
                                   ShardedStreamingEngine, StateStore,
                                   StoreConfig, StreamingEngine, faults,
                                   load_checkpoint_arrays)

# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, int8
# in the tensor cores, HBM3
PEAK_FP32 = 67e12
PEAK_INT8 = 1979e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12
Q, TOPN, ALPHA = 256, 10, 0.7
BD = 512                         # the int8 serving path's D tile
REPS = 5
# the million-item point of benchmarks/bench_serving.py::ScaleConfig
BIG_M, BIG_Q, BIG_I, BIG_K, BIG_BD = 256, 32, 1 << 20, 16, 1024
# granite-3-2b serving: 4 prompts of TRAIN_4K's length, 16 greedy steps
LM_BATCH, LM_PROMPT, LM_DECODE = 4, 4096, 16
# kernels vs plain: max |logit difference| / max |logit| may be at most
# this many times the plain bf16 run's own error against an f32 run of
# the same weights through the plain versions (a first fixed bound of
# 2e-2 failed at 2.45e-2 on rounding alone: both bf16 runs err against
# f32 by more than that)
LM_LOGIT_BOUND = 2.0
# the largest k of each (queries per block, stages) of knn_topk.plan_knn
KNN_PLAN_EDGES = (456,)
# B2's table past 2^31 cells (9.0 GB of f32): its top 4,096 rows start
# at cell 2,244,411,392
SCATTER_BIG = (1_100_000, 2_048)
# the durability and sharded-engine phases' commits (build/ is not in
# git)
CKPT_DIR = ROOT / "build" / "chip_smoke_ckpt"
SHARD_CKPT_DIR = ROOT / "build" / "chip_smoke_shard_ckpt"
COMPLIANCE_DIR = ROOT / "build" / "chip_smoke_compliance_ckpt"
# the compliance phase: users forgotten, and the query chunk of the
# plain route (its [Q, k, I] neighbour gather is 3.7 GB at 256)
N_FORGET, PLAIN_CHUNK = 64, 256
# recommender serving: the Criteo-1TB tables are 89.5 GiB of fp32, so
# each vocabulary is capped at 2^24 rows (5 of the 26 tables; 45 GB
# left); the retrieval_cand top n and BERT4Rec's serving top n
DLRM_VOCAB_CAP = 1 << 24
RETRIEVAL_TOP_N, BERT_TOP_N = 100, 20
# B3 at the recommender shapes: values within this of the plain version
RS_RTOL, RS_ATOL = 1e-5, 1e-6
# training: DLRM's vocabularies capped at 2^22 rows (table, gradient, m
# and v: 4 x 12.8 GB), two-tower's and BERT4Rec's batches cut from
# 65,536 (the [B, B] logits; the saved attention probabilities); the
# smoke models' 3 steps, card against CPU, within these
TRAIN_DLRM_CAP = 1 << 22
TRAIN_TWO_TOWER, TRAIN_BERT4REC = 32_768, 8_192
TRAIN_RTOL, TRAIN_ATOL = 1e-5, 1e-5
# ... at this lr: Adam moves a parameter whose gradient is ~0 by up to
# lr_t a step, whichever sign that gradient takes, so 3 lr_t <= atol
TRAIN_LR = 3e-6
assert 3 * TRAIN_LR <= TRAIN_ATOL
# the reference's 6-block DimeNet overflows on random molecules at init:
# the step-1 gradient norm is inf and the clip zeroes every gradient
NO_UPDATE_AT_INIT = {"DimeNet molecule"}
# (rows, ids) dtypes the sparse pair reads as given
INDEX_PAIRS = ((torch.int32, torch.int32), (torch.int64, torch.int32),
               (torch.int32, torch.int64), (torch.int64, torch.int64))

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
    "knn_topk_dtiled": dict(
        source="src/repro_torch/kernels/csrc/knn_topk_dtiled.cu",
        replaces="src/repro/kernels/knn_topk.py:265"),
    # B5's fp32 design (dtiled_ring_kernel): the same wrapper, which
    # counts its launches under this name
    "knn_topk_dtiled_f32": dict(
        source="src/repro_torch/kernels/csrc/knn_topk_dtiled.cu",
        replaces="src/repro/kernels/knn_topk.py:265"),
    "blend_topn_rows_quant": dict(
        source="src/repro_torch/kernels/csrc/serving_rows.cu",
        replaces="src/repro/kernels/serving_topn.py:264"),
    "blend_topn_rows": dict(
        source="src/repro_torch/kernels/csrc/serving_rows.cu",
        replaces="src/repro/kernels/serving_topn.py:192"),
    "decayed_scatter": dict(
        source="src/repro_torch/kernels/csrc/decayed_scatter.cu",
        replaces="src/repro/kernels/decayed_scatter.py:54"),
    "flash_attention": dict(
        source="src/repro_torch/kernels/csrc/flash_attention_wgmma.cu",
        replaces="src/repro/kernels/flash_attention.py:73"),
    # 9b: the gradient the JAX package takes by autodiff of its
    # model-level blocked attention
    "flash_attention_bwd": dict(
        source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        replaces="src/repro/models/transformer.py:378"),
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


def bound(n_bytes: float, n_ops: float, peak: float = PEAK_FP32) -> tuple:
    t_bytes, t_ops = n_bytes / PEAK_BYTES, n_ops / peak
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


def padded_inputs(gen, m, n_items, u, w, n_pad, dev):
    """:func:`sparse_inputs` in the appliers' shape: ``u - n_pad``
    distinct users, then ``n_pad`` padding rows of user 0 with PAD ids
    and zero deltas."""
    _, ids, vals = sparse_inputs(gen, m, n_items, u, w, dev)
    rows = torch.randperm(m, generator=gen, device=dev)[:u].to(torch.int32)
    rows[u - n_pad:] = 0
    ids[u - n_pad:] = -1
    vals[u - n_pad:] = 0.0
    return rows, ids, vals


def three_readings(fn, names, reps: int = 5, per_call: int = 1) -> dict:
    """A call's time three ways, and its host time: one call between two
    events (``ms``, holding the wrapper's host time on an idle card), a
    burst of 100 back to back between two events, per call
    (``burst_ms``), the profiler's device time of ``names`` per call
    (``device_ms``; the call launches ``per_call`` of them, and the
    trace held ``records`` of them), and the host clock around the
    burst's calls, per call, with no sync (``host_ms``)."""
    out = dict(ms=time_ms(fn))
    own, _, n_rec = device_ms(fn, names, reps)
    out["records"] = n_rec
    # per call by the launches the trace recorded (a trace can miss one);
    # every kernel of a call ("") per call
    out["device_ms"] = own if names == ("",) else \
        own * reps * per_call / n_rec
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    h0 = time.perf_counter()
    for _ in range(100):
        fn()
    out["host_ms"] = (time.perf_counter() - h0) * 10
    end.record()
    end.synchronize()
    out["burst_ms"] = start.elapsed_time(end) / 100
    return out


def readings_str(r) -> str:
    return (f"{r['ms']:.4f} ms one call, {r['burst_ms']:.4f} a call in a "
            f"burst of 100, {r['device_ms']:.4f} device, {r['host_ms']:.4f}"
            f" host")


def check_sparse(gen, table, u, w_add, w_del, records):
    m, n_items = table.shape
    dev = table.device
    for label, w in (("add", w_add), ("delete", w_del)):
        rows, ids, vals = sparse_inputs(gen, m, n_items, u, w, dev)
        # the appliers' dtypes: int64 rows (batch.user.long()), int32 ids;
        # every other pair of index dtypes reads the same
        got = sparse_row_gather.launch(table, rows.long(), ids)
        exp = ref.sparse_row_gather_ref(table, rows, ids)
        torch.cuda.synchronize()
        g_err = float((got - exp).abs().max())
        assert torch.equal(got, exp), f"gather ({label}) differs: {g_err}"
        for r_dt, i_dt in INDEX_PAIRS:
            assert torch.equal(sparse_row_gather.launch(
                table, rows.to(r_dt), ids.to(i_dt)), exp), (r_dt, i_dt)

        # B2 at the appliers' dtypes (int64 rows, the ids' own int32),
        # bitwise the sum in entry order at every pair of index dtypes
        rows64 = rows.long()
        t_k, t_p, t_o = table.clone(), table.clone(), table.clone()
        sparse_row_scatter.launch(t_k, rows64, ids, vals)
        ref.sparse_row_scatter_ref(t_p, rows, ids, vals)
        ref.sparse_row_scatter_ordered_ref(t_o, rows, ids, vals)
        t_again = table.clone()
        sparse_row_scatter.launch(t_again, rows64, ids, vals)
        torch.cuda.synchronize()
        s_err = float((t_k - t_p).abs().max())
        # index_put_ sums a cell's deltas in another order
        assert torch.allclose(t_k, t_p, rtol=1e-6, atol=1e-6), s_err
        assert same(t_k, t_o), "scatter differs from the ordered sum"
        assert same(t_k, t_again), "scatter reruns differ"
        del t_p, t_again
        for r_dt, i_dt in INDEX_PAIRS:
            t_x = table.clone()
            sparse_row_scatter.launch(t_x, rows.to(r_dt), ids.to(i_dt), vals)
            assert same(t_x, t_o), (r_dt, i_dt)
        del t_k, t_o, t_x
        ti, tpi = table.round(), table.round()      # integer-valued: exact
        sparse_row_scatter.launch(ti, rows64, ids, vals.round())
        ref.sparse_row_scatter_ref(tpi, rows, ids, vals.round())
        torch.cuda.synchronize()
        assert torch.equal(ti, tpi), "integer scatter differs"
        del ti, tpi

        valid = ids >= 0
        cells = rows.long()[:, None] * n_items + ids.long()
        n_valid = int(valid.sum())
        n_cells = int(torch.unique(cells[valid]).numel())
        safe_ids = torch.where(valid, ids, torch.zeros_like(ids)).long()
        safe_vals = torch.where(valid, vals, torch.zeros_like(vals))
        rows2d = rows64[:, None].expand(u, w)
        t_bench = table.clone()
        gather = three_readings(lambda: sparse_row_gather.launch(
            table, rows64, ids), ("sparse_row_gather_kernel",))
        indexing = three_readings(lambda: table[rows2d, safe_ids], ("",))

        def scatter_call():
            sparse_row_scatter.launch(t_bench, rows64, ids, vals)

        scatter = three_readings(scatter_call, ("sparse_row_scatter_kernel",))
        own, every, _ = device_ms(scatter_call, ("sparse_row_scatter_kernel",))
        assert own == every, f"a scatter call launched more ({every} ms)"
        put = three_readings(lambda: t_bench.index_put_(
            (rows2d, safe_ids), safe_vals, accumulate=True), ("",))
        timings = dict(
            gather_plain=time_ms(lambda: ref.sparse_row_gather_ref(
                table, rows64, ids)),
            scatter_plain=time_ms(lambda: ref.sparse_row_scatter_ref(
                t_bench, rows64, ids, vals)))
        del t_bench
        log(f"  sparse pair, {label} path U={u} W={w} "
            f"({n_valid} valid ids, {n_cells} distinct cells), int64 rows "
            f"and int32 ids: gather {readings_str(gather)} (indexing "
            f"{readings_str(indexing)}; plain "
            f"{timings['gather_plain']:.4f}); scatter "
            f"{readings_str(scatter)} (index_put_ {readings_str(put)}; "
            f"plain {timings['scatter_plain']:.4f}); max |err| gather "
            f"{g_err} scatter {s_err}")
        if label == "add":       # the add path launches most: it is timed
            records["sparse_row_gather"] = dict(
                max_abs_err=g_err, ms=gather["ms"],
                plain_ms=timings["gather_plain"],
                library_ms=indexing["ms"],
                shape=f"U={u} W={w} int64 rows, int32 ids",
                bound=bound(u * 8 + u * w * 4 + n_valid * 4 + u * w * 4,
                            0))
            records["sparse_row_scatter"] = dict(
                max_abs_err=s_err, ms=scatter["ms"],
                plain_ms=timings["scatter_plain"],
                library_ms=put["ms"],
                shape=f"U={u} W={w} int64 rows, int32 ids",
                bound=bound(u * 8 + 2 * u * w * 4 + n_cells * 8, n_valid))
    # the appliers' shape (distinct users, then the padding rows of a
    # pow2 bucket: user 0, PAD ids, zero deltas), and a sub-batch 8x the
    # engine's (every block scans all U rows)
    for what, (rows, ids, vals) in (
            ("300 users and 212 padding rows", padded_inputs(
                gen, m, n_items, u, w_add, 212, dev)),
            ("U=4096", sparse_inputs(gen, m, n_items, 4096, w_add, dev))):
        rows64 = rows.long()
        t_k, t_o = table.clone(), table.clone()
        sparse_row_scatter.launch(t_k, rows64, ids, vals)
        ref.sparse_row_scatter_ordered_ref(t_o, rows, ids, vals)
        torch.cuda.synchronize()
        assert same(t_k, t_o), f"scatter ({what}) differs"
        r = three_readings(lambda: sparse_row_scatter.launch(
            t_k, rows64, ids, vals), ("sparse_row_scatter_kernel",))
        valid = ids >= 0
        safe_ids = torch.where(valid, ids, torch.zeros_like(ids)).long()
        safe_vals = torch.where(valid, vals, torch.zeros_like(vals))
        put = three_readings(lambda: t_k.index_put_(
            (rows64[:, None].expand_as(ids), safe_ids), safe_vals,
            accumulate=True), ("",))
        log(f"  scatter, {what}, W={w_add}: {readings_str(r)} (index_put_ "
            f"{readings_str(put)})")
        del t_k, t_o


def scatter_case(what, table, rows, ids, vals):
    """B2 at every pair of index dtypes, bitwise the ordered sum."""
    exp = ref.sparse_row_scatter_ordered_ref(table.clone(), rows, ids, vals)
    for r_dt, i_dt in INDEX_PAIRS:
        got = sparse_row_scatter.launch(table.clone(), rows.to(r_dt),
                                        ids.to(i_dt), vals)
        assert same(got, exp), (what, r_dt, i_dt)


def check_scatter_edges(gen, n_items, w_add, dev):
    """B2's edge cases, bitwise the sum in entry order: every entry row
    one table row (its head block stages every entry of the run), with
    every id valid, with 40% PAD, and with I=1 (one cell); U=1, W=1,
    I=1, and a table whose M*I exceeds 2^31 (its touched rows held
    against the ordered sum on a copy of them, every other row left
    zero).  The one-row runs are longer than a staged chunk: they must
    flush it both at a tile's start and inside a tile
    (``sparse_row_scatter.chunk_flushes``)."""
    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def ids_in(items, u, w):
        return torch.randint(0, items, (u, w), generator=gen, device=dev)

    table = rand(16, n_items)
    slabs = set()
    for what, items, pad in (("one run", n_items, 0.0),
                             ("one run, 40% PAD", n_items, 0.4),
                             ("one run, I=1", 1, 0.0)):
        ids = ids_in(items, 64, w_add)
        ids[torch.rand((64, w_add), generator=gen, device=dev) < pad] = -1
        flushes = sparse_row_scatter.chunk_flushes(range(64), ids >= 0)
        assert flushes, f"{what}: no chunk flushed before the run's end"
        slabs |= {slab > 0 for _, _, slab in flushes}
        scatter_case(what, table if items > 1 else rand(16, 1),
                     torch.full((64,), 5, device=dev), ids, rand(64, w_add))
    assert slabs == {False, True}, "a chunk flush place is not reached"
    ids = ids_in(n_items, 1, w_add)
    ids[:, 1] = ids[:, 0]
    ids[:, ::4] = -1
    scatter_case("U=1", table, torch.tensor([3], device=dev), ids,
                 rand(1, w_add))
    ids = ids_in(n_items, 512, 1)
    ids[::3] = -1
    scatter_case("W=1", table, torch.randint(0, 16, (512,), generator=gen,
                                             device=dev), ids, rand(512, 1))
    scatter_case("I=1", rand(8, 1), torch.randint(
        -2, 10, (32,), generator=gen, device=dev), ids_in(1, 32, 9),
        rand(32, 9))
    m, items = SCATTER_BIG
    rows = torch.randint(m - 4096, m, (512,), generator=gen, device=dev)
    rows[256:288] = rows[0]
    ids = ids_in(items, 512, w_add)
    ids[torch.rand((512, w_add), generator=gen, device=dev) < 0.4] = -1
    vals = rand(512, w_add)
    big = torch.zeros((m, items), device=dev)
    touched = torch.unique(rows)
    big[touched] = rand(touched.numel(), items)
    exp = ref.sparse_row_scatter_ordered_ref(
        big[touched], torch.searchsorted(touched, rows), ids, vals)
    sparse_row_scatter.launch(big, rows, ids, vals)
    assert same(big[touched], exp), "scatter past 2^31 cells differs"
    assert int(torch.count_nonzero(big)) == int(
        torch.count_nonzero(big[touched])), "scatter wrote an untouched row"
    del big
    torch.cuda.empty_cache()
    log(f"  scatter edges: one row's run of 64 x {w_add} entries (all "
        f"valid, 40% PAD, I=1; chunks flushed at a tile's start and "
        f"inside a tile), U=1, W=1, I=1, M*I = {m * items:,} > 2^31: "
        f"bitwise the ordered sum at every pair of index dtypes")


def int_corpus(gen, m, d, dev):
    """Small-integer corpus with duplicate rows and columns: exact fp32
    scores, with true ties."""
    c = torch.randint(0, 3, (m, d), generator=gen, device=dev).float()
    c[1::4] = c[0]
    if d > 1:
        c[:, 1] = c[:, 0]
    return c


def plain_scores(q, c, uid):
    s = 2.0 * (q @ c.T) - ref.corpus_sqnorm(c)[None, :]
    s[torch.arange(q.shape[0], device=q.device), uid.long()] = \
        float("-inf")
    return s


def check_stage_a_edges(gen, dev):
    """Stage A on small integer corpora, ids and values exact against the
    plain version: a corpus cut into several slices with a partial last
    tile and a D that is no multiple of the kernel's chunk, up to k = M
    (the self column's −inf in the last slot); then k at each change of
    ``knn_topk.plan_knn``'s (queries per block, ring stages) and one
    either side, up to k = 1024, with Q of 1, 31 and 33 (partial query
    tiles) and D of 1, 31, 33 and 211 (tails of a 32-value chunk); and
    slices of several score tiles with a partial last tile and a partial
    last slice, whose last fold into the lists (two tiles at a time) has
    one tile at one k and two at another, euclidean, ``metric="dot"``
    and ``sub_qnorm`` with a shard's gid mapping.  Asserts that the cases
    reach every plan."""
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
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    shapes = set()

    def exact(q, c, k, **kw):
        vk, ik = knn_topk.launch(q, c, k, **kw)
        vp, ip = ref.knn_topk_ref(q, c, k, **kw)
        torch.cuda.synchronize()
        assert torch.equal(ik, ip) and torch.equal(vk, vp), \
            f"stage A Q={q.shape[0]} M={c.shape[0]} D={c.shape[1]} k={k} " \
            f"{sorted(kw)}"
        pl = knn_topk.plan_knn(q.shape[0], c.shape[0], k, n_sms)
        shapes.add((pl.bq, pl.stages))

    ks = sorted({1, 1024} | {b + e for b in KNN_PLAN_EDGES
                             for e in (-1, 0, 1)})
    m = 1500
    for d in (1, 31, 33, 211):
        c = int_corpus(gen, m, d, dev)
        for q_n in (1, 31, 33):
            uid = torch.randperm(m, generator=gen,
                                 device=dev)[:q_n].to(torch.int32)
            for k in ks:
                exact(c[uid.long()], c, k, query_gids=uid)
    log(f"  stage A M={m}, D in (1, 31, 33, 211), Q in (1, 31, 33), k in "
        f"{ks}: exact")
    m, d, q_n = 33800, 211, 33
    c = int_corpus(gen, m, d, dev)
    uid = torch.randperm(m, generator=gen, device=dev)[:q_n].to(torch.int32)
    q = c[uid.long()]
    shard = dict(query_gids=uid * 3 + 2, col_offset=2, col_stride=3,
                 sub_qnorm=True)
    for k in (1, 300, 457, 1024):
        for kw in (dict(query_gids=uid), dict(metric="dot"), shard):
            exact(q, c, k, **kw)
    plans = [knn_topk.plan_knn(q_n, m, k, n_sms) for k in (300, 1024)]
    tile = knn_topk.KNN_ROW_TILE
    assert all(pl.rows > 2 * tile and pl.rows % tile and m % pl.rows
               for pl in plans), plans
    # the last fold of a slice: one tile at k=300, two at k=1024
    assert [pl.rows % (2 * tile) > tile for pl in plans] == [False, True]
    log(f"  stage A M={m} D={d} Q={q_n} ({plans[0].n_slices} slices of "
        f"{plans[0].rows} rows at k=300, {plans[1].n_slices} of "
        f"{plans[1].rows} at k=1024), k in (1, 300, 457, 1024), "
        f"euclidean, dot and shard mode: exact")
    log(f"  (queries per block, stages) reached: {sorted(shapes)}")
    assert shapes == set(knn_topk.KNN_SHAPES), shapes


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
    # sub_qnorm, as the per-shard candidates run it (shard 1 of 2's ids)
    gids = uid * 2 + 1
    kw = dict(query_gids=gids, col_offset=1, col_stride=2, sub_qnorm=True)
    vk, ik = knn_topk.launch(q, corpus, 300, **kw)
    vp, _ = ref.knn_topk_ref(q, corpus, 300, **kw)
    # column uid is the one whose gid uid*2+1 the query carries
    s = plain_scores(q, corpus, uid) - ref.corpus_sqnorm(q)[:, None]
    torch.cuda.synchronize()
    err = float((vk - vp).abs().max())
    assert torch.allclose(vk, vp, rtol=1e-5, atol=1e-3), err
    assert torch.allclose(s.gather(1, ik.long()), vp, rtol=1e-5,
                          atol=1e-3), "stage A sub_qnorm ids"
    vki, iki = knn_topk.launch(q_int, c_int, 300, **kw)
    vpi, ipi = ref.knn_topk_ref(q_int, c_int, 300, **kw)
    torch.cuda.synchronize()
    assert torch.equal(iki, ipi) and torch.equal(vki, vpi), \
        "stage A sub_qnorm integer case"
    log(f"  stage A k=300 sub_qnorm (shard 1 of 2): max |err| {err}, "
        f"integer ties exact")
    rec = records["knn_topk"]
    rec["sub_qnorm_ms"] = time_ms(lambda: knn_topk.launch(q, corpus, 300,
                                                          **kw))
    rec.update(b3_timed(q, corpus, 300, "stage A", query_gids=uid))
    log(f"  stage A with sub_qnorm {rec['sub_qnorm_ms']:.4f} ms")


def b3_timed(q, c, k, what, metric="euclidean", query_gids=None) -> dict:
    """B3 at one shape: CUDA events around the launch, its plain version
    and matmul + ``torch.topk``; the profiler's device time per call
    (each call launches the tile and the merge kernel, so a trace that
    dropped records is scaled by the records it holds); the bound and
    the plan.  Logged, and returned as the summary's record."""
    q_n, d = q.shape
    m = c.shape[0]
    kw = dict(metric=metric, query_gids=query_gids)

    def call():
        return knn_topk.launch(q, c, k, **kw)
    if metric == "dot":
        def library():
            return torch.topk(q @ c.T, k)
        n_ops = 2.0 * q_n * m * d                 # the q.c products
    else:
        cn = ref.corpus_sqnorm(c)

        def library():
            return torch.topk(2.0 * (q @ c.T) - cn[None, :], k)
        n_ops = 2.0 * q_n * m * d + 2.0 * m * d   # and the |c|^2 sums
    n_gids = 0 if query_gids is None else q_n
    r = dict(ms=time_ms(call),
             plain_ms=time_ms(lambda: ref.knn_topk_ref(q, c, k, **kw)),
             library_ms=time_ms(library),
             shape=f"Q={q_n} M={m} D={d} k={k} {metric}",
             # q, c and the query gids read once, [Q, k] values and ids
             # written
             bound=bound((q_n * d + m * d + n_gids) * 4 + q_n * k * 8,
                         n_ops))
    reps = 5
    own, every, n_rec = device_ms(call, ("knn_tile_kernel",
                                         "merge_lists_kernel"), reps)
    r["device_ms"] = own * 2 * reps / n_rec
    pl = knn_topk.plan_knn(q_n, m, k, torch.cuda.get_device_properties(
        q.device).multi_processor_count)
    log(f"  B3 {what} {r['shape']}: {r['ms']:.4f} ms (profiler "
        f"{r['device_ms']:.4f} a call in its kernels, by the {n_rec} of "
        f"{2 * reps} records the trace holds; {every:.4f} in all kernels "
        f"the trace holds), plain {r['plain_ms']:.4f}, matmul + topk "
        f"{r['library_ms']:.4f}, bound {r['bound'][0]:.4f} "
        f"({r['bound'][1]}); plan {pl.bq} queries x {pl.stages} stages, "
        f"{-(-q_n // pl.bq)} query tiles x {pl.n_slices} slices of "
        f"{pl.rows} rows")
    return r


def blend_case(corpus, uid, nbr, n, what, one_pass=False):
    """B4 on one input: bitwise ``ref.blend_topn_ordered_ref`` in the
    kernel's staging passes (and, where ``one_pass``, every group in one
    pass, bitwise the sum in order j = 0..k-1 with no passes), within
    rtol=1e-5, atol=1e-6 of ``ref.blend_topn_ref`` with score-equivalent
    ids.  Returns (max |err|, the plan, the most passes a group took)."""
    m, n_items = corpus.shape
    q_n, k = nbr.shape
    plan = serving_topn.plan_blend(q_n, m, n_items, k, n, torch.cuda.
                                   get_device_properties(corpus.device)
                                   .multi_processor_count)
    passes = ref.blend_passes(nbr, m, plan.group, plan.stage_rows)
    valid = (nbr >= 0) & (nbr < m)
    n_pass = int(passes[valid].max()) + 1 if bool(valid.any()) else 0
    vk, ik = serving_topn.launch(corpus, uid, nbr, ALPHA, n)
    vo, io = ref.blend_topn_ordered_ref(corpus, uid, nbr, ALPHA, n, passes)
    vp, _ = ref.blend_topn_ref(corpus, uid, nbr, ALPHA, n)
    torch.cuda.synchronize()
    assert same(vk, vo) and torch.equal(ik, io), \
        f"B4 ({what}) is not the ordered sum in its passes"
    if one_pass:
        assert n_pass <= 1, (what, n_pass)
        vj, ij = ref.blend_topn_ordered_ref(corpus, uid, nbr, ALPHA, n)
        assert same(vk, vj) and torch.equal(ik, ij), \
            f"B4 ({what}) is not the sum in order j = 0..k-1"
    err = float((vk - vp).abs().max())
    assert torch.allclose(vk, vp, rtol=1e-5, atol=1e-6), (what, err)
    uvalid = ((uid >= 0) & (uid < m))[:, None]
    own = torch.where(uvalid, corpus[uid.long().clamp(0, m - 1)],
                      torch.zeros((), device=corpus.device))
    rows = torch.where(valid[..., None], corpus[nbr.long().clamp(0, m - 1)],
                       torch.zeros((), device=corpus.device))
    pred = ALPHA * own + (1.0 - ALPHA) * rows.sum(1) / k
    assert torch.allclose(pred.gather(1, ik.long()), vp, rtol=1e-5,
                          atol=1e-6), f"B4 ({what}) ids not equivalent"
    return err, plan, n_pass


def check_blend_edges(gen, corpus, uid, nbr):
    """B4's edge cases on the kernel checks' corpus: a group that
    overflows one pass (random neighbours), every group in one pass
    (neighbours drawn from 400 rows), n = 33 and n = 1,024 (the lists
    in shared memory), k = 1, all-PAD rows and entries >= M, user ids
    outside [0, M), int64 indices, Q not a multiple of the group, M = 1
    and I = 31."""
    m = corpus.shape[0]
    dev = corpus.device
    rnd = torch.randint(0, m, (40, 300), generator=gen, device=dev,
                        dtype=torch.int32)
    err, plan, n_pass = blend_case(corpus, uid[:40], rnd, TOPN,
                                   "random neighbours")
    assert n_pass > 1, n_pass
    log(f"  stage B overflow: Q=40 k=300 random neighbours, {n_pass} "
        f"passes of {plan.stage_rows} rows, max |err| {err}")
    pool = torch.randperm(m, generator=gen, device=dev)[:400]
    few = pool[torch.randint(0, 400, (64, 300), generator=gen, device=dev)]
    blend_case(corpus, uid[:64], few.to(torch.int32), TOPN, "400 rows",
               one_pass=True)
    for n in (33, 1024):
        _, plan, n_pass = blend_case(corpus, uid, nbr, n, f"n={n}")
        log(f"  stage B n={n}: groups of {plan.group}, {n_pass} passes of "
            f"{plan.stage_rows} rows")
    blend_case(corpus, uid, nbr[:, :1].contiguous(), TOPN, "k=1")
    pad = nbr.clone()
    pad[3] = -1
    pad[5, ::2] = m + 7
    bad = uid.clone()
    bad[2], bad[7] = -4, m
    blend_case(corpus, bad, pad, TOPN, "PAD rows, ids >= M, users out")
    blend_case(corpus, uid[:37].long(), nbr[:37].long(), TOPN,
               "int64, Q=37")
    blend_case(corpus[:1].contiguous(), torch.zeros(5, dtype=torch.int32,
               device=dev), torch.zeros((5, 3), dtype=torch.int32,
                                        device=dev), TOPN, "M=1")
    thin = corpus[:, :31].contiguous()
    for n in (TOPN, 31):
        blend_case(thin, uid[:37], nbr[:37], n, f"I=31 n={n}")
    log("  stage B edges: random neighbours (overflow), 400 rows (one pass), "
        "n=33, n=1,024, k=1, PAD rows and ids >= M, users out of range, "
        "int64 Q=37, M=1, I=31: each bitwise the ordered sum in its "
        "passes")


def check_stage_b(corpus, c_int, uid, records):
    m, n_items = corpus.shape
    nbr, nbr_int = records["knn_topk"].pop("nbr"), \
        records["knn_topk"].pop("nbr_int")
    k = nbr.shape[1]
    err, plan, n_pass = blend_case(corpus, uid, nbr, TOPN, "kernel checks")
    distinct = [int(torch.unique(nbr[g0:g0 + plan.group]).numel())
                for g0 in range(0, Q, plan.group)]
    vki, iki = serving_topn.launch(c_int, uid, nbr_int, ALPHA, TOPN)
    vpi, ipi = ref.blend_topn_ref(c_int, uid, nbr_int, ALPHA, TOPN)
    torch.cuda.synchronize()
    assert torch.equal(iki, ipi), "stage B tie-break differs"
    assert torch.allclose(vki, vpi, rtol=1e-6), "stage B integer values"
    log(f"  stage B k={k} n={TOPN}: max |err| {err}, bitwise the ordered "
        f"sum in {n_pass} passes, integer ties exact; plan: groups of "
        f"{plan.group} queries, tiles of {serving_topn.BLEND_TILE} items, "
        f"{plan.groups} groups x {plan.strips} strips of "
        f"{plan.tiles_per_strip} tiles = {plan.groups * plan.strips} "
        f"blocks, {plan.smem_bytes} bytes of shared memory ({plan.stage_rows}"
        f" rows a pass), plan kernel {plan.plan_smem_bytes}; distinct rows "
        f"a group {min(distinct)}-{max(distinct)}, the largest in {n_pass} "
        f"passes")
    check_blend_edges(torch.Generator(device=corpus.device).manual_seed(4),
                      corpus, uid, nbr)
    used = torch.unique(torch.cat([nbr.reshape(-1), uid]).long())
    # the distinct rows read once and ids in, [Q, n] out; Q·(k+1)·I fp32
    # adds (an add takes an FMA's slot, which the peak counts as two
    # operations)
    n_bytes = used.numel() * n_items * 4 + Q * (k + 1) * 4 + Q * TOPN * 8
    n_ops = 2.0 * Q * (k + 1) * n_items
    u, nb = uid.long(), nbr.long()
    b4 = three_readings(lambda: serving_topn.launch(corpus, uid, nbr, ALPHA,
                                                    TOPN),
                        ("blend_", "merge_"), per_call=3)
    lib = three_readings(lambda: torch.topk(
        ALPHA * corpus[u] + (1.0 - ALPHA) * corpus[nb].mean(1), TOPN),
        ("",))
    records["blend_topn_onehot"] = dict(
        max_abs_err=err, ms=b4["ms"], readings=b4, library=lib,
        plain_ms=time_ms(lambda: ref.blend_topn_ref(corpus, uid, nbr,
                                                    ALPHA, TOPN)),
        library_ms=lib["ms"],
        shape=f"Q={Q} M={m} I={n_items} k={k} n={TOPN}",
        bound=bound(n_bytes, n_ops))
    rec = records["blend_topn_onehot"]
    log(f"  stage B bound: {used.numel()} distinct rows used, bytes "
        f"{n_bytes / PEAK_BYTES * 1e3:.4f} ms, operations "
        f"{n_ops / PEAK_FP32 * 1e3:.4f} ms")
    log(f"  stage B timed: {readings_str(b4)} (plain {rec['plain_ms']:.4f};"
        f" gather + mean + topk {readings_str(lib)})")


def same(a, b) -> bool:
    """Bitwise equality of two tensors (values and ids of stage A)."""
    return a.dtype == b.dtype and torch.equal(a.contiguous().view(
        torch.int32), b.contiguous().view(torch.int32))


def device_ms(fn, names, reps: int = 5, required: bool = True):
    """Device time per call of ``fn`` under ``torch.profiler`` after a
    warm-up: (the kernels whose names contain one of ``names``, every
    kernel the call launched, how many records of the named kernels the
    trace holds -- a trace can miss one, and then these times read
    short; one that holds none of them is logged with the kernels it did
    hold and taken again, up to 6 times).  After 6 traces with no record
    it raises, or returns ``None`` where not ``required`` (a reading
    beside CUDA-event times: the profiler in this sandbox has recorded no
    kernel at all for whole stretches of a run, PERF.md §7)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    own = 0.0
    for _ in range(6):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        own = every = 0.0
        records = 0
        seen = []
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:   # kernels, not ops
                continue
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
            every += us
            seen.append(f"{e.key[:40]} x{e.count}")
            if any(n in e.key for n in names):
                own += us
                records += e.count
        if own > 0:
            break
        log(f"  profiler: no record of {names} in a trace of {len(seen)} "
            f"kernels {seen[:4]}; taken again")
    if own == 0 and not required:
        log(f"  profiler: no record of {names} in 6 traces; the CUDA-event "
            f"readings stand alone")
        return None
    assert own > 0, f"no device time for {names}"
    return own / reps / 1e3, every / reps / 1e3, records


def plan_str(q, c, k, bd) -> str:
    """The D-tiled stage A's plan for one input, for the log."""
    pl = knn_topk.plan_for(q, c, k, bd)
    return (f"{pl.design}: {pl.blocks} blocks = {pl.q_tiles} query tiles "
            f"of {pl.bq} x {pl.n_slices} slices of {pl.rows} rows x "
            f"{pl.n_splits} D splits of {pl.n_tiles} tiles"
            + (f", second pass {pl.fin_slices} slices of {pl.fin_rows} "
               f"rows, {pl.scratch_bytes} bytes of partials"
               if pl.n_splits > 1 else ""))


def dtiled_pair(q, c, k, bd, **kw):
    """Kernel and plain version of the D-tiled stage A on one input."""
    got = knn_topk.launch_dtiled(q, c, k, bd=bd, **kw)
    exp = ref.dtiled_topk_ref(q, c, k, bd=bd, **kw)
    torch.cuda.synchronize()
    return got, exp


def int_mm_topk(q8, c8_t, qs, cs, cn, k):
    """The int8 yardstick: cuBLAS int8 product (torch._int_mm, operands
    padded to its multiples of 8 beforehand) and torch.topk."""
    acc = torch._int_mm(q8, c8_t)[:, :cs.shape[0]].to(torch.float32)
    return torch.topk(2.0 * (qs[:, None] * cs[None, :]) * acc
                      - (cs * cs * cn)[None, :], k)


def pad8(x):
    """Zero-pad both dims of a 2-D tensor to multiples of 8."""
    return torch.nn.functional.pad(x, (0, -x.shape[1] % 8,
                                       0, -x.shape[0] % 8))


def check_dtiled_edges(gen, dev):
    """D-tiled stage A on a small integer corpus with duplicate rows, in
    both modes, over D tiles that do and do not divide D, up to k = M
    (the self column's -inf in the last slot): values and ids exact."""
    m, d, q_n = 1000, 211, 13
    c = int_corpus(gen, m, d, dev)
    cq, cs = quantize_int8_rows(c)
    uid = torch.randperm(m, generator=gen, device=dev)[:q_n].to(torch.int32)
    u = uid.long()
    plans = set()
    for bd in (16, 67, 512, 1024):
        for k in (1, 7, 300, m - 1, m):
            (vk, ik), (vp, ip) = dtiled_pair(cq[u], cq, k, bd, query_gids=uid,
                                             q_scale=cs[u], c_scale=cs)
            assert same(vk, vp) and same(ik, ip), f"int8 bd={bd} k={k}"
            (vk, ik), (vp, ip) = dtiled_pair(c[u], c, k, bd, query_gids=uid)
            assert same(vk, vp) and same(ik, ip), f"fp32 bd={bd} k={k}"
            for x in (cq, c):
                pl = knn_topk.plan_for(x[u], x, k, bd)
                plans.add((pl.design, pl.bq, pl.n_splits > 1))
        # the shard candidates' mode: gid mapping and sub_qnorm
        kw = dict(query_gids=uid * 3 + 2, col_offset=2, col_stride=3,
                  sub_qnorm=True)
        (vk, ik), (vp, ip) = dtiled_pair(cq[u], cq, 300, bd, q_scale=cs[u],
                                         c_scale=cs, **kw)
        assert same(vk, vp) and same(ik, ip), f"int8 shard mode bd={bd}"
        (vk, ik), (vp, ip) = dtiled_pair(c[u], c, 300, bd, **kw)
        assert same(vk, vp) and same(ik, ip), f"fp32 shard mode bd={bd}"
    log(f"  D-tiled stage A M={m} D={d} Q={q_n}, bd in (16, 67, 512, "
        f"1024), k in (1, 7, 300, M-1, M), int8 and fp32, and the shard "
        f"mode: identical")
    # each design unsplit and split: M=17,000 fills the SMs with slices
    # (M and every slice no multiple of a block's rows, D of bd; bd=48
    # ends each D tile on a half-zero k-step, 17 is no multiple of 16);
    # M=200 x D=65,536 is a small grid with a large D, split
    for m, d, bds, ks in ((17000, 2600, (16, 17, 48, 512, 1024),
                           (1, 7, 300, 1024)),
                          (200, 65536, (1024, 1000), (1, 7, 199, 200))):
        c = int_corpus(gen, m, d, dev)
        cq, cs = quantize_int8_rows(c)
        uid = torch.randperm(m, generator=gen,
                             device=dev)[:q_n].to(torch.int32)
        u = uid.long()
        shard = dict(query_gids=uid * 3 + 2, col_offset=2, col_stride=3,
                     sub_qnorm=True)
        for bd in bds:
            for k in ks:
                for kw in (dict(query_gids=uid), shard):
                    (vk, ik), (vp, ip) = dtiled_pair(
                        cq[u], cq, k, bd, q_scale=cs[u], c_scale=cs, **kw)
                    assert same(vk, vp) and same(ik, ip), \
                        f"int8 M={m} D={d} bd={bd} k={k} {sorted(kw)}"
                    (vk, ik), (vp, ip) = dtiled_pair(c[u], c, k, bd, **kw)
                    assert same(vk, vp) and same(ik, ip), \
                        f"fp32 M={m} D={d} bd={bd} k={k} {sorted(kw)}"
            for x in (cq, c):
                for k in (ks[0], ks[-1]):
                    pl = knn_topk.plan_for(x[u], x, k, bd)
                    plans.add((pl.design, pl.bq, pl.n_splits > 1))
        log(f"  D-tiled stage A M={m} D={d} Q={q_n}, bd in {bds}, k in "
            f"{ks}, int8 and fp32, plain and shard mode: identical")
    log(f"  (design, queries per block, split) reached: {sorted(plans)}")
    # every design unsplit and split; fp32 always on the ring, at both
    # query tiles split and unsplit; int8 odd bd on the CUDA cores
    assert {(d, sp) for d, _, sp in plans} == {
        (d, sp) for d in ("mma_s8", "cuda_cores", "ring_f32")
        for sp in (False, True)}, plans
    assert {b for d, b, _ in plans if d == "mma_s8"} == {16, 32}, plans
    assert {(b, sp) for d, b, sp in plans if d == "ring_f32"} == {
        (b, sp) for b in (16, 32) for sp in (False, True)}, plans


def check_dtiled(corpus, c_int, uid, records):
    """D-tiled stage A at TaFeng's size (Q=256, k=300, bd=512): int8
    identical to the plain version (and on the integer-tie corpus at
    k=300 and 900), fp32 allclose with exact ids on the integer corpus.
    The int8 corpus has the store's 16-byte row pitch; the integer-tie
    corpus is contiguous (padded into a copy per call).  Returns the
    int8 corpus, its scales and the int8 neighbours."""
    u = uid.long()
    cq, cs = quantize_int8_rows_pitched(corpus)
    cqi, csi = quantize_int8_rows(c_int)
    kq = dict(query_gids=uid, q_scale=cs[u], c_scale=cs)
    assert knn_topk.plan_for(cq[u], cq, 300, BD).design == "mma_s8"
    (vk, ik), (vp, ip) = dtiled_pair(cq[u], cq, 300, BD, **kq)
    assert same(vk, vp) and same(ik, ip), "int8 stage A at TaFeng differs"
    nbr = ip
    for k in (300, 900):
        (vk, ik), (vp, ip) = dtiled_pair(cqi[u], cqi, k, BD, query_gids=uid,
                                         q_scale=csi[u], c_scale=csi)
        assert same(vk, vp) and same(ik, ip), f"int8 ties k={k} differ"
    log("  D-tiled stage A int8 Q=256 k=300 bd=512: identical; integer-tie "
        "corpus k=300 and k=900: identical")
    pl = knn_topk.plan_for(corpus[u], corpus, 300, BD)
    assert (pl.design, pl.bq, pl.n_splits) == ("ring_f32", 32, 1), pl
    (vk, ik), (vp, ip) = dtiled_pair(corpus[u], corpus, 300, BD,
                                     query_gids=uid)
    s = plain_scores(corpus[u], corpus, uid)
    err = float((vk - vp).abs().max())
    assert torch.allclose(vk, vp, rtol=1e-5, atol=1e-5), err
    assert torch.allclose(s.gather(1, ik.long()), vp, rtol=1e-5,
                          atol=1e-5), "fp32 D-tiled ids not equivalent"
    (vk, ik), (vp, ip) = dtiled_pair(c_int[u], c_int, 300, BD,
                                     query_gids=uid)
    assert same(vk, vp) and same(ik, ip), "fp32 D-tiled integer case"
    log(f"  D-tiled stage A fp32 k=300: max |err| {err}, integer ties exact")

    m, d = corpus.shape
    cn_q = ref.tiled_sqnorm_ref(cq, BD)
    q8, c8_t = pad8(cq[u]), pad8(cq).t()
    cq_flat = cq.contiguous()
    fp_cn = ref.corpus_sqnorm(corpus)
    qf = corpus[u]
    timings = dict(
        ms=time_ms(lambda: knn_topk.launch_dtiled(cq[u], cq, 300, bd=BD,
                                                  **kq)),
        contiguous_ms=time_ms(lambda: knn_topk.launch_dtiled(
            cq[u], cq_flat, 300, bd=BD, **kq)),
        plain_ms=time_ms(lambda: ref.dtiled_topk_ref(cq[u], cq, 300, bd=BD,
                                                     **kq)),
        library_ms=time_ms(lambda: int_mm_topk(q8, c8_t, cs[u], cs, cn_q,
                                               300)))
    # fp32: one call by events, a burst, the profiler (the ring kernel
    # and the slice merge, 2 launches a call) and the host time
    f32 = three_readings(lambda: knn_topk.launch_dtiled(
        qf, corpus, 300, bd=BD, query_gids=uid),
        ("dtiled_ring_kernel", "merge_lists_kernel"), per_call=2)
    f32.update(
        plain_ms=time_ms(lambda: ref.dtiled_topk_ref(
            qf, corpus, 300, bd=BD, query_gids=uid)),
        library_ms=time_ms(lambda: torch.topk(
            2.0 * (qf @ corpus.T) - fp_cn[None, :], 300)))
    records["knn_topk_dtiled_f32"] = dict(
        max_abs_err=err, shape=f"fp32 Q={Q} M={m} D={d} k=300 bd={BD}",
        # queries, rows and ids read once, top-k out; the q.c products
        # and the |c|^2 sums, 2*Q*M*D + 2*M*D fp32 operations
        bound=bound((Q * d + m * d + Q) * 4 + Q * 300 * 8,
                    2.0 * Q * m * d + 2.0 * m * d), **f32)
    records["knn_topk_dtiled"] = dict(
        max_abs_err=0.0, shape=f"int8 Q={Q} M={m} D={d} k=300 bd={BD}",
        # int8 rows and queries read once, scales, norms, ids in, top-k
        # out; 2*Q*M*D int8 operations
        bound=bound(Q * d + m * d + (m + Q) * 12 + Q * 300 * 8,
                    2.0 * Q * m * d, PEAK_INT8), **timings)
    log(f"  D-tiled stage A plans: int8 {plan_str(cq[u], cq, 300, BD)}; "
        f"fp32 {plan_str(qf, corpus, 300, BD)}")
    log(f"  D-tiled stage A timed: int8 {timings['ms']:.4f} ms on the "
        f"16-byte row pitch ({timings['contiguous_ms']:.4f} ms on a "
        f"contiguous corpus, padded per call; plain "
        f"{timings['plain_ms']:.4f}, _int_mm + topk "
        f"{timings['library_ms']:.4f})")
    log("  D-tiled stage A fp32 timed: " + f32_str(
        records["knn_topk_dtiled_f32"], 2))
    return cq, cs, nbr


def f32_str(r, per_call) -> str:
    """B5's fp32 readings for the log: events, burst, profiler with its
    record count, host time; plain, library and bound."""
    return (f"{readings_str(r)} (profiler by the {r['records']} of "
            f"{per_call * REPS} records the trace holds; plain "
            f"{r['plain_ms']:.4f}, matmul + topk {r['library_ms']:.4f}, "
            f"bound {r['bound'][0]:.4f} ms {r['bound'][1]})")


def million_path(dev):
    """Phase 11, the million-item point: M=256 random rows, Q=32,
    I=1,048,576, k=16, bd=1024 (1.07 GB fp32, 268 MB int8).  The D-tiled
    stage A in both modes against its plain version (int8 identical,
    fp32 allclose with equivalent ids), then the int8 serving entry
    point against its plain pipeline.  Returns the timings and the
    entry point's launch counts."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    c = torch.rand((BIG_M, BIG_I), generator=gen, device=dev)
    cq, cs = quantize_int8_rows(c)
    uid = torch.randperm(BIG_M, generator=gen, device=dev)[:BIG_Q]
    uid = uid.to(torch.int32)
    u = uid.long()
    kq = dict(query_gids=uid, q_scale=cs[u], c_scale=cs)
    (vk, ik), (vp, ip) = dtiled_pair(cq[u], cq, BIG_K, BIG_BD, **kq)
    assert same(vk, vp) and same(ik, ip), "int8 million-item point differs"
    pl = knn_topk.plan_for(c[u], c, BIG_K, BIG_BD)
    # fp32 on the ring: one query tile reads the corpus once
    assert (pl.design, pl.q_tiles) == ("ring_f32", 1) and \
        pl.blocks >= 100, pl
    (vk, ik), (vp, ip) = dtiled_pair(c[u], c, BIG_K, BIG_BD, query_gids=uid)
    s = plain_scores(c[u], c, uid)
    err = float((vk - vp).abs().max())
    assert torch.allclose(vk, vp, rtol=1e-5, atol=1e-5), err
    assert torch.allclose(s.gather(1, ik.long()), vp, rtol=1e-5,
                          atol=1e-5), "fp32 million-item ids"
    log(f"million-item point M={BIG_M} Q={BIG_Q} I={BIG_I} k={BIG_K} "
        f"bd={BIG_BD}: D-tiled stage A int8 identical, fp32 max |err| {err}")

    def serve():
        return knn.recommend_for_users_quant(cq, cs, uid, k=BIG_K,
                                             alpha=ALPHA, topn=TOPN,
                                             bd=BIG_BD)
    build.reset_launch_counts()
    got = serve()
    torch.cuda.synchronize()
    launches = dict(build.launch_counts)
    log(f"  int8 serving at the million-item point: launches {launches}")
    for name in ("knn_topk_dtiled", "blend_topn_rows_quant"):
        assert launches[name] > 0, f"{name} was not launched on path 9"
    build.reset_launch_counts()
    with ops.default_impl("ref"):
        want = serve()
    torch.cuda.synchronize()
    assert not any(build.launch_counts.values()), build.launch_counts
    want, got = want.cpu().numpy(), got.cpu().numpy()
    hold(dequantize_int8_rows(cq, cs), uid.cpu().numpy(), want, got,
         SimpleNamespace(k_neighbors=BIG_K, alpha=ALPHA),
         "million-item int8 serving vs its plain pipeline")
    # On these rows many queries fall outside the exact class (neighbour
    # distances of 1M-wide random rows agree to 1e-5 relative, and the
    # dequantized predictions tie on a 1/64 grid), so the 90% gate of the
    # other paths cannot be met.  The stricter gate holds instead: both
    # pipelines read the same (q, scale), stage A is bitwise, and every
    # dequantized sum of k=16 rows is exact, so the ids are identical.
    same_ids = int(np.all(want == got, axis=1).sum())
    log(f"  identical ids for {same_ids} of {BIG_Q} queries")
    assert same_ids == BIG_Q, ("million-item int8 ids", same_ids, BIG_Q)

    out = {}
    q8, c8_t = pad8(cq[u]), pad8(cq).t()
    cn_q, cn = ref.tiled_sqnorm_ref(cq, BIG_BD), ref.corpus_sqnorm(c)
    for mode, args, kw, lib, peak, size in (
            ("int8", (cq[u], cq), kq,
             lambda: int_mm_topk(q8, c8_t, cs[u], cs, cn_q, BIG_K),
             PEAK_INT8, 1),
            ("fp32", (c[u], c), dict(query_gids=uid),
             lambda: torch.topk(2.0 * (c[u] @ c.T) - cn[None, :], BIG_K),
             PEAK_FP32, 4)):
        t = dict(
            ms=time_ms(lambda: knn_topk.launch_dtiled(
                *args, BIG_K, bd=BIG_BD, **kw), 3),
            plain_ms=time_ms(lambda: ref.dtiled_topk_ref(
                *args, BIG_K, bd=BIG_BD, **kw), 3),
            library_ms=time_ms(lib, 3))
        t["bound"] = bound((BIG_Q + BIG_M) * BIG_I * size
                           + (BIG_M + BIG_Q) * 12 + BIG_Q * BIG_K * 8,
                           2.0 * BIG_Q * BIG_M * BIG_I, peak)
        out[mode] = t
        pl = knn_topk.plan_for(*args, BIG_K, BIG_BD)
        assert pl.blocks >= 100, (mode, pl)
        log(f"  D-tiled stage A {mode} plan: "
            f"{plan_str(*args, BIG_K, BIG_BD)}")
        if mode == "fp32":
            # the split: the ring kernel, the second pass and the slice
            # merge, 3 launches a call
            t.update(three_readings(lambda: knn_topk.launch_dtiled(
                *args, BIG_K, bd=BIG_BD, **kw), ("dtiled_ring_kernel",
                                                 "dtiled_finish_kernel",
                                                 "merge_lists_kernel"),
                per_call=3))
            log(f"  D-tiled stage A fp32: {f32_str(t, 3)}")
            continue
        log(f"  D-tiled stage A {mode}: {t['ms']:.4f} ms (plain "
            f"{t['plain_ms']:.4f}, library {t['library_ms']:.4f}), bound "
            f"{t['bound'][0]:.4f} ms ({t['bound'][1]})")
    path_ms = time_ms(serve, 3)
    with ops.default_impl("ref"):
        path_plain_ms = time_ms(serve, 3)
    out["serving"] = dict(ms=path_ms, plain_ms=path_plain_ms)
    log(f"  recommend_for_users_quant: {path_ms:.4f} ms (plain pipeline "
        f"{path_plain_ms:.4f} ms)")
    return out, launches


def ordered_blend(x, rows, topn):
    """The row blend summed in order j = 0..k-1 by separate round-to-
    nearest torch ops, as the kernel sums: (values, items) of the top
    ``topn``, ties to the lower item."""
    acc = torch.zeros_like(x)
    for j in range(rows.shape[1]):
        acc = acc + rows[:, j]
    pred = ALPHA * x + (1.0 - ALPHA) * (acc / torch.full_like(
        acc, rows.shape[1]))
    v, i = torch.sort(pred, dim=1, descending=True, stable=True)
    return v[:, :topn], i[:, :topn].to(torch.int32)


def check_rows(corpus, c_int, cq, cs, uid, nbr, records):
    """Stage B over fetched rows at Q=256, k=300, n=10, I=11,997: fp32
    (pre-fetched and read in place) and int8 (pre-fetched and read from
    the corpus) bitwise against the sum in order j = 0..k-1 and against
    their plain versions; ids exact on the integer corpus."""
    u, nb = uid.long(), nbr.long()
    k = nb.shape[1]
    rows = corpus[nb]                                # 3.7 GB
    vk, ik = serving_topn.launch_rows(corpus[u], rows, ALPHA, TOPN)
    vx, ix = serving_topn.launch_rows_at(
        corpus[u], serving_topn._row_addresses(corpus, nb), [corpus],
        ALPHA, TOPN)
    vp, ip = ref.blend_topn_rows_ref(corpus[u], rows, ALPHA, TOPN)
    vo, io = ordered_blend(corpus[u], rows, TOPN)
    pred = ALPHA * corpus[u] + (1.0 - ALPHA) * rows.mean(1)
    torch.cuda.synchronize()
    assert same(vk, vo) and torch.equal(ik, io), \
        "blend_topn_rows is not the sum in order j = 0..k-1"
    assert same(vk, vx) and torch.equal(ik, ix), "in place and pre-fetched"
    err_f = float((vk - vp).abs().max())
    # fp32 sums of k rows in another order
    assert torch.allclose(vk, vp, rtol=1e-5, atol=1e-6), err_f
    assert torch.allclose(pred.gather(1, ik.long()), vp, rtol=1e-5,
                          atol=1e-6), "blend_topn_rows ids not equivalent"
    rows_q, n_scale = cq[nb], cs[nb]
    vk, ik = serving_topn.launch_rows(cq[u], rows_q, ALPHA, TOPN,
                                      q_scale=cs[u], n_scale=n_scale)
    vx, ix = serving_topn.launch_rows_indexed(cq[u], cs[u], cq, cs, nbr,
                                              ALPHA, TOPN)
    vp, ip = ref.blend_topn_rows_quant_ref(cq[u], cs[u], rows_q, n_scale,
                                           ALPHA, TOPN)
    deq = dequantize_int8_rows(cq, cs)
    pred = ALPHA * deq[u] + (1.0 - ALPHA) * deq[nb].mean(1)
    vo, io = ordered_blend(deq[u], deq[nb], TOPN)
    torch.cuda.synchronize()
    assert same(vk, vx) and same(ik, ix), "indexed and pre-fetched differ"
    assert same(vk, vo) and torch.equal(ik, io), \
        "blend_topn_rows_quant is not the sum in order j = 0..k-1"
    err_q = float((vk - vp).abs().max())
    assert torch.allclose(vk, vp, rtol=1e-5, atol=1e-6), err_q
    assert torch.allclose(pred.gather(1, ik.long()), vp, rtol=1e-5,
                          atol=1e-6), "blend_topn_rows_quant ids"
    del deq, pred
    # integer corpus: every sum exact, ties true ties
    ci8, ci_s = quantize_int8_rows(c_int)
    for got, exp in (
            (serving_topn.launch_rows(c_int[u], c_int[nb], ALPHA, TOPN),
             ref.blend_topn_rows_ref(c_int[u], c_int[nb], ALPHA, TOPN)),
            (serving_topn.launch_rows_indexed(ci8[u], ci_s[u], ci8, ci_s,
                                              nbr, ALPHA, TOPN),
             ref.blend_topn_rows_quant_ref(ci8[u], ci_s[u], ci8[nb],
                                           ci_s[nb], ALPHA, TOPN))):
        torch.cuda.synchronize()
        assert torch.equal(got[1], exp[1]), "row blend tie-break differs"
        assert torch.allclose(got[0], exp[0], rtol=1e-6), "integer values"
    log(f"  stage B over rows k={k} n={TOPN}: fp32 max |err| {err_f}, int8 "
        f"max |err| {err_q}; both bitwise the sum in order j = 0..k-1 "
        f"(in place = pre-fetched, indexed = pre-fetched); integer ties "
        f"exact")
    del ci8, ci_s
    n_items = corpus.shape[1]
    used = torch.unique(torch.cat([nb.reshape(-1), u]))
    qf, qq, qs = corpus[u], cq[u], cs[u]
    # Q*(k+1)*I adds (int8: multiply-adds) in FMA slots, two operations
    ops_b = 2.0 * Q * (k + 1) * n_items
    # one call by events, as in the table; beside it a burst of 10 by
    # events and the profiler's time per recorded launch of both kernels
    def b7():
        return serving_topn.launch_rows(qf, rows, ALPHA, TOPN)

    def b6():
        return serving_topn.launch_rows_indexed(qq, qs, cq, cs, nbr, ALPHA,
                                                TOPN)
    own, _, n_rec = device_ms(b7, ("rows_ring_kernel", "merge_lists_kernel"))
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(10):
        b7()
    end.record()
    end.synchronize()
    records["blend_topn_rows"] = dict(
        max_abs_err=err_f, shape=f"Q={Q} k={k} I={n_items} n={TOPN} "
                                 "pre-fetched f32",
        ms=time_ms(b7), burst_ms=start.elapsed_time(end) / 10,
        device_ms=own * 5 / max(1, n_rec // 2),
        in_place_ms=time_ms(lambda: serving_topn.launch_rows_at(
            qf, serving_topn._row_addresses(corpus, nb), [corpus], ALPHA,
            TOPN)),
        plain_ms=time_ms(lambda: ref.blend_topn_rows_ref(qf, rows, ALPHA,
                                                         TOPN)),
        library_ms=time_ms(lambda: torch.topk(
            ALPHA * qf + (1.0 - ALPHA) * rows.mean(1), TOPN)),
        bound=bound(Q * (k + 1) * n_items * 4 + Q * TOPN * 8, ops_b))
    del rows
    own, _, n_rec = device_ms(b6, ("rows_ring_kernel", "merge_lists_kernel"))
    records["blend_topn_rows_quant"] = dict(
        max_abs_err=err_q, shape=f"Q={Q} k={k} I={n_items} n={TOPN} int8 "
                                 "rows read from the corpus",
        ms=time_ms(b6), device_ms=own * 5 / max(1, n_rec // 2),
        prefetched_ms=time_ms(lambda: serving_topn.launch_rows(
            qq, rows_q, ALPHA, TOPN, q_scale=qs, n_scale=n_scale)),
        plain_ms=time_ms(lambda: ref.blend_topn_rows_quant_ref(
            qq, qs, cq[nb], cs[nb], ALPHA, TOPN)),
        library_ms=time_ms(lambda: torch.topk(
            ALPHA * (qq.float() * qs[:, None]) + (1.0 - ALPHA)
            * (cq[nb].float() * cs[nb][..., None]).mean(1), TOPN)),
        # the distinct rows read once, int8, with ids and scales
        bound=bound(used.numel() * n_items + Q * k * 8 + Q * TOPN * 8,
                    ops_b))
    for name in ("blend_topn_rows", "blend_topn_rows_quant"):
        r = records[name]
        log(f"  {name} timed: {r['ms']:.4f} ms one call, profiler "
            f"{r['device_ms']:.4f} ms a launch (plain {r['plain_ms']:.4f}, "
            f"library {r['library_ms']:.4f})"
            + (f"; pre-fetched int8 rows {r['prefetched_ms']:.4f} ms"
               if "prefetched_ms" in r else "")
            + (f"; {r['burst_ms']:.4f} ms a call in a burst of 10; rows "
               f"read in place from the corpus {r['in_place_ms']:.4f} ms"
               if "burst_ms" in r else ""))


# ---------------------------------------------------------------------------
# the main path, with the kernels and with the plain versions
# ---------------------------------------------------------------------------

def request_breakdown(run, p):
    """Device time of each request's serving stages on the corpus it was
    served from (CUDA events), beside the plain pipeline's: fp32 stages A
    and B (B also by the profiler, with stage A's distinct neighbour rows
    and B4's staging passes), then the int8 request's stages A and B."""
    for i, (users, corpus) in enumerate(zip(run.requests, run.corpora)):
        uid = torch.as_tensor(users, dtype=torch.int32, device=corpus.device)
        q = corpus[uid.long()]
        k = min(p.k_neighbors, corpus.shape[0] - 1)
        _, nbr = knn_topk.launch(q, corpus, k, query_gids=uid)
        t_a = time_ms(lambda: knn_topk.launch(q, corpus, k, query_gids=uid),
                      3)
        t_b = time_ms(lambda: serving_topn.launch(corpus, uid, nbr, p.alpha,
                                                  TOPN), 3)
        b_dev = device_ms(lambda: serving_topn.launch(corpus, uid, nbr,
                                                      p.alpha, TOPN),
                          ("blend_", "merge_"))[0]
        plan = serving_topn.plan_blend(
            uid.shape[0], corpus.shape[0], corpus.shape[1], k, TOPN,
            torch.cuda.get_device_properties(corpus.device)
            .multi_processor_count)
        distinct = [int(torch.unique(nbr[g0:g0 + plan.group]).numel())
                    for g0 in range(0, uid.shape[0], plan.group)]
        n_used = int(torch.unique(nbr).numel())
        t_p = time_ms(lambda: ref.fused_recommend_ref(corpus, uid, k,
                                                      p.alpha, TOPN), 3)
        cq, cs = run.quant_corpora[i]
        qq, qs = cq[uid.long()], cs[uid.long()]
        kq = dict(query_gids=uid, q_scale=qs, c_scale=cs)
        _, nbr = knn_topk.launch_dtiled(qq, cq, k, bd=BD, **kq)
        q_a = time_ms(lambda: knn_topk.launch_dtiled(qq, cq, k, bd=BD, **kq),
                      3)
        q_b = time_ms(lambda: serving_topn.launch_rows_indexed(
            qq, qs, cq, cs, nbr, p.alpha, TOPN), 3)
        q_p = time_ms(lambda: ref.fused_recommend_quant_ref(
            cq, cs, uid, k, p.alpha, TOPN, BD), 3)
        log(f"  request {i} on its corpus: stage A {t_a:.4f} ms, stage B "
            f"{t_b:.4f} ms ({b_dev:.4f} device; {n_used} distinct "
            f"neighbour rows, {min(distinct)}-{max(distinct)} a group of "
            f"{plan.group}, at most "
            f"{-(-max(distinct) // plan.stage_rows)} passes of "
            f"{plan.stage_rows}); plain pipeline {t_p:.4f} ms | int8: stage A "
            f"{q_a:.4f} ms ({plan_str(qq, cq, k, BD)}), stage B "
            f"{q_b:.4f} ms; plain int8 pipeline {q_p:.4f} ms")


def hold(corpus, users, exp, got, p, what):
    """compare_recommendations of two answers on one corpus: 0
    mismatches; returns (exact, total)."""
    res = knn.compare_recommendations(corpus, users, exp, got,
                                      k=p.k_neighbors, alpha=p.alpha,
                                      rtol=1e-5)
    log(f"  {what} ({len(users)} users): {res}")
    assert res["mismatch"] == 0, (what, res)
    return res["exact"], len(users)


def main_path(ds, dev):
    """Phase 4; returns the kernel run and the launch counts it made."""
    build.reset_launch_counts()
    kern = serve.run_trickle(ds, device=dev, keep_corpora=True,
                             quantized=True)
    torch.cuda.synchronize()
    launches = dict(build.launch_counts)
    log("main path with the kernels:\n" + serve.summary(kern))
    build.reset_launch_counts()
    with ops.default_impl("ref"):
        plain = serve.run_trickle(ds, device=dev, keep_corpora=True,
                                  quantized=True)
    torch.cuda.synchronize()
    log("main path with the plain versions:\n" + serve.summary(plain))
    assert not any(build.launch_counts.values()), \
        ("the plain run launched kernels", build.launch_counts)
    log(f"  launches on the main path: {launches}")
    for name in ("sparse_row_gather", "sparse_row_scatter", "knn_topk",
                 "blend_topn_onehot", "knn_topk_dtiled",
                 "blend_topn_rows_quant"):
        assert launches[name] > 0, \
            f"kernel {name} was not launched on the main path"
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
    for name in ("quant_full_builds", "quant_rows_refreshed",
                 "quant_threshold_rebuilds"):
        assert getattr(kern.engine.store, name) == \
            getattr(plain.engine.store, name), name

    p = ds.params
    total = exact = q_total = q_exact = 0
    for run in (kern, plain):
        # the row-refresh contract: after every request the int8 cache is
        # a from-scratch quantization of the corpus, bit for bit
        for i, (corpus, (cq, cs)) in enumerate(zip(run.corpora,
                                                   run.quant_corpora)):
            wq, ws = quantize_int8_rows(corpus)
            assert torch.equal(cq, wq) and same(cs, ws), \
                f"int8 cache after request {i} is not quantize(corpus())"
    for i, (users, corpus, kr, pr) in enumerate(zip(
            kern.requests, kern.corpora, kern.recs, plain.recs)):
        e, t = hold(corpus, users, pr, kr, p, f"request {i}, fp32")
        exact, total = exact + e, total + t
        # the int8 answer against the plain int8 pipeline on the SAME
        # (q, scale); the exact class is computed on the dequantized rows
        cq, cs = kern.quant_corpora[i]
        uid = torch.as_tensor(users, dtype=torch.int32, device=dev)
        want = ops.fused_recommend_quant(cq, cs, uid, p.k_neighbors,
                                         p.alpha, TOPN, bd=BD, impl="ref")
        e, t = hold(dequantize_int8_rows(cq, cs), users,
                    want.cpu().numpy(), kern.quant_recs[i], p,
                    f"request {i}, int8")
        q_exact, q_total = q_exact + e, q_total + t
    assert exact >= 0.9 * total, ("exact class", exact, total)
    assert q_exact >= 0.9 * q_total, ("int8 exact class", q_exact, q_total)
    # the two runs' fp32 states agree to rtol 1e-4 only, so a row may sit
    # one rounding step apart in int8: counted, not asserted
    differ = sum(int((kq != pq).any(dim=1).sum()) for (kq, _), (pq, _) in
                 zip(kern.quant_corpora, plain.quant_corpora))
    m = kern.engine.metrics
    log(f"main path: {kern.n_events / kern.load_seconds:.0f} load "
        f"events/s with the kernels, {plain.n_events / plain.load_seconds:.0f}"
        f" with the plain versions; request latency (ms) kernels "
        f"{[round(t * 1e3, 3) for t in kern.request_seconds]}, plain "
        f"{[round(t * 1e3, 3) for t in plain.request_seconds]}; int8 "
        f"request latency (ms) kernels "
        f"{[round(t * 1e3, 3) for t in kern.quant_request_seconds]}, plain "
        f"{[round(t * 1e3, 3) for t in plain.quant_request_seconds]}; "
        f"{m.host_fetches / m.batches:.3f} host fetches per step; "
        f"{exact}/{total} fp32 and {q_exact}/{q_total} int8 queries in the "
        f"exact class (identical ids); int8 cache rows that differ between "
        f"the two runs over the 4 requests: {differ}")
    return kern, launches


def dtiled_path(kern, p, dev):
    """Phase 5: fp32 D-tiled serving on the main path's last corpus.
    Returns its launch counts: its D-tiled launches are all fp32, on the
    ring design (``knn_topk_dtiled_f32``)."""
    corpus, users = kern.corpora[-1], kern.requests[-1]
    uid = torch.as_tensor(users, dtype=torch.int32, device=dev)
    pl = knn_topk.plan_for(corpus[uid.long()], corpus, p.k_neighbors, BD)
    assert pl.design == "ring_f32", pl
    build.reset_launch_counts()
    got = ops.fused_recommend(corpus, uid, p.k_neighbors, p.alpha, TOPN,
                              bd=BD)
    torch.cuda.synchronize()
    launches = dict(build.launch_counts)
    log(f"fp32 D-tiled serving: launches {launches}")
    for name in ("knn_topk_dtiled_f32", "blend_topn_onehot"):
        assert launches[name] > 0, f"{name} was not launched on path 5"
    assert launches["knn_topk_dtiled"] == 0, launches
    ms = host_ms(lambda: ops.fused_recommend(corpus, uid, p.k_neighbors,
                                             p.alpha, TOPN, bd=BD))
    log(f"  fp32 D-tiled request of {len(users)} users: {ms:.4f} ms "
        f"(host clock ended by a sync, median of 3)")
    got = got.cpu().numpy()
    mono = ops.fused_recommend(corpus, uid, p.k_neighbors, p.alpha, TOPN)
    plain = ops.fused_recommend(corpus, uid, p.k_neighbors, p.alpha, TOPN,
                                bd=BD, impl="ref")
    ex = [hold(corpus, users, mono.cpu().numpy(), got, p,
               "D-tiled vs bd=None"),
          hold(corpus, users, plain.cpu().numpy(), got, p,
               "D-tiled vs its plain pipeline")]
    for e, t in ex:
        assert e >= 0.9 * t, ("exact class", e, t)
    return launches


def sharded_prefetched(corpora, users, k, alpha, n_shards):
    """The fp32 sharded pipeline as it ran before the rows were read in
    place: the same candidates and merge, then the selected rows
    gathered, [Q, k, I], for the row blend (the route the plain path
    keeps).  Returns the top-n ids."""
    uid = torch.as_tensor(np.asarray(users, np.int64),
                          device=corpora[0].device)
    queries = knn._owner_rows(corpora, uid, n_shards)
    vals, gids = zip(*(knn.shard_topk_candidates(
        queries, c, k, s, n_shards, query_ids=uid.to(torch.int32))
        for s, c in enumerate(corpora)))
    sel = knn._merge_candidates(list(vals), list(gids), k)
    return ops.blend_topn_rows(
        queries, knn._owner_rows(corpora, sel, n_shards), alpha, TOPN)


def sharded_prefetched_quant(quant, users, k, alpha, n_shards):
    """The int8 twin of :func:`sharded_prefetched`."""
    cqs, css = [q for q, _ in quant], [s for _, s in quant]
    uid = torch.as_tensor(np.asarray(users, np.int64), device=cqs[0].device)
    queries_q = knn._owner_rows(cqs, uid, n_shards)
    q_scale = knn._owner_rows(css, uid, n_shards)
    vals, gids = zip(*(ops.shard_topk_quant(
        queries_q, q_scale, cq, cs, k, shard=s, n_shards=n_shards,
        query_gids=uid.to(torch.int32), bd=BD)
        for s, (cq, cs) in enumerate(quant)))
    sel = knn._merge_candidates(list(vals), list(gids), k)
    return ops.blend_topn_rows_quant(
        queries_q, q_scale, knn._owner_rows(cqs, sel, n_shards),
        knn._owner_rows(css, sel, n_shards), alpha, TOPN)


def host_ms(fn, reps: int = 3) -> float:
    """Median host-clock time of ``fn`` ended by a sync, after a warm-up
    (a request as its caller waits for it)."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def sharded_path(kern, p, dev):
    """Phase 6: the last corpus split round-robin into 2 shards on the
    one card; both sharded pipelines for the last request's users."""
    corpus, users = kern.corpora[-1], kern.requests[-1]
    cq, cs = kern.quant_corpora[-1]
    n_users = corpus.shape[0]
    spec = UserShardSpec(n_users, 2)
    owned = [torch.as_tensor(spec.owned_users(s), device=dev)
             for s in range(2)]
    corpora = [corpus[o] for o in owned]
    # row quantization is partition invariant: a shard's rows of the
    # store's int8 cache are its own quantization
    quant = [(cq[o], cs[o]) for o in owned]
    for (sq, ss), c in zip(quant, corpora):
        wq, ws = quantize_int8_rows(c)
        assert torch.equal(sq, wq) and same(ss, ws), "partition invariance"
    args = (users, p.k_neighbors, p.alpha, TOPN, 2)
    build.reset_launch_counts()
    got = knn.sharded_recommend_for_users(corpora, *args)
    got_q = knn.sharded_recommend_for_users_quant(quant, *args, bd=BD)
    torch.cuda.synchronize()
    launches = dict(build.launch_counts)
    log(f"cross-shard serving (2 shards, one card): launches {launches}")
    for name in ("knn_topk", "blend_topn_rows", "knn_topk_dtiled",
                 "blend_topn_rows_quant"):
        assert launches[name] > 0, f"{name} was not launched on path 6"
    # the rows read in place answer as the pre-fetched rows do (the sums
    # run in the same order), and each route's request time
    pre_args = (users, p.k_neighbors, p.alpha, 2)
    pre = sharded_prefetched(corpora, *pre_args)
    pre_q = sharded_prefetched_quant(quant, *pre_args)
    torch.cuda.synchronize()
    assert torch.equal(got, pre) and torch.equal(got_q, pre_q), \
        "in place and pre-fetched cross-shard answers differ"
    times = [host_ms(lambda: knn.sharded_recommend_for_users(corpora,
                                                             *args)),
             host_ms(lambda: sharded_prefetched(corpora, *pre_args)),
             host_ms(lambda: knn.sharded_recommend_for_users_quant(
                 quant, *args, bd=BD)),
             host_ms(lambda: sharded_prefetched_quant(quant, *pre_args))]
    log(f"  2-shard requests of {len(users)} users, host clock: fp32 "
        f"{times[0]:.3f} ms with the rows read in place, {times[1]:.3f} "
        f"pre-fetched; int8 {times[2]:.3f} ms in place, {times[3]:.3f} "
        f"pre-fetched; the answers identical, fp32 and int8")
    got, got_q = got.cpu().numpy(), got_q.cpu().numpy()
    uid = torch.as_tensor(users, dtype=torch.int32, device=dev)
    deq = dequantize_int8_rows(cq, cs)
    with ops.default_impl("ref"):
        plain = knn.sharded_recommend_for_users(corpora, *args)
        plain_q = knn.sharded_recommend_for_users_quant(quant, *args, bd=BD)
        single_q = ops.fused_recommend_quant(cq, cs, uid, p.k_neighbors,
                                             p.alpha, TOPN, bd=BD)
    single = ops.fused_recommend(corpus, uid, p.k_neighbors, p.alpha, TOPN)
    ex = [hold(corpus, users, single.cpu().numpy(), got, p,
               "sharded fp32 vs single corpus"),
          hold(corpus, users, plain.cpu().numpy(), got, p,
               "sharded fp32 vs its plain pipeline"),
          hold(deq, users, single_q.cpu().numpy(), got_q, p,
               "sharded int8 vs single corpus"),
          hold(deq, users, plain_q.cpu().numpy(), got_q, p,
               "sharded int8 vs its plain pipeline")]
    for e, t in ex:
        assert e >= 0.9 * t, ("exact class", e, t)
    u = torch.as_tensor(users, device=dev)
    qq, qs = cq[u], cs[u]
    for s, (sq, ss) in enumerate(quant):
        kv, kg = ops.shard_topk_quant(qq, qs, sq, ss, p.k_neighbors, s, 2,
                                      query_gids=uid, bd=BD, impl="cuda")
        pv, pg = ops.shard_topk_quant(qq, qs, sq, ss, p.k_neighbors, s, 2,
                                      query_gids=uid, bd=BD, impl="ref")
        torch.cuda.synchronize()
        assert same(kv, pv) and torch.equal(kg, pg), f"shard {s} int8"
    log("  each shard's int8 candidates: identical to the plain version")
    return launches
# ---------------------------------------------------------------------------
# the from-scratch rebuild (decayed_scatter) and granite-3-2b serving
# (flash_attention)
# ---------------------------------------------------------------------------

def multihot_pair(ids, w, n_items, what):
    """The scatter kernel against its plain version (allclose; the
    kernel's sum order is (n, b), the plain one's index_put_'s) and
    against itself (reruns bitwise).  Returns (max |err|, bitwise)."""
    got = decayed_scatter.launch(ids, w, n_items)
    again = decayed_scatter.launch(ids, w, n_items)
    exp = ref.decayed_scatter_ref(ids, w, n_items)
    torch.cuda.synchronize()
    err = float((got - exp).abs().max())
    assert got.shape == exp.shape, (what, got.shape, exp.shape)
    assert torch.allclose(got, exp, rtol=1e-5, atol=1e-6), (what, err)
    assert torch.equal(got, again), f"{what}: scatter reruns differ"
    return err, torch.equal(got, exp)


def check_multihot_edges(dev):
    """The scatter kernel's edge cases: PAD-only rows, an id repeated
    across baskets, ids >= n_items, a chunk boundary (N·B > 4,096), the
    single-row form, and one row at the million-item width."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    items = 1000
    ids = torch.randint(-1, items, (6, 40, 9), generator=gen, device=dev,
                        dtype=torch.int32)
    ids[0] = -1                                  # PAD only
    ids[1, :, 0] = 7                             # id 7 in every basket
    ids[2] = torch.randint(items - 20, items + 60, (40, 9), generator=gen,
                           device=dev, dtype=torch.int32)  # many >= I
    ids[3, :, :] = ids[3, :1, :]                 # the same basket 40 times
    w = torch.rand((6, 40), generator=gen, device=dev)
    results = [multihot_pair(ids, w, items, "edge rows")]
    results.append(multihot_pair(ids[1], w[1], items, "single row"))
    long_ids = torch.randint(-1, 300, (2, 700, 9), generator=gen,
                             device=dev, dtype=torch.int32)
    results.append(multihot_pair(long_ids, torch.rand(
        (2, 700), generator=gen, device=dev), 300, "6,300 entries per row"))
    big = torch.randint(-1, BIG_I, (256, 64), generator=gen, device=dev,
                        dtype=torch.int32)
    big[:, :8] = torch.randint(0, 64, (256, 8), generator=gen, device=dev,
                               dtype=torch.int32)   # repeated ids
    results.append(multihot_pair(big, torch.rand((256,), generator=gen,
                                                 device=dev), BIG_I,
                                 "million-item row"))
    out = decayed_scatter.launch(ids, w, items)
    assert torch.count_nonzero(out[0]) == 0, "PAD-only row not zero"
    log("  decayed_scatter edge cases (PAD-only row, repeated ids, ids >= "
        "I, 6,300 entries per row, single row, N=256 B=64 I=1,048,576): "
        f"max |err| {max(e for e, _ in results)}, bitwise its plain version "
        f"in {sum(b for _, b in results)} of {len(results)}; reruns bitwise")


def rebuild_path(kern, p, dev, records):
    """Phase 7: the from-scratch rebuild of every user of the main path's
    final state (TaFeng at its published size) in one batched
    ``ops.multihot_scatter`` (counts reset before, read after), held
    against its plain version and against the maintained state."""
    state = kern.engine.store.state
    hist, n_items = state.history, state.n_items
    u, n, b = hist.shape
    w = closed_form_basket_weights(state.group_sizes, state.n_groups, p.r_b,
                                   p.r_g, n)
    build.reset_launch_counts()
    got = ops.multihot_scatter(hist, w, n_items)
    torch.cuda.synchronize()
    launches = dict(build.launch_counts)
    assert launches["decayed_scatter"] == 1, launches
    plain = ops.multihot_scatter(hist, w, n_items, impl="ref")
    again = ops.multihot_scatter(hist, w, n_items)
    torch.cuda.synchronize()
    err = float((got - plain).abs().max())
    assert torch.allclose(got, plain, rtol=1e-5, atol=1e-6), err
    assert torch.equal(got, again), "rebuild reruns differ"
    maintained = state.materialized_user_vecs()
    dev_max = float((got - maintained).abs().max())
    assert torch.allclose(got, maintained, rtol=1e-4, atol=1e-5), \
        ("maintained state vs from-scratch rebuild", dev_max)
    valid = (hist >= 0) & (hist < n_items)
    n_valid = int(valid.sum())
    log(f"rebuild from scratch of all {u} users (N={n}, B={b}, I={n_items},"
        f" {n_valid} valid ids): kernel vs plain max |err| {err} "
        f"(bitwise: {torch.equal(got, plain)}), vs the maintained state max "
        f"|diff| {dev_max} (bar rtol=1e-4, atol=1e-5); launches {launches}")
    rows = torch.arange(u, device=dev)[:, None, None].expand(u, n, b)
    r_v, i_v = rows[valid], hist[valid].long()
    w_v = w[:, :, None].expand(u, n, b)[valid]
    del got, again, plain, maintained
    t = dict(
        ms=time_ms(lambda: ops.multihot_scatter(hist, w, n_items)),
        plain_ms=time_ms(lambda: ops.multihot_scatter(hist, w, n_items,
                                                      impl="ref")),
        library_ms=time_ms(lambda: torch.zeros(
            (u, n_items), device=dev).index_put_((r_v, i_v), w_v,
                                                 accumulate=True)))
    records["decayed_scatter"] = dict(
        t, max_abs_err=err, shape=f"U={u} N={n} B={b} I={n_items}",
        bound=bound(hist.numel() * 4 + w.numel() * 4 + u * n_items * 4, 0))
    return launches


# ---------------------------------------------------------------------------
# durability: checkpoint, crash, restore, replay, async commit, degraded
# and cosine serving at TaFeng's full size
# ---------------------------------------------------------------------------

def assert_launched(before, names, what):
    """Each kernel in ``names`` was launched since the counts ``before``."""
    for name in names:
        assert build.launch_counts[name] > before.get(name, 0), \
            f"{name} was not launched {what}"


def state_parity(got, want, what):
    """Integer leaves exact, materialized vectors rtol=1e-4, atol=1e-5."""
    a, b = got.store.state, want.store.state
    for name in ("history", "group_sizes", "n_baskets", "n_groups"):
        assert torch.equal(getattr(a, name), getattr(b, name)), (what, name)
    err = 0.0
    for fn in ("materialized_user_vecs", "materialized_last_group_vecs"):
        x, y = getattr(a, fn)(), getattr(b, fn)()
        err = max(err, float((x - y).abs().max()))
        assert torch.allclose(x, y, rtol=1e-4, atol=1e-5), (what, fn, err)
    return err


def trickle(eng, n_users, n_items, seed):
    """64 new baskets of distinct users, as the main path's trickle."""
    rng = np.random.default_rng(seed)
    eng.submit([Event(KIND_ADD_BASKET, int(u), items=rng.choice(
        n_items, size=int(rng.integers(1, 6)), replace=False))
        for u in rng.choice(n_users, size=64, replace=False)])
    eng.run_until_drained()


def uncounted(fn):
    """``fn()`` with its kernel launches left out of the counts: a
    yardstick's work inside a path's counted window."""
    saved = dict(build.launch_counts)
    out = fn()
    build.launch_counts.update(saved)
    return out


def serve_both(eng, users):
    """fp32 and int8 (bd=512) answers of one request batch."""
    return (eng.recommend(users, topn=TOPN),
            eng.recommend(users, topn=TOPN, quantized=True))


def timed(fn) -> float:
    """Host-clock seconds of ``fn``, between two synchronizations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def mixed_stream(ds):
    """The main path's store shapes and mixed stream, each event with
    its seqno (phases 8 and 9)."""
    cfg = StoreConfig(
        n_users=len(ds.histories), n_items=ds.params.n_items,
        max_baskets=max(len(h) for h in ds.histories.values()) + 8,
        max_basket_size=max(len(b) for h in ds.histories.values()
                            for b in h) + 2)
    events = [dataclasses.replace(ev, seqno=i) for i, ev in enumerate(
        stream.make_stream(ds.histories, deletion_user_rate=0.01,
                           item_deletion_rate=0.005, seed=0))]
    return cfg, events


def durability_path(ds, users, dev, card):
    """Phase 8: the durability layer at TaFeng's full size on the card.

    The main path's mixed stream, each event with its seqno: E1 loads
    the first half and commits it, loads the rest and dies at
    ``LATEST.pre_replace`` in its second commit; E2 restores (commit 1)
    and takes the whole stream again with seeded duplicates; a commit of
    E1 restores bitwise into E3, which answers E1's requests; an async
    commit lands its snapshot-time state after 64 more baskets; a frozen
    E1 answers as before the freeze, and a thawed one as a fresh corpus;
    a cosine request takes the plain route.  Counts reset before, read
    after; returns them and the phase's readings."""
    p = ds.params
    n_users, n_items = len(ds.histories), p.n_items
    cfg, events = mixed_stream(ds)
    half = len(events) // 2
    uid = torch.as_tensor(users, dtype=torch.int32, device=dev)
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    ck = str(CKPT_DIR)

    def engine():
        return StreamingEngine(StateStore(cfg, device=dev), p,
                               batch_size=512)

    r = {}
    build.reset_launch_counts()
    # 1-2: commit the first half, crash in the second commit
    e1 = engine()
    e1.submit(events[:half])
    e1.run_until_drained()
    r["checkpoint_s"] = timed(lambda: e1.checkpoint(ck, 1))
    with open(CKPT_DIR / "LATEST") as f:
        r["npz_bytes"] = json.load(f)["npz_bytes"]
    e1.submit(events[half:])
    e1.run_until_drained()
    plan = faults.FaultPlan(crash_site="LATEST.pre_replace")
    crashed = False
    with faults.inject(plan):
        try:
            e1.checkpoint(ck, 2)
        except faults.InjectedCrash:
            crashed = True
    assert crashed and plan.fired[-1] == "LATEST.pre_replace", plan.fired
    # 3: a fresh engine restores the last commit that landed
    e2 = engine()
    r["restore_after_crash_s"] = timed(lambda: e2.restore(ck))
    assert e2.store.last_restored_meta["step"] == 1
    assert e2.watermark == half - 1, (e2.watermark, half)
    # 4: at-least-once replay of the whole stream with duplicates
    dups = faults.redelivered(events, seed=7)
    before = dict(build.launch_counts)

    def replay():
        e2.submit(events)
        e2.submit(dups)
        e2.run_until_drained()

    r["replay_s"] = timed(replay)
    assert_launched(before, ("sparse_row_gather", "sparse_row_scatter"),
                    "during the replay")
    assert e2.metrics.events_processed == len(events) - half
    assert e2.metrics.dedup_skips == half + len(dups)
    assert e1.metrics.events_processed == len(events)
    assert e2.watermark == e1.watermark == len(events) - 1
    r["replay_events"] = len(events) + len(dups)
    r["replay_applied"] = len(events) - half
    r["replay_max_abs_err"] = state_parity(e2, e1, "replay vs E1")
    del e2
    # 5: round trip, bitwise, and the same answers
    r["checkpoint3_s"] = timed(lambda: e1.checkpoint(ck, 3))
    e3 = engine()
    r["restore_s"] = timed(lambda: e3.restore(ck))
    for name in convert.LEAVES:
        a, b = getattr(e1.store.state, name), getattr(e3.store.state, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name
    before = dict(build.launch_counts)
    ids1, ids3 = serve_both(e1, users), serve_both(e3, users)
    assert_launched(before, ("knn_topk", "blend_topn_onehot",
                             "knn_topk_dtiled", "blend_topn_rows_quant"),
                    "serving the restored state")
    for a, b, what in zip(ids1, ids3, ("fp32", "int8")):
        assert np.array_equal(a, b), f"restored {what} answer differs"
    del e3
    # 6: async commit; 64 baskets applied before the flush
    snap = convert.state_to_numpy(e1.store.state)
    e1.checkpointer = AsyncCheckpointer()
    r["async_caller_s"] = timed(lambda: e1.checkpoint(ck, 4))
    t0 = time.perf_counter()
    trickle(e1, n_users, n_items, seed=1)
    e1.flush_checkpoints()
    r["async_total_s"] = time.perf_counter() - t0 + r["async_caller_s"]
    e1.checkpointer.close()
    e1.checkpointer = None
    t0 = time.perf_counter()
    meta, leaves = load_checkpoint_arrays(ck)
    r["read_verify_s"] = time.perf_counter() - t0
    assert meta["step"] == 4
    for name in convert.LEAVES:
        assert leaves[name].dtype == snap[name].dtype and np.array_equal(
            leaves[name], snap[name]), f"async commit leaf {name}"
    assert not np.array_equal(snap["n_baskets"],
                              e1.store.state.n_baskets.cpu().numpy())
    del snap, leaves
    # 7: degraded serving, then a thaw onto a fresh corpus
    pre = serve_both(e1, users)
    e1.freeze_serving()
    trickle(e1, n_users, n_items, seed=2)
    before = dict(build.launch_counts)
    frozen = serve_both(e1, users)
    assert_launched(before, ("knn_topk", "blend_topn_onehot",
                             "knn_topk_dtiled", "blend_topn_rows_quant"),
                    "serving the frozen snapshot")
    for a, b, what in zip(pre, frozen, ("fp32", "int8")):
        assert np.array_equal(a, b), f"frozen {what} answer moved"
    e1.thaw_serving()
    thawed = serve_both(e1, users)
    fresh = e1.store.state.materialized_user_vecs()
    assert torch.equal(e1.store.corpus(), fresh), "thawed corpus"
    fq, fs = quantize_int8_rows_pitched(fresh)
    cq, cs = e1.store.quantized_corpus()
    assert torch.equal(cq, fq) and same(cs, fs), "thawed int8 cache"
    want = (knn.recommend_for_users(fresh, uid, k=p.k_neighbors,
                                    alpha=p.alpha, topn=TOPN),
            knn.recommend_for_users_quant(fq, fs, uid, k=p.k_neighbors,
                                          alpha=p.alpha, topn=TOPN))
    for a, b, what in zip(thawed, want, ("fp32", "int8")):
        assert np.array_equal(a, b.cpu().numpy()), f"thawed {what} answer"
    r["thaw_changed_rows"] = [int((a != b).any(axis=1).sum())
                              for a, b in zip(pre, thawed)]
    del fresh, fq, fs
    # 8: cosine routes to the plain pipeline, no kernel launched
    before = dict(build.launch_counts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = e1.recommend(users, topn=TOPN, metric="cosine")
    r["cosine_request_s"] = time.perf_counter() - t0
    assert build.launch_counts == before, "a kernel served cosine"
    plain = ops.fused_recommend(e1.store.corpus(), uid, p.k_neighbors,
                                p.alpha, TOPN, metric="cosine", impl="ref")
    assert np.array_equal(got, plain.cpu().numpy()), "cosine answer"
    torch.cuda.synchronize()
    launches = dict(build.launch_counts)
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    log(f"durability at TaFeng's full size ({n_users} users x {n_items} "
        f"items, {len(events)} events, commit of {r['npz_bytes']} npz "
        f"bytes): launches {launches}")
    log(f"  checkpoint (sync, after {half} events) {r['checkpoint_s']:.3f} "
        f"s, after all {r['checkpoint3_s']:.3f} s; npz {r['npz_bytes']} "
        f"bytes [{card}]")
    log(f"  restore {r['restore_s']:.3f} s (after the crash "
        f"{r['restore_after_crash_s']:.3f} s; reading, verifying and "
        f"decompressing a commit alone {r['read_verify_s']:.3f} s) "
        f"[{card}]")
    log(f"  replay: {r['replay_events']} events delivered "
        f"({r['replay_applied']} applied, the rest skipped as duplicates) "
        f"in {r['replay_s']:.3f} s: {r['replay_events'] / r['replay_s']:.0f}"
        f" delivered events/s, {r['replay_applied'] / r['replay_s']:.0f} "
        f"applied events/s; vs E1 max |diff| {r['replay_max_abs_err']} "
        f"[{card}]")
    log(f"  async checkpoint: caller thread {r['async_caller_s']:.3f} s "
        f"(sync {r['checkpoint3_s']:.3f} s), commit landed "
        f"{r['async_total_s']:.3f} s after the call, 64 baskets applied "
        f"meanwhile [{card}]")
    log(f"  frozen answers identical, fp32 and int8; after the thaw "
        f"{r['thaw_changed_rows']} of {len(users)} users' answers changed "
        f"(fp32, int8), equal to a fresh corpus's; cosine request "
        f"{r['cosine_request_s'] * 1e3:.3f} ms on the plain route [{card}]")
    return launches, r


# ---------------------------------------------------------------------------
# the sharded engine: load, serving, torn crash, restore, reshard, recovery
# ---------------------------------------------------------------------------

SHARD_INT_LEAVES = ("history", "group_sizes", "n_baskets", "n_groups")


def maintenance_counters(m):
    return {name: getattr(m, name) for name in (
        "batches", "refreshes", "renormalizations", "dropped_adds",
        "host_fetches")}


def sharded_parity(eng, single, what):
    """The sharded state mapped back through the spec against the single
    engine's: integer leaves exact, materialized vectors bitwise.  Users
    whose vectors differ in any bit are named, with both engines'
    maintenance counters, and held to the main path's rtol=1e-4,
    atol=1e-5; returns their number."""
    want_state = single.store.state
    dev = want_state.n_baskets.device
    owned = [torch.as_tensor(eng.spec.owned_users(s), device=dev)
             for s in range(eng.spec.n_shards)]
    for name in SHARD_INT_LEAVES:
        want = getattr(want_state, name)
        for s, sh in enumerate(eng.shards):
            assert torch.equal(getattr(sh.store.state, name),
                               want[owned[s]]), (what, name, s)
    differ = []
    for fn in ("materialized_user_vecs", "materialized_last_group_vecs"):
        want = getattr(want_state, fn)()
        for s, sh in enumerate(eng.shards):
            got, w = getattr(sh.store.state, fn)(), want[owned[s]]
            bad = (got.view(torch.int32) != w.view(torch.int32)).any(dim=1)
            if bool(bad.any()):
                assert torch.allclose(got[bad], w[bad], rtol=1e-4,
                                      atol=1e-5), (what, fn, s)
                differ += owned[s][bad].tolist()
        del want
    differ = sorted(set(differ))
    if differ:
        log(f"  {what}: {len(differ)} users differ from the single engine "
            f"in some bit (held to rtol=1e-4, atol=1e-5), the first "
            f"{differ[:8]}; maintenance counters: sharded "
            f"{[maintenance_counters(sh.metrics) for sh in eng.shards]}, "
            f"single {maintenance_counters(single.metrics)}")
    else:
        log(f"  {what}: the state bitwise the single engine's")
    return len(differ)


def global_rows(eng, tables):
    """Per-shard [M_s, ...] tables as one global table, through the spec."""
    out = torch.empty((eng.spec.n_users,) + tuple(tables[0].shape[1:]),
                      dtype=tables[0].dtype, device=tables[0].device)
    for s, t in enumerate(tables):
        out[torch.as_tensor(eng.spec.owned_users(s), device=t.device)] = t
    return out


def sharded_engine_path(ds, requests, dev, card, single_rate):
    """Phase 9: the user-axis sharded engine at TaFeng's full size.

    The mixed stream of phase 8, each event with its seqno, through a
    2-shard ``ShardedStreamingEngine`` on the one card in micro-batches
    of 512 a shard, with a synchronous commit after the first half; its
    state held against a single engine fed the same stream; 4 requests
    of 256 users, fp32 and int8, held against the single engine's and
    the plain versions' answers; a crash inside the second commit that
    lands shard 0's and not shard 1's; restore into 2 shards and a
    replay with duplicates; the first-half commit resharded into 3
    shards and the whole stream submitted; ``recover_shard(1)``
    answering from its frozen snapshot during the recovery.  The single
    engine is loaded and gives its answers before the counts are reset,
    and the fresh corpus's answers after the thaw are ``uncounted``: the
    counts, read after, hold the sharded engine's launches alone.
    Returns them and the phase's readings."""
    p = ds.params
    n_users = len(ds.histories)
    cfg, events = mixed_stream(ds)
    half = len(events) // 2
    spec = UserShardSpec(n_users, 2)
    shutil.rmtree(SHARD_CKPT_DIR, ignore_errors=True)
    ck, ck_half = str(SHARD_CKPT_DIR / "ck"), str(SHARD_CKPT_DIR / "half")

    def sharded(n_shards):
        return ShardedStreamingEngine.create(
            UserShardSpec(n_users, n_shards), p, cfg.max_baskets,
            cfg.max_basket_size,
            devices=make_user_shard_devices(n_shards), batch_size=512)

    def load(eng, evs):
        eng.submit(evs)
        eng.run_until_drained()

    r = {}
    # the single engine of the same stream and its answers, the
    # yardstick, before the counts are reset
    single = StreamingEngine(StateStore(cfg, device=dev), p,
                             batch_size=512)
    r["single_load_s"] = timed(lambda: load(single, events))
    yardstick = [serve_both(single, users) for users in requests]
    build.reset_launch_counts()
    # 1: the 2-shard load, a synchronous commit after the first half
    eng = sharded(2)
    assert all(sh.store.device.type == dev.type for sh in eng.shards)
    before = dict(build.launch_counts)
    r["load_s"] = timed(lambda: load(eng, events[:half]))
    r["checkpoint_s"] = timed(lambda: eng.checkpoint(ck, 1))
    r["npz_bytes"] = []
    for s in range(2):
        with open(SHARD_CKPT_DIR / "ck" / f"shard_{s:03d}" / "LATEST") as f:
            r["npz_bytes"].append(json.load(f)["npz_bytes"])
    shutil.copytree(ck, ck_half)
    r["load_s"] += timed(lambda: load(eng, events[half:]))
    assert_launched(before, ("sparse_row_gather", "sparse_row_scatter"),
                    "loading the sharded engine")
    assert eng.events_processed == len(events) and eng.n_pending == 0
    assert eng.dead_letters == single.metrics.dead_letters
    r["differ"] = [sharded_parity(eng, single, "2-shard load")]
    # 2: requests, fp32 and int8, against the single engine and the
    # plain versions
    corpus = global_rows(eng, eng.corpora())
    deq = dequantize_int8_rows(*(global_rows(eng, list(t)) for t in zip(
        *eng.quantized_corpora())))
    exact = {"fp32": [0, 0], "int8": [0, 0]}
    r["request_ms"], r["quant_request_ms"] = [], []
    for i, (users, (want, want_q)) in enumerate(zip(requests, yardstick)):
        before = dict(build.launch_counts)
        got, got_q = serve_both(eng, users)
        assert_launched(before, ("knn_topk", "blend_topn_rows",
                                 "knn_topk_dtiled", "blend_topn_rows_quant"),
                        "serving the sharded engine")
        before = dict(build.launch_counts)
        with ops.default_impl("ref"):
            plain, plain_q = serve_both(eng, users)
        assert build.launch_counts == before, "the plain versions launched"
        for c, exp, what, key, g in (
                (corpus, want, "single engine", "fp32", got),
                (corpus, plain, "plain versions", "fp32", got),
                (deq, want_q, "single engine", "int8", got_q),
                (deq, plain_q, "plain versions", "int8", got_q)):
            e, t = hold(c, users, exp, g, p,
                        f"request {i}, 2-shard {key} vs {what}")
            exact[key][0] += e
            exact[key][1] += t
        r["request_ms"].append(host_ms(lambda: eng.recommend(users,
                                                             topn=TOPN)))
        r["quant_request_ms"].append(host_ms(lambda: eng.recommend(
            users, topn=TOPN, quantized=True)))
    for key, (e, t) in exact.items():
        assert e >= 0.9 * t, ("exact class", key, e, t)
    r["exact"] = exact
    del corpus, deq
    # 3: a crash inside the second commit: shard 0's LATEST lands (the
    # site's 1st hit passes), shard 1's does not, the manifest stays
    plan = faults.FaultPlan(crash_site="LATEST.pre_replace", crash_on_hit=2)
    crashed = False
    with faults.inject(plan):
        try:
            eng.checkpoint(ck, 2)
        except faults.InjectedCrash:
            crashed = True
    assert crashed and plan.fired[-1] == "LATEST.pre_replace", plan.fired
    steps = []
    for name in ("shard_000/LATEST", "shard_001/LATEST", "SHARDS"):
        with open(SHARD_CKPT_DIR / "ck" / name) as f:
            steps.append(json.load(f)["step"])
    assert steps == [2, 1, 1], steps
    del eng
    torch.cuda.empty_cache()
    # 4: restore into 2 shards and replay the stream with duplicates:
    # each event applied once (shard 1's second half only)
    e2 = sharded(2)
    r["restore_s"] = timed(lambda: e2.restore(ck))
    assert e2.shards[0].watermark > e2.shards[1].watermark
    dups = faults.redelivered(events, seed=7)
    lost = sum(1 for ev in events[half:] if spec.shard_of(ev.user) == 1)

    def replay():
        e2.submit(events)
        e2.submit(dups)
        e2.run_until_drained()

    before = dict(build.launch_counts)
    r["replay_s"] = timed(replay)
    assert_launched(before, ("sparse_row_gather", "sparse_row_scatter"),
                    "replaying into the restored shards")
    assert e2.events_processed == lost, (e2.events_processed, lost)
    assert e2.shards[0].metrics.events_processed == 0
    assert sum(sh.metrics.dedup_skips for sh in e2.shards) == \
        len(events) + len(dups) - lost
    r["replay_events"], r["replay_applied"] = len(events) + len(dups), lost
    r["differ"].append(sharded_parity(e2, single, "torn crash, replay"))
    # 5: the first-half commit resharded into 3 shards, the whole stream
    # submitted: the legacy logs dedup the first half
    e3 = sharded(3)
    r["reshard_s"] = timed(lambda: e3.restore(ck_half))
    res = e3.submit(events)
    r["reshard_pending"] = e3.n_pending
    assert res.deduped == half and e3.n_pending == len(events) - half, \
        (res, e3.n_pending)
    before = dict(build.launch_counts)
    r["reshard_drain_s"] = timed(e3.run_until_drained)
    assert_launched(before, ("sparse_row_gather", "sparse_row_scatter"),
                    "draining the resharded engine")
    assert e3.events_processed == len(events) - half
    r["differ"].append(sharded_parity(e3, single, "2→3 reshard, drain"))
    del e3, single
    torch.cuda.empty_cache()
    # 6: recover_shard(1) from the torn directory (shard 1's commit 1):
    # during the recovery recommend answers from the frozen snapshot,
    # after the thaw as a fresh corpus
    users = requests[-1]
    pre = serve_both(e2, users)
    sh1 = e2.shards[1]
    restore_live, during = sh1.restore, []

    def restore_then_serve(directory):
        restore_live(directory)
        assert sh1.serving_degraded
        during.append(serve_both(e2, users))

    sh1.restore = restore_then_serve
    t0 = time.perf_counter()
    info = e2.recover_shard(1, ck)
    r["recover_s"] = time.perf_counter() - t0
    del sh1.restore
    assert info["source"] == "LATEST" and not sh1.serving_degraded, info
    assert len(during) == 1
    for a, b, what in zip(pre, during[0], ("fp32", "int8")):
        assert np.array_equal(a, b), f"frozen {what} answer moved"
    thawed = serve_both(e2, users)
    fresh = [sh.store.state.materialized_user_vecs() for sh in e2.shards]
    assert all(torch.equal(sh.store.corpus(), c)
               for sh, c in zip(e2.shards, fresh)), "thawed corpora"
    fresh_q = [quantize_int8_rows_pitched(c) for c in fresh]
    want = uncounted(lambda: (
        knn.sharded_recommend_for_users(fresh, users, p.k_neighbors,
                                        p.alpha, TOPN, 2),
        knn.sharded_recommend_for_users_quant(fresh_q, users,
                                              p.k_neighbors, p.alpha,
                                              TOPN, 2)))
    for a, b, what in zip(thawed, want, ("fp32", "int8")):
        assert np.array_equal(a, b.cpu().numpy()), f"thawed {what} answer"
    r["thaw_changed_rows"] = [int((a != b).any(axis=1).sum())
                              for a, b in zip(pre, thawed)]
    del e2, fresh, fresh_q
    torch.cuda.synchronize()
    launches = dict(build.launch_counts)
    for name in ("sparse_row_gather", "sparse_row_scatter", "knn_topk",
                 "knn_topk_dtiled", "blend_topn_rows_quant",
                 "blend_topn_rows"):
        assert launches[name] > 0, \
            f"kernel {name} was not launched on the sharded engine's path"
    # B4 serves one corpus: only the single engine, outside the counts
    assert launches["blend_topn_onehot"] == 0, launches
    shutil.rmtree(SHARD_CKPT_DIR, ignore_errors=True)
    load_rate = len(events) / r["load_s"]
    log(f"sharded engine at TaFeng's full size (2 shards on one card, "
        f"{n_users} users x {p.n_items} items, {len(events)} events): "
        f"launches {launches}")
    log(f"  load {load_rate:.0f} events/s with 2 shards ({r['load_s']:.3f} "
        f"s); a single engine in this phase "
        f"{len(events) / r['single_load_s']:.0f}, phase 4's "
        f"{single_rate:.0f} [{card}]")
    log(f"  requests of 256 users, host clock (ms): fp32 "
        f"{[round(t, 3) for t in r['request_ms']]}, int8 "
        f"{[round(t, 3) for t in r['quant_request_ms']]}; exact class "
        f"fp32 {exact['fp32'][0]}/{exact['fp32'][1]}, int8 "
        f"{exact['int8'][0]}/{exact['int8'][1]} [{card}]")
    log(f"  checkpoint (sync, 2 shards, after {half} events) "
        f"{r['checkpoint_s']:.3f} s, npz {r['npz_bytes']} bytes "
        f"({sum(r['npz_bytes'])} in all) [{card}]")
    log(f"  after the torn crash: restore {r['restore_s']:.3f} s; replay "
        f"{r['replay_events']} events delivered ({r['replay_applied']} "
        f"applied, shard 1's lost half) in {r['replay_s']:.3f} s: "
        f"{r['replay_events'] / r['replay_s']:.0f} delivered events/s, "
        f"{r['replay_applied'] / r['replay_s']:.0f} applied events/s "
        f"[{card}]")
    log(f"  reshard 2→3: restore {r['reshard_s']:.3f} s, "
        f"{r['reshard_pending']} events pending after the whole stream "
        f"(the second half), drained in {r['reshard_drain_s']:.3f} s "
        f"[{card}]")
    log(f"  recover_shard(1) {r['recover_s']:.3f} s: frozen answers "
        f"identical, fp32 and int8; after the thaw "
        f"{r['thaw_changed_rows']} of {len(users)} users' answers changed "
        f"(fp32, int8), equal to a fresh corpus's; users differing from "
        f"the single engine in some bit (load, replay, reshard): "
        f"{r['differ']} [{card}]")
    return launches, r


# ---------------------------------------------------------------------------
# compliance: forget_user on both engines, certify, the overlap's serving
# ---------------------------------------------------------------------------

def forget_set(hist, n_users):
    """N_FORGET users with a non-empty retained history, drawn with a
    seeded generator, the one with the most retained baskets first."""
    live = [u for u in range(n_users) if hist[u]]
    longest = max(live, key=lambda u: len(hist[u]))
    rng = np.random.default_rng(23)
    rest = rng.choice([u for u in live if u != longest], size=N_FORGET - 1,
                      replace=False)
    return [longest] + [int(u) for u in rest]


def forget_all(eng, users, hist, victim):
    """``forget_user`` on each of ``users`` in turn; each receipt clean,
    its deletions the user's retained baskets, its seqnos contiguous
    from the engine's next seqno, the victim's quarantined deletion
    purged.  Returns the receipts and their deletion events."""
    receipts, log_tail = [], []
    for u in users:
        first = eng._next_seqno
        rec = eng.forget_user(u)
        assert rec.clean, (u, rec.residue)
        assert rec.n_baskets_deleted == len(hist[u]), (u, rec)
        assert rec.seqnos == tuple(range(first, first + len(hist[u]))), \
            (u, first, rec.seqnos)
        if u == victim:
            assert rec.purged_dead_letters >= 1, rec
        receipts.append(rec)
        log_tail += [Event(KIND_DEL_BASKET, u, pos=q)
                     for q in range(rec.n_baskets_deleted - 1, -1, -1)]
    return receipts, log_tail


def latency_str(receipts) -> str:
    lat = np.array([r.latency_s for r in receipts])
    slow = receipts[int(np.argmax(lat))]
    return (f"forget_user latency median {np.median(lat) * 1e3:.3f} ms, "
            f"max {lat.max() * 1e3:.3f} ms (user {slow.user}, "
            f"{slow.n_baskets_deleted} deletions); "
            f"{sum(r.n_baskets_deleted for r in receipts)} deletions in all")


def certified(eng, events, forgotten, directory):
    """``certify`` with every ``knn.recommend_for_users`` call it makes
    recorded; returns the report, its seconds and the calls."""
    calls, live = [], knn.recommend_for_users

    def record(corpus, user_ids, k, alpha, topn, **kw):
        ids = live(corpus, user_ids, k=k, alpha=alpha, topn=topn, **kw)
        calls.append(SimpleNamespace(corpus=corpus, users=user_ids, k=k,
                                     alpha=alpha, topn=topn, ids=ids))
        return ids

    knn.recommend_for_users = record
    t0 = time.perf_counter()
    report = certify(eng, events, forgotten_users=forgotten,
                     checkpoint_dir=str(directory))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    knn.recommend_for_users = live
    lines = report.summary().replace("\n", "\n    ")
    log(f"  certify in {seconds:.3f} s: {lines}")
    assert report.compliant, report.summary()
    assert report.envelope_slack <= 0.0, report.envelope_slack
    assert [c.name for c in report.checks][-1] == "checkpoint-round-trip"
    return report, seconds, calls


def overlap_mean(a, b, topn) -> float:
    return float(((a[:, :, None] == b[:, None, :]).any(axis=2).sum(axis=1)
                  / topn).mean())


def hold_serving(call, what):
    """One of certify's serving calls held against the plain route on the
    same rows (in query chunks of PLAIN_CHUNK): exact or
    score-equivalent, 0 mismatches, >= 90% exact.  Returns the plain
    answer."""
    q_n = call.users.shape[0]
    before = dict(build.launch_counts)
    with ops.default_impl("ref"):
        plain = torch.cat([knn.recommend_for_users(
            call.corpus, call.users[i:i + PLAIN_CHUNK], k=call.k,
            alpha=call.alpha, topn=call.topn)
            for i in range(0, q_n, PLAIN_CHUNK)]).cpu().numpy()
    assert build.launch_counts == before, "the plain route launched"
    got = call.ids.cpu().numpy()
    # B3 and B4 at this query count, outside the counted windows
    q = call.corpus[call.users]
    _, nbr = knn_topk.launch(q, call.corpus, call.k, query_gids=call.users)
    t_a = time_ms(lambda: knn_topk.launch(q, call.corpus, call.k,
                                          query_gids=call.users), 3)
    t_b = time_ms(lambda: serving_topn.launch(call.corpus, call.users, nbr,
                                              call.alpha, call.topn), 3)
    del q, nbr
    res: dict = {}
    for i in range(0, q_n, 2048):
        part = knn.compare_recommendations(
            call.corpus, call.users[i:i + 2048].cpu().numpy(),
            plain[i:i + 2048], got[i:i + 2048], k=call.k, alpha=call.alpha,
            rtol=1e-5)
        for key, v in part.items():
            res[key] = res.get(key, 0) + v
    log(f"  {what} ({q_n} users, k={call.k}, top {call.topn}): kernels vs "
        f"plain {res}, {int((got != plain).any(axis=1).sum())} lists "
        f"differ; stage A (B3) {t_a:.4f} ms, stage B (B4) {t_b:.4f} ms")
    assert res["mismatch"] == 0, (what, res)
    assert res["exact"] >= 0.9 * q_n, (what, res)
    return plain


def compliance_path(ds, dev, card):
    """Phase 10: the compliance layer at TaFeng's full size on the card.

    The mixed stream of phases 8-9, each event with its seqno, through a
    single engine (micro-batches of 512) with both serving caches warm
    and one quarantined out-of-range deletion for a victim; ``forget_user``
    on N_FORGET users (counts reset before, read after: B1, B2);
    ``certify`` over the log and the forgets with a checkpoint round trip
    (counts reset before, read after: B3, B4 and no other serving
    kernel), its two serving calls held against the plain route.  Then a
    2-shard engine of the same stream: the same users forgotten through
    the router, 64 new baskets of other users all admitted, ``certify``.
    Returns the phase's launch counts and readings."""
    p = ds.params
    n_users = len(ds.histories)
    cfg, events = mixed_stream(ds)
    hist = retained_histories(events, n_users)
    users = forget_set(hist, n_users)
    victim = users[1]
    poison = Event(KIND_DEL_BASKET, victim, pos=len(hist[victim]) + 1)
    assert poison.pos < cfg.max_baskets
    shutil.rmtree(COMPLIANCE_DIR, ignore_errors=True)
    launches = {name: 0 for name in build.launch_counts}

    def counted(fn):
        build.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        got = dict(build.launch_counts)
        for name, n in got.items():
            launches[name] += n
        return out, got

    r = {}
    # 1: the single engine: load, warm caches, quarantine, forget
    eng = StreamingEngine(StateStore(cfg, device=dev), p, batch_size=512)
    eng.submit(events)
    eng.run_until_drained()
    eng.store.corpus()
    eng.store.quantized_corpus()
    eng.submit([poison])
    eng.run_until_drained()
    assert any(ev.user == victim for ev, _ in eng.dead_letter)
    (receipts, tail), got = counted(
        lambda: forget_all(eng, users, hist, victim))
    assert got["sparse_row_gather"] > 0 and got["sparse_row_scatter"] > 0, \
        got
    assert all({"corpus_absmax", "quant_nonzero"} <= set(x.residue)
               for x in receipts)
    r["receipts"] = receipts
    log(f"compliance at TaFeng's full size ({n_users} users x {p.n_items} "
        f"items, {len(events)} events; {N_FORGET} users forgotten, the "
        f"longest history {len(hist[users[0]])} baskets): forgets' "
        f"launches {got}")
    log(f"  single engine: {latency_str(receipts)} [{card}]")
    # 2: certify the single engine, then its serving calls against plain
    log_all = events + [poison] + tail
    (report, r["certify_s"], calls), got = counted(
        lambda: certified(eng, log_all, users, COMPLIANCE_DIR / "single"))
    assert got["knn_topk"] > 0 and got["blend_topn_onehot"] > 0, got
    for name in ("knn_topk_dtiled", "knn_topk_dtiled_f32",
                 "blend_topn_rows_quant", "blend_topn_rows",
                 "flash_attention"):
        assert got[name] == 0, (name, got)
    n_active = int(np.sum([bool(h) for h in hist])) - N_FORGET
    assert len(calls) == 2 and all(c.users.shape[0] == n_active
                                   for c in calls), \
        [c.users.shape for c in calls]
    log(f"  certify's launches {got}; {n_active} active users served in "
        f"one call a corpus [{card}]")
    plain = [hold_serving(c, f"certify's {what} serving")
             for c, what in zip(calls, ("maintained", "canonical"))]
    topn = calls[0].topn
    r["overlap"] = (overlap_mean(calls[0].ids.cpu().numpy(),
                                 calls[1].ids.cpu().numpy(), topn),
                    overlap_mean(plain[0], plain[1], topn))
    assert r["overlap"][0] == report.overlap_mean
    log(f"  top-{topn} overlap maintained vs canonical: kernels "
        f"{r['overlap'][0]:.6f}, plain {r['overlap'][1]:.6f}; envelope "
        f"slack {report.envelope_slack:.3e}")
    del eng, calls, plain
    torch.cuda.empty_cache()
    # 3: the 2-shard engine: the same stream, the same forgets through
    # the router, later traffic, certify
    t0 = time.perf_counter()
    sh = ShardedStreamingEngine.create(
        UserShardSpec(n_users, 2), p, cfg.max_baskets, cfg.max_basket_size,
        devices=make_user_shard_devices(2), batch_size=512)
    sh.submit(events)
    sh.run_until_drained()
    for s in sh.shards:
        s.store.corpus()
        s.store.quantized_corpus()
    sh.submit([poison])
    sh.run_until_drained()
    r["shard_load_s"] = time.perf_counter() - t0
    (s_receipts, s_tail), got = counted(
        lambda: forget_all(sh, users, hist, victim))
    assert got["sparse_row_gather"] > 0 and got["sparse_row_scatter"] > 0, \
        got
    r["shard_receipts"] = s_receipts
    log(f"  2 shards: {latency_str(s_receipts)}; forgets' launches {got} "
        f"[{card}]")
    keep = sorted(set(range(n_users)) - set(users))
    rng = np.random.default_rng(29)
    more = [Event(KIND_ADD_BASKET, int(u), items=rng.choice(
        p.n_items, size=int(rng.integers(1, 6)), replace=False))
        for u in rng.choice(keep, size=64, replace=False)]
    res = sh.submit(more)
    assert res.admitted == 64 and res.deduped == 0, res
    sh.run_until_drained()
    (s_report, r["shard_certify_s"], calls), got = counted(
        lambda: certified(sh, events + [poison] + s_tail + more, users,
                          COMPLIANCE_DIR / "sharded"))
    assert got["knn_topk"] > 0 and got["blend_topn_onehot"] > 0, got
    assert len(calls) == 2
    for s in range(2):
        assert (COMPLIANCE_DIR / "sharded" / f"shard_{s:03d}"
                / "LATEST").exists()
    log(f"  2 shards: certify's launches {got}; 64 later baskets admitted "
        f"({res}); top-{topn} overlap {s_report.overlap_mean:.6f}")
    del sh, calls
    torch.cuda.empty_cache()
    shutil.rmtree(COMPLIANCE_DIR, ignore_errors=True)
    log(f"  certify: single engine {r['certify_s']:.3f} s, 2 shards "
        f"{r['shard_certify_s']:.3f} s (each with a commit and its read); "
        f"the 2-shard load {r['shard_load_s']:.3f} s [{card}]")
    return launches, r


BF16, F32 = torch.bfloat16, torch.float32
# flash_attention.plan_flash's designs
WGMMA, MMA, CORES = "tma_wgmma", "mma_sync", "cuda_cores"
FLASH_EDGES = (
    # B, S, H, KV, D, window, dtype, causal, the design plan_flash picks
    (2, 200, 4, 4, 64, 0, F32, True, CORES),     # S % 64 != 0, KV == H
    (1, 333, 8, 2, 128, 0, BF16, True, WGMMA),   # KV < H, D = 128
    (2, 256, 4, 1, 64, 48, BF16, True, WGMMA),   # window
    (1, 130, 2, 2, 32, 17, F32, True, CORES),    # D = 32, window
    (2, 190, 8, 2, 32, 0, BF16, True, MMA),      # D = 32 in bf16
    (1, 96, 4, 2, 256, 0, BF16, True, CORES),    # D = 256
    (1, 72, 4, 4, 96, 0, BF16, True, CORES),     # D = 96
    (1, 100, 4, 4, 192, 0, BF16, True, CORES),   # D = 192 (MLA's Q/K)
    (2, 1, 2, 1, 64, 0, F32, True, CORES),       # one token
    (2, 1, 2, 1, 64, 0, BF16, True, WGMMA),
    (1, 100, 2, 2, 64, 0, F32, False, CORES),    # no causal mask
    (1, 64, 4, 4, 128, 30, BF16, False, WGMMA),  # window, no causal
    (1, 160, 8, 8, 128, 0, F32, True, CORES),    # D = 128 in f32
    # the Hopper design's 128-query / 128-key tiles at their edges
    (2, 1, 4, 2, 128, 0, BF16, True, WGMMA),     # S = 1, D = 128
    (1, 127, 4, 4, 64, 0, BF16, True, WGMMA),    # S = 127, KV == H
    (2, 128, 8, 2, 64, 0, BF16, True, WGMMA),    # S = 128
    (1, 129, 4, 1, 128, 0, BF16, True, WGMMA),   # S = 129, KV < H
    (2, 257, 4, 2, 64, 100, BF16, True, WGMMA),  # window ends in a tile
    (1, 257, 4, 4, 128, 129, BF16, True, WGMMA),  # window across an edge
    (1, 300, 2, 2, 128, 1000, BF16, True, WGMMA),  # window wider than S
    (1, 257, 4, 2, 64, 0, BF16, False, WGMMA),   # no causal mask
    (1, 200, 2, 1, 128, 70, BF16, False, WGMMA),  # no causal, window
    (1, 191, 4, 2, 64, 0, BF16, True, WGMMA),    # one 192-row item, partial
    (2, 193, 4, 4, 64, 150, BF16, True, WGMMA),  # an item of one row
    (1, 385, 2, 1, 64, 0, BF16, False, WGMMA),   # 192-row items, no causal
)
# the JAX package's own kernel-vs-oracle bounds (tests/test_kernels.py:206,
# :219)
FLASH_ATOL = {torch.float32: 2e-3, torch.bfloat16: 3e-2}
# the same check scaled to the output's size, in bf16 ulps (2^-7 relative
# step): the error's rms within 1 ulp of the output's rms, and no
# (batch, query, head) row off by more than 2 ulps of its largest output
FLASH_RMS_RATIO = 2.0 ** -7
FLASH_ROW_RATIO = 2.0 ** -6


def flash_check(q, k, v, what, design, causal=True, window=0,
                ulp_floor=False):
    """The attention kernel against its plain version, on the design
    ``flash_attention.plan_flash`` picks, which must be ``design``; a V
    narrower than Q (MLA's) goes to the kernel zero-padded to Q's width,
    as ``transformer.attend_padded_v`` sends it, and to the plain version
    unpadded, so the padding itself is checked.  Max |err| is held to
    the JAX package's bound for the dtype, set for N(0, 1) inputs whose
    outputs stay below 4; with ``ulp_floor`` (a model's activations,
    which reach further) to one bf16 rounding step of the largest output
    where that is more.  Returns (kernel, plain)."""
    dv = v.shape[-1]
    vk = transformer.pad_v(q, v)
    plan = flash_attention.plan_flash(q, k, vk, window, causal)
    assert plan.design == design, (what, plan)
    exp = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    got = flash_attention.launch(q, k, vk, causal=causal,
                                 window=window)[..., :dv]
    torch.cuda.synchronize()
    err = float((got.float() - exp.float()).abs().max())
    assert got.shape == q.shape[:3] + (dv,) and got.dtype == q.dtype, what
    atol = FLASH_ATOL[q.dtype]
    if ulp_floor:
        top = float(exp.float().abs().max())
        atol = max(atol, 2.0 ** (np.floor(np.log2(top)) - 7))
    assert err <= atol, (what, err, atol)
    return got, exp


def check_flash_edges(dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    worst: dict = {}

    def note(design, got, exp):
        err = float((got.float() - exp.float()).abs().max())
        worst[design] = max(worst.get(design, 0.0), err)

    for b, s, h, kv, d, win, dt, causal, design in FLASH_EDGES:
        q, k, v = (torch.randn((b, s, n, d), generator=gen, device=dev
                               ).to(dt) for n in (h, kv, kv))
        note(design, *flash_check(q, k, v, (b, s, h, kv, d, win, dt),
                                  design, causal, win))
    for dt, design in ((F32, CORES), (BF16, WGMMA)):
        # strided heads: every other head of a wider buffer
        wide = torch.randn((2, 77, 8, 64), generator=gen, device=dev).to(dt)
        note(design, *flash_check(wide[:, :, ::2], wide[:, :, 1::4],
                                  wide[:, :, 3::4], ("strided heads", dt),
                                  design))
        # rows starting 2 bytes past a 16-byte boundary: bf16 D = 64 that
        # the tensor-core designs do not take
        pad = torch.randn((2, 90, 4, 72), generator=gen, device=dev).to(dt)
        note(CORES, *flash_check(pad[:, :, :, 1:65], pad[:, :, :2, 3:67],
                                 pad[:, :, 2:, 5:69], ("unaligned rows", dt),
                                 CORES))
    # strided heads at D = 128: q, k and v slices of one buffer's heads
    wide = torch.randn((1, 130, 6, 128), generator=gen, device=dev).to(BF16)
    note(WGMMA, *flash_check(wide[:, :, :4], wide[:, :, 4:5], wide[:, :, 5:],
                             ("strided heads, D = 128", BF16), WGMMA, True,
                             40))
    assert set(worst) == {WGMMA, MMA, CORES}, worst
    log(f"  flash_attention edge cases ({len(FLASH_EDGES) + 5}: S 1, 127, "
        "128, 129, 191, 193, 257, 385 and off the 64-row tile, windows "
        "inside a tile, "
        "across an edge and wider than S, KV == H and KV < H, D 32/64/96/"
        "128/192/256, no causal mask, strided heads, unaligned rows), max |err|"
        " by design: " + ", ".join(f"{k} {e}" for k, e in worst.items()))


def attention_flops(b, s, h, d, dv=None, window=0):
    """2·D flops for QKᵀ and 2·Dv for P·V per unmasked (query, key) pair
    of causal attention: S(S+1)/2 pairs per (batch, head), or with a
    window w < S, w(w+1)/2 + (S - w)·w."""
    w = window if 0 < window < s else s
    pairs = w * (w + 1) / 2 + (s - w) * w
    return 2.0 * (d + (d if dv is None else dv)) * b * h * pairs


# the profiler's name of each design's kernel
FLASH_KERNEL_NAMES = {WGMMA: "flash_wgmma_kernel", MMA: "flash_mma_kernel",
                      CORES: "flash_kernel"}


def lm_attention_check(c, model, tokens, design, what) -> dict:
    """Layer 0's prefill attention of ``model`` on ``tokens``, as the
    prefill computes it (MLA: V zero-padded for the kernel, the plain
    version and SDPA on the unpadded V): the kernel against its plain
    version by max |err| and by error over the output's size, timed by
    events, the profiler, a burst of 10 and the host clock beside the
    plain version and SDPA.  Returns the kernel's record."""
    layer0 = model.layers[0]
    x = model.embed[tokens].to(c.dtype) * (c.d_model ** 0.5)
    pos = torch.arange(tokens.shape[1], device=tokens.device
                       ).expand(tokens.shape)
    qkv = transformer.mla_qkv if c.mla else transformer.project_qkv
    q, k, v = qkv(transformer.rms_norm(x, layer0.ln1, c.norm_eps), layer0,
                  c, pos)
    del x
    vk = transformer.pad_v(q, v)
    # layer 0's window, as the prefill passes it (gemma3's 1,024)
    win = transformer.kernel_window(model.groups()[0][2][0])
    got, exp = flash_check(q, k, v, f"{what} layer 0", design, window=win,
                           ulp_floor=True)
    # the error against the output's own size: most rows average
    # thousands of keys and are far smaller than the atol
    diff, size = (got.float() - exp.float()).abs(), exp.float().abs()
    err = float(diff.max())
    rms_ratio = float(diff.square().mean().sqrt() / size.square().mean()
                      .sqrt())
    row_ratio = float((diff.amax(-1) / size.amax(-1)).max())
    out_rms, out_max = float(size.square().mean().sqrt()), float(size.max())
    assert rms_ratio <= FLASH_RMS_RATIO and row_ratio <= FLASH_ROW_RATIO, \
        (f"{what} layer 0 relative error", rms_ratio, row_ratio)
    del got, exp, diff, size
    # the yardstick reads K/V repeated over each group of query heads
    b, s, h, d = q.shape
    group = h // k.shape[2]
    qt, kt, vt = (t.transpose(1, 2) for t in (
        q, k.repeat_interleave(group, 2), v.repeat_interleave(group, 2)))
    lib = torch.nn.functional.scaled_dot_product_attention
    mask = None
    if win:
        i = torch.arange(s, device=q.device)
        mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - win)
    t = dict(
        ms=time_ms(lambda: flash_attention.launch(q, k, vk, window=win)),
        plain_ms=time_ms(lambda: ref.flash_attention_ref(q, k, v,
                                                         window=win)),
        library_ms=time_ms(lambda: lib(qt, kt, vt, attn_mask=mask,
                                       is_causal=mask is None)))
    # q, k and v read once, an output of q's rows and v's width written
    # once
    io_bytes = sum(a.numel() * a.element_size() for a in (q, k, v)) \
        + b * s * h * v.shape[-1] * v.element_size()
    flops = attention_flops(b, s, h, d, v.shape[-1], win)
    # the event time of one call holds the wrapper's host time and the
    # launch's latency; beside it: the profiler's time of the kernel
    # alone (over the records the trace holds), the time a call of 10
    # back to back between two events, and the host time of a call,
    # enqueued behind a busy card
    reps = 5
    prof = device_ms(lambda: flash_attention.launch(q, k, vk, window=win),
                     (FLASH_KERNEL_NAMES[design],), reps, required=False)
    own, every, n_rec = prof or (float("nan"), float("nan"), 0)
    own *= reps / max(n_rec, 1)          # per launch the trace recorded
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(10):
        flash_attention.launch(q, k, vk, window=win)
    host_ms = (time.perf_counter() - h0) * 1e2
    end.record()
    end.synchronize()
    burst_ms = start.elapsed_time(end) / 10
    pad = f" (V {v.shape[-1]} padded to {d})" if v.shape[-1] < d else ""
    rec = dict(
        t, max_abs_err=err, device_ms=own, burst_ms=burst_ms,
        host_ms=host_ms,
        shape=f"B={b} S={s} H={h} KV={k.shape[2]} D={d}{pad} bf16 causal"
              + (f" window {win}" if win else ""),
        bound=bound(io_bytes, flops, PEAK_BF16))
    log(f"  layer 0 prefill attention {rec['shape']}:"
        f" kernel vs plain max |err| {err} (bound 3e-2, or one bf16 step "
        f"of the largest output, {out_max}, where more); output rms "
        f"{out_rms}, error rms / output rms {rms_ratio} (bound "
        f"{FLASH_RMS_RATIO}), worst row's max |err| / its max |out| "
        f"{row_ratio} (bound {FLASH_ROW_RATIO}); {t['ms']:.4f} ms, "
        f"{flops / t['ms'] / 1e9:.1f} TFLOP/s; {burst_ms:.4f} ms a call of "
        f"10 back to back; profiler device time {own:.4f} ms a launch "
        f"({flops / own / 1e9:.1f} TFLOP/s; {n_rec} of {reps} launches "
        f"in the trace, {every:.4f} ms a call in all kernels over {reps} "
        f"calls); host time {host_ms:.4f} ms a call; plain "
        f"{t['plain_ms']:.4f} ms, SDPA {t['library_ms']:.4f} ms, bound "
        f"{rec['bound'][0]:.4f} ms ({rec['bound'][1]}); plan "
        f"{flash_attention.plan_flash(q, k, vk, win)}")
    return rec


def lm_serve(model, tokens, max_len):
    """The prompts ``tokens`` prefilled, then ``LM_DECODE`` greedy steps:
    (the prefill's last-position logits, the greedy tokens [B, 1 +
    steps], prefill seconds, seconds per decode step), host clock ended
    by ``torch.cuda.synchronize``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = model.prefill(tokens, max_len)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    first = logits
    tok = torch.argmax(logits, dim=-1)[:, None]
    out = [tok]
    for i in range(LM_DECODE):
        logits, caches = model.decode_step(caches, tok, tokens.shape[1] + i)
        tok = torch.argmax(logits, dim=-1)[:, None]
        out.append(tok)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    del caches
    return first, torch.cat(out, dim=1), t1 - t0, (t2 - t1) / LM_DECODE


@contextlib.contextmanager
def last_moe_routing(model, out: dict):
    """While open, ``out["experts"]`` holds the top-k experts [T, k] that
    ``model``'s last MoE layer chose for the last prefill's tokens
    (``transformer.route`` wrapped; the model itself unchanged)."""
    router = model.layers[-1].router
    route = transformer.route

    def recorded(xf, r, c):
        gates, experts = route(xf, r, c)
        if r is router and xf.shape[0] > LM_BATCH:
            out["experts"] = experts
        return gates, experts
    transformer.route = recorded
    try:
        yield out
    finally:
        transformer.route = route


def lm_path(name, c, seed, design, dev, card) -> tuple:
    """One LM at ``c``'s widths serving 4 prompts of 4,096 tokens and 16
    greedy decode steps, once with the kernels (counts reset before, read
    after: B9 once per layer and nothing else) and once with the plain
    versions (no launch), held by the logit gate against an f32 run of
    the same (bf16-valued) weights, rebuilt from the seed after the bf16
    model is freed; layer 0's prefill attention checked and timed first,
    and for an MoE model the last MoE layer's prefill routing compared
    between the two runs.  Returns (launches, layer 0's attention
    record)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = transformer.init_params(c, gen, dev)
    # serving: the trainable weights frozen, so no call records a graph
    model.requires_grad_(False)
    torch.cuda.synchronize()
    n_stored = sum(t.numel() for t in model.parameters())
    n_bytes = sum(t.numel() * t.element_size() for t in model.parameters())
    log(f"{name}: {n_stored} parameters stored, {c.n_params()} by the JAX "
        f"package's count ({c.n_active_params()} active a token; "
        f"{n_bytes / 1e9:.2f} GB bf16), {c.n_layers} layers, made from a "
        f"seeded generator in {time.perf_counter() - t0:.1f} s")
    tokens = torch.randint(0, c.vocab_size, (LM_BATCH, LM_PROMPT),
                           generator=gen, device=dev)
    max_len = LM_PROMPT + LM_DECODE
    rec = lm_attention_check(c, model, tokens, design, name)

    routing = ({}, {})
    build.reset_launch_counts()
    with (last_moe_routing(model, routing[0]) if c.moe
          else contextlib.nullcontext()):
        k_logits, k_toks, k_pre, k_dec = lm_serve(model, tokens, max_len)
    launches = dict(build.launch_counts)
    assert launches["flash_attention"] == c.n_layers, launches
    assert sum(launches.values()) == c.n_layers, launches
    build.reset_launch_counts()
    with ops.default_impl("ref"), (last_moe_routing(model, routing[1])
                                   if c.moe else contextlib.nullcontext()):
        p_logits, p_toks, p_pre, p_dec = lm_serve(model, tokens, max_len)
    assert not any(build.launch_counts.values()), build.launch_counts
    for lg in (k_logits, p_logits):
        assert lg.shape == (LM_BATCH, c.vocab_size) and \
            bool(torch.isfinite(lg).all()), f"{name} logits"
    same = (k_toks == p_toks).cpu().numpy()
    agree = [int(np.argmin(r)) if not r.all() else len(r) for r in same]
    log(f"  {name} serving, {LM_BATCH} x {LM_PROMPT} prompt tokens + "
        f"{LM_DECODE} greedy steps: prefill {LM_BATCH * LM_PROMPT / k_pre:.0f}"
        f" tokens/s with the kernels ({k_pre * 1e3:.1f} ms), "
        f"{LM_BATCH * LM_PROMPT / p_pre:.0f} with the plain versions "
        f"({p_pre * 1e3:.1f} ms); decode {k_dec * 1e3:.3f} ms per step "
        f"(plain {p_dec * 1e3:.3f}); launches {launches}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB in bf16 "
        f"[{card}]")
    if c.moe:
        ke, pe = routing[0]["experts"], routing[1]["experts"]
        assert ke.shape == pe.shape == (LM_BATCH * LM_PROMPT, c.top_k)
        slots = int((ke != pe).sum())
        sets = int((ke.sort(-1).values != pe.sort(-1).values).any(-1).sum())
        log(f"  routing of the last MoE layer's prefill, kernels vs plain: "
            f"{slots} of {ke.numel()} (token, k) choices differ, {sets} of "
            f"{ke.shape[0]} tokens with another expert set")
    profile_serving(model, tokens, max_len)

    # the precision yardstick: the same (bf16-valued) weights in f32,
    # prefilled with the plain versions only, against which both bf16
    # runs err; built from the seed after the bf16 model is freed (an
    # f32 copy beside it does not fit for the MoE models)
    del model
    torch.cuda.empty_cache()
    gen.manual_seed(seed)
    model32 = transformer.init_params(dataclasses.replace(
        c, dtype=torch.float32), gen, dev)
    model32.requires_grad_(False)
    for p in model32.parameters():
        for slab in (p if p.dim() == 3 else [p]):
            slab.copy_(slab.to(torch.bfloat16))
    build.reset_launch_counts()
    with ops.default_impl("ref"):
        f_logits, _ = model32.prefill(tokens, max_len)
    assert not any(build.launch_counts.values()), build.launch_counts
    del model32
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())
    rel_kp, rel_k32, rel_p32 = (rel(k_logits, p_logits),
                                rel(k_logits, f_logits),
                                rel(p_logits, f_logits))
    log(f"  last-position logits, max |diff| / max |logit|: kernels vs plain"
        f" {rel_kp:.3e}; bf16 vs the f32 run of the same weights: kernels "
        f"{rel_k32:.3e}, plain {rel_p32:.3e} (bound on kernels vs plain: "
        f"{LM_LOGIT_BOUND} x the plain run's, {LM_LOGIT_BOUND * rel_p32:.3e});"
        f" greedy tokens equal in {int(same.sum())} of {same.size}, each "
        f"prompt's first {agree} of {LM_DECODE + 1} the same; peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB with the f32 "
        f"run")
    assert rel_kp <= LM_LOGIT_BOUND * rel_p32, (f"{name} logits", rel_kp,
                                                 rel_p32)
    return launches, rec


def granite_path(dev, records, card):
    """Phase 12: granite-3-2b at full width and depth through
    ``lm_path``; its layer 0's attention is B9's record in the JSON
    line."""
    launches, records["flash_attention"] = lm_path(
        "granite-3-2b", granite_3_2b.make_config(), 5, WGMMA, dev, card)
    return launches


def lm_zoo():
    """Phase 15's models: (name, config, seed, B9's design at layer 0),
    each at its published widths; deepseek, gemma3 and Command R+ cut in
    depth so that the bf16 weights, and after them the f32 yardstick's,
    fit one 80 GB card."""
    return (
        ("qwen2-moe-a2.7b", qwen2_moe_a2_7b.make_config(), 6, WGMMA),
        # 1 dense + 1 MoE layer: MLA and both layer groups
        ("deepseek-v3-671b", dataclasses.replace(
            deepseek_v3_671b.make_config(), n_layers=2,
            first_dense_layers=1), 7, CORES),
        # 5 local layers and 1 global: the 5:1 window pattern
        ("gemma3-27b", dataclasses.replace(gemma3_27b.make_config(),
                                           n_layers=6), 8, WGMMA),
        ("command-r-plus-104b", dataclasses.replace(
            command_r_plus_104b.make_config(), n_layers=2), 9, WGMMA),
    )


def lm_zoo_path(dev, card) -> tuple:
    """Phase 15: qwen2-moe-a2.7b, deepseek-v3-671b, gemma3-27b and
    command-r-plus-104b serving through ``lm_path``, one model on the
    card at a time.  Returns (launches summed over the four kernel runs,
    {model: layer 0's attention record})."""
    total = dict.fromkeys(build.launch_counts, 0)
    recs = {}
    for name, c, seed, design in lm_zoo():
        t0 = time.perf_counter()
        launches, recs[name] = lm_path(name, c, seed, design, dev, card)
        for k, n in launches.items():
            total[k] += n
        torch.cuda.empty_cache()
        log(f"  {name}: {time.perf_counter() - t0:.1f} s")
    return total, recs


def profiled(fn) -> tuple:
    """One call of ``fn`` under ``torch.profiler``: the host-clock ms
    (ended by ``torch.cuda.synchronize``), the device ms, and (ms,
    count, name) of each kernel, the largest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # ranges on the device timeline (``Optimizer.step#AdamW.step``) hold
    # kernels counted on their own
    notes = {e.name for e in prof.events()
             if getattr(e, "is_user_annotation", False)}
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.key in notes:
            continue
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    return wall, sum(r[0] for r in rows), rows


def profile_serving(model, tokens, max_len):
    """Where a prefill's and a decode step's device time goes: one more
    run of each under ``torch.profiler``, summed by kernel name."""
    caches = model.prefill(tokens[:, :64], max_len)[1]
    for what, fn in (
            ("prefill", lambda: model.prefill(tokens, max_len)),
            ("decode step", lambda: model.decode_step(
                caches, tokens[:, 64:65], 64))):
        wall, total, rows = profiled(fn)
        log(f"  profile of one {what}: {wall:.1f} ms on the host clock, "
            f"{total:.1f} ms of device time ({100 * total / wall:.0f}% busy)"
            f"; by kernel: " + "; ".join(
                f"{ms:.1f} ms x{n} {name[:60]}" for ms, n, name in rows[:6]))


# ---------------------------------------------------------------------------
# recommender serving: two-tower, BERT4Rec, DeepFM and DLRM at their
# published widths, retrieval through B3 (dot)
# ---------------------------------------------------------------------------

def hold_topk(q, c, got, want, what) -> None:
    """B3's (values, ids) against its plain version's on the same card:
    values within ``RS_RTOL``/``RS_ATOL``, and each query's ids by the
    parity rule -- identical, or score-equivalent (the float64 scores of
    both lists agree rank by rank within ``RS_RTOL`` and the ids are
    distinct); 0 mismatches and >= 90% identical.  Logs the counts and
    the largest value difference."""
    (vk, ik), (vp, ip) = got, want
    err = float((vk - vp).abs().max())
    assert torch.allclose(vk, vp, rtol=RS_RTOL, atol=RS_ATOL), (what, err)
    s = q.double() @ c.double().T
    sk, sp = s.gather(1, ik.long()), s.gather(1, ip.long())
    close = (sk - sp).abs() <= RS_RTOL * torch.maximum(sk.abs(), sp.abs())
    distinct = torch.tensor([len(set(r)) == ik.shape[1]
                             for r in ik.tolist()], device=q.device)
    same = torch.all(ik == ip, dim=1)
    equiv = ~same & torch.all(close, dim=1) & distinct
    out = dict(identical=int(same.sum()), equivalent=int(equiv.sum()),
               mismatch=int((~(same | equiv)).sum()), max_abs_err=err)
    assert out["mismatch"] == 0 and out["identical"] >= 0.9 * q.shape[0], \
        (what, out)
    assert int(ik.min()) >= 0 and int(ik.max()) < c.shape[0], what
    log(f"  {what}: {out}")


def counted(fn, tally):
    """``fn()`` with the launch counts set to 0 just before and added to
    ``tally`` just after."""
    build.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    for name, n in build.launch_counts.items():
        tally[name] = tally.get(name, 0) + n
    return out


def serve_timed(fn, tally, reps: int = 3):
    """Latency of one serving call on the host clock (ended by
    ``torch.cuda.synchronize``): the first call (counted in ``tally``)
    and the median of ``reps`` more (the first alone for ``reps=0``),
    with the peak device memory over them.  Returns (output, first s,
    median s, peak bytes)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = counted(fn, tally)
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return out, first, float(np.median(times or [first])), \
        torch.cuda.max_memory_allocated()


def model_bytes(model) -> int:
    return sum(p.numel() * p.element_size() for p in model.parameters())


def log_serving(what, n, first, median, peak, params, reps=3):
    how = (f"median of {reps}; first call {first * 1e3:.3f}" if reps
           else "one call")
    log(f"  {what} B={n}: {median * 1e3:.3f} ms ({how}), "
        f"{n / median:.0f} rows/s, peak {peak / 1e9:.2f} GB "
        f"({params / 1e9:.2f} GB of parameters)")


def smoke_parity(dev):
    """Each model at its ``smoke_config()`` on the card against the same
    weights and batch on the CPU (the plain path the CPU tests hold to
    the JAX package): rtol=1e-5, atol=1e-5."""
    for name, mod, cfg, make in (
            ("two-tower", two_tower, two_tower_retrieval,
             recsys_shapes.two_tower_batch),
            ("DLRM", dlrm, dlrm_mlperf, recsys_shapes.dlrm_batch),
            ("DeepFM", deepfm, deepfm_cfg, recsys_shapes.deepfm_batch),
            ("BERT4Rec", bert4rec, bert4rec_cfg,
             recsys_shapes.bert4rec_batch)):
        c = cfg.smoke_config()
        gen = torch.Generator().manual_seed(8)
        cpu = mod.init_params(c, gen, "cpu")
        batch = make(c, 64, gen)
        card = copy.deepcopy(cpu).to(dev)
        want = mod.serve_step(cpu, batch, c)
        got = mod.serve_step(card, {k: v.to(dev) for k, v in batch.items()},
                             c)
        if isinstance(want, tuple):              # BERT4Rec's top n
            # the card's ids score (on the CPU) what the CPU's list holds
            x = bert4rec.encoder(cpu, batch["ids"], c)[:, -1, :]
            full = x @ cpu.item_emb.T + cpu.out_bias
            assert torch.allclose(full.gather(1, got[1].cpu().long()),
                                  want[0], rtol=1e-5, atol=1e-5), name
            got, want = got[0], want[0]
        assert torch.allclose(got.cpu(), want, rtol=1e-5, atol=1e-5), \
            (name, float((got.cpu() - want).abs().max()))
    log("  smoke configs on the card against the CPU: all four serve_steps "
        "allclose (rtol=1e-5, atol=1e-5)")


def check_b3_widths(dev, gen):
    """B3 (dot) against its plain version at the recommender widths and
    one that is no multiple of the kernel's 32-float chunk, 200,000 unit
    rows, Q of 1 and 64, k=100."""
    for d in (64, 80, 256):
        c = recsys_shapes.unit_rows(gen, 200_000, d)
        for q_n in (1, 64):
            q = recsys_shapes.unit_rows(gen, q_n, d)
            got = knn_topk.launch(q, c, RETRIEVAL_TOP_N, metric="dot")
            want = ref.knn_topk_ref(q, c, RETRIEVAL_TOP_N, metric="dot")
            hold_topk(q, c, got, want, f"B3 dot D={d} Q={q_n} M=200000 "
                                       f"k=100")


@torch.no_grad()
def recsys_path(dev, card):
    """Phase 13: the recommender models at their published widths with
    seeded weights.  Two-tower (``TwoTowerConfig()``): ``serve_step`` at
    512 and 262,144 pairs, the index build (``item_tower`` over
    1,000,000 items) and ``retrieval_step`` (1 query against them, top
    100, B3).  BERT4Rec (vocab 1,000,448): ``serve_step`` at 512 and
    262,144 users, top 20, and ``retrieval_step`` against 1,000,000
    candidates (B3).  DeepFM: ``serve_step`` at 512 and 262,144.  DLRM
    with each vocabulary capped at 2^24 rows: ``serve_step`` at 512 and
    262,144.  Then the retrieval example's shape (64 queries against
    200,000 candidates, D = 64, B3).  Every serving call is counted
    (counts set to 0 just before, read just after; only the retrievals
    launch, B3 each); B3's answers are held against its plain version
    and timed afterwards.  Returns the counts."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    tally: dict = {}
    rs = recsys_shapes
    log(f"recommender serving: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        f"allocated at the start")
    smoke_parity(dev)
    check_b3_widths(dev, gen)

    # two-tower at its published widths
    c = two_tower_retrieval.make_config()
    t0 = time.perf_counter()
    model = two_tower.init_params(c, gen, dev)
    torch.cuda.synchronize()
    params = model_bytes(model)
    log(f"two-tower: {c.n_params()} parameters ({params / 1e9:.2f} GB) "
        f"made in {time.perf_counter() - t0:.1f} s")
    for n in (rs.SERVE_P99, rs.SERVE_BULK):
        batch = rs.two_tower_batch(c, n, gen)
        out, first, med, peak = serve_timed(
            lambda: two_tower.serve_step(model, batch, c), tally)
        assert out.shape == (n,) and bool(torch.isfinite(out).all())
        assert float(out.abs().max()) <= 1.0 + 1e-5     # unit vectors
        log_serving("two-tower serve_step", n, first, med, peak, params)
        del batch, out
    items = rs.two_tower_items(c, rs.N_CANDIDATES, gen)
    cand, first, med, peak = serve_timed(
        lambda: two_tower.item_tower(model, items, c), tally)
    assert cand.shape == (rs.N_CANDIDATES, c.tower_mlp[-1])
    assert torch.allclose(torch.linalg.norm(cand, dim=-1),
                          torch.ones(1, device=dev), atol=1e-5)
    log_serving("two-tower index build (item_tower)", rs.N_CANDIDATES,
                first, med, peak, params)
    user = rs.two_tower_batch(c, 1, gen)
    batch = {"user_id": user["user_id"], "history": user["history"],
             "candidates": cand}
    got, first, med, peak = serve_timed(
        lambda: two_tower.retrieval_step(model, batch, c,
                                         top_n=RETRIEVAL_TOP_N), tally)
    log_serving("two-tower retrieval_step (1 query, top 100)", 1, first, med,
                peak, params)
    eu = two_tower.user_tower(model, batch, c)
    hold_topk(eu, cand, got, ref.knn_topk_ref(eu, cand, RETRIEVAL_TOP_N,
                                              metric="dot"),
              "two-tower retrieval")
    b3_timed(eu, cand, RETRIEVAL_TOP_N, "two-tower retrieval_cand", "dot")
    del model, items, cand, batch, eu, got
    torch.cuda.empty_cache()

    # BERT4Rec at its published widths
    c = bert4rec_cfg.make_config()
    model = bert4rec.init_params(c, gen, dev)
    params = model_bytes(model)
    scored = c.vocab // 65536 * 65536
    for n, reps in ((rs.SERVE_P99, 3), (rs.SERVE_BULK, 0)):
        batch = rs.bert4rec_batch(c, n, gen)
        (vals, ids), first, med, peak = serve_timed(
            lambda: bert4rec.serve_step(model, batch, c, top_n=BERT_TOP_N),
            tally, reps)
        assert vals.shape == ids.shape == (n, BERT_TOP_N)
        assert bool(torch.isfinite(vals).all())
        assert int(ids.min()) >= 0 and int(ids.max()) < scored
        # the first 16 users against one full product over the scored rows
        x = bert4rec.encoder(model, batch["ids"][:16], c)[:, -1, :]
        full = x @ model.item_emb[:scored].T + model.out_bias[:scored]
        pv, _ = ref.topk_lowest_index(full, BERT_TOP_N)
        assert torch.allclose(vals[:16], pv, rtol=RS_RTOL, atol=1e-5)
        assert torch.allclose(full.gather(1, ids[:16].long()), pv,
                              rtol=RS_RTOL, atol=1e-5)
        log_serving(f"BERT4Rec serve_step (top {BERT_TOP_N}, rows "
                    f"{scored:,}+ never scored)", n, first, med, peak,
                    params, reps)
        del batch, vals, ids, x, full
    rbatch = rs.bert4rec_retrieval_batch(c, gen)
    got, first, med, peak = serve_timed(
        lambda: bert4rec.retrieval_step(model, rbatch, c,
                                        top_n=RETRIEVAL_TOP_N), tally)
    log_serving("BERT4Rec retrieval_step (1 query, top 100)", 1, first,
                med, peak, params)
    q = bert4rec.encoder(model, rbatch["ids"], c)[:, -1, :].contiguous()
    cand = rbatch["candidates"]
    hold_topk(q, cand, got, ref.knn_topk_ref(q, cand, RETRIEVAL_TOP_N,
                                             metric="dot"),
              "BERT4Rec retrieval")
    b3_timed(q, cand, RETRIEVAL_TOP_N, "BERT4Rec retrieval_cand", "dot")
    del model, rbatch, q, cand, got
    torch.cuda.empty_cache()

    # DeepFM and DLRM (vocabularies capped at 2^24 rows)
    for name, mod, c, make in (
            ("DeepFM", deepfm, deepfm_cfg.make_config(),
             rs.deepfm_batch),
            ("DLRM", dlrm, dataclasses.replace(
                dlrm_mlperf.make_config(),
                vocab_sizes=tuple(min(v, DLRM_VOCAB_CAP) for v in
                                  dlrm.CRITEO_1TB_VOCABS)),
             rs.dlrm_batch)):
        t0 = time.perf_counter()
        model = mod.init_params(c, gen, dev)
        torch.cuda.synchronize()
        params = model_bytes(model)
        log(f"{name}: {params / 1e9:.2f} GB of parameters "
            f"({c.table.total_rows} table rows) made in "
            f"{time.perf_counter() - t0:.1f} s")
        for n in (rs.SERVE_P99, rs.SERVE_BULK):
            batch = make(c, n, gen)
            out, first, med, peak = serve_timed(
                lambda: mod.serve_step(model, batch, c), tally)
            assert out.shape == (n,) and bool(torch.isfinite(out).all())
            assert float(out.min()) >= 0.0 and float(out.max()) <= 1.0
            log_serving(f"{name} serve_step", n, first, med, peak, params)
            del batch, out
        del model
        torch.cuda.empty_cache()

    # the retrieval example's shape: 64 queries x 200,000 candidates
    spec = importlib.util.spec_from_file_location(
        "serve_retrieval_torch",
        ROOT / "examples" / "serve_retrieval_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    r = counted(lambda: example.serve(dev), tally)
    q, cand = r["queries"], r["candidates"]
    assert r["agreement"] >= 0.99, r["agreement"]
    hold_topk(q, cand, r["kernel"],
              ref.knn_topk_ref(q, cand, example.TOP_K, metric="dot"),
              "retrieval example")
    log(f"  retrieval example: index {r['index_s']:.3f} s, streaming_topk "
        f"{r['stream_s'] * 1e3:.3f} ms, ops.knn_topk {r['kernel_s'] * 1e3:.3f}"
        f" ms, agreement {r['agreement']:.4f}")
    b3_timed(q, cand, example.TOP_K, "retrieval example", "dot")
    del r, q, cand
    torch.cuda.empty_cache()
    launches = {name: tally.get(name, 0) for name in KERNELS}
    log(f"  recommender serving launches: {launches} [{card}]")
    # one B3 launch a retrieval (two-tower, BERT4Rec, the example), no
    # other kernel anywhere on these models' paths
    assert launches == dict({n: 0 for n in KERNELS}, knn_topk=3), launches
    return launches


# ---------------------------------------------------------------------------
# recommender and GNN training: the five models' train steps, held card
# against CPU at the smoke configs, then 5 AdamW steps at published widths
# ---------------------------------------------------------------------------

def train_batch(name, c, n, gen, smoke):
    """A train batch of model ``name`` drawn from ``gen``: ``n`` rows (a
    DimeNet cell's own graph, of ``SMOKE_CELLS`` if ``smoke``).
    BERT4Rec's full cloze takes a target at every position, its sampled
    one 20 masked positions and 8,192 negatives (4 and 64 if
    ``smoke``)."""
    rs = recsys_shapes
    if name.startswith("BERT4Rec"):
        b = rs.bert4rec_batch(c, n, gen, train=True,
                              n_masked=4 if smoke else rs.N_MASKED,
                              n_negatives=64 if smoke else rs.N_NEGATIVES)
        if name == "BERT4Rec cloze":
            return {"ids": b["ids"],
                    "targets": rs.cloze_targets(b, c.seq_len)}
        return b
    if name.startswith("DimeNet"):
        cells = dimenet_cfg.SMOKE_CELLS if smoke else dimenet_cfg.CELLS
        seed = int(torch.randint(0, 1 << 30, (1,), generator=gen,
                                 device=gen.device))
        return dimenet_cfg.cell_batch(cells[name.split()[1]], seed,
                                      gen.device)
    make = {"two-tower": rs.two_tower_batch, "DLRM": rs.dlrm_batch,
            "DeepFM": rs.deepfm_batch}[name]
    return make(c, n, gen, train=True)


def train_models():
    """(name, module, smoke config, published config, batch at full
    width, the cut, make_train_step's kwargs) of phase 14."""
    dl = dataclasses.replace(
        dlrm_mlperf.make_config(),
        vocab_sizes=tuple(min(v, TRAIN_DLRM_CAP) for v in
                          dlrm.CRITEO_1TB_VOCABS))
    return [
        ("two-tower", two_tower, two_tower_retrieval.smoke_config(),
         two_tower_retrieval.make_config(), TRAIN_TWO_TOWER,
         "batch 32,768 (the cell's 65,536 needs ~51 GB of [B, B] logits, "
         "their gradient and softmax temporaries)", {}),
        ("DLRM", dlrm, dlrm_mlperf.smoke_config(), dl,
         recsys_shapes.TRAIN_BATCH,
         f"vocabularies capped at 2^22 rows ({dl.table.total_rows:,} rows;"
         f" table, gradient, m and v 4 x "
         f"{dl.table.padded_rows() * 128 * 4 / 1e9:.1f} GB)", {}),
        ("DeepFM", deepfm, deepfm_cfg.smoke_config(),
         deepfm_cfg.make_config(), recsys_shapes.TRAIN_BATCH, "none", {}),
        ("BERT4Rec cloze", bert4rec, bert4rec_cfg.smoke_config(), None, 0,
         "", {"sampled": False}),
        ("BERT4Rec sampled", bert4rec, bert4rec_cfg.smoke_config(),
         bert4rec_cfg.make_config(), TRAIN_BERT4REC,
         "batch 8,192 (the cell's 65,536 saves 21 GB of [B, 2, 200, 200] "
         "probabilities a block); 20 masked, 8,192 negatives",
         {"sampled": True}),
        ("DimeNet molecule", dimenet, dimenet_cfg.make_config(
            "molecule", smoke=True), dimenet_cfg.make_config("molecule"),
         0, "none (128 molecules, 8,192 edges, 32,768 triplets)", {}),
        ("DimeNet full_graph_sm", dimenet, dimenet_cfg.make_config(
            "full_graph_sm", smoke=True),
         dimenet_cfg.make_config("full_graph_sm"), 0,
         "none (2,708 nodes, 10,752 edges, 43,008 triplets, 1,433 "
         "features)", {}),
    ]


def train_parity(dev) -> None:
    """Each model at its smoke config takes 3 AdamW steps (warmup 1,
    ``TRAIN_LR``) on the card and on the CPU from the same seeded weights and
    batch: every loss and every parameter after the steps within
    ``TRAIN_RTOL`` / ``TRAIN_ATOL``."""
    worst = {}
    for name, mod, c, _, _, _, kw in train_models():
        gen = torch.Generator().manual_seed(11)
        cpu = mod.init_params(c, gen, "cpu")
        batch = train_batch(name, c, 24, gen, smoke=True)
        card = copy.deepcopy(cpu).to(dev)
        card_batch = {k: v.to(dev) for k, v in batch.items()}
        runs = []
        for model, b in ((cpu, batch), (card, card_batch)):
            opt = optimizers.adamw(model.parameters(), lr=TRAIN_LR,
                                   warmup_steps=1)
            step = mod.make_train_step(c, opt, **kw)
            runs.append([float(step(model, b)["loss"]) for _ in range(3)])
        assert np.allclose(runs[1], runs[0], rtol=TRAIN_RTOL,
                           atol=TRAIN_ATOL), (name, runs)
        err = 0.0
        for (pn, p), q in zip(cpu.named_parameters(), card.parameters()):
            q = q.detach().cpu()
            assert torch.allclose(q, p.detach(), rtol=TRAIN_RTOL,
                                  atol=TRAIN_ATOL), \
                (name, pn, float((q - p.detach()).abs().max()))
            err = max(err, float((q - p.detach()).abs().max()))
        worst[name] = err
        del cpu, card, batch, card_batch
    log("  smoke configs on the card against the CPU, 3 AdamW steps each "
        f"(lr {TRAIN_LR}, rtol={TRAIN_RTOL}, atol={TRAIN_ATOL}): losses and "
        "parameters "
        "allclose; max |param difference| " + ", ".join(
            f"{n} {e:.2e}" for n, e in worst.items()))


def corner(p: torch.Tensor) -> torch.Tensor:
    """A copy of the first 4,096 entries of ``p``."""
    return p.detach().reshape(-1)[:4096].clone()


def train_path(dev, card) -> dict:
    """Phase 14: the four recommenders and DimeNet trained with the
    port's AdamW (the cells' ``adamw(total_steps=10000)``).  First the
    smoke configs, card against CPU (:func:`train_parity`); then each
    model at its published widths, weights from a seeded generator, 5
    steps: each loss finite, the parameters moved, the global gradient
    norm of step 1 finite and above 0 and every parameter the loss reads
    given a gradient not all 0 after the clip (else, for a model of
    ``NO_UPDATE_AT_INIT`` whose norm is not finite, the steps are logged
    as steps with no update), the median step of steps 2-5 on the host
    clock, the peak memory (reset before each model), and one more step
    under the profiler.  Launch counts are set to 0 before the phase and read
    after: no kernel of the port is on this path.  Returns the
    counts."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(14)
    build.reset_launch_counts()
    train_parity(dev)
    for name, mod, _, c, n, cut, kw in train_models():
        if c is None:                       # the full cloze: smoke only
            continue
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = mod.init_params(c, gen, dev)
        batch = train_batch(name, c, n, gen, smoke=False)
        opt = optimizers.adamw(model.parameters(), total_steps=10000)
        step = mod.make_train_step(c, opt, **kw)
        torch.cuda.synchronize()
        made = time.perf_counter() - t0
        before = [corner(p) for p in model.parameters()]
        losses, times, gnorm = [], [], 0.0
        for i in range(5):
            t0 = time.perf_counter()
            loss = step(model, batch)["loss"]
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(loss))
            if i == 0:
                gnorm = float(opt.last_gnorm)
                zero = [pn for pn, p in model.named_parameters()
                        if p.grad is not None and not bool(p.grad.any())]
        assert all(np.isfinite(losses)), (name, losses)
        trained = np.isfinite(gnorm) and gnorm > 0 and not zero
        assert trained or (name in NO_UPDATE_AT_INIT
                           and not np.isfinite(gnorm)), (name, gnorm, zero)
        # every parameter moved but a zero one the loss never reads
        # (BERT4Rec's output bias under the sampled loss)
        still = [pn for b, (pn, p) in zip(before, model.named_parameters())
                 if torch.equal(b, corner(p))
                 and not (p.grad is None and not bool(p.any()))]
        assert not still, (name, still)
        peak = torch.cuda.max_memory_allocated()
        n_params = sum(p.numel() for p in model.parameters())
        rows = (f"B={n:,}" if n else "the cell's graph")
        log(f"  {name} train step ({rows}; cut: {cut}): {n_params:,} "
            f"parameters ({n_params * 4 / 1e9:.2f} GB), made in "
            f"{made:.1f} s; losses " + ", ".join(f"{x:.6g}" for x in losses)
            + f"; step-1 gradient norm {gnorm:.6g}"
            + ("" if trained else ": NO UPDATE, the clip zeroes every "
               "gradient and weight decay alone moves the parameters "
               "(ROADMAP.md §C item 8); a step with no update")
            + f"; step {np.median(times[1:]) * 1e3:.3f} ms (median of "
            "steps 2-5; "
            f"step 1 {times[0] * 1e3:.1f} ms); peak "
            f"{peak / 1e9:.2f} GB [{card}]")
        wall, total, prof = profiled(lambda: step(model, batch))
        log(f"    one more step under the profiler: {wall:.1f} ms on the "
            f"host clock, {total:.1f} ms of device time; by kernel: "
            + "; ".join(f"{ms:.1f} ms x{k} {kn[:50]}"
                        for ms, k, kn in prof[:6]))
        del model, batch, opt, step, before
    torch.cuda.synchronize()
    launches = {name: build.launch_counts[name] for name in KERNELS}
    log(f"  training launches: {launches} (none of the port's kernels is "
        f"on this path) [{card}]")
    assert not any(launches.values()), launches
    return launches



# ---------------------------------------------------------------------------
# LM training: 9b (attention's gradient), the gradient gate, granite-3-2b
# at full width and depth, the training driver, the smoke models
# ---------------------------------------------------------------------------

FLASH_BWD_CASES = (
    # what, B, S, H, KV, D, window, dtype, causal, the design planned
    ("granite-3-2b layer 0", 4, 4096, 32, 8, 64, 0, BF16, True, MMA),
    # the same on the CUDA cores: rows 2 bytes off a 16-byte boundary
    ("granite-3-2b layer 0, unaligned rows", 4, 4096, 32, 8, 64, 0, BF16,
     True, CORES),
    ("qwen2-moe-a2.7b layer 0", 4, 4096, 16, 16, 128, 0, BF16, True, MMA),
    ("gemma3-27b local layer", 2, 4096, 32, 16, 128, 1024, BF16, True, MMA),
    ("f32", 2, 1000, 8, 2, 64, 0, F32, True, CORES),
    ("odd S, GQA 4", 1, 333, 8, 2, 128, 0, BF16, True, MMA),
    ("odd S, D 96", 1, 333, 4, 2, 96, 0, BF16, True, CORES),
    ("window inside a tile", 2, 200, 4, 4, 64, 17, BF16, True, MMA),
    ("no causal mask, window", 1, 257, 4, 2, 64, 70, BF16, False, MMA),
    ("MLA's D 192, window, no causal mask", 1, 257, 4, 4, 192, 70, F32,
     False, CORES),
    ("D 32, window inside a tile", 1, 130, 2, 2, 32, 17, BF16, True, CORES),
    ("one token", 2, 1, 2, 1, 64, 0, BF16, True, MMA),
)
# 9b's kernels: the CUDA-core design's and the tensor-core design's
FLASH_BWD_KERNELS = ("bwd_stats_kernel", "bwd_dkdv_kernel", "bwd_dq_kernel")
FLASH_BWD_MMA_KERNELS = ("bwd_mma_stats_kernel", "bwd_mma_dkdv_kernel",
                         "bwd_mma_dq_kernel")
# the backward's operations: its 5 products (2.5x the forward's), and the
# 2 of the pass that recomputes each row's log-sum-exp and Δ (1x more)
FLASH_BWD_FLOP_RATIO = 3.5
# granite at full width, depth cut for the gradient gate; the training
# batch; the gate's bound (as the logit gate's: this many times the plain
# bf16 run's own error against an f32 run of the same weights)
LM_GATE_LAYERS = 4
LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_STEPS = 4, 4096, 5
LM_GRAD_BOUND = 2.0
TRAIN_CKPT_DIR = ROOT / "build" / "chip_smoke_train_ckpt"


def grad_errors(got, want, what) -> dict:
    """Max |err|, error rms / size rms and the worst last-dim row's max
    |err| / its max |value| of a gradient against its plain version,
    held to the LM logits row's bounds for layer 0's attention (§2 of
    PERF.md: 3e-2, or one bf16 step of the largest value where more;
    2^-7; 2^-6)."""
    diff, size = (got.float() - want.float()).abs(), want.float().abs()
    top = float(size.max())
    err = float(diff.max())
    atol = FLASH_ATOL[want.dtype]
    if top > 0:
        atol = max(atol, 2.0 ** (np.floor(np.log2(top)) - 7))
    rms = float(diff.square().mean().sqrt() / size.square().mean().sqrt()) \
        if top > 0 else 0.0
    row = float((diff.amax(-1) / size.amax(-1).clamp(min=1e-30)).max())
    assert got.shape == want.shape and got.dtype == want.dtype, what
    assert bool(torch.isfinite(got).all()), what
    assert err <= atol and rms <= FLASH_RMS_RATIO and \
        row <= FLASH_ROW_RATIO, (what, err, atol, rms, row)
    return dict(err=err, rms=rms, row=row, top=top)


def flash_bwd_library(q, k, v, do, window, causal):
    """SDPA's backward through autograd on the same values (contiguous
    copies: cuDNN's kernels fault on rows off a 16-byte boundary; K/V
    repeated over each group of query heads, the window as a boolean
    mask): a function that runs it once."""
    b, s, h, d = q.shape
    group = h // k.shape[2]
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_() for t in (
        q, k.repeat_interleave(group, 2), v.repeat_interleave(group, 2)))
    mask = None
    if window or not causal:
        i = torch.arange(s, device=q.device)
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
        if causal:
            mask &= i[None, :] <= i[:, None]
        if window:
            mask &= i[None, :] > i[:, None] - window
    out = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None)
    dot = do.transpose(1, 2).contiguous()
    return lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                       retain_graph=True)


def visible_pairs(s, causal, window) -> int:
    """The (query, key) pairs the mask leaves visible, per (batch,
    head)."""
    qp = np.arange(s)
    hi = qp if causal else np.full(s, s - 1)
    lo = np.maximum(qp - window + 1, 0) if window else np.zeros(s, int)
    return int(np.maximum(hi - lo + 1, 0).sum())


def check_flash_bwd(dev) -> dict:
    """9b alone at each of ``FLASH_BWD_CASES``: held against
    ``ref.flash_attention_bwd_ref`` by ``grad_errors`` (dq, dk, dv), the
    plain bf16 version's own error against an f32 one logged beside it,
    the three kernels bitwise from run to run; timed by events, by the
    profiler (the three kernels), a burst of 10 and the host clock,
    beside the plain version and SDPA's backward.  Returns granite's
    layer-0 record."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    recs = {}
    designs = set()
    for what, b, s, h, kv, d, win, dt, causal, design in FLASH_BWD_CASES:
        pad = int("unaligned" in what)
        q, k, v, do = (torch.randn((b, s, n, d + pad), generator=gen,
                                   device=dev).to(dt)[..., pad:]
                       for n in (h, kv, kv, h))
        plan = flash_attention.plan_flash_bwd(q, k, v, do, win, causal)
        assert plan.design == design, (what, plan)
        got = flash_attention.launch_bwd(q, k, v, do, causal, win)
        again = flash_attention.launch_bwd(q, k, v, do, causal, win)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(got, again)), what
        want = ref.flash_attention_bwd_ref(q, k, v, do, causal, win)
        errs = [grad_errors(x, y, (what, n)) for x, y, n in
                zip(got, want, ("dq", "dk", "dv"))]
        f32 = ref.flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                          do.float(), causal, win)
        own = [float((y.float() - z).abs().max()) for y, z in zip(want, f32)]
        del got, again, f32
        run = lambda: flash_attention.launch_bwd(q, k, v, do, causal, win)  # noqa: E731
        t = dict(ms=time_ms(run),
                 plain_ms=time_ms(lambda: ref.flash_attention_bwd_ref(
                     q, k, v, do, causal, win)),
                 library_ms=time_ms(flash_bwd_library(q, k, v, do, win,
                                                      causal)))
        reps = 5
        traced = device_ms(run, FLASH_BWD_KERNELS + FLASH_BWD_MMA_KERNELS,
                           reps, required=False)
        prof, every, n_rec = traced or (float("nan"), float("nan"), 0)
        prof *= 3 * reps / max(n_rec, 1)     # per call, over the records
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(10):
            run()
        host_ms = (time.perf_counter() - h0) * 1e2
        end.record()
        end.synchronize()
        burst_ms = start.elapsed_time(end) / 10
        # q, k, v and dO read once, dq, dk and dv written once
        io = sum(x.numel() * x.element_size() for x in (q, k, v, do)) * 2 \
            - do.numel() * do.element_size()
        flops = FLASH_BWD_FLOP_RATIO * 4.0 * d * b * h \
            * visible_pairs(s, causal, win)
        recs[what] = dict(
            t, max_abs_err=max(e["err"] for e in errs), device_ms=prof,
            burst_ms=burst_ms, host_ms=host_ms,
            shape=f"B={b} S={s} H={h} KV={kv} D={d} "
                  f"{str(dt).split('.')[-1]} "
                  + ("causal" if causal else "no causal mask")
                  + (f" window {win}" if win else "")
                  + (" unaligned rows" if pad else ""),
            bound=bound(io, flops, PEAK_BF16))
        r = recs[what]
        log(f"  9b {what} ({r['shape']}): kernel vs plain "
            + ", ".join(f"{n} max |err| {e['err']} (of {e['top']:.4g}), rms "
                        f"ratio {e['rms']:.3e}, worst row {e['row']:.3e}"
                        for n, e in zip(("dq", "dk", "dv"), errs))
            + f"; plain vs f32 max |err| {own}; bitwise from run to run; "
            f"{r['ms']:.4f} ms ({flops / r['ms'] / 1e9:.1f} TFLOP/s), "
            f"profiler {prof:.4f} ms a call ({n_rec} of {3 * reps} kernel "
            f"records, {every:.4f} ms in all kernels), {burst_ms:.4f} ms a "
            f"call of 10, host {host_ms:.4f} ms a call; plain "
            f"{r['plain_ms']:.4f} ms, SDPA backward {r['library_ms']:.4f} "
            f"ms, bound {r['bound'][0]:.4f} ms ({r['bound'][1]}); "
            f"{plan.design}, tiles {plan.bt}, shared bytes "
            f"{plan.smem_bytes}")
        designs.add(design)
        del q, k, v, do, want
        torch.cuda.empty_cache()
    assert designs == {MMA, CORES}, designs
    return recs


def bf16_valued(model) -> None:
    """Round an f32 model's weights to their bf16 values, in place."""
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(p.to(torch.bfloat16))


def lm_step1_grads(c, seed, batch, dev, plain, f32=False) -> tuple:
    """(loss, {name: gradient}) of ``lm_loss`` at the model made from
    ``seed`` (``f32``: the same bf16-valued weights in f32), through the
    kernels or the plain versions."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    model = transformer.init_params(
        dataclasses.replace(c, dtype=torch.float32) if f32 else c, gen, dev)
    if f32:
        bf16_valued(model)
    with ops.default_impl("ref") if plain else contextlib.nullcontext():
        loss = transformer.lm_loss(model, batch, model.config)
        loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    torch.cuda.synchronize()
    del model
    return float(loss.detach()), grads


def lm_gradient_gate(dev, card) -> None:
    """granite-3-2b at full width cut to ``LM_GATE_LAYERS`` layers, B 4 x
    S 4,096, one set of bf16-valued weights: step-1 gradients through the
    kernels (B9 and 9b) against the plain versions, per leaf max |Δ| /
    max |g| at most ``LM_GRAD_BOUND`` times the plain run's own against
    an f32 plain run; every layer's wq, wk, wv and wo gradient finite and
    not all 0 in the kernel run."""
    c = dataclasses.replace(granite_3_2b.make_config(),
                            n_layers=LM_GATE_LAYERS)
    batch = train_lm.synthetic_lm_batch(np.random.default_rng(16),
                                        LM_TRAIN_BATCH, LM_TRAIN_SEQ,
                                        c.vocab_size, dev)
    t0 = time.perf_counter()
    k_loss, kern = lm_step1_grads(c, 17, batch, dev, plain=False)
    k_s = time.perf_counter() - t0
    for i in range(c.n_layers):
        for w in ("wq", "wk", "wv", "wo"):
            g = kern[f"layers.{i}.{w}"]
            assert bool(torch.isfinite(g).all()) and bool(g.any()), (i, w)
    t0 = time.perf_counter()
    p_loss, plain = lm_step1_grads(c, 17, batch, dev, plain=True)
    p_s = time.perf_counter() - t0
    f_loss, full = lm_step1_grads(c, 17, batch, dev, plain=True, f32=True)

    def rel(a, b):
        return float((a.float() - b.float()).abs().max()
                     / b.float().abs().max())
    worst, rows = 0.0, []
    for name in kern:
        kp, p32 = rel(kern[name], plain[name]), rel(plain[name], full[name])
        assert kp <= LM_GRAD_BOUND * p32, (name, kp, p32)
        worst = max(worst, kp / p32)
        rows.append((kp / p32, name, kp, p32))
    rows.sort(reverse=True)
    log(f"  gradient gate, granite-3-2b at full width cut to {c.n_layers} "
        f"layers, B={LM_TRAIN_BATCH} S={LM_TRAIN_SEQ}: losses kernels "
        f"{k_loss:.6f}, plain {p_loss:.6f}, f32 {f_loss:.6f}; per leaf max "
        f"|Δ| / max |g|, kernels vs plain at most {worst:.3f}x the plain "
        f"run's against f32 (bound {LM_GRAD_BOUND}x); the closest leaves "
        + "; ".join(f"{n} {kp:.3e} vs {p32:.3e}"
                    for _, n, kp, p32 in rows[:4])
        + f"; every layer's wq/wk/wv/wo gradient finite and not all 0; "
        f"step-1 gradients {k_s:.1f} s with the kernels, {p_s:.1f} s plain"
        f" [{card}]")
    del kern, plain, full
    torch.cuda.empty_cache()


def lm_full_depth(dev, card) -> dict:
    """granite-3-2b at its published widths and depth (40 layers, bf16,
    seeded weights) takes ``LM_TRAIN_STEPS`` AdamW steps (lr 3e-4, warmup
    20, as the JAX driver) on B 4 x S 4,096 batches of the driver's
    maker: every loss finite, the step-1 gradient norm finite and above
    0; B9 twice and 9b once a layer a step (the forward, and each
    layer's recompute in the backward).  Logs the median of steps 2-5,
    tokens/s, peak memory and one more step under the profiler."""
    c = granite_3_2b.make_config()
    gen = torch.Generator(device=dev)
    gen.manual_seed(18)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = transformer.init_params(c, gen, dev)
    opt = optimizers.adamw(model.parameters(), lr=3e-4, warmup_steps=20,
                           total_steps=LM_TRAIN_STEPS)
    step = transformer.make_train_step(c, opt)
    rng = np.random.default_rng(18)
    batches = [train_lm.synthetic_lm_batch(rng, LM_TRAIN_BATCH,
                                           LM_TRAIN_SEQ, c.vocab_size, dev)
               for _ in range(LM_TRAIN_STEPS + 1)]
    torch.cuda.synchronize()
    made = time.perf_counter() - t0
    before = dict(build.launch_counts)
    losses, times = [], []
    for i in range(LM_TRAIN_STEPS):
        t0 = time.perf_counter()
        loss = step(model, batches[i])["loss"]
        losses.append(float(loss))
        times.append(time.perf_counter() - t0)
        if i == 0:
            gnorm = float(opt.last_gnorm)
    launched = {n: build.launch_counts[n] - before[n]
                for n in ("flash_attention", "flash_attention_bwd")}
    assert all(np.isfinite(losses)), losses
    assert np.isfinite(gnorm) and gnorm > 0, gnorm
    assert launched == {"flash_attention": 2 * c.n_layers * LM_TRAIN_STEPS,
                        "flash_attention_bwd": c.n_layers
                        * LM_TRAIN_STEPS}, launched
    peak = torch.cuda.max_memory_allocated()
    med = float(np.median(times[1:]))
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  granite-3-2b training, {c.n_layers} layers, B={LM_TRAIN_BATCH}"
        f" S={LM_TRAIN_SEQ}, {n_params:,} parameters (bf16; AdamW moments "
        f"f32), made in {made:.1f} s: losses " + ", ".join(
            f"{x:.6f}" for x in losses)
        + f"; step-1 gradient norm {gnorm:.6g}; step {med * 1e3:.1f} ms "
        f"(median of steps 2-{LM_TRAIN_STEPS}; step 1 {times[0] * 1e3:.1f} "
        f"ms), {tokens / med:,.0f} tokens/s; peak {peak / 1e9:.2f} GB; "
        f"launches {launched} [{card}]")
    wall, total, prof = profiled(lambda: step(model, batches[-1]))
    log(f"    one more step under the profiler: {wall:.1f} ms on the host "
        f"clock, {total:.1f} ms of device time "
        f"({100 * total / wall:.0f}% busy); by kernel: " + "; ".join(
            f"{ms:.1f} ms x{n} {kn[:50]}" for ms, n, kn in prof[:8]))
    del model, opt, step, batches
    torch.cuda.empty_cache()
    return dict(step_ms=med * 1e3, tokens_s=tokens / med, peak=peak)


def lm_driver(dev, card) -> None:
    """``launch.train`` (``run``, the body of ``main``) on the JAX
    driver's ``lm100m`` at B 2 x S 256: 20 steps with ``--ckpt`` under
    ``build/``, then a resume to 30."""
    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    flags = ["--arch", "lm100m", "--batch", "2", "--seq", "256", "--ckpt",
             str(TRAIN_CKPT_DIR), "--log-every", "10"]
    t0 = time.perf_counter()
    first = train_lm.run(flags + ["--steps", "20"])
    t1 = time.perf_counter()
    resumed = train_lm.run(flags + ["--steps", "30"])
    t2 = time.perf_counter()
    assert first.step0 == 0 and sorted(first.losses) == list(range(20))
    assert resumed.step0 == 20 and sorted(resumed.losses) == \
        list(range(20, 30))
    losses = list(first.losses.values()) + list(resumed.losses.values())
    assert all(np.isfinite(losses)), losses
    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    log(f"  driver, lm100m ({first.config.n_params():,} parameters, f32) at "
        f"B=2 S=256: 20 steps in {t1 - t0:.1f} s (losses "
        f"{first.losses[0]:.4f} -> {first.losses[19]:.4f}, median step "
        f"{np.median(first.step_seconds[1:]) * 1e3:.1f} ms), checkpoint "
        f"at 20, resumed to 30 in {t2 - t1:.1f} s (losses "
        f"{resumed.losses[20]:.4f} -> {resumed.losses[29]:.4f}) [{card}]")


def lm_smoke_parity(dev) -> None:
    """The granite, qwen2-moe, deepseek (MLA and MTP) and gemma3 smoke
    models take 3 AdamW steps (warmup 1, ``TRAIN_LR``) on the card
    (B9 and 9b in f32) and on the CPU from the same seeded weights and
    batch: losses and parameters within ``TRAIN_RTOL`` /
    ``TRAIN_ATOL``."""
    worst = {}
    for mod in (granite_3_2b, qwen2_moe_a2_7b, deepseek_v3_671b,
                gemma3_27b):
        c = mod.smoke_config()
        cpu = transformer.init_params(c, torch.Generator().manual_seed(16),
                                      "cpu")
        card = copy.deepcopy(cpu).to(dev)
        batch = train_lm.synthetic_lm_batch(np.random.default_rng(16), 4,
                                            32, c.vocab_size, "cpu")
        runs = []
        for model, b in ((cpu, batch),
                         (card, {k: v.to(dev) for k, v in batch.items()})):
            opt = optimizers.adamw(model.parameters(), lr=TRAIN_LR,
                                   warmup_steps=1)
            step = transformer.make_train_step(c, opt)
            runs.append([float(step(model, b)["loss"]) for _ in range(3)])
        assert np.allclose(runs[1], runs[0], rtol=TRAIN_RTOL,
                           atol=TRAIN_ATOL), (c.name, runs)
        err = 0.0
        for (pn, p), q in zip(cpu.named_parameters(), card.parameters()):
            q = q.detach().cpu()
            assert torch.allclose(q, p.detach(), rtol=TRAIN_RTOL,
                                  atol=TRAIN_ATOL), \
                (c.name, pn, float((q - p.detach()).abs().max()))
            err = max(err, float((q - p.detach()).abs().max()))
        worst[c.name] = (err, runs[1])
    log("  LM smoke configs on the card against the CPU, 3 AdamW steps each "
        f"(lr {TRAIN_LR}, rtol={TRAIN_RTOL}, atol={TRAIN_ATOL}): losses and "
        "parameters allclose; max |param difference|, card losses: "
        + "; ".join(f"{n} {e:.2e} {[round(x, 6) for x in r]}"
                    for n, (e, r) in worst.items()))


def lm_train_path(dev, card) -> tuple:
    """Phase 16: 9b alone at the LMs' shapes (its record), then with the
    launch counts set to 0: the gradient gate, granite-3-2b's full-depth
    training, the driver with a checkpoint and a resume, and the smoke
    models card against CPU (counts read after: B9 and 9b only).
    Returns (launches, 9b's granite layer-0 record, the other 9b
    records, the training readings)."""
    t0 = time.perf_counter()
    recs = check_flash_bwd(dev)
    log(f"  9b checks: {time.perf_counter() - t0:.1f} s")
    build.reset_launch_counts()
    t0 = time.perf_counter()
    lm_gradient_gate(dev, card)
    log(f"  gradient gate: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    full = lm_full_depth(dev, card)
    log(f"  full depth: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    lm_driver(dev, card)
    log(f"  driver: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    lm_smoke_parity(dev)
    log(f"  smoke parity: {time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    launches = dict(build.launch_counts)
    assert launches["flash_attention"] > 0 and \
        launches["flash_attention_bwd"] > 0, launches
    assert all(n in ("flash_attention", "flash_attention_bwd") or not x
               for n, x in launches.items()), launches
    log(f"  LM training launches: {launches} [{card}]")
    first = recs.pop("granite-3-2b layer 0")
    return launches, first, recs, full


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
    check_scatter_edges(gen, n_items, (p.group_size + 1) * b_max, dev)
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
    check_dtiled_edges(gen, dev)
    cq, cs, nbr = check_dtiled(corpus, c_int, uid, records)
    check_rows(corpus, c_int, cq, cs, uid, nbr, records)
    check_multihot_edges(dev)
    check_flash_edges(dev)
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
    entry = ""
    spills = {"knn_tile_kernel": [], "flash_wgmma_kernel": [],
              "rows_ring_kernel": [], "sparse_row_gather_kernel": [],
              "sparse_row_scatter_kernel": [], "blend_group_kernel": [],
              "blend_plan_kernel": [], "dtiled_ring_kernel": [],
              **{n: [] for n in FLASH_BWD_KERNELS
                 + FLASH_BWD_MMA_KERNELS}}
    for line in build.last_build_log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]          # the mangled kernel name
        elif "registers" in line or "spill" in line:
            log(f"  ptxas {entry[:100]}: " + line.strip())
            for name, found in spills.items():
                if name in entry and "spill" in line:
                    found.append(line.strip())
    # every instantiation of B3's tile kernel, of B9's Hopper design, of
    # B6/B7's ring (f32 and int8, selection and sort), of B1 and B2
    # (int32 or int64 rows and ids), of B4 (lists in registers or in
    # shared memory; int32 or int64 neighbours) and of B5's fp32 design
    # (32 or 16 queries, split or not), none with a spill
    assert len(spills["knn_tile_kernel"]) == len(knn_topk.KNN_SHAPES)
    assert len(spills["dtiled_ring_kernel"]) == 4
    assert len(spills["flash_wgmma_kernel"]) == len(flash_attention.WGMMA_BQ)
    assert len(spills["rows_ring_kernel"]) == 4
    assert len(spills["sparse_row_gather_kernel"]) == 4
    assert len(spills["sparse_row_scatter_kernel"]) == 4
    assert len(spills["blend_group_kernel"]) == 2
    assert len(spills["blend_plan_kernel"]) == 2
    # 9b's three kernels: on the CUDA cores at f32 and bf16, D padded to
    # 32, 64, 128, 256; on the tensor cores at D 64 and 128
    assert all(len(spills[n]) == 8 for n in FLASH_BWD_KERNELS), spills
    assert all(len(spills[n]) == 2 for n in FLASH_BWD_MMA_KERNELS), spills
    assert all("0 bytes spill stores, 0 bytes spill loads" in x
               for found in spills.values() for x in found), spills

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
    kern, launches = main_path(ds, dev)
    log(f"main path: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    paths = [launches, dtiled_path(kern, p, dev), sharded_path(kern, p, dev)]
    log(f"D-tiled and cross-shard paths: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    paths.append(rebuild_path(kern, p, dev, records))
    log(f"from-scratch rebuild: {time.perf_counter() - t0:.1f} s")
    requests, users = kern.requests, kern.requests[-1]
    single_rate = kern.n_events / kern.load_seconds
    del kern
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    paths.append(durability_path(ds, users, dev, card)[0])
    log(f"durability: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    paths.append(sharded_engine_path(ds, requests, dev, card,
                                     single_rate)[0])
    log(f"sharded engine: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    paths.append(compliance_path(ds, dev, card)[0])
    log(f"compliance: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    records["knn_topk_dtiled"]["million"], million = million_path(dev)
    paths.append(million)
    log(f"million-item point: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    paths.append(granite_path(dev, records, card))
    log(f"granite-3-2b serving: {time.perf_counter() - t0:.1f} s")
    # phase 15 next: after phase 14's traces the profiler records no
    # kernel at all
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    zoo, records["flash_attention"]["zoo"] = lm_zoo_path(dev, card)
    paths.append(zoo)
    log(f"LM zoo serving: {time.perf_counter() - t0:.1f} s")
    # phase 16 before phase 14 too
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    trained, records["flash_attention_bwd"], _, _ = lm_train_path(dev, card)
    paths.append(trained)
    log(f"LM training: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    paths.append(recsys_path(dev, card))
    log(f"recommender serving: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    paths.append(train_path(dev, card))
    log(f"recommender and GNN training: {time.perf_counter() - t0:.1f} s")
    for name in KERNELS:
        # launches on the paths that drive the kernel (each path's counts
        # were set to 0 just before it and read just after)
        records[name]["launches"] = sum(c[name] for c in paths)
        assert records[name]["launches"] > 0, name

    log("kernels launched on the paths of the port: " + ", ".join(
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
