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
   U=1, W=1, I=1, M*I > 2^31), of the multi-hot scatter, of B1, B3 and
   B8 past 2^31 elements (a 1,100,000 x 2,048 table: B1 gathering its
   top rows bitwise, B3 with 8 of its rows as queries, exact; B8
   writing 2 x 1,100,000,000 cells) and of attention;
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
   as the registry's serve cells cap them, at 2^24 rows: 45 GB of the
   89.5 GiB of tables); the retrieval
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
   ``adamw(total_steps=10000)``, at the configs and batches the
   registry's ``train_batch`` cells take on the card (the cut rule of
   ``configs/base.py``): two-tower at 32,768 pairs (the cell's 65,536
   would need ~51 GB of [B, B] logits and their gradients), DLRM at
   65,536 with each vocabulary capped at 2^22 rows (table, gradient, m
   and v 4 x 12.8 GB), DeepFM at 65,536, BERT4Rec's sampled cloze at
   8,192 sequences (20 masked, 8,192 negatives), DimeNet's
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
   local + 1 global layer) and command-r-plus-104b (cut to 2 layers):
   the depths the registry's prefill_32k cells take on the card, at
   their published widths, bf16, weights from a seeded generator, one
   model on the card at a time, each through phase 12's steps (the
   helper ``lm_path`` both phases share): layer 0's prefill attention
   kernel against plain and timed (qwen2-moe at D = 128 and DeepSeek's
   MLA at Q/K 192 with V 128 unpadded on ``tma_wgmma``), 4
   prompts of 4,096 tokens and 16 greedy steps with the kernels (counts
   reset before, read after: B9 once per layer, nothing else) and with
   the plain versions (no launch), the last MoE layer's prefill expert
   choices compared between the two runs, the logit gate against an f32
   run of the same weights rebuilt from the seed after the bf16 model is
   freed, a profile of one prefill and one decode step;
16. LM training (run after phase 15, before phase 13) -- 9b, the
   gradient of B9, alone at granite-3-2b's layer 0 (B 4, S 4,096, H 32,
   KV 8, D 64, bf16, causal), qwen2-moe's (D 128), a gemma3 local layer
   (window 1,024), deepseek-v3's MLA layer 0 (B 1, H 128, Q/K 192, V
   128, bf16) and command-r-plus's (B 1, H 96, KV 8, D 128), f32, an odd
   S, MLA's D 192 in f32 without the causal mask (the CUDA cores), MLA's
   (192, 128) at an odd S with a window, without the causal mask and at
   one token, D 32 and one token,
   on the Hopper design (``tma_wgmma``: from the
   log-sum-exp B9 saves, B9's output checked bitwise with and without the
   lse write and its lse against the plain one) where the input takes
   it, else on the CUDA cores: dq, dk and dv held to
   ``ref.flash_attention_bwd_ref`` by the LM logits row's layer-0 bounds,
   bitwise from run to run, timed by events, the profiler, a burst and
   the host clock beside the plain version, SDPA's backward and the
   bound; then (counts reset before, read after: B9 and 9b only, 9b's
   also by kernel name) the gradient gate (granite at full width cut to 4
   layers, B 4 x S 4,096: step-1 gradients with the kernels against the
   plain versions per leaf within 2x the plain run's own error against
   an f32 run, every layer's attention weights given a gradient),
   granite-3-2b at full width and depth taking 5 AdamW steps (step ms,
   tokens/s, peak memory, one more step under the profiler) under remat
   policy "full", then from the same weights and batches under "dots"
   (step ms and peak beside "full"'s; losses, the step-1 gradient norm
   and the parameters after 5 steps against "full"'s, bitwise or the
   difference logged; the gate's step-1 gradients under "dots" against
   "full"'s too, bitwise or within the gate's bound), the
   training driver on ``lm100m`` (20 steps with a checkpoint, a resume to
   30), and the granite, qwen2-moe, deepseek and gemma3 smoke models'
   3 steps card against CPU;
17. tifu-knn at production width (run right after phase 3, on a card
   with nothing else resident: asserted) -- the paper's own system,
   its three cells (``configs/tifu_knn.py``, histories drawn at
   ValuedShopper's Table-1 statistics) built from a seed on the card
   and run once through ``launch/dryrun.py`` (counts reset before each
   build and read after it: B8; reset again before each run and read
   after it: B1 and B2 in ``stream_update``, B3 in the serve cells; the
   peak memory counter reset before each run, the build's peak logged
   apart).  B8's first 16,384 users of each build (the state's user and
   last-group vectors, the corpus's user vectors, its histories drawn
   again from the seed) against the plain version on the same inputs
   (rtol=1e-5, atol=1e-6).  ``stream_update``: 16,384 adds, 1,024
   basket and 1,024 item deletes on 524,288 users x 16,384 items (cut
   from 1,048,576: 136 GiB of state), held to the plain route applied
   to a state of the 18,432 touched users' rows alone (integer leaves
   exact, float leaves and the materialized vectors rtol=1e-4,
   atol=1e-5) and 1,024 seeded untouched users bitwise unchanged; then
   the retrain baseline (both tables of every user from scratch through
   B8) timed.  ``serve_topk``: 4,096 queries at k = 300 against
   1,048,576 users through B3 (timed by events), 64 of them (32
   leading, 32 seeded) through the plain route (``knn.streaming_topk``
   and the chunked mean) against the whole corpus: neighbour ids by the
   repo's parity rule in float64 (``hold_topk``: 0 mismatches),
   predictions rtol=1e-5, atol=1e-6 where the rows are the same.
   ``serve_topk_opt``: the same data in 4 row blocks (views of one
   corpus) through ``knn.distributed_predict``: ids identical to
   ``serve_topk``'s, predictions rtol=1e-5, atol=1e-6.  Logs each
   cell's peak bytes, seconds, B3's ms and achieved FLOP/s against
   fp32's 67 TFLOP/s beside the card's name and power limit;
   ``serve_topk``'s library reading: matmul + ``topk`` over the same
   corpus in chunks of 256 queries (f32, TF32 off, |c|² computed once
   and counted), beside B3's time and bound;
18. the registry's 43 cells (run after phase 14: it uses no profiler)
   -- every (arch, shape) pair of ``configs.all_cells()`` built from a
   seed through ``dryrun.build_cell`` at the sizes ``configs/base.py``'s
   cut rule chooses for the card (named in ``reduced`` with their
   bytes) and run once through ``dryrun.run_program``, nothing caught:
   build and run seconds, peak bytes beside the rule's estimate, model
   FLOP/s and the cuts logged; ``fits`` asserted, every floating output
   finite, and each family's launches (counts reset before each run,
   read after): B9 once a layer in prefill_32k, twice a layer and 9b
   once in train_4k, B3 once in two-tower's and BERT4Rec's
   retrieval_cand, nothing else in the LM, recommender and GNN cells;
   tifu-knn's B1/B2 in ``stream_update``, B3 once and 4 times in the
   serve cells.  In each prefill_32k cell (S = 32,768) layer 0's
   attention output on the first and last 512 query rows of each
   sequence against f32 attention computed for those rows alone, by
   layer 0's bounds, and in granite's B9 timed at that shape beside
   SDPA and its bound.  Each program whose first call took under 3 s
   is then called a second time, warm (``warm_s``: the first call's
   one-time costs gone).  Then each
   cell built again from its seed and run once more under
   ``launch/cost.py``'s counter
   (``dryrun.count_program``), the counts reset before it: every launch
   matched by a work record of ``kernels/work.py``, FLOPs above 0, the
   three roofline terms (``launch/roofline.py``, the H100's published
   peaks), the bottleneck, ``useful_flops_ratio`` and t_bound over the
   cold and the warm call's seconds logged; no call of a cell may run
   faster than 1.05 times its bound.  First,
   three cells (tifu-knn ``serve_topk``, granite ``train_4k``, two-tower
   ``retrieval_cand``) at smoke sizes count the same ``Costs`` under
   ``ops.default_impl("cuda")`` and ``("ref")``.  The phase keeps
   within 300 s;
19. the paper's update rules (run right after phase 10: it uses no
   profiler) -- the mixed stream of phases 8-10 at TaFeng's full size,
   in order, as ``UpdateBatch``es of 512 rows (a batch closed early
   where a user would repeat, filled with noop rows; no add meets a
   full history, asserted), through four routes, each on a state of
   its own (~1.3 GB): (a) ``apply_update_batch`` on the kernels (B1,
   B2), (b) the same under ``ops.default_impl("ref")``, (c)
   ``apply_update_batch_dense`` (every rule on every row, one picked),
   (d) ``apply_add_batch`` then ``apply_del_*_batch_dense`` as
   ``benchmarks/bench_update_batch.py::_dense_kind_apply`` routes a
   batch (counts reset before each route, read after it: B1 and B2 in
   (a) and (d), none in (b) and (c)).  (b), (c) and (d) held to (a),
   and every route to a from-scratch ``user_vector_padded`` /
   ``last_group_vector_padded`` of its own final history: integer
   leaves exact, vectors rtol=1e-4, atol=1e-5, each max error logged.
   Each route's seconds, events/s and median ms a batch (host clock
   ended by ``torch.cuda.synchronize``); then the one-event latency of
   an add, an item delete and a basket delete through (a) and (c), each
   the median of 50 cycles after a warm-up on the users with the
   shortest and the longest history (the user's rows restored between
   cycles), beside the card's name and power limit;
20. static analysis on the card (run right after the build: it reads
   the verbose build's ptxas log) -- every compiled instance's
   registers, static shared memory, stack and spills logged;
   ``repro_torch.analysis.linter.lint_repo`` on this checkout clean (its
   contracts and kernels counted); the device's per-block shared-memory
   opt-in and per-SM size equal to ``launch/mesh.py``'s constants, which
   the plans and rule KC03 read; and ``resources.check_compiled`` with
   no finding: each kernel's compiled instances as its contract counts
   them, no spill but those a contract allows (``flash_kernel``'s 8
   bytes), static plus modelled dynamic shared memory within the opt-in.
   The phase's seconds beside the card's name and power limit;
21. placement and compression (run before phase 22, within 60 s) --
   ``quantize_int8`` and 30 steps of ``compress_with_feedback`` on seeded
   bf16 leaves of granite's widest shape [2048, 8192] bitwise the same
   calls on the CPU; then a one-rank NCCL process group on ``cuda:0``
   (a ``FileStore`` under a temporary directory) and the (1, 1, 1)
   ``("pod", "data", "model")`` mesh: granite-3-2b's parameters placed by
   ``param_pspecs`` through ``distribute`` (each local tensor on
   ``cuda:0`` and equal to its input), ``hierarchical_psum_mean`` with and
   without ``err`` (equal to the input up to its int8 round trip, or its
   bf16 rounding), ``save_pytree`` / ``restore_pytree(shardings=)`` of a
   small DTensor tree.  One card shows no multi-rank result: the CPU
   tests hold those in 8 gloo ranks;
22. sharded execution (run before phase 23, within 150 s) -- 4 rank
   processes of this script (``--shard-rank``) on ``cuda:0`` over gloo
   (NCCL refuses two ranks on one device; every collective of a CUDA
   tensor staged through host memory, ``parallel/spmd.py``), the (2, 2)
   ("data", "model") mesh with batch and FSDP over "data", each model
   built from its seed on every rank and placed by its ``param_pspecs``
   (``spmd.shard_module``), counts reset before each path and read
   after it on every rank: granite-3-2b at full width cut to 2 layers,
   B 4 x S 2,048 prefilled and 8 decode steps of fixed tokens (caches by
   ``_cache_pspecs``; B9 once a layer a rank), then 3 AdamW steps under
   remat "full" (B9 twice and 9b once a layer a step a rank), its logits
   by ``LM_LOGIT_BOUND``'s rule and its step-1 gradients by phase 16's
   gate against one-process single-device runs of the same weights
   (kernels, plain, f32); qwen2-moe-a2.7b at full width cut to 2 layers
   prefilled at a capacity factor that drops nothing (both runs' drops
   logged as 0, the logits by the same rule) and at its own 1.25 (each
   rank's drops logged); BERT4Rec's sharded ``serve_step`` at its
   published config for 512 users, the first 16 against one full product
   over every row (0 mismatches); DimeNet ``molecule`` at its published
   width in 4 equal edge partitions, ``forward_sharded`` and one AdamW
   step against the single-device ones on globalized indices, in f64 at
   rtol=1e-4, atol=1e-5 and in f32 within 1e-4 of the f64 forward.  The
   ranks' B9 / 9b launches join the kernels line; each part's seconds
   a rank logged beside the card (4 processes share the card and the
   collectives go through the host: correctness, not speed);
23. the recommender cells under the mesh (run after phase 22, within
   150 s) -- the 16 cells of DLRM, DeepFM, two-tower and BERT4Rec at
   their published widths through ``launch/dryrun.py``'s mesh route in 4
   rank processes (``dryrun --mesh-rank``, started by
   ``dryrun.run_ranks``) on ``cuda:0`` over gloo, phase 22's (2, 2)
   ("data", "model") mesh with batch and FSDP over "data": each cell
   built from its seed on every rank and placed by its own
   ``in_shardings`` (DLRM's tables built one rank at a time), run once
   and counted once more; each held by ``dryrun.held`` to a one-device
   run of the same seed made first in this process (its outputs on the
   host, the card freed before the ranks start): serving outputs
   ``rtol=1e-5, atol=1e-6``, top-n ids identical or tied (0 mismatches),
   a step's loss, its gradient norm and the parameters after it at the
   training tests' bars and each clipped gradient within 1e-3 of the
   one-device one in L2 norm (tables of more than 2^24 elements at the
   rows the step touched and seeded others).  Every DLRM cell at the
   2^22-row training cap, the bulk and training batches cut for time
   (``MESH_ROWS``), each cut in the cell's line; the sum of the ranks' estimated peaks within 0.85 of
   the card, the sum of their measured peaks within the card.  B3 on each
   rank's candidate block in the two retrieval cells (each rank's first
   call, ``dryrun.recorded_b3``), held here to its plain version on that
   block (run in the rank on the same inputs, ``dryrun.b3_plain``); its
   launches join the kernels line.  Each cell's per-rank
   seconds, peak and collective bytes by kind logged beside the card's
   name and power limit;
24. tifu-knn's cells and Adafactor under the mesh (run after phase 23,
   within 150 s) -- the three tifu-knn cells at their published widths
   with the users cut to 131,072 (each cut in the cell's line, with the
   bytes that force it) through ``launch/dryrun.py``'s mesh route in 4
   rank processes on ``cuda:0`` over gloo, phase 22's (2, 2) ("data",
   "model") mesh: ``stream_update``'s state with users over "data" and
   the vector tables' items over "model" (each rank builds its own block
   of the tables from the seed), the micro-batch gathered and each
   rank's users applied on its own columns (B1 and B2 on every rank);
   ``serve_topk`` and ``serve_topk_opt`` through B3 on each rank's rows
   (one launch a rank), the candidates merged over "model" then "data".
   Each held by ``dryrun.held`` to a one-device run of the same seed made
   first here (the stream state at the rows of 1,024 users its batch
   names and 1,024 seeded others: integer leaves exact, floats
   rtol=1e-4, atol=1e-5; predictions rtol=1e-5, atol=1e-6); B3's first
   call on each rank's block held to its plain version there; the sum of
   the ranks' measured peaks within the card.  Then Adafactor over
   DTensor parameters in 4 ranks of this script (``--adafactor-rank``):
   DeepSeek-V3's MLA down-projection [7168, 1536] over ("data",
   "model"), a stack of experts [8, 7168, 2048] split on its last two
   dims and a replicated [7168] norm, two steps, held on rank 0 to the
   one-device Adafactor on the same card (rtol=1e-5, atol=1e-7).  Each
   cell's per-rank seconds, peak and collective bytes by kind logged
   beside the card's name and power limit;
25. summary -- every kernel's launches, then one JSON line of kernel
   records, and last the ``{"ok": true, ...}`` line.

It needs a CUDA card and the rest of the repository; anywhere else it
exits non-zero without printing a result.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import importlib.util
import json
import math
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
from repro_torch.configs import all_cells, get_arch, smoke_sizes  # noqa: E402
from repro_torch.configs import (bert4rec_cfg,  # noqa: E402
                                 deepfm_cfg, deepseek_v3_671b, dimenet_cfg,
                                 dlrm_mlperf, gemma3_27b, granite_3_2b,
                                 qwen2_moe_a2_7b, recsys_shapes, tifu_knn,
                                 two_tower_retrieval)
from repro_torch.configs.base import (PEAK_SHARE, STATE_SHARE,  # noqa: E402
                                      card_bytes)
from repro_torch.core import knn, tifu, updates  # noqa: E402
from repro_torch.core.tifu import closed_form_basket_weights  # noqa: E402
from repro_torch.core.types import (KIND_ADD_BASKET,  # noqa: E402
                                    KIND_DEL_BASKET, KIND_DEL_ITEM, PAD_ID,
                                    AddBatch, DelBasketBatch, DelItemBatch,
                                    StreamState, UpdateBatch)
from repro_torch.data import stream, synthetic  # noqa: E402
from repro_torch.kernels import (build, decayed_scatter,  # noqa: E402
                                 flash_attention, knn_topk, ops, ref,
                                 serving_topn, sparse_row_gather,
                                 sparse_row_scatter, work)
from repro_torch.models import (bert4rec, deepfm, dimenet,  # noqa: E402
                                dlrm, transformer, two_tower)
from repro_torch.launch import dryrun, roofline, serve  # noqa: E402
from repro_torch.launch import train as train_lm  # noqa: E402
from repro_torch.launch.mesh import make_user_shard_devices  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.analysis import linter, resources  # noqa: E402
from repro_torch.optim import optimizers  # noqa: E402
from repro_torch.optim import compression  # noqa: E402
from repro_torch.optim.compression import (  # noqa: E402
    dequantize_int8_rows, hierarchical_psum_mean, quantize_int8_rows,
    quantize_int8_rows_pitched)
from repro_torch.parallel.sharding import (MeshShape, Sharding,  # noqa: E402
                                           Spec, UserShardSpec, distribute)
from repro_torch.checkpoint import pytree  # noqa: E402
from repro_torch.configs.base import named  # noqa: E402
from repro_torch.streaming import (AsyncCheckpointer, Event,  # noqa: E402
                                   ShardedStreamingEngine, StateStore,
                                   StoreConfig, StreamingEngine, faults,
                                   load_checkpoint_arrays)

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
# B1 and B3 on a table past 2^31 cells (SCATTER_BIG's shape) and B8 on
# an output past it: 2 rows of 1,100,000,000 items (8.8 GB), the last
# row's ids in its top 4,096 items (cells past 2,199,995,904)
MULTIHOT_BIG = (2, 1_100_000_000)
# the durability and sharded-engine phases' commits (build/ is not in
# git)
CKPT_DIR = ROOT / "build" / "chip_smoke_ckpt"
SHARD_CKPT_DIR = ROOT / "build" / "chip_smoke_shard_ckpt"
COMPLIANCE_DIR = ROOT / "build" / "chip_smoke_compliance_ckpt"
# the compliance phase: users forgotten, and the query chunk of the
# plain route (its [Q, k, I] neighbour gather is 3.7 GB at 256)
N_FORGET, PLAIN_CHUNK = 64, 256
# the retrieval_cand top n and BERT4Rec's serving top n
RETRIEVAL_TOP_N, BERT_TOP_N = 100, 20
# B3 at the recommender shapes: values within this of the plain version
RS_RTOL, RS_ATOL = 1e-5, 1e-6
# training: the smoke models' 3 steps, card against CPU, within these
TRAIN_RTOL, TRAIN_ATOL = 1e-5, 1e-5
# ... at this lr: Adam moves a parameter whose gradient is ~0 by up to
# lr_t a step, whichever sign that gradient takes, so 3 lr_t <= atol
TRAIN_LR = 3e-6
assert 3 * TRAIN_LR <= TRAIN_ATOL
# the reference's 6-block DimeNet overflows on random molecules at init:
# the step-1 gradient norm is inf and the clip zeroes every gradient
NO_UPDATE_AT_INIT = {"DimeNet molecule"}
# tifu-knn (phase 17): the seed of every cell (the two serve cells build
# the same data from it), the serve cells' queries through the plain
# route (the first 32 and 32 seeded), a phase to start on an empty card
TIFU_SEED, TIFU_PLAIN_QUERIES, TIFU_UNTOUCHED = 0, 64, 1024
TIFU_RESIDENT_MAX = 1 << 28
# serve_topk's library reading: matmul + topk in chunks of this many
# queries (a chunk's [256, 1,048,576] f32 distances are 1 GiB)
LIBRARY_CHUNK = 256
# phase 18: the cells' seed, the phase's budget in seconds, the query
# rows of each sequence (first and last) held to f32 attention at
# S = 32,768, and what may be resident when it starts
CELL_SEED, CELL_PHASE_S, LONG_ROWS = 18, 300.0, 512
# ... and the query heads the f32 attention takes at a time (DeepSeek's
# 128 at D 192: 1 GiB of scores a chunk of 16)
LONG_HEADS = 16
# ... no cell may run faster than this many times its roofline bound
BOUND_SLACK = 1.05
# ... and a first call this long (s) is not called again warm: its
# one-time costs are a small share of it (each such cell read within 1%
# warm on the H100, where a first call's costs came to at most 0.5 s)
WARM_MAX_S = 3.0
# ... the cells counted on the kernel and the plain route at smoke sizes
ROUTE_CELLS = (("tifu-knn", "serve_topk"), ("granite-3-2b", "train_4k"),
               ("two-tower-retrieval", "retrieval_cand"))
CELL_RESIDENT_MAX = 1 << 31
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
        source="src/repro_torch/kernels/csrc/flash_attention_bwd_wgmma.cu",
        replaces="src/repro/models/transformer.py:378"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = REPS):
    """Median device time of ``fn`` over ``reps`` runs after a warm-up
    (CUDA events around each run).  ``reps=0`` times one call with no
    warm-up and returns (its result, ms)."""
    if reps == 0:
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)
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


def bound(name: str, **inputs) -> tuple:
    """(ms, "bytes" | "operations"): ``roofline.kernel_bound`` of
    ``kernels/work.py``'s ``name`` on ``inputs``."""
    seconds, by = roofline.kernel_bound(name, **inputs)
    return seconds * 1e3, by


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
                bound=bound("sparse_row_gather", table=table, rows=rows64,
                            ids=ids))
            records["sparse_row_scatter"] = dict(
                max_abs_err=s_err, ms=scatter["ms"],
                plain_ms=timings["scatter_plain"],
                library_ms=put["ms"],
                shape=f"U={u} W={w} int64 rows, int32 ids",
                bound=bound("sparse_row_scatter", table=table, rows=rows64,
                            ids=ids, vals=vals))
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
    else:
        cn = ref.corpus_sqnorm(c)

        def library():
            return torch.topk(2.0 * (q @ c.T) - cn[None, :], k)
    r = dict(ms=time_ms(call),
             plain_ms=time_ms(lambda: ref.knn_topk_ref(q, c, k, **kw)),
             library_ms=time_ms(library),
             shape=f"Q={q_n} M={m} D={d} k={k} {metric}",
             bound=bound("knn_topk", queries=q, corpus=c, k=k, **kw))
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
    b4_work = dict(corpus=corpus, user_ids=uid, nbr_idx=nbr, topn=TOPN)
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
        bound=bound("blend_topn_onehot", **b4_work))
    rec = records["blend_topn_onehot"]
    t_bytes, t_ops = roofline.kernel_terms("blend_topn_onehot", **b4_work)
    log(f"  stage B bound: {used.numel()} distinct rows used, bytes "
        f"{t_bytes * 1e3:.4f} ms, operations {t_ops * 1e3:.4f} ms")
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
        bound=bound("knn_topk_dtiled", queries=qf, corpus=corpus, k=300,
                    query_gids=uid), **f32)
    records["knn_topk_dtiled"] = dict(
        max_abs_err=0.0, shape=f"int8 Q={Q} M={m} D={d} k=300 bd={BD}",
        bound=bound("knn_topk_dtiled", queries=cq[u], corpus=cq, k=300,
                    **kq), **timings)
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
    for mode, args, kw, lib in (
            ("int8", (cq[u], cq), kq,
             lambda: int_mm_topk(q8, c8_t, cs[u], cs, cn_q, BIG_K)),
            ("fp32", (c[u], c), dict(query_gids=uid),
             lambda: torch.topk(2.0 * (c[u] @ c.T) - cn[None, :], BIG_K))):
        t = dict(
            ms=time_ms(lambda: knn_topk.launch_dtiled(
                *args, BIG_K, bd=BIG_BD, **kw), 3),
            plain_ms=time_ms(lambda: ref.dtiled_topk_ref(
                *args, BIG_K, bd=BIG_BD, **kw), 3),
            library_ms=time_ms(lib, 3))
        t["bound"] = bound("knn_topk_dtiled", queries=args[0],
                           corpus=args[1], k=BIG_K, **kw)
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
    qf, qq, qs = corpus[u], cq[u], cs[u]
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
        bound=bound("blend_topn_rows", queries=qf, neighbor_rows=rows,
                    topn=TOPN))
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
        bound=bound("blend_topn_rows_indexed", queries_q=qq, q_scale=qs,
                    corpus_q=cq, c_scale=cs, nbr_idx=nbr, topn=TOPN))
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


def check_past_2_31(gen, dev):
    """B1, B3 and B8 where they address more than 2^31 elements, against
    their plain versions (B2's case is in :func:`check_scatter_edges`):
    a table of SCATTER_BIG's 1,100,000 x 2,048 small integers (9.0 GB;
    exact fp32 scores with true ties), B1 gathering from its top 4,096
    rows (bitwise), B3 with its last 8 rows as queries (ids and values
    exact, the lists reaching rows past 2^31 cells); B8 writing 2 rows of
    1,100,000,000 items (8.8 GB), the last row's ids among its top
    items."""
    m, items = SCATTER_BIG
    big = torch.randint(0, 3, (m, items), generator=gen, device=dev,
                        dtype=torch.float32)
    first_past = (1 << 31) // items + 1         # the first row past 2^31
    rows, ids, _ = sparse_inputs(gen, 4096, items, 512, 168, dev)
    rows = rows.long() + (m - 4096)
    got = sparse_row_gather.launch(big, rows, ids)
    assert same(got, ref.sparse_row_gather_ref(big, rows, ids)), \
        "gather past 2^31 cells differs"
    q = big[m - 8:]
    vk, ik = knn_topk.launch(q, big, 16)
    vp, ip = ref.knn_topk_ref(q, big, 16)
    torch.cuda.synchronize()
    assert torch.equal(ik, ip) and torch.equal(vk, vp), \
        "stage A past 2^31 cells differs"
    assert bool((ik >= first_past).any()), "stage A lists miss the top rows"
    del big, q
    torch.cuda.empty_cache()
    u, n_items = MULTIHOT_BIG
    mids = torch.randint(-1, n_items, (u, 12, 9), generator=gen, device=dev,
                         dtype=torch.int32)
    mids[-1] = torch.randint(n_items - 4096, n_items + 8, (12, 9),
                             generator=gen, device=dev, dtype=torch.int32)
    mids[-1, :, 0] = n_items - 1                 # the table's last cell
    err, bitwise = multihot_pair(mids, torch.rand((u, 12), generator=gen,
                                                  device=dev), n_items,
                                 "past 2^31 cells")
    torch.cuda.empty_cache()
    log(f"  past 2^31 elements: B1 gathering rows {m - 4096:,}.. of a "
        f"{m:,} x {items:,} table, bitwise; B3 with 8 queries against it "
        f"(k=16, rows from {first_past:,} on are past 2^31 cells), ids and "
        f"values exact; B8 writing {u} x {n_items:,} "
        f"({u * n_items:,} cells), max |err| {err} (bitwise {bitwise}); "
        f"each against its plain version")


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
        bound=bound("decayed_scatter", ids=hist, weights=w,
                    n_items=n_items))
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
    """Two engines' states: :func:`leaf_parity`."""
    return leaf_parity(got.store.state, want.store.state, what)


def leaf_parity(a, b, what):
    """Integer leaves exact, materialized vectors rtol=1e-4, atol=1e-5;
    returns the vectors' max |difference|."""
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


# ---------------------------------------------------------------------------
# phase 19: the paper's update rules in every form at TaFeng's full size
# ---------------------------------------------------------------------------

# the rows of one UpdateBatch, and the one-event latency's repetitions
RULE_ROWS, RULE_REPS = 512, 50


def stream_batches(events, rows, b_max, dev):
    """The stream, in order, as UpdateBatches of ``rows`` rows on ``dev``:
    a batch closes early where a user would repeat, and noop rows (user
    0) fill it.  Returns the batches and their event counts."""
    batches, counts, cur, seen = [], [], [], set()

    def close():
        kind, user, pos = (np.zeros(rows, np.int32) for _ in range(3))
        items = np.full((rows, b_max), PAD_ID, np.int32)
        item = np.full(rows, PAD_ID, np.int32)
        for r, ev in enumerate(cur):
            kind[r], user[r], pos[r], item[r] = (ev.kind, ev.user, ev.pos,
                                                 ev.item)
            if ev.items is not None:
                items[r, :len(ev.items)] = ev.items
        batches.append(UpdateBatch(*(torch.from_numpy(x).to(dev) for x in
                                     (kind, user, items, pos, item))))
        counts.append(len(cur))

    for ev in events:
        if len(cur) == rows or ev.user in seen:
            close()
            cur, seen = [], set()
        cur.append(ev)
        seen.add(ev.user)
    close()
    return batches, counts


def assert_adds_fit(events, n_users, max_baskets):
    """No add of the stream meets a full history (so the dense add, which
    has no capacity check, and the sparse one, which drops such an add,
    stay comparable), and every basket is sorted and unique (so the dense
    add, which stores it as given, and the sparse one, which stores
    ``AddBatch.build``'s ``np.unique``, write the same row).  Deletions
    are counted as basket deletions: an upper bound of the history."""
    nb = np.zeros(n_users, np.int64)
    for ev in events:
        if ev.kind == KIND_ADD_BASKET:
            assert nb[ev.user] < max_baskets, (ev, nb[ev.user])
            assert np.array_equal(np.unique(ev.items), ev.items), ev
            nb[ev.user] += 1
        elif ev.kind == KIND_DEL_BASKET:
            nb[ev.user] = max(nb[ev.user] - 1, 0)
    return int(nb.max())


def dense_kind_apply(state, batch, p):
    """``benchmarks/bench_update_batch.py::_dense_kind_apply``'s route:
    the sparse add, then the dense basket and item deletions."""
    kind = batch.kind.cpu().numpy()
    user = batch.user.cpu().numpy()
    cap, dev = int(kind.shape[0]), state.device
    adds = np.nonzero(kind == KIND_ADD_BASKET)[0]
    delb = np.nonzero(kind == KIND_DEL_BASKET)[0]
    deli = np.nonzero(kind == KIND_DEL_ITEM)[0]
    if adds.size:
        items = batch.basket_items.cpu().numpy()
        updates.apply_add_batch(state, AddBatch.build(
            user[adds], items[adds], items.shape[1], pad_cap=cap,
            device=dev), p)
    if delb.size or deli.size:
        pos = batch.basket_pos.cpu().numpy()
    if delb.size:
        updates.apply_del_basket_batch_dense(state, DelBasketBatch.build(
            user[delb], pos[delb], pad_cap=cap, device=dev), p)
    if deli.size:
        item = batch.item.cpu().numpy()
        updates.apply_del_item_batch_dense(state, DelItemBatch.build(
            user[deli], pos[deli], item[deli], pad_cap=cap, device=dev), p)
    return state


def plain_update_batch(state, batch, p):
    """Route (b): the shim with every kernel replaced by its plain
    version."""
    with ops.default_impl("ref"):
        return updates.apply_update_batch(state, batch, p)


# route: (the function, whether it launches B1 and B2)
KERNEL_ROUTE = "(a) apply_update_batch, kernels"
DENSE_ROUTE = "(c) apply_update_batch_dense"
RULE_ROUTES = {
    KERNEL_ROUTE: (updates.apply_update_batch, True),
    "(b) apply_update_batch, plain": (plain_update_batch, False),
    DENSE_ROUTE: (updates.apply_update_batch_dense, False),
    "(d) apply_add_batch + apply_del_*_batch_dense": (dense_kind_apply,
                                                       True),
}


def scratch_parity(state, p, what):
    """A state's materialized vectors against a from-scratch rebuild of
    its own final history (plain scatter): rtol=1e-4, atol=1e-5."""
    err = 0.0
    for fresh, fn in (
            (tifu.user_vector_padded, "materialized_user_vecs"),
            (tifu.last_group_vector_padded, "materialized_last_group_vecs")):
        x = getattr(state, fn)()
        y = fresh(state.history, state.group_sizes, state.n_groups, p)
        err = max(err, float((x - y).abs().max()))
        assert torch.allclose(x, y, rtol=1e-4, atol=1e-5), (what, fn, err)
        del x, y
    return err


def one_event_ms(route, state, u, p, n_items, rng):
    """Median host ms (ended by a synchronize) of each of three events
    on user ``u`` through ``route``, over RULE_REPS cycles after a
    warm-up cycle: an add of a seeded 3-item basket at the end of the
    history, the deletion of one of its items (in place), the deletion
    of that basket.  The user's rows are restored between cycles, so
    every cycle starts from the same state."""
    rows = {n: getattr(state, n)[u].clone() for n in convert.LEAVES}
    times = {"add": [], "item delete": [], "basket delete": []}
    b_max = state.max_basket_size
    for rep in range(RULE_REPS + 1):
        for n, row in rows.items():
            getattr(state, n)[u] = row
        nb = int(rows["n_baskets"])
        basket = np.sort(rng.choice(n_items, size=3, replace=False))
        items = np.full((1, b_max), PAD_ID, np.int32)
        items[0, :3] = basket

        def one(kind, pos=0, item=PAD_ID):
            return UpdateBatch(*(torch.from_numpy(np.asarray(x, np.int32))
                                 .to(state.device) for x in
                                 ([kind], [u], items, [pos], [item])))

        for name, batch in (("add", one(KIND_ADD_BASKET)),
                            ("item delete",
                             one(KIND_DEL_ITEM, nb, int(basket[1]))),
                            ("basket delete", one(KIND_DEL_BASKET, nb))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            route(state, batch, p)
            torch.cuda.synchronize()
            if rep:
                times[name].append((time.perf_counter() - t0) * 1e3)
        assert int(state.n_baskets[u]) == nb, (u, nb)
    for n, row in rows.items():
        getattr(state, n)[u] = row
    return {n: float(np.median(t)) for n, t in times.items()}


def update_rules_path(ds, dev, card):
    """Phase 19: the paper's update rules at TaFeng's full size.

    The mixed stream of phases 8-10, in order, as UpdateBatches of
    RULE_ROWS rows, through four routes, each on a state of its own:
    (a) the shim on the kernels, (b) the same with the plain versions,
    (c) the dense compute-all baseline, (d) the per-kind dense route.
    (b), (c) and (d) held to (a), and every route to a from-scratch
    rebuild of its own final history (integer leaves exact, vectors
    rtol=1e-4, atol=1e-5).  Then the one-event latency of an add, an
    item delete and a basket delete through (a) and (c) on the users
    with the shortest and the longest history.  Launch counts are reset
    before each route and before each latency run and read after it:
    B1 and B2 in (a), (d)'s adds and the latency through (a), none in
    (b) and (c).  Returns the phase's launch counts and readings."""
    p = ds.params
    cfg, events = mixed_stream(ds)
    n_max = assert_adds_fit(events, cfg.n_users, cfg.max_baskets)
    batches, counts = stream_batches(events, RULE_ROWS, cfg.max_basket_size,
                                     dev)
    assert sum(counts) == len(events)
    launches = {name: 0 for name in build.launch_counts}

    def counted(fn):
        build.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        got = dict(build.launch_counts)
        for name, n in got.items():
            launches[name] += n
        return out, {n: c for n, c in got.items() if c}

    log(f"update rules at TaFeng's full size ({cfg.n_users} users x "
        f"{p.n_items} items, N={cfg.max_baskets}, B={cfg.max_basket_size}; "
        f"{len(events)} events in {len(batches)} UpdateBatches of "
        f"{RULE_ROWS} rows, {np.mean(counts):.1f} events a batch; at most "
        f"{n_max} baskets a user, so no add meets a full history):")

    def run(fn):
        state = StreamState.zeros(cfg.n_users, p.n_items, cfg.max_baskets,
                                  cfg.max_basket_size, cfg.max_groups,
                                  device=dev)
        ms = []
        torch.cuda.synchronize()
        t_all = time.perf_counter()
        for batch in batches:
            t0 = time.perf_counter()
            fn(state, batch, p)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return state, time.perf_counter() - t_all, ms

    states, r = {}, {"routes": {}}
    for name, (fn, kernels) in RULE_ROUTES.items():
        (state, secs, ms), got = counted(lambda: run(fn))
        if kernels:
            assert got.get("sparse_row_gather", 0) > 0 and \
                got.get("sparse_row_scatter", 0) > 0, (name, got)
            assert set(got) == {"sparse_row_gather",
                                "sparse_row_scatter"}, (name, got)
        else:
            assert not got, (name, got)
        states[name] = state
        err = scratch_parity(state, p, name)
        held = "" if name == KERNEL_ROUTE else \
            f"; vs (a) {leaf_parity(state, states[KERNEL_ROUTE], name):.3e}"
        r["routes"][name] = dict(s=secs, rate=len(events) / secs,
                                 batch_ms=float(np.median(ms)))
        log(f"  {name}: {secs:.3f} s, {len(events) / secs:.0f} events/s, "
            f"median {np.median(ms):.3f} ms a batch (max "
            f"{np.max(ms):.3f}); launches {got}; max |err| vs a "
            f"from-scratch rebuild {err:.3e}{held} [{card}]")
    states = {n: states[n] for n in (KERNEL_ROUTE, DENSE_ROUTE)}
    torch.cuda.empty_cache()

    nb = states[KERNEL_ROUTE].n_baskets.cpu().numpy()
    has = np.nonzero(nb > 0)[0]
    short, long_ = int(has[np.argmin(nb[has])]), int(np.argmax(nb))
    rng = np.random.default_rng(19)
    r["latency"] = {}
    for name, state in states.items():
        route = RULE_ROUTES[name][0]
        for u in (short, long_):
            res, got = counted(
                lambda: one_event_ms(route, state, u, p, p.n_items, rng))
            r["latency"][(name, u)] = res
            assert bool(got) == (name == KERNEL_ROUTE), (name, got)
            log(f"  one event through {name}, user {u} ({int(nb[u])} "
                f"baskets): median of {RULE_REPS} host ms " + ", ".join(
                    f"{k} {v:.3f}" for k, v in res.items())
                + f"; launches {got} [{card}]")
    del states
    torch.cuda.empty_cache()
    return launches, r


BF16, F32 = torch.bfloat16, torch.float32
# flash_attention.plan_flash's designs
WGMMA, MMA, CORES = "tma_wgmma", "mma_sync", "cuda_cores"
# MLA's widths: Q/K 192, V 128 (a D written as (D, Dv) below)
MLA = (192, 128)
FLASH_EDGES = (
    # B, S, H, KV, D (or (D, Dv)), window, dtype, causal, the design
    # plan_flash picks for V as transformer.kernel_v sends it
    (2, 200, 4, 4, 64, 0, F32, True, CORES),     # S % 64 != 0, KV == H
    (1, 333, 8, 2, 128, 0, BF16, True, WGMMA),   # KV < H, D = 128
    (2, 256, 4, 1, 64, 48, BF16, True, WGMMA),   # window
    (1, 130, 2, 2, 32, 17, F32, True, CORES),    # D = 32, window
    (2, 190, 8, 2, 32, 0, BF16, True, MMA),      # D = 32 in bf16
    (1, 96, 4, 2, 256, 0, BF16, True, CORES),    # D = 256
    (1, 72, 4, 4, 96, 0, BF16, True, CORES),     # D = 96
    (1, 100, 4, 4, 192, 0, BF16, True, CORES),   # D = 192, V as wide
    (1, 130, 4, 2, MLA, 17, F32, True, CORES),   # MLA in f32: V padded
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
    # the Hopper design at MLA's (192, 128): V in tiles of its own
    (2, 1, 4, 2, MLA, 0, BF16, True, WGMMA),     # S = 1, KV < H
    (1, 127, 4, 4, MLA, 0, BF16, True, WGMMA),   # S = 127
    (1, 129, 8, 2, MLA, 0, BF16, True, WGMMA),   # S = 129, KV < H
    (1, 257, 4, 4, MLA, 129, BF16, True, WGMMA),  # window across an edge
    (1, 257, 4, 2, MLA, 0, BF16, False, WGMMA),  # no causal mask, KV < H
    (2, 300, 2, 1, MLA, 70, BF16, False, WGMMA),  # no causal, window
    # 288 items on at most 132 blocks: the one Q buffer taken 3 times
    (2, 1030, 16, 2, MLA, 0, BF16, True, WGMMA),
)
# the JAX package's own kernel-vs-oracle bounds (tests/test_kernels.py:206,
# :219)
FLASH_ATOL = {torch.float32: 2e-3, torch.bfloat16: 3e-2}
# the same check scaled to the output's size, in bf16 ulps (2^-7 relative
# step): the error's rms within 1 ulp of the output's rms, and no
# (batch, query, head) row off by more than 2 ulps of its largest output
FLASH_RMS_RATIO = 2.0 ** -7
FLASH_ROW_RATIO = 2.0 ** -6


def widths(d) -> tuple:
    """(D, Dv) of a case's D: an int (V as wide as Q) or a pair."""
    return d if isinstance(d, tuple) else (d, d)


def flash_check(q, k, v, what, design, causal=True, window=0,
                ulp_floor=False):
    """The attention kernel against its plain version, on the design
    ``flash_attention.plan_flash`` picks, which must be ``design``; a V
    narrower than Q (MLA's) goes to the kernel as
    ``transformer.attend_padded_v`` sends it (``transformer.kernel_v``:
    unpadded to ``tma_wgmma``, zero-padded to Q's width for the designs
    that take V as wide as Q) and to the plain version unpadded, so the
    padding itself is checked where there is one.  Max |err| is held to
    the JAX package's bound for the dtype, set for N(0, 1) inputs whose
    outputs stay below 4; with ``ulp_floor`` (a model's activations,
    which reach further) to one bf16 rounding step of the largest output
    where that is more.  Returns (kernel, plain)."""
    dv = v.shape[-1]
    vk = transformer.kernel_v(q, k, v, window, causal)
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
        d, dv = widths(d)
        q, k, v = (torch.randn((b, s, n, w), generator=gen, device=dev
                               ).to(dt) for n, w in ((h, d), (kv, d),
                                                     (kv, dv)))
        note(design, *flash_check(q, k, v, (b, s, h, kv, d, dv, win, dt),
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
    # MLA's widths on rows 2 bytes off a 16-byte boundary: the CUDA cores,
    # V padded to Q's width
    mla = torch.randn((1, 100, 6, 193), generator=gen, device=dev).to(BF16)
    note(CORES, *flash_check(mla[:, :, :4, 1:], mla[:, :, 4:5, 1:],
                             mla[:, :, 5:, 1:129],
                             ("MLA widths, unaligned rows", BF16), CORES))
    assert set(worst) == {WGMMA, MMA, CORES}, worst
    log(f"  flash_attention edge cases ({len(FLASH_EDGES) + 6}: S 1, 127, "
        "128, 129, 191, 193, 257, 385, 1,030 and off the 64-row tile, "
        "windows inside a tile, across an edge and wider than S, KV == H "
        "and KV < H, D 32/64/96/128/192/256, (D, Dv) (192, 128) on "
        "tma_wgmma and, in f32 or on unaligned rows, on the CUDA cores, no "
        "causal mask, strided heads, unaligned rows), max |err| by design: "
        + ", ".join(f"{k} {e}" for k, e in worst.items()))


# the profiler's name of each design's kernel
FLASH_KERNEL_NAMES = {WGMMA: "flash_wgmma_kernel", MMA: "flash_mma_kernel",
                      CORES: "flash_kernel"}


def lm_attention_check(c, model, tokens, design, what) -> dict:
    """Layer 0's prefill attention of ``model`` on ``tokens``, as the
    prefill computes it (MLA: V as ``transformer.kernel_v`` sends it to
    the kernel, the plain version and SDPA on the unpadded V): the
    kernel against its plain
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
    # layer 0's window, as the prefill passes it (gemma3's 1,024)
    win = transformer.kernel_window(model.groups()[0][2][0])
    vk = transformer.kernel_v(q, k, v, win)
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
    flops = work.flash_attention(q, k, v, window=win).ops
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
    pad = ""
    if v.shape[-1] < d:
        pad = f" Dv={v.shape[-1]}" + (
            f" (padded to {d})" if vk.shape[-1] > v.shape[-1] else "")
    rec = dict(
        t, max_abs_err=err, device_ms=own, burst_ms=burst_ms,
        host_ms=host_ms,
        shape=f"B={b} S={s} H={h} KV={k.shape[2]} D={d}{pad} bf16 causal"
              + (f" window {win}" if win else ""),
        bound=bound("flash_attention", q=q, k=k, v=v, window=win))
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
    each at its published widths and at the depth its prefill_32k cell
    takes on the card (``registry_cut``): qwen2-moe whole, DeepSeek 1
    dense + 1 MoE layer (MLA and both layer groups), gemma3 5 local + 1
    global (the 5:1 window pattern), Command R+ 2."""
    return tuple(
        (name, registry_cut(name, "prefill_32k")[0], seed, design)
        for name, seed, design in (("qwen2-moe-a2.7b", 6, WGMMA),
                                   ("deepseek-v3-671b", 7, WGMMA),
                                   ("gemma3-27b", 8, WGMMA),
                                   ("command-r-plus-104b", 9, WGMMA)))


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

def hold_topk(q, c, got, want, what, metric="dot", min_identical=0.9,
              chunk=16_384):
    """B3's (values, ids) against its plain version's on the same card,
    by the repo's parity rule (``knn.compare_recommendations``): values
    within ``RS_RTOL``/``RS_ATOL`` where both are given (B3's euclidean
    values are the surrogate without |q|², the plain route's are not:
    pass None for those); the float64 scores of every corpus
    row (in chunks of ``chunk`` rows) give each query's k-th and
    (k+1)-th; a query whose two differ by more than ``RS_RTOL`` relative
    is in the exact class and must list the same rows, any other the
    same rows or score-equivalent ones (the sorted float64 scores of
    both lists within ``RS_RTOL``, ids distinct).  0 mismatches, and at
    least ``min_identical`` of the queries with the same ids in the same
    order.  Logs the counts and the largest value difference; returns
    the queries whose rows are the same."""
    (vk, ik), (vp, ip) = got, want
    ik, ip = ik.long(), ip.long()
    err = None
    if vk is not None and vp is not None:
        err = float((vk - vp).abs().max())
        assert torch.allclose(vk, vp, rtol=RS_RTOL, atol=RS_ATOL), \
            (what, err)
    assert int(ik.min()) >= 0 and int(ik.max()) < c.shape[0], what
    q64, (q_n, k) = q.double(), ik.shape
    best = torch.full((q_n, k + 1), float("-inf"), dtype=torch.float64,
                      device=q.device)
    for lo in range(0, c.shape[0], chunk):
        sc = ref.pairwise_scores(q64, c[lo:lo + chunk].double(), metric)
        best = torch.topk(torch.cat([best, sc], dim=1), k + 1, dim=1).values
        del sc

    def scores(ids):
        out = torch.empty(ids.shape, dtype=torch.float64, device=q.device)
        for r in range(0, q_n, 8):
            rows = c[ids[r:r + 8]].double()
            qr = q64[r:r + 8, None]
            out[r:r + 8] = ((rows * qr).sum(-1) if metric == "dot"
                            else -((rows - qr) ** 2).sum(-1))
        return torch.sort(out, dim=1).values

    def close(a, b):
        return (a - b).abs() <= RS_RTOL * torch.maximum(a.abs(), b.abs())

    sep = (~close(best[:, k - 1], best[:, k]) if k < c.shape[0]
           else torch.ones(q_n, dtype=torch.bool, device=q.device))
    same_rows = torch.all(torch.sort(ik, dim=1).values
                          == torch.sort(ip, dim=1).values, dim=1)
    distinct = torch.tensor([len(set(r)) == k for r in ik.tolist()],
                            device=q.device)
    equiv = torch.all(close(scores(ik), scores(ip)), dim=1) & distinct
    identical = torch.all(ik == ip, dim=1)
    ok = torch.where(sep, same_rows, same_rows | equiv)
    out = dict(identical=int(identical.sum()),
               exact=int((sep & same_rows).sum()),
               equivalent=int((~sep & ok).sum()), mismatch=int((~ok).sum()),
               close_neighbours=int((~sep).sum()), max_abs_err=err)
    assert out["mismatch"] == 0, (what, out)
    assert out["identical"] >= min_identical * q_n, (what, out)
    log(f"  {what}: {out}")
    return same_rows


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
    with each vocabulary capped as the registry's serve cells cap it
    (2^24 rows): ``serve_step`` at 512 and
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

    # DeepFM and DLRM (vocabularies capped as the serve cells cap them)
    for name, mod, c, make in (
            ("DeepFM", deepfm, deepfm_cfg.make_config(),
             rs.deepfm_batch),
            ("DLRM", dlrm, registry_cut("dlrm-mlperf", "serve_p99")[0],
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


def registry_cut(name, shape):
    """(config, batch, cuts) of cell (``name``, ``shape``) as the
    registry's cut rule chooses them for the card (``Cell.choose``),
    the cuts as one line ("none" where nothing is cut)."""
    sz, reduced, _ = get_arch(name).cells[shape].choose(
        card_bytes(torch.device("cuda")))
    return sz.config, sz.batch, "; ".join(
        f"{k} {v}" for k, v in reduced.items()) or "none"


def train_models():
    """(name, module, smoke config, published config, batch at full
    width, the cut, make_train_step's kwargs) of phase 14: the
    recommenders at their ``train_batch`` cells' configs and batches."""
    return [
        ("two-tower", two_tower, two_tower_retrieval.smoke_config(),
         *registry_cut("two-tower-retrieval", "train_batch"), {}),
        ("DLRM", dlrm, dlrm_mlperf.smoke_config(),
         *registry_cut("dlrm-mlperf", "train_batch"), {}),
        ("DeepFM", deepfm, deepfm_cfg.smoke_config(),
         *registry_cut("deepfm", "train_batch"), {}),
        ("BERT4Rec cloze", bert4rec, bert4rec_cfg.smoke_config(), None, 0,
         "", {"sampled": False}),
        ("BERT4Rec sampled", bert4rec, bert4rec_cfg.smoke_config(),
         *registry_cut("bert4rec", "train_batch"), {"sampled": True}),
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
    # what, B, S, H, KV, D (or (D, Dv)), window, dtype, causal, the
    # design planned
    ("granite-3-2b layer 0", 4, 4096, 32, 8, 64, 0, BF16, True, WGMMA),
    # the same on the CUDA cores: rows 2 bytes off a 16-byte boundary
    ("granite-3-2b layer 0, unaligned rows", 4, 4096, 32, 8, 64, 0, BF16,
     True, CORES),
    ("qwen2-moe-a2.7b layer 0", 4, 4096, 16, 16, 128, 0, BF16, True, WGMMA),
    ("gemma3-27b local layer", 2, 4096, 32, 16, 128, 1024, BF16, True,
     WGMMA),
    # the train_4k cells' other layer 0s: MLA at (192, 128) on the
    # Hopper design, and Command R+'s GQA 12
    ("deepseek-v3-671b layer 0", 1, 4096, 128, 128, MLA, 0, BF16, True,
     WGMMA),
    ("command-r-plus-104b layer 0", 1, 4096, 96, 8, 128, 0, BF16, True,
     WGMMA),
    ("f32", 2, 1000, 8, 2, 64, 0, F32, True, CORES),
    ("odd S, GQA 4", 1, 333, 8, 2, 128, 0, BF16, True, WGMMA),
    ("odd S, D 96", 1, 333, 4, 2, 96, 0, BF16, True, CORES),
    ("window inside a tile", 2, 200, 4, 4, 64, 17, BF16, True, WGMMA),
    ("no causal mask, window", 1, 257, 4, 2, 64, 70, BF16, False, WGMMA),
    ("MLA's D 192, window, no causal mask", 1, 257, 4, 4, 192, 70, F32,
     False, CORES),
    # MLA's (192, 128) at the Hopper design's tile edges
    ("MLA, odd S, GQA 4, window", 1, 333, 8, 2, MLA, 70, BF16, True, WGMMA),
    ("MLA, no causal mask", 1, 257, 4, 4, MLA, 0, BF16, False, WGMMA),
    ("MLA, one token", 2, 1, 2, 1, MLA, 0, BF16, True, WGMMA),
    ("D 32, window inside a tile", 1, 130, 2, 2, 32, 17, BF16, True, CORES),
    ("one token", 2, 1, 2, 1, 64, 0, BF16, True, WGMMA),
)
# 9b's kernels: the CUDA-core design's and the Hopper design's
FLASH_BWD_KERNELS = flash_attention.BWD_KERNELS[CORES]
FLASH_BWD_WGMMA_KERNELS = flash_attention.BWD_KERNELS[WGMMA]
# the backward's products beside the gradient's own 5 that its bound
# counts (``work.GRAD_PRODUCTS``), as (products of width D, of width
# Dv): the 9 either design runs (each row's S and dP in each of its
# three launches: 4.5x the forward's), logged beside
FLASH_BWD_RUN = (5, 4)
# B9's saved log-sum-exp against the plain one: ex2.approx and another
# summation order, a few f32 ulps of values below ~20
FLASH_LSE_ATOL = 1e-4
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


def check_saved_lse(q, k, v, causal, win, what):
    """B9's ``tma_wgmma`` forward with and without the log-sum-exp write:
    the output bitwise the same, the lse within ``FLASH_LSE_ATOL`` of
    ``ref.flash_attention_lse_ref``.  Returns (out, lse, lse's max
    |err|)."""
    with torch.no_grad():
        plain_out = flash_attention.launch(q, k, v, causal, win)
        out, lse = flash_attention.launch_with_lse(q, k, v, causal, win)
    torch.cuda.synchronize()
    assert torch.equal(out, plain_out), (what, "B9's output moved")
    want = ref.flash_attention_lse_ref(q, k, causal, win)
    err = float((lse - want).abs().max())
    assert lse.shape == want.shape and err <= FLASH_LSE_ATOL, (what, err)
    return out, lse, err


def check_flash_bwd(dev) -> dict:
    """9b alone at each of ``FLASH_BWD_CASES``: on the ``tma_wgmma``
    design from the log-sum-exp that B9 saves (``check_saved_lse``), held
    against ``ref.flash_attention_bwd_ref`` by ``grad_errors`` (dq, dk,
    dv; the error against the design's own counterpart
    ``ref.flash_attention_bwd_lse_ref`` logged beside), the
    plain bf16 version's own error against an f32 one logged too, the
    three kernels bitwise from run to run; timed by events, by the
    profiler (the three kernels), a burst of 10 and the host clock,
    beside the plain version, SDPA's backward and the bound.  Returns
    granite's layer-0 record."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    recs = {}
    designs = set()
    for what, b, s, h, kv, d, win, dt, causal, design in FLASH_BWD_CASES:
        pad = int("unaligned" in what)
        d, dv = widths(d)
        q, k, v, do = (torch.randn((b, s, n, w + pad), generator=gen,
                                   device=dev).to(dt)[..., pad:]
                       for n, w in ((h, d), (kv, d), (kv, dv), (h, dv)))
        saved, lse_note = {}, ""
        if design == WGMMA:
            _, lse, lse_err = check_saved_lse(q, k, v, causal, win, what)
            saved = dict(lse=lse)
            lse_note = (f"; B9's output bitwise with and without the lse "
                        f"write, its lse vs plain max |err| {lse_err:.3e}")
        plan = flash_attention.plan_flash_bwd(q, k, v, do, win, causal,
                                              **saved)
        assert plan.design == design, (what, plan)
        got = flash_attention.launch_bwd(q, k, v, do, causal, win, **saved)
        again = flash_attention.launch_bwd(q, k, v, do, causal, win, **saved)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(got, again)), what
        want = ref.flash_attention_bwd_ref(q, k, v, do, causal, win)
        errs = [grad_errors(x, y, (what, n)) for x, y, n in
                zip(got, want, ("dq", "dk", "dv"))]
        if design == WGMMA:
            own = ref.flash_attention_bwd_lse_ref(q, k, v, lse, do, causal,
                                                  win)
            lse_note += ", vs its counterpart from that lse " + \
                str([float((x.float() - y.float()).abs().max())
                     for x, y in zip(got, own)])
            del own
        f32 = ref.flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                          do.float(), causal, win)
        own = [float((y.float() - z).abs().max()) for y, z in zip(want, f32)]
        del got, again, f32
        run = lambda: flash_attention.launch_bwd(  # noqa: E731
            q, k, v, do, causal, win, **saved)
        t = dict(ms=time_ms(run),
                 plain_ms=time_ms(lambda: ref.flash_attention_bwd_ref(
                     q, k, v, do, causal, win)),
                 library_ms=time_ms(flash_bwd_library(q, k, v, do, win,
                                                      causal)))
        reps = 5
        traced = device_ms(run, FLASH_BWD_KERNELS + FLASH_BWD_WGMMA_KERNELS,
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
        grad = dict(q=q, k=k, v=v, dout=do, causal=causal, window=win)
        flops = work.flash_attention_bwd(**grad).ops
        run_flops = work.flash_attention_bwd(**grad,
                                             products=FLASH_BWD_RUN).ops
        # the work over the forward's 2·(D + Dv) flops a pair
        ratio = flops / work.flash_attention(q, k, v, causal, win).ops
        recs[what] = dict(
            t, max_abs_err=max(e["err"] for e in errs), device_ms=prof,
            burst_ms=burst_ms, host_ms=host_ms,
            shape=f"B={b} S={s} H={h} KV={kv} D={d} "
                  + (f"Dv={dv} " if dv != d else "") +
                  f"{str(dt).split('.')[-1]} "
                  + ("causal" if causal else "no causal mask")
                  + (f" window {win}" if win else "")
                  + (" unaligned rows" if pad else ""),
            bound=bound("flash_attention_bwd", **grad),
            bound_run=bound("flash_attention_bwd", **grad,
                            products=FLASH_BWD_RUN))
        r = recs[what]
        log(f"  9b {what} ({r['shape']}): kernel vs plain "
            + ", ".join(f"{n} max |err| {e['err']} (of {e['top']:.4g}), rms "
                        f"ratio {e['rms']:.3e}, worst row {e['row']:.3e}"
                        for n, e in zip(("dq", "dk", "dv"), errs))
            + f"{lse_note}; plain vs f32 max |err| {own}; bitwise from run "
            f"to run; {r['ms']:.4f} ms ({flops / r['ms'] / 1e9:.1f} TFLOP/s "
            f"of the {ratio:.3f}x work), profiler {prof:.4f} ms a call "
            f"({n_rec} of {3 * reps} kernel records, {every:.4f} ms in all "
            "kernels), "
            f"{burst_ms:.4f} ms a call of 10, host {host_ms:.4f} ms a call; "
            f"plain {r['plain_ms']:.4f} ms, SDPA backward "
            f"{r['library_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms "
            f"({r['bound'][1]}, {ratio:.3f}x the forward's operations; the "
            f"{run_flops / flops * ratio:.3f}x it runs "
            f"{r['bound_run'][0]:.4f} ms); "
            f"{plan.design}, items {plan.item}, tiles {plan.step}, shared "
            f"bytes {plan.smem_bytes}")
        designs.add(design)
        del q, k, v, do, want, saved
        torch.cuda.empty_cache()
    assert designs == {WGMMA, CORES}, designs
    return recs


def bf16_valued(model) -> None:
    """Round an f32 model's weights to their bf16 values, in place."""
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(p.to(torch.bfloat16))


def lm_step1_grads(c, seed, batch, dev, plain, f32=False,
                   policy="full") -> tuple:
    """(loss, {name: gradient}) of ``lm_loss`` at the model made from
    ``seed`` (``f32``: the same bf16-valued weights in f32), through the
    kernels or the plain versions, under remat ``policy``."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    c = dataclasses.replace(c, remat_policy=policy)
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
    not all 0 in the kernel run.  Then the kernel run again under remat
    policy "dots": its loss and gradients bitwise the "full" run's, or
    each leaf within the same gate (the difference logged)."""
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
    t0 = time.perf_counter()
    d_loss, dots = lm_step1_grads(c, 17, batch, dev, plain=False,
                                  policy="dots")
    d_s = time.perf_counter() - t0

    def rel(a, b):
        return float((a.float() - b.float()).abs().max()
                     / b.float().abs().max())
    worst, rows, dots_worst, n_same = 0.0, [], 0.0, 0
    for name in kern:
        kp, p32 = rel(kern[name], plain[name]), rel(plain[name], full[name])
        assert kp <= LM_GRAD_BOUND * p32, (name, kp, p32)
        worst = max(worst, kp / p32)
        rows.append((kp / p32, name, kp, p32))
        if torch.equal(dots[name], kern[name]):
            n_same += 1
            continue
        dk = rel(dots[name], kern[name])
        assert dk <= LM_GRAD_BOUND * p32, ("dots", name, dk, p32)
        dots_worst = max(dots_worst, dk / p32)
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
    log(f"  \"dots\" against \"full\" in the gate: loss {d_loss:.6f} vs "
        f"{k_loss:.6f} ({'bitwise' if d_loss == k_loss else 'differs'}); "
        f"{n_same} of {len(kern)} leaves' gradients bitwise"
        + ("" if n_same == len(kern) else
           f", the others within {dots_worst:.3f}x the plain run's error "
           f"against f32 (bound {LM_GRAD_BOUND}x)")
        + f"; step-1 gradients {d_s:.1f} s under \"dots\" [{card}]")
    del kern, plain, full, dots
    torch.cuda.empty_cache()


def dots_saved_bytes(c, tokens: int) -> int:
    """What remat policy "dots" keeps beyond "full" for a dense GQA model:
    each layer's un-batched products' outputs (q, k, v, the output
    projection, the FFN's gate, up and down) in the model's dtype."""
    width = ((c.n_heads + 2 * c.n_kv_heads) * c.d_head + 2 * c.d_model
             + 2 * c.d_ff)
    return c.n_layers * tokens * width * torch.empty(
        (), dtype=c.dtype).element_size()


def lm_train_steps(model, c, batches, policy):
    """``LM_TRAIN_STEPS`` AdamW steps (lr 3e-4, warmup 20) of ``model``
    under remat ``policy``, from fresh optimizer state; returns the
    losses, each step's seconds, the step-1 gradient norm, B9's and 9b's
    launches (9b's also by kernel) and the peak memory (reset after the
    optimizer is made)."""
    c = dataclasses.replace(c, remat_policy=policy)
    model.config = c
    opt = optimizers.adamw(model.parameters(), lr=3e-4, warmup_steps=20,
                           total_steps=LM_TRAIN_STEPS)
    step = transformer.make_train_step(c, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = dict(build.launch_counts)
    bwd_before = dict(flash_attention.bwd_launches)
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
    by_kernel = {n: x - bwd_before[n]
                 for n, x in flash_attention.bwd_launches.items()}
    peak = torch.cuda.max_memory_allocated()
    assert all(np.isfinite(losses)), (policy, losses)
    assert np.isfinite(gnorm) and gnorm > 0, (policy, gnorm)
    # B9 twice a layer a step (the forward, and each layer's recompute in
    # the backward: "dots" keeps products, B9 is not one), 9b once, on its
    # Hopper design in every layer of every step
    assert launched == {"flash_attention": 2 * c.n_layers * LM_TRAIN_STEPS,
                        "flash_attention_bwd": c.n_layers
                        * LM_TRAIN_STEPS}, (policy, launched)
    assert by_kernel == {n: c.n_layers * LM_TRAIN_STEPS
                         if n in FLASH_BWD_WGMMA_KERNELS else 0
                         for n in by_kernel}, (policy, by_kernel)
    return SimpleNamespace(losses=losses, times=times, gnorm=gnorm,
                           launched=launched, by_kernel=by_kernel, peak=peak,
                           opt=opt, step=step,
                           ms=float(np.median(times[1:])) * 1e3)


def host_params(model) -> dict:
    return {n: p.detach().to("cpu", copy=True)
            for n, p in model.named_parameters()}


@torch.no_grad()
def load_params(model, params) -> None:
    for n, p in model.named_parameters():
        p.copy_(params[n])


def lm_full_depth(dev, card) -> dict:
    """granite-3-2b at its published widths and depth (40 layers, bf16,
    seeded weights) takes ``LM_TRAIN_STEPS`` AdamW steps (lr 3e-4, warmup
    20, as the JAX driver) on B 4 x S 4,096 batches of the driver's
    maker under remat policy "full": every loss finite, the step-1
    gradient norm finite and above 0; B9 twice and 9b once a layer a
    step (the forward, and each layer's recompute in the backward).
    Logs the median of steps 2-5, tokens/s, peak memory and one more
    step under the profiler.  Then the same model from the same weights
    and the same batches under "dots" (fresh optimizer state): its step
    ms and peak beside "full"'s, and its losses, step-1 gradient norm
    and parameters after 5 steps against "full"'s, bitwise or the
    difference logged (the gradient gate holds "dots" to the kernels'
    bound).  "dots" keeps ``dots_saved_bytes`` more; where that would
    not fit beside "full"'s peak, both policies run again at B 2."""
    c = granite_3_2b.make_config()
    gen = torch.Generator(device=dev)
    gen.manual_seed(18)
    t0 = time.perf_counter()
    model = transformer.init_params(c, gen, dev)
    rng = np.random.default_rng(18)
    batches = [train_lm.synthetic_lm_batch(rng, LM_TRAIN_BATCH,
                                           LM_TRAIN_SEQ, c.vocab_size, dev)
               for _ in range(LM_TRAIN_STEPS + 1)]
    initial = host_params(model)
    torch.cuda.synchronize()
    made = time.perf_counter() - t0
    full = lm_train_steps(model, c, batches, "full")
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  granite-3-2b training, {c.n_layers} layers, B={LM_TRAIN_BATCH}"
        f" S={LM_TRAIN_SEQ}, {n_params:,} parameters (bf16; AdamW moments "
        f"f32), made in {made:.1f} s: losses " + ", ".join(
            f"{x:.6f}" for x in full.losses)
        + f"; step-1 gradient norm {full.gnorm:.6g}; step {full.ms:.1f} ms "
        f"(median of steps 2-{LM_TRAIN_STEPS}; step 1 "
        f"{full.times[0] * 1e3:.1f} ms), {tokens * 1e3 / full.ms:,.0f} "
        f"tokens/s; peak {full.peak / 1e9:.2f} GB; launches "
        f"{full.launched}, 9b's by kernel {full.by_kernel} [{card}]")
    trained = host_params(model)
    step = full.step
    wall, total, prof = profiled(lambda: step(model, batches[-1]))
    by_name = {n: [(ms, k) for ms, k, kn in prof if n in kn]
               for n in ("flash_wgmma_kernel",) + FLASH_BWD_WGMMA_KERNELS}
    log(f"    one more step under the profiler: {wall:.1f} ms on the host "
        f"clock, {total:.1f} ms of device time "
        f"({100 * total / wall:.0f}% busy); by kernel: " + "; ".join(
            f"{ms:.1f} ms x{n} {kn[:50]}" for ms, n, kn in prof[:8])
        + "; B9 and 9b by kernel: " + "; ".join(
            f"{n} {sum(m for m, _ in r):.1f} ms x{sum(k for _, k in r)}"
            for n, r in by_name.items()))
    del full.opt, full.step, step
    gc.collect()
    torch.cuda.empty_cache()

    extra = dots_saved_bytes(c, tokens)
    total_bytes = torch.cuda.mem_get_info(dev)[1]
    b = LM_TRAIN_BATCH if full.peak + extra <= 0.9 * total_bytes else 2
    cut = "" if b == LM_TRAIN_BATCH else (
        f"; batch cut {LM_TRAIN_BATCH} -> {b}: \"full\"'s peak "
        f"{full.peak / 1e9:.2f} GB and the {extra / 1e9:.2f} GB \"dots\" "
        f"keeps exceed 0.9 of the card's {total_bytes / 1e9:.1f} GB")
    if b != LM_TRAIN_BATCH:
        batches = [{k: v[:b] for k, v in x.items()} for x in batches]
        load_params(model, initial)
        full = lm_train_steps(model, c, batches, "full")
        trained = host_params(model)
        del full.opt, full.step
        gc.collect()
        torch.cuda.empty_cache()
    load_params(model, initial)
    dots = lm_train_steps(model, c, batches, "dots")
    same = {n: torch.equal(p.detach().cpu(), trained[n])
            for n, p in model.named_parameters()}
    diff = max((float((p.detach().cpu().float() - trained[n].float()
                       ).abs().max() / trained[n].float().abs().max())
                for n, p in model.named_parameters() if not same[n]),
               default=0.0)
    log(f"  \"dots\" beside \"full\", granite-3-2b at {c.n_layers} layers, "
        f"B={b} S={LM_TRAIN_SEQ}{cut}: step {dots.ms:.1f} ms vs "
        f"{full.ms:.1f} ms (median of steps 2-{LM_TRAIN_STEPS}), peak "
        f"{dots.peak / 1e9:.2f} GB vs {full.peak / 1e9:.2f} GB (reckoned "
        f"+{dots_saved_bytes(c, b * LM_TRAIN_SEQ) / 1e9:.2f} GB); losses "
        + ("bitwise" if dots.losses == full.losses else "differ: " + ", ".join(
            f"{x:.6f} vs {y:.6f}" for x, y in zip(dots.losses, full.losses)))
        + f"; step-1 gradient norm {dots.gnorm:.6g} "
        + ("(bitwise)" if dots.gnorm == full.gnorm
           else f"vs {full.gnorm:.6g}")
        + f"; parameters after {LM_TRAIN_STEPS} steps: {sum(same.values())}"
        f" of {len(same)} leaves bitwise"
        + ("" if all(same.values())
           else f", the others within max |Δ| / max |p| {diff:.3e}")
        + f"; launches {dots.launched} [{card}]")
    assert all(abs(x - y) <= 1e-2 * abs(y)
               for x, y in zip(dots.losses, full.losses)), \
        (dots.losses, full.losses)
    del model, batches, dots.opt, dots.step, initial, trained
    gc.collect()
    torch.cuda.empty_cache()
    return dict(step_ms=full.ms, tokens_s=tokens * 1e3 / full.ms,
                peak=full.peak, dots_step_ms=dots.ms, dots_peak=dots.peak,
                dots_batch=b)


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
    flash_attention.reset_bwd_launches()
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
    log(f"  LM training launches: {launches}; 9b's by kernel "
        f"{flash_attention.bwd_launches} (the f32 driver and smoke models "
        f"on the CUDA cores) [{card}]")
    first = recs.pop("granite-3-2b layer 0")
    return launches, first, recs, full


# ---------------------------------------------------------------------------
# tifu-knn at production width: the paper's system on the card
# ---------------------------------------------------------------------------

TIFU_INT_LEAVES = ("history", "group_sizes", "n_baskets", "n_groups")


def tifu_cell(shape, dev):
    """Build one tifu-knn cell through the dry run's entry point, the
    launch counts set to 0 just before and read just after (the builds
    launch B8).  Returns (program, build seconds, the build's counts
    and peak bytes under "peak")."""
    build.reset_launch_counts()
    prog, build_s = dryrun.build_cell("tifu-knn", shape, dev, TIFU_SEED)
    built = dict(build.launch_counts, peak=torch.cuda.max_memory_allocated())
    assert built["decayed_scatter"] > 0, f"{shape}'s build launched no B8"
    return prog, build_s, built


def tifu_run(prog, dev, shape, build_s, built, card):
    """Run a built cell once through the dry run, the launch counts and
    the peak memory counter reset just before (so the peak is the run's,
    with the cell's inputs resident) and read just after; logs the dry
    run's readings.  Returns (readings, output, the run's counts, build
    and run counts)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    res, out = dryrun.run_program(prog, dev)
    ran = dict(build.launch_counts)
    both = {n: built.get(n, 0) + ran.get(n, 0) for n in KERNELS}
    log(f"  {shape}: {res['description']}; build {build_s:.3f} s (peak "
        f"{built['peak']:,} bytes), run {res['run_s']:.6f} s (host clock, "
        f"synchronized), peak of the run {res['peak_bytes']:,} bytes "
        f"({res['peak_bytes'] / 2 ** 30:.2f} GiB of "
        f"{res['device_bytes'] / 2 ** 30:.2f}, fits {res['fits']}), "
        f"model {res['model_flops']:.4g} FLOP at "
        f"{res['model_flops_per_s']:.4g} FLOP/s "
        f"({res['model_flops_per_s'] / roofline.PEAKS['f32']:.2%} of "
        f"fp32's 67 TFLOP/s); cuts {res['reduced'] or 'none'}; launches in "
        f"the build "
        f"{ {n: built[n] for n in KERNELS if built.get(n)} }, in the run "
        f"{ {n: c for n, c in ran.items() if c} } [{card}]")
    return res, out, ran, both


def tifu_b8_parity(hist, gs, ng, params, tables, what):
    """B8's rows of a cell's build against its plain version on the same
    inputs (``tables`` maps "user" and, for a state, "last group" to the
    rows the build wrote for these users), at multihot_pair's tolerance
    (rtol=1e-5, atol=1e-6).  The plain version launches nothing."""
    errs = {}
    for name, got in tables.items():
        fn = (tifu_knn.user_vectors if name == "user"
              else tifu_knn.last_group_vectors)
        with ops.default_impl("ref"):
            want = fn(hist, gs, ng, params)
        torch.cuda.synchronize()
        errs[name] = (float((got - want).abs().max()),
                      torch.equal(got, want))
        assert got.shape == want.shape, (what, name)
        assert torch.allclose(got, want, rtol=1e-5, atol=1e-6), \
            (what, name, errs[name])
        del want
    log(f"  {what}: B8's rows of the build for {hist.shape[0]:,} users x "
        f"{hist.shape[1]} baskets x {hist.shape[2]} items into I="
        f"{params.n_items:,} against the plain version on the same inputs "
        f"(max |err|, bitwise): {errs}")
    return errs


def tifu_stream_update(dev, card):
    """``stream_update``: B8's first chunk of the built state against its
    plain version; the cell on the kernel route, then the plain route on
    a state made of the touched users' rows only (the appliers are
    row-local): integer leaves exact, float leaves and the materialized
    vectors rtol=1e-4, atol=1e-5; 1,024 seeded untouched users bitwise
    unchanged; then the retrain baseline (both tables of every user from
    scratch through B8) timed."""
    prog, build_s, built = tifu_cell("stream_update", dev)
    state, adds, delb, deli = prog.args
    params = tifu_knn.make_params(state.n_items)
    c = slice(0, tifu_knn.BUILD_CHUNK)
    b8 = tifu_b8_parity(state.history[c], state.group_sizes[c],
                        state.n_groups[c], params,
                        {"user": state.user_vecs[c],
                         "last group": state.last_group_vecs[c]},
                        "stream_update's state")
    touched = torch.sort(torch.cat([adds.user, delb.user,
                                    deli.user]).long()).values
    assert torch.unique(touched).numel() == touched.numel()
    before = {n: getattr(state, n)[touched].cpu() for n in convert.LEAVES}
    gen = torch.Generator(device=dev)
    gen.manual_seed(TIFU_SEED + 1)
    hit = torch.zeros(state.n_users, dtype=torch.bool, device=dev)
    hit[touched] = True
    cand = torch.randperm(state.n_users, generator=gen, device=dev)[:4096]
    others = cand[~hit[cand]][:TIFU_UNTOUCHED]
    assert others.numel() == TIFU_UNTOUCHED
    kept = {n: getattr(state, n)[others].cpu() for n in convert.LEAVES}
    res, out, ran, launches = tifu_run(prog, dev, "stream_update", build_s,
                                       built, card)
    assert out is state
    for name in ("sparse_row_gather", "sparse_row_scatter"):
        assert ran[name] > 0, f"{name} not launched by stream_update's run"

    small = StreamState(**{n: t.to(dev, copy=True)
                           for n, t in before.items()})

    def local(u):
        return torch.searchsorted(touched, u.long()).to(torch.int32)

    batches = (AddBatch(local(adds.user), adds.items, adds.valid),
               DelBasketBatch(local(delb.user), delb.pos, delb.valid),
               DelItemBatch(local(deli.user), deli.pos, deli.item,
                            deli.valid))
    with ops.default_impl("ref"):
        prog.fn(small, *batches)
    torch.cuda.synchronize()
    worst = {}
    for n in convert.LEAVES:
        got, want = getattr(state, n)[touched], getattr(small, n)
        if n in TIFU_INT_LEAVES:
            assert torch.equal(got, want), f"stream_update leaf {n}"
        else:
            worst[n] = float((got - want).abs().max())
            assert torch.allclose(got, want, rtol=1e-4, atol=1e-5), \
                (n, worst[n])
    for fn in ("materialized_user_vecs", "materialized_last_group_vecs"):
        got = (state.user_vecs[touched] * state.uv_scale[touched, None]
               if fn == "materialized_user_vecs" else
               state.last_group_vecs[touched]
               * state.lgv_scale[touched, None])
        want = getattr(small, fn)()
        worst[fn] = float((got - want).abs().max())
        assert torch.allclose(got, want, rtol=1e-4, atol=1e-5), \
            (fn, worst[fn])
        del got, want
    for n in convert.LEAVES:
        assert torch.equal(getattr(state, n)[others].cpu(), kept[n]), \
            f"untouched users' {n} changed"
    changed = int((state.n_baskets[touched].cpu()
                   != before["n_baskets"]).sum())
    del small, before, kept
    log(f"  stream_update: {touched.numel():,} touched users (n_baskets "
        f"changed for {changed:,}) held to the plain route on their rows "
        f"alone: integer leaves exact, max |diff| {worst} (bar rtol=1e-4, "
        f"atol=1e-5); {TIFU_UNTOUCHED:,} untouched users bitwise "
        f"unchanged")
    n_b8 = build.launch_counts["decayed_scatter"]
    rebuild_s = timed(lambda: tifu_knn.rebuild_tables(state, params))
    log(f"  retrain baseline: both tables of all {state.n_users:,} users "
        f"from scratch in {rebuild_s:.3f} s "
        f"({build.launch_counts['decayed_scatter'] - n_b8} B8 launches; "
        f"the micro-batch's run {res['run_s']:.6f} s, "
        f"{rebuild_s / res['run_s']:.1f}x less) [{card}]")
    return launches, dict(res, rebuild_s=rebuild_s, b8=b8)


def tifu_serve(dev, card):
    """``serve_topk`` (all queries through B3), B8's first chunk of the
    corpus against its plain version, 64 queries through the plain route
    against the whole corpus, then ``serve_topk_opt`` on 4 row blocks
    against ``serve_topk``: ids identical, predictions rtol=1e-5,
    atol=1e-6."""
    sz = tifu_knn.Sizes()
    params = tifu_knn.make_params(sz.n_items)
    k, alpha = sz.topk, params.alpha
    b3_flops = 2.0 * sz.n_queries * sz.n_users * sz.n_items

    prog, build_s, built = tifu_cell("serve_topk", dev)
    res, pred, ran, launches = tifu_run(prog, dev, "serve_topk", build_s,
                                        built, card)
    assert ran["knn_topk"] > 0, ran
    queries, corpus = prog.args
    b3_bound_ms, _ = bound("knn_topk", queries=queries, corpus=corpus, k=k)
    # B8's first chunk of the corpus: its histories drawn again from the
    # seed (the build's first draws), then the plain version
    c = min(tifu_knn.BUILD_CHUNK, sz.n_users)
    hist, gs, _, ng, _ = tifu_knn.draw_users(
        tifu_knn.generator(dev, TIFU_SEED), c, sz, params.group_size, dev)
    b8 = tifu_b8_parity(hist, gs, ng, params, {"user": corpus[:c]},
                        "serve_topk's corpus")
    del hist, gs, ng
    (_, idx), b3_ms = time_ms(lambda: ops.knn_topk(queries, corpus, k), 0)
    lib_ids, library_ms = time_ms(lambda: library_topk(queries, corpus, k),
                                  0)
    lib_same = float((lib_ids == idx.long()).all(dim=1).float().mean())
    del lib_ids
    log(f"  serve_topk's library reading: matmul + topk over the corpus in "
        f"chunks of {LIBRARY_CHUNK} queries (f32, TF32 off, |c|² once, "
        f"counted) {library_ms:.3f} ms against B3's {b3_ms:.3f} ms and its "
        f"fp32 bound {b3_bound_ms:.1f} ms; {lib_same:.2%} of the queries' "
        f"ids identical to B3's [{card}]")
    # the ids B3 gives again are the ones the cell blended
    for q0 in range(0, sz.n_queries, knn.MEAN_QUERY_CHUNK):
        sl = slice(q0, q0 + knn.MEAN_QUERY_CHUNK)
        again = alpha * queries[sl] + (1.0 - alpha) * \
            knn.chunked_neighbor_mean(corpus, idx[sl])
        assert torch.equal(again, pred[sl]), "serve_topk's ids"
    del again
    assert bool(torch.isfinite(pred).all())
    gen = torch.Generator(device=dev)
    gen.manual_seed(TIFU_SEED + 2)
    half = TIFU_PLAIN_QUERIES // 2
    sel = torch.cat([torch.arange(half, device=dev), half + torch.randperm(
        sz.n_queries - half, generator=gen, device=dev)[:half]])
    qs = queries[sel]
    (_, pidx), plain_ms = time_ms(lambda: knn.streaming_topk(qs, corpus, k),
                                  0)
    ppred = alpha * qs + (1.0 - alpha) * knn.chunked_neighbor_mean(corpus,
                                                                   pidx)
    same_rows = hold_topk(qs, corpus, (None, idx[sel]), (None, pidx),
                          f"serve_topk: {TIFU_PLAIN_QUERIES} queries through "
                          f"B3 and the plain route (knn.streaming_topk, "
                          f"{plain_ms:.3f} ms) against the whole corpus",
                          metric="euclidean", min_identical=0.0)
    err = float((pred[sel][same_rows] - ppred[same_rows]).abs().max())
    assert torch.allclose(pred[sel][same_rows], ppred[same_rows],
                          rtol=1e-5, atol=1e-6), err
    log(f"  serve_topk: B3 over all {sz.n_queries:,} queries {b3_ms:.3f} ms "
        f"(events), {b3_flops / (b3_ms / 1e3):.4g} FLOP/s, "
        f"{b3_bound_ms / b3_ms:.1%} of its fp32 bound {b3_bound_ms:.1f} ms; "
        f"predictions of the {int(same_rows.sum())} plain-route queries "
        f"whose rows are the same max |diff| {err} (bar rtol=1e-5, "
        f"atol=1e-6) [{card}]")
    keep_q, keep_pred, keep_idx = queries.clone(), pred, idx
    del prog, queries, corpus, qs, pidx, ppred
    torch.cuda.empty_cache()

    prog, build_s, built = tifu_cell("serve_topk_opt", dev)
    res_o, pred_o, ran_o, launches_o = tifu_run(prog, dev, "serve_topk_opt",
                                                build_s, built, card)
    assert ran_o["knn_topk"] == sz.n_shards, ran_o
    queries, blocks = prog.args
    assert torch.equal(queries, keep_q), "the serve cells' data differ"
    assert all(b.data_ptr() == blocks[0].data_ptr() + s * b.shape[0]
               * b.stride(0) * 4 for s, b in enumerate(blocks)), \
        "the row blocks are not views of one corpus"
    (_, gids), opt_ms = time_ms(lambda: knn.distributed_topk(queries,
                                                             blocks, k), 0)
    assert torch.equal(gids, keep_idx.long()), "serve_topk_opt's ids"
    err_o = float((pred_o - keep_pred).abs().max())
    assert torch.allclose(pred_o, keep_pred, rtol=1e-5, atol=1e-6), err_o
    log(f"  serve_topk_opt: {sz.n_shards} row blocks' top-k and merge "
        f"{opt_ms:.3f} ms (events), ids identical to serve_topk's, "
        f"predictions max |diff| {err_o} (bar rtol=1e-5, atol=1e-6) "
        f"[{card}]")
    del prog, queries, blocks, keep_pred, pred_o
    torch.cuda.empty_cache()
    total = {n: launches[n] + launches_o[n] for n in launches}
    return total, dict(serve_topk=dict(res, b3_ms=b3_ms, b8=b8,
                                       library_ms=library_ms),
                       serve_topk_opt=dict(res_o, topk_ms=opt_ms))


def library_topk(queries, corpus, k):
    """The library's top-k nearest rows: |c|² once, then for each chunk
    of ``LIBRARY_CHUNK`` queries |q|² − 2·q·cᵀ + |c|² by one ``addmm``
    and ``torch.topk`` of the k smallest.  Returns the ids [Q, k]."""
    cn = torch.linalg.vector_norm(corpus, dim=1).square_()
    ids = []
    for q0 in range(0, queries.shape[0], LIBRARY_CHUNK):
        qs = queries[q0:q0 + LIBRARY_CHUNK]
        dist = torch.addmm(cn[None, :], qs, corpus.T, alpha=-2.0)
        dist.add_(torch.linalg.vector_norm(qs, dim=1).square_()[:, None])
        ids.append(torch.topk(dist, k, dim=1, largest=False).indices)
        del dist
    return torch.cat(ids)


def tifu_path(dev, card):
    """Phase 17: tifu-knn's three cells at production width through the
    dry run, on an otherwise empty card.  Returns the launch counts of
    the cells' builds and runs and the readings."""
    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    log(f"tifu-knn at production width ({resident:,} bytes resident "
        f"before) [{card}]")
    assert resident < TIFU_RESIDENT_MAX, resident
    counts, readings = tifu_stream_update(dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    served, readings["serve"] = tifu_serve(dev, card)
    return {n: counts[n] + served[n] for n in counts}, readings


# ---------------------------------------------------------------------------
# phase 18: every cell of the registry through the dry run
# ---------------------------------------------------------------------------

def expected_launches(name, shape, prog):
    """The launches of a cell's run, kernel by kernel, that its family
    should show; ``None`` for tifu-knn's (checked by
    :func:`tifu_launches_ok`)."""
    family = get_arch(name).family
    want = dict.fromkeys(KERNELS, 0)
    if family == "tifu":
        return None
    if family == "lm":
        n = prog.args[0].config.n_layers
        if shape == "train_4k":
            # remat runs each layer's forward again in backward
            want.update(flash_attention=2 * n, flash_attention_bwd=n)
        elif shape == "prefill_32k":
            want["flash_attention"] = n
    elif shape == "retrieval_cand" and name in ("two-tower-retrieval",
                                                "bert4rec"):
        want["knn_topk"] = 1
    return want


def tifu_launches_ok(shape, ran) -> bool:
    if shape == "stream_update":
        return ran["sparse_row_gather"] > 0 and ran["sparse_row_scatter"] > 0
    return ran["knn_topk"] == (4 if shape == "serve_topk_opt" else 1)


def floating_outputs(out):
    """Every floating tensor of a cell's output (tensors, tuples,
    lists, dicts)."""
    if isinstance(out, torch.Tensor):
        return [out] if out.is_floating_point() else []
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (tuple, list)):
        return [t for x in out for t in floating_outputs(x)]
    return []


def all_finite(t) -> bool:
    """Whether every value of ``t`` is finite, in chunks of 2^28 values
    (a cache's whole mask would be tens of GB)."""
    flat = t.reshape(-1)
    step = 1 << 28
    return all(bool(torch.isfinite(flat[i:i + step]).all())
               for i in range(0, flat.numel(), step))


class FirstAttention:
    """Within ``with``, ``ops.flash_attention`` keeps what the first call
    (a model's layer 0) gives the check of :func:`long_attention_check`:
    (q, k, v, window, output), of q and the output the first and last
    ``LONG_ROWS`` query rows of each sequence only, unless ``whole``
    (B9 is then timed on the whole q).  K and V stay whole: the last
    rows see every key."""

    def __init__(self, whole: bool = False):
        self.whole = whole

    def __enter__(self):
        self.first, self.orig = None, ops.flash_attention

        def rows(t):
            if self.whole:
                return t
            return torch.cat((t[:, :LONG_ROWS], t[:, -LONG_ROWS:]), 1)

        def call(q, k, v, causal=True, window=0, impl=None):
            out = self.orig(q, k, v, causal=causal, window=window,
                            impl=impl)
            if self.first is None:
                self.first = (rows(q), k, v, window, rows(out))
            return out
        ops.flash_attention = call
        return self

    def __exit__(self, *exc):
        ops.flash_attention = self.orig
        return False


def long_attention_check(first, what, card, timed) -> dict:
    """B9 at layer 0 of a prefill of S = 32,768: its output on the first
    and last ``LONG_ROWS`` query rows of each sequence against f32
    attention computed for those rows alone (causal, layer 0's window,
    scale 1/√D, softmax in f32; ``LONG_HEADS`` query heads at a time),
    by layer 0's bounds (max |err| <= 3e-2 or one bf16 step of the
    largest output, error rms / output rms <= 2^-7, worst row <= 2^-6);
    with ``timed``, B9 timed at that shape beside SDPA and its bound.
    Returns the record."""
    q, k, v, win, got = first
    b, s, h, d = k.shape[0], k.shape[1], q.shape[2], q.shape[3]
    group = h // k.shape[2]
    errs, sq_err, sq_out, row_ratio, top = 0.0, 0.0, 0.0, 0.0, 0.0
    n = 0
    for i in range(b):
        for j, r0 in enumerate((0, s - LONG_ROWS)):
            r1 = r0 + LONG_ROWS
            # the rows' place in ``q`` and ``got``: whole, or the kept rows
            at = r0 if q.shape[1] == s else j * LONG_ROWS
            rs_ = slice(at, at + LONG_ROWS)
            qpos = torch.arange(r0, r1, device=q.device)[:, None]
            kpos = torch.arange(r1, device=q.device)[None, :]
            mask = kpos <= qpos
            if win:
                mask &= kpos > qpos - win
            for h0 in range(0, h, LONG_HEADS):
                heads = torch.arange(h0, min(h, h0 + LONG_HEADS),
                                     device=q.device)
                kb = k[i, :r1, heads // group].float()
                vb = v[i, :r1, heads // group].float()
                sc = torch.einsum("qhd,khd->hqk", q[i, rs_, heads].float(),
                                  kb) / d ** 0.5
                sc.masked_fill_(~mask, float("-inf"))
                exp = torch.einsum("hqk,khd->qhd", torch.softmax(sc, dim=-1),
                                   vb)
                del sc, kb, vb
                diff = (got[i, rs_, heads].float() - exp).abs()
                size = exp.abs()
                errs = max(errs, float(diff.max()))
                top = max(top, float(size.max()))
                sq_err += float(diff.square().sum())
                sq_out += float(size.square().sum())
                n += diff.numel()
                row_ratio = max(row_ratio,
                                float((diff.amax(-1) / size.amax(-1)).max()))
                del diff, size, exp
    atol = max(FLASH_ATOL[q.dtype], 2.0 ** (np.floor(np.log2(top)) - 7))
    rms_ratio = (sq_err / n) ** 0.5 / (sq_out / n) ** 0.5
    shape = (f"B={b} S={s} H={h} KV={k.shape[2]} D={d}"
             + (f" Dv={v.shape[3]}" if v.shape[3] != d else "")
             + " bf16 causal" + (f" window {win}" if win else ""))
    assert errs <= atol, (what, "B9 at S = 32,768", errs, atol)
    assert rms_ratio <= FLASH_RMS_RATIO and row_ratio <= FLASH_ROW_RATIO, \
        (what, "B9 at S = 32,768 relative error", rms_ratio, row_ratio)
    rec = dict(shape=shape, max_abs_err=errs, rms_ratio=rms_ratio,
               row_ratio=row_ratio)
    timing = ""
    if timed:
        qt, kt, vt = (t.transpose(1, 2) for t in (
            q, k.repeat_interleave(group, 2), v.repeat_interleave(group, 2)))
        lib = torch.nn.functional.scaled_dot_product_attention
        ms = time_ms(lambda: flash_attention.launch(q, k, v, window=win))
        lib_ms = time_ms(lambda: lib(qt, kt, vt, is_causal=True))
        del qt, kt, vt
        flops = work.flash_attention(q, k, v, window=win).ops
        bound_ms, bound_by = bound("flash_attention", q=q, k=k, v=v,
                                   window=win)
        rec.update(ms=ms, library_ms=lib_ms, bound=(bound_ms, bound_by),
                   plan=str(flash_attention.plan_flash(q, k, v, win)))
        timing = (f"; {ms:.4f} ms (events, median of {REPS}), "
                  f"{flops / ms / 1e9:.1f} TFLOP/s; SDPA {lib_ms:.4f} ms; "
                  f"bound {bound_ms:.4f} ms ({bound_by}); plan "
                  f"{rec['plan']}")
    log(f"  B9 at layer 0 of {what}'s prefill, {shape}: the first and last "
        f"{LONG_ROWS} query rows of each sequence against f32 attention "
        f"for those rows alone: max |err| {errs} (bound {atol}), error rms "
        f"/ output rms {rms_ratio} (bound {FLASH_RMS_RATIO}), worst row "
        f"{row_ratio} (bound {FLASH_ROW_RATIO}){timing} [{card}]")
    return rec


def route_parity(dev, card) -> None:
    """``ROUTE_CELLS`` at smoke sizes counted under
    ``ops.default_impl("cuda")`` and ``("ref")``: the same ``Costs``, the
    hand-written kernels' work and calls included."""
    for name, shape in ROUTE_CELLS:
        costs = {}
        for impl in ("cuda", "ref"):
            prog, _ = dryrun.build_cell(name, shape, dev, CELL_SEED,
                                        smoke_sizes(name, shape))
            with ops.default_impl(impl):
                costs[impl] = dryrun.count_program(prog, dev)
            del prog
        assert costs["cuda"] == costs["ref"], (name, shape, costs)
        c = costs["cuda"]
        log(f"  {name} x {shape} at smoke sizes: the same Costs on the kernel "
            f"and the plain route ({c.flops:.6g} FLOP, {c.bytes:.6g} bytes, "
            f"kernel calls {c.kernel_calls}) [{card}]")


def count_cell(name, shape, dev, run_s, warm_s, model_flops) -> dict:
    """The cell built again from ``CELL_SEED`` and run once under the cost
    counter, the launch counts set to 0 just before and read just after:
    every launch matched by a work record.  Returns the dry run's
    roofline fields, with ``t_bound`` (s) and the launches; ``run_s`` and
    ``warm_s`` are the cell's cold and warm call (``None``: not made)."""
    t0 = time.perf_counter()
    prog, _ = dryrun.build_cell(name, shape, dev, CELL_SEED)
    t1 = time.perf_counter()
    build.reset_launch_counts()
    costs = dryrun.count_program(prog, dev)
    t2 = time.perf_counter()
    launched = {n: c for n, c in build.launch_counts.items() if c}
    del prog
    gc.collect()
    torch.cuda.empty_cache()
    assert launched == costs.kernel_calls, (name, shape, launched,
                                            costs.kernel_calls)
    fields = dryrun.roofline_fields(costs, model_flops)
    rt = fields["roofline"]
    t_b = dryrun.t_bound(fields)
    assert rt["flops"] > 0, (name, shape, rt)
    log(f"    roofline: compute {rt['t_compute_s']:.6g} s, memory "
        f"{rt['t_memory_s']:.6g} s, collective {rt['t_collective_s']:.6g} "
        f"s ({rt['flops']:.6g} FLOP {rt['flops_by_dtype']}, "
        f"{rt['hbm_bytes']:.6g} bytes), bottleneck {rt['bottleneck']}; "
        f"useful_flops_ratio {fields['useful_flops_ratio']}; t_bound / run_s "
        f"{t_b / run_s:.4f}"
        + ("" if warm_s is None else f", / warm_s {t_b / warm_s:.4f} "
           f"(warm call {warm_s:.6f} s)")
        + f"; kernels {costs.kernels or 'none'}; built again in "
        f"{t1 - t0:.3f} s, counted run {t2 - t1:.3f} s")
    return dict(fields, t_bound=t_b, count_launches=launched)


def cells_path(dev, card) -> tuple:
    """Phase 18: each of the 43 cells of ``configs.all_cells()`` built
    and run once through the dry run on an otherwise empty card, nothing
    caught, then built again and counted (``count_cell``): no cell runs
    faster than ``BOUND_SLACK`` times its roofline bound, cold or warm
    (a second call of the first program, timed where the first took
    under ``WARM_MAX_S``); first
    ``route_parity``.  Returns (the runs' launch counts, {(arch, shape):
    readings}, B9's records at S = 32,768 by arch: layer 0 of each
    prefill_32k cell, granite's timed)."""
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    log(f"the registry's cells ({resident:,} bytes resident before) "
        f"[{card}]")
    assert resident < CELL_RESIDENT_MAX, resident
    route_parity(dev, card)
    total = dict.fromkeys(KERNELS, 0)
    readings, long_recs = {}, {}
    for name, shape in all_cells():
        build.reset_launch_counts()
        prog, build_s = dryrun.build_cell(name, shape, dev, CELL_SEED)
        built = {n: c for n, c in build.launch_counts.items() if c}
        build.reset_launch_counts()
        watch = shape == "prefill_32k"
        timed = name == "granite-3-2b"
        with (FirstAttention(whole=timed) if watch
              else contextlib.nullcontext()) as fa:
            res, out = dryrun.run_program(prog, dev)
        ran = dict(build.launch_counts)
        for n in KERNELS:
            total[n] += ran.get(n, 0)
        want = expected_launches(name, shape, prog)
        if want is None:
            assert tifu_launches_ok(shape, ran), (name, shape, ran)
        else:
            assert {n: ran.get(n, 0) for n in KERNELS} == want, \
                (name, shape, ran, want)
        outs = floating_outputs(out)
        assert outs and all(all_finite(t) for t in outs) \
            or get_arch(name).family == "tifu" and shape == "stream_update", \
            (name, shape, "an output not finite")
        assert res["fits"], (name, shape, res)
        est = res["estimate_bytes"]
        log(f"  {name} x {shape}: {res['description']}; build {build_s:.3f}"
            f" s (launches {built or 'none'}), run {res['run_s']:.6f} s; "
            f"peak {res['peak_bytes']:,} bytes "
            f"({res['peak_bytes'] / 2 ** 30:.2f} GiB of "
            f"{res['device_bytes'] / 2 ** 30:.2f}, fits {res['fits']}), "
            f"estimate {est:,.0f} ({res['peak_bytes'] / est:.2f} of it); "
            f"{res['model_flops']:.4g} model FLOP, "
            f"{res['model_flops_per_s']:.4g} FLOP/s; launches "
            f"{ {n: c for n, c in ran.items() if c} or 'none'}; cuts "
            f"{res['reduced'] or 'none'}"
            + ("; the peak holds layer 0's K and V for B9's check"
               if watch else "") + f" [{card}]")
        readings[(name, shape)] = dict(res, build_s=build_s, launches=ran)
        del out, outs
        gc.collect()
        torch.cuda.empty_cache()
        # a second call, warm, where the first call's one-time costs
        # may be a large share of it: its output dropped at once
        warm_s = (dryrun.run_program(prog, dev)[0]["run_s"]
                  if res["run_s"] < WARM_MAX_S else None)
        readings[(name, shape)]["warm_s"] = warm_s
        del prog
        gc.collect()
        torch.cuda.empty_cache()
        if watch:
            first, fa.first = fa.first, None
            long_recs[name] = long_attention_check(first, name, card, timed)
            del first
            torch.cuda.empty_cache()
        readings[(name, shape)].update(count_cell(
            name, shape, dev, res["run_s"], warm_s, res["model_flops"]))
    phase_s = time.perf_counter() - t_phase
    # t_bound over the faster of the two calls
    share = {c: r["t_bound"] / min(r["run_s"], r["warm_s"] or r["run_s"])
             for c, r in readings.items()}
    faster = {c: x for c, x in share.items() if x > BOUND_SLACK}
    log(f"  the registry's {len(readings)} cells: launches "
        f"{ {n: c for n, c in total.items() if c} }; t_bound / the faster "
        f"call {min(share.values()):.4f}-{max(share.values()):.4f}"
        f"; phase {phase_s:.1f} s (budget {CELL_PHASE_S:.0f} s) [{card}]")
    assert len(readings) == 43, len(readings)
    assert len(long_recs) == 5, sorted(long_recs)
    assert not faster, ("cells faster than their roofline", faster)
    assert phase_s <= CELL_PHASE_S, phase_s
    return total, readings, long_recs


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
    check_past_2_31(gen, dev)
    check_flash_edges(dev)
    return records


# ---------------------------------------------------------------------------
# phase 20: the static analysis on the card
# ---------------------------------------------------------------------------

def static_analysis_path(card: str) -> None:
    """Phase 20: the port's lint on this checkout, and ptxas's report of
    the verbose build (``build.last_build_log``) held to the contracts at
    the device's own shared-memory sizes.  Nothing is caught."""
    t0 = time.perf_counter()
    records = resources.parse_ptxas(build.last_build_log)
    for r in records:
        log(f"  ptxas {r.mangled[:100]}: {r.registers} registers, "
            f"{r.smem} bytes smem, {r.stack} bytes stack frame, "
            f"{r.spill_stores} bytes spill stores, {r.spill_loads} bytes "
            "spill loads")
    report = linter.lint_repo(ROOT)
    assert report.ok, "\n".join(str(f) for f in report.findings)
    kernels = {k for c in linter.REGISTRY.values() for k in c.kernels}
    props = torch.cuda.get_device_properties(0)
    optin = props.shared_memory_per_block_optin
    per_sm = props.shared_memory_per_multiprocessor
    log(f"static analysis: lint clean, {len(linter.REGISTRY)} contracts "
        f"naming {len(kernels)} kernels; shared memory a block may opt in "
        f"to {optin} (launch/mesh.py {mesh.SMEM_PER_BLOCK_OPTIN}), an SM's "
        f"{per_sm} ({mesh.SMEM_PER_SM})")
    assert optin == mesh.SMEM_PER_BLOCK_OPTIN, optin
    assert per_sm == mesh.SMEM_PER_SM, per_sm
    compiled = linter.check_build_log(build.last_build_log, optin)
    assert compiled.ok, "\n".join(str(f) for f in compiled.findings)
    counts = {}
    for r in records:
        counts[r.kernel] = counts.get(r.kernel, 0) + 1
    spills = {r.mangled: r.spill for r in records if r.spill}
    log(f"static analysis: {len(records)} compiled instances, as the "
        f"contracts count them: {dict(sorted(counts.items()))}; spills "
        f"{spills}")
    log(f"phase 20 (static analysis on the card): "
        f"{time.perf_counter() - t0:.3f} s; card: {card}")


# ---------------------------------------------------------------------------
# phase 21: the placement layer and gradient compression
# ---------------------------------------------------------------------------

# granite-3-2b's widest leaf (an FFN matrix's [d_model, d_ff]) and the
# steps of error feedback held to the CPU
COMPRESS_SHAPE, COMPRESS_STEPS, PLACEMENT_PHASE_S = (2048, 8192), 30, 60.0
PLACEMENT_CKPT_DIR = ROOT / "build" / "chip_smoke_placement_ckpt"


def compression_parity(dev) -> str:
    """``quantize_int8`` and ``COMPRESS_STEPS`` steps of
    ``compress_with_feedback`` on seeded bf16 leaves of
    ``COMPRESS_SHAPE``, on the card and on the CPU: int8 values, scales
    and residuals bitwise."""
    gen = torch.Generator().manual_seed(21)
    g = torch.randn(COMPRESS_SHAPE, generator=gen).to(torch.bfloat16)
    q, scale = compression.quantize_int8(g.to(dev))
    cq, cscale = compression.quantize_int8(g)
    assert torch.equal(q.cpu(), cq) and torch.equal(scale.cpu(), cscale)
    err = compression.init_error_feedback(g.to(dev))
    cerr = compression.init_error_feedback(g)
    for t in range(COMPRESS_STEPS):
        g = (torch.randn(COMPRESS_SHAPE, generator=gen) * 1e-2
             ).to(torch.bfloat16)
        q, scale, err = compression.compress_with_feedback(g.to(dev), err)
        cq, cscale, cerr = compression.compress_with_feedback(g, cerr)
        assert torch.equal(q.cpu(), cq), t
        assert torch.equal(scale.cpu(), cscale), t
        assert torch.equal(err.cpu(), cerr), t
    return (f"quantize_int8 and {COMPRESS_STEPS} steps of "
            f"compress_with_feedback on bf16 {list(COMPRESS_SHAPE)}: int8 "
            f"values, scales and residuals bitwise the CPU's")


def one_rank_placement(dev, c, shape) -> dict:
    """The one-rank half of phase 21 on ``dev`` (NCCL on the card, gloo
    on the CPU for a rehearsal) with the config ``c`` of granite-3-2b and
    ``shape`` of compression: see :func:`placement_path`."""
    import tempfile

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    mesh_shape = MeshShape(("pod", "data", "model"), (1, 1, 1))
    rules = mesh.make_rules()
    with tempfile.TemporaryDirectory() as tmp:
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index or 0)
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            store=dist.FileStore(str(Path(tmp) / "store"), 1), rank=0,
            world_size=1)
        try:
            dm = mesh_shape.device_mesh(dev.type)
            gen = torch.Generator(device=dev)
            gen.manual_seed(21)
            model = transformer.init_params(c, gen, dev)
            params = dict(model.named_parameters())
            specs = transformer.param_pspecs(c, mesh_shape, rules)
            placed = distribute(params, named(mesh_shape, specs), dm)
            for n, x in placed.items():
                assert isinstance(x, DTensor), n
                local = x.to_local()
                assert local.device.type == dev.type, n
                assert torch.equal(local, params[n]), n
            del placed, params, model
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            x = torch.randn(shape, device=dev, generator=gen)
            mean, _ = hierarchical_psum_mean(x, dm, ("data", "model"),
                                             "pod")
            assert torch.equal(mean, x.to(torch.bfloat16).float())
            err = torch.zeros(x.numel(), device=dev)
            mean, err = hierarchical_psum_mean(x, dm, ("data", "model"),
                                               "pod", err=err)
            decoded = compression.dequantize_int8(*compression.quantize_int8(x))
            assert torch.equal(mean, decoded)
            assert torch.equal(err.view(x.shape), x - decoded)
            shutil.rmtree(PLACEMENT_CKPT_DIR, ignore_errors=True)
            tree = {"w": torch.randn(64, 32, device=dev, generator=gen),
                    "b": torch.randn(32, device=dev,
                                     generator=gen).to(torch.bfloat16)}
            tiny = {"w": Sharding(dm, Spec(("pod", "data"), "model")),
                    "b": Sharding(dm, Spec("model"))}
            pytree.save_pytree(distribute(tree, tiny, dm),
                               str(PLACEMENT_CKPT_DIR), 1)
            back = pytree.restore_pytree(
                {k: torch.zeros_like(v) for k, v in tree.items()},
                str(PLACEMENT_CKPT_DIR), shardings=tiny)
            for k, v in back.items():
                assert isinstance(v, DTensor) and torch.equal(
                    v.to_local(), tree[k]), k
            shutil.rmtree(PLACEMENT_CKPT_DIR, ignore_errors=True)
        finally:
            dist.destroy_process_group()
    return dict(mesh=mesh_shape, n_params=len(specs),
                n_sharded=sum(any(e is not None for e in s)
                              for s in specs.values()))


def placement_path(dev, card) -> None:
    """Phase 21: the compression's parity with the CPU, then a one-rank
    NCCL process group on ``cuda:0`` (a ``FileStore`` under a temporary
    directory) with the (1, 1, 1) ``("pod", "data", "model")`` mesh:
    granite-3-2b's parameters placed by ``param_pspecs`` (each local
    tensor on the card and equal to its input),
    ``hierarchical_psum_mean`` over ("data", "model") inside the pod and
    across "pod" (equal to the input's bf16 rounding without ``err``, to
    its int8 round trip with it), and a small tree saved from DTensors
    and restored by ``shardings=``.  One card shows no multi-rank
    result: the CPU tests hold those in 8 gloo ranks."""
    assert dev.type == "cuda" and torch.cuda.is_available(), dev
    t_start = time.perf_counter()
    parity = compression_parity(dev)
    t_parity = time.perf_counter() - t_start
    r = one_rank_placement(dev, granite_3_2b.make_config(), COMPRESS_SHAPE)
    seconds = time.perf_counter() - t_start
    assert seconds <= PLACEMENT_PHASE_S, seconds
    log(f"  {parity} ({t_parity:.1f} s); a one-rank NCCL group, mesh "
        f"{r['mesh'].shape} {r['mesh'].axis_names}: granite-3-2b's "
        f"{r['n_params']} parameters placed by param_pspecs "
        f"({r['n_sharded']} with a sharded dim), each local tensor on "
        f"cuda:0 equal to its input; hierarchical_psum_mean over ('data', "
        f"'model') and 'pod' equal to the input's bf16 rounding without "
        f"err and its int8 round trip with it; a DTensor tree saved and "
        f"restored by shardings= bitwise.  One card shows no multi-rank "
        f"result (the CPU tests hold those in 8 gloo ranks).  "
        f"{seconds:.1f} s of {PLACEMENT_PHASE_S:.0f} [{card}]")


# ---------------------------------------------------------------------------
# phase 22: the sharded execution
# ---------------------------------------------------------------------------

# 4 ranks on the one card over gloo (NCCL refuses two ranks on a device),
# the (2, 2) ("data", "model") mesh of tests/test_distributed.py's rules
SHARD_MESH, SHARD_AXES = (2, 2), ("data", "model")
SHARD_LAYERS, SHARD_BATCH, SHARD_SEQ = 2, 4, 2048
SHARD_DECODE, SHARD_STEPS, SHARD_LR = 8, 3, 3e-6
SHARD_USERS, SHARD_HELD, SHARD_TOPN = 512, 16, 20
SHARDED_PHASE_S, SHARD_RANK_S = 150.0, 240.0
SHARD_DIR = ROOT / "build" / "chip_smoke_sharded"


def shard_sizes(smoke: bool) -> dict:
    """Phase 22's models and inputs: granite-3-2b and qwen2-moe-a2.7b at
    their published widths cut to ``SHARD_LAYERS`` layers, BERT4Rec at
    its published config, DimeNet's ``molecule`` cell; ``smoke``: the
    smoke configs at small sizes (the CPU rehearsal)."""
    if smoke:
        return dict(granite=granite_3_2b.smoke_config(),
                    qwen=qwen2_moe_a2_7b.smoke_config(),
                    bert4rec=bert4rec_cfg.smoke_config(),
                    dimenet=dimenet_cfg.make_config("molecule", smoke=True),
                    cell=dimenet_cfg.SMOKE_CELLS["molecule"], batch=4,
                    seq=16, decode=4, users=16, held=4)
    cut = dict(n_layers=SHARD_LAYERS)
    return dict(granite=dataclasses.replace(granite_3_2b.make_config(), **cut),
                qwen=dataclasses.replace(qwen2_moe_a2_7b.make_config(), **cut),
                bert4rec=bert4rec_cfg.make_config(),
                dimenet=dimenet_cfg.make_config("molecule"),
                cell=dimenet_cfg.CELLS["molecule"], batch=SHARD_BATCH,
                seq=SHARD_SEQ, decode=SHARD_DECODE, users=SHARD_USERS,
                held=SHARD_HELD)


def shard_inputs(sz: dict, dev) -> dict:
    """The seeded inputs every rank and the single-device runs share."""
    gc, qc, bc = sz["granite"], sz["qwen"], sz["bert4rec"]
    b, s = sz["batch"], sz["seq"]
    batch = train_lm.synthetic_lm_batch(np.random.default_rng(22), b, s,
                                        gc.vocab_size, dev)
    rng = np.random.default_rng(23)
    local, whole = dimenet_cfg.partitioned_batch(
        sz["cell"], math.prod(SHARD_MESH), seed=24, device=dev)
    return dict(
        batch=batch,
        next=torch.as_tensor(rng.integers(0, gc.vocab_size,
                                          (b, sz["decode"])), device=dev),
        qwen=torch.as_tensor(rng.integers(0, qc.vocab_size, (b, s)),
                             device=dev),
        ids=torch.as_tensor(rng.integers(2, bc.vocab,
                                         (sz["users"], bc.seq_len)),
                            device=dev),
        graph=local, graph_whole=whole)


def seeded(dev, seed):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return gen


def no_drop(c):
    """``c`` with the capacity at every token (no assignment dropped)."""
    return dataclasses.replace(c, capacity_factor=c.e_pad / c.top_k)


@contextlib.contextmanager
def counting_drops(out: list):
    """Each ``_moe_local`` call's dropped (token, k) assignments to its
    experts appended to ``out``."""
    real = transformer.dispatch_slots

    def counted(experts, n_local, expert_offset, capacity):
        keep, slot = real(experts, n_local, expert_offset, capacity)
        flat = experts.reshape(-1)
        mine = (flat >= expert_offset) & (flat < expert_offset + n_local)
        out.append(int((mine & ~keep).sum()))
        return keep, slot
    transformer.dispatch_slots = counted
    try:
        yield out
    finally:
        transformer.dispatch_slots = real


def lm_serve_fixed(model, tokens, nxt, mesh=None, rules=None) -> list:
    """The prompts prefilled, then one decode step per column of ``nxt``
    (fixed tokens, not greedy): every step's f32 logits [B, V], whole."""
    from repro_torch.parallel import spmd
    with torch.no_grad():
        logits, caches = model.prefill(tokens, tokens.shape[1]
                                       + nxt.shape[1], mesh, rules)
        out = [spmd.gather_full(logits)]
        for i in range(nxt.shape[1]):
            logits, caches = model.decode_step(
                caches, nxt[:, i:i + 1], tokens.shape[1] + i, mesh, rules)
            out.append(spmd.gather_full(logits))
    return out


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def sharded_rank(rank: int, world: int, store: str, outdir: str,
                 smoke: bool) -> None:
    """One rank of phase 22: a gloo process group over ``world`` ranks on
    ``cuda:0`` (the CPU with ``smoke``), the ``SHARD_MESH`` DeviceMesh,
    and the sharded paths, each model built from its seed and placed by
    its ``param_pspecs`` (``spmd.shard_module``), launch counts reset
    before each path and read after it.  Rank 0 pickles the gathered
    results to ``outdir``; every rank its counts and seconds."""
    import datetime
    import pickle

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.parallel import spmd
    from repro_torch.parallel.sharding import ShardingRules
    dev = torch.device("cpu" if smoke else "cuda")
    if dev.type == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        build.library()
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=90))
    mesh_ = init_device_mesh(dev.type, SHARD_MESH, mesh_dim_names=SHARD_AXES)
    shape = MeshShape(SHARD_AXES, SHARD_MESH)
    rules = ShardingRules(batch=("data",), fsdp=("data",))
    sz = shard_sizes(smoke)
    inp = shard_inputs(sz, dev)
    res, counts, secs, drops_of = {}, {}, {}, {}

    def placed(module, mod, c):
        return spmd.shard_module(module, mesh_, mod.param_pspecs(c, shape,
                                                                rules))

    def timed(name, fn):
        build.reset_launch_counts()
        sync(dev)
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        secs[name] = time.perf_counter() - t0
        counts[name] = dict(build.launch_counts)
        return out

    # granite-3-2b: prefill and decode, then AdamW steps under remat "full"
    gc = sz["granite"]
    model = placed(transformer.init_params(gc, seeded(dev, 22), dev),
                   transformer, gc)
    res["granite_logits"] = [x.cpu() for x in timed(
        "granite_serve", lambda: lm_serve_fixed(
            model, inp["batch"]["tokens"], inp["next"], mesh_, rules))]
    opt = optimizers.adamw(model.parameters(), lr=SHARD_LR,
                           total_steps=10000)
    step = transformer.make_train_step(gc, opt, mesh_, rules)

    def train():
        opt.zero_grad(set_to_none=True)
        loss = transformer.lm_loss(model, inp["batch"], gc, mesh_, rules)
        loss.backward()
        grads = {n: spmd.gather_full(p.grad).cpu()
                 for n, p in model.named_parameters()}
        opt.step()
        losses = [float(loss.detach())]
        for _ in range(SHARD_STEPS - 1):
            losses.append(float(step(model, inp["batch"])["loss"]))
        return losses, grads, float(opt.last_gnorm)
    res["granite_losses"], grads, res["granite_gnorm"] = timed(
        "granite_train", train)
    if rank == 0:
        torch.save(grads, str(Path(outdir) / "granite_grads.pt"))
    del model, opt, step, grads
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # qwen2-moe-a2.7b: prefill with no drop, then at its own factor
    qc = sz["qwen"]
    model = placed(transformer.init_params(qc, seeded(dev, 25), dev),
                   transformer, qc)
    for name, c in (("qwen_nodrop", no_drop(qc)), ("qwen_own", qc)):
        model.config = c
        drops: list = []
        with counting_drops(drops):
            logits = timed(name, lambda: lm_serve_fixed(
                model, inp["qwen"], inp["next"][:, :0], mesh_, rules)[0])
        res[name] = logits.cpu()
        drops_of[name] = sum(drops)
    del model
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # BERT4Rec at its published config: the sharded serve_step
    bc = sz["bert4rec"]
    model = placed(bert4rec.init_params(bc, seeded(dev, 26), dev), bert4rec,
                   bc)
    vals, ids = timed("bert4rec", lambda: bert4rec.serve_step(
        model, {"ids": inp["ids"]}, bc, top_n=SHARD_TOPN, mesh=mesh_,
        rules=rules))
    res["bert4rec"] = (spmd.gather_full(vals).cpu(),
                       spmd.gather_full(ids).cpu())
    del model

    # DimeNet molecule: forward_sharded and one AdamW step, in f32 and in
    # f64 (dimenet_held says why)
    for dtype in (torch.float32, torch.float64):
        dc = dataclasses.replace(sz["dimenet"], dtype=dtype)
        model = placed(dimenet.init_params(dc, seeded(dev, 27), dev),
                       dimenet, dc)
        opt = optimizers.adamw(model.parameters(), lr=SHARD_LR,
                               total_steps=10000)

        def gnn():
            with torch.no_grad():
                pred = dimenet.forward_sharded(model, inp["graph"], dc,
                                               mesh_, rules).to_local()
            loss = dimenet.make_train_step(dc, opt, mesh_, rules)(
                model, inp["graph"])["loss"]
            return pred.cpu(), float(loss), float(opt.last_gnorm)
        key = f"dimenet_{str(dtype)[-7:]}"
        pred, loss, gnorm = timed(key, gnn)
        res[key] = dict(pred=pred, loss=loss, gnorm=gnorm, params={
            n: spmd.gather_full(p.detach()).cpu()
            for n, p in model.named_parameters()})
    dist.destroy_process_group()
    mine = {"counts": counts, "seconds": secs, "drops": drops_of,
            **({"results": res} if rank == 0 else {})}
    tmp = Path(outdir) / f"rank{rank}.pkl.tmp"
    with open(tmp, "wb") as f:
        pickle.dump(mine, f)
    tmp.replace(Path(outdir) / f"rank{rank}.pkl")


def run_shard_ranks(smoke: bool) -> list:
    """Phase 22's ranks (:func:`run_script_ranks`)."""
    return run_script_ranks("--shard-rank", SHARD_DIR, smoke, SHARD_RANK_S,
                            "phase 22")


def run_script_ranks(flag: str, directory: Path, smoke: bool,
                     timeout: float, what: str) -> list:
    """``SHARD_MESH``'s ranks as processes of this script (``flag`` rank
    world store directory mode), each logging to
    ``directory/rank<r>.log``; returns what each pickled (raises with the
    failing ranks' log tails)."""
    import pickle
    world = math.prod(SHARD_MESH)
    shutil.rmtree(directory, ignore_errors=True)
    directory.mkdir(parents=True)
    store = directory / "store"
    procs, logs = [], []
    try:
        for r in range(world):
            logs.append(open(directory / f"rank{r}.log", "w"))
            procs.append(subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), flag,
                 str(r), str(world), str(store), str(directory),
                 "smoke" if smoke else "card"],
                stdout=logs[-1], stderr=subprocess.STDOUT, cwd=str(ROOT)))
        deadline = time.monotonic() + timeout
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        tails = "\n".join(f"rank {r}:\n" + (directory / f"rank{r}.log")
                          .read_text()[-3000:] for r in bad[:2])
        raise AssertionError(f"{what}: ranks {bad} failed\n{tails}")
    out = []
    for r in range(world):
        with open(directory / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def rel_err(a, b) -> float:
    """max |a − b| / max |b| in f32."""
    a, b = a.float(), b.float().to(a.device)
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def single_lm_logits(c, seed, tokens, nxt, dev, plain=False, f32=False):
    """The single-device route's prefill and fixed-token decode logits
    of the model made from ``seed`` (``f32``: its bf16-valued weights in
    f32, through the plain versions)."""
    cc = dataclasses.replace(c, dtype=torch.float32) if f32 else c
    model = transformer.init_params(cc, seeded(dev, seed), dev)
    if f32:
        bf16_valued(model)
    with ops.default_impl("ref") if plain or f32 \
            else contextlib.nullcontext():
        out = lm_serve_fixed(model, tokens, nxt)
    del model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def logit_gate(got, kern, plain, full, what) -> str:
    """Each step's sharded logits against the single-device kernel run's
    by ``LM_LOGIT_BOUND`` times the plain run's own error against f32."""
    worst = []
    for i, (g, k, p, f) in enumerate(zip(got, kern, plain, full)):
        e, b = rel_err(g, k), rel_err(p, f)
        assert e <= LM_LOGIT_BOUND * b, (what, i, e, b)
        worst.append(e / max(b, 1e-30))
    return (f"{what}: {len(got)} logit rows (max |Δ| / max |logit| at most "
            f"{max(worst):.3f}x the plain run's error against f32, bound "
            f"{LM_LOGIT_BOUND}x)")


def sharded_execution_path(dev, card, smoke: bool = False) -> dict:
    """Phase 22 (before phase 23): the sharded execution in ``SHARD_MESH``
    gloo ranks on the one card against one-process single-device runs of the
    same weights: granite-3-2b (prefill, fixed-token decode, step-1
    gradients by the gradient gate, AdamW steps), qwen2-moe-a2.7b's
    prefill with and without drops, BERT4Rec's sharded top-n against
    one full product, DimeNet's ``forward_sharded`` and a step.  Returns
    the ranks' B9 / 9b launches on their paths, summed."""
    t_start = time.perf_counter()
    sz = shard_sizes(smoke)
    inp = shard_inputs(sz, dev)
    gc, qc = sz["granite"], sz["qwen"]
    toks, nxt = inp["batch"]["tokens"], inp["next"]
    # the single-device references first, then the card is freed
    g_kern = single_lm_logits(gc, 22, toks, nxt, dev)
    g_plain = single_lm_logits(gc, 22, toks, nxt, dev, plain=True)
    g_full = single_lm_logits(gc, 22, toks, nxt, dev, f32=True)
    _, gk = lm_step1_grads(gc, 22, inp["batch"], dev, plain=False)
    _, gp = lm_step1_grads(gc, 22, inp["batch"], dev, plain=True)
    _, gf = lm_step1_grads(gc, 22, inp["batch"], dev, plain=True, f32=True)
    grad_bound = {n: rel_err(gp[n], gf[n]) for n in gk}
    gk = {n: g.cpu() for n, g in gk.items()}
    del gp, gf
    empty = nxt[:, :0]
    drops: list = []
    with counting_drops(drops):
        q_kern = single_lm_logits(no_drop(qc), 25, inp["qwen"], empty, dev)
    q_drops = sum(drops)
    q_plain = single_lm_logits(no_drop(qc), 25, inp["qwen"], empty, dev,
                               plain=True)
    q_full = single_lm_logits(no_drop(qc), 25, inp["qwen"], empty, dev,
                              f32=True)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter() - t_start

    t0 = time.perf_counter()
    ranks = run_shard_ranks(smoke)
    t_ranks = time.perf_counter() - t0
    res = ranks[0]["results"]

    lines = [logit_gate(res["granite_logits"], g_kern, g_plain, g_full,
                        f"granite prefill + {sz['decode']} decode steps")]
    sharded = torch.load(str(SHARD_DIR / "granite_grads.pt"))
    worst = 0.0
    for n, g in gk.items():
        e = rel_err(sharded[n].to(dev), g.to(dev))
        assert e <= LM_GRAD_BOUND * grad_bound[n], (n, e, grad_bound[n])
        worst = max(worst, e / max(grad_bound[n], 1e-30))
    assert all(math.isfinite(x) for x in res["granite_losses"]), \
        res["granite_losses"]
    lines.append(f"granite step-1 gradients of {len(gk)} leaves: at most "
                 f"{worst:.3f}x the plain run's error against f32 (bound "
                 f"{LM_GRAD_BOUND}x); losses {res['granite_losses']}, "
                 f"step-{SHARD_STEPS} pre-clip norm {res['granite_gnorm']:.4f}")
    sharded_drops = [r["drops"]["qwen_nodrop"] for r in ranks]
    assert q_drops == 0 and not any(sharded_drops), (q_drops, sharded_drops)
    lines.append(logit_gate([res["qwen_nodrop"]], q_kern, q_plain, q_full,
                            f"qwen2-moe prefill at capacity factor "
                            f"{no_drop(qc).capacity_factor:g}")
                 + f", dropped assignments {q_drops} single-device and "
                 f"{sum(sharded_drops)} sharded; at the config's "
                 f"{qc.capacity_factor:g} each rank dropped "
                 f"{[r['drops']['qwen_own'] for r in ranks]} of its "
                 f"experts' (capacity from its own tokens)")
    lines.append(bert4rec_held(sz, inp, res["bert4rec"], dev))
    lines.append(dimenet_held(sz, inp, res, dev))

    counts = {name: 0 for name in KERNELS}
    per = {}
    for r, got in enumerate(ranks):
        c = got["counts"]
        if dev.type == "cuda":
            L, S = gc.n_layers, SHARD_STEPS
            assert c["granite_serve"]["flash_attention"] == L, (r, c)
            assert c["granite_serve"]["flash_attention_bwd"] == 0, (r, c)
            assert c["granite_train"]["flash_attention"] == 2 * L * S, (r, c)
            assert c["granite_train"]["flash_attention_bwd"] == L * S, (r, c)
            for q in ("qwen_nodrop", "qwen_own"):
                assert c[q]["flash_attention"] == qc.n_layers, (r, q, c)
        for path in c.values():
            for name, n in path.items():
                if name in counts:
                    counts[name] += n
        per[r] = {k: round(v, 2) for k, v in got["seconds"].items()}
    seconds = time.perf_counter() - t_start
    if not smoke:
        reduced = {f"{name} n_layers": (
            f"{full} → {SHARD_LAYERS} (phase 22's {SHARDED_PHASE_S:.0f} s "
            f"for 4 processes on one card)")
            for name, full in (("granite-3-2b",
                                granite_3_2b.make_config().n_layers),
                               ("qwen2-moe-a2.7b",
                                qwen2_moe_a2_7b.make_config().n_layers))}
        lines.insert(0, f"reduced: {reduced}")
    for line in lines:
        log(f"  {line}")
    log(f"  launches over the {len(ranks)} ranks: B9 "
        f"{counts['flash_attention']}, 9b {counts['flash_attention_bwd']}; "
        f"seconds a rank (4 processes on one card, collectives staged "
        f"through host memory: correctness, not speed) {per}")
    log(f"  phase 22: single-device references {t_ref:.1f} s, ranks "
        f"{t_ranks:.1f} s, {seconds:.1f} s of {SHARDED_PHASE_S:.0f} [{card}]")
    if not smoke:
        assert seconds <= SHARDED_PHASE_S, seconds
    shutil.rmtree(SHARD_DIR, ignore_errors=True)
    return counts


def bert4rec_held(sz, inp, got, dev) -> str:
    """The sharded top-n of the first ``held`` users against one full
    product over every catalogue row: scores within 1e-4 of it, each
    item identical or scoring the same as the reference's at its rank
    (0 mismatches)."""
    bc, held = sz["bert4rec"], sz["held"]
    model = bert4rec.init_params(bc, seeded(dev, 26), dev)
    with torch.no_grad():
        q = bert4rec.encoder(model, inp["ids"][:held], bc)[:, -1, :]
        scores = (q @ model.item_emb.T + model.out_bias).float()
    want_v, want_i = ref.topk_lowest_index(scores, SHARD_TOPN)
    vals, ids = got[0][:held].to(dev), got[1][:held].to(dev).long()
    err = float((vals - want_v).abs().max())
    scale = float(want_v.abs().max())
    tol = 1e-4 * max(1.0, scale)
    assert err <= tol, (err, tol)
    same = ids == want_i
    alt = (scores.gather(1, ids) - want_v).abs() <= tol
    mismatch = int((~same & ~alt).sum())
    assert mismatch == 0, mismatch
    del model
    return (f"BERT4Rec sharded serve_step for {sz['users']} users; the "
            f"first {held} against one full product over "
            f"{bc.vocab} rows: scores within {err:.2e} (tol {tol:.1e}), "
            f"{int(same.sum())} of {same.numel()} items identical, the "
            f"rest score-equivalent, 0 mismatches")


def dimenet_single(dc, inp, dev) -> dict:
    """The single-device forward and one AdamW step on the globalized
    indices, from the seed the ranks use."""
    model = dimenet.init_params(dc, seeded(dev, 27), dev)
    opt = optimizers.adamw(model.parameters(), lr=SHARD_LR,
                           total_steps=10000)
    with torch.no_grad():
        pred = dimenet.forward(model, inp["graph_whole"], dc)
    loss = float(dimenet.make_train_step(dc, opt)(
        model, inp["graph_whole"])["loss"])
    return dict(pred=pred, loss=loss, gnorm=float(opt.last_gnorm),
                params={n: p.detach() for n, p in model.named_parameters()})


def dimenet_held(sz, inp, res, dev) -> str:
    """``forward_sharded`` and one sharded AdamW step against the
    single-device forward and step on the globalized indices.  In f64 at
    rtol=1e-4, atol=1e-5: the molecule cell's random f32 weights give
    sums that cancel, so on the card (whose ``index_add`` adds in no
    fixed order) f32 rounding alone moved one prediction by 1.6e-4 of
    itself between two routes (NVIDIA H100 80GB HBM3 at 700 W).  In f32 the sharded predictions within 1e-4 of max |pred| of the
    f64 single-device forward, the single-device f32 route's own
    distance logged beside."""
    dc = sz["dimenet"]
    one = {dt: dimenet_single(dataclasses.replace(dc, dtype=dt), inp, dev)
           for dt in (torch.float32, torch.float64)}
    got = res["dimenet_float64"]
    want = one[torch.float64]
    tol = dict(rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(got["pred"].to(dev), want["pred"], **tol)
    assert math.isclose(got["loss"], want["loss"], rel_tol=1e-4,
                        abs_tol=1e-5), (got["loss"], want["loss"])
    for n, p in want["params"].items():
        torch.testing.assert_close(got["params"][n].to(dev), p, **tol,
                                   msg=n)
    f32 = res["dimenet_float32"]["pred"].to(dev)
    e = rel_err(f32, want["pred"])
    b = rel_err(one[torch.float32]["pred"], want["pred"])
    assert e <= 1e-4, (e, b)
    return (f"DimeNet molecule ({sz['cell']['n_edges']} edges in "
            f"{math.prod(SHARD_MESH)} partitions): forward_sharded and one "
            f"AdamW step against the single-device ones on the globalized "
            f"indices, f64 (rtol=1e-4, atol=1e-5): max |Δpred| "
            f"{float((got['pred'].to(dev) - want['pred']).abs().max()):.3e}"
            f", loss {got['loss']:.6g} vs {want['loss']:.6g}, gradient "
            f"norm {got['gnorm']:.6g} vs {want['gnorm']:.6g}; f32 against "
            f"the f64 single-device forward: max |Δpred| / max |pred| "
            f"{e:.3e} sharded (bound 1e-4), {b:.3e} single-device"
            f", loss {res['dimenet_float32']['loss']:.6g} vs "
            f"{one[torch.float32]['loss']:.6g}")


# ---------------------------------------------------------------------------
# phase 23: the recommender cells under the mesh
# ---------------------------------------------------------------------------

# the 16 recommender cells through dryrun's mesh route, on phase 22's
# (2, 2) mesh in 4 gloo ranks on cuda:0
MESH_ARCHS = ("dlrm-mlperf", "deepfm", "two-tower-retrieval", "bert4rec")
MESH_CELLS = [(a, s) for a in MESH_ARCHS for s in
              ("train_batch", "serve_p99", "serve_bulk", "retrieval_cand")]
MESH_RETRIEVERS = ("two-tower-retrieval", "bert4rec")
MESH_SEED, MESH_PHASE_S, MESH_RANK_S = 23, 150.0, 240.0
MESH_DIR = ROOT / "build" / "chip_smoke_mesh"
# the rows a cell runs at where they are fewer than its published ones
# (time: the 4 ranks' collectives all go through host memory)
MESH_ROWS = {("dlrm-mlperf", "train_batch"): 8192,
             ("dlrm-mlperf", "serve_bulk"): 16384,
             ("dlrm-mlperf", "retrieval_cand"): 16384,
             ("deepfm", "serve_bulk"): 65536,
             ("deepfm", "retrieval_cand"): 65536,
             ("two-tower-retrieval", "train_batch"): 8192,
             ("two-tower-retrieval", "serve_bulk"): 65536,
             ("bert4rec", "train_batch"): 4096,
             ("bert4rec", "serve_bulk"): 8192}
# a train cell's parameters of more than this many elements are held at
# the first MESH_PROBE rows its step touched and MESH_PROBE seeded others
MESH_PROBE_LIMIT, MESH_PROBE = 1 << 24, 256


def mesh_cell_sizes(name, shape, smoke):
    """(sizes, reduced) of phase 23's cell: the published widths; every
    DLRM cell's vocabularies at the training cap; ``MESH_ROWS``."""
    from repro_torch.configs.base import Sizes, gb
    if smoke:
        return smoke_sizes(name, shape), {}
    pub = get_arch(name).cells[shape].published
    c, reduced = pub.config, {}
    if name == "dlrm-mlperf":
        cap = dlrm_mlperf.TRAIN_VOCAB_CAP
        cut = dataclasses.replace(c, vocab_sizes=tuple(
            min(v, cap) for v in c.vocab_sizes))
        reduced["vocab_sizes"] = (
            f"{c.table.total_rows:,} → {cut.table.total_rows:,} rows "
            f"(memory: each vocabulary capped at 2^22, the training cap, "
            f"in every DLRM cell: the 4 ranks share the card and a sharded "
            f"table still sums to its whole "
            f"{gb(4 * cut.table.padded_rows() * cut.embed_dim)}, which "
            f"training's gradient and AdamW's m and v triple)")
        c = cut
    rows = MESH_ROWS.get((name, shape), pub.batch)
    if rows != pub.batch:
        reduced["batch"] = (f"{pub.batch:,} → {rows:,} (time: phase 23's "
                            f"{MESH_PHASE_S:.0f} s for 4 ranks on one card, "
                            f"every collective staged through host memory)")
    return Sizes(c, rows), reduced


def mesh_bytes(name, shape, sz):
    """(whole parameter bytes, replicated parameter bytes) of a cell's
    model at ``sz`` on ``SHARD_MESH`` (shapes only)."""
    cell = get_arch(name).cells[shape]
    arch = cell.module.__name__.rsplit(".", 1)[1]
    model = convert.RECSYS_MODELS[arch](sz.config, "meta")
    specs = cell.module.param_pspecs(
        sz.config, MeshShape(dryrun.MESH_AXES, SHARD_MESH),
        dryrun.mesh_rules())
    whole = repl = 0
    for n, p in model.named_parameters():
        b = p.numel() * p.element_size()
        whole += b
        if not any(specs[n].axes(d) for d in range(p.dim())):
            repl += b
    return whole, repl


def mesh_estimate(name, shape, sz, world, turns):
    """The sum of the ranks' estimated peaks: the cell's one-device
    estimate (its parameters and state and the whole batch's
    activations, which the ranks split), plus on each other rank the
    replicated parameters (with their gradient and AdamW's m and v when
    training), plus the whole model a building rank holds before it keeps
    its blocks (one at a time in ``turns``, else every rank at once)."""
    cell = get_arch(name).cells[shape]
    whole, repl = mesh_bytes(name, shape, sz)
    return (cell.peak(sz) + (world - 1) * repl * (4 if cell.train else 1)
            + whole * (1 if turns else world))


def b3_on_block(call) -> dict:
    """B3's output on a rank's block against its plain version on the
    same inputs on the same card (``dryrun.b3_plain``'s record, made in
    the rank): values within ``RS_RTOL``/``RS_ATOL``, each id the plain
    one's or tied with it."""
    (vals, idx), (pv, pi) = call["out"], call["plain"]
    torch.testing.assert_close(vals, pv, rtol=RS_RTOL, atol=RS_ATOL)
    same = idx.long() == pi.long()
    tie = (vals - pv).abs() <= RS_ATOL + RS_RTOL * pv.abs()
    assert bool((same | tie).all()), "B3: ids neither the plain ones nor tied"
    return {"max_abs_err": float((vals - pv).abs().max()),
            "identical": int(same.sum()), "n": same.numel(),
            "rows": call["rows"], "dim": call["dim"], "k": call["k"]}


def mesh_cells_path(dev, card, smoke: bool = False) -> dict:
    """Phase 23 (after phase 22): the 16 recommender cells through
    dryrun's mesh route in ``SHARD_MESH`` gloo ranks on the one card,
    each held to a one-device run of the same seed made first in this
    process (its outputs on the host, the card freed before the ranks
    start).  Returns the ranks' B3 launches in the two retrieval cells."""
    t_start = time.perf_counter()
    world = math.prod(SHARD_MESH)
    budget = PEAK_SHARE * card_bytes(dev)
    sizes, reduced, turns, est = {}, {}, [], {}
    for name, shape in MESH_CELLS:
        tag = f"{name} x {shape}"
        sizes[tag], reduced[tag] = mesh_cell_sizes(name, shape, smoke)
        whole, _ = mesh_bytes(name, shape, sizes[tag])
        if world * whole > STATE_SHARE * card_bytes(dev):
            turns.append(tag)
        est[tag] = mesh_estimate(name, shape, sizes[tag], world,
                                 tag in turns)
        assert smoke or est[tag] <= budget, (tag, est[tag], budget)
    one, probes = {}, {}
    for name, shape in MESH_CELLS:
        tag = f"{name} x {shape}"
        one[tag], probes[tag] = dryrun.one_device(
            name, shape, world, dev, MESH_SEED, sizes[tag],
            probe=(MESH_PROBE_LIMIT, MESH_PROBE))
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    t_ref = time.perf_counter() - t_start

    t0 = time.perf_counter()
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    ranks = dryrun.run_ranks(
        MESH_CELLS, SHARD_MESH, str(MESH_DIR), dev.type, smoke, MESH_SEED,
        probes, MESH_RANK_S, sizes, turns=turns)
    t_ranks = time.perf_counter() - t0
    counts = {name: 0 for name in KERNELS}
    for i, (name, shape) in enumerate(MESH_CELLS):
        tag = f"{name} x {shape}"
        per = [rank[i] for rank in ranks]
        how = dryrun.held(one[tag], per[0]["kept"], tag)
        line = (f"  {tag}: {per[0]['description']} at "
                f"{sizes[tag].batch:,} rows; cuts {reduced[tag] or 'none'}; "
                f"sum of the ranks' estimated peaks {est[tag] / 1e9:.1f} GB"
                f"{' (built in turns)' if tag in turns else ''}; held to "
                f"the one-device run: {how}")
        if shape == "retrieval_cand" and name in MESH_RETRIEVERS:
            b3 = [b3_on_block(r["b3_call"]) for r in per]
            launches = [r["launches"].get("knn_topk", 0) for r in per]
            assert all(b3), (tag, b3)
            assert dev.type != "cuda" or all(launches), (tag, launches)
            counts["knn_topk"] += sum(launches)
            line += (f"; B3 on each rank's block of {b3[0]['rows']:,} x "
                     f"{b3[0]['dim']} candidates, launches by rank "
                     f"{launches}, against its plain version max |Δ| "
                     f"{max(b['max_abs_err'] for b in b3):.2e}, "
                     f"{sum(b['identical'] for b in b3)} of "
                     f"{sum(b['n'] for b in b3)} ids identical, the rest "
                     f"tied")
        if dev.type == "cuda":
            assert sum(r["peak_bytes"] for r in per) <= \
                per[0]["device_bytes"], (tag, [r["peak_bytes"] for r in per])
        log(line)
        for row in dryrun.rank_rows(per, dev.type == "cuda").split("\n"):
            log(f"  {row} [{card}]")
    seconds = time.perf_counter() - t_start
    log(f"  phase 23: one-device runs {t_ref:.1f} s, ranks {t_ranks:.1f} s, "
        f"{seconds:.1f} s of {MESH_PHASE_S:.0f}; B3 launches over the "
        f"ranks {counts['knn_topk']} [{card}]")
    if not smoke:
        assert seconds <= MESH_PHASE_S, seconds
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    return counts


# ---------------------------------------------------------------------------
# phase 24: tifu-knn's cells under the mesh, and Adafactor over DTensor
# ---------------------------------------------------------------------------

TIFU_MESH_CELLS = [("tifu-knn", s) for s in ("stream_update", "serve_topk",
                                             "serve_topk_opt")]
# the users phase 24's cells hold (of 1,048,576): 17.0 GiB of stream
# state, an 8 GiB corpus
TIFU_MESH_USERS = 131_072
TIFU_MESH_SEED, TIFU_MESH_PHASE_S, TIFU_MESH_RANK_S = 24, 150.0, 240.0
TIFU_MESH_DIR = ROOT / "build" / "chip_smoke_tifu_mesh"
# the stream state held at the rows of the first this many users its
# batch names and as many seeded others (dryrun.probe_ids)
TIFU_MESH_PROBE = 1024
# Adafactor on DeepSeek-V3's published leaf shapes: (shape, spec) of an
# MLA down-projection (d_model x q_lora_rank), a stack of 8 experts'
# [d_model, moe_d_ff] and a norm; two steps, held to one device
ADAFACTOR_LEAVES = {"mla_down": ((7168, 1536), ("data", "model")),
                    "experts": ((8, 7168, 2048), (None, "data", "model")),
                    "norm": ((7168,), ())}
ADAFACTOR_SMOKE = {"mla_down": ((256, 128), ("data", "model")),
                   "experts": ((2, 256, 128), (None, "data", "model")),
                   "norm": ((256,), ())}
ADAFACTOR_STEPS, ADAFACTOR_SEED = 2, 25
ADAFACTOR_TOL = dict(rtol=1e-5, atol=1e-7)
ADAFACTOR_DIR = ROOT / "build" / "chip_smoke_adafactor"


def adafactor_leaves(smoke: bool, dev) -> tuple:
    """The seeded leaves and each step's gradients on ``dev``: (names,
    {name: (param, [grad per step], spec)})."""
    leaves = ADAFACTOR_SMOKE if smoke else ADAFACTOR_LEAVES
    gen = seeded(dev, ADAFACTOR_SEED)
    out = {}
    for name, (shape, spec) in leaves.items():
        p = torch.randn(shape, generator=gen, device=dev) * 0.02
        grads = [torch.randn(shape, generator=gen, device=dev) * 1e-3
                 for _ in range(ADAFACTOR_STEPS)]
        out[name] = (p, grads, Spec(*spec))
    return sorted(leaves), out


def adafactor_rank(rank: int, world: int, store: str, outdir: str,
                   smoke: bool) -> None:
    """One rank of phase 24's Adafactor check: a gloo process group on
    ``cuda:0`` (the CPU with ``smoke``), the ``SHARD_MESH`` DeviceMesh,
    the seeded leaves as DTensor parameters of their specs, two
    ``optimizers.adafactor`` steps, every parameter and state leaf
    gathered whole; rank 0 runs the one-device Adafactor on the same
    values on the same card and pickles the worst difference of each
    leaf, every rank its seconds."""
    import datetime
    import pickle

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.parallel import spmd
    dev = torch.device("cpu" if smoke else "cuda")
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=90))
    mesh_ = init_device_mesh(dev.type, SHARD_MESH, mesh_dim_names=SHARD_AXES)
    names, leaves = adafactor_leaves(smoke, dev)
    t0 = time.perf_counter()
    params = [torch.nn.Parameter(spmd.from_local(
        spmd.local_block(leaves[n][0], mesh_, leaves[n][2]).clone(), mesh_,
        leaves[n][2])) for n in names]
    opt = optimizers.adafactor(params)
    for step in range(ADAFACTOR_STEPS):
        for n, p in zip(names, params):
            g, spec = leaves[n][1][step], leaves[n][2]
            p.grad = spmd.from_local(
                spmd.local_block(g, mesh_, spec).clone(), mesh_, spec)
        opt.step()
    sync(dev)
    step_s = time.perf_counter() - t0
    got = {n: {"param": spmd.gather_full(p.detach()),
               **{k: spmd.gather_full(v) for k, v in opt.state[p].items()}}
           for n, p in zip(names, params)}
    dist.destroy_process_group()
    mine = {"seconds": step_s}
    if rank == 0:
        one = [torch.nn.Parameter(leaves[n][0].clone()) for n in names]
        ref_opt = optimizers.adafactor(one)
        for step in range(ADAFACTOR_STEPS):
            for n, p in zip(names, one):
                p.grad = leaves[n][1][step].clone()
            ref_opt.step()
        errs = {}
        for n, p in zip(names, one):
            want = {"param": p.detach(), **ref_opt.state[p]}
            assert set(want) == set(got[n]), (n, set(want), set(got[n]))
            for k, w in want.items():
                torch.testing.assert_close(got[n][k], w, **ADAFACTOR_TOL,
                                           msg=lambda m: f"{n}.{k}: {m}")
                errs[f"{n}.{k}"] = (float((got[n][k] - w).abs().max()),
                                    tuple(w.shape))
            moved = float((p.detach() - leaves[n][0]).abs().max())
            assert moved > 0, f"{n} did not move"
        mine["errors"] = errs
    tmp = Path(outdir) / f"rank{rank}.pkl.tmp"
    with open(tmp, "wb") as f:
        pickle.dump(mine, f)
    tmp.replace(Path(outdir) / f"rank{rank}.pkl")


def tifu_mesh_sizes(smoke: bool) -> tuple:
    """(sizes, reduced) of phase 24's cells: the published widths with
    ``TIFU_MESH_USERS`` users (``SMOKE_SIZES`` with ``smoke``)."""
    if smoke:
        return tifu_knn.SMOKE_SIZES, {}
    sz = tifu_knn.Sizes(n_users=TIFU_MESH_USERS,
                        stream_users=TIFU_MESH_USERS)
    pub = tifu_knn.Sizes()
    gib = 2 ** 30
    return sz, {"n_users": (
        f"{pub.n_users:,} → {sz.n_users:,} (time and memory: phase 24's "
        f"{TIFU_MESH_PHASE_S:.0f} s for 4 ranks on one card, every rank "
        f"drawing every user's history from the seed; the stream state "
        f"{tifu_knn.state_bytes(pub.n_users, pub) / gib:.1f} GiB at "
        f"{pub.n_users:,}, {tifu_knn.state_bytes(sz.n_users, sz) / gib:.1f}"
        f" GiB here, whose one-device twin runs on the same card first; "
        f"the corpus {4 * pub.n_users * pub.n_items / gib:.0f} GiB, "
        f"{4 * sz.n_users * sz.n_items / gib:.0f} GiB here)")}


def tifu_mesh_path(dev, card, smoke: bool = False) -> dict:
    """Phase 24 (after phase 23): tifu-knn's three cells through dryrun's
    mesh route in ``SHARD_MESH`` gloo ranks on the one card, each held to
    a one-device run of the same seed made first here (moved to the
    host, the card freed); B1 and B2 on every rank in ``stream_update``,
    B3 once a rank in each serve cell, held to its plain version on the
    rank's block; then Adafactor on DeepSeek-V3's leaf shapes in the
    ranks against one device.  Returns the ranks' launches."""
    t_start = time.perf_counter()
    world = math.prod(SHARD_MESH)
    sz, reduced = tifu_mesh_sizes(smoke)
    sizes = {f"{n} x {s}": sz for n, s in TIFU_MESH_CELLS}
    one, probes = {}, {}
    for name, shape in TIFU_MESH_CELLS:
        tag = f"{name} x {shape}"
        one[tag], probes[tag] = dryrun.one_device(
            name, shape, world, dev, TIFU_MESH_SEED, sz,
            probe=(MESH_PROBE_LIMIT, TIFU_MESH_PROBE))
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    t_ref = time.perf_counter() - t_start

    t0 = time.perf_counter()
    shutil.rmtree(TIFU_MESH_DIR, ignore_errors=True)
    ranks = dryrun.run_ranks(
        TIFU_MESH_CELLS, SHARD_MESH, str(TIFU_MESH_DIR), dev.type, smoke,
        TIFU_MESH_SEED, probes, TIFU_MESH_RANK_S, sizes)
    t_ranks = time.perf_counter() - t0
    counts = {name: 0 for name in KERNELS}
    for i, (name, shape) in enumerate(TIFU_MESH_CELLS):
        tag = f"{name} x {shape}"
        per = [rank[i] for rank in ranks]
        how = dryrun.held(one[tag], per[0]["kept"], tag)
        launched = {k: [r["launches"].get(k, 0) for r in per]
                    for k in ("sparse_row_gather", "sparse_row_scatter",
                              "knn_topk")}
        at = (f" at {len(probes[tag]['users']):,} users' rows"
              if probes[tag] else "")
        line = (f"  {tag}: {per[0]['description']}; cuts "
                f"{reduced or 'none'}; held to the one-device run{at}: "
                f"{how}; launches by rank {launched}")
        if shape == "stream_update":
            assert dev.type != "cuda" or all(
                all(launched[k]) for k in ("sparse_row_gather",
                                           "sparse_row_scatter")), launched
            for k in ("sparse_row_gather", "sparse_row_scatter"):
                counts[k] += sum(launched[k])
        else:
            assert dev.type != "cuda" or launched["knn_topk"] == \
                [1] * world, launched
            counts["knn_topk"] += sum(launched["knn_topk"])
            b3 = [b3_on_block(r["b3_call"]) for r in per]
            line += (f"; B3 on each rank's block of {b3[0]['rows']:,} "
                     f"users x {b3[0]['dim']:,} items, k={b3[0]['k']}, "
                     f"against its plain version max |Δ| "
                     f"{max(b['max_abs_err'] for b in b3):.2e}, "
                     f"{sum(b['identical'] for b in b3)} of "
                     f"{sum(b['n'] for b in b3)} ids identical, the rest "
                     f"tied")
        peaks = [r["peak_bytes"] for r in per]
        if dev.type == "cuda":
            assert sum(peaks) <= per[0]["device_bytes"], (tag, peaks)
            line += (f"; the ranks' peaks summed "
                     f"{sum(peaks) / 2 ** 30:.2f} GiB")
        log(line)
        for row in dryrun.rank_rows(per, dev.type == "cuda").split("\n"):
            log(f"  {row} [{card}]")
    shutil.rmtree(TIFU_MESH_DIR, ignore_errors=True)

    t0 = time.perf_counter()
    ada = run_script_ranks("--adafactor-rank", ADAFACTOR_DIR, smoke,
                           TIFU_MESH_RANK_S, "phase 24's Adafactor")
    t_ada = time.perf_counter() - t0
    shutil.rmtree(ADAFACTOR_DIR, ignore_errors=True)
    leaves = ADAFACTOR_SMOKE if smoke else ADAFACTOR_LEAVES
    log(f"  Adafactor over DTensor parameters, {ADAFACTOR_STEPS} steps on "
        f"DeepSeek-V3's leaf shapes "
        f"{ {n: (s, tuple(p)) for n, (s, p) in leaves.items()} } in "
        f"{world} ranks against one device on the same card (bar "
        f"{ADAFACTOR_TOL}), max |Δ| (shape): {ada[0]['errors']}; the "
        f"ranks' steps {max(r['seconds'] for r in ada):.2f} s, the part "
        f"{t_ada:.1f} s [{card}]")
    seconds = time.perf_counter() - t_start
    log(f"  phase 24: one-device runs {t_ref:.1f} s, ranks {t_ranks:.1f} s,"
        f" Adafactor {t_ada:.1f} s, {seconds:.1f} s of "
        f"{TIFU_MESH_PHASE_S:.0f}; launches over the ranks B1 "
        f"{counts['sparse_row_gather']}, B2 {counts['sparse_row_scatter']}, "
        f"B3 {counts['knn_topk']} [{card}]")
    if not smoke:
        assert seconds <= TIFU_MESH_PHASE_S, seconds
    return counts


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
    static_analysis_path(card)

    t0 = time.perf_counter()
    ds = synthetic.generate("tafeng", seed=0, scale=1.0)
    p = ds.params
    n_users, n_items = len(ds.histories), p.n_items
    assert (n_users, n_items, p.group_size, p.k_neighbors, p.alpha) == \
        (13949, 11997, 7, 300, 0.7), (n_users, n_items, p)
    log(f"data: TaFeng {n_users} users x {n_items} items generated in "
        f"{time.perf_counter() - t0:.1f} s")

    records = kernel_checks(ds, dev)
    # phase 17 next, while nothing else is resident on the card
    t0 = time.perf_counter()
    paths = [tifu_path(dev, card)[0]]
    log(f"tifu-knn at production width: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    kern, launches = main_path(ds, dev)
    log(f"main path: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    paths += [launches, dtiled_path(kern, p, dev),
              sharded_path(kern, p, dev)]
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
    paths.append(update_rules_path(ds, dev, card)[0])
    log(f"update rules: {time.perf_counter() - t0:.1f} s")
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
    # phase 18 after phase 14: it uses no profiler
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cells, _, long_recs = cells_path(dev, card)
    records["flash_attention"]["s32k"] = long_recs["granite-3-2b"]
    paths.append(cells)
    log(f"the registry's cells: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    placement_path(dev, card)
    log(f"placement and compression: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    paths.append(sharded_execution_path(dev, card))
    log(f"sharded execution: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    paths.append(mesh_cells_path(dev, card))
    log(f"recommender cells under the mesh: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    paths.append(tifu_mesh_path(dev, card))
    log(f"tifu-knn cells and Adafactor under the mesh: "
        f"{time.perf_counter() - t0:.1f} s")
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
    if sys.argv[1:2] == ["--shard-rank"]:
        # one of phase 22's rank processes (started by run_shard_ranks)
        r_, w_, store_, out_, mode_ = sys.argv[2:7]
        sharded_rank(int(r_), int(w_), store_, out_, mode_ == "smoke")
        raise SystemExit(0)
    if sys.argv[1:2] == ["--adafactor-rank"]:
        # one of phase 24's Adafactor ranks (started by run_script_ranks)
        r_, w_, store_, out_, mode_ = sys.argv[2:7]
        adafactor_rank(int(r_), int(w_), store_, out_, mode_ == "smoke")
        raise SystemExit(0)
    raise SystemExit(main())
