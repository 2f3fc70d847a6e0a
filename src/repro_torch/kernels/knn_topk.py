"""Fused similarity × streaming top-k (serving stage A, CUDA kernels).

Q queries against M corpus rows, returning each query's top-k rows of
the euclidean surrogate ``2q·c − |c|²`` (or the raw dot product) without
writing the [Q, M] score matrix to device memory.  Ties go to the lowest
row, as ``lax.top_k``.  Two kernels, one plan (corpus slices across
blocks, register-tiled products, per-slice running top-k lists merged
by a second kernel):

* :func:`launch` replaces ``repro/kernels/knn_topk.py::knn_topk``
  (``csrc/knn_topk.cu``, fp32 over the whole of D, |c|² summed in the
  kernel) on the grid :func:`plan_knn` gives; its plain version is
  ``ref.knn_topk_ref``;
* :func:`launch_dtiled` replaces ``::knn_topk_dtiled``
  (``csrc/knn_topk_dtiled.cu``): D summed in tiles of width ``bd``, for
  an fp32 corpus or an int8 one with power-of-two row scales, where it
  equals its plain version ``ref.dtiled_topk_ref`` bit for bit.  The
  input picks its mainloop (:func:`dtiled_design`: fp32 on stage A's
  ring, int8 on the tensor cores or the CUDA cores) and the shapes its
  grid (:func:`plan_dtiled`), which splits the D tiles across blocks
  where the slices leave SMs idle.

``ops`` picks between each kernel and its plain version.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import build, ref

MAX_K = 1024   # largest list the kernel keeps per query
SMEM_MAX = 232448   # shared memory one block may use on an H100
_ROWS = 128    # slices are whole multiples of one warp's 128 rows
# csrc/knn_topk.cu: rows per score tile, ring row pitch (floats); and its
# (queries per block, ring stages) in order of preference.  Two stages: on
# the H100 a third displaced the L1 room that two chunks of a misaligned
# row share, and ran slower.
KNN_ROW_TILE, _KNN_PITCH = 256, 36
KNN_SHAPES = ((32, 2), (16, 2))
# the ring of csrc/knn_topk_dtiled.cu's fp32 design (stage A's mainloop)
_RING_STAGES = 2


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def knn_smem_bytes(bq: int, stages: int, k: int) -> int:
    """Dynamic shared memory of one ``csrc/knn_topk.cu`` block: a ring of
    ``stages`` chunks of (256 rows + ``bq`` queries) x 36 floats, the
    first of each two score tiles the lists take at once ([``bq``, 256]
    floats; the second and the merge's scratch lie on the ring), and the
    ``bq`` lists of ``k`` (value, row) entries.  The C entry refuses a
    launch whose bytes differ."""
    return (4 * stages * (KNN_ROW_TILE + bq) * _KNN_PITCH
            + 4 * bq * KNN_ROW_TILE + 8 * bq * k)


def ring_smem_bytes(bq: int, ls: int) -> int:
    """Dynamic shared memory of one block of ``csrc/knn_topk_dtiled.cu``'s
    fp32 design: stage A's 2-stage ring of (256 rows + ``bq`` queries) x
    36 floats (the score tile, |c|² and the merge's scratch lie on it),
    then ``bq`` lists of ``ls`` (value, row) entries: ``ls = k``, or 0 in
    a split's first pass, which keeps no lists.  The C entry sizes the
    block by the same formula; the plan reads this one to pick ``bq``."""
    return 4 * _RING_STAGES * (KNN_ROW_TILE + bq) * _KNN_PITCH + 8 * bq * ls


class KnnPlan(NamedTuple):
    """The grid of one :func:`launch` call: ``bq`` queries a block, a
    ring of ``stages`` chunks, the corpus cut into ``n_slices`` slices of
    ``rows`` rows; one block per (query tile, slice)."""
    bq: int
    stages: int
    rows: int
    n_slices: int


def plan_knn(n_queries: int, m: int, k: int, n_sms: int) -> KnnPlan:
    """Plan the stage-A grid from the shapes alone.

    32 queries a block where their lists of k entries fit a block's
    shared memory beside the 2-stage ring and a score tile (k <= 456),
    else 16; then slices of whole 128-row units, at most one block per
    SM (the lists and the ring fill most of its shared memory), so the
    grid runs in one wave.
    """
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} outside [1, {MAX_K}]")
    bq, stages = next(s for s in KNN_SHAPES
                      if knn_smem_bytes(*s, k) <= SMEM_MAX)
    rows, n_slices = _slices(-(-n_queries // bq), m, n_sms, _ROWS)
    return KnnPlan(bq, stages, rows, n_slices)


def _slices(q_tiles: int, m: int, n_sms: int, unit: int) -> Tuple[int, int]:
    """(rows per slice, slices): about ``n_sms // q_tiles`` slices, each
    a whole number of ``unit`` rows."""
    want = max(1, min(n_sms // q_tiles, -(-m // unit)))
    rows = -(-(-(-m // want)) // unit) * unit
    return rows, -(-m // rows)


# A D split keeps every D tile's partials in device memory, written once
# and read once: 4·n_tiles·(Q·M + M) bytes.  At this budget the round
# trip costs at most 2 x 64 MiB / 3.35 TB/s = 0.04 ms of HBM time, a
# small part of the work a split spreads over idle SMs (the million-item
# point needs 35 MB), and the scratch stays a small part of the card
# beside the corpus.  Larger grids fill the SMs without a split.
SPLIT_SCRATCH_BYTES = 64 << 20
# (queries per block, slice row unit, rows per score tile) of each design
_DESIGNS = {"cuda_cores": (16, 128, 512), "mma_s8": (32, 32, 256),
            "ring_f32": (32, _ROWS, KNN_ROW_TILE)}
_FIN_BQ, _FIN_ROWS = 16, 8      # the split's second pass


@dataclasses.dataclass(frozen=True)
class DtiledPlan:
    """The grid of one :func:`launch_dtiled` call.

    ``design`` is the mainloop (``"ring_f32"``: fp32 on stage A's
    ``cp.async`` ring and ``fmaf`` tile; ``"mma_s8"``: int8 tensor cores;
    ``"cuda_cores"``: int8 ``dp4a``), ``bq`` its queries per block;
    the corpus is cut into ``n_slices`` slices of ``rows`` rows and the
    ``n_tiles`` D tiles into ``n_splits`` contiguous ranges
    (:func:`split_ranges`), one block per (query tile, slice, range).
    With ``n_splits > 1`` a second pass of ``fin_slices`` slices of
    ``fin_rows`` rows (16 queries a block) sums the tiles and selects,
    and the partials take ``scratch_bytes`` of device memory.
    """
    design: str
    bq: int
    q_tiles: int
    rows: int
    n_slices: int
    n_tiles: int
    n_splits: int
    fin_rows: int
    fin_slices: int
    scratch_bytes: int

    @property
    def blocks(self) -> int:
        return self.q_tiles * self.n_slices * self.n_splits


def _split_bytes(n_tiles: int, q_n: int, m: int) -> int:
    return 4 * n_tiles * (q_n + 1) * m


def plan_dtiled(q_n: int, m: int, d: int, bd: int, k: int, n_sms: int,
                design: str) -> DtiledPlan:
    """Plan the D-tiled stage A grid from the shapes alone.

    The corpus is sliced as for stage A (about one block per SM).  Only
    when the (query tile, slice) blocks would leave SMs idle, and the
    split's partials fit :data:`SPLIT_SCRATCH_BYTES`, are the D tiles
    split: each block's rows then fit one score tile, and the splits
    fill the SMs (no more splits than D tiles).  ``"mma_s8"`` and
    ``"ring_f32"`` hold 16 queries a block, not 32, where the lists of k
    entries leave 32 queries no room.
    """
    bq, unit, row_tile = _DESIGNS[design]
    if design == "mma_s8" and _pow2_at_least(k) > 512:
        bq = 16                  # the per-query lists of n2 = 1024
    if design == "ring_f32" and ring_smem_bytes(bq, k) > SMEM_MAX:
        bq = 16                  # k > 584
    q_tiles = -(-q_n // bq)
    rows, n_slices = _slices(q_tiles, m, n_sms, unit)
    n_tiles = -(-d // bd)
    n_splits = 1
    if q_tiles * n_slices < n_sms and \
            _split_bytes(n_tiles, q_n, m) <= SPLIT_SCRATCH_BYTES:
        s = -(-m // row_tile)
        n_splits = max(1, min(n_tiles, n_sms // (q_tiles * s)))
        if n_splits > 1:
            rows, n_slices = _slices(q_tiles, m, q_tiles * s, unit)
    fin_rows, fin_slices, scratch = rows, n_slices, 0
    if n_splits > 1:
        fin_rows, fin_slices = _slices(-(-q_n // _FIN_BQ), m, n_sms,
                                       _FIN_ROWS)
        scratch = _split_bytes(n_tiles, q_n, m)
    return DtiledPlan(design, bq, q_tiles, rows, n_slices, n_tiles, n_splits,
                      fin_rows, fin_slices, scratch)


def dtiled_design(int8: bool, bd: int) -> str:
    """The mainloop the input alone picks: fp32 stage A's ring on the
    CUDA cores (parity: no TF32); int8 the tensor cores when every D tile
    starts 16-byte aligned (``bd % 16 == 0``), else the CUDA cores."""
    if not int8:
        return "ring_f32"
    return "mma_s8" if bd % 16 == 0 else "cuda_cores"


def plan_for(queries: torch.Tensor, corpus: torch.Tensor, k: int,
                bd: int = 512) -> DtiledPlan:
    """The plan :func:`launch_dtiled` takes for these CUDA inputs."""
    q_n, d = queries.shape
    bd = min(bd, d)
    return plan_dtiled(
        q_n, corpus.shape[0], d, bd, k,
        torch.cuda.get_device_properties(corpus.device).multi_processor_count,
        dtiled_design(corpus.dtype == torch.int8, bd))


def split_ranges(n_tiles: int, n_splits: int) -> list:
    """The D tiles [t0, t1) of each split, as the kernel cuts them."""
    return [(n_tiles * z // n_splits, n_tiles * (z + 1) // n_splits)
            for z in range(n_splits)]


# The JAX package's ``knn_topk.tiled_sqnorm`` counterpart: |q|² of the
# queries for sub_qnorm (the kernel sums |c|² itself, in the same tiles).
tiled_sqnorm = ref.tiled_sqnorm_ref


def _query_gids(query_gids: Optional[torch.Tensor], q_n: int,
                dev: torch.device) -> torch.Tensor:
    if query_gids is None:
        return torch.full((q_n,), -1, dtype=torch.int32, device=dev)
    gids = build.index_input(query_gids, "query_gids", dev, 1)
    if gids.shape[0] != q_n:
        raise ValueError("query_gids must have one entry per query")
    return gids


def _check_common(d: int, m: int, width: int, k: int, col_offset: int,
                  col_stride: int) -> None:
    if width != d:
        raise ValueError(f"queries width {d} != corpus width {width}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} outside [1, {MAX_K}]")
    if m and k > m:
        raise ValueError(f"k={k} > M={m}")
    if col_offset < 0 or col_stride < 1:
        raise ValueError("col_offset must be >= 0 and col_stride >= 1")


def launch(queries: torch.Tensor, corpus: torch.Tensor, k: int,
           metric: str = "euclidean",
           query_gids: Optional[torch.Tensor] = None,
           col_offset: int = 0, col_stride: int = 1,
           sub_qnorm: bool = False
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage A: each query's top-k corpus rows, (f32[Q, k], i32[Q, k]).

    ``queries`` f32[Q, D] × ``corpus`` f32[M, D].  The column whose
    global id ``row·col_stride + col_offset`` equals ``query_gids[q]``
    scores −inf (self-exclusion).  ``sub_qnorm`` subtracts |q|² from the
    euclidean scores (the full −|q−c|² of the per-shard candidates).
    Requires ``1 <= k <= min(M, 1024)``.  Launches the CUDA kernels;
    raises on input they do not take (CPU tensors among them).
    """
    build.cuda_input(corpus, "corpus", (torch.float32,), ndim=2)
    dev = corpus.device
    build.cuda_input(queries, "queries", (torch.float32,), dev, 2)
    q_n, d = queries.shape
    m = corpus.shape[0]
    if metric not in ("euclidean", "dot"):
        raise ValueError(f"the kernel scores euclidean or dot, not {metric}")
    _check_common(d, m, corpus.shape[1], k, col_offset, col_stride)
    if m == 0:
        raise ValueError("the corpus has no rows")
    gids = _query_gids(query_gids, q_n, dev)
    out_v = torch.empty((q_n, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((q_n, k), dtype=torch.int32, device=dev)
    if q_n == 0:
        return out_v, out_i
    euclid = metric == "euclidean"
    qn = ref.corpus_sqnorm(queries) if euclid and sub_qnorm else None
    plan = plan_knn(
        q_n, m, k,
        torch.cuda.get_device_properties(dev).multi_processor_count)
    part_v = torch.empty((q_n, plan.n_slices, k), dtype=torch.float32,
                         device=dev)
    part_i = torch.empty((q_n, plan.n_slices, k), dtype=torch.int32,
                         device=dev)
    build.check(build.library().knn_topk_launch(
        queries.data_ptr(), corpus.data_ptr(),
        None if qn is None else qn.data_ptr(), gids.data_ptr(), q_n, m, d,
        k, int(euclid), col_offset, col_stride, plan.bq, plan.stages,
        knn_smem_bytes(plan.bq, plan.stages, k), plan.rows, plan.n_slices,
        part_v.data_ptr(), part_i.data_ptr(), out_v.data_ptr(),
        out_i.data_ptr(), build.stream_of(corpus)),
        "knn_topk")
    build.count_launch("knn_topk")
    return out_v, out_i


def launch_dtiled(queries: torch.Tensor, corpus: torch.Tensor, k: int,
                  bd: int = 512,
                  query_gids: Optional[torch.Tensor] = None,
                  col_offset: int = 0, col_stride: int = 1,
                  sub_qnorm: bool = False,
                  q_scale: Optional[torch.Tensor] = None,
                  c_scale: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """D-tiled stage A: each query's top-k rows, (f32[Q, k], i32[Q, k]).

    The q·c contraction is summed per D tile of width ``bd`` and across
    tiles in tile order.  ``queries`` [Q, D] × ``corpus`` [M, D], both
    f32 or both int8; int8 takes the power-of-two row scales ``q_scale``
    f32[Q] and ``c_scale`` f32[M] (``optim.compression
    .quantize_int8_rows``) and ``bd <= 1024`` (a tile's int32 partial
    then converts to f32 exactly).
    Self-exclusion, ``col_offset``/``col_stride`` and ``sub_qnorm`` as
    :func:`launch` (euclidean only).  Requires ``1 <= k <= min(M,
    1024)``; an empty corpus gives −inf scores.  Launches the CUDA
    kernels on the plan :func:`plan_for` gives; raises on input they
    do not take (CPU tensors among them).
    """
    quantized = corpus.dtype == torch.int8
    if quantized and (q_scale is None or c_scale is None):
        raise ValueError("int8 corpus requires q_scale and c_scale")
    if quantized and bd > 1024:
        raise ValueError(f"bd={bd} > 1024 breaks the exact f32 convert of "
                         "an int8 tile's partial")
    if bd < 1:
        raise ValueError(f"bd={bd} < 1")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} outside [1, {MAX_K}]")
    build.cuda_input(corpus, "corpus", (torch.float32, torch.int8), ndim=2,
                     pitched=True)
    dev = corpus.device
    build.cuda_input(queries, "queries", (corpus.dtype,), dev, 2,
                     pitched=True)
    q_n, d = queries.shape
    m = corpus.shape[0]
    _check_common(d, m, corpus.shape[1], k, col_offset, col_stride)
    gids = _query_gids(query_gids, q_n, dev)
    if q_n == 0 or m == 0:
        return (torch.full((q_n, k), float("-inf"), dtype=torch.float32,
                           device=dev),
                torch.zeros((q_n, k), dtype=torch.int32, device=dev))
    out_v = torch.empty((q_n, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((q_n, k), dtype=torch.int32, device=dev)
    scales = (None, None)
    if quantized:
        scales = (build.cuda_input(q_scale, "q_scale", (torch.float32,),
                                   dev, 1),
                  build.cuda_input(c_scale, "c_scale", (torch.float32,),
                                   dev, 1))
        if scales[0].shape[0] != q_n or scales[1].shape[0] != m:
            raise ValueError("q_scale / c_scale need one entry per row")
    bd = min(bd, d)
    qn = tiled_sqnorm(queries, bd) if sub_qnorm else None
    plan = plan_for(queries, corpus, k, bd)
    # the tensor-core design copies 16-byte pieces of rows, so the rows
    # need a 16-byte pitch.  StateStore.quantized_corpus keeps one; any
    # other int8 corpus is padded into a copy (0.2 GB at I=11,997).  The
    # queries (Q rows) are copied to the corpus's pitch.
    vec = plan.design == "mma_s8"
    ld = corpus.stride(0) if m > 1 else d
    if vec and (ld % 16 or corpus.data_ptr() % 16):
        ld = d + (-d % 16)
        corpus = torch.nn.functional.pad(corpus, (0, ld - d))
    if queries.stride(0) != ld or (vec and queries.data_ptr() % 16):
        queries = torch.nn.functional.pad(queries, (0, ld - d))
    n2 = max(64, _pow2_at_least(k))
    split = [None, None]
    if plan.n_splits > 1:
        split = [torch.empty((plan.n_tiles, q_n, m), dtype=torch.float32,
                             device=dev),
                 torch.empty((plan.n_tiles, m), dtype=torch.float32,
                             device=dev)]
    lists = plan.fin_slices if plan.n_splits > 1 else plan.n_slices
    part_v = torch.empty((q_n, lists, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((q_n, lists, k), dtype=torch.int32, device=dev)
    ptr = [None if t is None else t.data_ptr() for t in (qn, *scales, *split)]
    build.check(build.library().knn_topk_dtiled_launch(
        queries.data_ptr(), corpus.data_ptr(), ptr[0], ptr[1], ptr[2],
        gids.data_ptr(), q_n, m, d, ld, k, n2, bd, int(quantized), int(vec),
        col_offset, col_stride, plan.bq, plan.rows, plan.n_slices,
        plan.n_splits, ptr[3], ptr[4], plan.fin_rows, plan.fin_slices,
        part_v.data_ptr(), part_i.data_ptr(), out_v.data_ptr(),
        out_i.data_ptr(), build.stream_of(corpus)), "knn_topk_dtiled")
    build.count_launch("knn_topk_dtiled_f32" if plan.design == "ring_f32"
                       else "knn_topk_dtiled")
    return out_v, out_i
