"""Fused neighbour blend + top-n (serving stage B, CUDA kernels).

Two kernels blend a query's own row with the mean of its k neighbour
rows and keep the top-n items per query (ties to the lowest item id),
without writing the [Q, I] predictions to device memory:

* :func:`launch` replaces ``repro/kernels/serving_topn.py::
  blend_topn_onehot`` (``csrc/serving_topn.cu``)::

      pred[q, i] = α·C[uid_q, i] + ((1 − α)·Σ_j C[idx[q, j], i]) / k

  On Hopper the neighbour sum is gathered, not a one-hot matmul: a plan
  kernel lists each group of queries' distinct neighbour rows on the
  card, and the blend reads each of them once per 32-item tile into
  shared memory for all the group's queries.  Its grid and shared
  memory come from :func:`plan_blend`.  Plain versions:
  ``ref.blend_topn_ref``, and ``ref.blend_topn_ordered_ref`` in the
  kernel's order of additions.
* :func:`launch_rows` replaces ``::blend_topn_rows`` (f32) and
  ``::blend_topn_rows_quant`` (int8 rows with power-of-two row scales,
  dequantized on chip), ``csrc/serving_rows.cu``::

      pred[q, i] = α·x_q[i] + (1 − α)·mean_j(r_qj[i])

  over pre-fetched rows [Q, k, I]; :func:`launch_rows_indexed` reads
  the int8 neighbour rows straight from the corpus instead, and
  :func:`launch_rows_at` rows at any device addresses (the shard
  corpora of cross-shard serving).  Plain versions:
  ``ref.blend_topn_rows_ref`` / ``blend_topn_rows_quant_ref``.  Its grid
  and shared memory come from :func:`plan_rows`.

``ops`` picks between each kernel and its plain version.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import build

MAX_TOPN = 1024   # largest list the merge keeps per query
# csrc/serving_topn.cu: items per tile, blend threads, queries a warp
# sums at once (and items a lane), the most queries a group holds, the
# largest n kept in registers (a list in shared memory above it), the
# plan's bitmap words (a plan round covers 32 row ids a word), the slot
# that marks no row (so G·k stays below it)
BLEND_TILE = 32
BLEND_THREADS = 256
BLEND_QUADS = 4
BLEND_GROUP = BLEND_THREADS // 32 * BLEND_QUADS
BLEND_MAX_SELECT = 32
PLAN_BITMAP_WORDS = 8192
NO_SLOT = 0xFFFF
# blend blocks an SM holds (the staging area is what is left of their
# share of the SM's 228 KB, less 1 KB each that the card reserves), and
# the fewest rows a staging pass takes
BLEND_BLOCKS_PER_SM = 2
SM_SHARED_BYTES = 233_472
BLOCK_RESERVED_BYTES = 1024
MIN_STAGE_ROWS = 64
# csrc/serving_rows.cu: items per block and ring depth by element size
# (4 KB of each row a block), threads (8 consumer warps and a producer
# warp), the largest n taken by selection (a bitonic sort of the tile
# above it), and how many tensors whose end is not 16-byte aligned one
# launch takes
ROWS_TILE = {4: 1024, 1: 4096}
ROWS_STAGES = 8
ROWS_THREADS = 288
ROWS_MAX_SELECT = 32
ROWS_MAX_ENDS = 16


class RowsPlan(NamedTuple):
    """How ``csrc/serving_rows.cu`` cuts one launch."""

    select: bool      # the tile's top n by selection (else bitonic sort)
    tile: int         # items per block
    stages: int       # rows in flight per block (ring slots)
    n_tiles: int      # tiles per query
    list_len: int     # entries each tile keeps (L)
    n2: int           # the merge's power-of-two list
    smem_bytes: int   # the tile kernel's dynamic shared memory
    grid: Tuple[int, int]   # (n_tiles, Q) blocks of ROWS_THREADS


def plan_rows(q_n: int, n_items: int, topn: int, elem_size: int
              ) -> RowsPlan:
    """The row blend's plan for Q queries over rows of ``n_items``
    elements of ``elem_size`` bytes (4: f32, 1: int8).

    A ring slot holds a tile's 16-byte-aligned superset (the tile's 4 KB
    + 16 bytes); the tile's lists reuse the ring once its rows are
    summed; each slot adds a header and two mbarriers (24 bytes).  The C
    entry refuses a launch whose bytes differ.
    """
    if not 1 <= topn <= min(n_items, MAX_TOPN):
        raise ValueError(f"topn={topn} outside [1, min(I={n_items}, "
                         f"{MAX_TOPN})]")
    select = topn <= ROWS_MAX_SELECT
    tile, stages = ROWS_TILE[elem_size], ROWS_STAGES
    ring = stages * (tile * elem_size + 16)
    lists = (ROWS_THREADS // 32 - 1) * ROWS_MAX_SELECT * 8 if select \
        else tile * 8
    n_tiles = -(-n_items // tile)
    return RowsPlan(select, tile, stages, n_tiles, min(topn, tile),
                    1 << max(0, (topn - 1).bit_length()),
                    max(ring, lists) + stages * 24, (n_tiles, q_n))


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def _pitch(k: int) -> int:
    """The plan's entries a query: k rounded up to 8 (16-byte rows)."""
    return -(-k // 8) * 8


def blend_smem_bytes(group: int, k: int, n2: int, select: bool,
                     stage_rows: int) -> int:
    """The blend kernel's shared memory: the group's entries (u16, rows
    of k rounded up to 8), each warp's candidates of a tile, a row of
    zeros, for n > 32 the lists, the staging area."""
    candidates = BLEND_THREADS // 32 * BLEND_QUADS * BLEND_TILE * 8
    lists = 0 if select else group * n2 * 8
    return (_align16(group * _pitch(k) * 2) + candidates + BLEND_TILE * 4
            + lists + stage_rows * BLEND_TILE * 4)


def plan_smem_bytes(group: int, k: int) -> int:
    """The plan kernel's: the bitmap, its words' prefix, scan scratch
    and the group's entries' slots (u16)."""
    return PLAN_BITMAP_WORDS * 8 + 256 + _align16(group * k * 2)


class BlendPlan(NamedTuple):
    """How ``csrc/serving_topn.cu`` cuts one launch."""

    group: int             # queries a group (G)
    groups: int
    select: bool           # top n in registers (n <= 32), else lists
    stage_rows: int        # rows a staging pass holds (S)
    strips: int            # strips of tiles a group
    tiles_per_strip: int   # 32-item tiles a strip
    list_len: int          # entries each strip keeps per query (L)
    n2: int                # the merge's power-of-two list
    smem_bytes: int        # the blend kernel's dynamic shared memory
    plan_smem_bytes: int   # the plan kernel's
    grid: Tuple[int, int]  # (groups, strips) blocks of BLEND_THREADS


@functools.lru_cache(maxsize=256)
def plan_blend(q_n: int, m: int, n_items: int, k: int, topn: int,
               n_sms: int) -> BlendPlan:
    """The neighbour blend's plan for Q queries of k neighbours over an
    [M, I] corpus, from shapes alone.

    Groups of up to 32 queries (fewer where k or the lists of n > 32
    leave no staging area of ``MIN_STAGE_ROWS`` rows, or G·k would reach
    ``NO_SLOT``); the staging area takes the rest of a block's share of
    the SM (``BLEND_BLOCKS_PER_SM``), at most G·k rows; the item tiles
    are cut into strips so that groups × strips fills that many blocks
    an SM.  The C entry refuses a launch whose shared-memory bytes
    differ.  ``m`` does not change the plan (the plan kernel walks the
    row ids in rounds).
    """
    if not 1 <= topn <= min(n_items, MAX_TOPN):
        raise ValueError(f"topn={topn} outside [1, min(I={n_items}, "
                         f"{MAX_TOPN})]")
    if k < 1 or q_n < 1:
        raise ValueError("plan_blend needs a query and a neighbour")
    select = topn <= BLEND_MAX_SELECT
    n2 = 1 << max(0, (topn - 1).bit_length())
    budget = SM_SHARED_BYTES // BLEND_BLOCKS_PER_SM - BLOCK_RESERVED_BYTES
    group = min(BLEND_GROUP, q_n)
    while group > 0 and (
            group * k >= NO_SLOT
            or blend_smem_bytes(group, k, n2, select, MIN_STAGE_ROWS)
            > budget):
        group -= 1
    if group == 0:
        raise ValueError(f"k={k} leaves no staging area (n={topn})")
    fixed = blend_smem_bytes(group, k, n2, select, 0)
    stage_rows = min((budget - fixed) // (BLEND_TILE * 4), group * k)
    groups = -(-q_n // group)
    n_tiles = -(-n_items // BLEND_TILE)
    strips = max(1, min(n_tiles, n_sms * BLEND_BLOCKS_PER_SM // groups))
    per_strip = -(-n_tiles // strips)
    strips = -(-n_tiles // per_strip)
    return BlendPlan(group, groups, select, stage_rows, strips, per_strip,
                     min(topn, per_strip * BLEND_TILE), n2,
                     fixed + stage_rows * BLEND_TILE * 4,
                     plan_smem_bytes(group, k), (groups, strips))


def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def launch(corpus: torch.Tensor, user_ids: torch.Tensor,
           nbr_idx: torch.Tensor, alpha: float,
           topn: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage B: blend and top-n items per query, (f32[Q, n], i32[Q, n]).

    ``corpus`` f32[M, I] × ``user_ids`` int[Q] × ``nbr_idx`` int[Q, k]
    (int32 or int64, read as given).  Neighbour entries outside [0, M)
    (e.g. −1) add 0 but still count in k; a user id outside [0, M) adds
    0.  Requires ``1 <= topn <= min(I, 1024)``.  Checks, one allocation
    of scratch and three launches (plan, blend, merge); nothing waits on
    the card.  Raises on input the kernels do not take (CPU tensors
    among them).
    """
    build.cuda_input(corpus, "corpus", (torch.float32,), ndim=2)
    dev = corpus.device
    uid = build.index_as_given(user_ids, "user_ids", dev, 1)
    nbr = build.index_as_given(nbr_idx, "nbr_idx", dev, 2)
    m, n_items = corpus.shape
    q_n, k = nbr.shape
    if uid.shape[0] != q_n:
        raise ValueError("user_ids and nbr_idx disagree on Q")
    if not 1 <= topn <= min(n_items, MAX_TOPN):
        raise ValueError(f"topn={topn} outside [1, min(I={n_items}, "
                         f"{MAX_TOPN})]")
    if k < 1:
        raise ValueError("nbr_idx needs at least one neighbour column")
    out_v = torch.empty((q_n, topn), dtype=torch.float32, device=dev)
    out_i = torch.empty((q_n, topn), dtype=torch.int32, device=dev)
    if q_n == 0:
        return out_v, out_i
    plan = plan_blend(q_n, m, n_items, k, topn, _sm_count(dev))
    g_q = plan.groups * plan.group
    part = q_n * plan.strips * plan.list_len * 4
    sizes = (g_q * k * 4, plan.groups * (plan.group + 1) * 4,
             g_q * _pitch(k) * 2, part, part)
    offsets = [0]
    for size in sizes:
        offsets.append(offsets[-1] + _align16(size))
    scratch = torch.empty(offsets[-1], dtype=torch.uint8, device=dev)
    base = scratch.data_ptr()
    prow, pcnt, pent, part_v, part_i = (base + o for o in offsets[:-1])
    build.check(build.library().blend_topn_launch(
        corpus.data_ptr(), uid.data_ptr(), nbr.data_ptr(),
        build.index_bits(uid, nbr), q_n, m, n_items, k, float(alpha),
        float(1.0 - alpha), topn, plan.group, plan.stage_rows, plan.strips,
        plan.tiles_per_strip, plan.list_len, plan.n2, plan.smem_bytes,
        plan.plan_smem_bytes, prow, pcnt, pent, part_v, part_i,
        out_v.data_ptr(), out_i.data_ptr(), build.stream_of(corpus)),
        "blend_topn_onehot")
    build.count_launch("blend_topn_onehot")
    return out_v, out_i


def _row_addresses(rows: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """Device addresses of rows ``index`` of ``rows``, int64.

    ``rows`` is 2-D with contiguous rows at its row pitch; the result
    has ``index``'s shape.
    """
    row_bytes = rows.stride(0) * rows.element_size()
    return index.to(torch.int64) * row_bytes + rows.data_ptr()


def _scale_input(t: Optional[torch.Tensor], what: str, dev: torch.device,
                 shape: Tuple[int, ...]) -> torch.Tensor:
    if t is None:
        raise ValueError(f"int8 rows require {what}")
    build.cuda_input(t, what, (torch.float32,), dev, len(shape))
    if tuple(t.shape) != shape:
        raise ValueError(f"{what}: shape {tuple(t.shape)}, expected {shape}")
    return t


def _row_ends(sources: Sequence[torch.Tensor]):
    """The ends of the storages holding neighbour rows that are not
    16-byte aligned, as the C entry takes them (a host array and its
    length): the kernel copies 16-byte-aligned pieces of rows and reads
    no row past such an end.  Raises where a storage does not start
    16-byte aligned (the head of a row's first piece would lie before
    it)."""
    ends = set()
    for t in sources:
        st = t.untyped_storage()
        if st.data_ptr() % 16:
            raise ValueError("rows must lie in a storage that starts "
                             "16-byte aligned")
        end = st.data_ptr() + st.nbytes()
        if end % 16:
            ends.add(end)
    if len(ends) > ROWS_MAX_ENDS:
        raise ValueError(f"rows in more than {ROWS_MAX_ENDS} tensors whose "
                         "end is not 16-byte aligned")
    return (ctypes.c_ulonglong * max(1, len(ends)))(*sorted(ends)), len(ends)


class _Neighbours(NamedTuple):
    """Where the neighbour rows lie: row j of query q at ``base + x ·
    pitch`` (bytes), x = ``idx[q, j]`` or, without ``idx``, q·k + j;
    the int8 scale ``scale[x]`` when ``scale_by_idx``, else ``scale[q,
    j]``.  ``sources``: the tensors that hold the rows."""

    base: int
    pitch: int
    idx: Optional[torch.Tensor]
    scale: Optional[torch.Tensor]
    scale_by_idx: bool
    sources: Sequence[torch.Tensor]


def _blend_rows(queries: torch.Tensor, q_scale: Optional[torch.Tensor],
                nbr: _Neighbours, k: int, alpha: float, topn: int,
                name: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/serving_rows.cu``: ``queries`` [Q, I] (rows at
    their pitch) and their neighbour rows, int8 when ``q_scale`` is
    given, else f32."""
    q_n, n_items = queries.shape
    dev = queries.device
    quantized = q_scale is not None
    plan = plan_rows(q_n, n_items, topn, 1 if quantized else 4)
    if k < 1:
        raise ValueError("need at least one neighbour row per query")
    out_v = torch.empty((q_n, topn), dtype=torch.float32, device=dev)
    out_i = torch.empty((q_n, topn), dtype=torch.int32, device=dev)
    if q_n == 0:
        return out_v, out_i
    ends, n_ends = _row_ends(nbr.sources)
    part_v = torch.empty((q_n, plan.n_tiles, plan.list_len),
                         dtype=torch.float32, device=dev)
    part_i = torch.empty((q_n, plan.n_tiles, plan.list_len),
                         dtype=torch.int32, device=dev)
    build.check(build.library().blend_rows_launch(
        queries.data_ptr(), queries.stride(0) * queries.element_size(),
        q_scale.data_ptr() if quantized else None, nbr.base, nbr.pitch,
        None if nbr.idx is None else nbr.idx.data_ptr(),
        int(nbr.idx is not None and nbr.idx.dtype == torch.int64),
        nbr.scale.data_ptr() if quantized else None, int(nbr.scale_by_idx),
        int(quantized), q_n, n_items, k, float(alpha), float(1.0 - alpha),
        topn, plan.list_len, plan.n2, ends, n_ends, plan.smem_bytes,
        part_v.data_ptr(), part_i.data_ptr(), out_v.data_ptr(),
        out_i.data_ptr(), build.stream_of(queries)), name)
    build.count_launch(name)
    return out_v, out_i


def launch_rows(queries: torch.Tensor, neighbor_rows: torch.Tensor,
                alpha: float, topn: int,
                q_scale: Optional[torch.Tensor] = None,
                n_scale: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage B over pre-fetched rows, (f32[Q, n], i32[Q, n]).

    ``queries`` [Q, I] × ``neighbor_rows`` [Q, k, I], both f32
    (``blend_topn_rows``) or both int8 with row scales ``q_scale``
    f32[Q] and ``n_scale`` f32[Q, k] (``blend_topn_rows_quant``).
    Requires ``1 <= topn <= min(I, 1024)``.  Launches the CUDA kernels;
    raises on input they do not take (CPU tensors among them).
    """
    build.cuda_input(neighbor_rows, "neighbor_rows",
                     (torch.float32, torch.int8), ndim=3)
    dev = neighbor_rows.device
    build.cuda_input(queries, "queries", (neighbor_rows.dtype,), dev, 2)
    q_n, k, n_items = neighbor_rows.shape
    if tuple(queries.shape) != (q_n, n_items):
        raise ValueError(f"queries {tuple(queries.shape)} do not match "
                         f"neighbor_rows {tuple(neighbor_rows.shape)}")
    quantized = neighbor_rows.dtype == torch.int8
    if quantized:
        q_scale = _scale_input(q_scale, "q_scale", dev, (q_n,))
        n_scale = _scale_input(n_scale, "n_scale", dev, (q_n, k))
    else:
        q_scale = n_scale = None
    return _blend_rows(queries, q_scale, _Neighbours(
        neighbor_rows.data_ptr(), n_items * neighbor_rows.element_size(),
        None, n_scale, False, (neighbor_rows,)), k, alpha, topn,
        "blend_topn_rows_quant" if quantized else "blend_topn_rows")


def launch_rows_indexed(queries_q: torch.Tensor, q_scale: torch.Tensor,
                        corpus_q: torch.Tensor, c_scale: torch.Tensor,
                        nbr_idx: torch.Tensor, alpha: float,
                        topn: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 stage B reading the neighbour rows straight from the corpus.

    Neighbour j of query q is row ``corpus_q[nbr_idx[q, j]]`` with scale
    ``c_scale[nbr_idx[q, j]]``.  The same kernel and count as
    :func:`launch_rows` on ``corpus_q[nbr_idx]``, without writing that
    [Q, k, I] gather; ``nbr_idx`` (int32 or int64) is read as given and
    must lie in [0, M) (checked: one host sync).
    """
    build.cuda_input(corpus_q, "corpus_q", (torch.int8,), ndim=2,
                     pitched=True)
    dev = corpus_q.device
    build.cuda_input(queries_q, "queries_q", (torch.int8,), dev, 2)
    nbr = build.index_as_given(nbr_idx, "nbr_idx", dev, 2)
    m, n_items = corpus_q.shape
    q_n, k = nbr.shape
    if tuple(queries_q.shape) != (q_n, n_items):
        raise ValueError("queries_q must be [Q, I] with Q = nbr_idx rows")
    q_scale = _scale_input(q_scale, "q_scale", dev, (q_n,))
    _scale_input(c_scale, "c_scale", dev, (m,))
    if nbr.numel():
        lo, hi = (int(v) for v in torch.aminmax(nbr))
        if lo < 0 or hi >= m:
            raise ValueError(f"nbr_idx outside [0, {m}): [{lo}, {hi}]")
    return _blend_rows(queries_q, q_scale, _Neighbours(
        corpus_q.data_ptr(), corpus_q.stride(0), nbr, c_scale, True,
        (corpus_q,)), k, alpha, topn, "blend_topn_rows_quant")


def launch_rows_at(queries: torch.Tensor, nbr_rows: torch.Tensor,
                   tables: Sequence[torch.Tensor], alpha: float, topn: int,
                   q_scale: Optional[torch.Tensor] = None,
                   n_scale: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage B over rows read where they lie, (f32[Q, n], i32[Q, n]).

    ``nbr_rows`` i64[Q, k] holds the device address of each neighbour
    row, a row of one of ``tables`` (2-D, f32 or int8 as ``queries``
    [Q, I], rows contiguous at their pitch; the addresses are not
    checked).  int8 takes ``q_scale`` f32[Q] and the rows' scales
    ``n_scale`` f32[Q, k].  The same kernel and count as
    :func:`launch_rows` on the gathered rows, without writing that
    [Q, k, I] gather.
    """
    build.cuda_input(queries, "queries", (torch.float32, torch.int8),
                     ndim=2)
    dev = queries.device
    build.cuda_input(nbr_rows, "nbr_rows", (torch.int64,), dev, 2)
    q_n, n_items = queries.shape
    k = nbr_rows.shape[1]
    if nbr_rows.shape[0] != q_n:
        raise ValueError("nbr_rows must be [Q, k] with Q = queries rows")
    for t in tables:
        build.cuda_input(t, "tables", (queries.dtype,), dev, 2,
                         pitched=True)
        if t.shape[1] != n_items:
            raise ValueError(f"a table of width {t.shape[1]}, queries "
                             f"{n_items}")
    quantized = queries.dtype == torch.int8
    if quantized:
        q_scale = _scale_input(q_scale, "q_scale", dev, (q_n,))
        n_scale = _scale_input(n_scale, "n_scale", dev, (q_n, k))
    else:
        q_scale = n_scale = None
    return _blend_rows(queries, q_scale, _Neighbours(
        0, 1, nbr_rows, n_scale, False, tables), k, alpha, topn,
        "blend_topn_rows_quant" if quantized else "blend_topn_rows")
