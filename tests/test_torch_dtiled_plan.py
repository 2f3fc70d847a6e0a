"""The D-tiled stage A's grid plan and the arithmetic of its D split.

``knn_topk.plan_dtiled`` decides from the shapes alone how the CUDA
kernel of ``knn_topk_dtiled`` cuts the work: corpus slices, query tiles
and, when those leave SMs idle, ranges of D tiles spread over more
blocks, whose per-tile partials a second pass sums in tile order.  The
kernels run only on the card (``chip_smoke.py``); here the planner's
contract is held on its own, and the split's arithmetic is emulated in
numpy (exact int32 partials per D tile, written per split, then summed
in tile order with f32 adds) and held bitwise against both plain
versions: the port's ``ref.dtiled_topk_ref`` and the JAX package's
``repro.kernels.ref.dtiled_topk_ref``.

Tolerances: bitwise (values as bit patterns, ids exact).  int8 tile
partials are integers below 2^24, so their f32 converts are exact, and
the power-of-two scales make every scale product exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import knn_topk, ref

N_SMS = 132                              # an H100's SMs
TAFENG = (256, 13949, 11997, 512, 300)   # (Q, M, D, bd, k) of a request
MILLION = (32, 256, 1 << 20, 1024, 16)   # bench_serving's top point
DESIGNS = ("mma_s8", "cuda_cores", "ring_f32")


def _plan(shape, design, n_sms=N_SMS):
    q_n, m, d, bd, k = shape
    return knn_topk.plan_dtiled(q_n, m, d, bd, k, n_sms, design)


@pytest.mark.parametrize("n_tiles,n_splits", [
    (1024, 132), (1024, 66), (24, 1), (7, 7), (65, 64), (1000, 3), (5, 2)])
def test_split_ranges_cover_every_tile_once_in_order(n_tiles, n_splits):
    ranges = knn_topk.split_ranges(n_tiles, n_splits)
    assert len(ranges) == n_splits
    assert ranges[0][0] == 0 and ranges[-1][1] == n_tiles
    for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
        assert a0 < a1 == b0          # contiguous, non-empty, in order
    covered = [t for t0, t1 in ranges for t in range(t0, t1)]
    assert covered == list(range(n_tiles))


@pytest.mark.parametrize("design", DESIGNS)
def test_no_split_at_tafeng(design):
    plan = _plan(TAFENG, design)
    assert plan.n_splits == 1 and plan.scratch_bytes == 0
    assert plan.blocks <= N_SMS
    assert plan.rows * plan.n_slices >= TAFENG[1]


@pytest.mark.parametrize("design", DESIGNS)
def test_million_point_fills_the_sms(design):
    plan = _plan(MILLION, design)
    assert 100 <= plan.blocks <= N_SMS
    assert plan.n_splits > 1
    assert 0 < plan.scratch_bytes <= knn_topk.SPLIT_SCRATCH_BYTES
    q_n, m, d, bd, _ = MILLION
    assert plan.scratch_bytes == 4 * plan.n_tiles * (q_n + 1) * m
    assert plan.n_tiles == -(-d // bd)


@pytest.mark.parametrize("design", DESIGNS)
def test_scratch_over_the_budget_gets_no_split(design):
    # a small grid that a split would fill, at partials of
    # 4 * n_tiles * (Q + 1) * M bytes just over and just under the budget
    q_n, m, bd, k = 13, 1000, 16, 7
    per_tile = 4 * (q_n + 1) * m
    over = knn_topk.SPLIT_SCRATCH_BYTES // per_tile + 1
    assert over * per_tile > knn_topk.SPLIT_SCRATCH_BYTES
    assert _plan((q_n, m, over * bd, bd, k), design).n_splits == 1
    under = _plan((q_n, m, (over - 1) * bd, bd, k), design)
    assert under.n_splits > 1
    assert under.scratch_bytes <= knn_topk.SPLIT_SCRATCH_BYTES


@pytest.mark.parametrize("seed", range(6))
def test_plans_cover_the_corpus_and_stay_in_one_wave(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        q_n = int(rng.integers(1, 600))
        m = int(rng.integers(1, 40000))
        d = int(rng.integers(1, 1 << 21))
        bd = int(rng.integers(1, 1025))
        k = int(rng.integers(1, min(m, 1024) + 1))
        for design in DESIGNS:
            p = _plan((q_n, m, d, bd, k), design)
            assert p.design == design
            assert p.q_tiles == -(-q_n // p.bq)
            assert p.rows * p.n_slices >= m > p.rows * (p.n_slices - 1)
            assert p.fin_rows * p.fin_slices >= m
            assert 1 <= p.n_splits <= p.n_tiles == -(-d // bd)
            if p.n_splits > 1:
                # only grids that left SMs idle split, into one wave
                assert p.blocks <= N_SMS
                assert p.scratch_bytes <= knn_topk.SPLIT_SCRATCH_BYTES


def test_the_input_picks_the_design():
    assert knn_topk.dtiled_design(True, 512) == "mma_s8"
    assert knn_topk.dtiled_design(True, 48) == "mma_s8"
    assert knn_topk.dtiled_design(True, 67) == "cuda_cores"
    for bd in (16, 17, 48, 67, 512, 1000, 1024):
        assert knn_topk.dtiled_design(False, bd) == "ring_f32"
    # the tensor-core query tile is as large as the per-query lists allow
    assert _plan(TAFENG, "mma_s8").bq == 32
    q_n, m, d, bd, _ = TAFENG
    assert _plan((q_n, m, d, bd, 900), "mma_s8").bq == 16
    assert _plan(TAFENG, "cuda_cores").bq == 16


# ---------------------------------------------------------------------------
# the split's arithmetic against both plain versions
# ---------------------------------------------------------------------------

def _emulate_split(q8, c8, qs, cs, k, bd, n_splits, gids, col_offset,
                   col_stride, sub_qnorm):
    """The split kernels' arithmetic in numpy: each split writes the
    exact int32 partials of its D tiles (q·c per (tile, query, row), |c|²
    per (tile, row)) as f32; the second pass sums them over the tiles in
    order from 0.0 with f32 adds and scores as the kernels do."""
    q_n, d = q8.shape
    m = c8.shape[0]
    bd = min(bd, d)
    n_tiles = -(-d // bd)
    acc_p = np.full((n_tiles, q_n, m), np.nan, np.float32)
    cn_p = np.full((n_tiles, m), np.nan, np.float32)
    for t0, t1 in knn_topk.split_ranges(n_tiles, n_splits):
        for t in range(t0, t1):
            qt = q8[:, t * bd:(t + 1) * bd].astype(np.int64)
            ct = c8[:, t * bd:(t + 1) * bd].astype(np.int64)
            part = qt @ ct.T
            assert np.abs(part).max() < 1 << 24
            acc_p[t] = part.astype(np.float32)
            cn_p[t] = (ct * ct).sum(1).astype(np.float32)
    f32 = np.float32
    acc = np.zeros((q_n, m), f32)
    cn = np.zeros((m,), f32)
    for t in range(n_tiles):
        acc = acc + acc_p[t]
        cn = cn + cn_p[t]
    s = (f32(2.0) * (qs[:, None] * cs[None, :])) * acc \
        - (cs * cs)[None, :] * cn[None, :]
    if sub_qnorm:
        qn = np.zeros((q_n,), f32)
        for t in range(n_tiles):
            qt = q8[:, t * bd:(t + 1) * bd].astype(np.int64)
            qn = qn + (qt * qt).sum(1).astype(f32)
        s = s - (qs * qs * qn)[:, None]
    col = np.arange(m) * col_stride + col_offset
    s[gids[:, None] == col[None, :]] = -np.inf
    idx = np.stack([np.lexsort((np.arange(m), -row))[:k] for row in s])
    return np.take_along_axis(s, idx, 1).astype(f32), idx.astype(np.int32)


def _int8_rows(rng, n, d):
    """int8 rows in [-127, 127] and power-of-two row scales."""
    x = rng.integers(-127, 128, size=(n, d)).astype(np.int8)
    scale = np.exp2(-rng.integers(3, 9, size=n)).astype(np.float32)
    x[1::5], scale[1::5] = x[0], scale[0]          # true ties
    return x, scale


_SPLIT_CASES = [   # (Q, M, D, k, bd): ragged D, bd 16 / 48 / 67
    (7, 90, 131, 9, 16), (7, 90, 211, 90, 48), (5, 61, 131, 7, 67),
    (4, 40, 300, 13, 48),
]


@pytest.mark.parametrize("shard", [False, True], ids=["plain", "shard"])
@pytest.mark.parametrize("q_n,m,d,k,bd", _SPLIT_CASES)
def test_split_arithmetic_is_bitwise_both_plain_versions(q_n, m, d, k, bd,
                                                         shard):
    rng = np.random.default_rng(q_n * 1000 + d + bd)
    c8, cs = _int8_rows(rng, m, d)
    rows = rng.choice(m, q_n, replace=False)
    q8, qs = c8[rows], cs[rows]
    col_offset, col_stride = (2, 3) if shard else (0, 1)
    gids = (rows * col_stride + col_offset).astype(np.int32)
    kw = dict(col_offset=col_offset, col_stride=col_stride,
              sub_qnorm=shard)
    tv, ti = ref.dtiled_topk_ref(
        torch.from_numpy(q8), torch.from_numpy(c8), k, bd=bd,
        query_gids=torch.from_numpy(gids), q_scale=torch.from_numpy(qs),
        c_scale=torch.from_numpy(cs), **kw)
    jv, ji = jref.dtiled_topk_ref(
        jnp.asarray(q8), jnp.asarray(c8), k, bd=bd,
        query_gids=jnp.asarray(gids), q_scale=jnp.asarray(qs),
        c_scale=jnp.asarray(cs), **kw)
    np.testing.assert_array_equal(tv.numpy().view(np.int32),
                                  np.asarray(jv).view(np.int32))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    n_tiles = -(-d // min(bd, d))
    for n_splits in sorted({1, 2, 3, n_tiles}):
        ev, ei = _emulate_split(q8, c8, qs, cs, k, bd, n_splits, gids,
                                **kw)
        np.testing.assert_array_equal(ev.view(np.int32),
                                      tv.numpy().view(np.int32))
        np.testing.assert_array_equal(ei, ti.numpy())


# ---------------------------------------------------------------------------
# the fp32 design: stage A's ring with a fold at every D tile
# ---------------------------------------------------------------------------

def test_ring_smem_bytes_fit_a_block_at_the_planned_bq():
    q_n, m, d, bd, _ = TAFENG
    bqs = set()
    for k in range(1, knn_topk.MAX_K + 1):
        plan = _plan((q_n, m, d, bd, k), "ring_f32")
        bqs.add(plan.bq)
        assert knn_topk.ring_smem_bytes(plan.bq, k) <= knn_topk.SMEM_MAX, k
        # 32 queries wherever their lists fit, 16 only beyond
        assert plan.bq == (32 if knn_topk.ring_smem_bytes(32, k)
                           <= knn_topk.SMEM_MAX else 16), k
    assert bqs == {16, 32}


def test_ring_smem_bytes_are_the_ring_and_the_lists():
    # 2 stages of (256 rows + bq queries) x 36 floats, then bq lists of
    # ls (value, row) entries; a split's first pass keeps none
    assert knn_topk.ring_smem_bytes(32, 0) == 2 * 288 * 36 * 4 == 82944
    assert knn_topk.ring_smem_bytes(16, 0) == 2 * 272 * 36 * 4
    assert knn_topk.ring_smem_bytes(32, 300) == 82944 + 32 * 300 * 8
    # the score tile, |c|^2 and the merge's scratch lie on the ring
    for bq in (16, 32):
        assert 4 * (bq * 256 + 256 + 2 * 8 * 64) <= \
            knn_topk.ring_smem_bytes(bq, 0)


def test_ring_takes_32_queries_at_tafeng():
    plan = _plan(TAFENG, "ring_f32")
    assert plan.bq == 32 and plan.q_tiles == 8
    assert plan.n_splits == 1 and plan.rows % 128 == 0


def test_ring_reads_the_million_point_in_one_query_tile():
    plan = _plan(MILLION, "ring_f32")
    assert plan.bq == 32 and plan.q_tiles == 1
    assert 100 <= plan.blocks <= N_SMS and plan.n_splits > 1
