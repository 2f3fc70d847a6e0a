"""Stage A's grid plan and its plain version against the JAX package.

``knn_topk.plan_knn`` decides from the shapes alone how the CUDA kernel
of ``knn_topk`` (``csrc/knn_topk.cu``) cuts the work: queries per block
(32 where their lists of k entries fit a block's shared memory beside
the ring and a score tile, else 16), ring stages, and corpus slices of
whole 128-row units at about one block per SM.  The kernel runs only on the card
(``chip_smoke.py`` holds it against the plain version, exactly, at
every plan); here the planner's contract is held on its own, and the
port's plain stage A -- ``ops.shard_topk`` and ``ops.fused_recommend``
with ``impl="ref"`` -- against the JAX package's at each k where the
plan changes and one either side, on small-integer corpora from a numpy
seed.  JAX runs its Pallas kernel in interpret mode where its grid
stays short, and its plain reference at the larger k.

Tolerances: exact.  Integer corpora make every fp32 score exact and
every tie a true tie, so values and ids (lowest index first) must
agree bit for bit; alpha = 1/2 keeps the stage-B blend exact too.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import knn_topk, ops

N_SMS = 132                      # an H100's SMs
TAFENG = (256, 13949)            # (Q, M) of a request
PLAN_EDGE = 456                  # largest k with 32 queries a block
KS = (1, PLAN_EDGE - 1, PLAN_EDGE, PLAN_EDGE + 1, knn_topk.MAX_K)
INTERPRET_K = PLAN_EDGE + 1      # the Pallas grid stays short up to here


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _int_corpus(rng, m, d):
    c = rng.integers(0, 3, (m, d)).astype(np.float32)
    c[1::4] = c[0]                                  # duplicate rows
    c[:, 1] = c[:, 0]                               # duplicate columns
    return c


@pytest.mark.parametrize("k", [1, 300, PLAN_EDGE - 1, PLAN_EDGE,
                               PLAN_EDGE + 1, 900, knn_topk.MAX_K])
def test_queries_per_block_against_k(k):
    plan = knn_topk.plan_knn(*TAFENG, k, N_SMS)
    assert (plan.bq, plan.stages) == ((32, 2) if k <= PLAN_EDGE
                                      else (16, 2))
    assert (plan.bq, plan.stages) in knn_topk.KNN_SHAPES


def test_shared_memory_fits_every_k():
    """The formula the C entry checks: every k in 1..1024 fits one block,
    32 queries stop exactly where their lists no longer fit, and the ring
    holds a fold's second [bq, 256] score tile, the tile's |c|^2 and the
    merge's scratch of 512 (value, row) pairs per warp; the fold's first
    tile has its own [bq, 256] floats."""
    for k in range(1, knn_topk.MAX_K + 1):
        plan = knn_topk.plan_knn(*TAFENG, k, N_SMS)
        assert knn_topk.knn_smem_bytes(plan.bq, plan.stages, k) \
            <= knn_topk.SMEM_MAX
        fits32 = knn_topk.knn_smem_bytes(32, 2, k) <= knn_topk.SMEM_MAX
        assert fits32 == (k <= PLAN_EDGE) == (plan.bq == 32)
    tile = knn_topk.KNN_ROW_TILE
    for bq, stages in knn_topk.KNN_SHAPES:
        ring = stages * (tile + bq) * 36 * 4
        assert ring >= (bq * tile + tile + 2 * 8 * 2 * tile) * 4
        assert knn_topk.knn_smem_bytes(bq, stages, 0) == ring + bq * tile * 4


@pytest.mark.parametrize("q_n,m", [TAFENG, (1, 1500), (31, 1500),
                                   (33, 25000), (4096, 13949), (1, 1),
                                   (300, 127), (256, 1 << 20)])
@pytest.mark.parametrize("k", [300, 1024])
def test_slices_cover_the_corpus_once(q_n, m, k):
    plan = knn_topk.plan_knn(q_n, m, k, N_SMS)
    q_tiles = -(-q_n // plan.bq)
    assert plan.rows % 128 == 0 and plan.n_slices >= 1
    # whole row units, every row in exactly one slice, none empty
    assert plan.rows * (plan.n_slices - 1) < m <= plan.rows * plan.n_slices
    assert q_tiles * plan.n_slices <= max(N_SMS, q_tiles)


def test_tafeng_plan_is_one_wave():
    plan = knn_topk.plan_knn(*TAFENG, 300, N_SMS)
    assert plan == knn_topk.KnnPlan(32, 2, 896, 16)
    assert 8 * plan.n_slices == 128 <= N_SMS


@pytest.mark.parametrize("k", [0, knn_topk.MAX_K + 1])
def test_plan_rejects_k_out_of_range(k):
    with pytest.raises(ValueError):
        knn_topk.plan_knn(*TAFENG, k, N_SMS)


def _jax_impl(k):
    return "interpret" if k <= INTERPRET_K else "ref"


@pytest.mark.parametrize("q_n", [1, 31, 33])
@pytest.mark.parametrize("k", KS)
def test_shard_topk_plain_matches_jax(q_n, k):
    """Shard 1 of 2 (sub_qnorm, the gid mapping): scores and global ids
    exact, k' = min(k, M_s)."""
    rng = np.random.default_rng(k * 100 + q_n)
    c = _int_corpus(rng, 2 * knn_topk.MAX_K + 6, 13)
    gids = rng.choice(c.shape[0], q_n, replace=False).astype(np.int32)
    local = c[1::2]
    tv, tg = ops.shard_topk(_t(c[gids]), _t(local), k, 1, 2,
                            query_gids=_t(gids), impl="ref")
    jv, jg = jops.shard_topk(jnp.asarray(c[gids]), jnp.asarray(local), k,
                             1, 2, query_gids=jnp.asarray(gids),
                             impl=_jax_impl(k))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))


@pytest.mark.parametrize("q_n", [1, 31, 33])
@pytest.mark.parametrize("k", KS)
def test_fused_recommend_plain_matches_jax(q_n, k):
    """The serving path (stage A with self-exclusion, then the blend and
    top-n): ids exact; k is clamped to M - 1 on both sides."""
    rng = np.random.default_rng(k * 100 + q_n + 7)
    c = _int_corpus(rng, knn_topk.MAX_K + 7, 17)
    uids = rng.choice(c.shape[0], q_n, replace=False).astype(np.int32)
    got = ops.fused_recommend(_t(c), _t(uids), k, alpha=0.5, topn=5,
                              impl="ref")
    exp = jops.fused_recommend(jnp.asarray(c), jnp.asarray(uids), k,
                               alpha=0.5, topn=5, impl=_jax_impl(k))
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
