"""The port's int8 serving slice against the JAX package.

Row quantization, the D-tiled stage A, the int8 row blend, the int8
serving pipeline, the store's int8 cache and the engine's quantized
requests: the same numpy-seeded inputs go through ``repro`` (JAX on the
CPU, Pallas kernels in interpret mode where a test calls them) and
through the port's plain PyTorch versions (what ``ops`` runs on CPU
tensors).  The CUDA kernels run only on the card, where ``chip_smoke.py``
holds them against these plain versions.

Tolerances:
  * quantization, int8 stage A, int8 ``|x|²`` — bitwise (values as bit
    patterns, ids exact): power-of-two scales make every scale product
    exact and every int8 partial sum is an integer below 2^24.
  * fp32 D-tiled stage A — values ``rtol=1e-5, atol=1e-4`` (fp32 sums in
    another order), ids exact on integer-valued corpora (true ties).
  * int8 row blend and int8 serving — ids exact (the dequantized sums
    here are exact; the mean and blend round once, in the same order).
  * the engine on the mixed stream — its fp32 state matches the JAX
    engine to ``rtol=1e-4`` only, so an int8 row may sit one rounding
    step apart: ids by ``knn.compare_recommendations`` on the
    dequantized corpus (exact ids where neighbour k/k+1 and item n/n+1
    are separated by 1e-5 relative, score-equivalent elsewhere, >= 90%
    exact); within the port, bitwise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import knn as jknn
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.knn_topk import knn_topk_dtiled as jdtiled
from repro.kernels.knn_topk import tiled_sqnorm as jtiled_sqnorm
from repro.kernels.serving_topn import blend_topn_rows_quant as jblend_q
from repro.optim.compression import dequantize_int8_rows as jdequant
from repro.optim.compression import quantize_int8_rows as jquant
from repro_torch.core import knn
from repro_torch.kernels import knn_topk, ops, ref
from repro_torch.optim.compression import (dequantize_int8_rows,
                                           quantize_int8_rows,
                                           quantize_int8_rows_pitched)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _bits(x):
    return np.asarray(x).view(np.int32)


def _quant_both(x):
    """(port q, port scale), (jax q, jax scale) of the f32 rows ``x``."""
    tq, ts = quantize_int8_rows(_t(x))
    jq, js = jquant(jnp.asarray(x))
    return (tq, ts), (np.asarray(jq), np.asarray(js))


# ---------------------------------------------------------------------------
# quantize_int8_rows / dequantize_int8_rows
# ---------------------------------------------------------------------------

def _quant_cases(rng):
    exact_pow2 = rng.uniform(-1, 1, (3, 17)).astype(np.float32)
    exact_pow2[:, 5] = 127.0 * 2.0 ** np.array([-3, 0, 4])   # max/127 = 2^e
    return {
        "normal": rng.normal(size=(17, 23)),
        "zero_rows": np.zeros((3, 8)),
        "mixed_zero": np.concatenate([np.zeros((2, 9)),
                                      rng.normal(size=(2, 9))]),
        "max_is_pow2": exact_pow2,
        "near_1e-30": rng.normal(size=(4, 9)) * 1e-30,
        "tiny": rng.normal(size=(5, 301)) * 1e-6,
        "huge": rng.normal(size=(5, 301)) * 1e6,
        "mixed_magnitudes": rng.normal(size=(9, 31))
        * np.exp(rng.uniform(-20, 20, size=(9, 1))),
        "spikes": np.eye(7, 13) * 3.0,
        "halfway": np.array([[0.5, 1.5, 2.5, -0.5, 127.0, -3.5]]),
    }


@pytest.mark.parametrize("case", sorted(_quant_cases(
    np.random.default_rng(0))))
def test_quantize_int8_rows_bitwise_vs_jax(case):
    x = _quant_cases(np.random.default_rng(0))[case].astype(np.float32)
    (tq, ts), (jq, js) = _quant_both(x)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), jq)
    np.testing.assert_array_equal(_bits(ts.numpy()), _bits(js))
    # power-of-two scales: the mantissa bits are zero
    assert np.all(_bits(ts.numpy()) & 0x7FFFFF == 0)
    assert np.all(np.abs(tq.numpy().astype(np.int32)) <= 127)
    # the store's layout: the same values at a 16-byte row pitch
    pq, ps = quantize_int8_rows_pitched(_t(x))
    assert pq.stride(0) % 16 == 0 and pq.stride(0) - pq.shape[1] < 16
    np.testing.assert_array_equal(pq.numpy(), jq)
    np.testing.assert_array_equal(_bits(ps.numpy()), _bits(js))
    assert not _full_rows(pq)[:, pq.shape[1]:].any()


def _full_rows(q):
    """The whole buffer behind a row-pitched view, pad columns included."""
    return torch.as_strided(q, (q.shape[0], q.stride(0)), (q.stride(0), 1))


def test_dequantize_int8_rows_bitwise_vs_jax(rng):
    x = rng.normal(size=(11, 29)).astype(np.float32)
    (tq, ts), (jq, js) = _quant_both(x)
    got = dequantize_int8_rows(tq, ts)
    exp = np.asarray(jdequant(jnp.asarray(jq), jnp.asarray(js)))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(exp))
    # round-trip error <= scale / 2 per element
    assert np.all(np.abs(got.numpy() - x) <= ts.numpy()[:, None] / 2)


# ---------------------------------------------------------------------------
# tiled_sqnorm_ref and dtiled_topk_ref
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bd", [1, 7, 16, 67, 512])
def test_tiled_sqnorm_int8_bitwise_fp32_close(rng, bd):
    x = rng.normal(size=(13, 211)).astype(np.float32)
    (tq, _), (jq, _) = _quant_both(x)
    got = ref.tiled_sqnorm_ref(tq, bd).numpy()
    np.testing.assert_array_equal(
        _bits(got), _bits(jref.tiled_sqnorm_ref(jnp.asarray(jq), bd)))
    np.testing.assert_array_equal(
        _bits(got), _bits(jtiled_sqnorm(jnp.asarray(jq), bd)))
    np.testing.assert_allclose(
        ref.tiled_sqnorm_ref(_t(x), bd).numpy(),
        np.asarray(jref.tiled_sqnorm_ref(jnp.asarray(x), bd)), rtol=1e-6)
    assert knn_topk.tiled_sqnorm is ref.tiled_sqnorm_ref


def test_tiled_sqnorm_chunks_rows(rng, monkeypatch):
    """Rows are widened a chunk at a time; the chunking changes nothing."""
    x = rng.normal(size=(37, 53)).astype(np.float32)
    (tq, _), _ = _quant_both(x)
    whole = ref.tiled_sqnorm_ref(tq, 16)
    monkeypatch.setattr(ref, "_SQNORM_CHUNK", 64)     # one row at a time
    np.testing.assert_array_equal(ref.tiled_sqnorm_ref(tq, 16).numpy(),
                                  whole.numpy())


_DTILED_CASES = [   # (Q, M, D, k, bd)
    (13, 101, 67, 7, 16), (13, 101, 67, 7, 67), (5, 53, 211, 9, 32),
    (7, 97, 131, 96, 512), (3, 29, 41, 28, 8),
]


@pytest.mark.parametrize("q_n,m,d,k,bd", _DTILED_CASES)
def test_dtiled_int8_bitwise_vs_jax(rng, q_n, m, d, k, bd):
    x = rng.normal(size=(m, d)).astype(np.float32)
    (tq, ts), (jq, js) = _quant_both(x)
    uid = rng.choice(m, q_n, replace=False).astype(np.int32)
    kw_t = dict(query_gids=_t(uid), q_scale=ts[uid], c_scale=ts)
    kw_j = dict(query_gids=jnp.asarray(uid), q_scale=jnp.asarray(js[uid]),
                c_scale=jnp.asarray(js))
    tv, ti = ops.knn_topk_dtiled(tq[uid], tq, k, bd=bd, **kw_t)
    jv, ji = jref.dtiled_topk_ref(jnp.asarray(jq[uid]), jnp.asarray(jq), k,
                                  bd=bd, **kw_j)
    np.testing.assert_array_equal(_bits(tv.numpy()), _bits(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    pv, pi = jdtiled(jnp.asarray(jq[uid]), jnp.asarray(jq), k, bq=4, bm=16,
                     bd=bd, interpret=True, **kw_j)
    np.testing.assert_array_equal(_bits(tv.numpy()), _bits(pv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(pi))


@pytest.mark.parametrize("bd", [8, 16, 41])
def test_dtiled_int8_shard_mode_bitwise_vs_jax(rng, bd):
    """col_offset / col_stride self-exclusion and sub_qnorm: the scores
    the cross-shard merge consumes."""
    x = rng.normal(size=(53, 41)).astype(np.float32)
    (tq, ts), (jq, js) = _quant_both(x)
    rows = rng.choice(53, 6, replace=False)
    gids = (rows * 3 + 1).astype(np.int32)
    tv, ti = ref.dtiled_topk_ref(tq[rows], tq, 5, bd=bd, query_gids=_t(gids),
                                 col_offset=1, col_stride=3, sub_qnorm=True,
                                 q_scale=ts[rows], c_scale=ts)
    jv, ji = jref.dtiled_topk_ref(
        jnp.asarray(jq[rows]), jnp.asarray(jq), 5, bd=bd,
        query_gids=jnp.asarray(gids), col_offset=1, col_stride=3,
        sub_qnorm=True, q_scale=jnp.asarray(js[rows]),
        c_scale=jnp.asarray(js))
    np.testing.assert_array_equal(_bits(tv.numpy()), _bits(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_dtiled_int8_duplicate_rows_tie_break(rng):
    """Duplicate rows tie exactly; the lowest row wins, as lax.top_k."""
    x0 = rng.normal(size=(20, 24)).astype(np.float32)
    x = np.concatenate([x0, x0, x0])
    (tq, ts), (jq, js) = _quant_both(x)
    tv, ti = ref.dtiled_topk_ref(tq[:7], tq, 11, bd=8, q_scale=ts[:7],
                                 c_scale=ts)
    jv, ji = jref.dtiled_topk_ref(jnp.asarray(jq[:7]), jnp.asarray(jq), 11,
                                  bd=8, q_scale=jnp.asarray(js[:7]),
                                  c_scale=jnp.asarray(js))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(_bits(tv.numpy()), _bits(jv))


@pytest.mark.parametrize("bd", [8, 29, 64])
def test_dtiled_fp32_close_vs_jax(rng, bd):
    q = rng.normal(size=(13, 71)).astype(np.float32)
    c = rng.normal(size=(103, 71)).astype(np.float32)
    gids = np.arange(13, dtype=np.int32) * 7
    tv, ti = ref.dtiled_topk_ref(_t(q), _t(c), 9, bd=bd, query_gids=_t(gids))
    jv, ji = jref.dtiled_topk_ref(jnp.asarray(q), jnp.asarray(c), 9, bd=bd,
                                  query_gids=jnp.asarray(gids))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_dtiled_fp32_integer_corpus_ids_exact(rng):
    c0 = rng.integers(0, 3, (30, 37)).astype(np.float32)
    c = np.concatenate([c0, c0])
    q = c[::5]
    tv, ti = ref.dtiled_topk_ref(_t(q), _t(c), 17, bd=16)
    jv, ji = jref.dtiled_topk_ref(jnp.asarray(q), jnp.asarray(c), 17, bd=16)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# ---------------------------------------------------------------------------
# int8 row blend and the int8 serving pipeline
# ---------------------------------------------------------------------------

def test_blend_topn_rows_quant_matches_jax(rng):
    x = rng.normal(size=(31, 43)).astype(np.float32)
    (tq, ts), (jq, js) = _quant_both(x)
    uids = rng.choice(31, 5, replace=False)
    nbr = rng.integers(0, 31, size=(5, 4))
    got = ops.blend_topn_rows_quant(tq[uids], ts[uids], tq[nbr], ts[nbr],
                                    0.6, 7)
    exp = jref.blend_topn_rows_quant_ref(
        jnp.asarray(jq[uids]), jnp.asarray(js[uids]), jnp.asarray(jq[nbr]),
        jnp.asarray(js[nbr]), 0.6, 7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
    _, pallas = jblend_q(jnp.asarray(jq[uids]), jnp.asarray(js[uids]),
                         jnp.asarray(jq[nbr]), jnp.asarray(js[nbr]),
                         alpha=0.6, topn=7, bq=2, bi=16, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))


@pytest.mark.parametrize("m,d,k,bd", [(101, 67, 7, 16), (64, 150, 63, 64),
                                      (23, 37, 40, 8)])
def test_fused_recommend_quant_matches_jax(rng, m, d, k, bd):
    """k is clamped to M−1 (the last case asks for more)."""
    x = rng.normal(size=(m, d)).astype(np.float32)
    (tq, ts), (jq, js) = _quant_both(x)
    uids = rng.choice(m, 9, replace=False).astype(np.int32)
    got = knn.recommend_for_users_quant(tq, ts, _t(uids), k=k, alpha=0.7,
                                        topn=6, bd=bd)
    exp = jknn.recommend_for_users_quant(jnp.asarray(jq), jnp.asarray(js),
                                         jnp.asarray(uids), k=k, alpha=0.7,
                                         topn=6, bd=bd)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
    with jops.default_impl("interpret"):
        pallas = jops.fused_recommend_quant(jnp.asarray(jq), jnp.asarray(js),
                                            jnp.asarray(uids), k=k,
                                            alpha=0.7, topn=6, bd=bd)
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))


def test_fused_recommend_quant_empty():
    cq = torch.zeros((0, 8), dtype=torch.int8)
    out = ops.fused_recommend_quant(cq, torch.zeros(0), torch.zeros(
        3, dtype=torch.int32), k=2, alpha=0.7, topn=4)
    assert out.shape == (3, 4) and out.dtype == torch.int32
    with pytest.raises(ValueError, match="topn"):
        ops.fused_recommend_quant(torch.zeros((4, 3), dtype=torch.int8),
                                  torch.ones(4), torch.zeros(
                                      1, dtype=torch.int32), 2, 0.7, 5)


def test_shard_topk_quant_matches_jax(rng):
    x = rng.normal(size=(53, 29)).astype(np.float32)
    (tq, ts), (jq, js) = _quant_both(x)
    gids = (rng.choice(53, 6, replace=False) * 2).astype(np.int32)
    rows = gids // 2
    for k in (5, 60):                 # 60 > M_s: the self slot is pinned
        tv, tg = ops.shard_topk_quant(tq[rows], ts[rows], tq, ts, k,
                                      shard=0, n_shards=2,
                                      query_gids=_t(gids), bd=8)
        jv, jg = jops.shard_topk_quant(
            jnp.asarray(jq[rows]), jnp.asarray(js[rows]), jnp.asarray(jq),
            jnp.asarray(js), k, shard=0, n_shards=2,
            query_gids=jnp.asarray(gids), bd=8)
        np.testing.assert_array_equal(_bits(tv.numpy()), _bits(jv))
        np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))


# ---------------------------------------------------------------------------
# StateStore.quantized_corpus against the JAX store
# ---------------------------------------------------------------------------

def _stores(rng, n_users=16, n_items=41):
    from repro.core import TifuParams as JParams
    from repro.streaming import StateStore as JStore
    from repro.streaming import StoreConfig as JConfig
    from repro.streaming import StreamingEngine as JEngine
    from repro_torch.core.types import TifuParams
    from repro_torch.streaming.engine import StreamingEngine
    from repro_torch.streaming.state_store import StateStore, StoreConfig
    shape = dict(n_users=n_users, n_items=n_items, max_baskets=8,
                 max_basket_size=6)
    jp = JParams(n_items=n_items, group_size=3, k_neighbors=4, alpha=0.7)
    tp = TifuParams(n_items=n_items, group_size=3, k_neighbors=4, alpha=0.7)
    jeng = JEngine(JStore(JConfig(**shape)), jp, batch_size=16)
    teng = StreamingEngine(StateStore(StoreConfig(**shape), device="cpu"),
                           tp, batch_size=16)
    return jeng, teng


def _add(engines, users, rng, n_items=41):
    from repro.streaming import Event
    events = [Event(1, int(u), items=rng.choice(n_items, 3, replace=False))
              for u in users]
    for eng in engines:
        eng.submit(events)
        eng.run_until_drained()


COUNTERS = ("quant_full_builds", "quant_rows_refreshed",
            "quant_threshold_rebuilds", "corpus_full_builds",
            "corpus_rows_refreshed")


def _check_cache(jeng, teng):
    tq, ts = teng.store.quantized_corpus()
    jq, js = jeng.store.quantized_corpus()
    wq, ws = quantize_int8_rows(teng.store.corpus())
    # rows at a 16-byte pitch, pad columns zero, refreshed rows in place
    assert tq.stride(0) % 16 == 0 and tq.stride(1) == 1
    assert not _full_rows(tq)[:, tq.shape[1]:].any()
    np.testing.assert_array_equal(tq.numpy(), wq.numpy())
    np.testing.assert_array_equal(_bits(ts.numpy()), _bits(ws.numpy()))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(ts.numpy()), _bits(js))
    for name in COUNTERS:
        assert getattr(teng.store, name) == getattr(jeng.store, name), name


def test_quantized_corpus_row_invalidation_matches_jax(rng):
    engines = _stores(rng)
    _add(engines, range(16), rng)
    _check_cache(*engines)
    assert engines[1].store.quant_full_builds == 1
    _add(engines, [3, 7], rng)          # only these rows re-quantize
    _check_cache(*engines)
    assert engines[1].store.quant_full_builds == 1
    assert engines[1].store.quant_rows_refreshed == 2
    # the fp32 cache refreshed on its own schedule in between
    engines[1].store.corpus(), engines[0].store.corpus()
    _add(engines, [1], rng)
    for eng in engines:
        eng.store.corpus()              # fp32 refresh: int8 still dirty
    _check_cache(*engines)
    assert engines[1].store.quant_rows_refreshed == 3


def test_quantized_corpus_threshold_rebuild_matches_jax(rng):
    engines = _stores(rng)
    _add(engines, range(16), rng)
    _check_cache(*engines)
    _add(engines, range(8), rng)        # > corpus_rebuild_frac of rows
    _check_cache(*engines)
    assert engines[1].store.quant_threshold_rebuilds == 1
    assert engines[1].store.quant_rows_refreshed == 0


def test_quantized_corpus_invalidate_all_matches_jax(rng):
    engines = _stores(rng)
    _add(engines, range(16), rng)
    _check_cache(*engines)
    for eng in engines:
        eng.store.invalidate_all()
    _add(engines, [2], rng)
    _check_cache(*engines)
    assert engines[1].store.quant_full_builds == 2


def test_engine_recommend_quantized_matches_pipeline(rng):
    jeng, teng = _stores(rng)
    _add((jeng, teng), range(16), rng)
    users = rng.choice(16, size=5, replace=False)
    got = teng.recommend(users, topn=5, quantized=True)
    assert got.shape == (5, 5) and got.dtype == np.int32
    cq, cs = teng.store.quantized_corpus()
    want = knn.recommend_for_users_quant(cq, cs, _t(users), k=4, alpha=0.7,
                                         topn=5)
    np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_array_equal(got, jeng.recommend(users, topn=5,
                                                      quantized=True))


# ---------------------------------------------------------------------------
# recommend(quantized=True) on the mixed stream
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mixed():
    """The 520-event mixed stream of the JAX engine tests, served int8
    from both engines between chunks."""
    from repro.core import RefEngine
    from repro.core.types import TifuParams as JParams
    from repro.streaming import StateStore as JStore
    from repro.streaming import StoreConfig as JConfig
    from repro.streaming import StreamingEngine as JEngine
    from repro_torch.core.types import TifuParams
    from repro_torch.streaming.engine import StreamingEngine
    from repro_torch.streaming.state_store import StateStore, StoreConfig
    from tests.test_update_partition import (B, K, M, N, P,
                                             random_mixed_events)
    rng = np.random.default_rng(0)
    events = random_mixed_events(rng, RefEngine(P, dtype=np.float32), 520, M)
    shape = dict(n_users=M, n_items=P.n_items, max_baskets=N,
                 max_basket_size=B, max_groups=K)
    tp = TifuParams(**{f: getattr(P, f) for f in
                       ("n_items", "group_size", "r_b", "r_g",
                        "k_neighbors", "alpha")})
    assert isinstance(P, JParams)
    jeng = JEngine(JStore(JConfig(**shape)), P, batch_size=16)
    teng = StreamingEngine(StateStore(StoreConfig(**shape), device="cpu"),
                           tp, batch_size=16)
    served = []
    # a bulk chunk, then two-event trickles (row refreshes: at most 2 of
    # the 8 rows dirty), then larger chunks (threshold rebuilds)
    cuts = [0, 260] + list(range(262, 300, 2)) + [300, 410, 520]
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        for eng in (jeng, teng):
            eng.submit(events[lo:hi])
            eng.run_until_drained()
        users = np.arange(M)
        served.append((users, jeng.recommend(users, topn=5, quantized=True),
                       teng.recommend(users, topn=5, quantized=True),
                       tuple(t.clone() for t in
                             teng.store.quantized_corpus()),
                       teng.store.corpus().clone()))
    return dict(events=events, jeng=jeng, teng=teng, served=served, P=P)


def test_mixed_stream_int8_cache_is_fresh_quantization(mixed):
    assert len(mixed["events"]) == 520
    assert mixed["teng"].store.quant_rows_refreshed > 0
    assert mixed["teng"].store.quant_threshold_rebuilds > 0
    for _, _, _, (cq, cs), corpus in mixed["served"]:
        wq, ws = quantize_int8_rows(corpus)
        np.testing.assert_array_equal(cq.numpy(), wq.numpy())
        np.testing.assert_array_equal(_bits(cs.numpy()), _bits(ws.numpy()))
    for name in COUNTERS:
        assert getattr(mixed["teng"].store, name) == \
            getattr(mixed["jeng"].store, name), name


def test_mixed_stream_int8_answers_match_jax(mixed):
    p = mixed["P"]
    total = exact = 0
    for users, jids, tids, (cq, cs), _ in mixed["served"]:
        assert tids.shape == jids.shape == (len(users), 5)
        # within the port: the engine serves the pipeline bit for bit
        np.testing.assert_array_equal(tids, knn.recommend_for_users_quant(
            cq, cs, _t(users), k=p.k_neighbors, alpha=p.alpha,
            topn=5).numpy())
        res = knn.compare_recommendations(dequantize_int8_rows(cq, cs),
                                          users, jids, tids,
                                          k=p.k_neighbors, alpha=p.alpha,
                                          rtol=1e-5)
        assert res["mismatch"] == 0, res
        total += len(users)
        exact += res["exact"]
    assert exact >= 0.9 * total, (exact, total)
