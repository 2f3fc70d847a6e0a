"""The port's cross-shard and fp32 D-tiled serving against the JAX package.

``UserShardSpec``, the fp32 row blend, ``fused_recommend(bd=)``, the
per-shard candidates and both sharded pipelines: the same numpy-seeded
inputs go through ``repro`` (JAX on the CPU, Pallas kernels in interpret
mode where a test calls them) and through the port's plain PyTorch
versions.  The sharded answers are also held against the port's own
single-corpus answers.  The CUDA kernels run only on the card, where
``chip_smoke.py`` holds them against these plain versions.

Tolerances:
  * shard spec and candidate merge — exact (integer maps, one order).
  * fp32 scores — ``rtol=1e-5, atol=1e-4`` (sums in another order);
    ids exact on integer-valued corpora (exact sums, true ties), where
    the sharded answers also equal the single-corpus ones exactly, as
    the JAX package pins them.
  * int8 — ids exact: the sharded int8 pipeline is bitwise the
    single-corpus one (row quantization is partition invariant).
  * fp32 ids on a normal corpus — ``knn.compare_recommendations``
    (exact where neighbour k/k+1 and item n/n+1 are separated by 1e-5
    relative, score-equivalent elsewhere; >= 90% exact).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import knn as jknn
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.serving_topn import blend_topn_rows as jblend_rows
from repro.optim.compression import quantize_int8_rows as jquant
from repro.parallel.sharding import UserShardSpec as JSpec
from repro_torch.core import knn
from repro_torch.kernels import ops, ref
from repro_torch.optim.compression import quantize_int8_rows
from repro_torch.parallel.sharding import UserShardSpec


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _int_corpus(rng, m, n_items):
    """Small integers with duplicate rows: exact fp32 sums, true ties."""
    c = rng.integers(0, 4, (m, n_items)).astype(np.float32)
    c[1::5] = c[0]
    return c


# ---------------------------------------------------------------------------
# UserShardSpec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_users,n_shards", [(1, 1), (23, 2), (23, 3),
                                              (23, 5), (13949, 2)])
def test_user_shard_spec_matches_jax(n_users, n_shards):
    spec, jspec = UserShardSpec(n_users, n_shards), JSpec(n_users, n_shards)
    users = np.arange(n_users)
    np.testing.assert_array_equal(spec.shard_of(users),
                                  jspec.shard_of(users))
    np.testing.assert_array_equal(spec.local_row(users),
                                  jspec.local_row(users))
    seen = []
    for s in range(n_shards):
        owned = spec.owned_users(s)
        np.testing.assert_array_equal(owned, jspec.owned_users(s))
        assert spec.shard_users(s) == jspec.shard_users(s) == len(owned)
        np.testing.assert_array_equal(
            spec.global_user(s, np.arange(len(owned))), owned)
        seen.extend(owned.tolist())
    assert sorted(seen) == users.tolist()


@pytest.mark.parametrize("bad", [(0, 1), (3, 0)])
def test_user_shard_spec_rejects_empty(bad):
    with pytest.raises(ValueError):
        UserShardSpec(*bad)
    with pytest.raises(ValueError):
        JSpec(*bad)


# ---------------------------------------------------------------------------
# the fp32 row blend and fused_recommend(bd=)
# ---------------------------------------------------------------------------

def test_blend_topn_rows_matches_jax(rng):
    c = _int_corpus(rng, 31, 43)
    uids = rng.choice(31, 5, replace=False)
    nbr = rng.integers(0, 31, size=(5, 4))
    got = ops.blend_topn_rows(_t(c[uids]), _t(c[nbr]), 0.6, 7)
    exp = jref.blend_topn_rows_ref(jnp.asarray(c[uids]), jnp.asarray(c[nbr]),
                                   0.6, 7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
    _, pallas = jblend_rows(jnp.asarray(c[uids]), jnp.asarray(c[nbr]),
                            alpha=0.6, topn=7, bq=2, bi=16, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))
    vals, _ = ref.blend_topn_rows_ref(_t(c[uids]), _t(c[nbr]), 0.6, 7)
    pred = 0.6 * c[uids] + 0.4 * c[nbr].mean(1)
    np.testing.assert_allclose(vals.numpy(), -np.sort(-pred, axis=1)[:, :7],
                               rtol=1e-6)


@pytest.mark.parametrize("bd", [8, 16, 37])
def test_fused_recommend_dtiled_matches_jax(rng, bd):
    c = _int_corpus(rng, 41, 37)
    uids = rng.choice(41, 9, replace=False).astype(np.int32)
    got = ops.fused_recommend(_t(c), _t(uids), k=7, alpha=0.7, topn=6,
                              bd=bd)
    exp = jops.fused_recommend(jnp.asarray(c), jnp.asarray(uids), k=7,
                               alpha=0.7, topn=6, bd=bd)
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
    with jops.default_impl("interpret"):
        pallas = jops.fused_recommend(jnp.asarray(c), jnp.asarray(uids), k=7,
                                      alpha=0.7, topn=6, bd=bd)
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))


def test_fused_recommend_dtiled_normal_corpus(rng):
    """On a normal corpus the D-tiled answer holds against JAX's by the
    exact-or-score-equivalent rule."""
    c = rng.normal(size=(120, 90)).astype(np.float32)
    uids = np.arange(0, 120, 2).astype(np.int32)
    got = ops.fused_recommend(_t(c), _t(uids), k=9, alpha=0.7, topn=5, bd=32)
    exp = jops.fused_recommend(jnp.asarray(c), jnp.asarray(uids), k=9,
                               alpha=0.7, topn=5, bd=32)
    res = knn.compare_recommendations(_t(c), uids, np.asarray(exp),
                                      got.numpy(), k=9, alpha=0.7)
    assert res["mismatch"] == 0 and res["exact"] >= 0.9 * len(uids), res


# ---------------------------------------------------------------------------
# per-shard candidates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [5, 30])
def test_shard_topk_matches_jax(rng, k):
    """k=30 > M_s: the owner shard's self slot (−inf) comes last."""
    c = _int_corpus(rng, 23, 19)
    gids = np.array([0, 4, 7, 12, 21], dtype=np.int32)
    q = c[gids]
    for shard in range(2):
        local = c[shard::2]
        tv, tg = ops.shard_topk(_t(q), _t(local), k, shard, 2,
                                query_gids=_t(gids))
        jv, jg = jops.shard_topk(jnp.asarray(q), jnp.asarray(local), k,
                                 shard, 2, query_gids=jnp.asarray(gids))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))


def test_shard_topk_normal_corpus_close(rng):
    c = rng.normal(size=(29, 31)).astype(np.float32)
    gids = np.array([1, 3, 8], dtype=np.int32)
    tv, tg = ops.shard_topk(_t(c[gids]), _t(c[1::3]), 6, 1, 3,
                            query_gids=_t(gids))
    jv, jg = jops.shard_topk(jnp.asarray(c[gids]), jnp.asarray(c[1::3]), 6,
                             1, 3, query_gids=jnp.asarray(gids))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))


def test_merge_candidates_is_lexsort(rng):
    """Two stable sorts (gid asc, then score desc) = np.lexsort((gids,
    -vals)), ties and −inf included."""
    vals = rng.integers(-3, 3, (6, 40)).astype(np.float32)
    vals[vals == -3] = -np.inf
    gids = np.stack([rng.permutation(40) for _ in range(6)])
    order = np.lexsort((gids, -vals), axis=-1)
    want = np.take_along_axis(gids, order, axis=1)[:, :11]
    got = knn._merge_candidates([_t(vals[:, :17]), _t(vals[:, 17:])],
                                [_t(gids[:, :17]), _t(gids[:, 17:])], 11)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# sharded serving (the cases of the JAX package's sharded-engine test)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", [2, 3, 5])
def test_sharded_recommend_matches_jax_and_single_corpus(rng, n_shards):
    m, n_items, k, topn = 23, 37, 7, 6
    c = _int_corpus(rng, m, n_items)
    users = rng.choice(m, size=9, replace=False)
    spec = UserShardSpec(m, n_shards)
    parts = [c[spec.owned_users(s)] for s in range(n_shards)]
    got = knn.sharded_recommend_for_users([_t(x) for x in parts], users,
                                          k=k, alpha=0.7, topn=topn,
                                          n_shards=n_shards)
    exp = jknn.sharded_recommend_for_users([jnp.asarray(x) for x in parts],
                                           users, k=k, alpha=0.7, topn=topn,
                                           n_shards=n_shards)
    single = knn.recommend_for_users(_t(c), _t(users.astype(np.int32)), k=k,
                                     alpha=0.7, topn=topn)
    assert got.dtype == torch.int32 and got.shape == (9, topn)
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
    np.testing.assert_array_equal(got.numpy(), single.numpy())


@pytest.mark.parametrize("n_shards", [2, 3, 5])
def test_sharded_recommend_normal_corpus(rng, n_shards):
    """On a normal corpus: against the JAX answer and the single-corpus
    port answer by the exact-or-score-equivalent rule."""
    m, n_items, k = 40, 33, 7
    c = rng.normal(size=(m, n_items)).astype(np.float32)
    users = rng.choice(m, size=20, replace=False)
    parts = [c[s::n_shards] for s in range(n_shards)]
    got = knn.sharded_recommend_for_users([_t(x) for x in parts], users,
                                          k=k, alpha=0.7, topn=5,
                                          n_shards=n_shards).numpy()
    exp = np.asarray(jknn.sharded_recommend_for_users(
        [jnp.asarray(x) for x in parts], users, k=k, alpha=0.7, topn=5,
        n_shards=n_shards))
    single = knn.recommend_for_users(_t(c), _t(users.astype(np.int32)), k=k,
                                     alpha=0.7, topn=5).numpy()
    for want in (exp, single):
        res = knn.compare_recommendations(_t(c), users, want, got, k=k,
                                          alpha=0.7)
        assert res["mismatch"] == 0 and res["exact"] >= 18, res


@pytest.mark.parametrize("n_shards", [2, 3, 5])
def test_sharded_recommend_quant_matches_jax_and_single_corpus(rng,
                                                               n_shards):
    m, n_items = 23, 37
    c = rng.normal(size=(m, n_items)).astype(np.float32)
    users = rng.choice(m, 9, replace=False)
    spec = UserShardSpec(m, n_shards)
    own = [spec.owned_users(s) for s in range(n_shards)]
    quant = [quantize_int8_rows(_t(c[o])) for o in own]
    jquant_c = [jquant(jnp.asarray(c[o])) for o in own]
    got = knn.sharded_recommend_for_users_quant(quant, users, k=7, alpha=0.7,
                                                topn=6, n_shards=n_shards,
                                                bd=8)
    cq, cs = quantize_int8_rows(_t(c))
    uid = users.astype(np.int32)
    single = knn.recommend_for_users_quant(cq, cs, _t(uid), k=7, alpha=0.7,
                                           topn=6, bd=8)
    # the JAX package pins its sharded int8 answer bitwise to its
    # single-corpus one; its CPU compiler (XLA, jax 0.9.0) rejects the
    # int8 dot of the 4-5-row shards of a 5-way split, so there the port
    # is held against the JAX single-corpus answer alone
    jq, js = jquant(jnp.asarray(c))
    exp = [jknn.recommend_for_users_quant(jq, js, jnp.asarray(uid), k=7,
                                          alpha=0.7, topn=6, bd=8)]
    if n_shards < 5:
        exp.append(jknn.sharded_recommend_for_users_quant(
            jquant_c, users, k=7, alpha=0.7, topn=6, n_shards=n_shards,
            bd=8))
    for want in exp:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), single.numpy())
    # partition invariance: each shard's rows quantize as in the whole
    for o, (sq, ss) in zip(own, quant):
        np.testing.assert_array_equal(sq.numpy(), cq[o].numpy())
        np.testing.assert_array_equal(ss.numpy(), cs[o].numpy())


def test_sharded_candidates_are_the_shard_topk(rng):
    """shard_topk_candidates is ops.shard_topk with the query gids."""
    c = rng.normal(size=(17, 11)).astype(np.float32)
    q, gids = _t(c[[2, 5]]), _t(np.array([2, 5], dtype=np.int32))
    a = knn.shard_topk_candidates(q, _t(c[1::2]), 4, 1, 2, query_ids=gids)
    b = ops.shard_topk(q, _t(c[1::2]), 4, 1, 2, query_gids=gids)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
