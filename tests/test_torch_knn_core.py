"""The port's plain kNN functions and ``ops.knn_topk`` against the JAX
package.

``repro_torch.core.knn``'s ``pairwise_scores``, ``nearest_neighbors``,
``predict``, ``streaming_topk``, ``chunked_neighbor_mean`` and
``recommend_topn`` are held against ``repro.core.knn`` on the same
numpy-seeded inputs; ``ops.knn_topk`` on CPU tensors (its plain
version) against the JAX ``ops.knn_topk`` with the Pallas kernel in
interpret mode.  The CUDA kernel runs only on the card
(``chip_smoke.py``).

Tolerance: small-integer corpora score exactly, so ids (ties to the
lowest row included) and values must be equal; on float corpora values
``rtol=1e-5, atol=1e-6`` and ids exact or score-equivalent (the
float64 scores of both lists agree rank by rank within ``rtol=1e-5``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import knn as jknn
from repro.kernels import ops as jops
from repro_torch.core import knn
from repro_torch.kernels import build, ops, ref

TOL = dict(rtol=1e-5, atol=1e-6)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def int_corpus(rng, m, d):
    """Values in {0, 1, 2} with duplicated rows: exact scores, true
    ties."""
    c = rng.integers(0, 3, (m, d)).astype(np.float32)
    c[1::5] = c[0]
    return c


def scores64(q, c, metric):
    q, c = q.astype(np.float64), c.astype(np.float64)
    if metric == "cosine":
        q = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
        c = c / np.maximum(np.linalg.norm(c, axis=-1, keepdims=True), 1e-12)
        return q @ c.T
    s = q @ c.T
    if metric == "euclidean":
        s = 2 * s - (q * q).sum(-1)[:, None] - (c * c).sum(-1)[None, :]
    return s


def assert_ids_equivalent(q, c, got, exp, metric):
    """Each row's ids equal, or their float64 scores equal rank by rank."""
    s = scores64(q, c, metric)
    for i, (g, e) in enumerate(zip(np.asarray(got), np.asarray(exp))):
        if not np.array_equal(g, e):
            np.testing.assert_allclose(s[i, g], s[i, e], rtol=1e-5,
                                       atol=1e-6, err_msg=f"row {i}")
            assert len(set(g.tolist())) == len(g)


@pytest.mark.parametrize("metric", ["euclidean", "dot", "cosine"])
def test_pairwise_scores_matches_jax(rng, metric):
    q = rng.normal(size=(6, 20)).astype(np.float32)
    c = rng.normal(size=(50, 20)).astype(np.float32)
    exp = np.asarray(jknn.pairwise_scores(jnp.asarray(q), jnp.asarray(c),
                                          metric))
    got = knn.pairwise_scores(_t(q), _t(c), metric)
    np.testing.assert_allclose(got.numpy(), exp, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m,chunk,k,exclude_self", [
    (1009, 100, 7, False),          # prime corpus: a masked tail block
    (1009, 100, 7, True),
    (101, 16, 40, True),            # k > chunk
    (5, 16, 8, False),              # k > M: −inf entries at row 0
    (64, 64, 10, True),             # one whole block
    (0, 16, 3, False),              # no rows at all
])
@pytest.mark.parametrize("metric", ["euclidean", "dot"])
def test_streaming_topk_matches_jax(rng, m, chunk, k, exclude_self, metric):
    c = int_corpus(rng, m, 13) if m else np.zeros((0, 13), np.float32)
    q_n = 6
    rows = rng.integers(0, max(m, 1), q_n)
    q = c[rows] if m else rng.integers(0, 3, (q_n, 13)).astype(np.float32)
    qids = rows.astype(np.int32)
    ev, ei = jknn.streaming_topk(jnp.asarray(q), jnp.asarray(c), k, metric,
                                 chunk=chunk, exclude_self=exclude_self,
                                 query_ids=jnp.asarray(qids))
    gv, gi = knn.streaming_topk(_t(q), _t(c), k, metric, chunk=chunk,
                                exclude_self=exclude_self,
                                query_ids=_t(qids))
    assert gi.dtype == torch.int32 and gv.dtype == torch.float32
    np.testing.assert_array_equal(gv.numpy(), np.asarray(ev))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ei))
    if exclude_self and m > k:
        assert not (gi.numpy() == qids[:, None]).any()


def test_streaming_topk_float_corpus_matches_full_scores(rng):
    """On float rows the chunked scan and the one-shot top-k agree to the
    exact-or-score-equivalent rule, and both agree with JAX."""
    c = rng.normal(size=(997, 24)).astype(np.float32)
    q = rng.normal(size=(9, 24)).astype(np.float32)
    for metric in ("euclidean", "dot", "cosine"):
        gv, gi = knn.streaming_topk(_t(q), _t(c), 50, metric, chunk=128)
        ev, ei = jknn.streaming_topk(jnp.asarray(q), jnp.asarray(c), 50,
                                     metric, chunk=128)
        fv, fi = knn.nearest_neighbors(_t(q), _t(c), 50, metric)
        np.testing.assert_allclose(gv.numpy(), np.asarray(ev), **TOL)
        np.testing.assert_allclose(gv.numpy(), fv.numpy(), **TOL)
        assert_ids_equivalent(q, c, gi, ei, metric)
        assert_ids_equivalent(q, c, gi, fi, metric)


@pytest.mark.parametrize("exclude_self,with_ids", [(False, False),
                                                   (True, False),
                                                   (True, True)])
def test_nearest_neighbors_and_predict_match_jax(rng, exclude_self,
                                                 with_ids):
    c = int_corpus(rng, 120, 17)
    rows = rng.choice(120, 8, replace=False)
    q = c[rows]
    qids = rows.astype(np.int32) if with_ids else None
    jq = None if qids is None else jnp.asarray(qids)
    tq = None if qids is None else _t(qids)
    ev, ei = jknn.nearest_neighbors(jnp.asarray(q), jnp.asarray(c), 9,
                                    exclude_self=exclude_self, query_ids=jq)
    gv, gi = knn.nearest_neighbors(_t(q), _t(c), 9,
                                   exclude_self=exclude_self, query_ids=tq)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(ev))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ei))
    exp = jknn.predict(jnp.asarray(q), jnp.asarray(c), 9, 0.7,
                       exclude_self=exclude_self, query_ids=jq)
    got = knn.predict(_t(q), _t(c), 9, 0.7, exclude_self=exclude_self,
                      query_ids=tq)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), **TOL)


@pytest.mark.parametrize("k,chunk_k", [(9, 8), (16, 8), (7, 3), (5, 64)])
def test_chunked_neighbor_mean_matches_jax(rng, k, chunk_k):
    """−1 entries add nothing; the sum is divided by k; a k no chunk
    divides is padded with −1, not cut into smaller chunks."""
    c = rng.normal(size=(40, 11)).astype(np.float32)
    idx = rng.integers(-1, 40, (6, k)).astype(np.int32)
    exp = np.asarray(jknn.chunked_neighbor_mean(jnp.asarray(c),
                                                jnp.asarray(idx), chunk_k))
    got = knn.chunked_neighbor_mean(_t(c), _t(idx), chunk_k)
    np.testing.assert_allclose(got.numpy(), exp, **TOL)
    full = np.clip(idx, 0, None)
    np.testing.assert_allclose(
        knn.chunked_neighbor_mean(_t(c), _t(full), chunk_k).numpy(),
        c[full].mean(axis=1), **TOL)


def test_recommend_topn_matches_jax(rng):
    pred = rng.integers(0, 4, (7, 30)).astype(np.float32)  # many ties
    exp = np.asarray(jknn.recommend_topn(jnp.asarray(pred), 10))
    got = knn.recommend_topn(_t(pred), 10)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), exp)


@pytest.mark.parametrize("metric", ["dot", "euclidean"])
@pytest.mark.parametrize("q_n,m,d,k", [(5, 300, 33, 10), (1, 257, 80, 100),
                                       (12, 64, 64, 63)])
def test_ops_knn_topk_plain_matches_jax_interpret(rng, metric, q_n, m, d, k):
    """The plain version (what ``ops.knn_topk`` runs on CPU tensors)
    against the JAX Pallas kernel in interpret mode, exactly on an
    integer corpus; with self-exclusion by ``query_gids`` too, up to
    k = M − 1 (past it the −inf slot's row is unspecified in both
    packages' contracts)."""
    c = int_corpus(rng, m, d)
    rows = rng.integers(0, m, q_n)
    q = c[rows]
    ev, ei = jops.knn_topk(jnp.asarray(q), jnp.asarray(c), k,
                           impl="interpret", metric=metric, bq=8, bm=64)
    gv, gi = ops.knn_topk(_t(q), _t(c), k, metric=metric)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(ev))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ei))
    assert torch.equal(gi, ops.knn_topk(_t(q), _t(c), k, impl="ref",
                                        metric=metric)[1])
    gids = rows.astype(np.int32)
    ev, ei = jops.knn_topk(jnp.asarray(q), jnp.asarray(c), k,
                           impl="interpret", metric=metric, bq=8, bm=64,
                           query_gids=jnp.asarray(gids))
    gv, gi = ops.knn_topk(_t(q), _t(c), k, metric=metric,
                          query_gids=_t(gids))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(ev))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ei))


def test_ops_knn_topk_float_matches_jax_interpret(rng):
    q = rng.normal(size=(7, 48)).astype(np.float32)
    c = rng.normal(size=(333, 48)).astype(np.float32)
    for metric in ("dot", "euclidean"):
        ev, ei = jops.knn_topk(jnp.asarray(q), jnp.asarray(c), 20,
                               impl="interpret", metric=metric, bq=8,
                               bm=128)
        gv, gi = ops.knn_topk(_t(q), _t(c), 20, metric=metric)
        np.testing.assert_allclose(gv.numpy(), np.asarray(ev), rtol=1e-5,
                                   atol=1e-5)
        assert_ids_equivalent(q, c, gi, ei, metric)


def test_ops_knn_topk_cuda_on_cpu_raises_and_cosine_raises(rng):
    """impl="cuda" launches B3 or raises: no fallback for CPU tensors.
    Cosine has no kernel and raises on every impl."""
    q = _t(rng.normal(size=(3, 16)).astype(np.float32))
    c = _t(rng.normal(size=(40, 16)).astype(np.float32))
    before = dict(build.launch_counts)
    for metric in ("dot", "euclidean"):
        with pytest.raises(ValueError, match="CUDA"):
            ops.knn_topk(q, c, 5, impl="cuda", metric=metric)
        with ops.default_impl("cuda"):
            with pytest.raises(ValueError, match="CUDA"):
                ops.knn_topk(q, c, 5, metric=metric)
    for impl in ("auto", "cuda", "ref"):
        with pytest.raises(ValueError, match="cosine"):
            ops.knn_topk(q, c, 5, impl=impl, metric="cosine")
    assert dict(build.launch_counts) == before


def test_merge_in_row_blocks_is_exact(rng, monkeypatch):
    """A running top-k merged in row blocks (bounding the sort's memory)
    is the one-block answer, ties included."""
    c = int_corpus(rng, 400, 9)
    q = c[rng.integers(0, 400, 37)]
    want = knn.streaming_topk(_t(q), _t(c), 12, "dot", chunk=64)
    monkeypatch.setattr(ref, "MERGE_CELLS", 200)
    got = knn.streaming_topk(_t(q), _t(c), 12, "dot", chunk=64)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
