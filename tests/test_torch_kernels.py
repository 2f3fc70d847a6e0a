"""The port's four kernel modules against the JAX package.

For each kernel module, the port's plain PyTorch version (what
``ops`` runs on CPU tensors) is held against ``repro.kernels.ref`` and
against the JAX Pallas kernel in interpret mode, called as the JAX
package's own tests call it.  The CUDA kernels themselves run only on
the card (``chip_smoke.py`` holds them against these plain versions).

Tolerances:
  * gather — bitwise: it copies table cells.
  * scatter — bitwise on integer-valued tables and deltas (every fp32
    sum is exact); ``rtol=1e-6`` on normal floats (the Pallas kernel
    adds the deltas of one cell in another order), with ``atol=1e-6``
    for cells whose O(1) deltas cancel to near zero.
  * top-k / top-n — ids exact on integer-valued data, where fp32
    arithmetic is exact and ties are true ties, so the lowest-index
    tie-break is checked exactly; values ``rtol=1e-5`` (fp32 sums in
    another order), with ids then compared as sets.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.knn_topk import knn_topk as jknn_topk
from repro.kernels.serving_topn import blend_topn_onehot as jblend
from repro.kernels.sparse_row_gather import sparse_row_gather as jgather
from repro.kernels.sparse_row_scatter import sparse_row_scatter as jscatter
from repro_torch.kernels import ops, ref


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _sparse_inputs(rng, m, items, u, w, integer):
    if integer:
        table = rng.integers(-8, 9, (m, items)).astype(np.float32)
        vals = rng.integers(-8, 9, (u, w)).astype(np.float32)
    else:
        table = rng.normal(size=(m, items)).astype(np.float32)
        vals = rng.normal(size=(u, w)).astype(np.float32)
    rows = rng.integers(0, m, u).astype(np.int32)
    rows[: u // 2] = rows[0]                        # duplicate rows
    ids = rng.integers(-1, items, (u, w)).astype(np.int32)   # PAD = -1
    ids[0, :4] = 7                                  # repeated (row, id)
    ids[1, :3] = 7                                  # ... across rows too
    ids[-1, :] = -1                                 # an all-PAD row
    return table, rows, ids, vals


# ---------------------------------------------------------------------------
# sparse_row_gather
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,items,u,w", [(16, 256, 8, 24), (37, 384, 13, 40)])
def test_sparse_row_gather_matches_jax(rng, m, items, u, w):
    table, rows, ids, _ = _sparse_inputs(rng, m, items, u, w, False)
    got = ops.sparse_row_gather(_t(table), _t(rows), _t(ids))
    exp_ref = jref.sparse_row_gather_ref(jnp.asarray(table),
                                         jnp.asarray(rows), jnp.asarray(ids))
    exp_pallas = jgather(jnp.asarray(table), jnp.asarray(rows),
                         jnp.asarray(ids), bi=128, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp_ref))
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp_pallas))


def test_sparse_row_gather_any_width(rng):
    """The port takes any n_items (11,997 at TaFeng's published size is
    no multiple of 128); the JAX reference needs no tile either."""
    table, rows, ids, _ = _sparse_inputs(rng, 9, 211, 6, 17, False)
    got = ops.sparse_row_gather(_t(table), _t(rows), _t(ids))
    exp = jref.sparse_row_gather_ref(jnp.asarray(table), jnp.asarray(rows),
                                     jnp.asarray(ids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))


# ---------------------------------------------------------------------------
# sparse_row_scatter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("m,items,u,w", [(16, 256, 8, 24), (37, 384, 13, 40)])
def test_sparse_row_scatter_matches_jax(rng, m, items, u, w, integer):
    table, rows, ids, vals = _sparse_inputs(rng, m, items, u, w, integer)
    got = ops.sparse_row_scatter(_t(table), _t(rows), _t(ids), _t(vals))
    args = [jnp.asarray(a) for a in (table, rows, ids, vals)]
    exp_ref = np.asarray(jref.sparse_row_scatter_ref(*args))
    exp_pallas = np.asarray(jscatter(*args, bi=128, interpret=True))
    if integer:
        np.testing.assert_array_equal(got.numpy(), exp_ref)
        np.testing.assert_array_equal(got.numpy(), exp_pallas)
    else:
        # atol: a cell whose deltas cancel to near 0 keeps the absolute
        # error of its O(1) addends (a few ulp at 1.0), not a relative one
        np.testing.assert_allclose(got.numpy(), exp_ref, rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(got.numpy(), exp_pallas, rtol=1e-6,
                                   atol=1e-6)


def test_sparse_row_scatter_updates_in_place(rng):
    table, rows, ids, vals = _sparse_inputs(rng, 8, 130, 5, 9, True)
    t = _t(table)
    out = ops.sparse_row_scatter(t, _t(rows), _t(ids), _t(vals))
    assert out.data_ptr() == t.data_ptr()
    exp = jref.sparse_row_scatter_ref(*[jnp.asarray(a) for a in
                                        (table, rows, ids, vals)])
    np.testing.assert_array_equal(t.numpy(), np.asarray(exp))


# ---------------------------------------------------------------------------
# knn_topk (serving stage A)
# ---------------------------------------------------------------------------

def _int_corpus(rng, m, d):
    """Small-integer corpus with duplicate rows and duplicate columns:
    exact fp32 scores with true ties."""
    c = rng.integers(0, 3, (m, d)).astype(np.float32)
    c[1::4] = c[0]                                  # duplicate rows
    c[:, 1] = c[:, 0]                               # duplicate columns
    return c


@pytest.mark.parametrize("k_sel", ["1", "7", "M-1"])
@pytest.mark.parametrize("metric", ["euclidean", "dot"])
def test_knn_topk_integer_ties_exact(rng, k_sel, metric):
    """Prime Q and M, self-exclusion through query_gids: ids are exact
    against the Pallas kernel and the XLA oracle."""
    m, d, q_n = 53, 19, 13
    k = {"1": 1, "7": 7, "M-1": m - 1}[k_sel]
    c = _int_corpus(rng, m, d)
    qids = rng.choice(m, q_n, replace=False).astype(np.int32)
    qids[0] = 0                                     # a duplicated row
    q = c[qids]
    vals, idx = ref.knn_topk_ref(_t(q), _t(c), k, metric=metric,
                                 query_gids=_t(qids))
    pv, pi = jknn_topk(jnp.asarray(q), jnp.asarray(c), k=k, bq=8, bm=16,
                       metric=metric, interpret=True,
                       query_gids=jnp.asarray(qids))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(pi))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(pv))
    assert not np.any(idx.numpy() == qids[:, None])
    if metric == "euclidean":
        rv, ri = jref.dtiled_topk_ref(jnp.asarray(q), jnp.asarray(c), k,
                                      bd=d, query_gids=jnp.asarray(qids))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ri))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(rv))


@pytest.mark.parametrize("metric", ["euclidean", "dot"])
def test_knn_topk_float_matches_jax(rng, metric):
    m, d, q_n, k = 97, 24, 11, 7
    c = rng.normal(size=(m, d)).astype(np.float32)
    q = rng.normal(size=(q_n, d)).astype(np.float32)
    vals, idx = ref.knn_topk_ref(_t(q), _t(c), k, metric=metric)
    rv, ri = jref.knn_topk_ref(jnp.asarray(q), jnp.asarray(c), k, metric)
    pv, pi = jknn_topk(jnp.asarray(q), jnp.asarray(c), k=k, bq=8, bm=32,
                       metric=metric, interpret=True)
    for exp_v, exp_i in ((rv, ri), (pv, pi)):
        np.testing.assert_allclose(vals.numpy(), np.asarray(exp_v),
                                   rtol=1e-5, atol=1e-5)
        for a, b in zip(idx.numpy(), np.asarray(exp_i)):
            assert set(a.tolist()) == set(b.tolist())


def test_knn_topk_ties_go_to_lowest_index():
    """torch.topk promises no tie order; the plain version must give
    lax.top_k's (lowest index first)."""
    x = torch.tensor([[0.0, 3.0, 3.0, 1.0, 3.0]])
    _, idx = ref.topk_lowest_index(x, 3)
    assert idx.tolist() == [[1, 2, 4]]


# ---------------------------------------------------------------------------
# blend_topn_onehot (serving stage B)
# ---------------------------------------------------------------------------

def _nbr_idx(rng, q_n, m, k, qids):
    idx = np.stack([rng.choice(np.delete(np.arange(m), u), k, replace=False)
                    for u in qids]).astype(np.int32)
    idx[0, -2:] = -1                                # −1 adds 0, counts in k
    return idx


def test_blend_topn_integer_ties_exact(rng):
    """alpha = 1/2 and k = 8 keep every fp32 step exact on a
    small-integer corpus with duplicate rows and columns, so the
    lowest-item tie-break is checked exactly against the Pallas kernel
    and against the XLA gather-and-mean oracle."""
    m, items, q_n, k, n = 41, 67, 13, 8, 9
    c = _int_corpus(rng, m, items)
    qids = rng.choice(m, q_n, replace=False).astype(np.int32)
    nbr = _nbr_idx(rng, q_n, m, k, qids)
    vals, ids = ref.blend_topn_ref(_t(c), _t(qids), _t(nbr), 0.5, n)
    pv, pi = jblend(jnp.asarray(c), jnp.asarray(qids), jnp.asarray(nbr),
                    alpha=0.5, topn=n, bq=8, bm=16, bi=32, interpret=True)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(pi))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(pv))
    rows = np.where(nbr[..., None] >= 0, c[np.maximum(nbr, 0)], 0.0)
    ri = jref.blend_topn_rows_ref(jnp.asarray(c[qids]), jnp.asarray(rows),
                                  0.5, n)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ri))


def test_blend_topn_float_matches_jax(rng):
    m, items, q_n, k, n = 43, 71, 11, 7, 10
    c = rng.random((m, items)).astype(np.float32)
    qids = rng.choice(m, q_n, replace=False).astype(np.int32)
    nbr = _nbr_idx(rng, q_n, m, k, qids)
    vals, ids = ref.blend_topn_ref(_t(c), _t(qids), _t(nbr), 0.7, n)
    pv, pi = jblend(jnp.asarray(c), jnp.asarray(qids), jnp.asarray(nbr),
                    alpha=0.7, topn=n, bq=8, bm=16, bi=32, interpret=True)
    np.testing.assert_allclose(vals.numpy(), np.asarray(pv), rtol=1e-5)
    for a, b in zip(ids.numpy(), np.asarray(pi)):
        assert set(a.tolist()) == set(b.tolist())


# ---------------------------------------------------------------------------
# ops dispatch and the fused serving path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric", ["euclidean", "dot", "cosine"])
def test_fused_recommend_matches_jax(rng, metric):
    """On CPU tensors the serving path is the JAX reference's unfused
    pipeline, op for op; random data keeps scores separated, so ids are
    exact."""
    from repro.kernels import ops as jops
    m, items = 29, 45
    c = rng.random((m, items)).astype(np.float32)
    uids = np.array([3, 0, 28, 11, 7], np.int32)
    got = ops.fused_recommend(_t(c), _t(uids), k=40, alpha=0.7, topn=6,
                              metric=metric)
    exp = jops.fused_recommend(jnp.asarray(c), jnp.asarray(uids), k=40,
                               alpha=0.7, topn=6, metric=metric, impl="ref")
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))


def test_ops_impl_ref_and_auto_agree_on_cpu(rng):
    table, rows, ids, vals = _sparse_inputs(rng, 8, 100, 6, 11, False)
    a = ops.sparse_row_gather(_t(table), _t(rows), _t(ids), impl="ref")
    with ops.default_impl("ref"):
        b = ops.sparse_row_gather(_t(table), _t(rows), _t(ids))
    c = ops.sparse_row_gather(_t(table), _t(rows), _t(ids))
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(a.numpy(), c.numpy())
    with pytest.raises(ValueError):
        with ops.default_impl("pallas"):
            pass
