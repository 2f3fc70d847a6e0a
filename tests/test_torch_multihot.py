"""The port's weighted multi-hot scatter against the JAX package.

``ref.decayed_scatter_ref`` (what ``ops.multihot_scatter`` runs on CPU
tensors) is held against the JAX Pallas kernel in interpret mode, called
as the JAX package's own tests call it, and against JAX's plain version;
the from-scratch user vectors (``core.tifu.batch_user_vectors``) against
``repro.core.tifu``.  The CUDA kernel runs only on the card
(``chip_smoke.py`` holds it against the plain version there).

Tolerance ``atol=1e-5``: every cell is a sum of a few f32 weights in
[0, 1), added in another order by the one-hot kernel.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tifu as jtifu
from repro.core.types import TifuParams as JParams
from repro.kernels import ref as jref
from repro.kernels.decayed_scatter import (batched_decayed_scatter,
                                           decayed_scatter)
from repro_torch.core import tifu
from repro_torch.core.types import TifuParams
from repro_torch.kernels import ops, ref


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


@pytest.mark.parametrize("n,b,items,bi,bn", [
    (256, 8, 512, 128, 64),
    (512, 16, 1024, 512, 256),
    (128, 4, 2048, 256, 128),
    (64, 32, 640, 128, 64),          # wide baskets, non-pow2 items
])
def test_decayed_scatter_matches_jax(rng, n, b, items, bi, bn):
    ids = rng.integers(-1, items, (n, b)).astype(np.int32)
    w = rng.random(n).astype(np.float32)
    got = ref.decayed_scatter_ref(_t(ids), _t(w), items)
    kern = decayed_scatter(jnp.asarray(ids), jnp.asarray(w), items, bi=bi,
                           bn=bn, interpret=True)
    plain = jref.decayed_scatter_ref(jnp.asarray(ids), jnp.asarray(w), items)
    assert got.shape == (items,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(plain), atol=1e-5)
    assert torch.equal(ops.multihot_scatter(_t(ids), _t(w), items), got)


@pytest.mark.parametrize("u,n,b,items", [(3, 128, 8, 256), (5, 24, 19, 600)])
def test_batched_decayed_scatter_matches_jax(rng, u, n, b, items):
    ids = rng.integers(-1, items, (u, n, b)).astype(np.int32)
    ids[0] = -1                                 # an all-PAD user
    ids[1, :8, 0] = 7                           # one id in 8 baskets
    w = rng.random((u, n)).astype(np.float32)
    got = ops.multihot_scatter(_t(ids), _t(w), items)
    assert got.shape == (u, items)
    if items % 128 == 0:                        # the Pallas kernel's grid
        exp = batched_decayed_scatter(jnp.asarray(ids), jnp.asarray(w),
                                      items, interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=1e-5)
    for i in range(u):
        exp = jref.decayed_scatter_ref(jnp.asarray(ids[i]),
                                       jnp.asarray(w[i]), items)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(exp),
                                   atol=1e-5)
        assert torch.equal(ref.decayed_scatter_ref(_t(ids[i]), _t(w[i]),
                                                   items), got[i])
    assert torch.count_nonzero(got[0]) == 0
    want = sum(float(w[1, r]) * int((ids[1, r] == 7).sum())
               for r in range(n))
    assert abs(float(got[1, 7]) - want) <= 1e-5


def test_out_of_range_ids_add_nothing(rng):
    """Ids >= n_items are dropped, as JAX's scatter and its one-hot
    kernel drop them."""
    items = 384
    ids = rng.integers(-1, items + 40, (96, 6)).astype(np.int32)
    ids[3] = items                              # exactly n_items
    w = rng.random(96).astype(np.float32)
    got = ops.multihot_scatter(_t(ids), _t(w), items, impl="ref")
    kern = decayed_scatter(jnp.asarray(ids), jnp.asarray(w), items,
                           interpret=True)
    plain = jref.decayed_scatter_ref(jnp.asarray(ids), jnp.asarray(w), items)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(plain), atol=1e-5)


def _histories(rng, m, n, b, items, k):
    """Padded histories with their group sizes, as a store holds them."""
    hist = np.full((m, n, b), -1, np.int32)
    sizes = np.zeros((m, k), np.int32)
    n_groups = np.zeros(m, np.int32)
    for u in range(m):
        nb = int(rng.integers(0, n + 1))
        for t in range(nb):
            size = int(rng.integers(1, b + 1))
            hist[u, t, :size] = rng.choice(items, size, replace=False)
        left, g = nb, 0
        while left > 0:
            sizes[u, g] = min(3, left)
            left -= sizes[u, g]
            g += 1
        n_groups[u] = g
    return hist, sizes, n_groups


def test_batch_user_vectors_match_jax(rng):
    items = 300
    hist, sizes, n_groups = _histories(rng, 12, 10, 5, items, 4)
    jp = JParams(n_items=items, group_size=3)
    tp = TifuParams(n_items=items, group_size=3)
    exp = np.asarray(jtifu.batch_user_vectors(
        jnp.asarray(hist), jnp.asarray(sizes), jnp.asarray(n_groups), jp))
    got = tifu.batch_user_vectors(_t(hist), _t(sizes), _t(n_groups), tp)
    np.testing.assert_allclose(got.numpy(), exp, atol=1e-5)
    # the kernel path's input: all users' rows in one batched call
    w = tifu.closed_form_basket_weights(_t(sizes), _t(n_groups), tp.r_b,
                                        tp.r_g, hist.shape[1])
    scattered = ops.multihot_scatter(_t(hist), w, items)
    np.testing.assert_allclose(scattered.numpy(), exp, atol=1e-5)


def test_multihot_builds_tifu_user_vector(rng):
    """End-to-end: the scatter of the closed-form weights == the TIFU
    user vector of the ragged numpy oracle (test_kernels.py's case)."""
    jp = JParams(n_items=512, group_size=3)
    baskets = [rng.choice(jp.n_items, size=4, replace=False)
               for _ in range(10)]
    sizes = jtifu.default_group_sizes(10, 3)
    ids = np.full((16, 8), -1, np.int32)
    for i, b_ in enumerate(baskets):
        ids[i, :len(b_)] = b_
    sizes_padded = np.asarray(sizes + [0] * (16 - len(sizes)), np.int32)
    w = tifu.closed_form_basket_weights(_t(sizes_padded[None]),
                                        torch.tensor([len(sizes)]), jp.r_b,
                                        jp.r_g, 16)[0]
    out = ops.multihot_scatter(_t(ids), w, jp.n_items)
    oracle = jtifu.user_vector_ragged(baskets, sizes, jp)
    np.testing.assert_allclose(out.numpy(), oracle, atol=1e-5)


def test_maintained_state_meets_the_rebuild_bar():
    """After a mixed add/delete stream, the incrementally maintained user
    vectors of both engines equal the from-scratch rebuild at the parity
    bar (rtol=1e-4, atol=1e-5) that ``chip_smoke.py`` holds the card's
    rebuild to; the port's rebuild goes through ``ops.multihot_scatter``
    in one batched call."""
    from repro.data import stream as jstream
    from repro.data import synthetic as jsynth
    from repro.streaming import StateStore as JStore
    from repro.streaming import StoreConfig as JConfig
    from repro.streaming import StreamingEngine as JEngine
    from repro_torch.data import synthetic
    from repro_torch.launch import serve

    ds = jsynth.generate("tafeng", seed=0, scale=0.02)
    p = ds.params
    shape = dict(n_users=len(ds.histories), n_items=p.n_items,
                 max_baskets=max(len(h) for h in ds.histories.values()) + 8,
                 max_basket_size=max(len(b) for h in ds.histories.values()
                                     for b in h) + 2)
    eng = JEngine(JStore(JConfig(**shape)), p, batch_size=512)
    eng.submit(jstream.make_stream(ds.histories, deletion_user_rate=0.01,
                                   item_deletion_rate=0.005, seed=0))
    eng.run_until_drained()
    st = eng.store.state
    fresh = np.asarray(jtifu.batch_user_vectors(st.history, st.group_sizes,
                                                st.n_groups, p))
    np.testing.assert_allclose(np.asarray(st.materialized_user_vecs()),
                               fresh, rtol=1e-4, atol=1e-5)

    run = serve.run_trickle(synthetic.generate("tafeng", seed=0, scale=0.02),
                            device="cpu", requests=0)
    ts = run.engine.store.state
    w = tifu.closed_form_basket_weights(ts.group_sizes, ts.n_groups, p.r_b,
                                        p.r_g, ts.history.shape[1])
    rebuilt = ops.multihot_scatter(ts.history, w, p.n_items)
    assert run.n_events > 1000 and int(ts.n_baskets.sum()) > 0
    np.testing.assert_allclose(rebuilt.numpy(),
                               ts.materialized_user_vecs().numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(rebuilt.numpy(), fresh, rtol=1e-4, atol=1e-5)
