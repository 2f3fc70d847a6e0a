"""Cosine serving in the port against the JAX engine, on the CPU.

No kernel scores cosine, in either package: the JAX dispatchers send
``metric="cosine"`` to their plain pipeline on every backend, and the
port's ``ops.fused_recommend`` / ``ops.shard_topk`` do the same on every
impl, so ``StreamingEngine.recommend(metric="cosine")`` also serves on a
CUDA store.  Here both engines take one seeded TaFeng-shaped mixed
stream (scale 0.02: 278 users x 239 items) and answer cosine requests;
the port's answers are held against JAX's by
``knn.compare_recommendations(metric="cosine")``: identical ids wherever
neighbour k vs k+1 and item n vs n+1 are separated by more than 1e-5
relative, score-equivalent items elsewhere, at least 90% of the queries
in the exact class.  Under ``ops.default_impl("cuda")`` the port takes
the same plain route before any launch, so the answer is identical.
"""
import numpy as np
import pytest
import torch

from repro.data import stream as jstream
from repro.data import synthetic as jsynth
from repro.streaming import StateStore as JStore
from repro.streaming import StoreConfig as JConfig
from repro.streaming import StreamingEngine as JEngine
from repro_torch.core import knn
from repro_torch.kernels import build, ops
from repro_torch.streaming import StateStore, StoreConfig, StreamingEngine
from tests.test_torch_durability import tparams


@pytest.fixture(scope="module")
def engines():
    ds = jsynth.generate("tafeng", scale=0.02, seed=1)
    events = jstream.make_stream(ds.histories, deletion_user_rate=0.05,
                                 item_deletion_rate=0.02, seed=1)
    shape = dict(n_users=len(ds.histories), n_items=ds.params.n_items,
                 max_baskets=max(len(h) for h in ds.histories.values()) + 2,
                 max_basket_size=max(len(b) for h in ds.histories.values()
                                     for b in h))
    jeng = JEngine(JStore(JConfig(**shape)), ds.params, batch_size=32)
    teng = StreamingEngine(StateStore(StoreConfig(**shape), device="cpu"),
                           tparams(ds.params), batch_size=32)
    for eng in (jeng, teng):
        eng.submit(events)
        eng.run_until_drained()
    return ds.params, jeng, teng


@pytest.mark.parametrize("k,topn", [(None, 10), (5, 3)])
def test_cosine_recommend_matches_jax(engines, k, topn):
    p, jeng, teng = engines
    users = np.arange(teng.store.cfg.n_users)
    jids = jeng.recommend(users, topn=topn, k=k, metric="cosine")
    tids = teng.recommend(users, topn=topn, k=k, metric="cosine")
    assert tids.shape == jids.shape == (len(users), topn)
    res = knn.compare_recommendations(
        teng.store.corpus(), users, jids, tids,
        k=p.k_neighbors if k is None else k, alpha=p.alpha, rtol=1e-5,
        metric="cosine")
    assert res["mismatch"] == 0, res
    assert res["exact"] >= 0.9 * len(users), res
    # the euclidean answer differs: the metric reached the scores
    assert not np.array_equal(tids, teng.recommend(users, topn=topn, k=k))


def test_cosine_takes_the_plain_route_on_the_kernel_impl(engines):
    """Under impl="cuda" a CPU tensor would raise at the first launch;
    cosine is routed by its metric before any, and answers as plain."""
    _, _, teng = engines
    users = np.arange(0, teng.store.cfg.n_users, 3)
    want = teng.recommend(users, metric="cosine")
    before = dict(build.launch_counts)
    with ops.default_impl("cuda"):
        got = teng.recommend(users, metric="cosine")
        with pytest.raises(ValueError, match="CUDA"):
            teng.recommend(users)           # euclidean: the kernel route
    np.testing.assert_array_equal(got, want)
    assert build.launch_counts == before
    assert torch.count_nonzero(teng.store.corpus()) > 0
