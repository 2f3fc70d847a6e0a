"""tifu-knn's cells in the port, held against the JAX package.

Each cell is built on the CPU at a smoke size (``tifu_knn.SMOKE_SIZES``:
M 256, I 64, N 64, B 4, 64 adds, 16 + 16 deletes, 16 queries, k 5),
its inputs copied to numpy and run through the JAX reference:

* ``stream_update``'s fn against ``repro.core``'s three appliers
  composed as the JAX cell composes them: integer leaves exact, float
  leaves and the materialized vectors ``rtol=1e-4, atol=1e-5``;
* the seeded state's tables against JAX's from-scratch vectors of the
  same history, ``rtol=1e-5, atol=1e-6``;
* ``serve_topk``'s route (``knn.predict_streaming``) against
  ``repro.core.knn.predict`` on a one-device mesh (its streaming
  top-k and chunked mean), ``rtol=1e-5, atol=1e-6``.

The histories' statistics are held to ValuedShopper's in Table 1, as
the repo's synthetic generator draws them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import tifu_knn as jcfg
from repro.core import knn as jknn
from repro.core import tifu as jtifu
from repro.core import types as jtypes
from repro.core import updates as jupd
from repro.data import synthetic as jsynth
from repro.parallel.sharding import ShardingRules
from repro_torch import convert
from repro_torch.configs import all_cells, base, get_arch, tifu_knn
from repro_torch.core import knn
from repro_torch.kernels import ops
from repro_torch.launch import dryrun

SZ = tifu_knn.SMOKE_SIZES
INT_LEAVES = ("history", "group_sizes", "n_baskets", "n_groups")


def _jax_params(n_items):
    return dataclasses.replace(jcfg.make_params(), n_items=n_items)


def _np(t):
    return t.detach().cpu().numpy().copy()


def test_published_constants_equal_the_reference():
    for name in ("M_USERS", "N_ITEMS", "MAX_BASKETS", "MAX_BSIZE",
                 "UPDATE_BATCH", "DEL_BATCH", "N_QUERIES", "TOPK"):
        assert getattr(tifu_knn, name) == getattr(jcfg, name), name
    full = tifu_knn.Sizes()
    assert (full.n_users, full.n_items, full.max_baskets,
            full.max_basket_size, full.update_batch, full.del_batch,
            full.n_queries, full.topk) == (
        jcfg.M_USERS, jcfg.N_ITEMS, jcfg.MAX_BASKETS, jcfg.MAX_BSIZE,
        jcfg.UPDATE_BATCH, jcfg.DEL_BATCH, jcfg.N_QUERIES, jcfg.TOPK)
    assert dataclasses.asdict(tifu_knn.make_params()) == \
        dataclasses.asdict(jcfg.make_params())
    assert dataclasses.asdict(tifu_knn.smoke_config()) == \
        dataclasses.asdict(jcfg.smoke_config())
    arch = get_arch("tifu-knn")
    assert isinstance(arch, base.ArchDef)
    assert (arch.name, arch.family) == (jcfg.ARCH.name, jcfg.ARCH.family)
    assert set(arch.cells) == set(jcfg.ARCH.cells)
    assert [c for c in all_cells() if c[0] == "tifu-knn"] == \
        [("tifu-knn", s) for s in arch.cells]
    with pytest.raises(KeyError, match="tifu-knn"):
        get_arch("no-such-arch")


def test_reduced_names_the_cut_of_stream_update():
    prog = tifu_knn.stream_update_cell("cpu", 0, SZ)
    assert set(prog.reduced) == {"n_users"}
    assert prog.reduced["n_users"].startswith("256 → 128 (")
    cut = tifu_knn.stream_cut(tifu_knn.Sizes())
    assert cut["n_users"].startswith("1,048,576 → 524,288 (")
    for words in ("136.3 GiB", "2 x 64.0 GiB", "8.0 GiB of history",
                  "68.1 GiB at 524,288"):
        assert words in cut["n_users"], words
    assert tifu_knn.stream_cut(dataclasses.replace(
        SZ, stream_users=SZ.n_users)) == {}
    for shape in ("serve_topk", "serve_topk_opt"):
        assert get_arch("tifu-knn").cells[shape]("cpu", 0, SZ).reduced == {}
    # the JAX cell's model FLOPs at the published sizes: 1.30e8
    w, w_d = 8 * 32, 64 * 32
    assert w * 8 + 4 * w == 3072 and w_d * 11 + 8 * w_d == 38912
    assert 16_384 * 3072 + 2 * 1_024 * 38912 == 130_023_424


def test_seeded_state_is_the_from_scratch_state_of_its_history():
    prog = tifu_knn.stream_update_cell("cpu", 3, SZ)
    state, adds, delb, deli = prog.args
    a = convert.state_to_numpy(state)
    hist, nb = a["history"], a["n_baskets"]
    lo = SZ.max_baskets // 8
    assert nb.min() >= lo and nb.max() <= SZ.max_baskets - lo
    assert nb.min() < nb.max()
    for u in range(state.n_users):
        sizes = jtifu.default_group_sizes(int(nb[u]), 7)
        assert list(a["group_sizes"][u, :len(sizes)]) == sizes
        assert not a["group_sizes"][u, len(sizes):].any()
        assert a["n_groups"][u] == len(sizes)
        assert (hist[u, nb[u]:] == -1).all()
        for basket in hist[u, :nb[u]]:
            ids = basket[basket >= 0]
            assert 1 <= len(ids) <= SZ.max_basket_size
            assert (basket[:len(ids)] == ids).all()        # PAD after
            assert len(np.unique(ids)) == len(ids) and ids.max() < SZ.n_items
    for name in ("err_mult", "uv_scale", "lgv_scale"):
        assert (a[name] == 1.0).all(), name
    p = _jax_params(SZ.n_items)
    want_u = jtifu.batch_user_vectors(jnp.asarray(hist),
                                      jnp.asarray(a["group_sizes"]),
                                      jnp.asarray(a["n_groups"]), p)
    want_l = jax.vmap(lambda h, g, n: jtifu.last_group_vector_padded(
        h, g, n, p))(jnp.asarray(hist), jnp.asarray(a["group_sizes"]),
                     jnp.asarray(a["n_groups"]))
    np.testing.assert_allclose(a["user_vecs"], np.asarray(want_u),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(a["last_group_vecs"], np.asarray(want_l),
                               rtol=1e-5, atol=1e-6)
    assert np.count_nonzero(a["last_group_vecs"]) > 0


def test_batch_is_one_event_per_user_on_valid_positions():
    prog = tifu_knn.stream_update_cell("cpu", 5, SZ)
    state, adds, delb, deli = prog.args
    users = torch.cat([adds.user, delb.user, deli.user])
    assert users.numel() == SZ.update_batch + 2 * SZ.del_batch
    assert torch.unique(users).numel() == users.numel()
    for b in (adds, delb, deli):
        assert bool(b.valid.all()) and b.user.dtype == torch.int32
    nb = state.n_baskets
    for b in (delb, deli):
        assert bool((b.pos >= 0).all() and (b.pos < nb[b.user.long()]).all())
    rows = state.history[deli.user.long(), deli.pos.long()]
    assert bool((rows == deli.item[:, None]).any(dim=1).all())
    assert bool((deli.item >= 0).all())
    assert bool(((adds.items >= 0).sum(dim=1) >= 1).all())


def test_histories_follow_valuedshopper_statistics():
    """Zipf popularity, Poisson sizes around 9.1 items, Poisson basket
    counts around 56.9 clipped to [N/8, N − N/8], and the repeat
    purchases from each user's pool, at the published N and B."""
    assert tifu_knn.STATS == jsynth.DATASET_STATS["valuedshopper"]
    sz = dataclasses.replace(tifu_knn.SMOKE_SIZES, n_items=2048,
                             max_baskets=64, max_basket_size=32)
    gen = torch.Generator().manual_seed(0)
    state, pools = tifu_knn.build_state(
        gen, 512, sz, tifu_knn.make_params(sz.n_items), torch.device("cpu"))
    assert pools.shape == (512, tifu_knn.POOL) == (512, 27)
    assert all(len(set(r)) == 27 for r in pools.tolist())
    nb = state.n_baskets.numpy()
    assert nb.min() >= 8 and nb.max() == 56
    assert 0.45 < (nb == 56).mean() < 0.67    # P(Poisson(56.9) >= 56) = 0.565
    hist = state.history.numpy()
    live = np.arange(64)[None, :] < nb[:, None]
    sizes = (hist >= 0).sum(-1)[live]
    assert sizes.min() >= 1 and sizes.max() <= 32
    assert 8.0 < sizes.mean() < 9.3               # 9.1 less duplicates
    ids = hist[hist >= 0]
    counts = np.bincount(ids, minlength=sz.n_items)
    assert counts[0] == counts.max() and counts[:20].sum() > 0.2 * ids.size
    own = np.mean([np.isin(hist[u][hist[u] >= 0], pools[u].numpy()).mean()
                   for u in range(512)])
    other = np.mean([np.isin(hist[u][hist[u] >= 0],
                             pools[(u + 1) % 512].numpy()).mean()
                     for u in range(512)])
    assert own > 0.6 and other < 0.5 * own


@pytest.mark.parametrize("seed", [0, 1])
def test_stream_update_matches_the_jax_appliers(seed):
    prog = tifu_knn.stream_update_cell("cpu", seed, SZ)
    state, adds, delb, deli = prog.args
    arrays = convert.state_to_numpy(state)
    jstate = jtypes.StreamState(**{k: jnp.asarray(v)
                                   for k, v in arrays.items()})
    ja = jtypes.AddBatch(*(jnp.asarray(_np(x)) for x in
                           (adds.user, adds.items, adds.valid)))
    jb = jtypes.DelBasketBatch(*(jnp.asarray(_np(x)) for x in
                                 (delb.user, delb.pos, delb.valid)))
    ji = jtypes.DelItemBatch(*(jnp.asarray(_np(x)) for x in
                               (deli.user, deli.pos, deli.item, deli.valid)))
    p = _jax_params(SZ.n_items)
    jstate = jupd.apply_add_batch(jstate, ja, p)
    jstate = jupd.apply_del_basket_batch(jstate, jb, p)
    jstate = jupd.apply_del_item_batch(jstate, ji, p)

    out = prog.fn(*prog.args)
    assert out is state                               # in place
    got, exp = convert.state_to_numpy(out), convert.state_to_numpy(jstate)
    assert not np.array_equal(got["n_baskets"], arrays["n_baskets"])
    for name in convert.LEAVES:
        assert got[name].dtype == exp[name].dtype, name
        if name in INT_LEAVES:
            np.testing.assert_array_equal(got[name], exp[name],
                                          err_msg=name)
        else:
            np.testing.assert_allclose(got[name], exp[name], rtol=1e-4,
                                       atol=1e-5, err_msg=name)
    np.testing.assert_allclose(out.materialized_user_vecs().numpy(),
                               np.asarray(jstate.materialized_user_vecs()),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        out.materialized_last_group_vecs().numpy(),
        np.asarray(jstate.materialized_last_group_vecs()),
        rtol=1e-4, atol=1e-5)


def _one_device_mesh():
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    return mesh, ShardingRules(batch=("data",), fsdp=("data",))


def test_serve_topk_matches_jax_predict_on_a_mesh():
    prog = tifu_knn.serve_topk_cell("cpu", 7, SZ)
    queries, corpus = prog.args
    assert queries.shape == (SZ.n_queries, SZ.n_items)
    assert corpus.shape == (SZ.n_users, SZ.n_items)
    got = prog.fn(*prog.args)
    mesh, rules = _one_device_mesh()
    want = jknn.predict(jnp.asarray(_np(queries)), jnp.asarray(_np(corpus)),
                        k=SZ.topk, alpha=0.7, exclude_self=False, mesh=mesh,
                        rules=rules)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("exclude_self", [False, True])
def test_predict_streaming_matches_jax_predict_on_a_mesh(rng, exclude_self,
                                                       monkeypatch):
    """Corpus rows as queries, with and without self-exclusion, Q larger
    than one chunk of the mean (the chunk patched small)."""
    c = (rng.random((300, 40)) * (rng.random((300, 40)) < 0.2)).astype(
        np.float32)
    ids = rng.choice(300, size=37, replace=False).astype(np.int32)
    mesh, rules = _one_device_mesh()
    want = jknn.predict(jnp.asarray(c[ids]), jnp.asarray(c), k=9, alpha=0.7,
                        exclude_self=exclude_self,
                        query_ids=jnp.asarray(ids), mesh=mesh, rules=rules)
    monkeypatch.setattr(knn, "MEAN_QUERY_CHUNK", 16)
    got = knn.predict_streaming(torch.from_numpy(c[ids]),
                                torch.from_numpy(c), 9, 0.7,
                                exclude_self=exclude_self,
                                query_ids=torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_serve_topk_opt_matches_serve_topk():
    """The same seed gives both serve cells the same data; the merged
    row-block top-k is the whole corpus's, ids identical."""
    one = tifu_knn.serve_topk_cell("cpu", 11, SZ)
    opt = tifu_knn.serve_topk_opt_cell("cpu", 11, SZ)
    queries, blocks = opt.args
    assert len(blocks) == SZ.n_shards
    assert torch.equal(queries, one.args[0])
    assert torch.equal(torch.cat(blocks), one.args[1])
    np.testing.assert_allclose(opt.fn(*opt.args).numpy(),
                               one.fn(*one.args).numpy(), rtol=1e-5,
                               atol=1e-6)
    _, gids = knn.distributed_topk(queries, blocks, SZ.topk)
    _, idx = ops.knn_topk(queries, one.args[1], SZ.topk)
    assert torch.equal(gids, idx.long())


@pytest.mark.parametrize("shape", ["stream_update", "serve_topk",
                                   "serve_topk_opt"])
def test_run_cell_on_the_cpu_returns_every_field(shape):
    r = dryrun.run_cell("tifu-knn", shape, device="cpu", seed=0, sizes=SZ)
    assert set(r) == {"arch", "shape", "build_s", "description", "reduced",
                      "device", "run_s", "model_flops", "model_flops_per_s",
                      "peak_bytes", "estimate_bytes", "device_bytes",
                      "fits", "roofline", "chips", "model_flops_per_device",
                      "useful_flops_ratio"}
    assert (r["arch"], r["shape"], r["device"]) == ("tifu-knn", shape, "cpu")
    assert r["build_s"] > 0 and r["run_s"] > 0 and r["model_flops"] > 0
    assert r["model_flops_per_s"] == pytest.approx(
        r["model_flops"] / r["run_s"])
    # a CPU run measures no device memory; the estimate is arithmetic
    assert r["peak_bytes"] is None and r["fits"] is None
    assert r["estimate_bytes"] > 0
    assert bool(r["reduced"]) == (shape == "stream_update")
