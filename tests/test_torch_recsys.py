"""The port's recommender models against the JAX package.

Two-tower, DLRM, DeepFM and BERT4Rec at each config's
``smoke_config()``: the JAX package's parameters (``init_params`` from a
PRNG key) are carried across with ``convert.recsys_params_from_numpy``,
the batches come from the port's seeded makers
(``configs.recsys_shapes``) and go to both packages, and every serving
function is held against its JAX counterpart: ``serve_step`` of all
four, the towers, BERT4Rec's encoder with padding tokens present (a
sequence of padding alone included) and its full logits, both
``retrieval_step``s (through ``ops.knn_topk``'s plain version, B3's on
the card), and BERT4Rec's ``serve_step`` where ``vocab % vocab_chunk
!= 0``, whose tail rows the reference never scores.

Tolerance: fp32 ``rtol=1e-5, atol=1e-6``; ids exact or score-equivalent
(the JAX scores of both lists agree rank by rank within the same
tolerance).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import bert4rec_cfg as jbert_cfg
from repro.configs import deepfm_cfg as jdeepfm_cfg
from repro.configs import dlrm_mlperf as jdlrm_cfg
from repro.configs import two_tower_retrieval as jtt_cfg
from repro.models import bert4rec as jbert
from repro.models import deepfm as jdeepfm
from repro.models import dlrm as jdlrm
from repro.models import two_tower as jtt
from repro_torch import convert
from repro_torch.configs import (bert4rec_cfg, deepfm_cfg, dlrm_mlperf,
                                 recsys_shapes, two_tower_retrieval)
from repro_torch.kernels import ops
from repro_torch.models import bert4rec, deepfm, dlrm, two_tower
from repro_torch.models.embedding import InvalidIdError

TOL = dict(rtol=1e-5, atol=1e-6)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _jax(batch):
    """The batch as JAX arrays (ids as int32, as the reference's
    shapes)."""
    return {k: jnp.asarray(v.numpy().astype(np.int32)
                           if v.dtype == torch.int64 else v.numpy())
            for k, v in batch.items()}


def _port(arch, jmodule, jcfg, seed=0):
    jparams = jmodule.init_params(jcfg.smoke_config(),
                                  jax.random.PRNGKey(seed))
    numpy_tree = jax.tree.map(np.asarray, jparams)
    cfg = {"two_tower": two_tower_retrieval, "dlrm": dlrm_mlperf,
           "deepfm": deepfm_cfg, "bert4rec": bert4rec_cfg}[arch]
    c = cfg.smoke_config()
    return jparams, convert.recsys_params_from_numpy(arch, numpy_tree, c,
                                                     device="cpu"), c


def assert_topk_equivalent(got, exp, scores):
    """(values, ids) of both packages: values allclose, each row's ids
    equal or equal in ``scores`` (the reference's) rank by rank."""
    gv, gi = (np.asarray(x) for x in got)
    ev, ei = (np.asarray(x) for x in exp)
    np.testing.assert_allclose(gv, ev, **TOL)
    scores = np.asarray(scores)
    for r in range(gi.shape[0]):
        if not np.array_equal(gi[r], ei[r]):
            np.testing.assert_allclose(scores[r, gi[r]], scores[r, ei[r]],
                                       **TOL)
            assert len(set(gi[r].tolist())) == gi.shape[1]


@pytest.mark.parametrize("arch,jmod,jcfg,n_params", [
    ("two_tower", jtt, jtt_cfg, 52320), ("dlrm", jdlrm, jdlrm_cfg, 59409),
    ("deepfm", jdeepfm, jdeepfm_cfg, 36130),
    ("bert4rec", jbert, jbert_cfg, 34304)])
def test_configs_and_init_match_jax(arch, jmod, jcfg, n_params):
    """Configs letter for letter; ``init_params`` draws every parameter
    of the reference's tree from an explicit generator, reproducibly."""
    jp, model, c = _port(arch, jmod, jcfg)
    jc = jcfg.smoke_config()
    # n_params() is the reference's formula (it leaves out DeepFM's
    # bias and BERT4Rec's output bias); the model holds every leaf
    assert c.n_params() == jc.n_params()
    assert sum(p.numel() for p in model.parameters()) == n_params == \
        sum(x.size for x in jax.tree.leaves(jp))
    mod = {"two_tower": two_tower, "dlrm": dlrm, "deepfm": deepfm,
           "bert4rec": bert4rec}[arch]
    a = mod.init_params(c, _gen(1), device="cpu")
    b = mod.init_params(c, _gen(1), device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                 b.parameters()))
    # trainable: the serving entry points run under torch.no_grad()
    assert all(p.requires_grad for p in a.parameters())
    full = {"two_tower": two_tower_retrieval, "dlrm": dlrm_mlperf,
            "deepfm": deepfm_cfg, "bert4rec": bert4rec_cfg}[arch]
    assert full.make_config().n_params() == jcfg.make_config().n_params()


def test_full_configs_match_jax():
    assert two_tower_retrieval.make_config().tower_mlp == (1024, 512, 256)
    assert dlrm.CRITEO_1TB_VOCABS == jdlrm.CRITEO_1TB_VOCABS
    assert deepfm.DEEPFM_VOCABS == jdeepfm.DEEPFM_VOCABS
    c, jc = bert4rec_cfg.make_config(), jbert_cfg.make_config()
    assert c.vocab == jc.vocab == 1_000_448
    assert (recsys_shapes.TRAIN_BATCH, recsys_shapes.SERVE_P99,
            recsys_shapes.SERVE_BULK, recsys_shapes.N_CANDIDATES) == \
        (65536, 512, 262144, 1_000_000)


def test_two_tower_towers_and_serve_step_match_jax():
    jp, model, c = _port("two_tower", jtt, jtt_cfg)
    batch = recsys_shapes.two_tower_batch(c, 24, _gen())
    assert bool((batch["history"] == -1).any())
    jb, jc = _jax(batch), jtt_cfg.smoke_config()
    for ours, theirs in ((two_tower.user_tower, jtt.user_tower),
                         (two_tower.item_tower, jtt.item_tower),
                         (two_tower.serve_step, jtt.serve_step)):
        np.testing.assert_allclose(ours(model, batch, c).detach().numpy(),
                                   np.asarray(theirs(jp, jb, jc)), **TOL)


def test_two_tower_retrieval_step_matches_jax():
    jp, model, c = _port("two_tower", jtt, jtt_cfg)
    batch = recsys_shapes.two_tower_retrieval_batch(c, _gen(2), n_cand=3000)
    jb = _jax(batch)
    exp = jtt.retrieval_step(jp, jb, jtt_cfg.smoke_config(), top_n=100)
    got = two_tower.retrieval_step(model, batch, c, top_n=100)
    assert got[1].dtype == torch.int32
    eu = jtt.user_tower(jp, jb, jtt_cfg.smoke_config())
    assert_topk_equivalent(got, exp, eu @ jb["candidates"].T)
    with ops.default_impl("ref"):
        assert torch.equal(got[1],
                           two_tower.retrieval_step(model, batch, c)[1])


def test_dlrm_serve_step_and_interaction_match_jax(rng):
    jp, model, c = _port("dlrm", jdlrm, jdlrm_cfg)
    batch = recsys_shapes.dlrm_batch(c, 40, _gen(3))
    jc = jdlrm_cfg.smoke_config()
    np.testing.assert_allclose(
        dlrm.serve_step(model, batch, c).numpy(),
        np.asarray(jdlrm.serve_step(jp, _jax(batch), jc)), **TOL)
    np.testing.assert_allclose(
        dlrm.forward(model, batch, c).detach().numpy(),
        np.asarray(jdlrm.forward(jp, _jax(batch), jc)), **TOL)
    # the pair order is np.tril_indices(F, k=-1)'s, row-major: (1,0),
    # (2,0), (2,1), (3,0), ...
    v = rng.normal(size=(3, 5, 4)).astype(np.float32)
    got = dlrm.dot_interaction(torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, np.asarray(jdlrm.dot_interaction(
        jnp.asarray(v))), **TOL)
    pairs = [(i, j) for i in range(5) for j in range(i)]
    np.testing.assert_allclose(
        got, np.stack([(v[:, i] * v[:, j]).sum(-1) for i, j in pairs], -1),
        **TOL)


def test_deepfm_serve_step_matches_jax():
    jp, model, c = _port("deepfm", jdeepfm, jdeepfm_cfg)
    # a nonzero bias and first-order weights, so every term counts
    with torch.no_grad():
        model.bias.fill_(0.25)
    jp = {**jp, "bias": jnp.asarray(0.25, jnp.float32)}
    batch = recsys_shapes.deepfm_batch(c, 40, _gen(4))
    jc = jdeepfm_cfg.smoke_config()
    np.testing.assert_allclose(
        deepfm.forward(model, batch, c).detach().numpy(),
        np.asarray(jdeepfm.forward(jp, _jax(batch), jc)), **TOL)
    np.testing.assert_allclose(
        deepfm.serve_step(model, batch, c).numpy(),
        np.asarray(jdeepfm.serve_step(jp, _jax(batch), jc)), **TOL)


def _bert_batch(c, n, seed):
    batch = recsys_shapes.bert4rec_batch(c, n, _gen(seed))
    batch["ids"][0] = 0                  # a sequence of padding alone
    return batch


def test_bert4rec_encoder_and_logits_match_jax():
    """Padding keys masked with −1e30 (a row of padding alone stays
    finite: −inf would give NaN), tanh GELU, population-variance norms."""
    jp, model, c = _port("bert4rec", jbert, jbert_cfg)
    jc = jbert_cfg.smoke_config()
    batch = _bert_batch(c, 6, 5)
    assert bool((batch["ids"][1:] == 0).any())
    got = bert4rec.encoder(model, batch["ids"], c)
    exp = jbert.encoder(jp, _jax(batch)["ids"], jc)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(exp), **TOL)
    np.testing.assert_allclose(
        bert4rec.forward_logits(model, batch["ids"], c).detach().numpy(),
        np.asarray(jbert.forward_logits(jp, _jax(batch)["ids"], jc)),
        rtol=1e-5, atol=1e-5)
    bad = batch["ids"].clone()
    bad[1, 3] = c.vocab
    with pytest.raises(InvalidIdError):
        bert4rec.encoder(model, bad, c)


@pytest.mark.parametrize("vocab_chunk,batch_chunk", [
    (65536, 16384),      # one chunk of the whole (512-row) vocab
    (128, 16384),        # 4 whole chunks
    (100, 16384),        # 512 % 100: rows 500..511 never scored
    (100, 4),            # and in batch chunks of 4
])
def test_bert4rec_serve_step_matches_jax(vocab_chunk, batch_chunk):
    jp, model, c = _port("bert4rec", jbert, jbert_cfg)
    jc = jbert_cfg.smoke_config()
    batch = _bert_batch(c, 12, 6)
    got = bert4rec.serve_step(model, batch, c, top_n=20,
                              vocab_chunk=vocab_chunk,
                              batch_chunk=batch_chunk)
    exp = jbert.serve_step(jp, _jax(batch), jc, top_n=20,
                           vocab_chunk=vocab_chunk, batch_chunk=batch_chunk)
    x = jbert.encoder(jp, _jax(batch)["ids"], jc)[:, -1, :]
    scores = x @ jp["item_emb"].T + jp["out_bias"]
    assert_topk_equivalent(got, exp, scores)
    scored = c.vocab // min(vocab_chunk, c.vocab) * min(vocab_chunk,
                                                        c.vocab)
    assert int(got[1].max()) < scored
    if scored < c.vocab:
        # the reference's tail: the unscored rows would have entered
        # some list had they been scored
        full = np.argsort(-np.asarray(scores), axis=1, kind="stable")[:, :20]
        assert (full >= scored).any()


def test_bert4rec_retrieval_step_matches_jax():
    jp, model, c = _port("bert4rec", jbert, jbert_cfg)
    jc = jbert_cfg.smoke_config()
    batch = recsys_shapes.bert4rec_retrieval_batch(c, _gen(7), n_cand=2500)
    jb = _jax(batch)
    got = bert4rec.retrieval_step(model, batch, c, top_n=100)
    exp = jbert.retrieval_step(jp, jb, jc, top_n=100)
    q = jbert.encoder(jp, jb["ids"], jc)[:, -1, :]
    assert_topk_equivalent(got, exp, q @ jb["candidates"].T)


def test_batch_makers_are_seeded_and_in_range():
    tt, dl = two_tower_retrieval.make_config(), dlrm_mlperf.make_config()
    a = recsys_shapes.dlrm_batch(dl, 64, _gen(9))
    b = recsys_shapes.dlrm_batch(dl, 64, _gen(9))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["sparse"].shape == (64, 26) and a["dense"].shape == (64, 13)
    assert bool((a["sparse"] >= 0).all())
    assert bool((a["sparse"] < torch.tensor(dl.vocab_sizes)).all())
    t = recsys_shapes.two_tower_batch(tt, 64, _gen(9))
    assert t["history"].shape == (64, 50)
    assert int(t["history"].min()) >= -1
    assert int(t["history"].max()) < tt.n_items
    r = recsys_shapes.two_tower_retrieval_batch(tt, _gen(9), n_cand=10)
    np.testing.assert_allclose(torch.linalg.norm(r["candidates"], dim=-1),
                               1.0, rtol=1e-5)
    ids = recsys_shapes.bert4rec_batch(bert4rec_cfg.make_config(), 8,
                                       _gen(9))["ids"]
    assert ids.shape == (8, 200) and int(ids.max()) < 1_000_002
    # padding only before each sequence, never after an item
    first = (ids != 0).int().argmax(dim=1)
    assert all(bool((row[f:] >= 2).all()) for row, f in zip(ids, first))
