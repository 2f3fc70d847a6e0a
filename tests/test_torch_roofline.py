"""The port's cost model and roofline held against the JAX package's.

* FLOPs: ``launch/cost.py``'s ``CostCounter`` against
  ``repro.launch.hlo_cost.HloCostModel`` on the HLO of the same
  program, on the same numpy inputs, exactly: an MLP forward, its
  ``value_and_grad`` (both programs return the loss and the gradients:
  with plain ``jax.grad`` XLA drops the forward product whose value is
  not returned), a batched einsum, and the ``serve_p99`` smoke cells of
  DLRM, DeepFM and two-tower against their JAX ``serve_step``;
* a granite smoke prefill's FLOPs against its closed form, and the
  closed forms ``tools/flops_gap.py`` explains the cells' model FLOPs
  by (the other LM prefills, tifu-knn's two serving cells, DimeNet's
  and DeepFM's training steps) held to the counter at smoke sizes;
  ``stream_update``'s FLOPs are B2's adds alone;
* the counted bytes of an AdamW step over a table of DLRM's width,
  against a hand count of the aten ops it runs;
* ``kernels/work.py``'s bound of each kernel at ``PERF.md`` §6's shapes,
  to that table's printed digits;
* the dispatchers' records: on the plain route a dispatcher counts its
  kernel's declared work exactly, nothing of the plain version's ops;
* the counter's byte rules (views, in-place ops, gathers, scatters);
* collectives (c10d and functional) counted under the JAX model's keys;
* ``RooflineTerms`` against JAX's on bf16-only costs, the JAX module's
  constants patched to the H100's (no file of the JAX package changes);
* ``dryrun.run_cell`` on the CPU returning the JAX dry run's roofline
  fields for one cell of each family.
"""
import importlib.util
import socket
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol

from repro.launch import roofline as jroofline
from repro.launch.hlo_cost import HloCostModel
from repro.models import deepfm as jdeepfm
from repro.models import dlrm as jdlrm
from repro.models import two_tower as jtt
from repro_torch.configs import get_arch, smoke_sizes
from repro_torch.kernels import ops, ref, work
from repro_torch.launch import dryrun, mesh, roofline
from repro_torch.launch.cost import CostCounter, Costs
from repro_torch.optim import optimizers

from test_torch_registry_cells import _recsys

_spec = importlib.util.spec_from_file_location(
    "flops_gap", Path(__file__).resolve().parents[1] / "tools"
    / "flops_gap.py")
flops_gap = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(flops_gap)

BF16, F32, I8 = torch.bfloat16, torch.float32, torch.int8
# PERF.md §6's stage A/B shapes: TaFeng, 256 queries, k 300, top 10
Q, M, D, K, N = 256, 13949, 11997, 300, 10
ROWS_USED = 1462


def _hlo_flops(fn, *args) -> float:
    hlo = jax.jit(fn).lower(*args).compile().as_text()
    return HloCostModel(hlo).cost().flops


def _counted(fn, *args) -> Costs:
    with CostCounter("cpu") as c:
        fn(*args)
    return c.costs


def _mlp_params(rng):
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((48, 96), (96,), (96, 24), (24,))]


def _jax_mlp(p, x):
    h = jax.nn.relu(x @ p[0] + p[1])
    return h @ p[2] + p[3]


def _torch_mlp(p, x):
    h = torch.relu(x @ p[0] + p[1])
    return h @ p[2] + p[3]


def _case_mlp_forward(rng):
    p, x = _mlp_params(rng), rng.standard_normal((64, 48)).astype(np.float32)
    want = _hlo_flops(_jax_mlp, [jnp.asarray(a) for a in p], jnp.asarray(x))
    tp = [torch.from_numpy(a) for a in p]
    return want, _counted(_torch_mlp, tp, torch.from_numpy(x))


def _case_mlp_value_and_grad(rng):
    p, x = _mlp_params(rng), rng.standard_normal((64, 48)).astype(np.float32)

    def jloss(p, x):
        return jnp.mean(_jax_mlp(p, x) ** 2)
    want = _hlo_flops(jax.value_and_grad(jloss),
                      [jnp.asarray(a) for a in p], jnp.asarray(x))
    tp = [torch.from_numpy(a).requires_grad_() for a in p]

    def tloss(p, x):
        loss = torch.mean(_torch_mlp(p, x) ** 2)
        return loss, torch.autograd.grad(loss, p)
    return want, _counted(tloss, tp, torch.from_numpy(x))


def _case_batched_einsum(rng):
    a = rng.standard_normal((4, 16, 24)).astype(np.float32)
    b = rng.standard_normal((4, 24, 40)).astype(np.float32)
    want = _hlo_flops(lambda a, b: jnp.einsum("bij,bjk->bik", a, b),
                      jnp.asarray(a), jnp.asarray(b))
    return want, _counted(lambda a, b: torch.einsum("bij,bjk->bik", a, b),
                          torch.from_numpy(a), torch.from_numpy(b))


def _case_serve(name, jmod):
    def case(rng):
        prog, jp, jb, jc = _recsys(name, "serve_p99")
        want = _hlo_flops(lambda p, b: jmod.serve_step(p, b, jc), jp, jb)
        return want, dryrun.count_program(prog, "cpu")
    return case


@pytest.mark.parametrize("case", [
    _case_mlp_forward, _case_mlp_value_and_grad, _case_batched_einsum,
    _case_serve("dlrm-mlperf", jdlrm), _case_serve("deepfm", jdeepfm),
    _case_serve("two-tower-retrieval", jtt)],
    ids=["mlp_forward", "mlp_value_and_grad", "batched_einsum",
         "dlrm_serve_p99", "deepfm_serve_p99", "two_tower_serve_p99"])
def test_counted_flops_equal_the_jax_hlo_model(case):
    want, costs = case(np.random.default_rng(0))
    assert want > 0
    assert costs.flops == want
    assert costs.flops_by_dtype == {"f32": want}


def test_granite_prefill_flops_are_the_closed_form():
    sizes = smoke_sizes("granite-3-2b", "prefill_32k")
    c, b, s = sizes.config, sizes.batch, sizes.seq
    prog = get_arch("granite-3-2b").cells["prefill_32k"]("cpu", 0, sizes)
    costs = dryrun.count_program(prog, "cpu")
    d, h, kv, dh = c.d_model, c.n_heads, c.n_kv_heads, c.d_head
    # q, k, v, o and the gated MLP's three products, per token and layer
    params = d * h * dh + 2 * d * kv * dh + h * dh * d + 3 * d * c.d_ff
    pairs = s * (s + 1) // 2
    want = (2 * b * s * params * c.n_layers
            + 2 * b * d * c.vocab_size                   # the last position
            + c.n_layers * b * h * pairs * 2 * (dh + dh))
    assert costs.flops == want
    assert costs.kernel_calls == {"flash_attention": c.n_layers}


def _smoke_costs(name, shape):
    sizes = smoke_sizes(name, shape)
    prog = get_arch(name).cells[shape]("cpu", 0, sizes)
    return sizes, dryrun.count_program(prog, "cpu")


@pytest.mark.parametrize("name", ["granite-3-2b", "command-r-plus-104b",
                                  "gemma3-27b", "deepseek-v3-671b",
                                  "qwen2-moe-a2.7b"])
def test_lm_prefill_flops_are_the_closed_form(name):
    sizes, costs = _smoke_costs(name, "prefill_32k")
    c = sizes.config
    # on the CPU's f32 route transformer.kernel_v pads MLA's V to Q's
    # width, and the dispatcher is handed that V
    terms = flops_gap.lm_prefill(c, sizes.batch, sizes.seq,
                                 v_width=c.qk_dim if c.mla else None)
    assert costs.flops == sum(terms.values())
    assert costs.kernel_calls == {"flash_attention": c.n_layers}


def test_closed_form_lm_prefill_splits_the_model_formula():
    """The formula's 2·N_active·tokens is its two terms, and the counted
    terms the products of the layers at every position (GQA, dense FFN)
    beside the head at the last position and the attention."""
    c = get_arch("command-r-plus-104b").make_smoke()
    b, s = 2, 16
    model = flops_gap.lm_prefill_model(c, b, s)
    assert sum(model.values()) == 2.0 * c.n_active_params() * b * s
    counted = flops_gap.lm_prefill(c, b, s)
    layers = counted["attention projections"] + counted["dense FFN"]
    assert layers == model["layers' active parameters at every position"]


@pytest.mark.parametrize("shape,blocks", [("serve_topk", 1),
                                          ("serve_topk_opt", 4)])
def test_tifu_serve_flops_are_the_closed_form(shape, blocks):
    sizes, costs = _smoke_costs("tifu-knn", shape)
    assert sizes.n_shards == blocks or shape == "serve_topk"
    assert costs.flops == sum(flops_gap.tifu_serve(sizes, blocks).values())
    assert costs.kernel_calls == {"knn_topk": blocks}


def test_stream_update_flops_are_b2s_adds():
    _, costs = _smoke_costs("tifu-knn", "stream_update")
    adds = costs.kernels["sparse_row_scatter"]["flops"]
    assert adds > 0
    assert costs.flops == adds and costs.flops_by_dtype == {"f32": adds}


@pytest.mark.parametrize("shape", ["molecule", "ogb_products"])
def test_dimenet_train_flops_are_the_closed_form(shape):
    sizes, costs = _smoke_costs("dimenet", shape)
    cell = get_arch("dimenet").cells[shape]
    g = cell.batch.graph(sizes.config, sizes.batch)
    assert costs.flops == sum(flops_gap.dimenet_train(sizes.config,
                                                      g).values())
    model = flops_gap.dimenet_model(sizes.config, g)
    assert sum(model.values()) == cell.flops(sizes)


def test_deepfm_train_flops_are_the_closed_form():
    sizes, costs = _smoke_costs("deepfm", "train_batch")
    assert costs.flops == sum(flops_gap.deepfm_train(sizes.config,
                                                     sizes.batch).values())
    model = flops_gap.deepfm_train_model(sizes.config, sizes.batch)
    assert sum(model.values()) == get_arch("deepfm").cells[
        "train_batch"].flops(sizes)


def test_adamw_step_bytes_are_the_hand_count():
    """One AdamW step over a table of DLRM's published width (128 f32
    columns), each of its aten ops reading its operands and writing its
    outputs once, counted by hand: per element, in f32 words, the
    gradient norm's read 1, the clip's g *= scale 2, m = b1·m + (1-b1)·g
    2 + 3, v = b2·v + (1-b2)·g² 2 + 3 (g read once), m/bc1 2, v/bc2 2,
    sqrt 2, + eps 2, the division 3, + wd·p 3, · lr 2, p -= delta 3:
    32 words; and 56 bytes of scalars (the norms, their stack, the
    clip's clamps, reciprocal and product, the scale's read)."""
    dim = get_arch("dlrm-mlperf").cells["train_batch"].published.config \
        .embed_dim
    table = torch.nn.Parameter(torch.rand((1000, dim)))
    opt = optimizers.adamw([table])
    table.grad = torch.rand((1000, dim))
    costs = _counted(opt.step)
    assert costs.bytes == 32 * 4 * table.numel() + 56
    assert costs.flops == 0


def _meta(*shape, dtype=F32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _ids(*shape, high):
    return torch.from_numpy(np.random.default_rng(1).integers(
        0, high, shape).astype(np.int32))


def _attn(b, s, h, kv, d, dv=None):
    dv = d if dv is None else dv
    return dict(q=_meta(b, s, h, d, dtype=BF16),
                k=_meta(b, s, kv, d, dtype=BF16),
                v=_meta(b, s, kv, dv, dtype=BF16))


# (work function, its inputs, PERF.md §6's bound ms, "bytes" | "operations")
BOUNDS = {
    "B3": ("knn_topk", lambda: dict(
        queries=_meta(Q, D), corpus=_meta(M, D), k=K,
        query_gids=_meta(Q, dtype=torch.int32)), 1.2838, "operations"),
    "B3 dot Q=1 M=1e6 D=256": (
        "knn_topk", lambda: dict(queries=_meta(1, 256),
                                 corpus=_meta(10 ** 6, 256), k=100,
                                 metric="dot"), 0.3057, "bytes"),
    "B3 dot Q=64 M=200,000 D=64": (
        "knn_topk", lambda: dict(queries=_meta(64, 64),
                                 corpus=_meta(200_000, 64), k=100,
                                 metric="dot"), 0.0245, "operations"),
    # the 1,462 distinct rows of the kernel checks' neighbour lists
    "B4": ("blend_topn_onehot", lambda: dict(
        corpus=_meta(M, D), user_ids=_ids(Q, high=ROWS_USED),
        nbr_idx=_ids(Q, K, high=ROWS_USED), topn=N), 0.0276, "operations"),
    "B5 int8": ("knn_topk_dtiled", lambda: dict(
        queries=_meta(Q, D, dtype=I8), corpus=_meta(M, D, dtype=I8), k=K,
        query_gids=_meta(Q, dtype=torch.int32), q_scale=_meta(Q),
        c_scale=_meta(M)), 0.0511, "bytes"),
    "B5 int8 million-item": ("knn_topk_dtiled", lambda: dict(
        queries=_meta(32, 1 << 20, dtype=I8),
        corpus=_meta(256, 1 << 20, dtype=I8), k=16,
        query_gids=_meta(32, dtype=torch.int32), q_scale=_meta(32),
        c_scale=_meta(256)), 0.0901, "bytes"),
    "B5 fp32": ("knn_topk_dtiled", lambda: dict(
        queries=_meta(Q, D), corpus=_meta(M, D), k=K,
        query_gids=_meta(Q, dtype=torch.int32)), 1.2838, "operations"),
    "B5 fp32 million-item": ("knn_topk_dtiled", lambda: dict(
        queries=_meta(32, 1 << 20), corpus=_meta(256, 1 << 20), k=16,
        query_gids=_meta(32, dtype=torch.int32)), 0.3606, "bytes"),
    "B6": ("blend_topn_rows_indexed", lambda: dict(
        queries_q=_meta(Q, D, dtype=I8), q_scale=_meta(Q),
        corpus_q=_meta(M, D, dtype=I8), c_scale=_meta(M),
        nbr_idx=_ids(Q, K, high=ROWS_USED), topn=N), 0.0276, "operations"),
    "B7": ("blend_topn_rows", lambda: dict(
        queries=_meta(Q, D), neighbor_rows=_meta(Q, K, D), topn=N),
        1.1038, "bytes"),
    "B8": ("decayed_scatter", lambda: dict(
        ids=torch.zeros((M, 25, 21), dtype=torch.int32),
        weights=_meta(M, 25), n_items=D), 0.2090, "bytes"),
    "B9 granite layer 0": ("flash_attention", lambda: _attn(4, 4096, 32, 8,
                                                            64),
                           0.2780, "operations"),
    "B9 DeepSeek MLA layer 0": ("flash_attention", lambda: _attn(
        4, 4096, 128, 128, 192, 128), 2.7800, "operations"),
    "9b granite layer 0": ("flash_attention_bwd", lambda: dict(
        _attn(4, 4096, 32, 8, 64), dout=_meta(4, 4096, 32, 64, dtype=BF16)),
        0.6950, "operations"),
    "9b DeepSeek MLA layer 0": ("flash_attention_bwd", lambda: dict(
        _attn(1, 4096, 128, 128, 192, 128),
        dout=_meta(1, 4096, 128, 128, dtype=BF16)), 1.8070, "operations"),
}


@pytest.mark.parametrize("what", list(BOUNDS))
def test_kernel_bound_is_the_perf_table_bound(what):
    name, inputs, ms, by = BOUNDS[what]
    seconds, got_by = roofline.kernel_bound(name, **inputs())
    assert f"{seconds * 1e3:.4f}" == f"{ms:.4f}"
    assert got_by == by


def test_b4_bytes_are_its_distinct_rows():
    """PERF.md §6: "the 1,462 distinct rows' bytes 0.0210"."""
    w = work.blend_topn_onehot(_meta(M, D), _ids(Q, high=ROWS_USED),
                               _ids(Q, K, high=ROWS_USED), N)
    assert f"{w.bytes / mesh.HBM_BW * 1e3:.4f}" == "0.0210"


def test_attention_pairs_are_the_masks_count():
    for s in (1, 7, 64, 333):
        for causal in (True, False):
            for window in (0, 1, 17, 70, 400):
                qp = np.arange(s)[:, None]
                kp = np.arange(s)[None, :]
                mask = np.ones((s, s), bool)
                if causal:
                    mask &= kp <= qp
                if window:
                    mask &= kp > qp - window
                assert work.visible_pairs(s, causal, window) == mask.sum(), \
                    (s, causal, window)


def test_dispatchers_count_only_their_declared_work_on_the_plain_route():
    g = torch.Generator().manual_seed(0)
    q, c = torch.rand((8, 40), generator=g), torch.rand((300, 40), generator=g)
    gids = torch.arange(8, dtype=torch.int32)
    costs = _counted(lambda: ops.knn_topk(q, c, 7, query_gids=gids))
    w = work.knn_topk(q, c, 7, query_gids=gids)
    assert (costs.flops, costs.bytes) == (w.ops, w.bytes)
    assert costs.kernel_calls == {"knn_topk": 1}

    qa = torch.randn((2, 33, 4, 16), generator=g, requires_grad=True)
    ka = torch.randn((2, 33, 2, 16), generator=g, requires_grad=True)
    va = torch.randn((2, 33, 2, 8), generator=g, requires_grad=True)
    dout = torch.randn((2, 33, 4, 8), generator=g)

    def fwd_bwd():
        ops.flash_attention(qa, ka, va, window=9).backward(dout)
    costs = _counted(fwd_bwd)
    f = work.flash_attention(qa, ka, va, True, 9)
    b = work.flash_attention_bwd(qa, ka, va, dout, True, 9)
    assert costs.kernel_calls == {"flash_attention": 1,
                                  "flash_attention_bwd": 1}
    assert costs.flops == f.ops + b.ops
    # the plain route counts nothing of its own; around it, autograd's
    # seed gradient (the dout copy) and the leaves' gradients
    around = costs.bytes - f.bytes - b.bytes
    leaves = sum(t.numel() * 4 for t in (qa, ka, va))
    assert 0 <= around <= dout.numel() * 4 * 2 + leaves * 3


def test_fused_recommend_records_both_stages():
    g = torch.Generator().manual_seed(1)
    corpus = torch.rand((64, 32), generator=g)
    users = torch.tensor([3, 9, 9, 40], dtype=torch.int32)
    costs = _counted(lambda: ops.fused_recommend(corpus, users, 5, 0.7, 4))
    assert costs.kernel_calls == {"knn_topk": 1, "blend_topn_onehot": 1}
    queries = corpus[users.long()]
    idx = ref.fused_topk_ref(queries, corpus, users, 5)
    w3 = work.knn_topk(queries, corpus, 5, query_gids=users)
    w4 = work.blend_topn_onehot(corpus, users, idx, 4)
    assert costs.flops == w3.ops + w4.ops
    # the ids' int64 copy and the queries' gather, then the two stages
    gather = users.numel() * (4 + 8) + users.numel() * 8 \
        + queries.numel() * 4 * 2
    assert costs.bytes == w3.bytes + w4.bytes + gather


def test_byte_rules_views_inplace_gathers_scatters():
    x = torch.rand((64, 32))
    assert _counted(lambda: (x.t(), x[:4], x.view(-1),
                             x.expand(2, 64, 32))).bytes == 0
    nb = x.numel() * 4
    assert _counted(lambda: x.add_(1.0)).bytes == 2 * nb
    # a tensor given as two operands is read once
    assert _counted(lambda: x + x).bytes == 2 * nb
    y = torch.rand((64, 32))
    assert _counted(lambda: x.addcmul_(y, y)).bytes == 3 * nb
    assert _counted(lambda: x.fill_(0.5)).bytes == nb
    # a broadcast operand reads its distinct elements once
    row = torch.rand((1, 32))
    assert _counted(lambda: x + row.expand(64, 32)).bytes == 2 * nb + 32 * 4
    idx = torch.tensor([1, 5, 5, 9])
    # a gather reads what it writes, and its ids
    assert _counted(lambda: x[idx]).bytes == 2 * 4 * 32 * 4 + 4 * 8
    vals = torch.rand((4, 32))
    # a scatter touches the rows it addresses: read and written (it
    # accumulates), beside its values and ids
    got = _counted(lambda: x.index_put_((idx,), vals, accumulate=True))
    assert got.bytes == 2 * 4 * 32 * 4 + vals.numel() * 4 + 4 * 8
    got = _counted(lambda: x.index_add_(0, idx, vals))
    assert got.bytes == 2 * 4 * 32 * 4 + vals.numel() * 4 + 4 * 8
    assert got.flops == 0


def test_no_counter_is_active_outside_with():
    assert work.SINK is None
    with CostCounter("cpu") as outer:
        assert work.SINK is outer
        with CostCounter("cpu") as inner:
            assert work.SINK is inner
        assert work.SINK is outer
    assert work.SINK is None
    assert isinstance(work.kernel(work.knn_topk, None, None, 1),
                      type(work._UNCOUNTED))


def test_collectives_are_counted_under_the_jax_keys():
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        x = torch.ones(1000)
        gathered = torch.empty(1000)
        with CostCounter("cpu") as c:
            dist.all_reduce(x)
            funcol.all_reduce(x, "sum", dist.group.WORLD) + 0
            dist.all_gather_into_tensor(gathered, x)
    finally:
        dist.destroy_process_group()
    assert dict(c.costs.coll) == {"all-reduce": 8000.0, "all-gather": 4000.0}
    assert c.costs.coll_counts == {"all-reduce": 2, "all-gather": 1}
    terms = roofline.analyze(c.costs)
    assert terms.t_collective == pytest.approx(12000.0 / mesh.LINK_BW)
    assert terms.as_dict()["coll_counts"] == c.costs.coll_counts


def test_roofline_terms_are_the_jax_terms_at_the_h100(monkeypatch):
    monkeypatch.setattr(jroofline, "PEAK_FLOPS_BF16", mesh.PEAK_FLOPS_BF16)
    monkeypatch.setattr(jroofline, "HBM_BW", mesh.HBM_BW)
    monkeypatch.setattr(jroofline, "ICI_BW", mesh.LINK_BW)
    for flops, hbm, coll in ((3.3e12, 1.1e9, 0.0), (1e9, 9e11, 0.0),
                             (1e9, 1e6, 4.5e10)):
        detail = {"all-reduce": coll, "_counts": {"all-reduce": 1}}
        want = jroofline.RooflineTerms(flops=flops, hbm_bytes=hbm,
                                       coll_bytes=coll, chips=1,
                                       coll_detail=detail).as_dict()
        costs = Costs(bytes=hbm)
        costs.add_flops(flops, "bf16")
        costs.coll["all-reduce"] = coll
        costs.coll_counts["all-reduce"] = 1
        got = roofline.analyze(costs).as_dict()
        assert set(got) == set(want) | {"flops_by_dtype"}
        for key, value in want.items():
            if isinstance(value, float):
                assert got[key] == pytest.approx(value, rel=1e-12), key
            else:
                assert got[key] == value, key
    # other dtypes divide by their own peaks
    costs = Costs()
    costs.add_flops(67e12, "f32")
    costs.add_flops(1979e12, "int8")
    assert roofline.analyze(costs).t_compute == pytest.approx(2.0)


JAX_KEYS = set(jroofline.RooflineTerms(1.0, 1.0, 0.0, 1, {}).as_dict())


@pytest.mark.parametrize("name,shape", [
    ("granite-3-2b", "train_4k"), ("dlrm-mlperf", "serve_p99"),
    ("dimenet", "molecule"), ("tifu-knn", "stream_update")])
def test_run_cell_gives_the_jax_roofline_fields(name, shape):
    r = dryrun.run_cell(name, shape, device="cpu",
                        sizes=smoke_sizes(name, shape))
    assert r["chips"] == 1
    assert r["model_flops_per_device"] == r["model_flops"]
    rt = r["roofline"]
    assert set(rt) == JAX_KEYS | {"flops_by_dtype"}
    assert rt["flops"] > 0 and rt["hbm_bytes"] > 0
    assert rt["coll_bytes"] == 0 and rt["bottleneck"] in ("compute",
                                                          "memory")
    assert r["useful_flops_ratio"] == pytest.approx(
        r["model_flops"] / rt["flops"])
    assert sum(rt["flops_by_dtype"].values()) == rt["flops"]
    if name == "tifu-knn":
        assert rt["flops_by_dtype"] == {"f32": rt["flops"]}
