"""Guards of the port: what it imports, where it runs, and that a kernel
request never falls back quietly.

The CUDA kernels themselves cannot run here; these tests hold the
contracts around them that a CPU run can see.
"""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.types import (KIND_ADD_BASKET, AddBatch,
                                    StreamState, TifuParams, resolve_device)
from repro_torch.kernels import (build, decayed_scatter, flash_attention,
                                 knn_topk, ops, serving_topn)
from repro_torch.streaming.engine import Event, StreamingEngine
from repro_torch.streaming.state_store import StateStore, StoreConfig

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_files():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20 and files[-1].exists()
    return files


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "flax", "optax"), \
            f"{path.name} imports {mod}"


def test_store_defaults_to_cuda():
    """An entry point runs on the card unless the caller asks for the
    CPU; without a card it raises rather than carrying on on the CPU."""
    cfg = StoreConfig(n_users=4, n_items=16, max_baskets=3,
                      max_basket_size=2)
    if torch.cuda.is_available():
        assert StateStore(cfg).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StateStore(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamState.zeros(4, 16, 3, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AddBatch.build([1], [[2, 3]], 2)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert StateStore(cfg, device="cpu").state.user_vecs.device.type == "cpu"
    assert StreamState.zeros(4, 16, 3, 2, device="cpu").device.type == "cpu"


def _cpu_sparse():
    table = torch.zeros((4, 16))
    rows = torch.tensor([0, 2], dtype=torch.int32)
    ids = torch.tensor([[1, -1], [3, 3]], dtype=torch.int32)
    return table, rows, ids, torch.ones((2, 2))


def test_cuda_impl_on_cpu_tensors_raises():
    """impl="cuda" launches the kernel or raises: no fallback to the
    plain version for a tensor on the CPU."""
    table, rows, ids, vals = _cpu_sparse()
    before = dict(build.launch_counts)
    with pytest.raises(ValueError, match="CUDA"):
        ops.sparse_row_scatter(table, rows, ids, vals, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        ops.sparse_row_gather(table, rows, ids, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        knn_topk.launch(torch.zeros((2, 16)), table, 2)
    with pytest.raises(ValueError, match="CUDA"):
        serving_topn.launch(table, rows, ids.abs(), 0.5, 2)
    with ops.default_impl("cuda"):
        with pytest.raises(ValueError, match="CUDA"):
            ops.fused_recommend(table, rows, k=2, alpha=0.5, topn=2)
        # no kernel scores cosine: the metric alone routes it to the
        # plain version on the kernel route too, with or without bd, as
        # the JAX dispatchers do
        corpus = torch.rand((6, 16), generator=torch.Generator()
                            .manual_seed(0))
        for bd in (None, 8):
            got = ops.fused_recommend(corpus, rows, k=2, alpha=0.5, topn=3,
                                      metric="cosine", bd=bd)
            assert torch.equal(got, ops.fused_recommend(
                corpus, rows, k=2, alpha=0.5, topn=3, metric="cosine",
                impl="ref"))
        got = ops.shard_topk(corpus[:2], corpus, 3, 1, 2, query_gids=rows,
                             metric="cosine")
        want = ops.shard_topk(corpus[:2], corpus, 3, 1, 2, query_gids=rows,
                              metric="cosine", impl="ref")
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    for call in _new_dispatch_calls():
        with pytest.raises(ValueError, match="CUDA"):
            call("cuda")
    assert torch.count_nonzero(table) == 0          # nothing was applied
    assert build.launch_counts == before


def _int8_inputs():
    cq = torch.arange(6 * 16, dtype=torch.int8).reshape(6, 16)
    cs = torch.ones(6)
    nbr = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    return cq, cs, torch.tensor([0, 5], dtype=torch.int32), nbr


def _scatter_inputs():
    ids = torch.tensor([[[1, -1], [3, 3]], [[-1, -1], [2, 40]]],
                       dtype=torch.int32)
    return ids, torch.rand((2, 2))


def _attention_inputs(dtype=torch.float32):
    q = torch.rand((1, 5, 4, 8), dtype=dtype)
    return q, torch.rand((1, 5, 2, 8), dtype=dtype), \
        torch.rand((1, 5, 2, 8), dtype=dtype)


def _new_dispatch_calls():
    """One call of each dispatcher and wrapper of the int8, D-tiled and
    cross-shard serving paths, the multi-hot scatter and attention, on
    CPU tensors, taking ``impl``."""
    c = torch.rand((6, 16))
    cq, cs, uid, nbr = _int8_inputs()
    q, qs = cq[uid.long()], cs[uid.long()]
    ids, w = _scatter_inputs()
    aq, ak, av = _attention_inputs()
    return [
        lambda impl: ops.multihot_scatter(ids, w, 16, impl=impl),
        lambda impl: ops.multihot_scatter(ids[0], w[0], 16, impl=impl),
        lambda impl: ops.flash_attention(aq, ak, av, impl=impl),
        lambda impl: ops.flash_attention(aq, ak, av, window=2, impl=impl),
        lambda impl: ops.knn_topk_dtiled(c[:2], c, 3, bd=8, impl=impl),
        lambda impl: ops.knn_topk_dtiled(q, cq, 3, bd=8, impl=impl,
                                         q_scale=qs, c_scale=cs),
        lambda impl: ops.fused_recommend(c, uid, 2, 0.5, 3, bd=8,
                                         impl=impl),
        lambda impl: ops.fused_recommend_quant(cq, cs, uid, 2, 0.5, 3, bd=8,
                                               impl=impl),
        lambda impl: ops.shard_topk(c[:2], c, 2, 1, 2, query_gids=uid,
                                    impl=impl),
        lambda impl: ops.shard_topk_quant(q, qs, cq, cs, 2, 1, 2,
                                          query_gids=uid, bd=8, impl=impl),
        lambda impl: ops.blend_topn_rows(c[:2], c[nbr.long()], 0.5, 3,
                                         impl=impl),
        lambda impl: ops.blend_topn_rows_quant(q, qs, cq[nbr.long()],
                                               cs[nbr.long()], 0.5, 3,
                                               impl=impl),
    ]


def test_new_kernel_wrappers_take_only_cuda_tensors():
    c = torch.rand((6, 16))
    cq, cs, uid, nbr = _int8_inputs()
    q, qs = cq[uid.long()], cs[uid.long()]
    before = dict(build.launch_counts)
    for call in (
            lambda: knn_topk.launch_dtiled(c[:2], c, 2),
            lambda: knn_topk.launch_dtiled(q, cq, 2, q_scale=qs, c_scale=cs),
            lambda: knn_topk.launch(c[:2], c, 2, sub_qnorm=True),
            lambda: serving_topn.launch_rows(c[:2], c[nbr.long()], 0.5, 3),
            lambda: serving_topn.launch_rows(q, cq[nbr.long()], 0.5, 3,
                                             q_scale=qs,
                                             n_scale=cs[nbr.long()]),
            lambda: serving_topn.launch_rows_indexed(q, qs, cq, cs, nbr, 0.5,
                                                     3),
            lambda: decayed_scatter.launch(*_scatter_inputs(), 16),
            lambda: flash_attention.launch(*_attention_inputs()),
            lambda: flash_attention.launch(
                *_attention_inputs(torch.bfloat16), window=3)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert build.launch_counts == before


def test_row_addresses_follow_the_row_pitch():
    """The row blend reads the rows of a row-pitched int8 cache (a
    ``[:, :I]`` view of a wider buffer) at that pitch."""
    buf = torch.zeros((9, 32), dtype=torch.int8)
    view = buf[:, :21]
    idx = torch.tensor([[4, 0], [8, 3]])
    got = serving_topn._row_addresses(view, idx)
    want = [[view[i].data_ptr() for i in row] for row in idx.tolist()]
    assert got.tolist() == want


def test_int8_guards_raise():
    """As the JAX kernel's: an int8 corpus needs both scales, its D tile
    stays <= 1024 (exact f32 convert of a tile's int32 partial), and
    k <= 1024 (instacart's k=900 fits)."""
    cq, cs, uid, _ = _int8_inputs()
    q = cq[uid.long()]
    with pytest.raises(ValueError, match="q_scale"):
        knn_topk.launch_dtiled(q, cq, 2)
    with pytest.raises(ValueError, match="q_scale"):
        knn_topk.launch_dtiled(q, cq, 2, q_scale=cs[:2])
    with pytest.raises(ValueError, match="bd"):
        knn_topk.launch_dtiled(q, cq, 2, bd=2048, q_scale=cs[:2],
                               c_scale=cs)
    with pytest.raises(ValueError, match="k="):
        knn_topk.launch_dtiled(q, cq, 1025, q_scale=cs[:2], c_scale=cs)
    with pytest.raises(ValueError, match="k="):
        knn_topk.launch_dtiled(q, cq, 0, q_scale=cs[:2], c_scale=cs)
    with pytest.raises(ValueError, match="int8 rows require"):
        serving_topn._scale_input(None, "q_scale", torch.device("cpu"), (2,))


def test_quantized_serving_is_euclidean_only():
    cfg = StoreConfig(n_users=4, n_items=16, max_baskets=3,
                      max_basket_size=2)
    eng = StreamingEngine(StateStore(cfg, device="cpu"),
                          TifuParams(n_items=16, k_neighbors=2), batch_size=4)
    eng.submit([Event(KIND_ADD_BASKET, u, items=np.array(items))
                for u, items in ((0, [1, 2]), (1, [2, 3]))])
    eng.run_until_drained()
    assert eng.recommend([0, 1], topn=3, quantized=True).shape == (2, 3)
    for metric in ("dot", "cosine"):
        with pytest.raises(ValueError, match="euclidean"):
            eng.recommend([0, 1], topn=3, metric=metric, quantized=True)


def test_plain_versions_on_cpu_count_no_launch():
    table, rows, ids, vals = _cpu_sparse()
    build.reset_launch_counts()
    ops.sparse_row_gather(table, rows, ids)
    ops.sparse_row_scatter(table, rows, ids, vals)
    ops.fused_recommend(torch.rand((6, 16)), rows, k=3, alpha=0.7, topn=4)
    for call in _new_dispatch_calls():
        call(None)
    assert set(build.launch_counts) == {"sparse_row_gather",
                                        "sparse_row_scatter", "knn_topk",
                                        "blend_topn_onehot",
                                        "knn_topk_dtiled",
                                        "knn_topk_dtiled_f32",
                                        "blend_topn_rows_quant",
                                        "blend_topn_rows",
                                        "decayed_scatter",
                                        "flash_attention",
                                        "flash_attention_bwd"}
    assert all(v == 0 for v in build.launch_counts.values())


def test_kernel_sources_name_the_tpu_kernel_they_replace():
    for name in build.SOURCES:
        text = (build.CSRC / name).read_text()
        assert "Replaces the TPU kernel repro/kernels/" in text, name
        assert "Bound:" in text, name
    replaced = {"knn_topk_dtiled.cu": ("knn_topk.py :: knn_topk_dtiled",),
                "serving_rows.cu": (":: blend_topn_rows_quant",
                                    ":: blend_topn_rows (f32)"),
                "decayed_scatter.cu": ("decayed_scatter.py :: "
                                       "decayed_scatter",),
                "flash_attention.cu": ("flash_attention.py :: "
                                       "flash_attention",)}
    for name, functions in replaced.items():
        assert name in build.SOURCES
        text = " ".join((build.CSRC / name).read_text().replace(
            "//", " ").split())
        for fn in functions:
            assert fn in text, (name, fn)
    assert not build.BUILD_DIR.is_relative_to(PORT)
    assert build.BUILD_DIR.parts[-2:] == ("build", "repro_torch_kernels")
    assert "sm_90a" in " ".join(build.NVCC_FLAGS)


def test_kernel_build_names_a_missing_toolkit(monkeypatch, tmp_path):
    """Without nvcc the build raises, naming the toolkit (no quiet
    skip of the kernels)."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build._nvcc()


def test_flash_attention_guards_raise():
    """What the attention kernel does not take raises before any launch:
    other dtypes, mixed dtypes, D > 256, H % KV != 0, K/V of another
    length, a strided head dim."""
    q, k, v = _attention_inputs()
    checks = [
        ((q.half(), k.half(), v.half()), TypeError, "dtype"),
        ((q, k.bfloat16(), v), TypeError, "dtype"),
        ((torch.rand((1, 5, 4, 300)), torch.rand((1, 5, 2, 300)),
          torch.rand((1, 5, 2, 300))), ValueError, "D="),
        ((torch.rand((1, 5, 3, 8)), k, v), ValueError, "multiple"),
        ((q, k[:, :4], v[:, :4]), ValueError, "K/V"),
        ((q, k.transpose(1, 3).contiguous().transpose(1, 3), v), ValueError,
         "contiguous"),
    ]
    for (a, b, c), err, match in checks:
        with pytest.raises(err, match=match):
            flash_attention._check(a, b, c, 0)
    assert flash_attention._check(q, k, v, 0) == (1, 5, 4, 2, 8)
    with pytest.raises(ValueError, match="window"):
        flash_attention._check(q, k, v, -1)


def test_multihot_scatter_guards_raise():
    ids, w = _scatter_inputs()
    with pytest.raises(ValueError, match="do not match"):
        decayed_scatter._check_shapes(ids, w[:, :1], 16)
    with pytest.raises(ValueError, match="n_items"):
        decayed_scatter._check_shapes(ids, w, 0)
    with pytest.raises(ValueError, match=r"\[N, B\]"):
        decayed_scatter._check_shapes(ids[0, 0], w[0], 16)
    assert decayed_scatter._check_shapes(ids, w, 16) == (2, 2, 2)


def test_mlp_defaults_to_cuda():
    """The recommender MLPs are built where every other constructor of
    the port builds: on the card unless the caller names the CPU, and
    never quietly on the CPU when there is no card."""
    from repro_torch.models import common
    gen = torch.Generator().manual_seed(0)
    if torch.cuda.is_available():
        assert common.MLP([3, 2]).w[0].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        common.MLP([3, 2])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        common.init_mlp(gen, [3, 2])
    mlp = common.init_mlp(gen, [3, 2], device="cpu")
    assert mlp.w[0].device.type == "cpu" and mlp.w[0].requires_grad


def test_attention_kernel_refuses_a_call_autograd_would_record():
    """``flash_attention.launch`` has no backward: with grad mode on and
    an input that requires grad it raises before anything else, so no
    caller loses attention's gradient without a word; without grad it
    goes on to its usual checks.  ``ops.flash_attention`` sends such
    inputs through the autograd Function instead, and 9b's wrapper takes
    CUDA tensors only."""
    q, k, v = _attention_inputs()
    q.requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention.launch(q, k, v)
    with torch.no_grad():
        with pytest.raises(ValueError, match="CUDA"):
            flash_attention.launch(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention.launch_bwd(q.detach(), k, v, q.detach())
    before = dict(build.launch_counts)
    out = ops.flash_attention(q, k, v)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    out.sum().backward()
    assert q.grad is not None and build.launch_counts == before


def test_lm_training_defaults_to_cuda():
    """The LM and its training driver run on the card unless the caller
    names the CPU, and never quietly on the CPU when there is no
    card."""
    from repro_torch.configs import granite_3_2b
    from repro_torch.launch import train
    from repro_torch.models import transformer
    if torch.cuda.is_available():
        return
    c = granite_3_2b.smoke_config()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transformer.init_params(c, torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.run(["--arch", "granite-3-2b", "--smoke", "--steps", "1"])
    model = transformer.init_params(c, torch.Generator(), device="cpu")
    assert all(p.requires_grad for p in model.parameters())
