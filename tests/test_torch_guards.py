"""Guards of the port: what it imports, where it runs, and that a kernel
request never falls back quietly.

The CUDA kernels themselves cannot run here; these tests hold the
contracts around them that a CPU run can see.
"""
import ast
from pathlib import Path

import pytest
import torch

from repro_torch.core.types import AddBatch, StreamState, resolve_device
from repro_torch.kernels import build, knn_topk, ops, serving_topn
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
        # no kernel scores cosine: the kernel path raises rather than
        # serving it through the plain version
        with pytest.raises(ValueError):
            ops.fused_recommend(table, rows, k=2, alpha=0.5, topn=2,
                                metric="cosine")
    assert torch.count_nonzero(table) == 0          # nothing was applied
    assert build.launch_counts == before


def test_plain_versions_on_cpu_count_no_launch():
    table, rows, ids, vals = _cpu_sparse()
    build.reset_launch_counts()
    ops.sparse_row_gather(table, rows, ids)
    ops.sparse_row_scatter(table, rows, ids, vals)
    ops.fused_recommend(torch.rand((6, 16)), rows, k=3, alpha=0.7, topn=4)
    assert set(build.launch_counts) == {"sparse_row_gather",
                                        "sparse_row_scatter", "knn_topk",
                                        "blend_topn_onehot"}
    assert all(v == 0 for v in build.launch_counts.values())


def test_kernel_sources_name_the_tpu_kernel_they_replace():
    for name in build.SOURCES:
        text = (build.CSRC / name).read_text()
        assert "Replaces the TPU kernel repro/kernels/" in text, name
        assert "Bound:" in text, name
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
