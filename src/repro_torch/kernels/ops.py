"""Dispatch surface: the hand-written CUDA kernels or their plain versions.

The rest of the port calls these entry points.  ``impl`` (or the
process-wide :func:`default_impl`) picks the implementation:

* ``auto`` — the CUDA kernel for CUDA tensors, the plain PyTorch version
  for CPU tensors (decided by where the tensor lies, nothing else);
* ``cuda`` — always the kernel; CPU tensors raise;
* ``ref``  — always the plain version, on any device.

This is the one place that maps ``impl`` and the device to an
implementation: the kernel modules hold only their ``launch`` wrappers,
``ref`` only the plain versions.  There is no silent fallback: a kernel
that fails to build or launch, or input it does not take, raises.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch

from repro_torch.kernels import knn_topk as _knn
from repro_torch.kernels import ref
from repro_torch.kernels import serving_topn as _blend
from repro_torch.kernels import sparse_row_gather as _gather
from repro_torch.kernels import sparse_row_scatter as _scatter

IMPLS = ("auto", "cuda", "ref")
_DEFAULT_IMPL = "auto"


@contextlib.contextmanager
def default_impl(impl: str) -> Iterator[None]:
    """Process-wide implementation override (auto | cuda | ref)."""
    global _DEFAULT_IMPL
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    prev = _DEFAULT_IMPL
    _DEFAULT_IMPL = impl
    try:
        yield
    finally:
        _DEFAULT_IMPL = prev


def _use_kernel(impl: Optional[str], x: torch.Tensor) -> bool:
    """True where ``impl`` (or the default) asks for the kernel on ``x``."""
    impl = _DEFAULT_IMPL if impl is None else impl
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    return impl == "cuda" or (impl == "auto" and x.device.type != "cpu")


def sparse_row_gather(table: torch.Tensor, rows: torch.Tensor,
                      ids: torch.Tensor,
                      impl: Optional[str] = None) -> torch.Tensor:
    """Sparse per-row gather ``table[rows, ids]`` → f32[U, W] (PAD → 0).

    O(U·W) elements addressed (the update-path supports, W ≪ I).
    """
    if _use_kernel(impl, table):
        return _gather.launch(table, rows, ids)
    return ref.sparse_row_gather_ref(table, rows, ids)


def sparse_row_scatter(table: torch.Tensor, rows: torch.Tensor,
                       ids: torch.Tensor, vals: torch.Tensor,
                       impl: Optional[str] = None) -> torch.Tensor:
    """Sparse per-row scatter-add into ``table`` IN PLACE; returns it.

    ``table[rows[r], ids[r, w]] += vals[r, w]`` for valid ids; O(U·W)
    elements addressed (the Eq. 7-13 deltas).
    """
    if _use_kernel(impl, table):
        return _scatter.launch(table, rows, ids, vals)
    return ref.sparse_row_scatter_ref(table, rows, ids, vals)


def fused_recommend(corpus: torch.Tensor, user_ids: torch.Tensor, k: int,
                    alpha: float, topn: int, metric: str = "euclidean",
                    impl: Optional[str] = None) -> torch.Tensor:
    """Serving path: corpus rows → top-n item ids, i32[Q, topn].

    ``corpus`` f32[M, I] (the cached serving corpus), ``user_ids``
    int[Q] corpus rows, self-excluded from their own neighbourhood.
    The kernel path is stage A (``knn_topk``: O(Q·M·I) compute, [Q, k]
    out) then stage B (``blend_topn_onehot``: O(Q·k·I) reads, [Q, n]
    out).  The plain path is ``ref.fused_recommend_ref``, the JAX
    reference's unfused pipeline.  ``k`` is clamped to M−1: with
    self-exclusion only M−1 candidates are finite, and a k that admits
    the −inf slot would resolve it differently on the two paths.  The
    kernel scores euclidean and dot only: ``metric="cosine"`` on the
    kernel path raises (``impl="ref"`` serves it on any device).
    """
    kernel = _use_kernel(impl, corpus)
    q_n, m = user_ids.shape[0], corpus.shape[0]
    if topn > corpus.shape[1]:
        raise ValueError(f"topn={topn} > n_items={corpus.shape[1]}")
    if q_n == 0 or m == 0:
        return torch.zeros((q_n, topn), dtype=torch.int32,
                           device=corpus.device)
    k = max(1, min(k, m - 1))
    if not kernel:
        return ref.fused_recommend_ref(corpus, user_ids, k, alpha, topn,
                                       metric)
    queries = corpus[user_ids.long()]
    _, idx = _knn.launch(queries, corpus, k, metric=metric,
                         query_gids=user_ids)
    _, ids = _blend.launch(corpus, user_ids, idx, alpha, topn)
    return ids
