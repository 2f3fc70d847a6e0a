"""Blocked online-softmax attention (CUDA kernels + wrapper).

    out = softmax(mask(q·kᵀ/√D)) · v          [B, S, H, D], causal (+ window)

Replaces ``repro/kernels/flash_attention.py::flash_attention``, the
prefill attention of the dense LM stack.  Every design takes one query
tile at a time through the key tiles with f32 running max, denominator
and accumulator (the [S, S] scores are never written), rounds ``p`` to
the V dtype before P·V as the TPU kernel does, and skips the key tiles
that the causal mask or the window hide from the whole query tile.  The input
picks the design (:func:`plan_flash`), and the C entry refuses an input
its design does not take:

* ``tma_wgmma`` (``csrc/flash_attention_wgmma.cu``): bf16 with D in
  {64, 128}, 16-byte aligned bases and strides that are positive
  multiples of 8 elements -- 192-query work items at D = 64 (128 at
  D = 128) on a persistent grid, K/V fed by TMA through a ring of
  128-key stages, both products on ``wgmma``;
* ``mma_sync`` (``csrc/flash_attention.cu``): bf16 with D = 32 and
  16-byte aligned rows -- 64-query tiles on ``mma.sync``;
* ``cuda_cores`` (``csrc/flash_attention.cu``): everything else (f32,
  other D, unaligned rows).

K/V may carry fewer heads than Q (H % KV == 0), so grouped-query
attention reads each KV head in place.  The plain version is
``ref.flash_attention_ref``; ``ops.flash_attention`` picks between the
two.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.kernels import build

DTYPES = (torch.float32, torch.bfloat16)
MAX_D = 256
SMEM_MAX = 232448   # shared memory one block may use on an H100
# the Hopper design (csrc/flash_attention_wgmma.cu): query rows a work
# item by D (64 per consumer warpgroup: three at D = 64, two at 128),
# 128-key tiles, a ring of 2 stages; one kernel is built for each D
WGMMA_BQ = {64: 192, 128: 128}
WGMMA_BK, WGMMA_STAGES = 128, 2
_DESIGN_CODES = {"cuda_cores": 0, "mma_sync": 1}


def wgmma_smem_bytes(d: int, stages: int) -> int:
    """Shared memory of one ``tma_wgmma`` block: a 1024-byte alignment
    slack, two Q tiles of ``WGMMA_BQ[d]`` rows (a work item's and the
    next one's) and ``stages`` K and V tiles of 128 rows, each row ``d``
    bf16, and 8 bytes per mbarrier (two per Q tile, four per stage).  The
    C entry refuses a launch whose bytes differ."""
    return (1024 + (2 * WGMMA_BQ[d] + 2 * stages * WGMMA_BK) * d * 2
            + 8 * (4 + 4 * stages))


def _cuda_core_smem_bytes(d: int) -> int:
    dp = 16 * next(c for c in (2, 4, 8, 16) if d <= 16 * c)
    return 4 * (64 * (dp + 1) * 2 + 64 * dp + 64 * 65)


@dataclasses.dataclass(frozen=True)
class FlashPlan:
    """One :func:`launch` call's design and tiles: ``bq`` query rows a
    work item (one item per (batch·head, query tile): a block each, or,
    for ``tma_wgmma``, a persistent grid walking them), ``bk`` keys a
    tile, a ring of ``stages`` K/V tiles (1: loaded between barriers),
    ``smem_bytes`` of shared memory a block."""
    design: str
    bq: int
    bk: int
    stages: int
    smem_bytes: int
    s: int
    causal: bool
    window: int

    def tiles(self) -> list:
        """The first query row of each work item (rows q0 .. q0 + bq - 1,
        those in [0, S) computed), in the order the grid takes them: the
        longest causal rows first.  ``tma_wgmma`` ends its tiles at S (the
        last, shortest one may start below 0); the others start theirs at
        multiples of ``bq``."""
        n = -(-self.s // self.bq)
        if self.design == "tma_wgmma":
            return [self.s - (t + 1) * self.bq for t in range(n)]
        return [(n - 1 - t) * self.bq for t in range(n)]

    def key_tiles(self, q0: int) -> range:
        """The key tiles the work item from row ``q0`` walks, as the
        kernel computes them: from the first its window reaches to the
        last its causal mask reaches."""
        first, last = max(q0, 0), min(q0 + self.bq, self.s) - 1
        hi = last // self.bk if self.causal else -(-self.s // self.bk) - 1
        lo = 0
        if self.window > 0 and first - self.window + 1 > 0:
            lo = (first - self.window + 1) // self.bk
        return range(lo, hi + 1)


def _aligned(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """16-byte aligned bases, and (batch, seq, head) strides that are
    positive multiples of 8 elements: 16-byte rows for vector loads and
    TMA."""
    return all(t.data_ptr() % 16 == 0 and all(
        x > 0 and x % 8 == 0 for x in t.stride()[:3]) for t in (q, k, v))


def plan_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               window: int = 0, causal: bool = True) -> FlashPlan:
    """The design and tiles the input alone picks (any device).

    ``tma_wgmma`` for bf16 with D in {64, 128} and aligned rows,
    ``mma_sync`` for bf16 with D = 32 and aligned rows, else
    ``cuda_cores``.
    """
    d, s = q.shape[3], q.shape[1]
    bf16 = q.dtype == torch.bfloat16
    aligned = _aligned(q, k, v)
    if bf16 and d in (64, 128) and aligned:
        return FlashPlan("tma_wgmma", WGMMA_BQ[d], WGMMA_BK, WGMMA_STAGES,
                         wgmma_smem_bytes(d, WGMMA_STAGES), s, causal,
                         window)
    if bf16 and d == 32 and aligned:
        return FlashPlan("mma_sync", 64, 64, 1, 3 * 64 * (d + 8) * 2, s,
                         causal, window)
    return FlashPlan("cuda_cores", 64, 64, 1, _cuda_core_smem_bytes(d), s,
                     causal, window)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int) -> Tuple[int, int, int, int, int]:
    """Raise on what the kernel does not take; returns (B, S, H, KV, D)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in DTYPES:
            raise TypeError(f"{name}: dtype {t.dtype} not in {list(DTYPES)}")
        if t.dim() != 4:
            raise ValueError(f"{name}: expected [B, S, heads, D], got "
                             f"{tuple(t.shape)}")
        if t.shape[3] > 1 and t.stride(3) != 1:
            raise ValueError(f"{name}: the head dim must be contiguous")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    b, s, h, d = q.shape
    kv = k.shape[2]
    if k.shape != v.shape or k.shape[0] != b or k.shape[1] != s or \
            k.shape[3] != d:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: K/V must be [B, S, KV, D]")
    if kv < 1 or h % kv != 0:
        raise ValueError(f"H={h} is not a multiple of KV={kv}")
    if not 1 <= d <= MAX_D:
        raise ValueError(f"head dim D={d} outside [1, {MAX_D}]")
    if window < 0:
        raise ValueError(f"window={window} < 0")
    if b * h >= 2 ** 31 or (s + 63) // 64 > 65535:
        raise ValueError(f"grid too large for B*H={b * h}, S={s}")
    return b, s, h, kv, d


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool = True, window: int = 0) -> torch.Tensor:
    """Attention of ``q`` [B, S, H, D] over ``k``/``v`` [B, S, KV, D].

    f32 or bf16 (all three alike), 1 <= D <= 256, H % KV == 0, any S,
    any strides with a contiguous last dim; ``window`` 0 means none.
    Returns a contiguous [B, S, H, D] in q's dtype, on the design
    :func:`plan_flash` picks.  Launches a CUDA kernel; raises on tensors
    it does not take (CPU tensors among them).
    """
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or not t.is_cuda:
            raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors, "
                             f"got {getattr(t, 'device', type(t))}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    b, s, h, kv, d = _check(q, k, v, window)
    plan = plan_flash(q, k, v, window, causal)
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s,
            h, kv, d, *[x for t in (q, k, v) for x in t.stride()[:3]],
            1.0 / d ** 0.5, int(bool(causal)), int(window))
    lib = build.library()
    if plan.design == "tma_wgmma":
        code = lib.flash_wgmma_launch(*args, plan.stages, plan.smem_bytes,
                                      build.stream_of(out))
    else:
        code = lib.flash_attention_launch(
            *args, int(q.dtype == torch.bfloat16),
            _DESIGN_CODES[plan.design], build.stream_of(out))
    build.check(code, f"flash_attention ({plan.design})")
    build.count_launch("flash_attention")
    return out
