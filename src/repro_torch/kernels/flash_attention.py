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

The gradient (9b, :func:`launch_bwd`, ``csrc/flash_attention_bwd.cu``)
takes every input the forward takes: a launch that recomputes each query
row's log-sum-exp and Δ = Σ P·dP, one that accumulates dK and dV per key
tile, one that accumulates dQ per query tile, on ``mma.sync`` for bf16
with D in {64, 128} and aligned rows, on the CUDA cores for the rest
(:func:`plan_flash_bwd`).
Its plain version is ``ref.flash_attention_bwd_ref``, and
``ops.FlashAttention`` pairs the two directions.  :func:`launch` refuses
to run where autograd would record it (grad mode on and an input that
requires grad): its output has no ``grad_fn``, so attention's gradient
would be lost without a word; only the Function's forward calls it
then.
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


def _cuda_inputs(**tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a CUDA tensor, all on one device."""
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor) or not t.is_cuda:
            raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors, "
                             f"got {getattr(t, 'device', type(t))}")
    if len({t.device for t in tensors.values()}) != 1:
        raise ValueError(f"{', '.join(tensors)} must be on one device")


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool = True, window: int = 0) -> torch.Tensor:
    """Attention of ``q`` [B, S, H, D] over ``k``/``v`` [B, S, KV, D].

    f32 or bf16 (all three alike), 1 <= D <= 256, H % KV == 0, any S,
    any strides with a contiguous last dim; ``window`` 0 means none.
    Returns a contiguous [B, S, H, D] in q's dtype, on the design
    :func:`plan_flash` picks.  Launches a CUDA kernel; raises on tensors
    it does not take (CPU tensors among them), and where autograd would
    record the call (``ops.flash_attention`` sends such inputs through
    ``ops.FlashAttention``, whose backward is :func:`launch_bwd`).
    """
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention.launch has no backward: with grad mode on and "
            "an input that requires grad, call ops.flash_attention (the "
            "autograd Function), or run under torch.no_grad()")
    _cuda_inputs(q=q, k=k, v=v)
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


# ---------------------------------------------------------------------------
# 9b: the gradient (csrc/flash_attention_bwd.cu)
# ---------------------------------------------------------------------------

def _bwd_geometry(d: int) -> Tuple[int, int]:
    """(DC, BT) of the CUDA-core backward for head dim ``d``: D padded
    to 16·DC, tiles of BT rows (32 at D > 128, where four staged f32
    tiles of 64 rows would not fit in shared memory)."""
    dc = next(c for c in (2, 4, 8, 16) if d <= 16 * c)
    return dc, (32 if dc == 16 else 64)


def bwd_smem_bytes(d: int) -> Tuple[int, int, int]:
    """Shared bytes of the CUDA-core stats, dK/dV and dQ kernels at head
    dim ``d``: four staged f32 tiles of BT rows at a pitch of 16·DC + 1
    floats; the dQ kernel adds a [BT, BT + 1] dS tile, the dK/dV kernel a
    P and a dS tile and BT log-sum-exps and Δs.  The C entry refuses
    other bytes."""
    dc, bt = _bwd_geometry(d)
    tile = bt * (16 * dc + 1)
    score = bt * (bt + 1)
    return (4 * 4 * tile, 4 * (4 * tile + 2 * score + 2 * bt),
            4 * (4 * tile + score))


def mma_bwd_smem_bytes(d: int) -> Tuple[int, int, int]:
    """Shared bytes of the ``mma_sync`` stats, dK/dV and dQ kernels (D 64
    or 128): four bf16 tiles of 64 rows at a pitch of D + 8; the dK/dV
    kernel adds 64 log-sum-exps and Δs."""
    tiles = 4 * 64 * (d + 8) * 2
    return tiles, tiles + 2 * 64 * 4, tiles


_BWD_DESIGN_CODES = {"cuda_cores": 0, "mma_sync": 1}


@dataclasses.dataclass(frozen=True)
class FlashBwdPlan:
    """One :func:`launch_bwd` call's design and tiles: ``bt`` rows a tile
    (queries and keys alike), the three kernels' shared bytes (stats,
    dK/dV, dQ)."""
    design: str
    bt: int
    smem_bytes: Tuple[int, int, int]
    s: int
    causal: bool
    window: int

    @property
    def n_tiles(self) -> int:
        return -(-self.s // self.bt)

    def key_tiles(self, q0: int) -> range:
        """The key tiles that the stats and dQ kernels walk for the query
        tile from row ``q0``: from the first its window reaches to the
        last its causal mask reaches."""
        last = min(q0 + self.bt, self.s) - 1
        hi = last // self.bt if self.causal else self.n_tiles - 1
        lo = 0
        if self.window > 0 and q0 - self.window + 1 > 0:
            lo = (q0 - self.window + 1) // self.bt
        return range(lo, hi + 1)

    def query_tiles(self, k0: int) -> range:
        """The query tiles that the dK/dV kernel walks (for each query
        head of the group) for the key tile from row ``k0``: from the one
        holding ``k0`` under the causal mask to the last the window lets
        see its last key."""
        lo = k0 // self.bt if self.causal else 0
        hi = self.n_tiles - 1
        if self.window > 0:
            last = min(k0 + self.bt, self.s) - 1
            hi = min(hi, (last + self.window - 1) // self.bt)
        return range(lo, hi + 1)


def plan_flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   dout: torch.Tensor, window: int = 0,
                   causal: bool = True) -> FlashBwdPlan:
    """The backward's design and tiles, from the input alone (any
    device): ``mma_sync`` for bf16 with D in {64, 128} and 16-byte
    aligned rows (q, k, v and dout), else ``cuda_cores``."""
    d, s = q.shape[3], q.shape[1]
    if q.dtype == torch.bfloat16 and d in (64, 128) and \
            _aligned(q, k, v) and _aligned(dout, dout, dout):
        return FlashBwdPlan("mma_sync", 64, mma_bwd_smem_bytes(d), s,
                            causal, window)
    return FlashBwdPlan("cuda_cores", _bwd_geometry(d)[1],
                        bwd_smem_bytes(d), s, causal, window)


def launch_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               dout: torch.Tensor, causal: bool = True, window: int = 0
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of :func:`launch` at ``q``, ``k``, ``v`` given the
    output's gradient ``dout`` [B, S, H, D]: (dq [B, S, H, D], dk, dv
    [B, S, KV, D]), contiguous, in the inputs' dtype.  Takes every input
    :func:`launch` takes (``dout`` alike: any strides with a contiguous
    last dim), on the design :func:`plan_flash_bwd` picks.  Three kernel
    launches (stats, dK/dV, dQ) and two f32 scratch vectors of B·H·S;
    raises on tensors it does not take."""
    _cuda_inputs(q=q, k=k, v=v, dout=dout)
    b, s, h, kv, d = _check(q, k, v, window)
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError(f"dout: {tuple(dout.shape)} {dout.dtype}, expected "
                         f"{tuple(q.shape)} {q.dtype}")
    if d > 1 and dout.stride(3) != 1:
        raise ValueError("dout: the head dim must be contiguous")
    plan = plan_flash_bwd(q, k, v, dout, window, causal)
    if plan.n_tiles > 65535:
        raise ValueError(f"grid too large for S={s}")
    dq = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, s, kv, d), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    stats = torch.empty((2, b * h * s), dtype=torch.float32,
                        device=q.device)
    lib = build.library()
    code = lib.flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats[0].data_ptr(),
        stats[1].data_ptr(), b, s, h, kv, d,
        *[x for t in (q, k, v, dout) for x in t.stride()[:3]],
        1.0 / d ** 0.5, int(bool(causal)), int(window),
        int(q.dtype == torch.bfloat16), _BWD_DESIGN_CODES[plan.design],
        *plan.smem_bytes, build.stream_of(dq))
    build.check(code, f"flash_attention_bwd ({plan.design})")
    build.count_launch("flash_attention_bwd")
    return dq, dk, dv
