"""Blocked online-softmax attention (CUDA kernels + wrapper).

    out = softmax(mask(q·kᵀ/√D)) · v          [B, S, H, Dv], causal (+ window)

Replaces ``repro/kernels/flash_attention.py::flash_attention``, the
prefill attention of the LM stack.  Q and K are D wide, V is Dv <= D
wide (MLA's 128 beside Q/K's 192; the scale stays Q's 1/√D).  Every
design takes one query
tile at a time through the key tiles with f32 running max, denominator
and accumulator (the [S, S] scores are never written), rounds ``p`` to
the V dtype before P·V as the TPU kernel does, and skips the key tiles
that the causal mask or the window hide from the whole query tile.  The input
picks the design (:func:`plan_flash`), and the C entry refuses an input
its design does not take:

* ``tma_wgmma`` (``csrc/flash_attention_wgmma.cu``): bf16 with (D, Dv)
  in :data:`WGMMA_DV` ((64, 64), (128, 128), (192, 128)), 16-byte
  aligned bases and strides that are positive multiples of 8 elements
  -- 192-query work items at D = 64 (128 at D = 128 and 192) on a
  persistent grid, K/V fed by TMA through a ring of 128-key stages,
  both products on ``wgmma``, V in tiles of its own width;
* ``mma_sync`` (``csrc/flash_attention.cu``): bf16 with D = Dv = 32 and
  16-byte aligned rows -- 64-query tiles on ``mma.sync``;
* ``cuda_cores`` (``csrc/flash_attention.cu``): everything else with V
  as wide as Q (f32, other D, unaligned rows, D 192 with Dv 192).

``mma_sync`` and ``cuda_cores`` take Dv == D only: :func:`launch` raises
on a narrower V that its planned design does not take, and
``models.transformer.attend_padded_v`` pads V to Q's width for them.

K/V may carry fewer heads than Q (H % KV == 0), so grouped-query
attention reads each KV head in place.  The plain version is
``ref.flash_attention_ref``; ``ops.flash_attention`` picks between the
two.

The gradient (9b, :func:`launch_bwd`) takes every input the forward
takes, in three launches and no atomics (:func:`plan_flash_bwd`):

* ``tma_wgmma`` (``csrc/flash_attention_bwd_wgmma.cu``), where the
  forward ran ``tma_wgmma`` and saved each row's log-sum-exp
  (:func:`launch_with_lse`): each row's Δ = Σ P·dP per 128-query tile,
  then dK/dV per 128-key tile and dQ per 128-query tile, each on a
  persistent grid streaming 64-row tiles through a TMA-fed ring into
  ``wgmma`` products;
* ``cuda_cores`` (``csrc/flash_attention_bwd.cu``) for the rest (V as
  wide as Q): a launch that recomputes each row's log-sum-exp and
  Δ = Σ P·dP, then dK/dV and dQ per 64-row tile (32 past D = 128).

Their plain versions are ``ref.flash_attention_bwd_lse_ref`` and
``ref.flash_attention_bwd_ref``, and ``ops.FlashAttention`` pairs the two
directions.  :func:`launch` refuses
to run where autograd would record it (grad mode on and an input that
requires grad): its output has no ``grad_fn``, so attention's gradient
would be lost without a word; only the Function's forward calls it
then.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.analysis.contracts import Accumulators, KernelContract, \
    register
from repro_torch.kernels import build
from repro_torch.launch.mesh import SMEM_PER_BLOCK_OPTIN

DTYPES = (torch.float32, torch.bfloat16)
MAX_D = 256
SMEM_MAX = SMEM_PER_BLOCK_OPTIN   # shared memory one block may use
# the Hopper design (csrc/flash_attention_wgmma.cu), one kernel built for
# each Q/K width D: the V width Dv it takes, query rows a work item (64
# per consumer warpgroup: three at D = 64, two at 128 and 192), Q buffers
# (the item's and the next one's, but one at D = 192, where a second does
# not fit beside the ring), 128-key tiles, a ring of 2 stages
WGMMA_DV = {64: 64, 128: 128, 192: 128}
WGMMA_BQ = {64: 192, 128: 128, 192: 128}
WGMMA_Q_BUFS = {64: 2, 128: 2, 192: 1}
WGMMA_BK, WGMMA_STAGES = 128, 2
_DESIGN_CODES = {"cuda_cores": 0, "mma_sync": 1}
# 9b's Hopper design (csrc/flash_attention_bwd_wgmma.cu), for the (D, Dv)
# of WGMMA_DV: work items of 128 rows (64 per consumer warpgroup, two),
# streamed tiles of 64, rings of 2 stages; the log-sum-exp rows at a
# pitch of S rounded up to 64
WGMMA_BWD_ITEM, WGMMA_BWD_STEP, WGMMA_BWD_STAGES = 128, 64, 2
# the CUDA kernels each 9b design launches, in order
BWD_KERNELS = {"tma_wgmma": ("bwd_wgmma_stats_kernel",
                             "bwd_wgmma_dkdv_kernel", "bwd_wgmma_dq_kernel"),
               "cuda_cores": ("bwd_stats_kernel", "bwd_dkdv_kernel",
                              "bwd_dq_kernel")}
# launches of each of those kernels since the last reset_bwd_launches()
bwd_launches: Dict[str, int] = {n: 0 for ks in BWD_KERNELS.values()
                                for n in ks}


def reset_bwd_launches() -> None:
    """Set every 9b kernel's launch count to 0."""
    for name in bwd_launches:
        bwd_launches[name] = 0


def lse_pitch(s: int) -> int:
    """Row pitch of the saved log-sum-exp and of Δ: S rounded up to the
    64-row tiles that the backward copies whole."""
    return -(-s // WGMMA_BWD_STEP) * WGMMA_BWD_STEP


def wgmma_smem_bytes(d: int, stages: int, dv: Optional[int] = None) -> int:
    """Shared memory of one ``tma_wgmma`` block at Q/K width ``d`` and V
    width ``dv`` (default ``d``): a 1024-byte alignment slack,
    ``WGMMA_Q_BUFS[d]`` Q tiles of ``WGMMA_BQ[d]`` rows x ``d``,
    ``stages`` K tiles of 128 rows x ``d`` and V tiles of 128 rows x
    ``dv``, all bf16, and 8 bytes per mbarrier (two per Q tile, four per
    stage).  The C entry refuses a launch whose bytes differ."""
    dv = d if dv is None else dv
    nq = WGMMA_Q_BUFS[d]
    return (1024 + nq * WGMMA_BQ[d] * d * 2
            + stages * WGMMA_BK * (d + dv) * 2 + 8 * (2 * nq + 4 * stages))


def _mma_smem_bytes(d: int) -> int:
    """Shared memory of one ``mma_sync`` block: 64-row Q, K and V tiles
    of bf16 at a pitch of D + 8."""
    return 3 * 64 * (d + 8) * 2


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


def _narrower_v(d: int, dv: int) -> None:
    if dv > d:
        raise ValueError(f"V width {dv} exceeds the query width {d}")


def aligned_rows(t: torch.Tensor) -> bool:
    """A 16-byte aligned base, and (batch, seq, head) strides that are
    positive multiples of 8 elements: 16-byte rows for vector loads and
    TMA."""
    return t.data_ptr() % 16 == 0 and all(
        x > 0 and x % 8 == 0 for x in t.stride()[:3])


def _aligned(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    return all(aligned_rows(t) for t in (q, k, v))


def plan_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               window: int = 0, causal: bool = True) -> FlashPlan:
    """The design and tiles the input alone picks (any device).

    ``tma_wgmma`` for bf16 with (D, Dv) in :data:`WGMMA_DV` and aligned
    rows, ``mma_sync`` for bf16 with D = Dv = 32 and aligned rows, else
    ``cuda_cores`` (which, like ``mma_sync``, takes Dv == D only:
    :func:`takes_v_width`).
    """
    d, dv, s = q.shape[3], v.shape[3], q.shape[1]
    _narrower_v(d, dv)
    bf16 = q.dtype == torch.bfloat16
    aligned = _aligned(q, k, v)
    if bf16 and WGMMA_DV.get(d) == dv and aligned:
        return FlashPlan("tma_wgmma", WGMMA_BQ[d], WGMMA_BK, WGMMA_STAGES,
                         wgmma_smem_bytes(d, WGMMA_STAGES, dv), s, causal,
                         window)
    if bf16 and d == dv == 32 and aligned:
        return FlashPlan("mma_sync", 64, 64, 1, _mma_smem_bytes(d), s,
                         causal, window)
    return FlashPlan("cuda_cores", 64, 64, 1, _cuda_core_smem_bytes(d), s,
                     causal, window)


def takes_v_width(design: str, d: int, dv: int) -> bool:
    """Whether ``design`` takes V of width ``dv`` beside Q/K of width
    ``d``: ``tma_wgmma`` the pairs of :data:`WGMMA_DV`, the others V as
    wide as Q only."""
    return dv == d or (design == "tma_wgmma" and WGMMA_DV.get(d) == dv)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int) -> Tuple[int, int, int, int, int]:
    """Raise on what the kernels do not take (V may be narrower than Q);
    returns (B, S, H, KV, D)."""
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
    kv, dv = k.shape[2], v.shape[3]
    _narrower_v(d, dv)
    if k.shape != (b, s, kv, d) or v.shape[:3] != k.shape[:3] or dv < 1:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: K/V must be [B, S, KV, D] "
                         f"and [B, S, KV, Dv] with Dv <= D")
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


def _refuse_grad(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention.launch has no backward: with grad mode on and "
            "an input that requires grad, call ops.flash_attention (the "
            "autograd Function), or run under torch.no_grad()")


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             causal: bool, window: int, with_lse: bool
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    _refuse_grad(q, k, v)
    _cuda_inputs(q=q, k=k, v=v)
    b, s, h, kv, d = _check(q, k, v, window)
    dv = v.shape[3]
    plan = plan_flash(q, k, v, window, causal)
    if not takes_v_width(plan.design, d, dv):
        raise ValueError(f"V width {dv} != Q width {d}: the {plan.design} "
                         "design takes V as wide as Q "
                         "(models.transformer.attend_padded_v pads it)")
    out = torch.empty((b, s, h, dv), dtype=q.dtype, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s,
            h, kv, d, dv, *[x for t in (q, k, v) for x in t.stride()[:3]],
            1.0 / d ** 0.5, int(bool(causal)), int(window))
    lib = build.library()
    lse = None
    if plan.design == "tma_wgmma":
        if with_lse:
            lse = torch.empty((b * h, lse_pitch(s)), dtype=torch.float32,
                              device=q.device)
        code = lib.flash_wgmma_launch(
            *args, None if lse is None else lse.data_ptr(),
            0 if lse is None else lse.stride(0), plan.stages,
            plan.smem_bytes, build.stream_of(out))
    else:
        code = lib.flash_attention_launch(
            *args, int(q.dtype == torch.bfloat16),
            _DESIGN_CODES[plan.design], build.stream_of(out))
    build.check(code, f"flash_attention ({plan.design})")
    build.count_launch("flash_attention")
    return out, None if lse is None else lse[:, :s]


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool = True, window: int = 0) -> torch.Tensor:
    """Attention of ``q`` [B, S, H, D] over ``k`` [B, S, KV, D] and ``v``
    [B, S, KV, Dv].

    f32 or bf16 (all three alike), 1 <= D <= 256, Dv <= D as the planned
    design takes it (:func:`takes_v_width`), H % KV == 0, any S, any
    strides with a contiguous last dim; ``window`` 0 means none.  Returns
    a contiguous [B, S, H, Dv] in q's dtype, on the design
    :func:`plan_flash` picks.  Launches a CUDA kernel; raises on tensors
    it does not take (CPU tensors among them), and where autograd would
    record the call (``ops.flash_attention`` sends such inputs through
    ``ops.FlashAttention``, whose backward is :func:`launch_bwd`).
    """
    return _forward(q, k, v, causal, window, False)[0]


def launch_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """:func:`launch` for training: (out, lse).  On the ``tma_wgmma``
    design the kernel also writes each query row's log-sum-exp, lse f32
    [B·H, S] (row b·H + h; a view of a [B·H, :func:`lse_pitch`] buffer),
    which the backward's ``tma_wgmma`` design reads; out is the same
    as without it.  The other designs give None (their backward
    recomputes it).  Raises as :func:`launch`."""
    return _forward(q, k, v, causal, window, True)


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


def wgmma_bwd_smem_bytes(d: int, dv: Optional[int] = None
                         ) -> Tuple[int, int, int]:
    """Shared bytes of the ``tma_wgmma`` statistics, dK/dV and dQ kernels
    at Q/K width ``d`` and V width ``dv`` (default ``d``; the pairs of
    :data:`WGMMA_DV`), each from a 1024-byte alignment slack, rows of Q
    and K ``d`` bf16 wide and of V and dO ``dv``: the statistics and dQ
    kernels (one query pass) ``WGMMA_Q_BUFS[d]`` 128-row Q and dO tiles
    (an item's and, with two, the next one's), ``WGMMA_BWD_STAGES``
    stages of 64-row K and V tiles, and 8 bytes per mbarrier (two per
    Q/dO buffer, four per stage); dK/dV the K and V tiles of its 128
    keys, the stages of a 64-row Q and dO tile with their 64 log-sum-exps
    and Δs, and its mbarriers (two for K/V, two per stage).  The C entry
    refuses other bytes."""
    dv = d if dv is None else dv
    item, step = WGMMA_BWD_ITEM * 2, WGMMA_BWD_STEP * 2   # bytes a column
    n, nq = WGMMA_BWD_STAGES, WGMMA_Q_BUFS[d]
    dkdv = 1024 + item * (d + dv) \
        + n * (step * (d + dv) + 2 * WGMMA_BWD_STEP * 4) + 8 * (2 + 2 * n)
    dq = 1024 + nq * item * (d + dv) + n * step * (d + dv) \
        + 8 * (2 * nq + 4 * n)
    return dq, dkdv, dq


@dataclasses.dataclass(frozen=True)
class FlashBwdPlan:
    """One :func:`launch_bwd` call's design and tiles: work items of
    ``item`` rows (the dK/dV kernel's keys, the statistics and dQ
    kernels' queries) that walk tiles of ``step`` rows of the other side
    (``cuda_cores``: one size, ``item == step``), the three kernels'
    shared bytes (statistics, dK/dV, dQ)."""
    design: str
    item: int
    step: int
    smem_bytes: Tuple[int, int, int]
    s: int
    causal: bool
    window: int

    @property
    def n_items(self) -> int:
        return -(-self.s // self.item)

    @property
    def n_steps(self) -> int:
        return -(-self.s // self.step)

    def key_tiles(self, q0: int) -> range:
        """The ``step``-row key tiles that the statistics and dQ kernels
        walk for the query item from row ``q0``: from the first its window
        reaches to the last its causal mask reaches."""
        last = min(q0 + self.item, self.s) - 1
        hi = last // self.step if self.causal else self.n_steps - 1
        lo = 0
        if self.window > 0 and q0 - self.window + 1 > 0:
            lo = (q0 - self.window + 1) // self.step
        return range(lo, hi + 1)

    def query_tiles(self, k0: int) -> range:
        """The ``step``-row query tiles that the dK/dV kernel walks (for
        each query head of the group) for the key item from row ``k0``:
        from the one holding ``k0`` under the causal mask to the last the
        window lets see its last key."""
        lo = k0 // self.step if self.causal else 0
        hi = self.n_steps - 1
        if self.window > 0:
            last = min(k0 + self.item, self.s) - 1
            hi = min(hi, (last + self.window - 1) // self.step)
        return range(lo, hi + 1)


def plan_flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   dout: torch.Tensor, window: int = 0, causal: bool = True,
                   lse: Optional[torch.Tensor] = None) -> FlashBwdPlan:
    """The backward's design and tiles, from the input alone (any
    device): ``tma_wgmma`` for bf16 with (D, Dv) in :data:`WGMMA_DV`,
    16-byte aligned rows (q, k, v and dout) and the forward's ``lse``
    given (:func:`launch_with_lse`), else ``cuda_cores`` (V as wide as Q
    only)."""
    d, dv, s = q.shape[3], v.shape[3], q.shape[1]
    _narrower_v(d, dv)
    if lse is not None and q.dtype == torch.bfloat16 and \
            WGMMA_DV.get(d) == dv and _aligned(q, k, v) and \
            _aligned(dout, dout, dout):
        return FlashBwdPlan("tma_wgmma", WGMMA_BWD_ITEM, WGMMA_BWD_STEP,
                            wgmma_bwd_smem_bytes(d, dv), s, causal, window)
    bt = _bwd_geometry(d)[1]
    return FlashBwdPlan("cuda_cores", bt, bt, bwd_smem_bytes(d), s, causal,
                        window)


def _check_saved(q: torch.Tensor, lse: Optional[torch.Tensor]) -> None:
    """Raise unless ``lse`` is None or what :func:`launch_with_lse` gives
    for ``q``."""
    if lse is None:
        return
    b, s, h, _ = q.shape
    if lse.dtype != torch.float32 or lse.shape != (b * h, s) or \
            lse.stride() != (lse_pitch(s), 1) or lse.data_ptr() % 16:
        raise ValueError(f"lse: {tuple(lse.shape)} {lse.dtype} strides "
                         f"{lse.stride()}, expected launch_with_lse's "
                         f"[{b * h}, {s}] f32 at a pitch of {lse_pitch(s)}")
    _cuda_inputs(q=q, lse=lse)


def launch_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               dout: torch.Tensor, causal: bool = True, window: int = 0,
               lse: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of :func:`launch` at ``q``, ``k``, ``v`` given the
    output's gradient ``dout`` [B, S, H, Dv]: (dq [B, S, H, D], dk [B, S,
    KV, D], dv [B, S, KV, Dv]), contiguous, in the inputs' dtype.  Takes
    every input
    :func:`launch` takes (``dout`` alike: any strides with a contiguous
    last dim), and the forward's ``lse`` from :func:`launch_with_lse`
    where it gave one, on the design :func:`plan_flash_bwd` picks.  Three
    kernel launches and f32 scratch of the rows' statistics (B·H·pitch
    each on ``tma_wgmma``, B·H·S each on ``cuda_cores``); raises on
    tensors it does not take."""
    _cuda_inputs(q=q, k=k, v=v, dout=dout)
    b, s, h, kv, d = _check(q, k, v, window)
    dvw = v.shape[3]
    if dout.shape != (b, s, h, dvw) or dout.dtype != q.dtype:
        raise ValueError(f"dout: {tuple(dout.shape)} {dout.dtype}, expected "
                         f"{(b, s, h, dvw)} {q.dtype}")
    if dvw > 1 and dout.stride(3) != 1:
        raise ValueError("dout: the head dim must be contiguous")
    _check_saved(q, lse)
    plan = plan_flash_bwd(q, k, v, dout, window, causal, lse)
    if not takes_v_width(plan.design, d, dvw):
        raise ValueError(f"V width {dvw} != Q width {d}: the {plan.design} "
                         "backward takes V as wide as Q")
    if plan.n_items > 65535:
        raise ValueError(f"grid too large for S={s}")
    dq = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, s, kv, d), dtype=q.dtype, device=q.device)
    dv = torch.empty((b, s, kv, dvw), dtype=q.dtype, device=q.device)
    lib = build.library()
    strides = [x for t in (q, k, v, dout) for x in t.stride()[:3]]
    if plan.design == "tma_wgmma":
        stats = torch.empty((b * h, 2, lse.stride(0)), dtype=torch.float32,
                            device=q.device)
        code = lib.flash_bwd_wgmma_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), stats.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, s, h, kv, d, dvw, *strides, lse.stride(0),
            1.0 / d ** 0.5, int(bool(causal)), int(window),
            *plan.smem_bytes, build.stream_of(dq))
    else:
        stats = torch.empty((2, b * h * s), dtype=torch.float32,
                            device=q.device)
        code = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats[0].data_ptr(),
            stats[1].data_ptr(), b, s, h, kv, d, dvw, *strides,
            1.0 / d ** 0.5, int(bool(causal)), int(window),
            int(q.dtype == torch.bfloat16), *plan.smem_bytes,
            build.stream_of(dq))
    build.check(code, f"flash_attention_bwd ({plan.design})")
    build.count_launch("flash_attention_bwd")
    for name in BWD_KERNELS[plan.design]:
        bwd_launches[name] += 1
    return dq, dk, dv


def _wgmma_smem(d: int, dv: int) -> dict:
    return {"flash_wgmma_kernel": wgmma_smem_bytes(d, WGMMA_STAGES, dv)}


def _cuda_core_smem(d: int) -> dict:
    return {"flash_kernel": _cuda_core_smem_bytes(d),
            "flash_mma_kernel": _mma_smem_bytes(32)}


def _wgmma_bwd_smem(d: int, dv: int) -> dict:
    return dict(zip(BWD_KERNELS["tma_wgmma"], wgmma_bwd_smem_bytes(d, dv)))


def _cuda_core_bwd_smem(d: int) -> dict:
    return dict(zip(BWD_KERNELS["cuda_cores"], bwd_smem_bytes(d)))


# The C entries' contracts (static analysis: repro_torch.analysis).  The
# oracle is allclose, so none is exact-parity (the softmax may take
# ex2.approx); every product accumulates in f32, and the running max,
# denominator and output in float.  The Hopper designs at MLA's (192,
# 128), the largest shared memory of WGMMA_DV; the CUDA-core ones at
# MAX_D.  Persistent grids stop at n_items; per-tile grids skip the
# rows past S.  One Hopper instance per (D, Dv) of WGMMA_DV; the CUDA
# cores' per dtype (f32, bf16) and D padded to 32, 64, 128 and 256.
_F32 = (("m_i", "float"), ("l_i", "float"))
register(KernelContract(
    module=__name__, entry="flash_wgmma_launch",
    source="flash_attention_wgmma.cu", kernels=("flash_wgmma_kernel",),
    smem_model=_wgmma_smem, max_shapes={"d": 192, "dv": 128},
    tail={"flash_wgmma_kernel": "if (w >= n_items) break"},
    exact_parity=False,
    accumulators=Accumulators(mma=("f32",), running={
        "flash_wgmma_kernel": (("m", "float"), ("l", "float"))}),
    instantiations={"flash_wgmma_kernel": len(WGMMA_BQ)}))
register(KernelContract(
    module=__name__, entry="flash_attention_launch",
    source="flash_attention.cu", kernels=("flash_kernel", "flash_mma_kernel"),
    smem_model=_cuda_core_smem, max_shapes={"d": MAX_D},
    tail={"flash_kernel": "if (qp >= S) continue",
          "flash_mma_kernel": "if (qp >= S) continue"},
    exact_parity=False,
    accumulators=Accumulators(mma=("f32",), running={
        "flash_kernel": _F32 + (("acc", "float"),),
        "flash_mma_kernel": _F32 + (("acc", "float"),)}),
    instantiations={"flash_kernel": 8, "flash_mma_kernel": 1},
    spill_bytes={"flash_kernel": 8}))
register(KernelContract(
    module=__name__, entry="flash_bwd_wgmma_launch",
    source="flash_attention_bwd_wgmma.cu", kernels=BWD_KERNELS["tma_wgmma"],
    smem_model=_wgmma_bwd_smem, max_shapes={"d": 192, "dv": 128},
    tail={k: "if (w >= n_items) break" for k in BWD_KERNELS["tma_wgmma"]},
    exact_parity=False,
    accumulators=Accumulators(mma=("f32",), running={
        "bwd_wgmma_dkdv_kernel": (("acc_k", "float"), ("acc_v", "float")),
        "bwd_wgmma_dq_kernel": (("acc", "float"),)}),
    instantiations={k: len(WGMMA_DV) for k in BWD_KERNELS["tma_wgmma"]}))
register(KernelContract(
    module=__name__, entry="flash_attention_bwd_launch",
    source="flash_attention_bwd.cu", kernels=BWD_KERNELS["cuda_cores"],
    smem_model=_cuda_core_bwd_smem, max_shapes={"d": MAX_D},
    tail={"bwd_stats_kernel": "if (qp >= S) continue",
          "bwd_dq_kernel": "if (qp >= S) continue",
          "bwd_dkdv_kernel": "if (kp >= S) continue"},
    exact_parity=False,
    accumulators=Accumulators(running={
        "bwd_stats_kernel": _F32,
        "bwd_dq_kernel": (("acc", "float"),),
        "bwd_dkdv_kernel": (("acc_k", "float"), ("acc_v", "float"))}),
    instantiations={k: 8 for k in BWD_KERNELS["cuda_cores"]}))
