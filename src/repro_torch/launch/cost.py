"""Cost model of an eager PyTorch program: the work one run dispatches.

The port's counterpart of the JAX package's ``launch/hlo_cost.py``.
Eager PyTorch has no HLO: every aten operation is a kernel of its own
(the analog of HLO's unfused top-level ops), so :class:`CostCounter`, a
``TorchDispatchMode``, counts the aten operations a run dispatches:

    with CostCounter(device) as c:
        prog.fn(*prog.args)
    c.costs          # a Costs

* FLOPs of every product (``mm``, ``addmm``, ``bmm``, ``baddbmm``,
  convolutions, SDPA: ``torch.utils.flop_counter``'s formulas, an FMA as
  two; ``_int_mm``, ``mv``, ``addmv`` and ``dot`` likewise), by the class
  of their inputs' dtype (``work.dtype_class``: ``"bf16"``, ``"f32"`` or
  ``"int8"``).
* HBM bytes: an op that makes a new tensor reads its operands on the
  counted device once and writes its outputs once; a tensor's bytes are
  its distinct elements, and a tensor given as two operands is read
  once.  Views, aliases and metadata ops count nothing;
  an in-place op reads and writes its mutated operand once (a fill, a
  copy or a random draw only writes it); a host<->device copy counts its
  device side.  Gathers (indexing, ``gather``, ``index_select``,
  ``embedding``) read as many source elements as they write, and
  scatters (``index_put_``, ``index_add_``, ``index_copy_``,
  ``scatter_*``) touch only the elements they address: not the whole
  table.
* Kernel work: the port's hand-written kernels are pybind/ctypes calls
  the dispatcher never sees.  Each dispatcher of ``kernels/ops.py``
  records its kernel's work (``kernels/work.py``) with the active counter
  once, on either route, and the counter stops counting aten ops while
  the route runs, so a cell counts the same work on the kernel and the
  plain route.
* Collective bytes, under the JAX model's keys: the result bytes of any
  ``torch.distributed`` (c10d or functional) collective this rank runs,
  on whichever device its tensors lie (``parallel/spmd.py`` stages a
  CUDA tensor's collective over gloo through a host copy; the copies
  count as HBM bytes, the collective as collective bytes).  Per rank:
  a run on a mesh counts its own rank's work.  0 on the one-card paths,
  whose shards are devices of one process.
* A DTensor operand counts as its local block (this rank's bytes).
* The backward pass counts too (the mode follows autograd's worker
  threads), and so does the recompute under ``torch.utils.checkpoint``,
  as the remat recompute does in the JAX HLO.

Not ported: ``estimate_f32_shadow_bytes`` (the XLA CPU backend's f32
copies of bf16 stacks; PyTorch makes none, and the port measures its
peak on the card).
"""
from __future__ import annotations

import contextlib
import dataclasses
from collections import defaultdict
from typing import Any, Dict, Iterator

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.kernels import work

# an op name's fragment -> its kind under the JAX model's keys
# (``hlo_cost.py::_COLLECTIVES``), for c10d and functional collectives
_COLLECTIVE_NAMES = (("ragged_all_to_all", "ragged-all-to-all"),
                     ("all_gather", "all-gather"),
                     ("allgather", "all-gather"),
                     ("reduce_scatter", "reduce-scatter"),
                     ("all_reduce", "all-reduce"),
                     ("allreduce", "all-reduce"),
                     ("all_to_all", "all-to-all"),
                     ("alltoall", "all-to-all"),
                     ("send", "collective-permute"),
                     ("recv", "collective-permute"))
_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")

# ops that move no data: metadata, views whose schema does not say so,
# allocations that write nothing, and in-place views
_FREE = {
    "_unsafe_view", "_reshape_alias", "lift_fresh", "lift_fresh_copy",
    "detach", "detach_", "alias", "view", "t", "t_", "transpose",
    "transpose_", "expand", "slice", "select", "as_strided", "as_strided_",
    "permute", "unsqueeze", "unsqueeze_", "squeeze", "squeeze_", "unfold",
    "diagonal", "split", "split_with_sizes", "unbind", "narrow",
    "view_as_real", "view_as_complex", "_conj", "_neg_view", "empty",
    "empty_strided", "empty_like", "new_empty", "new_empty_strided",
    "resize_", "resize_as_", "set_", "record_stream", "sym_size",
    "sym_stride", "sym_numel", "sym_storage_offset", "is_same_size",
    "_has_compatible_shallow_copy_type", "wait_tensor"}
# in-place ops that write their mutated operand without reading it
_WRITE_ONLY = {"copy_", "fill_", "zero_", "normal_", "uniform_", "random_",
               "bernoulli_", "exponential_", "geometric_", "log_normal_",
               "cauchy_", "index_copy_", "scatter_", "index_fill_", "put_",
               "masked_fill_"}
# out-of-place gathers: the source is read where the output is written
_GATHERS = {"index", "gather", "index_select", "embedding", "take"}
# in-place scatters: only the addressed elements of the target move
_SCATTERS = {"index_put_", "_index_put_impl_", "index_add_", "index_copy_",
             "index_fill_", "scatter_", "scatter_add_", "scatter_reduce_",
             "index_reduce_", "put_"}


@dataclasses.dataclass
class Costs:
    """Counted work of one run: FLOPs (``flops`` in all and by dtype
    class), HBM bytes, collective bytes by kind (``coll``) and count
    (``coll_counts``), and the hand-written kernels' work by kernel
    (``kernels``: name -> {"calls", "flops", "bytes"})."""
    flops: float = 0.0
    bytes: float = 0.0
    coll: Dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    flops_by_dtype: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    coll_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    kernels: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)

    def add_flops(self, n: float, cls: str) -> None:
        self.flops += n
        self.flops_by_dtype[cls] = self.flops_by_dtype.get(cls, 0.0) + n

    def add_work(self, w: work.Work) -> None:
        """A hand-written kernel's work (``kernels/work.py``)."""
        self.add_flops(w.ops, w.dtype)
        self.bytes += w.bytes
        k = self.kernels.setdefault(w.kernel, {"calls": 0, "flops": 0.0,
                                               "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += w.ops
        k["bytes"] += w.bytes

    @property
    def coll_bytes(self) -> float:
        return sum(self.coll.values())

    @property
    def kernel_calls(self) -> Dict[str, int]:
        """Recorded calls of each hand-written kernel."""
        return {n: int(r["calls"]) for n, r in self.kernels.items()}


def _flop_formulas() -> Dict[Any, Any]:
    from torch.utils.flop_counter import flop_registry
    aten = torch.ops.aten
    out = dict(flop_registry)

    def mm_like(a, b, *args, out_val=None, **kw):
        return 2 * a.shape[0] * a.shape[1] * b.shape[1]

    def mv(a, x, *args, out_val=None, **kw):
        return 2 * a.shape[0] * a.shape[1]

    def addmv(bias, a, x, *args, out_val=None, **kw):
        return 2 * a.shape[0] * a.shape[1]

    def dot(a, b, *args, out_val=None, **kw):
        return 2 * a.shape[0]

    out.update({aten._int_mm: mm_like, aten.mv: mv, aten.addmv: addmv,
                aten.dot: dot, aten.vdot: dot})
    return out


# aten op packet -> its FLOP formula
_FORMULAS = _flop_formulas()


def _schema_args(func, args, kwargs) -> Iterator[tuple]:
    """(schema argument, value) of each argument given."""
    schema = func._schema.arguments
    for a, v in zip(schema, args):
        yield a, v
    for a in schema[len(args):]:
        if a.name in kwargs:
            yield a, kwargs[a.name]


def _tensors(x) -> list:
    """The tensors in ``x``, a DTensor as its local block."""
    from torch.distributed.tensor import DTensor
    return [t._local_tensor if isinstance(t, DTensor) else t
            for t in tree_flatten(x)[0] if isinstance(t, torch.Tensor)]


def _broadcast_numel(shapes) -> int:
    n = 1
    for s in torch.broadcast_shapes(*shapes):
        n *= s
    return n


class CostCounter(TorchDispatchMode):
    """Within ``with``, counts the aten operations dispatched on
    ``device`` (the card by default) and the hand-written kernels' work
    into :attr:`costs` (see the module docstring)."""

    def __init__(self, device: Any = None):
        super().__init__()
        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.costs = Costs()
        self._quiet = 0
        self._prev_sink = None

    # -- the dispatchers' side (``kernels/work.py``) -------------------------

    def declare(self, fn, args, kw) -> None:
        """Record ``fn(*args, **kw)``'s work; its own reads of the device
        are not counted."""
        with self.quiet():
            self.costs.add_work(fn(*args, **kw))

    @contextlib.contextmanager
    def quiet(self) -> Iterator[None]:
        """Suspend the counting of aten ops (a kernel's route runs)."""
        self._quiet += 1
        try:
            yield
        finally:
            self._quiet -= 1

    # -- the mode ------------------------------------------------------------

    def __enter__(self):
        self._prev_sink, work.SINK = work.SINK, self
        return super().__enter__()

    def __exit__(self, *exc):
        work.SINK = self._prev_sink
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._quiet:
            self._count(func, args, kwargs, out)
        return out

    def _on(self, t: torch.Tensor) -> bool:
        d = t.device
        return d.type == self.device.type and (
            d.type != "cuda" or d.index == self.device.index)

    def _bytes(self, ts) -> int:
        return sum(work.nbytes(t) for t in ts if self._on(t))

    def _count(self, func, args, kwargs, out) -> None:
        packet = func.overloadpacket
        name = packet.__name__
        if name in _FREE:
            return
        formula = _FORMULAS.get(packet)
        if formula is not None:
            first = [t for t in _tensors(args) if t.dtype != torch.bool]
            cls = work.dtype_class(first[0].dtype if first else torch.float32)
            self.costs.add_flops(float(formula(*args, **kwargs, out_val=out)),
                                 cls)
        schema = func._schema
        if schema.returns and all(r.alias_info is not None
                                  for r in schema.returns) and not any(
                a.alias_info is not None and a.alias_info.is_write
                for a in schema.arguments):
            return                        # a view or an alias of its input
        n = self._io_bytes(func, name, args, kwargs, out)
        self.costs.bytes += n
        ns = func.namespace
        if ns in _COLLECTIVE_NAMESPACES:
            kind = next((k for frag, k in _COLLECTIVE_NAMES if frag in name),
                        None)
            if kind is not None:
                moved = sum(work.nbytes(t) for t in _tensors(out)) or sum(
                    work.nbytes(t) for t in _tensors((args, kwargs)))
                self.costs.coll[kind] += moved
                self.costs.coll_counts[kind] = \
                    self.costs.coll_counts.get(kind, 0) + 1

    def _io_bytes(self, func, name, args, kwargs, out) -> int:
        """Operands read once, outputs written once (module docstring);
        a tensor given as two operands is read once."""
        reads = writes = 0
        seen = set()
        for a, v in _schema_args(func, args, kwargs):
            ts = [t for t in _tensors(v) if _key(t) not in seen]
            seen.update(_key(t) for t in ts)
            if not ts:
                continue
            if a.alias_info is not None and a.alias_info.is_write:
                if name in _SCATTERS:
                    n = self._touched(name, args, kwargs, ts)
                else:
                    n = self._bytes(ts)
                writes += n
                if name not in _WRITE_ONLY and not a.name.startswith("out"):
                    reads += n
            elif name in _GATHERS and a.name in ("self", "weight"):
                # as many source elements as the output holds
                outs = [t for t in _tensors(out) if self._on(t)]
                src = [t for t in ts if self._on(t)]
                if outs and src:
                    reads += min(work.nbytes(src[0]),
                                 outs[0].numel() * src[0].element_size())
            else:
                reads += self._bytes(ts)
        for r, t in zip(func._schema.returns, _out_list(out)):
            if r.alias_info is None and isinstance(t, torch.Tensor):
                writes += self._bytes([t])
        return reads + writes

    def _touched(self, name, args, kwargs, ts) -> int:
        """The bytes of a scatter's target it addresses."""
        target = ts[0]
        if not self._on(target):
            return 0
        bound = _bound_args(name, args, kwargs)
        itemsize = target.element_size()
        if name in ("index_put_", "_index_put_impl_"):
            idx = [i for i in bound["indices"] if i is not None]
            shapes = []
            for i in idx:
                if i.dtype == torch.bool:
                    shapes.append((int(i.sum()),))
                else:
                    shapes.append(tuple(i.shape))
            covered = sum(i.dim() if i.dtype == torch.bool else 1
                          for i in idx)
            rest = 1
            for s in target.shape[covered:]:
                rest *= s
            n = _broadcast_numel(shapes) * rest if shapes else target.numel()
        elif name in ("index_add_", "index_copy_", "index_fill_",
                      "index_reduce_"):
            dim = bound["dim"] % max(target.dim(), 1)
            n = bound["index"].numel() * (target.numel() // max(
                target.shape[dim] if target.dim() else 1, 1))
        else:                             # scatter_*, put_
            n = bound["index"].numel()
        return min(n, target.numel()) * itemsize


def _key(t: torch.Tensor) -> tuple:
    """The elements a tensor operand names: two operands with one key
    are one input."""
    return (t.device, t.data_ptr(), t.dtype, tuple(t.shape), t.stride())


def _out_list(out) -> list:
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _bound_args(name, args, kwargs) -> Dict[str, Any]:
    """A scatter's arguments by name (their positions in the aten
    schemas)."""
    names = {"index_put_": ("self", "indices", "values", "accumulate"),
             "_index_put_impl_": ("self", "indices", "values", "accumulate"),
             "put_": ("self", "index", "source", "accumulate")}.get(
        name, ("self", "dim", "index"))
    bound = dict(zip(names, args))
    bound.update(kwargs)
    return bound
