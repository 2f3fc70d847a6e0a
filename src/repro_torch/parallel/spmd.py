"""SPMD execution over a named ``DeviceMesh``: ``shard_map``, sharding
constraints, axis indices and the collectives of a ``shard_map`` body.

The counterpart of what the JAX package reaches through
``compat.shard_map``, ``jax.lax.with_sharding_constraint`` and
``jax.lax.{axis_index, psum, all_gather, psum_scatter}``.  Every rank
runs the same program on its LOCAL block of each tensor, the block
:func:`local_block` gives for a :class:`~repro_torch.parallel.sharding.
Spec` (the block ``NamedSharding`` gives the device of the same index),
and moves data between ranks only through the collectives here:

* :func:`psum` (gradient: the identity), :func:`pvary` (the identity;
  gradient: :func:`psum`), :func:`all_gather` (tiled; gradient:
  :func:`psum_scatter`) and :func:`psum_scatter` (gradient:
  :func:`all_gather`) are JAX's primitives with the transposes JAX gives
  them: a body's cotangents are per-rank partial sums;
* :func:`redistribute` moves a local block from one spec's layout to
  another's, with a constraint's gradient (the reverse move), what
  ``with_sharding_constraint`` does on a value GSPMD holds;
* :func:`constrain` is that move on a DTensor (a no-op without a mesh);
* :func:`shard_map` runs a body on the local blocks of its inputs (a
  DTensor moved to its in-spec, a plain tensor taken as the global value
  every rank holds) and wraps each output as a DTensor of its out-spec,
  as ``torch.distributed.tensor.experimental.local_map`` does.

Sums of bf16 and f16 values run in float32 and round once, as one
device's reduction over the same values would.  DTensors are the
containers (parameters, optimizer state, sharded results); none of
their own collectives run here.  The port's kernels
are called on local tensors inside the bodies.

Host staging: a collective of a CUDA tensor over a gloo group always
runs on a host copy (device → host, the gloo collective on CPU tensors,
host → device), never through gloo's CUDA paths: on torch 2.11 with
CUDA 12.8, a DTensor all-gather of CUDA tensors over gloo crashed the
process (NVIDIA H100 80GB HBM3, 4 ranks on one card), and NCCL refuses
two ranks on one device.  Over NCCL the collective runs on the device.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.parallel.sharding import Spec, placements, tree_map

Axes = Union[str, Sequence[str]]


# ---------------------------------------------------------------------------
# Axes, groups, indices
# ---------------------------------------------------------------------------

def _names(mesh: Any) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def _axes(mesh: Any, axes: Axes) -> Tuple[str, ...]:
    """``axes`` as a tuple in the mesh's order (JAX's order for a tuple
    of axes is the tuple's; the port's specs keep mesh order)."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    names = _names(mesh)
    for a in axes:
        if a not in names:
            raise ValueError(f"axis {a!r} is not one of the mesh's {names}")
    if list(axes) != sorted(axes, key=names.index):
        raise ValueError(f"axes {axes} out of the mesh's order {names}")
    return axes


def axis_size(mesh: Any, axes: Axes) -> int:
    """The product of the sizes of ``axes`` (1 for no axis)."""
    sizes = dict(zip(_names(mesh), tuple(mesh.shape)))
    return math.prod(sizes[a] for a in _axes(mesh, axes))


def axis_index(mesh: Any, axes: Axes) -> int:
    """This rank's coordinate along ``axes`` (``jax.lax.axis_index``): the
    row-major index over the axes, the first outermost."""
    idx = 0
    for a in _axes(mesh, axes):
        idx = idx * axis_size(mesh, a) + mesh.get_local_rank(a)
    return idx


def _group(mesh: Any, axes: Tuple[str, ...]):
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return mesh[axes]._flatten().get_group()


def _staged(x: torch.Tensor, group) -> bool:
    """Whether a collective of ``x`` over ``group`` runs on a host copy
    (a CUDA tensor over gloo)."""
    return x.device.type != "cpu" and dist.get_backend(group) == "gloo"


def _run(x: torch.Tensor, group, op: Callable, out_shape) -> torch.Tensor:
    """``op(out, inp, group)`` on a fresh output of ``out_shape``, staged
    through host memory where :func:`_staged` says so."""
    inp = x.contiguous()
    if _staged(x, group):
        host = inp.cpu()
        out = torch.empty(out_shape, dtype=x.dtype)
        op(out, host, group)
        return out.to(x.device)
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    # a copy: gloo's reduce-scatter works in its input, which may be a
    # tensor autograd (or a selective checkpoint) keeps
    op(out, inp.clone() if inp is x else inp, group)
    return out


# sums of these dtypes run in float32 and round once at the end, as one
# device's reduction over the same values would
_WIDEN = (torch.bfloat16, torch.float16)


def _all_reduce(x: torch.Tensor, mesh: Any, axes: Tuple[str, ...],
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    if axis_size(mesh, axes) == 1:
        return x.clone()
    if op == dist.ReduceOp.SUM and x.dtype in _WIDEN:
        return _all_reduce(x.float(), mesh, axes, op).to(x.dtype)

    def run(out, inp, group):
        out.copy_(inp)
        dist.all_reduce(out, op=op, group=group)
    return _run(x, _group(mesh, axes), run, x.shape)


def _gather(x: torch.Tensor, mesh: Any, axes: Tuple[str, ...],
            dim: int) -> torch.Tensor:
    n = axis_size(mesh, axes)
    if n == 1:
        return x.clone()
    xt = x.movedim(dim, 0)
    shape = (n * xt.shape[0],) + tuple(xt.shape[1:])

    def run(out, inp, group):
        dist.all_gather_into_tensor(out, inp, group=group)
    return _run(xt, _group(mesh, axes), run, shape).movedim(0, dim)


def _scatter(x: torch.Tensor, mesh: Any, axes: Tuple[str, ...],
             dim: int) -> torch.Tensor:
    n = axis_size(mesh, axes)
    if n == 1:
        return x.clone()
    if x.dtype in _WIDEN:
        return _scatter(x.float(), mesh, axes, dim).to(x.dtype)
    xt = x.movedim(dim, 0)
    if xt.shape[0] % n:
        raise ValueError(f"psum_scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not divide over {axes} ({n})")
    shape = (xt.shape[0] // n,) + tuple(xt.shape[1:])

    def run(out, inp, group):
        dist.reduce_scatter_tensor(out, inp, group=group)
    return _run(xt, _group(mesh, axes), run, shape).movedim(0, dim)


def _chunk(x: torch.Tensor, mesh: Any, axes: Tuple[str, ...],
           dim: int) -> torch.Tensor:
    n = axis_size(mesh, axes)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide "
                         f"over {axes} ({n})")
    size = x.shape[dim] // n
    return x.narrow(dim, axis_index(mesh, axes) * size, size)


# ---------------------------------------------------------------------------
# The collectives of a shard_map body, with JAX's transposes
# ---------------------------------------------------------------------------

class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return _all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Pvary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh, ctx.axes), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, ctx.mesh, ctx.axes, ctx.dim), None, None, None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _scatter(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.mesh, ctx.axes, ctx.dim), None, None, None


def psum(x: torch.Tensor, mesh: Any, axes: Axes) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axes`` (``jax.lax.psum``).
    Gradient: the identity (the cotangent of a sum every rank holds is
    the same on each)."""
    return _Psum.apply(x, mesh, _axes(mesh, axes))


def pmax(x: torch.Tensor, mesh: Any, axes: Axes) -> torch.Tensor:
    """The element-wise maximum over the ranks of ``axes`` (no
    gradient)."""
    return _all_reduce(x.detach(), mesh, _axes(mesh, axes),
                       dist.ReduceOp.MAX)


def pvary(x: torch.Tensor, mesh: Any, axes: Axes) -> torch.Tensor:
    """``x``, a value every rank of ``axes`` holds, entering a computation
    whose cotangents differ by rank (``jax.lax.pvary``): the identity,
    whose gradient is the :func:`psum` of the cotangents."""
    axes = _axes(mesh, axes)
    if not axes:
        return x
    return _Pvary.apply(x, mesh, axes)


def all_gather(x: torch.Tensor, mesh: Any, axes: Axes, dim: int = 0,
               tiled: bool = True) -> torch.Tensor:
    """The blocks of ``x`` over the ranks of ``axes`` joined along
    ``dim`` (``jax.lax.all_gather(..., tiled=True)``; ``tiled=False``
    stacks them in a new leading dim ``dim``).  Gradient:
    :func:`psum_scatter` of the cotangent."""
    if not tiled:
        return all_gather(x.unsqueeze(dim), mesh, axes, dim, True)
    return _AllGather.apply(x, mesh, _axes(mesh, axes), dim % x.dim())


def psum_scatter(x: torch.Tensor, mesh: Any, axes: Axes,
                 dim: int = 0) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axes``, of which each keeps
    its block along ``dim`` (``jax.lax.psum_scatter(..., tiled=True)``).
    Gradient: :func:`all_gather` of the cotangent."""
    return _PsumScatter.apply(x, mesh, _axes(mesh, axes), dim % x.dim())


# ---------------------------------------------------------------------------
# Layouts: local blocks, redistribution, constraints
# ---------------------------------------------------------------------------

def spec_of(x: Any) -> Spec:
    """The :class:`Spec` of a DTensor's placements (each ``Shard(d)`` on a
    mesh dim names that dim's axis for tensor dim ``d``, in mesh
    order).  Raises on a ``Partial`` placement."""
    from torch.distributed.tensor import Replicate, Shard
    names = _names(x.device_mesh)
    axes: Dict[int, list] = {}
    for name, p in zip(names, x.placements):
        if isinstance(p, Shard):
            axes.setdefault(p.dim % x.dim(), []).append(name)
        elif not isinstance(p, Replicate):
            raise ValueError(f"no spec for the placement {p}")
    return Spec(*[tuple(axes.get(d, ())) for d in range(x.dim())])


def _spec_axes(spec: Spec, dim: int) -> Tuple[str, ...]:
    return spec.axes(dim) if dim < len(spec) else ()


class _Gather(torch.autograd.Function):
    """A constraint from sharded to gathered: the forward gathers, the
    gradient takes the rank's block (the reverse constraint)."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return (_chunk(g, ctx.mesh, ctx.axes, ctx.dim).contiguous(),
                None, None, None)


class _Chunk(torch.autograd.Function):
    """A constraint from gathered to sharded: the forward takes the
    rank's block, the gradient gathers the blocks."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _chunk(x, mesh, axes, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.mesh, ctx.axes, ctx.dim), None, None, None


def local_block(x: torch.Tensor, mesh: Any, spec: Spec) -> torch.Tensor:
    """This rank's block of ``x``, a global value every rank holds, under
    ``spec`` (each dim sharded over its axes in mesh order).  Gradient:
    the blocks' cotangents gathered."""
    for d in range(min(len(spec), x.dim())):
        axes = _spec_axes(spec, d)
        if axes:
            x = _Chunk.apply(x, mesh, _axes(mesh, axes), d)
    return x


def redistribute(x: torch.Tensor, mesh: Any, have: Spec,
                 want: Spec) -> torch.Tensor:
    """The local block ``x`` of a tensor laid out by ``have`` as its
    block under ``want``: each dim whose axes differ is gathered over
    ``have``'s, then cut over ``want``'s; a dim whose ``have`` axes lead
    ``want``'s (rows over "data" to rows over ("data", "model")) is only
    cut further over the rest, with nothing gathered.  The gradient is
    the reverse move of the cotangent (a sharding constraint's)."""
    ndim = x.dim()

    def refined(h, w):
        return len(h) < len(w) and w[:len(h)] == h
    for d in range(ndim):
        h, w = _spec_axes(have, d), _spec_axes(want, d)
        if h and h != w and not refined(h, w):
            x = _Gather.apply(x, mesh, _axes(mesh, h), d)
    for d in range(ndim):
        h, w = _spec_axes(have, d), _spec_axes(want, d)
        if w and h != w:
            cut = w[len(h):] if refined(h, w) else w
            x = _Chunk.apply(x, mesh, _axes(mesh, cut), d)
    return x


def from_local(x: torch.Tensor, mesh: Any, spec: Spec):
    """A DTensor of ``spec`` over ``mesh`` whose block on this rank is
    ``x`` (no check, no collective)."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(x, mesh, placements(spec, mesh),
                              run_check=False)


def constrain(x: Any, mesh: Any, spec: Spec) -> Any:
    """``jax.lax.with_sharding_constraint``: ``x`` laid out by ``spec``
    over ``mesh``.  Without a mesh, ``x`` itself.  A DTensor is moved
    from its placements to the spec's; a plain tensor is the global value
    every rank holds, of which the rank keeps its block."""
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        return from_local(redistribute(x.to_local(), mesh, spec_of(x),
                                        spec), mesh, spec)
    return from_local(local_block(x, mesh, spec), mesh, spec)


def gather_full(x: Any) -> torch.Tensor:
    """The global value of a DTensor (gathered through the collectives
    here; a new tensor, also where the DTensor is replicated); a plain
    tensor as it is."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    local = x.to_local()
    out = redistribute(local, x.device_mesh, spec_of(x), Spec())
    return out.clone() if out is local else out


def enter(x: Any, mesh: Any, spec: Spec) -> Any:
    """This rank's block of ``x`` under ``spec``: a DTensor moved there
    by :func:`redistribute`, a plain tensor taken as the global value
    every rank holds (:func:`local_block`); anything else as it is."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        return redistribute(x.to_local(), mesh, spec_of(x), spec)
    if isinstance(x, torch.Tensor):
        return local_block(x, mesh, spec)
    return x


def shard_map(fn: Callable, mesh: Any, in_specs: Any,
              out_specs: Any) -> Callable:
    """``compat.shard_map(fn, mesh=mesh, in_specs=..., out_specs=...)``:
    the returned function calls ``fn`` on each argument's local block
    under its spec in ``in_specs`` (a tree of :class:`Spec` matching the
    arguments; a DTensor is moved there by :func:`redistribute`, a plain
    tensor is the global value every rank holds) and returns each of
    ``fn``'s outputs as a DTensor of its spec in ``out_specs`` (one rank's
    block, no check).  Non-tensor arguments pass through (:func:`enter`)."""
    def wrapped(*args):
        local = tree_map(lambda _, x, spec: enter(x, mesh, spec),
                         list(args), list(in_specs))
        out = fn(*local)
        return tree_map(lambda _, y, s: from_local(y, mesh, s), out,
                        out_specs)
    return wrapped


def shard_module(module: torch.nn.Module, mesh: Any,
                 specs: Dict[str, Spec]) -> torch.nn.Module:
    """Every parameter of ``module`` (each rank holding the same global
    values, e.g. from one seed) replaced IN PLACE by a DTensor parameter
    of its spec in ``specs`` (keyed as ``named_parameters`` names it),
    holding the rank's block: ``distribute`` without its broadcast, the
    parameters' storage as ``param_pspecs`` places it."""
    import torch.nn as nn
    for name, p in list(module.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        sub = module.get_submodule(owner) if owner else module
        block = local_block(p.detach(), mesh, specs[name]).clone()
        sub.register_parameter(leaf, nn.Parameter(
            from_local(block, mesh, specs[name]),
            requires_grad=p.requires_grad))
    return module


def local(x: Any) -> Any:
    """A DTensor's local block (its storage, not a copy, under
    ``torch.no_grad()``); a plain tensor as it is."""
    from torch.distributed.tensor import DTensor
    return x.to_local() if isinstance(x, DTensor) else x
