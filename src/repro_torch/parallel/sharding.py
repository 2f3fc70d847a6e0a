"""Sharding rules: parameter and activation axes → mesh axes, placed as
DTensors.

The port of ``repro/parallel/sharding.py``.  The strategy is the JAX
package's (DESIGN.md §5):

* **tensor parallelism** over ``"model"``: attention heads, FFN hidden,
  vocabulary, MoE experts, embedding-table rows;
* **FSDP / ZeRO** over ``("pod", "data")``: the largest remaining dim of
  each large parameter, the optimizer state inheriting it;
* **batch** over ``("pod", "data")``; **context** over ``"model"``.

The rules read a mesh's axis names and sizes only, so they run on a
logical :class:`MeshShape` (the production meshes of 256 and 512 devices
are evaluated without a device).  A rule gives a :class:`Spec`, the
counterpart of ``PartitionSpec``: one entry per tensor dim, ``None``, an
axis name or a tuple of axis names (``tuple(spec)`` equals
``tuple(jax_spec)``).  :func:`placements` turns a spec into DTensor
placements over a ``torch.distributed`` ``DeviceMesh`` and
:func:`distribute` places a tree by them.  Each rank's local block is the
block ``NamedSharding.devices_indices_map`` gives the device of the same
index: a dim sharded over several axes is split over them in mesh order,
which DTensor's ``Shard`` placements on those mesh dims also do.  A spec
that names a dim's axes out of mesh order has no such placement and
raises.  The rules assign an axis only where its size divides the dim;
:func:`distribute` refuses a dim that does not divide (no padding).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

Entry = Union[None, str, Tuple[str, ...]]


@dataclasses.dataclass(frozen=True)
class UserShardSpec:
    """Round-robin assignment of users to shards.

    Global user ``u`` lives on shard ``u % n_shards`` at local row
    ``u // n_shards``: a bijection between global ids and ``(shard,
    row)`` pairs, stable as ``n_users`` grows, with shard sizes that
    differ by at most one row.  Interleaving the ids is what lets
    per-shard candidate lists merge with a single corpus's tie-break
    order (``core.knn.sharded_recommend_for_users``).
    """

    n_users: int
    n_shards: int

    def __post_init__(self) -> None:
        if self.n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {self.n_shards}")
        if self.n_users < 1:
            raise ValueError(f"n_users must be >= 1, got {self.n_users}")

    def shard_of(self, user):
        """Owning shard of global user id(s) ``user`` (int or array)."""
        return user % self.n_shards

    def local_row(self, user):
        """Local state-store row of global user id(s) ``user``."""
        return user // self.n_shards

    def global_user(self, shard, row):
        """Inverse mapping: global id of local ``row`` on ``shard``."""
        return row * self.n_shards + shard

    def shard_users(self, shard: int) -> int:
        """Number of users owned by ``shard`` (its state-store size)."""
        return (self.n_users - shard + self.n_shards - 1) // self.n_shards

    def owned_users(self, shard: int) -> np.ndarray:
        """Global ids owned by ``shard``, in local-row order."""
        return np.arange(shard, self.n_users, self.n_shards)


# ---------------------------------------------------------------------------
# Specs and meshes
# ---------------------------------------------------------------------------

def _entry(e: Any) -> Entry:
    """One spec entry as ``PartitionSpec`` normalizes it: ``()`` is
    ``None``, a 1-tuple its one name, a list a tuple."""
    if e is None or isinstance(e, str):
        return e
    names = tuple(e)
    if not all(isinstance(a, str) for a in names):
        raise TypeError(f"a spec entry is None, an axis name or a tuple "
                        f"of them, not {e!r}")
    if not names:
        return None
    return names[0] if len(names) == 1 else names


class Spec(tuple):
    """A ``PartitionSpec``: per tensor dim ``None`` (replicated), a mesh
    axis name or a tuple of names (sharded over their product, the first
    outermost).  Dims past the spec's length are replicated."""

    def __new__(cls, *entries: Any) -> "Spec":
        return super().__new__(cls, [_entry(e) for e in entries])

    def __repr__(self) -> str:
        return f"Spec({', '.join(map(repr, self))})"

    def axes(self, dim: int) -> Tuple[str, ...]:
        """The axis names tensor dim ``dim`` is sharded over."""
        e = self[dim] if dim < len(self) else None
        return () if e is None else (e,) if isinstance(e, str) else e


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A logical device mesh: axis names and sizes, what the rules read
    (the JAX dry run's fake-device mesh plays the same part).
    ``devices``: the devices of a mesh that names them (row-major), or
    ``None``."""

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    devices: Optional[Tuple[torch.device, ...]] = None

    def __post_init__(self) -> None:
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"{len(self.axis_names)} axis names for a "
                             f"mesh of {len(self.shape)} dims")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated axis name in {self.axis_names}")
        if any(int(n) < 1 for n in self.shape):
            raise ValueError(f"mesh shape {self.shape}")
        if self.devices is not None and len(self.devices) != self.size:
            raise ValueError(f"{len(self.devices)} devices for a mesh of "
                             f"{self.size}")

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def sizes(self) -> Dict[str, int]:
        """Axis name → size."""
        return dict(zip(self.axis_names, self.shape))

    def device_mesh(self, device_type: str = "cuda"):
        """The ``DeviceMesh`` of this shape over the default process
        group, which must hold exactly ``size`` ranks (rank ``r`` at the
        row-major position ``r``, as JAX lays device ``r`` out)."""
        if not dist.is_initialized():
            raise RuntimeError("no process group: init_process_group "
                               "before building a DeviceMesh")
        if dist.get_world_size() != self.size:
            raise RuntimeError(f"the process group holds "
                               f"{dist.get_world_size()} ranks, the mesh "
                               f"{self.shape} needs {self.size}")
        from torch.distributed.device_mesh import init_device_mesh
        return init_device_mesh(device_type, tuple(self.shape),
                                mesh_dim_names=tuple(self.axis_names))


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A ``NamedSharding``: a spec over a mesh, a logical
    :class:`MeshShape` (what the rules give) or a ``DeviceMesh`` (what
    ``restore_pytree(shardings=)`` places on)."""

    mesh: Any
    spec: Spec


def _axis_names(mesh: Any) -> Tuple[str, ...]:
    """A MeshShape's or a DeviceMesh's axis names."""
    names = getattr(mesh, "axis_names", None)
    if names is None:
        names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the mesh names no axes")
    return tuple(names)


def _sizes(mesh: Any) -> Dict[str, int]:
    return dict(zip(_axis_names(mesh), tuple(mesh.shape)))


# ---------------------------------------------------------------------------
# The rules
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Named logical axes → physical mesh axes.

    ``fsdp`` may span several axes (("pod", "data") on the multi-pod
    mesh): parameters are then ZeRO-3 sharded across all of them.
    """

    batch: tuple = ("pod", "data")
    fsdp: tuple = ("pod", "data")
    tensor: str = "model"
    expert: str = "model"
    context: str = "model"     # long-sequence KV cache sharding

    def fsdp_axes(self, mesh: Any) -> tuple:
        """The FSDP axes this mesh has."""
        names = _axis_names(mesh)
        return tuple(a for a in self.fsdp if a in names)

    def fsdp_size(self, mesh: Any) -> int:
        """The product of the FSDP axes' sizes (1 with none)."""
        sizes = _sizes(mesh)
        return math.prod(sizes[a] for a in self.fsdp_axes(mesh))


def _mesh_axis_size(mesh: Any, axis: Any) -> int:
    sizes = _sizes(mesh)
    if isinstance(axis, (tuple, list)):
        return math.prod(sizes[a] for a in axis)
    return sizes[axis]


def batch_axes(mesh: Any, rules: ShardingRules) -> tuple:
    """The batch sharding axes present in this mesh (pod may be absent)."""
    names = _axis_names(mesh)
    return tuple(a for a in rules.batch if a in names)


def logical_to_physical(mesh: MeshShape, rules: ShardingRules,
                        logical: tuple) -> Sharding:
    """A tuple of logical axis names (or None) as a :class:`Sharding`:
    "batch" → the batch axes, "tp" → the tensor axis, "fsdp" → the FSDP
    axes, "expert" and "ctx" → theirs, None → replicated.  Example:
    ("tp", "fsdp") → Spec("model", "data") on the single-pod mesh."""
    table = {
        None: None,
        "batch": batch_axes(mesh, rules),
        "tp": rules.tensor,
        "fsdp": rules.fsdp_axes(mesh),
        "expert": rules.expert,
        "ctx": rules.context,
    }
    return Sharding(mesh, Spec(*[table[x] for x in logical]))


def pick_fsdp_dim(shape: Tuple[int, ...], mesh: Any, rules: ShardingRules,
                  taken: Optional[int] = None) -> Optional[int]:
    """The largest dim (not ``taken``) that the FSDP size divides; None
    where nothing divides or the FSDP size is 1."""
    n = rules.fsdp_size(mesh)
    if n <= 1:
        return None
    candidates = [(d, s) for d, s in enumerate(shape)
                  if d != taken and s % n == 0 and s >= n]
    if not candidates:
        return None
    return max(candidates, key=lambda t: t[1])[0]


def param_spec(shape: Tuple[int, ...], mesh: Any, rules: ShardingRules,
               tp_dim: Optional[int] = None) -> Spec:
    """TP on ``tp_dim`` (where its size divides) + FSDP on the best other
    dim."""
    axes: List[Entry] = [None] * len(shape)
    if tp_dim is not None and rules.tensor in _axis_names(mesh):
        n = _mesh_axis_size(mesh, rules.tensor)
        if shape[tp_dim] % n == 0 and shape[tp_dim] >= n:
            axes[tp_dim] = rules.tensor
        else:
            tp_dim = None
    fs = pick_fsdp_dim(shape, mesh, rules, taken=tp_dim)
    if fs is not None:
        axes[fs] = rules.fsdp_axes(mesh)
    return Spec(*axes)


def _is_leaf(x: Any) -> bool:
    return not isinstance(x, (dict, list)) and not (
        isinstance(x, tuple) and not isinstance(x, Spec))


def tree_map(fn: Callable, tree: Any, *rest: Any, path: tuple = ()) -> Any:
    """``fn(path, leaf, *other leaves)`` over dicts, lists and tuples
    (NamedTuples kept; a :class:`Spec` is a leaf), ``path`` the keys and
    indices down to the leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest),
                            path=path + (k,)) for k in tree}
    if not _is_leaf(tree):
        out = [tree_map(fn, c, *(r[i] for r in rest), path=path + (i,))
               for i, c in enumerate(tree)]
        if hasattr(tree, "_fields"):
            return type(tree)(*out)
        return type(tree)(out)
    return fn(path, tree, *rest)


def shard_params_pytree(params: Any, spec_fn: Callable,
                        mesh: MeshShape) -> Any:
    """:class:`Sharding` objects of a tree of parameters by
    ``spec_fn(path, leaf)``."""
    return tree_map(lambda path, leaf: Sharding(mesh, spec_fn(path, leaf)),
                    params)


def zero_like_sharded(params_shardings: Any) -> Any:
    """Optimizer-state shardings = parameter shardings (ZeRO through
    the FSDP dims)."""
    return params_shardings


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------

def placements(spec: Spec, mesh: Any) -> list:
    """DTensor placements of ``spec`` over ``mesh`` (a DeviceMesh or a
    MeshShape): ``Shard(d)`` on each mesh dim the spec names for tensor
    dim ``d``, ``Replicate()`` on the others.  Raises where the spec
    names an axis the mesh lacks, names one twice, or names a dim's axes
    out of the mesh's order (DTensor splits a dim over its mesh dims in
    mesh order)."""
    from torch.distributed.tensor import Replicate, Shard
    names = _axis_names(mesh)
    out: list = [Replicate() for _ in names]
    seen: Dict[str, int] = {}
    for d in range(len(spec)):
        at = []
        for a in spec.axes(d):
            if a not in names:
                raise ValueError(f"{spec}: axis {a!r} is not one of the "
                                 f"mesh's {names}")
            if a in seen:
                raise ValueError(f"{spec}: axis {a!r} shards dims "
                                 f"{seen[a]} and {d}")
            seen[a] = d
            at.append(names.index(a))
        if at != sorted(at):
            raise ValueError(f"{spec}: dim {d} names its axes "
                             f"{spec.axes(d)} out of the mesh's order "
                             f"{names}, which DTensor cannot place")
        for j in at:
            out[j] = Shard(d)
    return out


def _check_divides(shape: Tuple[int, ...], spec: Spec, mesh: Any) -> None:
    if len(spec) > len(shape):
        raise ValueError(f"{spec} has {len(spec)} entries for a tensor of "
                         f"{len(shape)} dims")
    sizes = _sizes(mesh)
    for d in range(len(spec)):
        n = math.prod(sizes[a] for a in spec.axes(d))
        if shape[d] % n:
            raise ValueError(f"{spec}: dim {d} of {tuple(shape)} does not "
                             f"divide over {spec.axes(d)} ({n})")


def distribute(tree: Any, shardings: Any, device_mesh: Any) -> Any:
    """``tree`` (tensors) placed by ``shardings`` (a tree of
    :class:`Sharding` or :class:`Spec` of the same structure) as
    DTensors over ``device_mesh``: ``distribute_tensor`` of each leaf
    (from rank 0's copy).  Every rank must call it; a dim its axes do
    not divide raises."""
    from torch.distributed.tensor import distribute_tensor

    def one(_, x, s):
        spec = s.spec if isinstance(s, Sharding) else s
        _check_divides(tuple(x.shape), spec, device_mesh)
        return distribute_tensor(x, device_mesh,
                                 placements(spec, device_mesh))
    return tree_map(one, tree, shardings)
