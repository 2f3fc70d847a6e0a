"""Fault-tolerant pytree checkpoints (the port of
``repro/checkpoint/pytree.py``), in the JAX package's on-disk format, so
that either package restores the other's:

* ``ckpt_{step:010d}.npz`` holds ``leaf_{i}`` for the tree's leaves in
  ``jax.tree_util``'s flatten order (:func:`flatten`: dict keys sorted,
  lists, tuples and NamedTuples in field order, ``None`` no leaf);
  bf16 (and fp8) leaves are stored as a same-width unsigned view;
* ``LATEST`` is JSON with ``step``, ``n_leaves`` and each leaf's
  ``dtypes`` name;
* writes are atomic (tmp + rename): a preempted writer never corrupts
  the latest checkpoint;
* :class:`AsyncCheckpointer` snapshots to host memory at ``save`` and
  serializes on a worker thread, keeping the last ``keep`` checkpoints;
  a writer's error is raised by the next call.

Leaves are torch tensors (any device), numpy arrays or Python scalars;
:func:`restore_pytree` gives torch tensors, each on its ``like`` leaf's
device.

Sharded trees: every rank calls :func:`save_pytree` on a tree with
DTensor leaves; each is gathered whole (``full_tensor``, as the
reference's ``np.asarray`` gathers a sharded array), global rank 0
writes the same files an unsharded tree of those values gives, and the
ranks meet at a barrier.  :func:`restore_pytree` with ``shardings=``
places every restored leaf as a DTensor by its ``Sharding`` over a
``DeviceMesh`` of any size: an elastic restart onto another mesh.
"""
from __future__ import annotations

import json
import os
import queue
import threading
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

# numpy has no bf16 / fp8: stored as a same-width unsigned view, the true
# dtype in LATEST (the reference's names); torch reads the bits through
# an integer dtype of its own (it has no uint16 numpy bridge everywhere)
_EXOTIC = {torch.bfloat16: ("bfloat16", np.uint16, torch.int16, np.int16),
           torch.float8_e4m3fn: ("float8_e4m3fn", np.uint8, torch.uint8,
                                 np.uint8),
           torch.float8_e5m2: ("float8_e5m2", np.uint8, torch.uint8,
                               np.uint8)}
_BY_NAME = {spec[0]: dt for dt, spec in _EXOTIC.items()}


def flatten(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in ``jax.tree_util``'s order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for child in tree for x in flatten(child)]
    return [tree]


def _unflatten(like: Any, leaves: List[Any]) -> Any:
    """``like``'s structure with its leaves replaced, in order, by those
    of ``leaves`` (consumed from the front)."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        children = [_unflatten(c, leaves) for c in like]
        if hasattr(like, "_fields"):                  # a NamedTuple
            return type(like)(*children)
        return type(like)(children)
    return leaves.pop(0)


def _map(fn: Callable[[Any], Any], tree: Any) -> Any:
    return _unflatten(tree, [fn(x) for x in flatten(tree)])


def _encode(x: Any) -> Tuple[np.ndarray, str]:
    """A leaf as (the array written, its dtype name)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype in _EXOTIC:
            name, stored, bits, _ = _EXOTIC[x.dtype]
            return x.view(bits).numpy().view(stored), name
        x = x.numpy()
        return x, str(x.dtype)
    x = np.asarray(x)
    if x.dtype.name in _BY_NAME:                    # ml_dtypes' bf16 / fp8
        return x.view(_EXOTIC[_BY_NAME[x.dtype.name]][1]), x.dtype.name
    return x, str(x.dtype)


def _decode(x: np.ndarray, name: str) -> torch.Tensor:
    x = np.array(x, order="C")        # a writable copy, 0-d kept 0-d
    if name in _BY_NAME:
        dt = _BY_NAME[name]
        return torch.from_numpy(x.view(_EXOTIC[dt][3])).view(dt)
    return torch.from_numpy(x.astype(np.dtype(name), copy=False))


def _is_dtensor(x: Any) -> bool:
    if not isinstance(x, torch.Tensor) or not dist.is_available():
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def save_pytree(tree: Any, directory: str, step: int) -> str:
    """Write ``tree`` as checkpoint ``step`` of ``directory`` and point
    ``LATEST`` at it (both atomically); returns the npz path.  A tree
    with DTensor leaves is saved by every rank together: the leaves are
    gathered whole, rank 0 writes, and all return after a barrier."""
    leaves = flatten(tree)
    sharded = any(_is_dtensor(x) for x in leaves)
    if sharded:
        leaves = [x.full_tensor() if _is_dtensor(x) else x for x in leaves]
    path = os.path.join(directory, f"ckpt_{step:010d}.npz")
    if not sharded or dist.get_rank() == 0:
        _write(leaves, directory, step, path)
    if sharded:
        dist.barrier()
    return path


def _write(leaves: List[Any], directory: str, step: int, path: str) -> None:
    os.makedirs(directory, exist_ok=True)
    arrays, dtypes = {}, []
    for i, x in enumerate(leaves):
        enc, name = _encode(x)
        arrays[f"leaf_{i}"] = enc
        dtypes.append(name)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)
    meta = {"step": step, "n_leaves": len(leaves), "dtypes": dtypes}
    mtmp = os.path.join(directory, "LATEST.tmp")
    with open(mtmp, "w") as f:
        json.dump(meta, f)
    os.replace(mtmp, os.path.join(directory, "LATEST"))


def latest_step(directory: str) -> Optional[int]:
    """The step ``LATEST`` names, or ``None`` when there is none."""
    try:
        with open(os.path.join(directory, "LATEST")) as f:
            return json.load(f)["step"]
    except FileNotFoundError:
        return None


def restore_pytree(like: Any, directory: str, step: Optional[int] = None,
                   shardings: Any = None) -> Any:
    """Checkpoint ``step`` (default: the latest) of ``directory`` in the
    structure of ``like``: torch tensors of the stored dtypes, each on
    its ``like`` leaf's device (the CPU for a leaf that is not a
    tensor).  Raises where the leaf count or a shape differs from
    ``like``'s.

    ``shardings``: a tree of ``parallel.sharding.Sharding`` matching
    ``like``, each over a ``DeviceMesh``; every leaf is then returned as
    a DTensor placed by its sharding on that mesh's devices, whatever
    mesh wrote the checkpoint (every rank of the mesh calls it)."""
    places = None
    if shardings is not None:
        from repro_torch.parallel.sharding import Sharding, distribute
        places = flatten(shardings)
        if not all(isinstance(s, Sharding)
                   and hasattr(s.mesh, "device_type") for s in places):
            raise TypeError("shardings= takes a tree of Sharding over a "
                            "DeviceMesh, one for each leaf")
        if len(places) != len(flatten(like)):
            raise ValueError(f"{len(places)} shardings for a tree of "
                             f"{len(flatten(like))} leaves")
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    with open(os.path.join(directory, "LATEST")) as f:
        dtypes = json.load(f).get("dtypes")
    wanted = flatten(like)
    out = []
    with np.load(os.path.join(directory, f"ckpt_{step:010d}.npz")) as data:
        if len(data.files) != len(wanted):
            raise ValueError(f"checkpoint {step} holds {len(data.files)} "
                             f"leaves, the tree {len(wanted)}")
        for i, ref in enumerate(wanted):
            x = data[f"leaf_{i}"]
            t = _decode(x, dtypes[i] if dtypes else str(x.dtype))
            if isinstance(ref, torch.Tensor):
                if tuple(t.shape) != tuple(ref.shape):
                    raise ValueError(f"leaf {i}: shape {tuple(t.shape)}, "
                                     f"the tree's {tuple(ref.shape)}")
                if places is None:
                    t = t.to(ref.device)
            out.append(t)
    if places is not None:
        out = [distribute(t.to(s.mesh.device_type), s, s.mesh)
               for t, s in zip(out, places)]
    return _unflatten(like, out)


def _host_copy(x: Any) -> Any:
    if _is_dtensor(x):
        raise TypeError("AsyncCheckpointer snapshots local tensors: save "
                        "a DTensor tree with save_pytree")
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return np.array(x, copy=True)


class AsyncCheckpointer:
    """Background writer: a host snapshot at :meth:`save`, serialized on
    a worker thread, the newest ``keep`` checkpoints kept.  An error of
    the writer is raised by the next :meth:`save` or :meth:`wait`."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._q: queue.Queue = queue.Queue(maxsize=2)
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            tree, step = item
            try:
                save_pytree(tree, self.directory, step)
                self._gc()
            except BaseException as e:  # noqa: BLE001 - raised by the caller
                self._err = e
            finally:
                self._q.task_done()

    def _gc(self) -> None:
        ckpts = sorted(f for f in os.listdir(self.directory)
                       if f.startswith("ckpt_") and f.endswith(".npz"))
        for f in ckpts[:-self.keep]:
            os.remove(os.path.join(self.directory, f))

    def save(self, tree: Any, step: int) -> None:
        """Snapshot ``tree`` to host memory now (training may then
        change its tensors) and queue its write as checkpoint
        ``step``."""
        if self._err:
            raise self._err
        self._q.put((_map(_host_copy, tree), step))

    def wait(self) -> None:
        """Block until every queued write is done."""
        self._q.join()
        if self._err:
            raise self._err

    def close(self) -> None:
        """Wait, then stop the writer."""
        self.wait()
        self._q.put(None)
        self._thread.join()
