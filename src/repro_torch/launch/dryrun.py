"""Dry run of the registered cells: build each cell's inputs on the card
from a seed, run it once, and report what it took.

    python -m repro_torch.launch.dryrun --arch tifu-knn --shape serve_topk
    python -m repro_torch.launch.dryrun --all [--out results.json]
    python -m repro_torch.launch.dryrun --mesh 2,4 --smoke --device cpu \
        --arch dlrm-mlperf

The port's counterpart of the JAX package's ``launch/dryrun.py``.  PyTorch
has no lower-and-compile step, so a cell is measured by running it:
``run_cell`` reports the cell's description and cuts (``reduced``), its
model FLOPs, the seconds its inputs took to build and the seconds of
one run (host clock, ended by a device synchronize), the achieved
model FLOP/s, and on a CUDA card the peak bytes
(``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats``,
inputs included) and whether they fit the card's memory
(``torch.cuda.mem_get_info``), beside the peak the cut rule estimated
for the sizes it chose (``estimate_bytes``, ``configs/base.py``; a run
on the card checks it).  On the CPU (``device="cpu"``, the tests)
the measured memory fields are ``None``: a CPU run measures no device
memory.  Cells run on the card unless the caller names another device.

The cell is then freed, built again from the same seed and run once
more under ``launch/cost.py``'s ``CostCounter`` (the counterpart of the
JAX dry run's ``extract_hlo=True``), so
the counted run sees the same call also where a cell changes its state
(``stream_update``, the train steps).  That adds the JAX dry run's
roofline fields: ``roofline`` (``launch/roofline.py``'s terms on the
H100's peaks: compute, memory and collective seconds, the bottleneck,
FLOPs by dtype), ``chips`` (1), ``model_flops_per_device`` and
``useful_flops_ratio`` (model FLOPs over counted FLOPs).  On the CPU the
counts are the same; the terms are the card's, not the CPU's.

The mesh route (``--mesh D,M``; the JAX dry run's ``in_shardings`` on a
mesh): the cells of the LM, recommender, GNN and tifu families run in
``D·M`` rank processes on the ("data", "model") mesh with the batch and FSDP
over "data" (:func:`no_mesh_route` names the cells without one).  The
parent first runs each cell on one device from the same seed and keeps
its outputs on the host (:func:`outputs`), then starts the ranks (over
gloo on the CPU or where the ranks share one card, over NCCL where each
rank has a card), each of which calls
:func:`run_cell_sharded` per cell: the cell built with ``mesh=`` and
placed by its ``in_shardings``, run once (each kernel wrapper's
launches counted), its outputs gathered (a train step's loss, gradient
norm, clipped gradients and parameters after it; a ``stream_update``'s
state), then counted once more under the ``CostCounter`` (the rank's FLOPs, HBM bytes and
``torch.distributed`` collective bytes by kind).  The parent prints
one row a rank (seconds, peak, collective bytes by kind; ``fits``: the
rank's peak within its card, or the sum of the ranks' peaks within the
card they share) and holds each cell's gathered outputs to the
one-device run's (:func:`held`).  ``--smoke`` runs every cell at
``configs.smoke_sizes``.  A failed rank fails the run; a rank never
moves to the CPU (ranks run on CUDA unless ``--device cpu``).
tifu-knn's cells take the route as the JAX cells take their
``in_shardings``: ``stream_update``'s state with users over "data" and
the vector tables' items over "model", each rank applying its users'
rows of the gathered micro-batch on its own columns; the serve cells
through B3 on each rank's rows and the merge over "model", then "data".
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import pickle
import subprocess
import sys
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import all_cells, get_arch, smoke_sizes
from repro_torch.configs.base import CellProgram
from repro_torch.core.types import StreamState, resolve_device
from repro_torch.kernels import build
from repro_torch.launch import roofline
from repro_torch.launch.cost import CostCounter, Costs


def _gib(n_bytes: Optional[float]) -> str:
    return "none" if n_bytes is None else f"{n_bytes / 2 ** 30:.2f} GiB"


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def build_cell(arch_name: str, shape: str, device: Any = None,
               seed: int = 0, sizes: Any = None
               ) -> Tuple[CellProgram, float]:
    """The cell's program with its inputs built on ``device`` from
    ``seed``, and the build's seconds.  On CUDA the peak memory counter
    is reset first, so :func:`run_program`'s peak holds the inputs."""
    dev = resolve_device(device)
    builder = get_arch(arch_name).cells[shape]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    prog = builder(device, seed, sizes)
    _sync(dev)
    return prog, time.perf_counter() - t0


def run_program(prog: CellProgram, device: Any = None
                ) -> Tuple[Dict[str, Any], Any]:
    """Run ``prog`` once; returns (readings, its output)."""
    dev = resolve_device(device)
    _sync(dev)
    t0 = time.perf_counter()
    out = prog.fn(*prog.args)
    _sync(dev)
    seconds = time.perf_counter() - t0
    peak = total = None
    if dev.type == "cuda":
        peak = torch.cuda.max_memory_allocated(dev)
        total = torch.cuda.mem_get_info(dev)[1]
    return {
        "description": prog.description,
        "reduced": dict(prog.reduced),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
        "run_s": seconds,
        "model_flops": prog.model_flops_per_step,
        "model_flops_per_s": prog.model_flops_per_step / seconds
        if seconds > 0 else None,
        "peak_bytes": peak,
        "estimate_bytes": prog.estimate_bytes,
        "device_bytes": total,
        "fits": None if peak is None else bool(peak <= total),
    }, out


def count_program(prog: CellProgram, device: Any = None) -> Costs:
    """Run ``prog`` once under a ``CostCounter`` on ``device``; returns
    the work it dispatched."""
    dev = resolve_device(device)
    _sync(dev)
    with CostCounter(dev) as counter:
        prog.fn(*prog.args)
    _sync(dev)
    return counter.costs


def roofline_fields(costs: Costs, model_flops: float,
                    chips: int = 1) -> Dict[str, Any]:
    """The JAX dry run's roofline fields of a counted run (one rank's of
    ``chips``: the model FLOPs a device is its share of the step's;
    ``useful_flops_ratio`` ``None`` where nothing was counted)."""
    terms = roofline.analyze(costs, chips=chips)
    per_device = model_flops / chips
    return {"roofline": terms.as_dict(), "chips": chips,
            "model_flops_per_device": per_device,
            "useful_flops_ratio": per_device / terms.flops
            if terms.flops else None}


def t_bound(fields: Dict[str, Any]) -> float:
    """The largest roofline term of ``roofline_fields``' output, s."""
    rt = fields["roofline"]
    return max(rt["t_compute_s"], rt["t_memory_s"], rt["t_collective_s"])


def run_cell(arch_name: str, shape: str, device: Any = None, seed: int = 0,
             sizes: Any = None) -> Dict[str, Any]:
    """Build the cell on ``device`` (the card by default) and run it
    once, then build it again and count a second run; returns its
    readings (see the module docstring)."""
    dev = resolve_device(device)
    prog, build_s = build_cell(arch_name, shape, dev, seed, sizes)
    result, out = run_program(prog, dev)
    del prog, out
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    prog, _ = build_cell(arch_name, shape, dev, seed, sizes)
    costs = count_program(prog, dev)
    return {"arch": arch_name, "shape": shape, "build_s": build_s,
            **result, **roofline_fields(costs, result["model_flops"])}


# ---------------------------------------------------------------------------
# The mesh route
# ---------------------------------------------------------------------------

MESH_AXES = ("data", "model")
# families with a mesh route
MESH_FAMILIES = ("lm", "recsys", "gnn", "tifu")
# a rank's process group: its setup and each collective's timeout (s)
GROUP_TIMEOUT_S = 90.0


def no_mesh_route(arch_name: str, shape: str, model_axis: int = 1,
                  sizes: Any = None) -> Optional[str]:
    """Why cell (``arch_name``, ``shape``) at ``sizes`` (the published
    ones by default) has no mesh route on a mesh whose "model" axis has
    ``model_axis`` ranks, or ``None`` where it has one."""
    arch = get_arch(arch_name)
    cell = arch.cells[shape]
    if arch.family not in MESH_FAMILIES:
        return f"the {arch.family} family has no mesh route"
    if arch.family != "lm":
        return None
    c = (cell.published if sizes is None else sizes).config
    if c.n_heads % model_axis:
        return (f"its {c.n_heads} heads do not divide the model axis "
                f"({model_axis}): the sharded LM splits attention by head")
    return None


def mesh_sizes(arch_name: str, shape: str, smoke: bool,
               device: Any = None) -> Any:
    """The sizes a cell runs at on the mesh route and in its one-device
    twin: ``configs.smoke_sizes`` with ``smoke``, else the cut rule's
    (``None``).  A MoE model runs at the capacity factor that drops no
    assignment: under a mesh the capacity comes from each data shard's
    tokens, so only such a factor gives the one-device answer."""
    import dataclasses

    from repro_torch.configs.base import card_bytes
    arch = get_arch(arch_name)
    cell = arch.cells[shape]
    sizes = smoke_sizes(arch_name, shape) if smoke else None
    if arch.family != "lm" or not getattr(
            (cell.published if sizes is None else sizes).config, "moe",
            False):
        return sizes
    if sizes is None:
        sizes = cell.choose(card_bytes(resolve_device(device)))[0]
    c = sizes.config
    return dataclasses.replace(sizes, config=dataclasses.replace(
        c, capacity_factor=c.e_pad / c.top_k))


def mesh_rules() -> Any:
    """The mesh route's rules: the batch and FSDP over "data", the
    tensor, expert and context axes "model"."""
    from repro_torch.parallel.sharding import ShardingRules
    return ShardingRules(batch=("data",), fsdp=("data",))


def _host(x: Any) -> torch.Tensor:
    """A DTensor's global value (gathered) or a tensor, on the host."""
    from repro_torch.parallel import spmd
    return spmd.gather_full(x.detach()).cpu()


def outputs(prog: CellProgram, out: Any,
            probes: Optional[Dict[str, np.ndarray]] = None) -> Any:
    """What a cell's run is compared by, on the host, whole (DTensors
    gathered): a train step's ``{"loss", "gnorm", "grads", "params"}``
    (the gradient's global norm before the clip, each gradient as the
    step applied it, clipped, and the parameters after the step; those
    named in ``probes`` as their rows at its global row ids only), a
    ``StreamState`` after the micro-batch (with ``probes["users"]``, each
    leaf at those users' rows only), an LM prefill's or decode's logits,
    else the output (a tensor or a tuple of them).  On a mesh every rank
    must call it (the gathers are collectives)."""
    if isinstance(out, dict) and "loss" in out:
        def whole(name, t):
            if probes and name in probes:
                return rows_at(t, probes[name], prog.mesh)
            return _host(t)
        named = list(prog.args[0].named_parameters())
        return {"loss": float(out["loss"]),
                "gnorm": float(prog.fn.optimizer.last_gnorm),
                "grads": {name: whole(name, p.grad) for name, p in named
                          if p.grad is not None},
                "params": {name: whole(name, p) for name, p in named}}
    if isinstance(out, StreamState):
        users = (probes or {}).get("users")
        return StreamState(**{
            f.name: _host(getattr(out, f.name)) if users is None else
            rows_at(getattr(out, f.name), users, prog.mesh)
            for f in dataclasses.fields(out)})
    if isinstance(out, tuple) and len(out) == 2 and isinstance(out[1], dict):
        out = out[0]                          # (logits, caches)
    if isinstance(out, (tuple, list)):
        return tuple(_host(x) for x in out)
    return _host(out)


def rows_at(x: Any, ids: Any, mesh: Any) -> torch.Tensor:
    """Rows ``ids`` (global) of ``x``, whole, on the host.  A DTensor's
    (rows over any axes, its other dims in any layout): each rank takes
    the rows its block holds and zeros for the rest, summed over the row
    axes (one rank adds each row, so the sum is exact), then the other
    dims gathered; every rank must call it."""
    from torch.distributed.tensor import DTensor

    from repro_torch.parallel import spmd
    from repro_torch.parallel.sharding import Spec
    with torch.no_grad():
        local = spmd.local(x.detach())
        rows = torch.as_tensor(np.asarray(ids), dtype=torch.int64,
                               device=local.device)
        if mesh is None or not isinstance(x, DTensor):
            return local[rows].cpu()
        spec = spmd.spec_of(x)
        axes = spec.axes(0)
        at = rows - spmd.axis_index(mesh, axes) * local.shape[0]
        hit = (at >= 0) & (at < local.shape[0])
        part = local[at.clamp(0, local.shape[0] - 1)]
        part = torch.where(hit.view(-1, *(1,) * (part.dim() - 1)), part,
                           torch.zeros_like(part))
        if axes:
            part = spmd.psum(part, mesh, axes)
        rest = Spec(None, *(spec[d] if d < len(spec) else None
                            for d in range(1, part.dim())))
        return spmd.redistribute(part, mesh, rest, Spec()).cpu()


def probe_ids(prog: CellProgram, limit: int,
              k: int) -> Dict[str, np.ndarray]:
    """For a one-device train cell after its step: the global row ids a
    mesh run reports of each parameter of more than ``limit`` elements
    (:func:`outputs`' ``probes``): its first ``k`` rows the step's
    gradient touched and ``k`` seeded others, sorted.  For a
    ``stream_update`` whose vector tables hold more than ``limit``
    elements: ``{"users": ...}``, the first ``k`` users its batches
    name and ``k`` seeded others, sorted."""
    rng = np.random.default_rng(0)
    if isinstance(prog.args[0], StreamState):
        state = prog.args[0]
        if state.user_vecs.numel() <= limit:
            return {}
        named = torch.cat([b.user[b.valid] for b in prog.args[1:]])
        touched = torch.unique(named.long()).cpu().numpy()[:k]
        return {"users": np.unique(np.concatenate(
            [touched, rng.integers(0, state.n_users, k)]))}
    out = {}
    for name, p in prog.args[0].named_parameters():
        if p.numel() <= limit or p.grad is None:
            continue
        g = p.grad.reshape(p.shape[0], -1)
        touched = torch.nonzero((g != 0).any(1)).flatten()[:k].cpu().numpy()
        out[name] = np.unique(np.concatenate(
            [touched, rng.integers(0, p.shape[0], k)]))
    return out


def is_decode(arch_name: str, shape: str) -> bool:
    """Whether the cell is an LM decode step."""
    return getattr(get_arch(arch_name).cells[shape], "kind", "") == "decode"


# a train step's bars: its gradient norm (the training tests'), each
# gradient's error in L2 norm relative to its own, the parameters after
# the step (the training tests')
GNORM_TOL = dict(rtol=1e-4, atol=1e-6)
GRAD_NORM_RTOL = 1e-3
PARAM_TOL = dict(rtol=1e-5, atol=1e-5)
# a stream state's float leaves (the parity bar of the update paths)
STATE_TOL = dict(rtol=1e-4, atol=1e-5)


def grad_error(q: torch.Tensor, p: torch.Tensor) -> float:
    """``‖q − p‖ / ‖p‖`` in float64 (0 where both are 0)."""
    d = float(torch.linalg.vector_norm(q.double() - p.double()))
    n = float(torch.linalg.vector_norm(p.double()))
    if n == 0:
        return 0.0 if d == 0 else float("inf")
    return d / n


def held(one: Any, got: Any, what: str, decode: bool = False) -> str:
    """Hold a mesh run's outputs to the one-device run's (both from
    :func:`outputs`).

    A train step: its loss ``rtol=1e-5, atol=1e-6``; its gradient norm
    ``rtol=1e-4, atol=1e-6``; each clipped gradient within
    ``GRAD_NORM_RTOL`` of the one-device one in L2 norm; its parameters
    ``rtol=1e-5, atol=1e-5``.  At the first step's learning rate, 3e-6,
    the parameters move by less than their bar, so the gradients are what
    shows a wrong step (doubled, or from half the batch: an error of the
    gradient's own size).  The gradients are held in norm, not element by
    element: a ReLU whose input lies within rounding of 0 takes the other
    side when the sharded sums round differently, and moves single
    elements of the layer's gradient by a whole sample's share (on the
    card, two-tower's user tower at 8,192 rows: 109 of user_mlp.w.0's
    524,288 elements past ``rtol=1e-4, atol=1e-6``, by up to 3.1e-6, the
    leaf within 1.8e-4 in norm).

    A ``StreamState``: its integer leaves exact, its float leaves
    ``rtol=1e-4, atol=1e-5``.

    A top-n's (scores f32, ids int) scores ``rtol=1e-5, atol=1e-6`` and
    each id identical or scoring the same within that (0 mismatches);
    any other output ``rtol=1e-5, atol=1e-6``, an LM decode step's logits
    (``decode``) ``rtol=1e-4, atol=1e-4``: they read bf16 caches, whose
    roundings move the sharded sums by ~1e-5 in f32 models (the sharded
    LM tests' bar).  Raises ``AssertionError``; returns the worst
    differences."""
    tol = dict(rtol=1e-4, atol=1e-4) if decode else dict(rtol=1e-5,
                                                          atol=1e-6)
    if isinstance(one, dict):
        torch.testing.assert_close(torch.tensor(got["loss"]),
                                   torch.tensor(one["loss"]), **tol,
                                   msg=lambda m: f"{what}: loss: {m}")
        torch.testing.assert_close(
            torch.tensor(got["gnorm"]), torch.tensor(one["gnorm"]),
            **GNORM_TOL, msg=lambda m: f"{what}: gradient norm: {m}")
        assert set(got["grads"]) == set(one["grads"]), \
            (what, sorted(set(got["grads"]) ^ set(one["grads"])))
        errs = {name: grad_error(got["grads"][name], p)
                for name, p in one["grads"].items()}
        bad = {k: e for k, e in errs.items() if not e <= GRAD_NORM_RTOL}
        assert not bad, f"{what}: gradients off in norm: {bad}"
        worst = 0.0
        for name, p in one["params"].items():
            q = got["params"][name]
            torch.testing.assert_close(
                q, p, **PARAM_TOL, msg=lambda m: f"{what}: {name}: {m}")
            worst = max(worst, float((q.double() - p.double()).abs().max()))
        return (f"loss {got['loss']:.7g} vs {one['loss']:.7g}, gradient "
                f"norm {got['gnorm']:.7g} vs {one['gnorm']:.7g}, "
                f"{len(errs)} gradients within "
                f"{max(errs.values(), default=0.0):.2e} in norm, "
                f"{len(one['params'])} parameters after the step within "
                f"{worst:.2e}")
    if isinstance(one, StreamState):
        worst = 0.0
        for f in dataclasses.fields(one):
            a, b = getattr(got, f.name), getattr(one, f.name)
            if b.dtype.is_floating_point:
                torch.testing.assert_close(
                    a, b, **STATE_TOL, msg=lambda m: f"{what}: {f.name}: {m}")
                worst = max(worst, float((a.double() - b.double()).abs()
                                         .max()) if b.numel() else 0.0)
            else:
                assert a.dtype == b.dtype and torch.equal(a, b), \
                    f"{what}: {f.name} differs"
        return (f"state of {one.n_users:,} users: integer leaves exact, "
                f"float leaves within {worst:.2e}")
    one = one if isinstance(one, tuple) else (one,)
    got = got if isinstance(got, tuple) else (got,)
    if len(one) == 2 and one[1].dtype in (torch.int32, torch.int64):
        (v1, i1), (v2, i2) = one, got
        torch.testing.assert_close(v2, v1, **tol,
                                   msg=lambda m: f"{what}: scores: {m}")
        same = i2.long() == i1.long()
        tie = (v2.double() - v1.double()).abs() <= tol["atol"] \
            + tol["rtol"] * v1.double().abs()
        bad = int((~same & ~tie).sum())
        assert bad == 0, f"{what}: {bad} ids neither equal nor tied"
        return (f"top-{v1.shape[-1]}: {int(same.sum())} of {same.numel()} "
                f"ids identical, the rest tied, 0 mismatches; scores "
                f"within {float((v2 - v1).abs().max()):.2e}")
    worst = 0.0
    for a, b in zip(got, one):
        torch.testing.assert_close(a, b, **tol, msg=lambda m: f"{what}: {m}")
        worst = max(worst, float((a.double() - b.double()).abs().max()))
    return f"output within {worst:.2e}"


def one_device(arch_name: str, shape: str, world: int, device: Any = None,
               seed: int = 0, sizes: Any = None,
               probe: Optional[Tuple[int, int]] = None) -> Tuple[Any, dict]:
    """The one-device twin of a cell's mesh run on ``world`` ranks, by
    :func:`outputs`: the cell from the same seed (a DimeNet graph in the
    ``world`` equal partitions the ranks take, globalized), run once.
    Returns (the outputs, the probe rows): with ``probe`` (``limit``,
    ``k``) a train cell's parameters and gradients of more than
    ``limit`` elements are reported at :func:`probe_ids`' rows only."""
    dev = resolve_device(device)
    cell = get_arch(arch_name).cells[shape]
    parts = world if get_arch(arch_name).family == "gnn" else None
    prog = cell(dev, seed, sizes, partitions=parts)
    out = prog.fn(*prog.args)
    probes = probe_ids(prog, *probe) if probe and isinstance(
        out, (dict, StreamState)) else {}
    return outputs(prog, out, probes), probes


def run_cell_sharded(arch_name: str, shape: str, mesh: Any, rules: Any,
                     device: Any = None, seed: int = 0, sizes: Any = None,
                     keep: Optional[Callable] = None,
                     turns: bool = False) -> Dict[str, Any]:
    """Cell (``arch_name``, ``shape``) on this rank of the process group
    that is up, over the named ``DeviceMesh`` ``mesh``: built with
    ``mesh=``, ``rules=`` (placed by its ``in_shardings``), run once
    and once more under the ``CostCounter``.  Returns
    this rank's readings: ``build_s``, ``run_s``, ``peak_bytes`` (the
    peak from the placed inputs on, inputs included; the build's whole
    copies freed before), ``launches`` (each kernel wrapper's launches
    in the first run: ``build.launch_counts`` set to 0 just before it
    and read just after), the local ``output``, ``kept`` (``keep(prog,
    out)`` after the first run, before the counted one: what a train
    step left), ``costs`` and the roofline fields per rank.
    ``turns``: the ranks build one at a time
    (each builds the whole model before it keeps its blocks, so ranks
    that share a card hold one whole copy at a time)."""
    import torch.distributed as dist
    why = no_mesh_route(arch_name, shape,
                        dict(zip(mesh.mesh_dim_names, mesh.shape))["model"],
                        sizes)
    if why:
        raise ValueError(f"{arch_name} x {shape} has no mesh route: {why}")
    dev = resolve_device(device)
    world = dist.get_world_size()
    t0 = time.perf_counter()
    for turn in range(world if turns else 1):
        if not turns or turn == dist.get_rank():
            prog = get_arch(arch_name).cells[shape](dev, seed, sizes,
                                                    mesh=mesh, rules=rules)
            _sync(dev)
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        if turns:
            dist.barrier()
    build_s = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    build.reset_launch_counts()
    result, out = run_program(prog, dev)
    result.update(launches=dict(build.launch_counts))
    result.update(arch=arch_name, shape=shape, build_s=build_s,
                  rank=dist.get_rank(), world=world,
                  mesh=dict(zip(mesh.mesh_dim_names, mesh.shape)),
                  output=out,
                  kept=None if keep is None else keep(prog, out))
    costs = count_program(prog, dev)
    result.update(costs=costs, coll=dict(costs.coll),
                  **roofline_fields(costs, result["model_flops"], world))
    return result


def _rank_main(rank: int, world: int, store: str, outdir: str,
               spec: Dict[str, Any]) -> None:
    """One rank of ``--mesh``: its process group, the mesh, each cell by
    :func:`run_cell_sharded`; pickles its readings to ``outdir`` (rank 0
    with each cell's gathered outputs; every rank with ``b3_call``, the
    first run's first ``ops.knn_topk`` call beside its plain version on
    the same inputs, where the cell makes one: :func:`b3_plain`)."""
    import datetime

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dev = torch.device(spec["device"])
    nccl = dev.type == "cuda" and torch.cuda.device_count() >= world
    if dev.type == "cuda":
        dev = torch.device("cuda", rank if nccl else 0)
        torch.cuda.set_device(dev)
    dist.init_process_group(
        "nccl" if nccl else "gloo", store=dist.FileStore(store, world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    mesh = init_device_mesh(dev.type, tuple(spec["mesh"]),
                            mesh_dim_names=MESH_AXES)
    given = None
    if spec["sizes"]:
        with open(spec["sizes"], "rb") as f:
            given = pickle.load(f)
    rows = []
    try:
        for name, shape in spec["cells"]:
            tag = f"{name} x {shape}"
            sizes = (mesh_sizes(name, shape, spec["smoke"], dev)
                     if given is None else given[tag])
            probes = spec["probes"].get(tag)
            calls: list = []
            with recorded_b3(calls):
                r = run_cell_sharded(
                    name, shape, mesh, mesh_rules(), dev, spec["seed"],
                    sizes, keep=lambda prog, out: outputs(prog, out, probes),
                    turns=tag in spec["turns"])
            r["b3_call"] = b3_plain(calls[0]) if calls else None
            del calls
            r.pop("output")
            r.pop("costs")
            if rank:
                r.pop("kept")
            rows.append(r)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    tmp = os.path.join(outdir, f"rank{rank}.pkl.tmp")
    with open(tmp, "wb") as f:
        pickle.dump(rows, f)
    os.replace(tmp, os.path.join(outdir, f"rank{rank}.pkl"))


@contextlib.contextmanager
def recorded_b3(calls: list):
    """``ops.knn_topk`` (B3) with its first call kept in ``calls``:
    (queries, corpus, k, metric, query_gids, (scores, ids)), the inputs
    where they lie (no copy), what :func:`b3_plain` holds against the
    plain version on the same block."""
    from repro_torch.kernels import ops
    real = ops.knn_topk

    def rec(queries, corpus, k, *args, **kw):
        out = real(queries, corpus, k, *args, **kw)
        if not calls:
            calls.append((queries.detach(), corpus.detach(), k,
                          kw.get("metric", "euclidean"),
                          kw.get("query_gids"), out))
        return out
    ops.knn_topk = rec
    try:
        yield calls
    finally:
        ops.knn_topk = real


def b3_plain(call: tuple) -> dict:
    """A :func:`recorded_b3` call beside B3's plain version
    (``ref.knn_topk_ref``) on the same inputs on the same device: ``k``,
    ``metric``, the block's ``rows`` and ``dim``, and both answers
    (``out``, ``plain``: (scores, ids)) on the host, what a caller holds
    one against the other."""
    from repro_torch.kernels import ref
    queries, corpus, k, metric, gids, out = call
    plain = ref.knn_topk_ref(queries, corpus, k, metric=metric,
                             query_gids=gids)
    return {"k": k, "metric": metric, "rows": corpus.shape[0],
            "dim": corpus.shape[1], "out": tuple(t.cpu() for t in out),
            "plain": tuple(t.cpu() for t in plain)}


def run_ranks(cells: List[Tuple[str, str]], mesh: Tuple[int, int],
              outdir: str, device: str = "cuda", smoke: bool = False,
              seed: int = 0, probes: Optional[dict] = None,
              timeout: float = 1200.0, sizes: Optional[dict] = None,
              turns: Optional[List[str]] = None
              ) -> List[List[Dict[str, Any]]]:
    """Start the ``D·M`` rank processes of ``--mesh`` on ``cells`` (a
    ``FileStore`` and each rank's log under ``outdir``) and wait; returns
    each rank's readings by rank.  Raises with the failing ranks' log
    tails where any rank fails or the run outlasts ``timeout``.
    ``sizes``: each cell's sizes by ``"arch x shape"`` (default
    :func:`mesh_sizes`'); ``probes`` likewise, :func:`probe_ids`' rows;
    ``turns``: the cells built in turns.  Each rank is ``dryrun
    --mesh-rank`` with five arguments (rank, world, store, ``outdir``,
    the spec as JSON)."""
    world = int(np.prod(mesh))
    os.makedirs(outdir, exist_ok=True)
    store = os.path.join(outdir, "store")
    if os.path.exists(store):
        os.remove(store)
    path = None
    if sizes is not None:
        path = os.path.join(outdir, "sizes.pkl")
        with open(path, "wb") as f:
            pickle.dump(sizes, f)
    spec = json.dumps({"cells": cells, "mesh": list(mesh), "device": device,
                       "smoke": smoke, "seed": seed, "sizes": path,
                       "turns": list(turns or []),
                       "probes": {k: {n: [int(i) for i in ids]
                                      for n, ids in v.items()}
                                  for k, v in (probes or {}).items()}})
    command = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--mesh-rank"]
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"]
                               if env.get("PYTHONPATH") else "")
    procs, logs = [], []
    try:
        for r in range(world):
            logs.append(open(os.path.join(outdir, f"rank{r}.log"), "w"))
            procs.append(subprocess.Popen(
                command + [str(r), str(world), store, outdir, spec],
                env=env, stdout=logs[-1], stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"the {world} ranks did not finish in "
                             f"{timeout:.0f} s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        tails = []
        for r in bad[:2]:
            with open(os.path.join(outdir, f"rank{r}.log")) as f:
                tails.append(f"rank {r}:\n{f.read()[-3000:]}")
        raise AssertionError(f"ranks {bad} failed\n" + "\n".join(tails))
    out = []
    for r in range(world):
        with open(os.path.join(outdir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _bytes_str(coll: Dict[str, float]) -> str:
    return ", ".join(f"{k} {v:,.0f} B" for k, v in
                     sorted(coll.items())) or "none"


def rank_rows(per_rank: List[Dict[str, Any]], shared_card: bool) -> str:
    """One cell's line a rank: seconds, peak, collective bytes by kind;
    and ``fits`` (each rank's peak within its card, or with
    ``shared_card`` the sum of the ranks' peaks within the one card)."""
    peaks = [r["peak_bytes"] for r in per_rank]
    total = per_rank[0]["device_bytes"]
    if peaks[0] is None:
        fits = None
    elif shared_card:
        fits = sum(peaks) <= total
    else:
        fits = all(p <= total for p in peaks)
    lines = [f"    rank {r['rank']}: run {r['run_s']:.4f} s, peak "
             f"{_gib(r['peak_bytes'])}, collectives "
             f"{_bytes_str(r.get('coll', {}))}" for r in per_rank]
    lines.append(f"    fits {fits}" + (" (the ranks' peaks summed on one "
                                       "card)" if shared_card else ""))
    return "\n".join(lines)


def _mesh_main(args, cells: List[Tuple[str, str]]) -> int:
    """``--mesh``: the one-device runs, then the ranks, then each cell's
    rows and its outputs held to the one-device run's."""
    import tempfile
    mesh = tuple(int(x) for x in args.mesh.split(","))
    if len(mesh) != 2:
        raise SystemExit("--mesh takes D,M: the (\"data\", \"model\") sizes")
    def why(n, s):
        return no_mesh_route(n, s, mesh[1],
                             mesh_sizes(n, s, args.smoke, args.device))
    for n, s in cells:
        if why(n, s):
            print(f"[SKIP] {n} x {s}: {why(n, s)}", flush=True)
    cells = [(n, s) for n, s in cells if not why(n, s)]
    dev = resolve_device(args.device)
    world = int(np.prod(mesh))
    one = {}
    for name, shape in cells:
        one[(name, shape)] = one_device(
            name, shape, world, dev, 0,
            mesh_sizes(name, shape, args.smoke, dev))[0]
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    shared = dev.type == "cuda" and torch.cuda.device_count() < world
    with tempfile.TemporaryDirectory() as d:
        ranks = run_ranks(cells, mesh, d, dev.type, args.smoke)
    n_ok = 0
    results = []
    for i, (name, shape) in enumerate(cells):
        per = [rank[i] for rank in ranks]
        tag = f"{name} x {shape}"
        try:
            how = held(one[(name, shape)], per[0]["kept"], tag,
                       decode=is_decode(name, shape))
            n_ok += 1
            print(f"[OK] {tag} on the {mesh} mesh: {per[0]['description']};"
                  f" against the one-device run: {how}", flush=True)
        except AssertionError as e:
            print(f"[FAIL] {tag}: {e}", flush=True)
        print(rank_rows(per, shared), flush=True)
        results.append({"arch": name, "shape": shape, "ranks": [
            {k: v for k, v in r.items() if k not in ("kept", "b3_call")}
            for r in per]})
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1, default=str)
    print(f"{n_ok}/{len(cells)} cells passed on the {mesh} mesh")
    return 0 if n_ok == len(cells) else 1


def main(argv: Optional[list] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--mesh-rank"]:
        rank, world, store, outdir, spec = argv[1:6]
        _rank_main(int(rank), int(world), store, outdir, json.loads(spec))
        return 0
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--mesh", type=str, default=None,
                    help="D,M: run on the (data, model) mesh in D·M ranks")
    ap.add_argument("--smoke", action="store_true",
                    help="every cell at configs.smoke_sizes")
    ap.add_argument("--device", type=str, default=None,
                    help="cpu for a run without a card (CUDA by default)")
    args = ap.parse_args(argv)
    if args.all:
        cells = list(all_cells())
    elif args.arch is None:
        ap.error("give --arch (and --shape) or --all")
    else:
        shapes = ([args.shape] if args.shape
                  else list(get_arch(args.arch).cells))
        cells = [(args.arch, s) for s in shapes]
    if args.mesh:
        return _mesh_main(args, cells)

    results = []
    for name, shape in cells:
        tag = f"{name} x {shape}"
        try:
            r = run_cell(name, shape, args.device,
                         sizes=smoke_sizes(name, shape) if args.smoke
                         else None)
            rt = r["roofline"]
            print(f"[OK] {tag}: {r['description']}; build {r['build_s']:.2f}"
                  f" s, run {r['run_s']:.4f} s, "
                  f"{r['model_flops_per_s']:.4g} model FLOP/s, peak "
                  f"{_gib(r['peak_bytes'])} (estimate "
                  f"{_gib(r['estimate_bytes'])}) of "
                  f"{_gib(r['device_bytes'])} (fits {r['fits']}) "
                  f"on {r['device']}; cuts {r['reduced'] or 'none'}; "
                  f"t_comp={rt['t_compute_s']:.2e}s "
                  f"t_mem={rt['t_memory_s']:.2e}s "
                  f"t_coll={rt['t_collective_s']:.2e}s "
                  f"bound={rt['bottleneck']} "
                  f"t_bound/run={t_bound(r) / r['run_s']:.3f}", flush=True)
        except Exception as e:  # noqa: BLE001 -- reported, the next cell runs
            r = {"arch": name, "shape": shape,
                 "error": f"{type(e).__name__}: {e}",
                 "traceback": traceback.format_exc()[-2000:]}
            print(f"[FAIL] {tag}: {type(e).__name__}: {e}", flush=True)
        results.append(r)
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1, default=str)
        print(f"wrote {args.out}")
    n_ok = sum(1 for r in results if "error" not in r)
    print(f"{n_ok}/{len(results)} cells passed")
    return 0 if n_ok == len(results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
