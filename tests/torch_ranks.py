"""Multi-rank runs of the port's CPU tests: a job in ``world`` spawned
ranks over gloo, and JAX runs on fake host devices.

:func:`run_ranks` starts one process per rank (``python torch_ranks.py
<job> <rank> ...``), each with one torch thread, joined through a
``FileStore`` in the test's own directory (no port: parallel test
workers would collide on fixed ones), with a timeout on the process
group's setup and on the whole run.  Each rank pickles its job's result;
:func:`run_ranks` returns them by rank, or raises with the failing
ranks' logs.  A job reads its inputs from the files its arguments name,
so every rank and the JAX run see the same numbers.

:func:`run_jax` runs a script in a subprocess whose JAX has ``n_devices``
fake CPU devices (the dry run's ``XLA_FLAGS``) and returns what the
script pickled to the path in ``sys.argv[1]``.

Run as a script, this module is one rank.  It imports neither JAX nor
the JAX package.
"""
import datetime
import json
import os
import pickle
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")


def _env(extra=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + (os.pathsep + env["PYTHONPATH"]
                               if env.get("PYTHONPATH") else "")
    env["OMP_NUM_THREADS"] = "1"
    env.update(extra or {})
    return env


def run_ranks(job, world, workdir, args=None, timeout=240.0):
    """Run ``job`` in ``world`` ranks; returns each rank's result."""
    out = os.path.join(str(workdir), job)
    os.makedirs(out)
    store = os.path.join(out, "store")
    procs, logs = [], []
    try:
        for r in range(world):
            log = open(os.path.join(out, f"{r}.log"), "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), job, str(r),
                 str(world), store, out, json.dumps(args or {})],
                env=_env(), stdout=log, stderr=subprocess.STDOUT,
                cwd=REPO))
        deadline = time.monotonic() + timeout
        for p in procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"{job}: the ranks did not finish in "
                                     f"{timeout:.0f} s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        tails = []
        for r in bad[:2]:
            with open(os.path.join(out, f"{r}.log")) as f:
                tails.append(f"rank {r}:\n{f.read()[-3000:]}")
        raise AssertionError(f"{job}: ranks {bad} failed\n"
                             + "\n".join(tails))
    results = []
    for r in range(world):
        with open(os.path.join(out, f"{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


def run_jax(script, workdir, n_devices, timeout=400.0):
    """Run ``script`` under JAX with ``n_devices`` fake CPU devices;
    returns what it pickled to ``sys.argv[1]``."""
    path = os.path.join(str(workdir), "jax_result.pkl")
    head = ("import os\nos.environ['XLA_FLAGS'] = "
            f"'--xla_force_host_platform_device_count={n_devices}'\n")
    r = subprocess.run([sys.executable, "-c", head + script, path],
                       env=_env({"JAX_PLATFORMS": "cpu"}), cwd=REPO,
                       capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0 and os.path.exists(path), \
        r.stdout[-2000:] + r.stderr[-3000:]
    with open(path, "rb") as f:
        return pickle.load(f)


# ---------------------------------------------------------------------------
# Jobs: (rank, world, args) -> a picklable result
# ---------------------------------------------------------------------------

def _mesh(shape, names):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))


def job_hierarchical(rank, world, args):
    """``hierarchical_psum_mean`` of this rank's rows of the inputs: each
    case's (mean, err) per step."""
    import numpy as np
    import torch

    from repro_torch.optim.compression import hierarchical_psum_mean
    data = np.load(args["inputs"])
    out = {}
    for case in args["cases"]:
        mesh = _mesh(case["mesh"], case["names"])
        xs = data[case["name"]]                  # [steps, world, ...]
        err = (torch.zeros(case["err"], dtype=torch.float32)
               if case["err"] else None)
        got = []
        for t in range(xs.shape[0]):
            x = torch.from_numpy(np.array(xs[t, rank]))
            m, err = hierarchical_psum_mean(x, mesh, tuple(case["intra"]),
                                            case["inter"], err=err)
            got.append((m.numpy(), None if err is None else err.numpy()))
        out[case["name"]] = got
    return out


def job_distribute(rank, world, args):
    """Each case's local block of ``distribute`` over its mesh, and the
    message of each "raising" case's error."""
    import numpy as np
    import torch

    from repro_torch.parallel.sharding import Spec, distribute
    meshes = {}

    def place(case):
        key = tuple(case["names"])
        if key not in meshes:
            meshes[key] = _mesh(case["mesh"], case["names"])
        x = torch.arange(int(np.prod(case["shape"])), dtype=torch.float32
                         ).reshape(case["shape"])
        spec = Spec(*[tuple(e) if isinstance(e, list) else e
                      for e in case["spec"]])
        return distribute({"x": x}, {"x": spec}, meshes[key])["x"]

    raised = []
    for case in args.get("raising", ()):
        try:
            place(case)
        except ValueError as e:
            raised.append(str(e))
    return {"blocks": [place(c).to_local().numpy() for c in args["cases"]],
            "raised": raised}


def _elastic_tree(torch):
    x = torch.arange(64, dtype=torch.float32).reshape(8, 8) * 0.37
    y = (torch.arange(24, dtype=torch.float32).reshape(8, 3) - 7.5
         ).to(torch.bfloat16)
    return {"x": x, "y": y, "step": torch.tensor(11, dtype=torch.int32)}


def job_elastic_save(rank, world, args):
    """Save the tree from a ``world``-rank mesh: ``x`` and ``y`` as
    DTensors sharded by rows, the step a plain tensor."""
    import torch
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.checkpoint import pytree
    mesh = _mesh((world,), ("data",))
    tree = _elastic_tree(torch)
    for k in ("x", "y"):
        tree[k] = distribute_tensor(tree[k], mesh, [Shard(0)])
    path = pytree.save_pytree(tree, args["dir"], 1)
    return {"path": path, "local_x": tree["x"].to_local().numpy()}


def job_elastic_restore(rank, world, args):
    """Restore the tree onto a ``world``-rank mesh by rows."""
    import torch

    from repro_torch.checkpoint import pytree
    from repro_torch.parallel.sharding import Sharding, Spec
    mesh = _mesh((world,), ("data",))
    like = {k: torch.zeros_like(v) for k, v in _elastic_tree(torch).items()}
    rows = Sharding(mesh, Spec("data", None))
    shardings = {"x": rows, "y": rows, "step": Sharding(mesh, Spec())}
    got = pytree.restore_pytree(like, args["dir"], shardings=shardings)
    view = torch.int16
    return {k: {"local": (v.to_local().view(view) if v.dtype ==
                          torch.bfloat16 else v.to_local()).numpy(),
                "full": (v.full_tensor().view(view) if v.dtype ==
                         torch.bfloat16 else v.full_tensor()).numpy(),
                "placements": [(type(p).__name__, getattr(p, "dim", None))
                               for p in v.placements],
                "dtype": str(v.dtype)}
            for k, v in got.items()}


JOBS = {"hierarchical": job_hierarchical, "distribute": job_distribute,
        "elastic_save": job_elastic_save,
        "elastic_restore": job_elastic_restore}


def main(argv):
    job, rank, world, store, out, args = argv
    rank, world = int(rank), int(world)
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=90))
    try:
        result = JOBS[job](rank, world, json.loads(args))
    finally:
        dist.destroy_process_group()
    tmp = os.path.join(out, f"{rank}.pkl.tmp")
    with open(tmp, "wb") as f:
        pickle.dump(result, f)
    os.replace(tmp, os.path.join(out, f"{rank}.pkl"))


if __name__ == "__main__":
    main(sys.argv[1:])
