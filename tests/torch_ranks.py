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
script pickled to the path in ``sys.argv[1]``.  :func:`started` runs
either in a thread, so a test's ranks and its JAX run overlap.

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


def started(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` in a thread (rank jobs and JAX runs wait on
    subprocesses, so they overlap); the returned function joins it and
    returns its result or raises its exception."""
    import threading
    out = {}

    def run():
        try:
            out["value"] = fn(*args, **kwargs)
        except BaseException as e:          # re-raised by the join
            out["error"] = e
    thread = threading.Thread(target=run)
    thread.start()

    def join():
        thread.join()
        if "error" in out:
            raise out["error"]
        return out["value"]
    return join


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


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def job_sharded_lm(rank, world, args):
    """Each case's LM (the JAX parameter tree pickled at ``params``, its
    port config ``config``), its parameters placed by ``param_pspecs``:
    the sharded forward's hidden states, prefill and decode logits,
    step-1 gradients and ``steps`` AdamW steps (losses, pre-clip norms,
    the parameters after), each gathered whole, and this rank's blocks'
    own gradient norm."""
    import numpy as np
    import torch

    from repro_torch import convert
    from repro_torch.models import transformer as tf
    from repro_torch.optim import optimizers
    from repro_torch.parallel import spmd
    from repro_torch.parallel.sharding import MeshShape, ShardingRules
    mesh = _mesh(args["mesh"], args["names"])
    rules = ShardingRules(batch=("data",), fsdp=("data",))
    out = {}
    for case in args["cases"]:
        c = tf.TransformerConfig(**case["config"], dtype=torch.float32)
        model = convert.transformer_params_from_numpy(
            _load(case["params"]), c, device="cpu")
        spmd.shard_module(model, mesh, tf.param_pspecs(
            c, MeshShape(tuple(args["names"]), tuple(args["mesh"])), rules))
        data = np.load(case["inputs"])
        tokens = torch.from_numpy(data["tokens"]).long()
        b, s = tokens.shape
        got = {}
        with torch.no_grad():
            x, _ = model(tokens, mesh=mesh, rules=rules)
            got["hidden"] = spmd.gather_full(spmd.from_local(
                x, mesh, tf._hspec(mesh, rules, b, s))).numpy()
            logits, caches = model.prefill(tokens, case["max_len"], mesh,
                                           rules)
            got["prefill"] = spmd.gather_full(logits).numpy()
            got["decode"] = []
            for i in range(data["next"].shape[1]):
                tok = torch.from_numpy(data["next"][:, i:i + 1]).long()
                logits, caches = model.decode_step(caches, tok, s + i, mesh,
                                                   rules)
                got["decode"].append(spmd.gather_full(logits).numpy())
        out[case["name"]] = got
        if not case["steps"]:
            continue
        opt = optimizers.adamw(model.parameters(), **case["opt"])
        batch = {"tokens": tokens,
                 "labels": torch.from_numpy(data["labels"]).long()}
        opt.zero_grad(set_to_none=True)
        tf.lm_loss(model, batch, c, mesh, rules).backward()
        got["grads"] = {k: spmd.gather_full(p.grad).numpy()
                        for k, p in model.named_parameters()}
        got["local_norm"] = float(torch.sqrt(sum(
            torch.sum(torch.square(p.grad.to_local()))
            for p in model.parameters())))
        step = tf.make_train_step(c, opt, mesh, rules)
        got["losses"], got["gnorms"] = [], []
        for _ in range(case["steps"]):
            got["losses"].append(float(step(model, batch)["loss"]))
            got["gnorms"].append(float(opt.last_gnorm))
        got["params"] = {k: spmd.gather_full(p.detach()).numpy()
                         for k, p in model.named_parameters()}
    return out


def _spec(entries):
    from repro_torch.parallel.sharding import Spec
    return Spec(*[tuple(e) if isinstance(e, list) else e for e in entries])


def _global_leaf(a):
    import numpy as np
    import torch
    return torch.from_numpy(np.array(a)).requires_grad_()


def job_sharded_moe(rank, world, args):
    """``moe_block`` under the mesh on DTensors placed by the reference
    test's specs, per capacity factor: the output, the gradients of
    ``sum(sin(out))`` with respect to x and each weight (whole), and the
    (token, k) assignments to this rank's experts that were dropped."""
    import dataclasses
    import types

    import numpy as np
    import torch

    from repro_torch.models import transformer as tf
    from repro_torch.parallel import spmd
    from repro_torch.parallel.sharding import ShardingRules
    mesh = _mesh(args["mesh"], args["names"])
    rules = ShardingRules(batch=("data",), fsdp=("data",))
    data = np.load(args["inputs"])
    c0 = tf.TransformerConfig(**args["config"], dtype=torch.float32)
    dropped = []
    real = tf.dispatch_slots

    def counting(experts, n_local, expert_offset, capacity):
        keep, slot = real(experts, n_local, expert_offset, capacity)
        flat = experts.reshape(-1)
        local = (flat >= expert_offset) & (flat < expert_offset + n_local)
        dropped.append(int((local & ~keep).sum()))
        return keep, slot
    tf.dispatch_slots = counting
    out = {}
    for cf in args["factors"]:
        c = dataclasses.replace(c0, capacity_factor=cf)
        dropped.clear()
        x = _global_leaf(data["x"])
        leaves = {k: _global_leaf(data[k]) for k in args["specs"]}
        layer = types.SimpleNamespace(**{
            k: spmd.constrain(v, mesh, _spec(args["specs"][k]))
            for k, v in leaves.items()})
        xd = spmd.constrain(x, mesh, _spec(args["x_spec"]))
        y = tf.moe_block(xd, layer, c, mesh, rules)
        spec = spmd.spec_of(y)
        axes = tuple(a for a in args["names"]
                     if any(a in spec.axes(d) for d in range(len(spec))))
        loss = spmd.psum(torch.sum(torch.sin(y.to_local())), mesh, axes)
        loss.backward()
        out[cf] = {"out": spmd.gather_full(y.detach()).numpy(),
                   "loss": float(loss), "dropped": list(dropped),
                   "grads": {"x": x.grad.numpy(),
                             **{k: v.grad.numpy()
                                for k, v in leaves.items()}}}
    return out


def _placed(arch, c, tree, args, mesh, rules, override=None):
    """The port's ``arch`` model holding the JAX tree, its parameters
    placed by its ``param_pspecs`` (``override``: specs by name that
    replace them)."""
    import importlib

    from repro_torch import convert
    from repro_torch.parallel import spmd
    from repro_torch.parallel.sharding import MeshShape
    model = convert.recsys_params_from_numpy(arch, tree, c, device="cpu")
    specs = importlib.import_module(f"repro_torch.models.{arch}").param_pspecs(
        c, MeshShape(tuple(args["names"]), tuple(args["mesh"])), rules)
    specs.update({k: _spec(v) for k, v in (override or {}).items()})
    return spmd.shard_module(model, mesh, specs)


def job_sharded_models(rank, world, args):
    """Each BERT4Rec case's sharded ``serve_step`` (scores and items,
    whole, and the scores' placements) and DimeNet's ``forward_sharded``
    with its loss's gradients and one AdamW step (whole), each model
    from the JAX tree pickled at its ``params``."""
    import numpy as np
    import torch

    from repro_torch.models import bert4rec, dimenet
    from repro_torch.optim import optimizers
    from repro_torch.parallel import spmd
    from repro_torch.parallel.sharding import ShardingRules
    mesh = _mesh(args["mesh"], args["names"])
    rules = ShardingRules(batch=("data",), fsdp=("data",))
    data = np.load(args["inputs"])
    out = {}
    for a in args.get("bert4rec", ()):
        c = bert4rec.Bert4RecConfig(**a["config"])
        model = _placed("bert4rec", c, _load(a["params"]), args, mesh, rules)
        vals, idx = bert4rec.serve_step(
            model, {"ids": torch.from_numpy(data["ids"])}, c,
            top_n=a["top_n"], vocab_chunk=a["vocab_chunk"], mesh=mesh,
            rules=rules)
        out[a["name"]] = (spmd.gather_full(vals).numpy(),
                          spmd.gather_full(idx).numpy(),
                          [str(p) for p in vals.placements])
    if "dimenet" in args:
        a = args["dimenet"]
        c = dimenet.DimeNetConfig(**a["config"])
        model = _placed("dimenet", c, _load(a["params"]), args, mesh, rules)
        batch = {k[len("local_"):]: torch.from_numpy(data[k])
                 for k in data.files if k.startswith("local_")}
        with torch.no_grad():
            pred = dimenet.forward_sharded(model, batch, c, mesh, rules)
        loss = dimenet.loss_fn(model, batch, c, mesh, rules)
        loss.backward()
        # ``head`` is never read: no gradient
        grads = {k: spmd.gather_full(p.grad).numpy()
                 for k, p in model.named_parameters() if p.grad is not None}
        opt = optimizers.adamw(model.parameters(), lr=a["lr"],
                               warmup_steps=1)
        step = dimenet.make_train_step(c, opt, mesh, rules)
        step_loss = float(step(model, batch)["loss"])
        out["dimenet"] = {
            "pred": pred.to_local().numpy(), "loss": float(loss),
            "grads": grads, "step_loss": step_loss,
            "gnorm": float(opt.last_gnorm),
            "params": {k: spmd.gather_full(p.detach()).numpy()
                       for k, p in model.named_parameters()}}
    return out


CONFIGS = {"dlrm": "DLRMConfig", "deepfm": "DeepFMConfig",
           "two_tower": "TwoTowerConfig", "bert4rec": "Bert4RecConfig"}


def _recsys_fns(arch, sampled):
    """The arch's module, loss and train-step keywords."""
    import importlib
    mod = importlib.import_module(f"repro_torch.models.{arch}")
    loss = {"dlrm": "loss_fn", "deepfm": "loss_fn",
            "two_tower": "sampled_softmax_loss",
            "bert4rec": "sampled_cloze_loss" if sampled else "cloze_loss"}
    kw = {"sampled": sampled} if arch == "bert4rec" else {}
    return mod, getattr(mod, loss[arch]), kw


def job_sharded_recsys(rank, world, args):
    """Each recommender case on the mesh, from the JAX tree pickled at
    its ``params`` placed by ``param_pspecs``, on the batch in its
    ``inputs`` (the global values every rank holds): the parameters'
    placements, ``serve_step`` (whole, with its placements),
    ``retrieval_step`` on the ``q_*`` query (whole), the loss
    and its gradients (whole), ``steps`` AdamW steps (losses, norms,
    the last step's clipped gradients and the parameters after, whole);
    a case with ``raises`` records the ``InvalidIdError`` its loss raised
    on this rank; ``specs`` replace ``param_pspecs``' by name."""
    import numpy as np
    import torch

    from repro_torch.models.embedding import InvalidIdError
    from repro_torch.optim import optimizers
    from repro_torch.parallel import spmd
    from repro_torch.parallel.sharding import ShardingRules
    mesh = _mesh(args["mesh"], args["names"])
    rules = ShardingRules(batch=("data",), fsdp=("data",))
    out = {}
    for case in args["cases"]:
        mod, loss_fn, kw = _recsys_fns(case["arch"], case.get("sampled",
                                                              False))
        c = getattr(mod, CONFIGS[case["arch"]])(**{
            k: tuple(v) if isinstance(v, list) else v
            for k, v in case["config"].items()})
        model = _placed(case["arch"], c, _load(case["params"]), args, mesh,
                        rules, case.get("specs"))
        data = np.load(case["inputs"])
        batch = {k: torch.from_numpy(np.array(data[k])) for k in data.files}
        got = {}
        if case.get("raises"):
            try:
                loss_fn(model, batch, c, mesh=mesh, rules=rules)
            except InvalidIdError as e:
                got["raised"] = str(e)
            out[case["name"]] = got
            continue
        serve = {k: v for k, v in batch.items() if k in case["serve_keys"]}
        if serve:
            y = mod.serve_step(model, serve, c, mesh=mesh, rules=rules)
            y = y if isinstance(y, tuple) else (y,)
            got["serve"] = [spmd.gather_full(t).numpy() for t in y]
            got["serve_placements"] = [str(p) for p in y[0].placements]
        got["placements"] = {k: [str(pl) for pl in p.placements]
                             for k, p in model.named_parameters()}
        if case.get("retrieval"):
            q = {k: batch["q_" + k] for k in case["query_keys"]}
            q["candidates"] = batch["candidates"]
            v, i = mod.retrieval_step(model, q, c, top_n=case["top_n"],
                                      mesh=mesh, rules=rules)
            got["retrieval"] = (spmd.gather_full(v).numpy(),
                                spmd.gather_full(i).numpy())
        if not case.get("train_keys"):
            out[case["name"]] = got
            continue
        tb = {k: batch[k] for k in case["train_keys"]}
        loss = loss_fn(model, tb, c, mesh=mesh, rules=rules)
        loss.backward()
        got["loss"] = float(loss)
        got["grads"] = {k: spmd.gather_full(p.grad).numpy()
                        for k, p in model.named_parameters()
                        if p.grad is not None}
        opt = optimizers.adamw(model.parameters(), lr=case["lr"],
                               warmup_steps=1)
        step = mod.make_train_step(c, opt, mesh=mesh, rules=rules, **kw)
        got["steps"] = []
        for _ in range(case["steps"]):
            got["steps"].append((float(step(model, tb)["loss"]),
                                 float(opt.last_gnorm)))
        got["step_grads"] = {k: spmd.gather_full(p.grad).numpy()
                             for k, p in model.named_parameters()
                             if p.grad is not None}
        got["params"] = {k: spmd.gather_full(p.detach()).numpy()
                         for k, p in model.named_parameters()}
        out[case["name"]] = got
    return out


def job_spmd(rank, world, args):
    """``parallel.spmd`` on the (2, 4) mesh: axis indices, each collective
    and its gradient on rank-dependent inputs, ``redistribute`` and
    ``constrain`` blocks and gradients, ``shard_map``, ``gather_full``."""
    import torch

    from repro_torch.parallel import spmd
    from repro_torch.parallel.sharding import Spec
    mesh = _mesh(args["mesh"], args["names"])
    out = {"index": {"data": spmd.axis_index(mesh, "data"),
                     "model": spmd.axis_index(mesh, "model"),
                     "both": spmd.axis_index(mesh, ("data", "model"))}}
    x0 = torch.arange(24, dtype=torch.float64).reshape(4, 6) + 100 * rank
    w = torch.arange(24, dtype=torch.float64).reshape(4, 6) * (rank + 1)

    def run(name, fn, weight):
        x = x0.clone().requires_grad_()
        y = fn(x)
        (y * weight(y)).sum().backward()
        out[name] = (y.detach().numpy(), x.grad.numpy())

    def same_shape(y):
        return torch.ones_like(y) * (rank + 1)
    run("psum", lambda x: spmd.psum(x, mesh, "model"), same_shape)
    run("pvary", lambda x: spmd.pvary(x, mesh, ("data", "model")),
        lambda y: w)
    run("all_gather", lambda x: spmd.all_gather(x, mesh, "model", 1),
        lambda y: torch.arange(y.numel(), dtype=y.dtype).reshape(y.shape)
        * (rank + 1))
    run("psum_scatter", lambda x: spmd.psum_scatter(x, mesh, "data", 0),
        same_shape)
    g = torch.arange(64, dtype=torch.float64).reshape(8, 8)
    have, want = Spec("data", "model"), Spec("model", None)
    blk = spmd.local_block(g, mesh, have).clone().requires_grad_()
    moved = spmd.redistribute(blk, mesh, have, want)
    (moved * (rank + 1)).sum().backward()
    out["redistribute"] = (moved.detach().numpy(), blk.grad.numpy())
    d = spmd.constrain(g, mesh, Spec(("data", "model"), None))
    out["constrain"] = (d.to_local().numpy(), [str(p) for p in d.placements],
                        spmd.constrain(g, None, Spec("data")) is g)
    out["spec_of"] = tuple(spmd.spec_of(spmd.constrain(
        g, mesh, Spec(None, ("data", "model")))))
    out["gather_full"] = spmd.gather_full(d).numpy()
    body = spmd.shard_map(
        lambda a, b: (spmd.psum(a.sum(0, keepdim=True), mesh, "data"),
                      a * b[None, :]),
        mesh, (Spec("data", "model"), Spec("model")),
        (Spec(None, "model"), Spec("data", "model")))
    r, m = body(g, torch.arange(8, dtype=torch.float64))
    out["shard_map"] = (spmd.gather_full(r).numpy(),
                        spmd.gather_full(m).numpy())
    return out


def job_sharded_adafactor(rank, world, args):
    """``optimizers.adafactor`` over DTensor parameters placed by the
    cases' specs, two steps from the gradients in ``args["inputs"]``:
    every parameter and state leaf after them, gathered whole."""
    import numpy as np
    import torch

    from repro_torch.optim import optimizers
    from repro_torch.parallel import spmd
    mesh = _mesh(args["mesh"], args["names"])
    data = np.load(args["inputs"])
    names = sorted(args["specs"])
    params = []
    for n in names:
        spec = _spec(args["specs"][n])
        block = spmd.local_block(torch.from_numpy(data[n]), mesh, spec)
        params.append(torch.nn.Parameter(
            spmd.from_local(block.clone(), mesh, spec)))
    opt = optimizers.adafactor(params, **args["hyper"])
    for step in range(args["steps"]):
        for n, p in zip(names, params):
            spec = _spec(args["specs"][n])
            g = torch.from_numpy(data[f"{n}.g{step}"])
            p.grad = spmd.from_local(
                spmd.local_block(g, mesh, spec).clone(), mesh, spec)
        opt.step()
    return {n: {"param": spmd.gather_full(p.detach()).numpy(),
                **{k: spmd.gather_full(v).numpy()
                   for k, v in opt.state[p].items()},
                "state_spec": {k: tuple(spmd.spec_of(v))
                               for k, v in opt.state[p].items()}}
            for n, p in zip(names, params)}


def job_mesh_tifu(rank, world, args):
    """tifu-knn under the (2, 2) mesh on the inputs in ``args["inputs"]``:
    ``stream_update``'s seeded state (``tifu_knn.SMOKE_SIZES``, seed
    ``args["seed"]``) after the given batches, placed by the cell's
    ``in_shardings``; ``knn.predict`` (with and without self-exclusion)
    and ``knn.distributed_predict``'s mesh route on the given queries
    and corpus placed by the serve cells' ``in_shardings``; and the two
    negative runs: the micro-batch with no exchange (each rank applies
    the rows it holds), the merge without its "data" step.  Everything
    gathered whole."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import convert
    from repro_torch.configs import tifu_knn
    from repro_torch.configs.base import mesh_shape, place
    from repro_torch.core import knn
    from repro_torch.core.types import AddBatch, DelBasketBatch, DelItemBatch
    from repro_torch.launch import dryrun
    from repro_torch.parallel import spmd
    mesh = _mesh(args["mesh"], args["names"])
    rules = dryrun.mesh_rules()
    data = np.load(args["inputs"])
    sz, k, alpha = tifu_knn.SMOKE_SIZES, args["k"], args["alpha"]

    def t(name):
        return torch.from_numpy(data[name])
    batches = (AddBatch(t("add.user"), t("add.items"), t("add.valid")),
               DelBasketBatch(t("delb.user"), t("delb.pos"), t("delb.valid")),
               DelItemBatch(t("deli.user"), t("deli.pos"), t("deli.item"),
                            t("deli.valid")))

    def stream():
        prog = tifu_knn.stream_update_cell("cpu", args["seed"], sz,
                                           mesh=mesh, rules=rules)
        placed = [place(b, sh, mesh)
                  for b, sh in zip(batches, prog.in_shardings[1:])]
        out = prog.fn(prog.args[0], *placed)
        return convert.state_to_numpy(dryrun.outputs(prog, out))

    out = {"stream": stream()}
    real_whole = tifu_knn.whole_batch
    tifu_knn.whole_batch = lambda b: dataclasses.replace(b, **{
        f.name: spmd.local(getattr(b, f.name)) for f in dataclasses.fields(b)})
    try:
        out["stream_no_exchange"] = stream()
    finally:
        tifu_knn.whole_batch = real_whole

    q, c = t("queries"), t("corpus")
    ms = mesh_shape(mesh)
    qs, cs = tifu_knn.cell_shardings("serve_topk", ms, rules)
    qd, cd = place(q, qs, mesh), place(c, cs, mesh)
    out["predict"] = spmd.gather_full(knn.predict(
        qd, cd, k, alpha, exclude_self=False, mesh=mesh,
        rules=rules)).numpy()
    ids = t("self_ids")
    out["predict_self"] = spmd.gather_full(knn.predict(
        place(c[ids.long()], qs, mesh), cd, k, alpha,
        exclude_self=True, query_ids=ids, mesh=mesh, rules=rules)).numpy()
    qs, cs = tifu_knn.cell_shardings("serve_topk_opt", ms, rules)
    qd, cd = place(q, qs, mesh), place(c, cs, mesh)

    def opt():
        return spmd.gather_full(knn.distributed_predict(
            qd, cd, k, alpha, mesh=mesh, rules=rules)).numpy()
    out["opt"] = opt()
    real_merge = knn._merge_over
    knn._merge_over = lambda vals, gids, k_, mesh_, axis: (
        (vals, gids) if axis == "data" else
        real_merge(vals, gids, k_, mesh_, axis))
    try:
        out["opt_no_data_merge"] = opt()
    finally:
        knn._merge_over = real_merge
    return out


JOBS = {"hierarchical": job_hierarchical, "distribute": job_distribute,
        "sharded_models": job_sharded_models, "spmd": job_spmd,
        "sharded_recsys": job_sharded_recsys,
        "sharded_moe": job_sharded_moe,
        "sharded_lm": job_sharded_lm,
        "elastic_save": job_elastic_save,
        "elastic_restore": job_elastic_restore,
        "sharded_adafactor": job_sharded_adafactor,
        "mesh_tifu": job_mesh_tifu}


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
