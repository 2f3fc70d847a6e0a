"""The port's pytree checkpoints and training driver against the JAX
package's.

``repro_torch.checkpoint`` writes the JAX package's format
(``ckpt_{step:010d}.npz`` of ``leaf_{i}`` in ``jax.tree_util``'s flatten
order, bf16 as a ``uint16`` view, ``LATEST`` JSON): a checkpoint of
either package restores in the other leaf for leaf, bf16 included, and
the two write the same arrays and the same ``LATEST``.  Then
``AsyncCheckpointer``'s snapshot, its garbage collection and its error
path; and ``repro_torch.launch.train`` against ``repro.launch.train``:
its config and batches, its refusal of the full configs, the resume
from the JAX driver's own checkpoint continuing as the JAX driver does
(losses ``rtol=1e-5, atol=1e-6`` and parameters ``rtol=1e-5,
atol=1e-5``, the bar of ``tests/test_torch_train.py``), and the batch
generator restarting at seed 1234 on a resume.
"""
import json
import os
import shutil
import sys
from typing import NamedTuple

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.configs import get_arch
from repro.launch import train as jtrain
from repro.models import transformer as jtf
from repro.optim import OptState as JOptState
from repro.optim import adamw
from repro_torch import checkpoint as ckpt
from repro_torch.launch import train
from repro_torch.optim.optimizers import OptState

LOSS = dict(rtol=1e-5, atol=1e-6)
STEPS = dict(rtol=1e-5, atol=1e-5)



@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The steps here are many small ops: one torch thread a test keeps
    parallel test workers from oversubscribing the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

class Pair(NamedTuple):
    second: object
    first: object


def _trees(rng):
    """The same tree in both packages' leaves: bf16, f32, int32 and a
    bool, under dicts (keys out of order), a list, a tuple, a NamedTuple
    and a ``None``."""
    arrays = {"b16": rng.normal(size=(3, 5)).astype(ml_dtypes.bfloat16),
              "f32": rng.normal(size=(4,)).astype(np.float32),
              "i32": np.asarray(7, np.int32),
              "mask": rng.random((2, 3)) < 0.5,
              "stack": rng.normal(size=(2, 3, 2)).astype(np.float32)}

    def build(leaf, state):
        return {"z": state(leaf("i32"), {"m": [leaf("f32"), leaf("b16")],
                                         "v": (leaf("stack"), None)}),
                "a": {"y": leaf("mask"), "x": Pair(leaf("f32"),
                                                   leaf("stack"))},
                "step": leaf("i32")}

    def to_torch(name):
        x = arrays[name]
        if x.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(np.array(x, copy=True))
    port = build(to_torch, OptState)
    ref = build(lambda n: jnp.asarray(arrays[n]), JOptState)
    return port, ref


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == ml_dtypes.bfloat16 else x


def _same_leaves(a, b):
    la, lb = ckpt.flatten(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert tuple(x.shape) == np.asarray(y).shape
        assert str(x.dtype).split(".")[-1] == str(np.asarray(y).dtype)
        np.testing.assert_array_equal(_np(x), _np(y))


def test_flatten_is_jax_tree_order(rng):
    port, ref = _trees(rng)
    _same_leaves(port, ref)
    assert len(ckpt.flatten(port)) == 8          # None holds no leaf


def test_checkpoints_restore_across_the_packages(rng, tmp_path):
    """A port checkpoint restored by the JAX package and a JAX checkpoint
    by the port, leaf for leaf with bf16 leaves; both write the same
    arrays and the same ``LATEST``."""
    port, ref = _trees(rng)
    ckpt.save_pytree(port, str(tmp_path / "port"), 12)
    jckpt.save_pytree(ref, str(tmp_path / "jax"), 12)
    for name in ("port", "jax"):
        assert sorted(os.listdir(tmp_path / name)) == \
            ["LATEST", "ckpt_0000000012.npz"]
    metas = [json.loads((tmp_path / n / "LATEST").read_text())
             for n in ("port", "jax")]
    assert metas[0] == metas[1]
    assert metas[0]["dtypes"].count("bfloat16") == 1
    with np.load(tmp_path / "port" / "ckpt_0000000012.npz") as a, \
            np.load(tmp_path / "jax" / "ckpt_0000000012.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for f in a.files:
            assert a[f].dtype == b[f].dtype
            np.testing.assert_array_equal(a[f], b[f])
    _same_leaves(jckpt.restore_pytree(ref, str(tmp_path / "port")), ref)
    got = ckpt.restore_pytree(port, str(tmp_path / "jax"))
    _same_leaves(got, ref)
    assert isinstance(got["z"], OptState) and got["z"].inner["v"][1] is None
    assert got["z"].inner["m"][1].dtype == torch.bfloat16
    assert ckpt.latest_step(str(tmp_path / "jax")) == 12


def test_restore_refuses_what_does_not_match(rng, tmp_path):
    port, _ = _trees(rng)
    d = str(tmp_path)
    assert ckpt.latest_step(d) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore_pytree(port, d)
    ckpt.save_pytree(port, d, 1)
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore_pytree({"only": torch.zeros(1)}, d)
    wrong = dict(port, step=torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore_pytree(wrong, d)
    with pytest.raises(TypeError, match="shardings"):
        ckpt.restore_pytree(port, d, shardings=port)
    # an explicit older step, and an atomic write leaves no tmp file
    ckpt.save_pytree(dict(port, step=torch.tensor(9, dtype=torch.int32)),
                     d, 2)
    assert int(ckpt.restore_pytree(port, d, step=1)["step"]) == 7
    assert int(ckpt.restore_pytree(port, d)["step"]) == 9
    assert not [f for f in os.listdir(d) if f.endswith(".tmp")]


def test_async_checkpointer_snapshots_and_keeps_the_newest(tmp_path):
    d = str(tmp_path / "a")
    w = torch.zeros(4)
    ck = ckpt.AsyncCheckpointer(d, keep=3)
    for step in range(5):
        w.fill_(step)
        ck.save({"w": w, "step": step}, step)
        w.fill_(-1.0)            # after the snapshot: not in the write
    ck.close()
    assert sorted(f for f in os.listdir(d) if f.endswith(".npz")) == \
        [f"ckpt_{s:010d}.npz" for s in (2, 3, 4)]
    for s in (2, 3, 4):
        got = ckpt.restore_pytree({"w": w, "step": 0}, d, step=s)
        assert torch.equal(got["w"], torch.full((4,), float(s)))
    # the JAX package reads what the port's writer left
    got = jckpt.restore_pytree({"w": jnp.zeros(4), "step": 0}, d)
    np.testing.assert_array_equal(np.asarray(got["w"]), np.full(4, 4.0))


def test_async_checkpointer_raises_a_writer_error_on_the_next_call(
        tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    ck = ckpt.AsyncCheckpointer(str(blocker), keep=3)
    ck.save({"w": torch.zeros(2)}, 0)         # the writer fails
    with pytest.raises(OSError):
        ck.wait()
    with pytest.raises(OSError):
        ck.save({"w": torch.zeros(2)}, 1)


def test_driver_config_and_batches_are_the_jax_ones():
    mine, theirs = train.lm100m_config(), jtrain.lm100m_config()
    for f in ("name", "n_layers", "d_model", "n_heads", "n_kv_heads",
              "d_head", "d_ff", "vocab_size", "tie_embeddings"):
        assert getattr(mine, f) == getattr(theirs, f), f
    assert mine.dtype == torch.float32 and theirs.dtype == jnp.float32
    assert 100e6 < mine.n_params() == theirs.n_params() < 120e6
    a = train.synthetic_lm_batch(np.random.default_rng(1234), 3, 16, 97,
                                 "cpu")
    b = jtrain.synthetic_lm_batch(np.random.default_rng(1234), 3, 16, 97)
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))
    assert torch.equal(a["tokens"][:, 2::2], a["tokens"][:, 1:-1:2])
    with pytest.raises(SystemExit, match="--smoke"):
        train.run(["--arch", "granite-3-2b", "--device", "cpu"])


FLAGS = ["--arch", "granite-3-2b", "--smoke", "--batch", "2", "--seq", "16",
         "--ckpt-every", "2", "--log-every", "1"]


def _jax_main(monkeypatch, capsys, directory, steps):
    monkeypatch.setattr(sys, "argv", ["train.py", *FLAGS, "--ckpt",
                                      str(directory), "--steps", str(steps)])
    assert jtrain.main() == 0
    out = capsys.readouterr().out.splitlines()
    losses = {int(ln.split()[1]): float(ln.split()[3]) for ln in out
              if ln.startswith("step ")}
    final = [float(ln.split()[-1]) for ln in out
             if ln.startswith("final loss:")]
    return losses, final[0], out


def test_driver_resumes_the_jax_drivers_checkpoint_as_jax_does(
        monkeypatch, capsys, tmp_path):
    """The JAX driver trains 4 steps with checkpoints; from a copy of its
    directory both drivers resume to 6: the same resumed step, the same
    losses, and final checkpoints that either package restores to the
    same parameters."""
    _jax_main(monkeypatch, capsys, tmp_path / "jax", 4)
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    want, want_final, out = _jax_main(monkeypatch, capsys, tmp_path / "jax",
                                      6)
    assert "resumed from step 4" in out
    got = train.run([*FLAGS, "--ckpt", str(tmp_path / "port"), "--steps",
                     "6", "--device", "cpu"])
    assert got.step0 == 4 and sorted(got.losses) == [4, 5]
    assert "resumed from step 4" in capsys.readouterr().out
    for step in (4, 5):
        np.testing.assert_allclose(got.losses[step], want[step], atol=1e-4)
    np.testing.assert_allclose(got.losses[5], want_final, **LOSS)
    c = get_arch("granite-3-2b").make_smoke()
    params = jtf.init_params(c, jax.random.PRNGKey(0))
    like = {"p": params, "o": adamw().init(params),
            "step": jnp.zeros((), jnp.int32)}
    a = jckpt.restore_pytree(like, str(tmp_path / "jax"))
    b = jckpt.restore_pytree(like, str(tmp_path / "port"))
    assert int(a["step"]) == int(b["step"]) == 6
    assert int(a["o"].step) == int(b["o"].step) == 6
    for x, y in zip(jax.tree.leaves(b["p"]), jax.tree.leaves(a["p"])):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), **STEPS)


def test_driver_restarts_its_batches_at_the_seed_on_a_resume(
        monkeypatch, tmp_path):
    """After a resume the batch generator starts again at seed 1234, as
    the JAX driver's does: the resumed run's first batch is the first
    run's first, not the one the interrupted run would have drawn
    next."""
    seen = []
    make = train.synthetic_lm_batch

    def recorded(*a, **kw):
        seen.append(make(*a, **kw))
        return seen[-1]
    monkeypatch.setattr(train, "synthetic_lm_batch", recorded)
    flags = [*FLAGS, "--ckpt", str(tmp_path), "--device", "cpu"]
    first = train.run(flags + ["--steps", "3"])
    n_first = len(seen)
    resumed = train.run(flags + ["--steps", "5"])
    assert first.step0 == 0 and resumed.step0 == 3
    assert n_first == 3 and len(seen) == 5
    assert torch.equal(seen[3]["tokens"], seen[0]["tokens"])
    assert not torch.equal(seen[4]["tokens"], seen[0]["tokens"])
    assert torch.equal(seen[4]["tokens"], seen[1]["tokens"])
