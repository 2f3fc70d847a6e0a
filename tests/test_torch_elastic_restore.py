"""Elastic restore: a tree saved from 4 gloo ranks as DTensors sharded
by rows restores onto 8 ranks (``restore_pytree(shardings=)``), as the
JAX package's ``ELASTIC_SCRIPT`` saves from a 4-device mesh and restores
onto 8 devices (``tests/test_checkpoint_and_optim.py``).

The restored values are bit for bit the saved ones (an f32 and a bf16
leaf sharded, an int32 step replicated), each rank holding row ``r``,
the block ``NamedSharding(mesh8, P("data", None))`` gives device ``r``.
The sharded save writes what the same tree saved whole writes: the
same ``LATEST`` bytes and the same npz members byte for byte (the zip's
entry timestamps aside, which ``np.savez`` takes from the clock), and
the JAX package restores it.
"""
import json
import os
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_pytree as jrestore
from repro_torch.checkpoint import pytree
from torch_ranks import run_ranks


def _whole_tree():
    x = torch.arange(64, dtype=torch.float32).reshape(8, 8) * 0.37
    y = (torch.arange(24, dtype=torch.float32).reshape(8, 3) - 7.5
         ).to(torch.bfloat16)
    return {"x": x, "y": y, "step": torch.tensor(11, dtype=torch.int32)}


@pytest.fixture(scope="module")
def elastic(tmp_path_factory):
    d = tmp_path_factory.mktemp("elastic")
    sharded = str(d / "sharded")
    saved = run_ranks("elastic_save", 4, d, {"dir": sharded})
    restored = run_ranks("elastic_restore", 8, d, {"dir": sharded})
    whole = str(d / "whole")
    pytree.save_pytree(_whole_tree(), whole, 1)
    return sharded, whole, saved, restored


def test_save_from_four_ranks_shards_the_tree(elastic):
    _, _, saved, _ = elastic
    x = _whole_tree()["x"].numpy()
    for r, res in enumerate(saved):
        assert res["path"].endswith("ckpt_0000000001.npz")
        np.testing.assert_array_equal(res["local_x"], x[2 * r:2 * r + 2])


def test_restore_onto_eight_ranks_is_bitwise(elastic):
    _, _, _, restored = elastic
    tree = _whole_tree()
    bits = {"x": tree["x"].numpy(), "y": tree["y"].view(torch.int16).numpy(),
            "step": tree["step"].numpy()}
    for r, res in enumerate(restored):
        for k in ("x", "y"):
            assert res[k]["placements"] == [("Shard", 0)]
            assert res[k]["full"].tobytes() == bits[k].tobytes()
            assert res[k]["local"].tobytes() == bits[k][r:r + 1].tobytes()
        assert res["y"]["dtype"] == "torch.bfloat16"
        assert res["step"]["placements"] == [("Replicate", None)]
        assert int(res["step"]["local"]) == 11


def test_sharded_save_writes_the_whole_tree_s_files(elastic):
    sharded, whole, _, _ = elastic
    for name in ("LATEST",):
        with open(os.path.join(sharded, name), "rb") as a, \
                open(os.path.join(whole, name), "rb") as b:
            assert a.read() == b.read()
    with open(os.path.join(sharded, "LATEST")) as f:
        assert json.load(f)["dtypes"] == ["int32", "float32", "bfloat16"]
    npz = "ckpt_0000000001.npz"
    with zipfile.ZipFile(os.path.join(sharded, npz)) as a, \
            zipfile.ZipFile(os.path.join(whole, npz)) as b:
        assert a.namelist() == b.namelist()
        for info_a, info_b in zip(a.infolist(), b.infolist()):
            assert info_a.compress_type == info_b.compress_type
            assert a.read(info_a) == b.read(info_b), info_a.filename
    assert sorted(os.listdir(sharded)) == sorted(os.listdir(whole))


def test_jax_restores_the_sharded_save(elastic):
    sharded, _, _, _ = elastic
    tree = _whole_tree()
    like = {"x": jnp.zeros((8, 8)), "y": jnp.zeros((8, 3), jnp.bfloat16),
            "step": jnp.zeros((), jnp.int32)}
    got = jrestore(like, sharded)
    np.testing.assert_array_equal(np.asarray(got["x"]), tree["x"].numpy())
    np.testing.assert_array_equal(np.asarray(got["y"], np.float32),
                                  tree["y"].float().numpy())
    assert int(got["step"]) == 11
