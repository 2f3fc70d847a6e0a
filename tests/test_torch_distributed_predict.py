"""``knn.distributed_predict`` over 8 row blocks on the CPU against the
JAX reference's ``distributed_predict`` on 8 fake host devices.

The JAX side runs in a subprocess (the device count is fixed when JAX
starts), on a (2, 4) mesh over ``("data", "model")`` as
``tests/test_distributed.py`` runs it: users over both axes, queries
replicated.  The port takes the same corpus as 8 contiguous row blocks,
one per shard.  Predictions ``rtol=1e-5, atol=1e-5``.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import tifu_knn
from repro_torch.core import knn
from repro_torch.kernels import ops

ROOT = Path(__file__).resolve().parents[1]
K, ALPHA, N_SHARDS = 5, 0.7, 8

JAX_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, "src")
import jax, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import compat
from repro.core import knn
from repro.parallel.sharding import ShardingRules
mesh = jax.make_mesh((2, 4), ("data", "model"))
rules = ShardingRules(batch=("data",), fsdp=("data",))
src, dst = sys.argv[1], sys.argv[2]
data, out = np.load(src), {}
for name in ("normal", "tifu"):
    q, c = data[name + "_q"], data[name + "_c"]
    with compat.set_mesh(mesh):
        cd = jax.device_put(c, NamedSharding(mesh, P(("data", "model"),
                                                     None)))
        out[name] = np.asarray(jax.jit(lambda q, c: knn.distributed_predict(
            q, c, K, ALPHA, mesh, rules))(q, cd))
np.savez(dst, **out)
""".replace("K, ALPHA", f"{K}, {ALPHA}")


def _cases():
    """Normal rows, and the tifu-knn serve cell's smoke corpus (sparse,
    non-negative TIFU user vectors)."""
    rng = np.random.default_rng(0)
    prog = tifu_knn.serve_topk_cell("cpu", 0, tifu_knn.SMOKE_SIZES)
    q, c = (t.numpy() for t in prog.args)
    return {"normal": (rng.normal(size=(16, 32)).astype(np.float32),
                       rng.normal(size=(64, 32)).astype(np.float32)),
            "tifu": (q, c)}


@pytest.fixture(scope="module")
def jax_outputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("distributed_predict")
    src, dst = tmp / "in.npz", tmp / "out.npz"
    np.savez(src, **{f"{n}_{w}": a for n, (q, c) in _cases().items()
                     for w, a in (("q", q), ("c", c))})
    r = subprocess.run([sys.executable, "-c", JAX_SCRIPT, str(src),
                        str(dst)], capture_output=True, text=True,
                       timeout=580, cwd=ROOT)
    assert r.returncode == 0, r.stdout[-1500:] + r.stderr[-1500:]
    return dict(np.load(dst))


def _blocks(c, n=N_SHARDS):
    m_loc = c.shape[0] // n
    return [torch.from_numpy(c[s * m_loc:(s + 1) * m_loc])
            for s in range(n)]


@pytest.mark.parametrize("case", ["normal", "tifu"])
def test_distributed_predict_matches_jax_on_8_devices(jax_outputs, case):
    q, c = _cases()[case]
    got = knn.distributed_predict(torch.from_numpy(q), _blocks(c), K, ALPHA)
    np.testing.assert_allclose(got.numpy(), jax_outputs[case], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("case", ["normal", "tifu"])
def test_row_blocks_merge_to_the_whole_corpus_top_k(case):
    """The merged block lists are the one-corpus list: ids identical,
    scores bitwise (each pair is scored the same way in a block)."""
    q, c = (torch.from_numpy(a) for a in _cases()[case])
    vals, gids = knn.distributed_topk(q, _blocks(c.numpy()), K)
    want_v, want_i = ops.knn_topk(q, c, K)
    assert torch.equal(gids, want_i.long())
    assert torch.equal(vals, want_v)


def test_unequal_row_blocks_raise():
    c = np.random.default_rng(1).normal(size=(30, 8)).astype(np.float32)
    q = torch.from_numpy(c[:4])
    blocks = [torch.from_numpy(c[:16]), torch.from_numpy(c[16:])]
    with pytest.raises(ValueError, match="differ in size"):
        knn.distributed_predict(q, blocks, 3, ALPHA)
    with pytest.raises(ValueError, match="k=9 > the 8 rows"):
        knn.distributed_predict(q, _blocks(c[:16], 2), 9, ALPHA)
    with pytest.raises(ValueError, match="equal row blocks"):
        tifu_knn.serve_topk_opt_cell(
            "cpu", 0, tifu_knn.Sizes(n_users=30, n_items=8, max_baskets=8,
                                     max_basket_size=2, n_queries=2, topk=3,
                                     n_shards=4))
