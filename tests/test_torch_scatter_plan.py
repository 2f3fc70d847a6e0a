"""B2's order of additions, and its wrapper's contract.

The CUDA kernel of ``sparse_row_scatter`` (``csrc/sparse_row_scatter.cu``)
builds its plan on the card: one block per entry row, the first row of
each run of equal (clamped) rows owning the table row, each cell's
deltas added one at a time in entry order (r, w).  Its bitwise oracle is
``ref.sparse_row_scatter_ordered_ref``; the kernel runs only on the card
(``chip_smoke.py`` holds it bitwise against that oracle).  Here the
oracle is held against a sequential scatter-add (``numpy.add.at``) and
against the JAX package, ``sparse_row_scatter.chunk_flushes`` (where the
owner flushes a staged chunk, which ``chip_smoke.py`` uses to show that
its long runs flush at a tile's start and inside a tile) against the
kernel's staging loop transcribed, and the wrapper's checks and its one
launch with the library replaced by a recorder.

Tolerances:
  * against ``numpy.add.at`` -- bitwise: both add each cell's deltas one
    at a time in entry order, in float32;
  * against ``repro.kernels.ref.sparse_row_scatter_ref`` and the Pallas
    kernel in interpret mode -- bitwise on integer-valued tables and
    deltas (every fp32 sum is exact), else ``rtol=1e-6, atol=1e-6`` as in
    ``tests/test_torch_kernels.py`` (those sum a cell's deltas in another
    order).
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.kernels import ref as jref
from repro.kernels.sparse_row_scatter import sparse_row_scatter as jscatter
from repro_torch.kernels import build, ops, ref, sparse_row_scatter

INDEX_PAIRS = [(torch.int32, torch.int32), (torch.int64, torch.int32),
               (torch.int32, torch.int64), (torch.int64, torch.int64)]


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _inputs(rng, m, items, u, w, integer=False, out_of_range=True):
    """Entries with duplicate rows, duplicate ids within and across rows,
    PAD ids, an all-PAD row and, with ``out_of_range``, ids >= I and rows
    outside [0, M) (clamped)."""
    if integer:
        table = rng.integers(-8, 9, (m, items)).astype(np.float32)
        vals = rng.integers(-8, 9, (u, w)).astype(np.float32)
    else:
        table = rng.normal(size=(m, items)).astype(np.float32)
        # deltas of mixed magnitudes: a sum's bits depend on its order
        vals = (rng.normal(size=(u, w))
                * 10.0 ** rng.integers(-3, 4, (u, w))).astype(np.float32)
    rows = rng.integers(0, m, u)
    rows[u // 3: u // 3 + max(2, u // 4)] = rows[0]   # a run of one row
    ids = rng.integers(-1, items, (u, w))             # PAD = -1
    ids[:, 1] = ids[:, 0]                             # duplicate ids
    ids[0, :4] = 7 % items                            # (row, id) repeated
    ids[1, :3] = 7 % items                            # ... across rows
    ids[-1, :] = -1                                   # an all-PAD row
    if out_of_range:
        rows[2], rows[-2] = -3, m + 5
        ids[3, -1], ids[4, -2] = items, items + 40
    return table, rows, ids, vals


def _sequential(table, rows, ids, vals):
    """``numpy.add.at`` over the valid entries: one addition at a time,
    in entry order."""
    out = table.copy()
    m, items = table.shape
    valid = (ids >= 0) & (ids < items)
    r = np.broadcast_to(np.clip(rows, 0, m - 1)[:, None], ids.shape)
    np.add.at(out, (r[valid], ids[valid]), vals[valid])
    return out


def _ordered(table, rows, ids, vals, pair):
    return ref.sparse_row_scatter_ordered_ref(
        _t(table), _t(rows).to(pair[0]), _t(ids).to(pair[1]),
        _t(vals)).numpy()


# ---------------------------------------------------------------------------
# the ordered oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pair", INDEX_PAIRS)
@pytest.mark.parametrize("m,items,u,w", [(16, 256, 8, 24), (37, 211, 13, 40),
                                         (5, 9, 30, 7)])
def test_ordered_ref_is_a_sequential_sum(rng, pair, m, items, u, w):
    table, rows, ids, vals = _inputs(rng, m, items, u, w)
    np.testing.assert_array_equal(_ordered(table, rows, ids, vals, pair),
                                  _sequential(table, rows, ids, vals))


@pytest.mark.parametrize("m,items,u,w", [(3, 4096, 64, 168), (1, 1, 5, 7),
                                         (4, 50, 1, 30), (6, 70, 9, 1)])
def test_ordered_ref_at_the_kernels_edges(rng, m, items, u, w):
    """Every entry row one table row with every id valid (64 x 168
    entries: longer than a staged chunk of 2,048), I = 1, U = 1, W = 1."""
    table = rng.normal(size=(m, items)).astype(np.float32)
    vals = rng.normal(size=(u, w)).astype(np.float32)
    rows = np.full(u, m - 1)
    ids = rng.integers(0, items, (u, w))
    np.testing.assert_array_equal(
        _ordered(table, rows, ids, vals, INDEX_PAIRS[1]),
        _sequential(table, rows, ids, vals))


def test_ordered_ref_updates_in_place(rng):
    table, rows, ids, vals = _inputs(rng, 8, 130, 5, 9)
    t = _t(table)
    out = ref.sparse_row_scatter_ordered_ref(t, _t(rows), _t(ids), _t(vals))
    assert out is t
    np.testing.assert_array_equal(t.numpy(),
                                  _sequential(table, rows, ids, vals))


def test_ordered_ref_of_no_valid_entry(rng):
    table = rng.normal(size=(4, 6)).astype(np.float32)
    got = _ordered(table, np.array([0, 3]), np.full((2, 3), -1),
                   np.ones((2, 3), np.float32), INDEX_PAIRS[0])
    np.testing.assert_array_equal(got, table)


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("pair", INDEX_PAIRS)
@pytest.mark.parametrize("m,items,u,w", [(16, 256, 8, 24), (37, 384, 13, 40)])
def test_ordered_ref_matches_jax(rng, integer, pair, m, items, u, w):
    """JAX's reference and its Pallas kernel in interpret mode take rows
    in [0, M) and ids in [-1, I)."""
    table, rows, ids, vals = _inputs(rng, m, items, u, w, integer,
                                     out_of_range=False)
    got = _ordered(table, rows, ids, vals, pair)
    args = [jnp.asarray(table), jnp.asarray(rows, jnp.int32),
            jnp.asarray(ids, jnp.int32), jnp.asarray(vals)]
    for exp in (jref.sparse_row_scatter_ref(*args),
                jscatter(*args, bi=128, interpret=True)):
        if integer:
            np.testing.assert_array_equal(got, np.asarray(exp))
        else:
            np.testing.assert_allclose(got, np.asarray(exp), rtol=1e-6,
                                       atol=1e-6)


# ---------------------------------------------------------------------------
# where the head block flushes a staged chunk
# ---------------------------------------------------------------------------

def test_chunk_constants_are_the_kernels():
    src = (Path(sparse_row_scatter.__file__).parent / "csrc" /
           "sparse_row_scatter.cu").read_text()
    const = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert (int(const["kThreads"]), int(const["kPer"]),
            int(const["kChunk"])) == (sparse_row_scatter.THREADS,
                                      sparse_row_scatter.PER,
                                      sparse_row_scatter.CHUNK)


def _staging_loop(at, valid):
    """The kernel's walk of one run, transcribed: windows of THREADS
    candidate entry rows from the head on, tiles of PER slabs, and the
    start/stop loop that flushes the chunk before a slab that does not
    fit."""
    t, p, c = (sparse_row_scatter.THREADS, sparse_row_scatter.PER,
               sparse_row_scatter.CHUNK)
    w = valid.shape[1]
    out, n = [], 0
    for t0 in range(at[0], at[-1] + 1, t):
        run = [i for i, a in enumerate(at) if t0 <= a < t0 + t]
        entries = valid[run].reshape(-1).tolist()
        for f0 in range(0, len(run) * w, t * p):
            counts = [sum(entries[f0 + j * t: f0 + (j + 1) * t])
                      for j in range(p)]
            start = 0
            while True:
                stop = p
                for j in range(start, p):
                    if j >= stop:
                        break
                    if n + counts[j] > c:
                        stop = j
                        continue
                    n += counts[j]
                if stop == p:
                    break
                out.append(((t0 - at[0]) // t, f0 // (t * p), stop))
                n, start = 0, stop
    return out


@pytest.mark.parametrize("at,w,pad", [
    (list(range(64)), 168, 0.0), (list(range(64)), 168, 0.4),
    (list(range(64)), 168, 0.9), (list(range(3, 67)), 1, 0.0),
    ([0, 5, 255, 256, 300, 511, 600], 526, 0.3),
    (list(range(0, 3000, 7)), 1, 0.2), ([0, 1], 3000, 0.5),
    ([4], 168, 0.0), (list(range(40)), 168, 1.0)])
def test_chunk_flushes_follow_the_staging_loop(rng, at, w, pad):
    valid = torch.from_numpy(rng.random((len(at), w)) >= pad)
    assert sparse_row_scatter.chunk_flushes(at, valid) == _staging_loop(
        at, valid)


def test_chunk_flushes_of_a_long_run():
    """64 rows of 168 valid ids flush at tile starts only; with PAD ids
    the chunks fill inside tiles; a run of no valid id never flushes."""
    full = torch.ones((64, 168), dtype=torch.bool)
    assert sparse_row_scatter.chunk_flushes(range(64), full) == [
        (0, tile, 0) for tile in range(1, 6)]
    some = torch.from_numpy(np.random.default_rng(0).random((64, 168))
                            >= 0.4)
    assert any(slab > 0 for _, _, slab in
               sparse_row_scatter.chunk_flushes(range(64), some))
    assert sparse_row_scatter.chunk_flushes(range(64), ~full) == []


# ---------------------------------------------------------------------------
# the wrapper: checks, then one launch
# ---------------------------------------------------------------------------

def _checks_but_the_device(t, what, dtypes, device=None, ndim=None,
                           pitched=False):
    """``build.cuda_input`` without its device check (no card here)."""
    if t.dtype not in dtypes:
        raise TypeError(f"{what}: dtype {t.dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{what}: expected {ndim} dims")
    if not t.is_contiguous():
        raise ValueError(f"{what}: must be contiguous")
    return t


class _Library:
    """Records each ``srs_launch`` call in place of the CUDA library."""

    def __init__(self):
        self.calls = []

    def srs_launch(self, *args):
        self.calls.append(args)
        return 0


class _Ops(TorchDispatchMode):
    """Records every tensor operation run under it."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.seen.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.fixture
def recorder(monkeypatch):
    lib = _Library()
    monkeypatch.setattr(build, "cuda_input", _checks_but_the_device)
    monkeypatch.setattr(build, "library", lambda verbose=False: lib)
    monkeypatch.setattr(build, "stream_of", lambda t: 0)
    return lib


@pytest.mark.parametrize("pair", INDEX_PAIRS)
def test_wrapper_is_checks_and_one_launch(recorder, pair):
    """int32 and int64 indices reach the C entry as given, with their
    flag; no tensor operation runs (no sort, cast, key arithmetic or
    allocation); the launch is counted once."""
    table = torch.zeros((6, 10))
    rows = torch.tensor([3, 0, 3], dtype=pair[0])
    ids = torch.tensor([[1, -1], [4, 4], [-1, 9]], dtype=pair[1])
    vals = torch.ones((3, 2))
    before = build.launch_counts["sparse_row_scatter"]
    with _Ops() as seen:
        out = sparse_row_scatter.launch(table, rows, ids, vals)
    assert out is table and seen.seen == []
    assert build.launch_counts["sparse_row_scatter"] == before + 1
    (args,) = recorder.calls
    assert args[:4] == (table.data_ptr(), rows.data_ptr(), ids.data_ptr(),
                        vals.data_ptr())
    bits = int(pair[0] == torch.int64) | int(pair[1] == torch.int64) << 1
    assert args[4:] == (6, 10, 3, 2, bits, 0)


@pytest.mark.parametrize("bad", ["rows", "vals", "ids_dtype", "vals_dtype",
                                 "table_dims", "empty"])
def test_wrapper_rejects_what_the_kernel_does_not_take(recorder, bad):
    table = torch.zeros((0, 10) if bad == "empty" else (6, 10))
    rows = torch.tensor([3, 0] if bad == "rows" else [3, 0, 1])
    ids = torch.zeros((3, 2), dtype=torch.int16 if bad == "ids_dtype"
                      else torch.int32)
    vals = torch.ones((3, 3) if bad == "vals" else (3, 2),
                      dtype=torch.float64 if bad == "vals_dtype"
                      else torch.float32)
    if bad == "table_dims":
        table = table[None]
    before = dict(build.launch_counts)
    with pytest.raises((ValueError, TypeError)):
        sparse_row_scatter.launch(table, rows, ids, vals)
    assert recorder.calls == [] and build.launch_counts == before


def test_wrapper_takes_only_cuda_tensors(rng):
    """On CPU tensors the kernel path raises (``ops`` runs the plain
    version there); nothing is launched or counted."""
    table, rows, ids, vals = (_t(a) for a in _inputs(rng, 6, 20, 8, 5))
    before = dict(build.launch_counts)
    with pytest.raises(ValueError, match="CUDA"):
        sparse_row_scatter.launch(table, rows, ids, vals)
    with pytest.raises(ValueError, match="CUDA"):
        ops.sparse_row_scatter(table, rows, ids, vals, impl="cuda")
    assert build.launch_counts == before
