"""The row blend's plan, the cross-shard row addresses and B1's indices.

``serving_topn.plan_rows`` decides from the shapes alone how the CUDA
kernel of ``blend_topn_rows`` / ``blend_topn_rows_quant``
(``csrc/serving_rows.cu``) cuts a launch: a tile of 4 KB of each row a
block (1,024 f32 or 4,096 int8 items), an 8-slot ring, a selection for
n <= 32 and a bitonic sort above it, and the shared memory the C entry
checks.  ``knn._owner_row_addresses`` gives the kernel the address of
each selected row where it lies in the shard corpora, in place of the
[Q, k, I] gather ``knn._owner_rows`` writes; ``build.index_as_given``
hands ``sparse_row_gather`` its int32 or int64 indices uncast.  The
kernels run only on the card (``chip_smoke.py`` holds them bitwise
against a sum in order j = 0..k-1 and against their plain versions);
here the contracts around them are held on their own, and the plain
row blend and gather against the JAX package at the new tiles' edges.

Tolerances: exact.  Addresses, plans and index maps are integers;
integer-valued corpora make every fp32 sum exact and every tie a true
tie, and int8 is exact by construction.
"""
import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.sparse_row_gather import sparse_row_gather as jgather
from repro.optim.compression import quantize_int8_rows as jquant
from repro_torch.core import knn
from repro_torch.kernels import build, ops, serving_topn, sparse_row_gather

SMEM_MAX = 232448                # a block's shared memory on an H100
ROWS_CU = (build.CSRC / "serving_rows.cu").read_text()
TOPNS = (1, 10, 32, 33, 1024)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _c_int(name):
    return int(re.search(rf"constexpr int {name} = ([^;]+);",
                         ROWS_CU).group(1).split("//")[0].split()[0])


def _int_corpus(rng, m, d):
    c = rng.integers(0, 3, (m, d)).astype(np.float32)
    c[1::4] = c[0]                                  # duplicate rows
    return c


# ---------------------------------------------------------------------------
# plan_rows
# ---------------------------------------------------------------------------

def test_plan_constants_are_the_kernel_sources():
    tile = re.search(r"constexpr int kTile = sizeof\(T\) == 1 \? (\d+) : "
                     r"(\d+);", ROWS_CU)
    assert serving_topn.ROWS_TILE == {1: int(tile.group(1)),
                                      4: int(tile.group(2))}
    assert serving_topn.ROWS_STAGES == _c_int("STAGES")
    assert serving_topn.ROWS_MAX_SELECT == _c_int("MAX_SELECT")
    assert serving_topn.ROWS_MAX_ENDS == _c_int("MAX_ENDS")
    assert serving_topn.ROWS_THREADS == _c_int("NT") + 32


@pytest.mark.parametrize("elem", [4, 1], ids=["f32", "int8"])
@pytest.mark.parametrize("topn", TOPNS)
def test_plan_at_tafeng(elem, topn):
    q_n, n_items = 256, 11997
    p = serving_topn.plan_rows(q_n, n_items, topn, elem)
    assert p.tile * elem == 4096                    # 4 KB of each row
    assert p.stages == 8
    assert p.select == (topn <= 32)
    assert p.n_tiles == -(-n_items // p.tile)
    assert p.grid == (p.n_tiles, q_n)
    assert p.list_len == min(topn, p.tile)
    assert p.n2 >= max(p.list_len, topn) and p.n2 & (p.n2 - 1) == 0
    assert p.n2 < 2 * topn or p.n2 == 1
    ring = p.stages * (4096 + 16)
    lists = 8 * 32 * 8 if p.select else p.tile * 8
    assert p.smem_bytes == max(ring, lists) + p.stages * 24
    assert p.smem_bytes < SMEM_MAX
    # the tile's lists reuse the ring once its rows are summed
    assert lists <= ring


@pytest.mark.parametrize("elem", [4, 1], ids=["f32", "int8"])
def test_plan_grid_covers_every_item_once(elem):
    for n_items in (1, 1023, 1024, 1025, 4095, 4096, 4097, 11997):
        p = serving_topn.plan_rows(3, n_items, 1, elem)
        assert (p.n_tiles - 1) * p.tile < n_items <= p.n_tiles * p.tile


@pytest.mark.parametrize("topn", [0, 12, 1025])
def test_plan_rejects_topn(topn):
    with pytest.raises(ValueError, match="topn"):
        serving_topn.plan_rows(2, 11 if topn == 12 else 11997, topn, 4)


# ---------------------------------------------------------------------------
# the cross-shard row addresses
# ---------------------------------------------------------------------------

def _shard_tables(rng, n_users, n_shards, dtype, width, pad):
    """Round-robin shard tables whose rows lie at a pitch of width + pad
    elements (a ``[:, :width]`` view of a wider buffer)."""
    tables = []
    for s in range(n_shards):
        m_s = len(range(s, n_users, n_shards))
        buf = rng.integers(-100, 100, (m_s, width + pad))
        tables.append(torch.from_numpy(buf).to(dtype)[:, :width])
    return tables


@pytest.mark.parametrize("n_shards", [2, 3, 5])
@pytest.mark.parametrize("dtype,width,pad", [
    (torch.float32, 37, 2), (torch.float32, 16, 1), (torch.float32, 11, 0),
    (torch.int8, 37, 6), (torch.int8, 21, 0)])
def test_owner_row_addresses_match_owner_rows(rng, n_shards, dtype, width,
                                              pad):
    """Each address is ``data_ptr + local · pitch`` of the owner shard,
    and the bytes there are the row ``_owner_rows`` fetches: the same
    (shard, local row) for every gid."""
    n_users = 23
    tables = _shard_tables(rng, n_users, n_shards, dtype, width, pad)
    gids = torch.from_numpy(rng.integers(0, n_users, (4, 7)))
    gids[0, :n_users % 7] = torch.arange(n_users % 7)
    addr = knn._owner_row_addresses(tables, gids, n_shards)
    rows = knn._owner_rows(tables, gids, n_shards)
    assert addr.dtype == torch.int64 and addr.shape == gids.shape
    elem = tables[0].element_size()
    for (q, j), g in np.ndenumerate(gids.numpy()):
        s, local = g % n_shards, g // n_shards
        pitch = tables[s].stride(0) * elem
        assert pitch == (width + pad) * elem
        assert int(addr[q, j]) == tables[s].data_ptr() + local * pitch
        assert ctypes.string_at(int(addr[q, j]), width * elem) == \
            rows[q, j].numpy().tobytes()


def test_owner_row_addresses_of_int32_gids(rng):
    """The merged candidates arrive as int64; the query ids as int32."""
    tables = _shard_tables(rng, 9, 2, torch.float32, 5, 0)
    gids = torch.tensor([8, 0, 3], dtype=torch.int32)
    assert torch.equal(knn._owner_row_addresses(tables, gids, 2),
                       knn._owner_row_addresses(tables, gids.long(), 2))


def test_in_place_blend_takes_only_cuda_tensors():
    c = torch.rand((6, 16))
    addr = serving_topn._row_addresses(c, torch.tensor([[1, 2], [3, 4]]))
    before = dict(build.launch_counts)
    with pytest.raises(ValueError, match="CUDA"):
        serving_topn.launch_rows_at(c[:2], addr, [c], 0.5, 3)
    with pytest.raises(ValueError, match="CUDA"):
        ops.blend_topn_rows_at(c[:2], addr, [c], 0.5, 3)
    assert build.launch_counts == before


# ---------------------------------------------------------------------------
# the plain row blend against JAX at the tiles' edges
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_items", [1023, 1025, 4095, 4097])
def test_blend_rows_at_tile_edges_match_jax(rng, n_items):
    c = _int_corpus(rng, 19, n_items)
    uids = rng.choice(19, 3, replace=False)
    nbr = rng.integers(0, 19, size=(3, 5))
    got = ops.blend_topn_rows(_t(c[uids]), _t(c[nbr]), 0.5, 33)
    exp = jref.blend_topn_rows_ref(jnp.asarray(c[uids]), jnp.asarray(c[nbr]),
                                   0.5, 33)
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
    jq, js = (np.asarray(a) for a in jquant(jnp.asarray(c)))
    got_q = ops.blend_topn_rows_quant(_t(jq[uids]), _t(js[uids]),
                                      _t(jq[nbr]), _t(js[nbr]), 0.5, 10)
    exp_q = jref.blend_topn_rows_quant_ref(
        jnp.asarray(jq[uids]), jnp.asarray(js[uids]), jnp.asarray(jq[nbr]),
        jnp.asarray(js[nbr]), 0.5, 10)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(exp_q))


# ---------------------------------------------------------------------------
# sparse_row_gather's indices
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


@pytest.mark.parametrize("rows_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("ids_dtype", [torch.int32, torch.int64])
def test_gather_indices_are_taken_as_given(monkeypatch, rows_dtype,
                                           ids_dtype):
    """int32 and int64 indices pass to the kernel as they are: no cast,
    and no copy of a contiguous tensor; the flag names each dtype."""
    monkeypatch.setattr(build, "cuda_input", _checks_but_the_device)
    rows = torch.tensor([3, 0, 2], dtype=rows_dtype)
    ids = torch.tensor([[1, -1], [4, 4], [-1, 0]], dtype=ids_dtype)
    got_rows = build.index_as_given(rows, "rows", None, 1)
    got_ids = build.index_as_given(ids, "ids", None, 2)
    assert got_rows is rows and got_ids is ids
    assert build.index_bits(got_rows, got_ids) == \
        int(rows_dtype == torch.int64) + 2 * int(ids_dtype == torch.int64)
    strided = build.index_as_given(ids.t(), "ids", None, 2)
    assert strided.is_contiguous() and strided.dtype == ids_dtype
    assert torch.equal(strided, ids.t())


def test_gather_indices_of_other_dtypes_raise(monkeypatch):
    monkeypatch.setattr(build, "cuda_input", _checks_but_the_device)
    with pytest.raises(TypeError, match="rows"):
        build.index_as_given(torch.zeros(3), "rows", None, 1)
    with pytest.raises(ValueError, match="dims"):
        build.index_as_given(torch.zeros(3, dtype=torch.int64), "ids",
                             None, 2)


@pytest.mark.parametrize("rows_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("ids_dtype", [torch.int32, torch.int64])
def test_gather_of_either_index_dtype_matches_jax(rng, rows_dtype,
                                                  ids_dtype):
    """The add applier's dtypes (int64 rows, int32 ids) and the others
    read the same values; JAX's Pallas kernel in interpret mode."""
    table = rng.normal(size=(13, 256)).astype(np.float32)
    rows = rng.integers(0, 13, 7)
    ids = rng.integers(-1, 256, (7, 19))
    got = ops.sparse_row_gather(_t(table), _t(rows).to(rows_dtype),
                                _t(ids).to(ids_dtype))
    exp = jgather(jnp.asarray(table), jnp.asarray(rows, jnp.int32),
                  jnp.asarray(ids, jnp.int32), bi=128, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
