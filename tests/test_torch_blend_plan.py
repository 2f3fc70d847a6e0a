"""B4's order of additions, its plan, and its wrapper's contract.

The CUDA kernels of ``blend_topn_onehot`` (``csrc/serving_topn.cu``) run
only on the card, where ``chip_smoke.py`` holds them bitwise against
``ref.blend_topn_ordered_ref``.  Here, on the CPU:

  * the ordered plain version against ``ref.blend_topn_ref`` and against
    the JAX package's reference and its Pallas kernel in interpret mode;
  * ``serving_topn.plan_blend``'s grid and shared-memory bytes, and its
    constants against the CUDA source's;
  * the plan kernel transcribed (bitmap rounds over the row ids, a
    prefix count of the words, each query's slots grouped by staging
    pass) against a numpy construction, and the blend kernel's walk of
    those slots transcribed against the ordered plain version, bit for
    bit, over the edge cases;
  * the wrapper's checks and its one call, with the library replaced by
    a recorder.

Tolerances:
  * the ordered version against JAX and ``ref.blend_topn_ref`` --
    bitwise on small-integer corpora with alpha = 1/2 and k a power of
    two (every fp32 step exact), else ``rtol=1e-5, atol=1e-6`` as in
    ``tests/test_torch_kernels.py`` (those sum the rows in another
    order);
  * the transcriptions -- bitwise: both add in the same order in
    float32.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.kernels import ref as jref
from repro.kernels.serving_topn import blend_topn_onehot as jblend
from repro_torch.kernels import build, ops, ref, serving_topn

ALPHA = 0.7
NO_SLOT = serving_topn.NO_SLOT


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _inputs(rng, m, items, q_n, k, integer=False, out_of_range=True):
    """A corpus, user ids and neighbour lists with repeated rows across
    and within queries, PAD entries (-1, still counted in k), an
    all-PAD query and, with ``out_of_range``, entries >= M and user ids
    outside [0, M) (they add 0)."""
    if integer:
        c = rng.integers(0, 3, (m, items)).astype(np.float32)
        c[1::4] = c[0]
    else:
        c = rng.random((m, items)).astype(np.float32)
    uid = rng.integers(0, m, q_n)
    nbr = rng.integers(-1, m, (q_n, k))
    if k > 1:
        nbr[:, 1] = nbr[:, 0]                       # a row twice
    nbr[0, :] = nbr[1 % q_n, :]                     # two queries alike
    nbr[-1, :] = -1                                 # an all-PAD query
    if out_of_range:
        nbr[q_n // 2, ::2] = m + 3
        uid[q_n // 3] = -2
        uid[-1] = m
    return c, uid, nbr


def _ordered(c, uid, nbr, n, alpha=ALPHA, passes=None):
    v, i = ref.blend_topn_ordered_ref(
        _t(c), _t(uid), _t(nbr), alpha, n,
        None if passes is None else _t(passes))
    return v.numpy(), i.numpy()


# ---------------------------------------------------------------------------
# the ordered plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,items,q_n,k,n", [
    (41, 67, 13, 8, 9), (30, 31, 5, 1, 31), (1, 40, 4, 3, 10),
    (60, 100, 37, 16, 33)])
def test_ordered_ref_matches_jax_on_integers(rng, m, items, q_n, k, n):
    """alpha = 1/2 and k a power of two keep every fp32 step exact, so
    values and the lowest-item tie-break agree bit for bit."""
    c, uid, nbr = _inputs(rng, m, items, q_n, k, integer=True,
                          out_of_range=False)
    got_v, got_i = _ordered(c, uid, nbr, n, alpha=0.5)
    args = (jnp.asarray(c), jnp.asarray(uid, jnp.int32),
            jnp.asarray(nbr, jnp.int32))
    for exp_v, exp_i in (
            jblend(*args, alpha=0.5, topn=n, bq=8, bm=16, bi=32,
                   interpret=True),
            ref.blend_topn_ref(_t(c), _t(uid), _t(nbr), 0.5, n)):
        np.testing.assert_array_equal(got_v, np.asarray(exp_v))
        np.testing.assert_array_equal(got_i, np.asarray(exp_i))
    rows = np.where(nbr[..., None] >= 0, c[np.maximum(nbr, 0)], 0.0)
    exp_i = jref.blend_topn_rows_ref(jnp.asarray(c[uid]), jnp.asarray(rows),
                                     0.5, n)
    np.testing.assert_array_equal(got_i, np.asarray(exp_i))


@pytest.mark.parametrize("m,items,q_n,k,n", [
    (43, 71, 11, 7, 10), (64, 96, 40, 30, 20)])
def test_ordered_ref_matches_jax_on_floats(rng, m, items, q_n, k, n):
    c, uid, nbr = _inputs(rng, m, items, q_n, k, out_of_range=False)
    got_v, _ = _ordered(c, uid, nbr, n)
    exp_v, _ = jblend(jnp.asarray(c), jnp.asarray(uid, jnp.int32),
                      jnp.asarray(nbr, jnp.int32), alpha=ALPHA, topn=n,
                      bq=8, bm=16, bi=32, interpret=True)
    np.testing.assert_allclose(got_v, np.asarray(exp_v), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("group,stage_rows", [(None, None), (4, 5), (3, 1),
                                              (32, 64)])
@pytest.mark.parametrize("m,items,q_n,k,n", [
    (50, 70, 13, 9, 10), (200, 64, 40, 30, 33), (3, 33, 6, 2, 31)])
def test_ordered_ref_in_passes_matches_plain(rng, group, stage_rows, m,
                                             items, q_n, k, n):
    """In passes or not, the ordered sum is the plain blend up to the
    order of its additions; out-of-range rows and users add 0."""
    c, uid, nbr = _inputs(rng, m, items, q_n, k)
    passes = None if group is None else \
        ref.blend_passes(_t(nbr), m, group, stage_rows).numpy()
    got_v, got_i = _ordered(c, uid, nbr, n, passes=passes)
    exp_v, _ = ref.blend_topn_ref(_t(c), _t(uid), _t(nbr), ALPHA, n)
    np.testing.assert_allclose(got_v, exp_v.numpy(), rtol=1e-5, atol=1e-6)
    # the ids are score-equivalent: their exact scores are the values
    valid = (nbr >= 0) & (nbr < m)
    rows = np.where(valid[..., None], c[np.clip(nbr, 0, m - 1)], 0.0)
    own = np.where(((uid >= 0) & (uid < m))[:, None],
                   c[np.clip(uid, 0, m - 1)], 0.0)
    pred = ALPHA * own.astype(np.float64) + (1 - ALPHA) * rows.astype(
        np.float64).sum(1) / k
    np.testing.assert_allclose(np.take_along_axis(pred, got_i.astype(
        np.int64), 1), exp_v.numpy(), rtol=1e-5, atol=1e-6)


def test_ordered_ref_sums_in_order_j(rng):
    """Rows of mixed magnitudes: the ordered version's bits are those of
    a float32 loop over j, not of torch.sum."""
    m, items, q_n, k = 20, 50, 6, 40
    c = (rng.normal(size=(m, items))
         * 10.0 ** rng.integers(-4, 5, (m, 1))).astype(np.float32)
    uid = rng.integers(0, m, q_n)
    nbr = rng.integers(-1, m, (q_n, k))
    acc = np.zeros((q_n, items), np.float32)
    for j in range(k):
        row = np.where((nbr[:, j] >= 0)[:, None], c[np.maximum(nbr[:, j], 0)],
                       np.float32(0))
        acc = (acc + row).astype(np.float32)
    pred = (np.float32(ALPHA) * c[uid]
            + (np.float32(1 - ALPHA) * acc) / np.float32(k))
    order = np.argsort(-pred, axis=1, kind="stable")[:, :items]
    got_v, got_i = _ordered(c, uid, nbr, items)
    np.testing.assert_array_equal(got_i, order)
    np.testing.assert_array_equal(got_v, np.take_along_axis(pred, order, 1))


# ---------------------------------------------------------------------------
# plan_blend: constants, grid and bytes
# ---------------------------------------------------------------------------

def _source():
    return (Path(serving_topn.__file__).parent / "csrc" /
            "serving_topn.cu").read_text()


def test_constants_are_the_kernels():
    const = {name: int(v, 0) for name, v in re.findall(
        r"constexpr int (k\w+) = (0x[0-9a-f]+|\d+);", _source())}
    assert const["kTile"] == serving_topn.BLEND_TILE
    assert const["kThreads"] == serving_topn.BLEND_THREADS
    assert const["kQuads"] == serving_topn.BLEND_QUADS
    assert const["kBitmapWords"] == serving_topn.PLAN_BITMAP_WORDS
    assert const["kMaxSelect"] == serving_topn.BLEND_MAX_SELECT
    assert const["kNoSlot"] == NO_SLOT
    assert const["kPhases"] == 7
    assert re.search(r"__launch_bounds__\(kThreads, (\d+)\) "
                     r"blend_group_kernel", _source()).group(1) == \
        str(serving_topn.BLEND_BLOCKS_PER_SM)


def test_plan_at_the_main_paths_shape():
    """Q=256 TaFeng users, k=300, n=10 on 132 SMs: 8 groups of 32 x 32
    strips of 12 tiles, two blocks an SM."""
    plan = serving_topn.plan_blend(256, 13949, 11997, 300, 10, 132)
    assert plan == serving_topn.BlendPlan(
        group=32, groups=8, select=True, stage_rows=687, strips=32,
        tiles_per_strip=12, list_len=10, n2=16, smem_bytes=115712,
        plan_smem_bytes=84992, grid=(8, 32))


@pytest.mark.parametrize("q_n,m,items,k,n,sms", [
    (256, 13949, 11997, 300, 10, 132), (32, 13949, 11997, 300, 10, 132),
    (1024, 13949, 11997, 300, 10, 132), (256, 13949, 11997, 300, 33, 132),
    (256, 13949, 11997, 300, 1024, 132), (37, 5, 31, 1, 31, 132),
    (1, 1, 1, 1, 1, 132), (300, 1 << 20, 1 << 20, 16, 10, 132),
    (256, 13949, 11997, 3000, 10, 132), (5, 100, 40, 40_000, 10, 8),
    (7, 100, 4096, 300, 32, 1)])
def test_plan_contract(q_n, m, items, k, n, sms):
    plan = serving_topn.plan_blend(q_n, m, items, k, n, sms)
    budget = (serving_topn.SM_SHARED_BYTES // serving_topn.BLEND_BLOCKS_PER_SM
              - serving_topn.BLOCK_RESERVED_BYTES)
    n_tiles = -(-items // serving_topn.BLEND_TILE)
    assert 1 <= plan.group <= min(serving_topn.BLEND_GROUP, q_n)
    assert plan.group * k < NO_SLOT
    assert plan.groups == -(-q_n // plan.group)
    assert plan.select == (n <= serving_topn.BLEND_MAX_SELECT)
    assert plan.n2 >= n and plan.n2 & (plan.n2 - 1) == 0
    assert plan.n2 < 2 * n or n == 1
    assert plan.stage_rows >= min(serving_topn.MIN_STAGE_ROWS,
                                  plan.group * k)
    assert plan.stage_rows <= plan.group * k
    assert plan.smem_bytes == serving_topn.blend_smem_bytes(
        plan.group, k, plan.n2, plan.select, plan.stage_rows) <= budget
    assert plan.smem_bytes % 16 == 0 or plan.stage_rows == plan.group * k
    assert plan.plan_smem_bytes == serving_topn.plan_smem_bytes(
        plan.group, k) <= 232_448
    # the strips cover the tiles, none empty, and fill the SMs' blocks
    assert plan.strips * plan.tiles_per_strip >= n_tiles
    assert (plan.strips - 1) * plan.tiles_per_strip < n_tiles
    assert plan.grid == (plan.groups, plan.strips)
    assert plan.strips <= max(1, sms * serving_topn.BLEND_BLOCKS_PER_SM
                              // plan.groups)
    assert plan.list_len == min(n, plan.tiles_per_strip
                                * serving_topn.BLEND_TILE)


@pytest.mark.parametrize("q_n,m,items,k,n", [
    (4, 10, 20, 3, 21), (4, 10, 2000, 3, 1025), (4, 10, 20, 3, 0),
    (4, 10, 20, 0, 5), (0, 10, 20, 3, 5), (4, 10, 20, 60_000, 5),
    (4, 10, 20, 120_000, 5)])
def test_plan_refuses(q_n, m, items, k, n):
    with pytest.raises(ValueError):
        serving_topn.plan_blend(q_n, m, items, k, n, 132)


def test_plan_groups_shrink_for_long_lists_and_k():
    """n = 1,024 keeps a [G, 1,024] list a query in shared memory, and a
    large k a [G, k] slot table: both cut the group, not the staging
    area below its least."""
    assert serving_topn.plan_blend(256, 13949, 11997, 300, 1024,
                                   132).group == 11
    plan = serving_topn.plan_blend(256, 13949, 11997, 3000, 10, 132)
    assert plan.group == 16 and plan.stage_rows >= serving_topn.MIN_STAGE_ROWS


# ---------------------------------------------------------------------------
# the plan kernel and the blend's walk, transcribed
# ---------------------------------------------------------------------------

def _plan_kernel(nbr, m, group, stage_rows):
    """``blend_plan_kernel`` transcribed: per group, rounds of
    PLAN_BITMAP_WORDS * 32 row ids -- a bitmap of the entries in the
    round, the exclusive prefix of its words' counts, the rows in slot
    order, each entry's slot -- then each query's slots pass by pass in
    order j (the warp's ballot compaction), no-slot marks to the row's
    end of kp.  Returns (rows, D, cnt, ent) per group."""
    q_n, k = nbr.shape
    kp = -(-k // 8) * 8
    span_max = serving_topn.PLAN_BITMAP_WORDS * 32
    out = []
    for q0 in range(0, q_n, group):
        gq = min(group, q_n - q0)
        ents = nbr[q0:q0 + gq].reshape(-1)
        slot = [NO_SLOT] * ents.size
        rows, base = [], 0
        for c0 in range(0, m, span_max):
            span = min(span_max, m - c0)
            bits = [0] * (-(-span // 32))
            for r in ents.tolist():
                if 0 <= r - c0 < span:
                    bits[(r - c0) >> 5] |= 1 << ((r - c0) & 31)
            pre, run = [], base
            for w in bits:
                pre.append(run)
                run += bin(w).count("1")
            for w, b in enumerate(bits):
                rows += [c0 + 32 * w + i for i in range(32) if b >> i & 1]
            for e, r in enumerate(ents.tolist()):
                if 0 <= r - c0 < span:
                    w, i = (r - c0) >> 5, (r - c0) & 31
                    slot[e] = pre[w] + bin(bits[w] & ((1 << i) - 1)).count(
                        "1")
            base = run
        n_pass = -(-base // stage_rows)
        ent = np.full((group, kp), NO_SLOT, np.int64)
        cnt = np.zeros(group, np.int64)
        for q in range(gq):
            mine = []
            for p in range(n_pass):
                lo, hi = p * stage_rows, (p + 1) * stage_rows
                for j0 in range(0, k, 32):
                    lanes = [slot[q * k + j]
                             for j in range(j0, min(k, j0 + 32))]
                    mine += [s for s in lanes if s != NO_SLOT and lo <= s < hi]
            ent[q, :len(mine)] = mine
            cnt[q] = len(mine)
        out.append((rows, base, cnt, ent))
    return out


def _plan_numpy(nbr, m, group, stage_rows):
    """The same plan built another way: np.unique, searchsorted and a
    stable sort by pass."""
    q_n, k = nbr.shape
    out = []
    for q0 in range(0, q_n, group):
        blk = nbr[q0:q0 + group]
        valid = (blk >= 0) & (blk < m)
        rows = np.unique(blk[valid])
        cnt, ent = [], []
        for q in range(blk.shape[0]):
            s = np.searchsorted(rows, blk[q][valid[q]])
            s = s[np.argsort(s // stage_rows, kind="stable")]
            cnt.append(s.size)
            ent.append(s)
        out.append((rows.tolist(), rows.size, cnt, ent))
    return out


PLAN_CASES = [
    # (m, q_n, k, group, stage_rows, entries from)
    (50, 13, 9, 4, 5, "mixed"), (50, 13, 9, 32, 687, "mixed"),
    (7, 37, 1, 32, 64, "mixed"), (1, 5, 3, 32, 64, "mixed"),
    (300, 40, 30, 32, 16, "mixed"), (300, 9, 40, 3, 1, "mixed"),
    (600_000, 6, 50, 4, 7, "wide"), (600_000, 4, 20, 4, 3, "wide"),
    (20, 8, 16, 8, 64, "pad")]


def _plan_entries(rng, m, q_n, k, kind):
    if kind == "pad":
        nbr = np.full((q_n, k), -1, np.int64)
        nbr[1, 3] = m - 1
        return nbr
    if kind == "wide":       # ids in several bitmap rounds; past 2^31
        nbr = rng.integers(0, m, (q_n, k))
        nbr[0, :4] = [m - 1, 0, 262_143, 262_144]
        nbr[1, :3] = [-5, 2 ** 31 + 5, 2 ** 40]
        nbr[2, ::3] = m + 9
        return nbr
    nbr = rng.integers(-1, m + 2, (q_n, k))
    if k > 1:
        nbr[:, 1] = nbr[:, 0]
    nbr[-1, :] = -1
    return nbr


@pytest.mark.parametrize("m,q_n,k,group,stage_rows,kind", PLAN_CASES)
def test_plan_kernel_matches_numpy(rng, m, q_n, k, group, stage_rows, kind):
    nbr = _plan_entries(rng, m, q_n, k, kind)
    got = _plan_kernel(nbr, m, group, stage_rows)
    exp = _plan_numpy(nbr, m, group, stage_rows)
    assert len(got) == len(exp) == -(-q_n // group)
    for (rows, d, cnt, ent), (e_rows, e_d, e_cnt, e_ent) in zip(got, exp):
        assert rows == e_rows and d == e_d
        for q, (c, s) in enumerate(zip(e_cnt, e_ent)):
            assert cnt[q] == c
            assert ent[q, :c].tolist() == s.tolist()
            assert (ent[q, c:] == NO_SLOT).all()
    passes = ref.blend_passes(_t(nbr), m, group, stage_rows).numpy()
    valid = (nbr >= 0) & (nbr < m)
    for g, (rows, _, _, _) in enumerate(exp):
        blk = slice(g * group, (g + 1) * group)
        slots = np.searchsorted(np.asarray(rows, np.int64), nbr[blk])
        np.testing.assert_array_equal(
            np.where(valid[blk], slots // stage_rows, 0), passes[blk])


def _walk(ent_q, cnt, d, stage_rows, rows_of, values):
    """The blend kernel's walk of one query's slots at one item,
    transcribed: per pass, the aligned chunks of 8 from the one holding
    the next entry, an entry out of the pass adding the zero row's
    +0.0; each pass's sum added to the total."""
    total = np.float32(0)
    c = 0
    for p in range(-(-d // stage_rows)):
        lo, hi = p * stage_rows, min((p + 1) * stage_rows, d)
        acc = np.float32(0)
        b, skip = c & ~7, c - (c & ~7)
        while True:
            chunk = ent_q[b:b + 8] if b < cnt else [NO_SLOT] * 8
            take = [u >= skip and chunk[u] < hi for u in range(8)]
            if not any(take):
                break
            for u in range(8):
                acc = np.float32(acc + (values[rows_of[chunk[u]]]
                                        if take[u] else np.float32(0)))
            c += sum(take)
            b, skip = b + 8, 0
        total = np.float32(total + acc)
    return total


@pytest.mark.parametrize("m,q_n,k,group,stage_rows", [
    (60, 13, 19, 4, 5), (60, 13, 19, 32, 687), (300, 9, 40, 3, 2),
    (9, 5, 1, 32, 1), (1, 6, 7, 4, 64)])
def test_blend_walk_is_the_ordered_sum(rng, m, q_n, k, group, stage_rows):
    """The kernel's walk over the transcribed plan, blended with the
    kernel's rounding, is bit for bit ``blend_topn_ordered_ref`` in the
    same passes, and with one pass the sum in order j = 0..k-1."""
    items = 12
    c = (rng.normal(size=(m, items))
         * 10.0 ** rng.integers(-3, 4, (m, 1))).astype(np.float32)
    uid = rng.integers(-1, m + 1, q_n)
    nbr = _plan_entries(rng, m, q_n, k, "mixed")
    pred = np.zeros((q_n, items), np.float32)
    for g, (rows, d, cnt, ent) in enumerate(
            _plan_kernel(nbr, m, group, stage_rows)):
        for ql in range(len(cnt)):
            q = g * group + ql
            if q >= q_n:
                break
            own = c[uid[q]] if 0 <= uid[q] < m else np.zeros(items,
                                                             np.float32)
            for i in range(items):
                tot = _walk(ent[ql].tolist(), int(cnt[ql]), d, stage_rows,
                            rows, c[:, i])
                pred[q, i] = (np.float32(ALPHA) * own[i]
                              + (np.float32(1 - ALPHA) * tot) / np.float32(k))
    order = np.argsort(-pred, axis=1, kind="stable")
    passes = ref.blend_passes(_t(nbr), m, group, stage_rows).numpy()
    got_v, got_i = _ordered(c, uid, nbr, items, passes=passes)
    np.testing.assert_array_equal(got_i, order)
    np.testing.assert_array_equal(got_v, np.take_along_axis(pred, order, 1))
    if passes.max() == 0:
        one_v, one_i = _ordered(c, uid, nbr, items)
        np.testing.assert_array_equal(one_v, got_v)
        np.testing.assert_array_equal(one_i, got_i)


# ---------------------------------------------------------------------------
# the wrapper: checks, one allocation of scratch, one call
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
    """Records each ``blend_topn_launch`` call in place of the library."""

    def __init__(self):
        self.calls = []

    def blend_topn_launch(self, *args):
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
    monkeypatch.setattr(serving_topn, "_sm_count", lambda dev: 132)
    return lib


@pytest.mark.parametrize("uid_dt", [torch.int32, torch.int64])
@pytest.mark.parametrize("nbr_dt", [torch.int32, torch.int64])
@pytest.mark.parametrize("n", [10, 33])
def test_wrapper_is_checks_and_one_call(recorder, uid_dt, nbr_dt, n):
    """Indices reach the C entry as given, with their flag; the only
    tensor operations are the three allocations (scratch, values,
    items); the plan's fields and the scratch's five parts follow; one
    launch is counted."""
    corpus = torch.zeros((50, 70))
    uid = torch.arange(37, dtype=uid_dt)
    nbr = torch.zeros((37, 300), dtype=nbr_dt)
    before = build.launch_counts["blend_topn_onehot"]
    with _Ops() as ops_seen:
        out_v, out_i = serving_topn.launch(corpus, uid, nbr, ALPHA, n)
    assert ops_seen.seen == ["aten.empty.memory_format"] * 3
    assert build.launch_counts["blend_topn_onehot"] == before + 1
    assert out_v.shape == out_i.shape == (37, n)
    assert (out_v.dtype, out_i.dtype) == (torch.float32, torch.int32)
    (args,) = recorder.calls
    plan = serving_topn.plan_blend(37, 50, 70, 300, n, 132)
    bits = int(uid_dt == torch.int64) | int(nbr_dt == torch.int64) << 1
    assert args[:3] == (corpus.data_ptr(), uid.data_ptr(), nbr.data_ptr())
    assert args[3:19] == (bits, 37, 50, 70, 300, pytest.approx(ALPHA),
                          pytest.approx(1 - ALPHA), n, plan.group,
                          plan.stage_rows, plan.strips,
                          plan.tiles_per_strip, plan.list_len, plan.n2,
                          plan.smem_bytes, plan.plan_smem_bytes)
    prow, pcnt, pent, part_v, part_i = args[19:24]
    g_q = plan.groups * plan.group
    sizes = [g_q * 300 * 4, plan.groups * (plan.group + 1) * 4,
             g_q * 304 * 2, 37 * plan.strips * plan.list_len * 4]
    starts = [prow, pcnt, pent, part_v, part_i]
    assert all(s % 16 == 0 for s in starts)
    for a, b, size in zip(starts, starts[1:], sizes + sizes[-1:]):
        assert b - a == -(-size // 16) * 16
    assert args[24:] == (out_v.data_ptr(), out_i.data_ptr(), 0)


@pytest.mark.parametrize("bad", ["q", "topn_items", "topn_max", "topn_zero",
                                 "k0", "corpus_dtype", "corpus_dims",
                                 "uid_dtype", "nbr_dims"])
def test_wrapper_rejects_what_the_kernels_do_not_take(recorder, bad):
    corpus = torch.zeros((50, 2000 if bad == "topn_max" else 70),
                         dtype=torch.float64 if bad == "corpus_dtype"
                         else torch.float32)
    if bad == "corpus_dims":
        corpus = corpus[None]
    uid = torch.arange(36 if bad == "q" else 37,
                       dtype=torch.float32 if bad == "uid_dtype"
                       else torch.int32)
    nbr = torch.zeros((37, 0 if bad == "k0" else 5), dtype=torch.int32)
    if bad == "nbr_dims":
        nbr = nbr[None]
    n = {"topn_items": 71, "topn_max": 1025, "topn_zero": 0}.get(bad, 10)
    before = dict(build.launch_counts)
    with pytest.raises((ValueError, TypeError)):
        serving_topn.launch(corpus, uid, nbr, ALPHA, n)
    assert recorder.calls == [] and build.launch_counts == before


def test_wrapper_takes_only_cuda_tensors(rng):
    """On CPU tensors the kernel path raises (``ops`` runs the plain
    version there); nothing is launched or counted."""
    c, uid, nbr = _inputs(rng, 20, 30, 6, 4, out_of_range=False)
    before = dict(build.launch_counts)
    with pytest.raises(ValueError, match="CUDA"):
        serving_topn.launch(_t(c), _t(uid), _t(nbr), ALPHA, 5)
    with ops.default_impl("cuda"):
        with pytest.raises(ValueError, match="CUDA"):
            ops.fused_recommend(_t(c), _t(uid), k=3, alpha=ALPHA, topn=5)
    assert build.launch_counts == before
