"""tifu-knn: the paper's own system at production width, as three cells.

The port's counterpart of the JAX package's ``configs/tifu_knn.py``:

  stream_update  : one micro-batch of 16,384 basket adds, 1,024 basket
                   deletes and 1,024 item deletes (Algorithm 1 at
                   scale), applied in place to the scaled state;
  serve_topk     : TIFU-kNN prediction of 4,096 queries against the
                   1,048,576-user corpus (``knn.predict_streaming``:
                   stage A through B3, then the chunked neighbour mean);
  serve_topk_opt : the same through ``knn.distributed_predict`` over
                   ``n_shards`` contiguous row blocks of the corpus,
                   one per device (on one card every block is a view of
                   the same corpus on ``cuda:0``).

Every input is a concrete tensor built on the cell's device from
``seed``.  The histories follow the repo's synthetic generator
(``data/synthetic.py``) at the statistics of ValuedShopper, the one
dataset of the paper's Table 1 whose ~57 baskets a user fit N = 64
(avg 56.9 baskets of 9.1 items): Zipf item popularity with exponent
``synthetic.ZIPF_EXPONENT``, a preference pool of
``synthetic.pool_size(9.1)`` items a user drawn by popularity without
replacement, basket sizes Poisson around 9.1 clipped to 1..B, of which
``floor(REPEAT_BIAS · size)`` items come from the pool without
replacement and the rest by popularity (with replacement, duplicates
dropped, so a basket may hold fewer), ``n_baskets`` Poisson around 56.9
clipped to [N/8, N − N/8] (so adds find room and deletes find a basket;
at N = 64, 56% of users sit at the upper clip, 56), ``group_sizes`` as
``tifu.default_group_sizes(n, m)``, and both vector tables built from
scratch through ``tifu.closed_form_basket_weights`` (the last group's
through ``tifu.last_group_basket_weights``) and ``ops.multihot_scatter``
(B8) in chunks of users; scales and ``err_mult`` start at 1.  The serve
cells' queries are further users, built the same way and kept out of
the corpus.  A micro-batch holds at most one event per user, so the
batch's events go to distinct users; an added basket is drawn from its
user's pool as the history's were, and an item delete names an item its
basket holds.

The sizes come from one frozen :class:`Sizes`, whose defaults are the
published constants; ``stream_update`` holds ``stream_users`` of them
(the state of all 1,048,576 is 136 GiB), and says so in ``reduced``.

Each cell also takes ``mesh=`` and ``rules=`` (a named ``DeviceMesh``,
every rank calling it), as the JAX cells take them: the same seeded
inputs placed by ``cell_shardings`` over the mesh, each rank building
its own block of the vector tables or of the corpus (every history is
still drawn, the seed's sequence).  ``stream_update`` gathers the
micro-batch and applies its users' rows on its own item columns in place
(:func:`apply_on_block`); the serve cells take ``knn.predict`` and
``knn.distributed_predict``'s mesh routes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch

from repro_torch.configs.base import (ArchDef, CellProgram, generator,
                                      mesh_shape, place)
from repro_torch.core import knn
from repro_torch.core.tifu import (closed_form_basket_weights,
                                   last_group_basket_weights)
from repro_torch.core.types import (PAD_ID, AddBatch, DelBasketBatch,
                                    DelItemBatch, StreamState, TifuParams,
                                    make_user_shard_devices, resolve_device)
from repro_torch.core.updates import (apply_add_batch,
                                      apply_del_basket_batch,
                                      apply_del_item_batch)
from repro_torch.data import synthetic
from repro_torch.kernels import ops

M_USERS = 1_048_576
N_ITEMS = 16_384
MAX_BASKETS = 64
MAX_BSIZE = 32
UPDATE_BATCH = 16_384
DEL_BATCH = 1_024     # deletion traffic is ~1/16 of add traffic (§6.1)
N_QUERIES = 4_096
TOPK = 300
# stream_update's users on one 80 GB card: 2 x 32 GiB of vector tables,
# 4 GiB of history and 128 MiB of group sizes (68.1 GiB)
STREAM_USERS = 524_288
N_SHARDS = 4
# the histories' statistics: Table 1's ValuedShopper (56.9 baskets of
# 9.1 items a user), drawn as data/synthetic.py draws them
DATASET = "valuedshopper"
STATS = synthetic.DATASET_STATS[DATASET]
POOL = synthetic.pool_size(STATS["avg_basket_size"])
# users whose histories are drawn and whose vectors B8 scatters at once
# (1 GiB of [users, I] vectors at I = 16,384)
BUILD_CHUNK = 16_384


@dataclasses.dataclass(frozen=True)
class Sizes:
    """The cells' sizes: the published ones by default."""
    n_users: int = M_USERS
    n_items: int = N_ITEMS
    max_baskets: int = MAX_BASKETS
    max_basket_size: int = MAX_BSIZE
    update_batch: int = UPDATE_BATCH
    del_batch: int = DEL_BATCH
    n_queries: int = N_QUERIES
    topk: int = TOPK
    stream_users: int = STREAM_USERS     # stream_update's cut of n_users
    n_shards: int = N_SHARDS             # serve_topk_opt's row blocks


# the CPU tests' size
SMOKE_SIZES = Sizes(n_users=256, n_items=64, max_baskets=64,
                    max_basket_size=4, update_batch=64, del_batch=16,
                    n_queries=16, topk=5, stream_users=128)


def make_params(n_items: int = N_ITEMS) -> TifuParams:
    return TifuParams(n_items=n_items, group_size=7, r_b=0.9, r_g=0.7,
                      k_neighbors=TOPK, alpha=0.7)


def state_bytes(n_users: int, sz: Sizes) -> int:
    """Bytes of a ``StreamState`` of ``n_users`` at these sizes: two f32
    vector tables, i32 history and group sizes (K = N), five per-user
    scalars."""
    return n_users * (2 * 4 * sz.n_items
                      + 4 * sz.max_baskets * sz.max_basket_size
                      + 4 * sz.max_baskets + 5 * 4)


# ---------------------------------------------------------------------------
# seeded data on the device
# ---------------------------------------------------------------------------

def _popularity(n_items: int, dev: torch.device):
    """(log-probabilities f32[I], CDF f32[I]) of the Zipf popularity."""
    pop = torch.as_tensor(synthetic.zipf_popularity(n_items), device=dev)
    return pop.log().float(), pop.cumsum(0).float()


def _pools(gen: torch.Generator, n: int, sz: Sizes, dev: torch.device,
           chunk: int = 2048) -> torch.Tensor:
    """i32[n, POOL]: each user's preference pool, drawn by popularity
    without replacement (the Gumbel top-k of the log-probabilities, the
    law of numpy's ``choice(replace=False, p=...)``)."""
    log_p, _ = _popularity(sz.n_items, dev)
    out = torch.empty((n, min(POOL, sz.n_items)), dtype=torch.int32,
                      device=dev)
    for lo in range(0, n, chunk):
        g = torch.rand((min(chunk, n - lo), sz.n_items), generator=gen,
                       device=dev)
        g = g.log_().neg_().log_().neg_().add_(log_p)     # Gumbel keys
        out[lo:lo + g.shape[0]] = g.topk(out.shape[1], dim=1).indices
    return out


def _baskets(gen: torch.Generator, pools: torch.Tensor,
             lead: Tuple[int, ...], sz: Sizes,
             dev: torch.device) -> torch.Tensor:
    """i32[*lead, B] item sets of the users whose pools are ``pools``
    (i32[lead[0], P]): a size Poisson around the dataset's mean clipped
    to 1..B, ``floor(REPEAT_BIAS · size)`` items from the pool without
    replacement and the rest by popularity, duplicates dropped (so a
    basket may hold fewer), the ids ascending at the front and PAD
    after."""
    b, n_items, p = sz.max_basket_size, sz.n_items, pools.shape[1]
    _, cdf = _popularity(n_items, dev)
    mean = torch.full(lead, STATS["avg_basket_size"], device=dev)
    size = torch.poisson(mean, generator=gen).clamp_(1, b)[..., None]
    n_rep = (size * synthetic.REPEAT_BIAS).floor_().clamp_(max=p)
    # a random order of each basket's pool, its first n_rep taken
    order = torch.rand((*lead, p), generator=gen, device=dev).argsort(-1)
    pool = pools.view(lead[0], *(1,) * (len(lead) - 1), p)
    rep = pool.expand(*lead, p).gather(-1, order[..., :b])
    if rep.shape[-1] < b:
        rep = torch.cat([rep, rep.new_full((*lead, b - rep.shape[-1]),
                                           n_items)], dim=-1)
    u = torch.rand((*lead, b), generator=gen, device=dev)
    fresh = torch.searchsorted(cdf, u).clamp_(max=n_items - 1)
    j = torch.arange(b, device=dev)
    ids = torch.where(j < n_rep, rep,
                      torch.where(j < size, fresh.to(torch.int32), n_items))
    ids = ids.sort(dim=-1).values             # n_items (empty) sorts last
    dup = torch.zeros_like(ids, dtype=torch.bool)
    dup[..., 1:] = ids[..., 1:] == ids[..., :-1]
    ids = torch.where(dup, n_items, ids).sort(dim=-1).values
    return torch.where(ids < n_items, ids, PAD_ID)


def draw_users(gen: torch.Generator, n: int, sz: Sizes, group_size: int,
           dev: torch.device):
    """``n`` users' (history i32[n, N, B], group_sizes i32[n, N],
    n_baskets i32[n], n_groups i32[n], pools i32[n, P])."""
    n_b = sz.max_baskets
    lo = max(1, n_b // 8)
    mean = torch.full((n,), STATS["avg_baskets"], device=dev)
    nb = torch.poisson(mean, generator=gen).clamp_(lo, n_b - lo).long()
    t = torch.arange(n_b, device=dev)
    pools = _pools(gen, n, sz, dev)
    hist = _baskets(gen, pools, (n, n_b), sz, dev)
    hist = torch.where((t < nb[:, None])[..., None], hist, PAD_ID)
    # tifu.default_group_sizes: groups of m, the last holding the rest
    ng = (nb + group_size - 1) // group_size
    last = nb - group_size * (ng - 1)
    gs = torch.where(t < (ng - 1)[:, None], group_size,
                     torch.where(t == (ng - 1)[:, None], last[:, None], 0))
    return (hist, gs.to(torch.int32), nb.to(torch.int32),
            ng.to(torch.int32), pools)


def user_vectors(hist, gs, ng, params: TifuParams) -> torch.Tensor:
    """From-scratch user vectors (Eq. 1 + 2) through B8, f32[n, I]."""
    w = closed_form_basket_weights(gs, ng, params.r_b, params.r_g,
                                   hist.shape[1])
    return ops.multihot_scatter(hist, w, params.n_items)


def last_group_vectors(hist, gs, ng, params: TifuParams) -> torch.Tensor:
    """From-scratch last-group vectors (Eq. 1) through B8, f32[n, I]."""
    w = last_group_basket_weights(gs, ng, params.r_b, hist.shape[1])
    return ops.multihot_scatter(hist, w, params.n_items)


def rebuild_tables(state: StreamState, params: TifuParams,
                   block: Optional[Tuple[int, int, int, int]] = None
                   ) -> StreamState:
    """Both vector tables of every user from scratch, in place, in
    chunks of :data:`BUILD_CHUNK` users: the paper's retrain baseline.

    Two B8 launches a chunk (the user vector, Eq. 1 + 2, and the last
    group's, Eq. 1); the scales and ``err_mult`` become 1.  ``block``
    (u0, u1, i0, i1): the tables hold users ``[u0, u1)`` on items
    ``[i0, i1)`` of the state's whole histories (:func:`build_state`'s
    block), each user's row built alone, so the same bits.
    """
    u0, u1, i0, i1 = block or (0, state.n_users, 0, state.n_items)
    for lo in range(u0, u1, BUILD_CHUNK):
        sl = slice(lo, min(u1, lo + BUILD_CHUNK))
        hist, gs, ng = (state.history[sl], state.group_sizes[sl],
                        state.n_groups[sl])
        rows = slice(lo - u0, sl.stop - u0)
        state.user_vecs[rows] = user_vectors(hist, gs, ng, params)[:, i0:i1]
        state.last_group_vecs[rows] = last_group_vectors(
            hist, gs, ng, params)[:, i0:i1]
    state.err_mult.fill_(1.0)
    state.uv_scale.fill_(1.0)
    state.lgv_scale.fill_(1.0)
    return state


def build_state(gen: torch.Generator, n_users: int, sz: Sizes,
                params: TifuParams, dev: torch.device,
                block: Optional[Tuple[int, int, int, int]] = None
                ) -> Tuple[StreamState, torch.Tensor]:
    """A seeded state of ``n_users`` users on ``dev``, its tables from
    scratch, and the users' preference pools i32[n_users, P].

    ``block`` (u0, u1, i0, i1): the vector tables are built for users
    ``[u0, u1)`` on items ``[i0, i1)`` only, a rank's block under a mesh
    (every user's history is still drawn: the seed's sequence), and the
    other leaves stay whole; the same bits as those cells of the whole
    tables.
    """
    n_b, b, n_items = sz.max_baskets, sz.max_basket_size, sz.n_items
    u0, u1, i0, i1 = block or (0, n_users, 0, n_items)
    i32 = dict(dtype=torch.int32, device=dev)
    state = StreamState(
        user_vecs=torch.empty((u1 - u0, i1 - i0), device=dev),
        last_group_vecs=torch.empty((u1 - u0, i1 - i0), device=dev),
        history=torch.empty((n_users, n_b, b), **i32),
        group_sizes=torch.empty((n_users, n_b), **i32),
        n_baskets=torch.empty((n_users,), **i32),
        n_groups=torch.empty((n_users,), **i32),
        err_mult=torch.empty((n_users,), device=dev),
        uv_scale=torch.empty((n_users,), device=dev),
        lgv_scale=torch.empty((n_users,), device=dev))
    pools = torch.empty((n_users, min(POOL, n_items)), **i32)
    for lo in range(0, n_users, BUILD_CHUNK):
        sl = slice(lo, min(n_users, lo + BUILD_CHUNK))
        (state.history[sl], state.group_sizes[sl], state.n_baskets[sl],
         state.n_groups[sl], pools[sl]) = draw_users(
             gen, sl.stop - lo, sz, params.group_size, dev)
    return rebuild_tables(state, params, block), pools


def build_batches(gen: torch.Generator, state: StreamState,
                  pools: torch.Tensor, sz: Sizes
                  ) -> Tuple[AddBatch, DelBasketBatch, DelItemBatch]:
    """One micro-batch on ``state``'s device: ``update_batch`` adds and
    ``del_batch`` deletes of each kind, every event to its own user, no
    padding rows; an added basket is drawn from its user's pool
    (``pools``, as :func:`build_state` returns them), a basket delete
    names one of its user's baskets, an item delete an item of one of
    them.  Reads the histories and basket counts only (whole, also where
    ``build_state`` built a block of the tables)."""
    dev, n_users = state.history.device, state.history.shape[0]
    n_add, n_del = sz.update_batch, sz.del_batch
    n_ev = n_add + 2 * n_del
    if n_ev > n_users:
        raise ValueError(f"{n_ev} events need as many users, the state "
                         f"holds {n_users}")
    users = torch.randperm(n_users, generator=gen, device=dev)[:n_ev]
    ua, ub, ui = users[:n_add], users[n_add:n_add + n_del], \
        users[n_add + n_del:]

    def position(u):
        nb = state.n_baskets[u].long()
        pos = (torch.rand(u.shape, generator=gen, device=dev) * nb).long()
        return torch.minimum(pos, nb - 1)

    def valid(n):
        return torch.ones((n,), dtype=torch.bool, device=dev)

    adds = AddBatch(user=ua.to(torch.int32),
                    items=_baskets(gen, pools[ua], (n_add,), sz, dev),
                    valid=valid(n_add))
    delb = DelBasketBatch(user=ub.to(torch.int32),
                          pos=position(ub).to(torch.int32), valid=valid(n_del))
    pos = position(ui)
    row = state.history[ui, pos]
    blen = (row >= 0).sum(dim=1)
    slot = (torch.rand((n_del,), generator=gen, device=dev) * blen).long()
    slot = torch.minimum(slot, blen - 1)
    deli = DelItemBatch(user=ui.to(torch.int32), pos=pos.to(torch.int32),
                        item=row.gather(1, slot[:, None])[:, 0],
                        valid=valid(n_del))
    return adds, delb, deli


def build_corpus(gen: torch.Generator, sz: Sizes, params: TifuParams,
                 dev: torch.device,
                 block: Optional[Tuple[int, int, int, int]] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(queries f32[Q, I], corpus f32[M, I]): the user vectors of M
    seeded users, then of Q further users, built in chunks through B8;
    the histories are dropped.  ``block`` (u0, u1, i0, i1): the corpus
    rows ``[u0, u1)`` on items ``[i0, i1)`` only, a rank's block under a
    mesh (every history is still drawn; the same bits as those cells of
    the whole corpus); the queries stay whole."""
    u0, u1, i0, i1 = block or (0, sz.n_users, 0, sz.n_items)
    corpus = torch.empty((u1 - u0, i1 - i0), device=dev)
    queries = torch.empty((sz.n_queries, sz.n_items), device=dev)
    for table, (r0, r1, c0, c1) in ((corpus, (u0, u1, i0, i1)),
                                    (queries, (0, sz.n_queries, 0,
                                               sz.n_items))):
        n_rows = sz.n_users if table is corpus else sz.n_queries
        for lo in range(0, n_rows, BUILD_CHUNK):
            n = min(BUILD_CHUNK, n_rows - lo)
            hist, gs, _, ng, _ = draw_users(gen, n, sz,
                                            params.group_size, dev)
            a, b = max(lo, r0), min(lo + n, r1)
            if a < b:
                table[a - r0:b - r0] = user_vectors(
                    hist[a - lo:b - lo], gs[a - lo:b - lo],
                    ng[a - lo:b - lo], params)[:, c0:c1]
    return queries, corpus


def build_bytes(sz: Sizes) -> float:
    """A build chunk's transient: two f32 [users, I] tables of
    ``BUILD_CHUNK`` users (B8's output and its copy into the table)."""
    return 8.0 * min(BUILD_CHUNK, sz.n_users) * sz.n_items


def serve_bytes(sz: Sizes) -> float:
    """The serve cells' estimate: the f32 corpus and queries, a build
    chunk, and the prediction of the mean's chunks (one chunk's [chunk,
    8, I] gather and the [Q, I] output)."""
    return 4.0 * sz.n_items * (sz.n_users + 2 * sz.n_queries
                               + 8 * knn.MEAN_QUERY_CHUNK) + build_bytes(sz)


# ---------------------------------------------------------------------------
# the cells
# ---------------------------------------------------------------------------

def _gib(n_bytes: float) -> str:
    if n_bytes >= 2 ** 30:
        return f"{n_bytes / 2 ** 30:.1f} GiB"
    return f"{n_bytes / 2 ** 20:.1f} MiB"


def cell_shardings(shape: str, mesh: Any = None, rules: Any = None) -> tuple:
    """The JAX cell's ``in_shardings`` over ``mesh`` and ``rules``
    (default: the production mesh and ``make_rules``), from specs alone:
    ``stream_update``'s state (users over the batch axes, the vector
    tables' items over the tensor axis) and its three batches (rows over
    the batch axes), ``serve_topk``'s queries and corpus (users over the
    batch axes, items over the tensor axis), ``serve_topk_opt``'s
    queries replicated and corpus rows over every mesh axis."""
    from repro_torch.parallel.sharding import Sharding, Spec, batch_axes
    if mesh is None:
        from repro_torch.launch.mesh import make_production_mesh, make_rules
        mesh, rules = make_production_mesh(), make_rules()
    u = batch_axes(mesh, rules)
    tp = rules.tensor if rules.tensor in mesh.axis_names else None

    def sh(*entries):
        return Sharding(mesh, Spec(*entries))
    if shape == "stream_update":
        state = StreamState(
            user_vecs=sh(u, tp), last_group_vecs=sh(u, tp),
            history=sh(u, None, None), group_sizes=sh(u, None),
            n_baskets=sh(u), n_groups=sh(u), err_mult=sh(u),
            uv_scale=sh(u), lgv_scale=sh(u))
        return (state,
                AddBatch(user=sh(u), items=sh(u, None), valid=sh(u)),
                DelBasketBatch(user=sh(u), pos=sh(u), valid=sh(u)),
                DelItemBatch(user=sh(u), pos=sh(u), item=sh(u),
                             valid=sh(u)))
    if shape == "serve_topk":
        return (sh(u, tp), sh(u, tp))
    if shape == "serve_topk_opt":
        axes = tuple(a for a in ("pod", "data", "model")
                     if a in mesh.axis_names)
        return (sh(None, None), sh(axes, None))
    raise KeyError(shape)


# ---------------------------------------------------------------------------
# the mesh route
# ---------------------------------------------------------------------------

def _span(n: int, mesh: Any, axes: Tuple[str, ...]) -> Tuple[int, int]:
    """The rank's block [lo, hi) of a dim of ``n`` split over ``axes``."""
    from repro_torch.parallel import spmd
    size = n // spmd.axis_size(mesh, axes)
    lo = spmd.axis_index(mesh, axes) * size
    return lo, lo + size


def table_block(shape: Tuple[int, int], mesh: Any,
                spec: Any) -> Tuple[int, int, int, int]:
    """(u0, u1, i0, i1): the rows and columns of a [users, items] table
    laid out by ``spec`` over ``mesh`` that this rank holds."""
    return (*_span(shape[0], mesh, spec.axes(0)),
            *_span(shape[1], mesh, spec.axes(1)))


def whole_batch(batch: Any) -> Any:
    """A batch of DTensors (rows over the batch axes) with every field
    gathered whole on every rank: the micro-batch's exchange."""
    from repro_torch.parallel import spmd
    return dataclasses.replace(batch, **{
        f.name: spmd.gather_full(getattr(batch, f.name))
        for f in dataclasses.fields(batch)})


def apply_on_block(state: StreamState, adds: AddBatch,
                   delb: DelBasketBatch, deli: DelItemBatch,
                   params: TifuParams) -> StreamState:
    """``stream_update`` on a mesh, on every rank: ``state`` holds
    DTensors laid out as the cell's ``in_shardings`` lay it out (users
    over the batch axes, the vector tables' items over the tensor axis)
    and the batches rows over the batch axes.  The three batches are
    gathered whole (:func:`whole_batch`); each rank applies the rows of
    the users it holds, on the item columns it holds
    (``updates.on_user_block``, the appliers' ``cols``), IN PLACE in its
    blocks; every other row is a padding row there.  The per-user
    scalars and the history come out the same on the ranks that share
    users.  No table moves.  Returns ``state``."""
    from repro_torch.parallel import spmd
    from repro_torch.core.updates import on_user_block
    mesh = state.user_vecs.device_mesh
    u0, u1, i0, i1 = table_block(tuple(state.user_vecs.shape), mesh,
                                 spmd.spec_of(state.user_vecs))
    local = StreamState(**{f.name: spmd.local(getattr(state, f.name))
                           for f in dataclasses.fields(state)})
    with torch.no_grad():
        for apply, batch in ((apply_add_batch, adds),
                             (apply_del_basket_batch, delb),
                             (apply_del_item_batch, deli)):
            apply(local, on_user_block(whole_batch(batch), u0, u1), params,
                  cols=(i0, i1))
    return state


# ---------------------------------------------------------------------------
# the cells
# ---------------------------------------------------------------------------

def stream_update_cell(device: Any = None, seed: int = 0,
                       sizes: Optional[Sizes] = None, mesh: Any = None,
                       rules: Any = None,
                       partitions: Optional[int] = None) -> CellProgram:
    """Kind-partitioned micro-batch: adds, basket deletes, item deletes,
    each sub-batch through its sparse applier (B1 gathers, B2 scatters),
    the state updated in place.

    With a named ``DeviceMesh`` ``mesh`` and ``rules`` (every rank calls
    it): the same seeded state and batches, placed by the cell's
    ``in_shardings`` over the mesh (each rank builds the vector tables
    of its own block only; the histories of every user are drawn), and
    ``fn`` is :func:`apply_on_block`.  ``partitions`` is not read."""
    sz = sizes or Sizes()
    dev = resolve_device(device)
    params = make_params(sz.n_items)
    gen = generator(dev, seed)
    if mesh is None:
        shardings = cell_shardings("stream_update")
        state, pools = build_state(gen, sz.stream_users, sz, params, dev)
        adds, delb, deli = build_batches(gen, state, pools, sz)

        def fn(state, adds, delb, deli):
            state = apply_add_batch(state, adds, params)
            state = apply_del_basket_batch(state, delb, params)
            return apply_del_item_batch(state, deli, params)
    else:
        from repro_torch.parallel import spmd
        shardings = cell_shardings("stream_update", mesh_shape(mesh), rules)
        st = shardings[0]
        block = table_block((sz.stream_users, sz.n_items), mesh,
                            st.user_vecs.spec)
        state, pools = build_state(gen, sz.stream_users, sz, params, dev,
                                   block)
        adds, delb, deli = (place(b, sh, mesh) for b, sh in zip(
            build_batches(gen, state, pools, sz), shardings[1:]))
        # the tables are the rank's block already, the rest whole
        tables = ("user_vecs", "last_group_vecs")
        state = StreamState(**{
            f.name: spmd.from_local(getattr(state, f.name), mesh,
                                    getattr(st, f.name).spec)
            if f.name in tables else
            place(getattr(state, f.name), getattr(st, f.name), mesh)
            for f in dataclasses.fields(state)})

        def fn(state, adds, delb, deli):
            return apply_on_block(state, adds, delb, deli, params)
    del pools

    # the JAX cell's count: adds a W·log2(W) dedup sort and O(W) work on
    # W = (m+1)·B slots a row, deletes the same on W_d = N·B
    w = (params.group_size + 1) * sz.max_basket_size
    w_d = sz.max_baskets * sz.max_basket_size
    flops = sz.update_batch * (w * (w - 1).bit_length() + 4 * w) \
        + 2 * sz.del_batch * (w_d * (w_d - 1).bit_length() + 8 * w_d)
    return CellProgram(
        fn=fn, args=(state, adds, delb, deli), in_shardings=shardings,
        description=(f"kind-partitioned micro-batch adds={sz.update_batch} "
                     f"dels=2x{sz.del_batch} M={sz.stream_users} "
                     f"I={sz.n_items}"),
        model_flops_per_step=float(flops), reduced=stream_cut(sz),
        estimate_bytes=float(state_bytes(sz.stream_users, sz)
                             + build_bytes(sz)), mesh=mesh)


def stream_cut(sz: Sizes) -> dict:
    """``stream_update``'s ``reduced``: its cut of the users, with the
    bytes that force it (empty when it holds all of them)."""
    if sz.stream_users == sz.n_users:
        return {}
    return {"n_users": (
        f"{sz.n_users:,} → {sz.stream_users:,} (the state of "
        f"{sz.n_users:,} users is {_gib(state_bytes(sz.n_users, sz))}: 2 x "
        f"{_gib(4 * sz.n_users * sz.n_items)} of vector tables and "
        f"{_gib(4 * sz.n_users * sz.max_baskets * sz.max_basket_size)} of "
        f"history; {_gib(state_bytes(sz.stream_users, sz))} at "
        f"{sz.stream_users:,} fits one 80 GB card)")}


def _serve_inputs(shape: str, sz: Sizes, params: TifuParams,
                  dev: torch.device, seed: int, mesh: Any, rules: Any):
    """A serve cell's (queries, corpus) on a mesh, placed by the cell's
    ``in_shardings``: each rank builds the corpus rows and items of its
    own block only (every history is still drawn), the queries whole,
    and keeps its blocks.  Returns (queries, corpus, the shardings)."""
    from repro_torch.parallel import spmd
    shardings = cell_shardings(shape, mesh_shape(mesh), rules)
    q_sh, c_sh = shardings
    if sz.n_users % spmd.axis_size(mesh, c_sh.spec.axes(0)):
        raise ValueError(f"{sz.n_users} users do not split over "
                         f"{c_sh.spec.axes(0)}")
    queries, corpus = build_corpus(
        generator(dev, seed), sz, params, dev,
        table_block((sz.n_users, sz.n_items), mesh, c_sh.spec))
    return (place(queries, q_sh, mesh),
            spmd.from_local(corpus, mesh, c_sh.spec), shardings)


def serve_topk_cell(device: Any = None, seed: int = 0,
                    sizes: Optional[Sizes] = None, mesh: Any = None,
                    rules: Any = None,
                    partitions: Optional[int] = None) -> CellProgram:
    """``knn.predict_streaming`` of the queries against the corpus (no
    self-exclusion: the queries are other users).

    With a named ``DeviceMesh`` ``mesh`` and ``rules`` (every rank calls
    it): the same seeded data placed by the cell's ``in_shardings``
    (users over the batch axes, items over the tensor axis), and ``fn``
    is ``knn.predict(..., mesh=, rules=)``: the one-device answer from
    B3 on each rank's rows.  ``partitions`` is not read."""
    sz = sizes or Sizes()
    dev = resolve_device(device)
    params = make_params(sz.n_items)
    if mesh is None:
        shardings = cell_shardings("serve_topk")
        queries, corpus = build_corpus(generator(dev, seed), sz, params,
                                       dev)

        def fn(queries, corpus):
            return knn.predict_streaming(queries, corpus, k=sz.topk,
                                         alpha=params.alpha,
                                         exclude_self=False)
    else:
        queries, corpus, shardings = _serve_inputs(
            "serve_topk", sz, params, dev, seed, mesh, rules)

        def fn(queries, corpus):
            return knn.predict(queries, corpus, k=sz.topk,
                               alpha=params.alpha, exclude_self=False,
                               mesh=mesh, rules=rules)

    flops = 2.0 * sz.n_queries * sz.n_users * sz.n_items \
        + 2.0 * sz.n_queries * sz.topk * sz.n_items
    return CellProgram(
        fn=fn, args=(queries, corpus), in_shardings=shardings,
        description=f"kNN predict Q={sz.n_queries} M={sz.n_users} "
                    f"I={sz.n_items} k={sz.topk}",
        model_flops_per_step=flops, estimate_bytes=serve_bytes(sz),
        mesh=mesh)


def serve_topk_opt_cell(device: Any = None, seed: int = 0,
                        sizes: Optional[Sizes] = None, mesh: Any = None,
                        rules: Any = None,
                        partitions: Optional[int] = None) -> CellProgram:
    """``knn.distributed_predict`` over ``n_shards`` contiguous row
    blocks of the same corpus as ``serve_topk`` (the same seed gives the
    same data), dealt to the devices by ``make_user_shard_devices``:
    every visible card by default, else the one named; blocks on the
    corpus's device are views, not copies.

    With a named ``DeviceMesh`` ``mesh`` and ``rules`` (every rank calls
    it): the same seeded data placed by the cell's ``in_shardings``
    (queries replicated, corpus rows over every mesh axis), and ``fn`` is
    ``knn.distributed_predict``'s mesh route (B3 on each rank's rows, the
    candidates merged over "model", then "data"); ``n_shards`` is not
    read there, nor ``partitions`` anywhere."""
    sz = sizes or Sizes()
    dev = resolve_device(device)
    params = make_params(sz.n_items)
    if mesh is not None:
        queries, corpus, shardings = _serve_inputs(
            "serve_topk_opt", sz, params, dev, seed, mesh, rules)
        n_blocks = math.prod(mesh.shape)
        args = (queries, corpus)

        def fn(queries, corpus):
            return knn.distributed_predict(queries, corpus, k=sz.topk,
                                           alpha=params.alpha, mesh=mesh,
                                           rules=rules)
    else:
        if sz.n_users % sz.n_shards:
            raise ValueError(f"{sz.n_users} users do not split into "
                             f"{sz.n_shards} equal row blocks")
        shardings = cell_shardings("serve_topk_opt")
        n_blocks = sz.n_shards
        devices = make_user_shard_devices(sz.n_shards,
                                          None if device is None else [dev])
        queries, corpus = build_corpus(generator(devices[0], seed), sz,
                                       params, devices[0])
        m_loc = sz.n_users // sz.n_shards
        args = (queries, [corpus[s * m_loc:(s + 1) * m_loc].to(d)
                          for s, d in enumerate(devices)])
        del corpus

        def fn(queries, blocks):
            return knn.distributed_predict(queries, blocks, k=sz.topk,
                                           alpha=params.alpha)

    # the JAX cell's definition: the scores, and the neighbour mean as a
    # one-hot [Q, M] x [M, I] matmul
    flops = 2.0 * sz.n_queries * sz.n_users * sz.n_items \
        + 2.0 * sz.n_queries * sz.n_users * sz.n_items
    return CellProgram(
        fn=fn, args=args, in_shardings=shardings,
        description=f"kNN predict (opt, {n_blocks} row blocks) "
                    f"Q={sz.n_queries} M={sz.n_users} I={sz.n_items} "
                    f"k={sz.topk}",
        model_flops_per_step=flops, estimate_bytes=serve_bytes(sz),
        mesh=mesh)


def smoke_config() -> TifuParams:
    return TifuParams(n_items=64, group_size=3)


ARCH = ArchDef(
    name="tifu-knn", family="tifu",
    cells={"stream_update": stream_update_cell,
           "serve_topk": serve_topk_cell,
           "serve_topk_opt": serve_topk_opt_cell},
    make_smoke=smoke_config,
    notes="the paper's system at production width on one card: "
          "stream_update at 524,288 users, the serve cells over all "
          "1,048,576; serve_topk_opt is the user-sharded variant over "
          "contiguous row blocks. Under a mesh: users over the batch "
          "axes, the tables' items over the tensor axis; serve_topk_opt's "
          "rows over every axis.")
