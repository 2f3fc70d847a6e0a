"""dimenet [arXiv:2003.03123]: n_blocks=6 d_hidden=128 n_bilinear=8
n_spherical=7 n_radial=6.

The port's copy of ``repro/configs/dimenet_cfg.py``: ``CELLS``,
``make_config``, ``smoke_config`` and ``ARCH``.  All four cells are
training regimes (``dimenet`` train steps with AdamW).
Non-geometric graphs take ``dist`` / ``angle`` as inputs.  Edge and
triplet counts are padded to multiples of 512 with ghost entries
(node 0 → node 0 at the cutoff distance, where the radial basis is 0).

``cell_batch`` builds a seeded batch at a cell's sizes on a device:
molecules from ``graph_sampler.molecule_batch`` with their geometry, or
a random graph with bag-of-words node features, synthetic distances and
angles, and a class per node.  ``SMOKE_CELLS`` are the same two kinds
of graph at test sizes, for ``make_config(cell, smoke=True)``.

A cell's :class:`GraphBatch` runs its graph divided by a power of two
(nodes, edges and triplets together; molecules stay whole): the cut
rule takes the least that fits the card (``peak_bytes``).
``full_graph_sm``, ``minibatch_lg`` and ``molecule`` run uncut; the
uncut ``ogb_products`` needs more cards than one.  On the mesh route
the graph is :func:`partitioned_batch`'s, one equal edge partition a
rank.
"""
import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchDef, CellBatch, Leaves, recsys_cell
from repro_torch.core.types import resolve_device
from repro_torch.data.graph_sampler import (molecule_batch, pad_to,
                                            partition_triplets,
                                            sample_triplets)
from repro_torch.models import dimenet
from repro_torch.parallel.sharding import Sharding, Spec


def _pad(n, m=512):
    return (n + m - 1) // m * m


CELLS = {
    # cora-like: 2708 nodes, 10556 edges (padded 10752), 1433 feats
    "full_graph_sm": dict(n_nodes=2708, n_edges=_pad(10556),
                          n_tri=_pad(42240), d_feat=1433, n_targets=7,
                          geometric=False),
    # reddit-like sampled: 1024 seeds, fanout 15-10 → padded subgraph
    "minibatch_lg": dict(n_nodes=174080, n_edges=169984, n_tri=1699840,
                         d_feat=602, n_targets=41, geometric=False),
    # ogbn-products full batch: 61,859,140 edges (padded 61,859,328);
    # triplets capped at 1×E (sampled)
    "ogb_products": dict(n_nodes=2449029, n_edges=_pad(61859140),
                         n_tri=_pad(61859140), d_feat=100, n_targets=47,
                         geometric=False),
    # 128 molecules × 30 atoms, 64 edges each
    "molecule": dict(n_nodes=3840, n_edges=8192, n_tri=32768,
                     d_feat=0, n_targets=1, geometric=True, n_graphs=128),
}

# the two kinds of graph at test sizes (unpadded counts: the graph's own)
SMOKE_CELLS = {
    "full_graph_sm": dict(n_nodes=40, n_edges=120, n_tri=512, d_feat=24,
                          n_targets=5, geometric=False),
    "molecule": dict(n_nodes=40, n_edges=96, n_tri=256, d_feat=0,
                     n_targets=1, geometric=True, n_graphs=4),
}


def make_config(cell: str = "molecule",
                smoke: bool = False) -> dimenet.DimeNetConfig:
    """The published widths with ``cell``'s input mode and targets
    (``smoke``: :func:`smoke_config`'s widths, ``SMOKE_CELLS[cell]``'s
    mode and targets)."""
    g = (SMOKE_CELLS if smoke else CELLS)[cell]
    base = smoke_config() if smoke else dimenet.DimeNetConfig()
    return dataclasses.replace(base, d_node_feat=g["d_feat"],
                               n_targets=g["n_targets"])


def smoke_config() -> dimenet.DimeNetConfig:
    """Two narrow blocks, for tests on the CPU."""
    return dimenet.DimeNetConfig(n_blocks=2, d_hidden=32, n_bilinear=4,
                                 n_spherical=3, n_radial=4)


def cell_batch(g: Dict[str, Any], seed: int = 0,
               device: Any = None) -> Dict[str, torch.Tensor]:
    """A seeded batch of cell ``g`` (an entry of ``CELLS`` or
    ``SMOKE_CELLS``) on ``device`` (CUDA unless the caller names
    another).  Molecules: ``n_graphs`` of ``n_nodes / n_graphs`` atoms
    and ``n_edges / n_graphs`` edges, distances and angles from their
    positions by ``dimenet.geometry_from_positions`` (the reference's
    angles, near π/2), one N(0, 1) target each.  Other graphs: uniform random
    edges, node features of 0/1 words (2% set), distances uniform in
    (0.5, cutoff), angles in [0, π), and a class per node.  The cutoff is
    ``DimeNetConfig``'s, which no cell changes.

    The first edges are ghosts (node 0 → node 0 at the cutoff: one for
    molecules, 2% of the others), and the triplets of ``sample_triplets``
    (at most 8 per edge, in edge order) are cut or padded to ``n_tri``,
    the padding with triplets of edge 0, so it adds nothing: the radial
    gate of a ghost edge is 0."""
    dev = resolve_device(device)
    cutoff = dimenet.DimeNetConfig.cutoff
    rng = np.random.default_rng(seed)
    e, n = g["n_edges"], g["n_nodes"]
    if g["geometric"]:
        k = g["n_graphs"]
        z, pos, src, dst, gid = molecule_batch(k, n // k, e // k, seed=seed)
        ghost = 1
    else:
        src = rng.integers(0, n, e).astype(np.int32)
        dst = rng.integers(0, n, e).astype(np.int32)
        ghost = e // 50
    src[:ghost] = dst[:ghost] = 0
    t = g["n_tri"]
    tkj, tji = sample_triplets(src, dst, seed=seed, limit=t)
    batch = {"edge_src": src, "edge_dst": dst,
             "tri_kj": pad_to(tkj, t), "tri_ji": pad_to(tji, t)}
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    if g["geometric"]:
        dist, batch["angle"] = dimenet.geometry_from_positions(
            torch.from_numpy(pos).to(dev), batch["edge_src"],
            batch["edge_dst"], batch["tri_kj"], batch["tri_ji"])
        batch["dist"] = dist.index_fill(
            0, torch.arange(ghost, device=dev), cutoff)
        batch.update(z=torch.from_numpy(z).to(dev),
                     graph_id=torch.from_numpy(gid).to(dev),
                     labels=torch.from_numpy(rng.normal(size=k).astype(
                         np.float32)).to(dev))
        return batch
    dist = rng.uniform(0.5, cutoff, e).astype(np.float32)
    dist[:ghost] = cutoff
    host = {"dist": dist,
            "angle": rng.uniform(0.0, np.pi, t).astype(np.float32),
            "node_feat": (rng.random((n, g["d_feat"])) < 0.02).astype(
                np.float32),
            "labels": rng.integers(0, g["n_targets"], n).astype(np.int64)}
    batch.update({k: torch.from_numpy(v).to(dev) for k, v in host.items()})
    return batch


def partitioned_batch(g: Dict[str, Any], n_partitions: int, seed: int = 0,
                      device: Any = None
                      ) -> Tuple[Dict[str, torch.Tensor],
                                 Dict[str, torch.Tensor]]:
    """A seeded batch of cell ``g`` cut into ``n_partitions`` equal edge
    partitions for ``dimenet.forward_sharded``: (the batch with each
    partition's triplet indices LOCAL to it, the same batch with them
    offset to global edge ids, for the single-device forward).

    Molecules: the edges are ``molecule_batch``'s, the first of each
    partition a ghost (node 0 → node 0 at the cutoff, radial gate 0); the
    triplets are :func:`~repro_torch.data.graph_sampler.
    partition_triplets`' (at most 8 per edge, within a partition), each
    partition's padded with triplets of its ghost to ``n_tri /
    n_partitions`` (or its longest list, whichever is more), so every
    partition holds as many edges and triplets.  Angles from the
    positions on the global indices.  Other graphs: :func:`cell_batch`'s
    kind of graph with each partition's first edge a ghost and its
    triplets drawn by ``sample_triplets`` within it."""
    if not g["geometric"]:
        return _partitioned_graph(g, n_partitions, seed, device)
    dev = resolve_device(device)
    cutoff = dimenet.DimeNetConfig.cutoff
    rng = np.random.default_rng(seed)
    e, n, k = g["n_edges"], g["n_nodes"], g["n_graphs"]
    if e % n_partitions:
        raise ValueError(f"{e} edges in {n_partitions} equal partitions")
    z, pos, src, dst, gid = molecule_batch(k, n // k, e // k, seed=seed)
    part = e // n_partitions
    ghosts = np.arange(n_partitions) * part
    src[ghosts] = dst[ghosts] = 0
    tkj, tji, counts = partition_triplets(src, dst, n_partitions, seed=seed)
    per = max(int(counts.max()), -(-g["n_tri"] // n_partitions))
    kj = np.zeros((n_partitions, per), np.int32)
    ji = np.zeros((n_partitions, per), np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)])
    for p, c in enumerate(counts):
        kj[p, :c] = tkj[starts[p]:starts[p + 1]]
        ji[p, :c] = tji[starts[p]:starts[p + 1]]
    offset = ghosts[:, None].astype(np.int32)
    local = {"tri_kj": kj.reshape(-1), "tri_ji": ji.reshape(-1)}
    whole = {"tri_kj": (kj + offset).reshape(-1),
             "tri_ji": (ji + offset).reshape(-1)}
    common = {k_: torch.from_numpy(v).to(dev) for k_, v in
              {"edge_src": src, "edge_dst": dst, "z": z, "graph_id": gid,
               "labels": rng.normal(size=k).astype(np.float32)}.items()}
    whole = {**common, **{k_: torch.from_numpy(v).to(dev)
                          for k_, v in whole.items()}}
    dist, angle = dimenet.geometry_from_positions(
        torch.from_numpy(pos).to(dev), whole["edge_src"], whole["edge_dst"],
        whole["tri_kj"], whole["tri_ji"])
    dist = dist.index_fill(0, torch.from_numpy(ghosts).to(dev), cutoff)
    whole.update(dist=dist, angle=angle)
    local = {**common, "dist": dist, "angle": angle,
             **{k_: torch.from_numpy(v).to(dev) for k_, v in local.items()}}
    return local, whole


def _partitioned_graph(g: Dict[str, Any], n_partitions: int, seed: int,
                       device: Any) -> Tuple[Dict[str, torch.Tensor],
                                             Dict[str, torch.Tensor]]:
    """:func:`partitioned_batch` of a non-geometric graph: uniform random
    edges, each partition's first edge a ghost, up to ``n_tri /
    n_partitions`` triplets a partition by ``sample_triplets`` within it
    (padded with its ghost's), distances, angles, node features and
    classes as :func:`cell_batch` draws them.  Edge and triplet counts
    that the partitions do not divide are padded up with ghosts."""
    dev = resolve_device(device)
    cutoff = dimenet.DimeNetConfig.cutoff
    rng = np.random.default_rng(seed)
    n = g["n_nodes"]
    part = -(-g["n_edges"] // n_partitions)
    per = -(-g["n_tri"] // n_partitions)
    e = part * n_partitions
    src = np.zeros(e, np.int32)
    dst = np.zeros(e, np.int32)
    src[:g["n_edges"]] = rng.integers(0, n, g["n_edges"])
    dst[:g["n_edges"]] = rng.integers(0, n, g["n_edges"])
    ghosts = np.arange(n_partitions) * part
    src[ghosts] = dst[ghosts] = 0
    kj = np.zeros((n_partitions, per), np.int32)
    ji = np.zeros((n_partitions, per), np.int32)
    for p in range(n_partitions):
        lo = p * part
        a, b = sample_triplets(src[lo:lo + part], dst[lo:lo + part],
                               seed=seed + p, limit=per)
        kj[p, :len(a)], ji[p, :len(b)] = a[:per], b[:per]
    dist = rng.uniform(0.5, cutoff, e).astype(np.float32)
    dist[ghosts] = cutoff
    dist[g["n_edges"]:] = cutoff
    host = {"edge_src": src, "edge_dst": dst, "dist": dist,
            "angle": rng.uniform(0.0, np.pi, n_partitions * per).astype(
                np.float32),
            "node_feat": (rng.random((n, g["d_feat"])) < 0.02).astype(
                np.float32),
            "labels": rng.integers(0, g["n_targets"], n).astype(np.int64)}
    common = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    offset = ghosts[:, None].astype(np.int32)
    local = {**common, "tri_kj": torch.from_numpy(kj.reshape(-1)).to(dev),
             "tri_ji": torch.from_numpy(ji.reshape(-1)).to(dev)}
    whole = {**common,
             "tri_kj": torch.from_numpy((kj + offset).reshape(-1)).to(dev),
             "tri_ji": torch.from_numpy((ji + offset).reshape(-1)).to(dev)}
    return local, whole


# ---------------------------------------------------------------------------
# the cells
# ---------------------------------------------------------------------------

def scaled(g: Dict[str, Any], f: int, c: dimenet.DimeNetConfig
           ) -> Dict[str, Any]:
    """Graph ``g`` divided by ``f`` (nodes, edges and triplets; whole
    molecules), with ``c``'s input width and targets."""
    out = dict(g, n_nodes=max(1, g["n_nodes"] // f),
               n_edges=max(1, g["n_edges"] // f),
               n_tri=max(1, g["n_tri"] // f), d_feat=c.d_node_feat,
               n_targets=c.n_targets)
    if g["geometric"]:
        k = max(1, g["n_graphs"] // f)
        out.update(n_graphs=k, n_nodes=k * (g["n_nodes"] // g["n_graphs"]),
                   n_edges=k * (g["n_edges"] // g["n_graphs"]))
    return out


def peak_bytes(c: dimenet.DimeNetConfig, g: Dict[str, Any]) -> float:
    """The estimated peak of a train step: the f32 parameters with their
    gradient, m and v; per edge ~22 [E, D] f32 tensors (the six blocks'
    saved messages, a block's recomputed activations and their
    gradients), per triplet ~12 [T, D] (the gathered messages, the
    bilinear product and their gradients) and two copies of the
    spherical basis; per node the features and 4 [N, D]; the int64
    copies of every index."""
    e, t, n = g["n_edges"], g["n_tri"], g["n_nodes"]
    d = c.d_hidden
    return (16 * c.n_params() + 4 * d * (22 * e + 12 * t)
            + 8 * c.n_spherical * c.n_radial * t
            + 4 * n * (g["d_feat"] + 4 * d) + 16 * (e + t) + 8 * n)


# the leaves with one row per edge or triplet
EDGE_LEAVES = ("edge_src", "edge_dst", "dist", "angle", "tri_kj", "tri_ji")


class GraphBatch(CellBatch):
    """A cell's graph divided by ``f`` (the batch the cut rule moves: 1,
    2, 4, ... up to a graph of one edge), built by :func:`cell_batch`."""

    n = 1
    cut_note = "the uncut graph needs the sharded path on more cards than one"

    def __init__(self, cell: str):
        self.cell = cell

    def graph(self, c, f: int) -> Dict[str, Any]:
        return scaled(CELLS[self.cell], f, c)

    def candidates(self):
        e = CELLS[self.cell]["n_edges"]
        return [1 << k for k in range(e.bit_length())]

    def words(self, f: int) -> str:
        g = CELLS[self.cell]
        return (f"1/{f:,} of the graph ({max(1, g['n_nodes'] // f):,} "
                f"nodes, {max(1, g['n_edges'] // f):,} edges)"
                if f > 1 else f"the whole graph ({g['n_nodes']:,} nodes, "
                f"{g['n_edges']:,} edges)")

    def leaves(self, c, f: int) -> Leaves:
        g = self.graph(c, f)
        e, t, n = g["n_edges"], g["n_tri"], g["n_nodes"]
        i32, f32 = torch.int32, torch.float32
        out = {"edge_src": ((e,), i32), "edge_dst": ((e,), i32),
               "dist": ((e,), f32), "angle": ((t,), f32),
               "tri_kj": ((t,), i32), "tri_ji": ((t,), i32)}
        if g["geometric"]:
            out.update(z=((n,), i32), graph_id=((n,), i32),
                       labels=((g["n_graphs"],), f32))
        else:
            out.update(node_feat=((n, g["d_feat"]), f32),
                       labels=((n,), torch.int64))
        return out

    def make(self, c, f: int, gen: torch.Generator, seed: int):
        return cell_batch(self.graph(c, f), seed, gen.device)

    partitioned = True

    def make_partitioned(self, c, f, gen, seed, parts, local):
        pair = partitioned_batch(self.graph(c, f), parts, seed, gen.device)
        return pair[0] if local else pair[1]

    def shardings(self, c, f, mesh, rules):
        """The edge and triplet leaves over ("data", "model"), the node
        and graph leaves replicated (a one-entry spec, as the
        reference's)."""
        graph = Spec(tuple(a for a in ("data", "model")
                           if a in mesh.axis_names))
        return {k: Sharding(mesh, graph if k in EDGE_LEAVES
                            else Spec(None))
                for k in self.leaves(c, f)}


def _flops(cell: str):
    def f(c, div: int = 1) -> float:
        g = scaled(CELLS[cell], div, c)
        d, b = c.d_hidden, c.n_bilinear
        per_block = (2 * g["n_edges"] * d * d * 2       # msg MLPs
                     + g["n_tri"] * (d * b + b * b * d)  # bilinear path
                     + 2 * g["n_edges"] * d * d)         # output blocks
        return 6.0 * c.n_blocks * per_block              # fwd+bwd
    return f


def _cell(cell: str):
    batch = GraphBatch(cell)
    return recsys_cell(
        dimenet, lambda: make_config(cell), batch, f"dimenet {cell} train",
        train=True, flops_fn=_flops(cell),
        peak_fn=lambda c, div: peak_bytes(c, batch.graph(c, div)))


ARCH = ArchDef(
    name="dimenet", family="gnn",
    cells={cell: _cell(cell) for cell in CELLS},
    make_smoke=smoke_config,
    notes="triplet-gather regime; segment sums by index_add; dist/angle "
          "are inputs for non-geometric graphs; ogb_products on a graph "
          "divided by a power of two (the uncut graph needs more cards "
          "than one).")
