"""dimenet [arXiv:2003.03123]: n_blocks=6 d_hidden=128 n_bilinear=8
n_spherical=7 n_radial=6.

The port's copy of ``repro/configs/dimenet_cfg.py``: ``CELLS``,
``make_config`` and ``smoke_config`` (the arch registry and its mesh
cells stay with the JAX package).  All four cells are training regimes.
Non-geometric graphs take ``dist`` / ``angle`` as inputs.  Edge and
triplet counts are padded to multiples of 512 with ghost entries
(node 0 → node 0 at the cutoff distance, where the radial basis is 0).

``cell_batch`` builds a seeded batch at a cell's sizes on a device:
molecules from ``graph_sampler.molecule_batch`` with their geometry, or
a random graph with bag-of-words node features, synthetic distances and
angles, and a class per node.  ``SMOKE_CELLS`` are the same two kinds
of graph at test sizes, for ``make_config(cell, smoke=True)``.
"""
import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.types import resolve_device
from repro_torch.data.graph_sampler import (build_triplets, molecule_batch,
                                            pad_to)
from repro_torch.models import dimenet


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
    molecules, 2% of the others), and the triplets of ``build_triplets``
    (at most 8 per edge) are padded to ``n_tri`` with triplets of edge 0,
    so the padding adds nothing: the radial gate of a ghost edge is 0."""
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
    tkj, tji = build_triplets(src, dst, seed=seed)
    t = g["n_tri"]
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
