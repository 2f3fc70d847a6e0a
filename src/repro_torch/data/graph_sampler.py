"""Graph data pipeline (numpy): CSR neighbour sampling (GraphSAGE-style
layered fanout) and partition-aware DimeNet triplet construction.

The port's own copy of ``repro/data/graph_sampler.py`` (the port imports
nothing of the JAX package): for the same seed every array is the
reference's, bit for bit.  ``LayeredSampler.sample`` draws a seed batch
and fans out per layer from a CSR adjacency.  ``build_triplets`` emits
(tri_kj, tri_ji) lists whose edges are partition-local (both edges of a
triplet fall in the same edge-range partition; cross-partition angles
are dropped, the approximation that keeps distributed message passing
local).  ``molecule_batch`` batches small random molecules.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass
class CSRGraph:
    indptr: np.ndarray     # [N+1]
    indices: np.ndarray    # [E]
    n_nodes: int

    @staticmethod
    def random(n_nodes: int, avg_degree: int, seed: int = 0) -> "CSRGraph":
        rng = np.random.default_rng(seed)
        degrees = rng.poisson(avg_degree, n_nodes).clip(1)
        indptr = np.concatenate([[0], np.cumsum(degrees)])
        indices = rng.integers(0, n_nodes, indptr[-1])
        return CSRGraph(indptr.astype(np.int64), indices.astype(np.int64),
                        n_nodes)


class LayeredSampler:
    """Uniform fanout sampling (fanouts like [15, 10])."""

    def __init__(self, graph: CSRGraph, fanouts, seed: int = 0):
        self.g = graph
        self.fanouts = list(fanouts)
        self.rng = np.random.default_rng(seed)

    def sample(self, seeds: np.ndarray):
        """Returns (sub_src, sub_dst, node_map) for the sampled subgraph;
        edges are directed neighbour→target per GraphSAGE layer."""
        src_all, dst_all = [], []
        frontier = np.unique(seeds)
        nodes = [frontier]
        for fan in self.fanouts:
            s_list, d_list = [], []
            for v in frontier:
                lo, hi = self.g.indptr[v], self.g.indptr[v + 1]
                nbrs = self.g.indices[lo:hi]
                if len(nbrs) == 0:
                    continue
                take = self.rng.choice(nbrs, size=min(fan, len(nbrs)),
                                       replace=False)
                s_list.append(take)
                d_list.append(np.full(len(take), v))
            if not s_list:
                break
            s = np.concatenate(s_list)
            d = np.concatenate(d_list)
            src_all.append(s)
            dst_all.append(d)
            frontier = np.unique(s)
            nodes.append(frontier)
        src = np.concatenate(src_all) if src_all else np.zeros(0, np.int64)
        dst = np.concatenate(dst_all) if dst_all else np.zeros(0, np.int64)
        node_map = np.unique(np.concatenate(nodes))
        return src, dst, node_map


def build_triplets(src: np.ndarray, dst: np.ndarray, n_partitions: int = 1,
                   max_per_edge: int = 8, seed: int = 0
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """DimeNet triplets: for edge e=(j→i), feeder edges f=(k→j).

    Returns LOCAL edge indices (tri_kj, tri_ji) per partition concatenated
    — both ends of each triplet lie in the same edge-id partition
    (partition-aware sampling), so the distributed gather stays local.
    """
    rng = np.random.default_rng(seed)
    n_edges = len(src)
    part = max(n_edges // n_partitions, 1)
    tri_kj, tri_ji = [], []
    for p in range(n_partitions):
        lo, hi = p * part, min((p + 1) * part, n_edges)
        if lo >= hi:
            break
        # edges into each node within this partition
        by_dst = {}
        for e in range(lo, hi):
            by_dst.setdefault(dst[e], []).append(e)
        for e in range(lo, hi):
            feeders = by_dst.get(src[e], [])
            feeders = [f for f in feeders if f != e]
            if not feeders:
                continue
            take = feeders if len(feeders) <= max_per_edge else \
                list(rng.choice(feeders, size=max_per_edge, replace=False))
            for f in take:
                tri_kj.append(f - lo)   # local index within partition
                tri_ji.append(e - lo)
    return (np.asarray(tri_kj, np.int32), np.asarray(tri_ji, np.int32))


def pad_to(x: np.ndarray, n: int, fill=0):
    out = np.full((n,) + x.shape[1:], fill, dtype=x.dtype)
    out[:len(x)] = x[:n]
    return out


def molecule_batch(n_graphs: int, nodes_per_graph: int = 30,
                   edges_per_graph: int = 64, seed: int = 0):
    """Batched small molecules: positions → a flat graph with offsets."""
    rng = np.random.default_rng(seed)
    z, pos, src, dst, graph_id = [], [], [], [], []
    off = 0
    for g in range(n_graphs):
        z.append(rng.integers(1, 10, nodes_per_graph))
        pos.append(rng.normal(scale=2.0, size=(nodes_per_graph, 3)))
        s = rng.integers(0, nodes_per_graph, edges_per_graph) + off
        d = rng.integers(0, nodes_per_graph, edges_per_graph) + off
        src.append(s)
        dst.append(d)
        graph_id.append(np.full(nodes_per_graph, g))
        off += nodes_per_graph
    return (np.concatenate(z).astype(np.int32),
            np.concatenate(pos).astype(np.float32),
            np.concatenate(src).astype(np.int32),
            np.concatenate(dst).astype(np.int32),
            np.concatenate(graph_id).astype(np.int32))
