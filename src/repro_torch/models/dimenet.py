"""DimeNet (Klicpera et al., arXiv:2003.03123): directional message
passing with radial (RBF) and spherical (SBF) bases over edge triplets.

The port of ``repro/models/dimenet.py``.  Messages live on edges; each
interaction block aggregates over triplets (k→j, j→i) with an
angle-dependent bilinear transform and scatters back to edges, then
an output block scatters edges to nodes.  The reference's
``jax.ops.segment_sum`` is ``index_add`` into zeros here: atomic on the
card, so a sum's order (and its last bits) may differ between runs
there; the CPU's is sequential.

Graph inputs are index lists (``geometry_from_positions`` computes the
distances and angles of molecules; other graphs bring them as inputs):

  z / node_feat  [N]         atomic numbers (or [N, d_feat] features)
  edge_src/dst   [E]         message direction j→i: src=j, dst=i
  dist           [E]         d_ji
  tri_kj/tri_ji  [T]         triplet edge indices into [E]
  angle          [T]         α(kj, ji)
  graph_id       [N]         molecule id for the batched readout
  labels         [G] / [N]   regression targets per molecule, or
                             classes per node (−1: unlabelled)

As in the reference, ``head`` is a parameter that ``forward`` never
reads (its gradient is zero).  The reference's ``jax.lax.scan`` over
``jax.checkpoint(block)`` is a loop over the stacked blocks, each
recomputed in backward (``torch.utils.checkpoint``) when autograd is
on.  ``make_train_step(c, optimizer)`` gives ``train_step(model, batch)
-> {"loss"}`` (``common.train_step_of``); ``serve_step`` runs under
``torch.no_grad()``.  Row gathers run through ``F.embedding``, whose
backward sums runs of equal indices (the padding triplets' edge 0, a
molecule's few atom types) by segments.

Sharded (``forward_sharded``, and ``loss_fn`` / ``make_train_step`` /
``serve_step`` with a mesh): the reference's edge-partitioned
``shard_map``: the edge and triplet arrays split evenly over ("data",
"model") (a partition per rank, triplet indices LOCAL to it, see
``data.graph_sampler.build_triplets``), nodes and parameters
replicated, each block's node aggregate ``psum``-ed over those axes.
The parameters a rank uses on its own edges enter through ``pvary``
(their gradients summed over the ranks); the output block's, used
after the ``psum``, do not: each gradient is the single-device one.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.types import resolve_device
from repro_torch.models.common import (masked_xent, normal_, replicated,
                                       train_step_of)
from repro_torch.models.embedding import InvalidIdError
from repro_torch.parallel import spmd
from repro_torch.parallel.sharding import MeshShape, ShardingRules, Spec

Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class DimeNetConfig:
    """The published DimeNet widths: 6 blocks, d_hidden 128, 8 bilinear,
    7 spherical × 6 radial bases."""

    name: str = "dimenet"
    n_blocks: int = 6
    d_hidden: int = 128
    n_bilinear: int = 8
    n_spherical: int = 7
    n_radial: int = 6
    cutoff: float = 5.0
    n_species: int = 95          # atomic-number embedding rows
    d_node_feat: int = 0         # >0: feature-input mode (non-geometric)
    n_targets: int = 1           # regression targets / classes
    dtype: torch.dtype = torch.float32

    def n_params(self) -> int:
        """The reference's formula, letter for letter (an estimate: the
        model's leaves hold another number of weights)."""
        d, b = self.d_hidden, self.n_bilinear
        nsb = self.n_spherical * self.n_radial
        emb = (self.n_species if not self.d_node_feat
               else self.d_node_feat) * d
        per_block = (d * d * 4            # msg MLPs
                     + self.n_radial * d  # rbf proj
                     + nsb * b            # sbf proj
                     + d * b + b * d      # bilinear down/up
                     + d * d * 2 + d * self.n_targets)  # output block
        return emb + self.n_radial * d + d * d \
            + self.n_blocks * per_block + d * self.n_targets


# -- bases -------------------------------------------------------------------

def rbf_basis(dist: torch.Tensor, n_radial: int,
              cutoff: float) -> torch.Tensor:
    """Radial Bessel basis ``sin(nπd/c)/d`` under the C2 envelope
    [E, n_radial]."""
    d = torch.clamp(dist, min=1e-6)[..., None] / cutoff          # [E, 1]
    n = torch.arange(1, n_radial + 1, dtype=torch.float32,
                     device=dist.device)
    basis = math.sqrt(2.0 / cutoff) * torch.sin(n * math.pi * d) / d
    u = torch.clamp(d, 0, 1)
    env = 1 - 6 * u ** 5 + 15 * u ** 4 - 10 * u ** 3
    return basis * env


def sbf_basis(dist: torch.Tensor, angle: torch.Tensor, n_spherical: int,
              n_radial: int, cutoff: float) -> torch.Tensor:
    """The reference's simplified spherical basis: ``cos(l·α)`` times the
    radial Bessel terms, [T, n_spherical · n_radial]."""
    dev = angle.device
    l = torch.arange(n_spherical, dtype=torch.float32, device=dev)
    ang = torch.cos(angle[..., None] * (l + 1.0))                 # [T, S]
    d = torch.clamp(dist, min=1e-6)[..., None] / cutoff
    n = torch.arange(1, n_radial + 1, dtype=torch.float32, device=dev)
    rad = torch.sin(n * math.pi * d) / d                          # [T, R]
    return (ang[..., :, None] * rad[..., None, :]).reshape(
        angle.shape[0], n_spherical * n_radial)


def geometry_from_positions(pos: torch.Tensor, edge_src: torch.Tensor,
                            edge_dst: torch.Tensor, tri_kj: torch.Tensor,
                            tri_ji: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The molecular frontend: each edge's length [E] and each triplet's
    angle [T] from atom positions [N, 3].

    As the reference, which writes ``jnp.linalg.norm(v1, -1)``: the -1 is
    ``ord``, so every triplet's dot product is divided by the product of
    the two [T, 3] matrices' smallest column sums of |x| (one scalar),
    not by its own edge lengths, and the angles sit near π/2."""
    vec = pos[edge_dst.long()] - pos[edge_src.long()]           # j→i
    dist = torch.linalg.norm(vec, dim=-1)
    v1 = -vec[tri_kj.long()]                                    # j→k
    v2 = vec[tri_ji.long()]
    cosang = torch.sum(v1 * v2, -1) / torch.clamp(
        torch.linalg.norm(v1, -1) * torch.linalg.norm(v2, -1), min=1e-9)
    return dist, torch.arccos(torch.clamp(cosang, -1 + 1e-7, 1 - 1e-7))


# -- params ------------------------------------------------------------------

def param_shapes(c: DimeNetConfig) -> Dict[str, Any]:
    """Shapes of the JAX parameter tree (the blocks stacked ``[L, ...]``)."""
    d, b, nsb = c.d_hidden, c.n_bilinear, c.n_spherical * c.n_radial
    emb_rows = c.d_node_feat if c.d_node_feat else c.n_species
    blocks = {
        "w_msg1": (c.n_blocks, d, d), "w_msg2": (c.n_blocks, d, d),
        "w_rbf": (c.n_blocks, c.n_radial, d),
        "w_sbf": (c.n_blocks, nsb, b),
        "w_down": (c.n_blocks, d, b),
        "w_bilinear": (c.n_blocks, b, b, d),
        "w_out_edge": (c.n_blocks, d, d),
        "w_out_node": (c.n_blocks, d, d),
        "w_out_head": (c.n_blocks, d, c.n_targets),
    }
    return {
        "node_emb": (emb_rows, d),
        "rbf_emb": (c.n_radial, d),
        "w_edge_emb": (3 * d, d),
        "blocks": blocks,
        "head": (d, c.n_targets),
    }


TOP_LEVEL = ("node_emb", "rbf_emb", "w_edge_emb", "head")


class DimeNet(nn.Module):
    """The node and radial embeddings, the edge embedding, the stacked
    blocks and the (unread) head."""

    def __init__(self, c: DimeNetConfig, device: Any = None):
        super().__init__()
        device = resolve_device(device)
        self.config = c
        shapes = param_shapes(c)

        def empty(shape):
            return nn.Parameter(torch.empty(shape, dtype=c.dtype,
                                            device=device))
        for name in TOP_LEVEL:
            self.register_parameter(name, empty(shapes[name]))
        self.blocks = nn.ParameterDict(
            {k: empty(s) for k, s in shapes["blocks"].items()})


def param_pspecs(c: DimeNetConfig, mesh: MeshShape,
                 rules: ShardingRules) -> Dict[str, Spec]:
    """Every parameter replicated, by its name in ``named_parameters``:
    the parameters are tiny (~2M); parallelism comes from sharding the
    edge and triplet axes of the data."""
    shapes = param_shapes(c)
    out = {k: replicated(shapes[k]) for k in TOP_LEVEL}
    out.update({f"blocks.{k}": replicated(s)
                for k, s in shapes["blocks"].items()})
    return out


def init_params(c: DimeNetConfig, generator: torch.Generator,
                device: Any = None) -> DimeNet:
    """As the reference: every leaf N(0, 1/fan) with fan its next-to-last
    dim (its only dim for a vector), drawn from ``generator`` (which must
    live on ``device``; CUDA unless the caller names another)."""
    model = DimeNet(c, device)
    for p in model.parameters():
        fan = p.shape[-2] if p.dim() > 1 else p.shape[-1]
        normal_(p, generator, math.sqrt(1.0 / max(fan, 1)))
    return model


# -- model -------------------------------------------------------------------

def _n_nodes(batch: Batch) -> int:
    return (batch["z"] if "z" in batch else batch["node_feat"]).shape[0]


def check_indices(batch: Batch, c: DimeNetConfig) -> None:
    """Raise :class:`InvalidIdError` unless every index of ``batch`` lies
    in its range (a CUDA gather or ``index_add`` would fault where the
    reference clamps or drops); one host read for all of them."""
    n_nodes, n_edges = _n_nodes(batch), batch["edge_src"].shape[0]
    ranges = [("edge_src", n_nodes), ("edge_dst", n_nodes),
              ("tri_kj", n_edges), ("tri_ji", n_edges)]
    if not c.d_node_feat:
        ranges += [("z", c.n_species),
                   ("graph_id", batch["labels"].shape[0])]
    ranges = [(k, hi) for k, hi in ranges if batch[k].numel()]
    if not ranges:
        return
    ext = torch.stack([torch.stack([batch[k].min(), batch[k].max()]).long()
                       for k, _ in ranges]).tolist()
    for (k, hi), (mn, mx) in zip(ranges, ext):
        if mn < 0 or mx >= hi:
            raise InvalidIdError(f"dimenet {k}: ids span [{mn}, {mx}], "
                                 f"outside [0, {hi})")


def _segment_sum(x: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.ops.segment_sum``: row i of the result sums the rows of
    ``x`` whose id is i."""
    return torch.zeros((n,) + x.shape[1:], dtype=x.dtype,
                       device=x.device).index_add(0, ids, x)


def _block(m: torch.Tensor, blk: Dict[str, torch.Tensor], rbf: torch.Tensor,
           sbf: torch.Tensor, tri_kj: torch.Tensor, tri_ji: torch.Tensor,
           dst: torch.Tensor, n_nodes: int, mesh: Any = None,
           axis_names: Tuple[str, ...] = ()
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One interaction block and its output block: the new edge messages
    [E, D] and this block's node outputs [N, n_targets] (f32).  With
    ``axis_names`` (a ``shard_map`` body over edge partitions) the node
    aggregate is ``psum``-ed over them."""
    # directional message: triplets k→j feeding edge j→i
    m2 = F.silu(m @ blk["w_msg1"])
    x_kj = F.embedding(tri_kj, m2) \
        * (F.embedding(tri_kj, rbf) @ blk["w_rbf"])              # [T, D]
    t_down = x_kj @ blk["w_down"]                               # [T, b]
    s_proj = sbf @ blk["w_sbf"]                                 # [T, b]
    # the bilinear einsum("tb,tf,bfd->td") contracted as XLA does: the
    # [T, b, f] outer product, then one [T, b·f] @ [b·f, D] product (the
    # other order would build [T, f, D], D/b times larger)
    nb = t_down.shape[1]
    outer = (t_down[:, :, None] * s_proj[:, None, :]).reshape(-1, nb * nb)
    tri_msg = outer @ blk["w_bilinear"].reshape(nb * nb, -1)    # [T, D]
    agg = _segment_sum(tri_msg, tri_ji, m.shape[0])
    m_new = F.silu((m2 + agg) @ blk["w_msg2"]) + m              # residual
    # output block: edges → nodes
    e_out = F.silu(m_new @ blk["w_out_edge"])
    node = _segment_sum(e_out, dst, n_nodes)
    if axis_names:
        # cross-partition: the ranks' partial aggregates summed
        node = spmd.psum(node, mesh, axis_names)
    node = F.silu(node @ blk["w_out_node"])
    return m_new, (node @ blk["w_out_head"]).float()


def forward(params: DimeNet, batch: Batch, c: DimeNetConfig,
            axis_names: Tuple[str, ...] = (), mesh: Any = None
            ) -> torch.Tensor:
    """Per-molecule predictions [n_graphs, n_targets] (geometric mode,
    ``n_graphs`` the length of ``labels``) or per-node logits [N,
    n_targets] (feature mode).  Raises :class:`InvalidIdError` on an
    index out of range (:func:`check_indices`).

    ``axis_names`` (with ``mesh``): run as :func:`forward_sharded`'s
    body on this rank's edge partition, the node aggregates ``psum``-ed
    over those axes."""
    check_indices(batch, c)
    if axis_names:
        params = _varying(params, mesh, axis_names)
    src, dst = batch["edge_src"].long(), batch["edge_dst"].long()
    tri_kj, tri_ji = batch["tri_kj"].long(), batch["tri_ji"].long()
    dist, angle = batch["dist"], batch["angle"]
    n_nodes = _n_nodes(batch)

    if c.d_node_feat:
        h = batch["node_feat"].to(c.dtype) @ params.node_emb
    else:
        h = F.embedding(batch["z"].long(), params.node_emb).to(c.dtype)
    rbf = rbf_basis(dist, c.n_radial, c.cutoff).to(c.dtype)      # [E, R]
    sbf = sbf_basis(dist[tri_ji], angle, c.n_spherical, c.n_radial,
                    c.cutoff).to(c.dtype)                        # [T, SR]

    # embedding block: m_ji = W [h_j ; h_i ; rbf_emb]
    m = F.silu(torch.cat([F.embedding(src, h), F.embedding(dst, h),
                          rbf @ params.rbf_emb], dim=-1)
               @ params.w_edge_emb)                              # [E, D]
    outs = []
    for i in range(c.n_blocks):
        blk = {k: v[i] for k, v in params.blocks.items()}
        args = (m, blk, rbf, sbf, tri_kj, tri_ji, dst, n_nodes, mesh,
                axis_names)
        if torch.is_grad_enabled():
            # remat: each block's node aggregates are recomputed in
            # backward, not saved
            m, out = checkpoint(_block, *args, use_reentrant=False)
        else:
            m, out = _block(*args)
        outs.append(out)
    out_acc = torch.sum(torch.stack(outs), dim=0)
    if c.d_node_feat:
        return out_acc                                   # per-node logits
    # molecular readout: sum per graph (n_graphs = labels length)
    return _segment_sum(out_acc, batch["graph_id"].long(),
                        batch["labels"].shape[0])


# the weights used only after the node aggregate's psum: the same on
# every rank, so they enter a sharded body without ``pvary``
_AFTER_PSUM = ("w_out_node", "w_out_head", "head")

EDGE_KEYS = ("edge_src", "edge_dst", "dist", "angle", "tri_kj", "tri_ji")


def _varying(params: Any, mesh: Any, axes: Tuple[str, ...]) -> Any:
    """The parameters as a sharded body uses them: those that meet the
    rank's own edges through ``pvary`` over ``axes``."""
    import types
    def one(k, v):
        return v if k in _AFTER_PSUM else spmd.pvary(v, mesh, axes)
    out = types.SimpleNamespace(**{k: one(k, getattr(params, k))
                                   for k in TOP_LEVEL})
    out.blocks = {k: one(k, v) for k, v in params.blocks.items()}
    return out


def forward_sharded(params: DimeNet, batch: Batch, c: DimeNetConfig,
                    mesh: Any, rules: Any = None) -> Any:
    """The reference's distributed forward: ``EDGE_KEYS``' arrays split
    evenly over the graph axes (("data", "model") where the mesh has
    them; a rank's slice is its partition, triplet indices LOCAL to it),
    everything else and the parameters (DTensors, replicated) whole on
    every rank; :func:`forward` as the ``shard_map`` body.  Returns the
    predictions as a replicated DTensor.  Every partition must hold the
    same number of edges and of triplets (padded)."""
    graph_axes = tuple(a for a in ("data", "model")
                       if a in mesh.mesh_dim_names)
    in_specs = {k: Spec(graph_axes) if k in EDGE_KEYS
                else Spec(*([None] * v.dim())) for k, v in batch.items()}
    pspecs = {k: Spec(*([None] * p.dim()))
              for k, p in _params_tree(params).items()}

    def body(p, dyn):
        return forward(_as_model(p), dyn, c, axis_names=graph_axes,
                       mesh=mesh)
    return spmd.shard_map(body, mesh, (pspecs, in_specs), Spec(None))(
        _params_tree(params), dict(batch))


def _params_tree(params: DimeNet) -> Dict[str, Any]:
    out = {k: getattr(params, k) for k in TOP_LEVEL}
    out.update({f"blocks.{k}": v for k, v in params.blocks.items()})
    return out


def _as_model(tree: Dict[str, Any]) -> Any:
    import types
    out = types.SimpleNamespace(**{k: tree[k] for k in TOP_LEVEL})
    out.blocks = {k[len("blocks."):]: v for k, v in tree.items()
                  if k.startswith("blocks.")}
    return out


def loss_fn(params: DimeNet, batch: Batch, c: DimeNetConfig,
            mesh: Any = None, rules: Any = None) -> torch.Tensor:
    """Mean squared error against the per-molecule ``labels`` (one
    target), or the masked softmax cross-entropy against per-node
    classes (−1 unlabelled); with a mesh on :func:`forward_sharded`'s
    predictions (the same loss on every rank; the labels a DTensor or
    the global value every rank holds)."""
    pred = forward(params, batch, c) if mesh is None \
        else forward_sharded(params, batch, c, mesh, rules).to_local()
    labels = batch["labels"] if mesh is None \
        else spmd.enter(batch["labels"], mesh, Spec(None))
    if c.n_targets == 1:
        return torch.mean(torch.square(pred[..., 0] - labels))
    return masked_xent(pred, labels)


def make_train_step(c: DimeNetConfig, optimizer: torch.optim.Optimizer,
                    mesh: Any = None, rules: Any = None) -> Callable:
    """``train_step(model, batch) -> {"loss"}`` on :func:`loss_fn`."""
    return train_step_of(lambda m, b: loss_fn(m, b, c, mesh, rules),
                         optimizer)


@torch.no_grad()
def serve_step(params: DimeNet, batch: Batch, c: DimeNetConfig,
               mesh: Any = None, rules: Any = None) -> Any:
    """:func:`forward` (with a mesh :func:`forward_sharded`) without an
    autograd graph."""
    if mesh is not None:
        return forward_sharded(params, batch, c, mesh, rules)
    return forward(params, batch, c)
