"""BERT4Rec (Sun et al., arXiv:1904.06690): a bidirectional transformer
over item sequences.

The port of ``repro/models/bert4rec.py``, serving half.  Encoder only
(no decode step).  As in the reference: GELU in its tanh approximation
(``jax.nn.gelu``'s default), layer norm with the population variance,
padding keys (item 0) masked with −1e30, not −inf, so a row of padding
alone stays finite.  ``serve_step`` keeps a running top-n over the item
table in vocab chunks and scores only the ``vocab // vocab_chunk``
whole chunks, as the reference's single-device scan does: rows past
the last whole chunk are never scored.  ``retrieval_step`` scores every
candidate row through ``ops.knn_topk`` (B3 on the card).  Both run
under ``torch.no_grad()``.

Training: ``cloze_loss`` scores every masked position against the whole
vocabulary ([B, S, V] logits: smoke sizes only); ``sampled_cloze_loss``
scores the gold item against K shared negatives (the production cell),
so no [B, S, V] tensor is built.  With autograd on, each block is
recomputed in backward (``torch.utils.checkpoint``, the reference's
``jax.checkpoint``) rather than saving its [B, h, S, S] scores.
``make_train_step(c, optimizer, sampled=...)`` gives ``train_step(model,
batch) -> {"loss"}`` (``common.train_step_of``).

``serve_step(..., mesh=, rules=)`` is the reference's ``shard_map``
serving path: the catalogue's rows over "model", each rank's local
top-n over ALL its rows (ids offset by ``axis_index("model") · V_loc``),
an all-gather of the [B, TP·n] candidates and the final top-n (ties:
the lower rank's candidate first, so the lowest global id).  Unlike the
single-device scan it scores every row.

``encoder``, ``cloze_loss``, ``sampled_cloze_loss``, ``make_train_step``
and ``retrieval_step`` take ``mesh=``, ``rules=`` too (DTensor
parameters by :func:`param_pspecs`; the batch DTensors or the global
values every rank holds).  The encoder looks its items up by
``embedding.gather_rows`` from the row-sharded ``item_emb`` and runs the
blocks on each rank's batch block, pinned to the batch axes
(``common.constrain_batchwise``) after the lookup and after every block,
as the reference pins them (the second inside the block's
``torch.utils.checkpoint``, so the recompute pins it again).  The
sampled cloze looks the gold and the negative rows up from the sharded
table; the full cloze scores against the whole table
(``common.whole``).  ``retrieval_step`` runs B3 on each rank's block of
``candidates`` and merges the lists (``common.sharded_retrieval``).
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
from repro_torch.kernels import ops, ref
from repro_torch.models.common import (batch_split, constrain_batchwise,
                                       layer_norm, map_batch_chunks,
                                       masked_xent, merge_topk_over,
                                       normal_, replicated, row_axes,
                                       sharded_retrieval, train_step_of,
                                       whole)
from repro_torch.models.embedding import check_ids, gather_rows, row_block
from repro_torch.parallel import spmd
from repro_torch.parallel.sharding import (MeshShape, ShardingRules, Spec,
                                           batch_axes)


# serve_step's item rows a step of its running top-n (the reference's)
VOCAB_CHUNK = 65536


@dataclasses.dataclass(frozen=True)
class Bert4RecConfig:
    """The published BERT4Rec widths over a 10⁶-item catalogue."""

    name: str = "bert4rec"
    n_items: int = 1_000_000        # +2 special tokens (pad=0, mask=1)
    embed_dim: int = 64
    n_blocks: int = 2
    n_heads: int = 2
    seq_len: int = 200
    d_ff: int = 256
    dtype: torch.dtype = torch.float32

    @property
    def vocab(self) -> int:
        # padded to a multiple of 512, the special tokens included
        return (self.n_items + 2 + 511) // 512 * 512

    def n_params(self) -> int:
        d = self.embed_dim
        per_block = 4 * d * d + 2 * d * self.d_ff + 4 * d + self.d_ff + d
        return self.vocab * d + self.seq_len * d \
            + self.n_blocks * per_block + 2 * d


def block_shapes(c: Bert4RecConfig) -> Dict[str, Tuple[int, ...]]:
    """Shapes of the blocks' parameters, stacked ``[L, ...]``."""
    d, f, L = c.embed_dim, c.d_ff, c.n_blocks
    return {
        "wq": (L, d, d), "wk": (L, d, d), "wv": (L, d, d), "wo": (L, d, d),
        "ln1_w": (L, d), "ln1_b": (L, d), "ln2_w": (L, d), "ln2_b": (L, d),
        "w1": (L, d, f), "b1": (L, f), "w2": (L, f, d), "b2": (L, d),
    }


def param_shapes(c: Bert4RecConfig) -> Dict[str, Any]:
    """Shapes of the JAX parameter tree."""
    return {
        "item_emb": (c.vocab, c.embed_dim),
        "pos_emb": (c.seq_len, c.embed_dim),
        "blocks": block_shapes(c),
        "out_ln_w": (c.embed_dim,), "out_ln_b": (c.embed_dim,),
        "out_bias": (c.vocab,),
    }


TOP_LEVEL = ("item_emb", "pos_emb", "out_ln_w", "out_ln_b", "out_bias")


class Bert4Rec(nn.Module):
    """Item and position embeddings, the stacked blocks, the output norm
    and bias."""

    def __init__(self, c: Bert4RecConfig, device: Any = None):
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


def param_pspecs(c: Bert4RecConfig, mesh: MeshShape,
                 rules: ShardingRules) -> Dict[str, Spec]:
    """The spec of each parameter, by its name in ``named_parameters``:
    the item table's rows (and the output bias) over every mesh axis
    where the devices divide the vocabulary, else over the tensor axis;
    the rest replicated (the blocks stay stacked ``[L, ...]``)."""
    rows = row_axes(c.vocab, mesh, rules)
    shapes = param_shapes(c)
    out = {"item_emb": Spec(rows, None), "pos_emb": Spec(None, None),
           "out_ln_w": Spec(None), "out_ln_b": Spec(None),
           "out_bias": Spec(rows)}
    out.update({f"blocks.{k}": replicated(s)
                for k, s in shapes["blocks"].items()})
    return out


@torch.no_grad()
def init_params(c: Bert4RecConfig, generator: torch.Generator,
                device: Any = None) -> Bert4Rec:
    """As the reference: leaves named ``*_b`` / ``*bias`` zero, ``*_w``
    one, every other 0.02·N(0, 1) drawn from ``generator`` (which must
    live on ``device``; CUDA unless the caller names another)."""
    model = Bert4Rec(c, device)
    for name, p in model.named_parameters():
        leaf = name.split(".")[-1]
        if leaf.endswith(("_b", "bias")):
            p.zero_()
        elif leaf.endswith("_w"):
            p.fill_(1.0)
        else:
            normal_(p, generator, 0.02)
    return model


def encoder(params: Bert4Rec, ids: torch.Tensor, c: Bert4RecConfig,
            mesh: Any = None, rules: Any = None) -> Any:
    """ids [B, S] → hidden [B, S, D] (bidirectional, padding masked);
    with a mesh a DTensor of the batch block (module docstring).

    Raises :class:`~repro_torch.models.embedding.InvalidIdError` on an
    id outside ``[0, vocab)``."""
    if mesh is not None:
        x, vary = _encoder_sharded(params, ids, c, mesh, rules)
        return spmd.from_local(x, mesh, Spec(vary, None, None))
    b, s = ids.shape
    check_ids(ids, c.vocab, "bert4rec ids")
    x = F.embedding(ids.long(), params.item_emb).to(c.dtype) \
        + params.pos_emb[None, :s, :].to(c.dtype)
    bias = torch.where((ids == 0)[:, None, None, :], -1e30, 0.0)  # [B,1,1,S]
    for i in range(c.n_blocks):
        blk = {k: v[i] for k, v in params.blocks.items()}
        if torch.is_grad_enabled():
            # remat: the [B, h, S, S] scores are recomputed in backward
            x = checkpoint(_block, x, blk, bias, c, use_reentrant=False)
        else:
            x = _block(x, blk, bias, c)
    return layer_norm(x, params.out_ln_w, params.out_ln_b)


def _encoder_sharded(params: Bert4Rec, ids: Any, c: Bert4RecConfig,
                     mesh: Any, rules: Any) -> Tuple[torch.Tensor, tuple]:
    """:func:`encoder` under a mesh: this rank's block of the hidden
    states, and the axes the batch is split over."""
    b, s = ids.shape
    vary = batch_split(mesh, rules, b)
    ids = spmd.enter(ids, mesh, Spec(vary, None))
    check_ids(ids, c.vocab, "bert4rec ids", mesh=mesh)
    x = gather_rows(*row_block(params.item_emb, mesh), ids.long(), mesh,
                    vary).to(c.dtype) \
        + whole(params.pos_emb, mesh, vary)[None, :s, :].to(c.dtype)
    pin = (mesh, rules, b, vary)
    x = _pinned(x, pin)
    bias = torch.where((ids == 0)[:, None, None, :], -1e30, 0.0)
    blocks = {k: whole(v, mesh, vary) for k, v in params.blocks.items()}
    for i in range(c.n_blocks):
        blk = {k: v[i] for k, v in blocks.items()}
        if torch.is_grad_enabled():
            x = checkpoint(_block, x, blk, bias, c, pin, use_reentrant=False)
        else:
            x = _block(x, blk, bias, c, pin)
    return layer_norm(x, whole(params.out_ln_w, mesh, vary),
                      whole(params.out_ln_b, mesh, vary)), vary


def _pinned(x: torch.Tensor, pin: tuple) -> torch.Tensor:
    """The reference's ``_constrain_batchwise`` on the hidden states'
    block ``x`` (``pin``: mesh, rules, global batch, the batch's axes)."""
    mesh, rules, b, vary = pin
    return spmd.local(constrain_batchwise(
        spmd.from_local(x, mesh, Spec(vary, None, None)), mesh, rules, b))


def _block(x: torch.Tensor, blk: Dict[str, torch.Tensor],
           bias: torch.Tensor, c: Bert4RecConfig,
           pin: Any = None) -> torch.Tensor:
    """One encoder block: attention over the unmasked keys, then the
    GELU feed-forward, each with a residual and a layer norm (then, with
    ``pin``, pinned to the batch axes)."""
    b, s, _ = x.shape
    h, d = c.n_heads, c.embed_dim // c.n_heads
    q = (x @ blk["wq"]).reshape(b, s, h, d)
    k = (x @ blk["wk"]).reshape(b, s, h, d)
    v = (x @ blk["wv"]).reshape(b, s, h, d)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    probs = torch.softmax(scores * (1.0 / math.sqrt(d)) + bias,
                          dim=-1).to(x.dtype)
    att = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, -1)
    x = layer_norm(x + att @ blk["wo"], blk["ln1_w"], blk["ln1_b"])
    f = F.gelu(x @ blk["w1"] + blk["b1"], approximate="tanh") \
        @ blk["w2"] + blk["b2"]
    x = layer_norm(x + f, blk["ln2_w"], blk["ln2_b"])
    return x if pin is None else _pinned(x, pin)


def forward_logits(params: Bert4Rec, ids: torch.Tensor,
                   c: Bert4RecConfig) -> torch.Tensor:
    """Full-vocab logits at every position [B, S, V] (tied item
    embeddings)."""
    x = encoder(params, ids, c)
    return x @ params.item_emb.T.to(c.dtype) + params.out_bias


def cloze_loss(params: Bert4Rec, batch: Dict[str, torch.Tensor],
               c: Bert4RecConfig, mesh: Any = None,
               rules: Any = None) -> torch.Tensor:
    """batch: {"ids": [B, S] (the mask token 1 at masked positions),
    "targets": [B, S] (the true item where masked, −1 elsewhere)}.  The
    full-vocabulary softmax cross-entropy over the masked positions
    (with a mesh the whole batch's, on every rank)."""
    if mesh is not None:
        vary = batch_split(mesh, rules, batch["ids"].shape[0])
        t = spmd.enter(batch["targets"], mesh, Spec(vary, None))
        check_ids(torch.clamp(t, min=0), c.vocab, "bert4rec targets",
                  mesh=mesh)
        x, vary = _encoder_sharded(params, batch["ids"], c, mesh, rules)
        logits = x @ whole(params.item_emb, mesh, vary).T.to(c.dtype) \
            + whole(params.out_bias, mesh, vary)
        return masked_xent(logits, t, mesh, vary)
    t = batch["targets"]
    check_ids(torch.clamp(t, min=0), c.vocab, "bert4rec targets")
    logits = forward_logits(params, batch["ids"], c)         # [B, S, V]
    return masked_xent(logits, t)


def sampled_cloze_loss(params: Bert4Rec, batch: Dict[str, torch.Tensor],
                       c: Bert4RecConfig, mesh: Any = None,
                       rules: Any = None) -> torch.Tensor:
    """The cloze loss against sampled negatives, the big-vocabulary path:
    no [B, S, V] logits.

    batch: {"ids": [B, S], "mask_pos": [B, M], "targets": [B, M] (−1
    pads), "negatives": [K]}: each target's hidden state is scored
    against the gold item and the K shared negatives (a softmax over
    K + 1).  Raises :class:`~repro_torch.models.embedding.InvalidIdError`
    on a position outside ``[0, S)`` or an item outside ``[0, vocab)``.
    With a mesh: the gold rows of each rank's batch block and the shared
    negatives' rows from the row-sharded table, the whole batch's loss
    on every rank."""
    if mesh is not None:
        return _sampled_sharded(params, batch, c, mesh, rules)
    x = encoder(params, batch["ids"], c)                    # [B, S, D]
    mp = torch.clamp(batch["mask_pos"], min=0).long()
    check_ids(mp, x.shape[1], "bert4rec mask_pos")
    t, neg = batch["targets"], batch["negatives"].long()
    gold_ids = torch.clamp(t, min=0).long()
    check_ids(torch.cat([gold_ids.flatten(), neg]), c.vocab,
              "bert4rec targets and negatives")
    h = torch.gather(x, 1, mp[..., None].expand(-1, -1, x.shape[2]))
    emb = params.item_emb
    gold_e = F.embedding(gold_ids, emb).to(c.dtype)         # [B, M, D]
    neg_e = F.embedding(neg, emb).to(c.dtype)               # [K, D]
    gold = torch.sum(h * gold_e, dim=-1).float()
    neg_logits = (h @ neg_e.T).float()                      # [B, M, K]
    # the gold item is class 0 of the K + 1
    return masked_xent(torch.cat([gold[..., None], neg_logits], -1),
                       torch.where(t >= 0, 0, -1))


def _sampled_sharded(params: Bert4Rec, batch: Dict[str, Any],
                     c: Bert4RecConfig, mesh: Any, rules: Any
                     ) -> torch.Tensor:
    x, vary = _encoder_sharded(params, batch["ids"], c, mesh, rules)
    bspec = Spec(vary, None)
    mp = torch.clamp(spmd.enter(batch["mask_pos"], mesh, bspec),
                     min=0).long()
    check_ids(mp, x.shape[1], "bert4rec mask_pos", mesh=mesh)
    t = spmd.enter(batch["targets"], mesh, bspec)
    neg = spmd.enter(batch["negatives"], mesh, Spec(None)).long()
    gold_ids = torch.clamp(t, min=0).long()
    check_ids(torch.cat([gold_ids.flatten(), neg]), c.vocab,
              "bert4rec targets and negatives", mesh=mesh)
    h = torch.gather(x, 1, mp[..., None].expand(-1, -1, x.shape[2]))
    w, rows, off = row_block(params.item_emb, mesh)
    gold_e = gather_rows(w, rows, off, gold_ids, mesh, vary).to(c.dtype)
    # the negatives are the same on every rank: their rows enter the
    # batch-varying scores through pvary
    neg_e = spmd.pvary(gather_rows(w, rows, off, neg, mesh, ()), mesh,
                       vary).to(c.dtype)
    gold = torch.sum(h * gold_e, dim=-1).float()
    neg_logits = (h @ neg_e.T).float()
    return masked_xent(torch.cat([gold[..., None], neg_logits], -1),
                       torch.where(t >= 0, 0, -1), mesh, vary)


def make_train_step(c: Bert4RecConfig, optimizer: torch.optim.Optimizer,
                    sampled: bool = False, mesh: Any = None,
                    rules: Any = None) -> Callable:
    """``train_step(model, batch) -> {"loss"}`` on
    :func:`sampled_cloze_loss` (``sampled``) or :func:`cloze_loss`."""
    fn = sampled_cloze_loss if sampled else cloze_loss
    return train_step_of(lambda m, b: fn(m, b, c, mesh, rules), optimizer)


@torch.no_grad()
def serve_step(params: Bert4Rec, batch: Dict[str, torch.Tensor],
               c: Bert4RecConfig, top_n: int = 20,
               vocab_chunk: int = VOCAB_CHUNK,
               batch_chunk: int = 16384, mesh: Any = None,
               rules: Any = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Next-item recommendation: (f32[B, n] scores, i32[B, n] items).

    The [B, V] logits are never materialised: the item table is scanned
    in ``vocab_chunk`` rows with a running top-n (stable sort, ties to
    the lowest item).  Only the ``V // vocab_chunk`` whole chunks are
    scored (the reference's single-device scan): at the published
    config rows 983,040–1,000,447 never are.  Batches of more than
    ``batch_chunk`` rows run in batch chunks.  O(B·V·D).

    With a mesh whose tensor axis divides the vocabulary:
    :func:`_serve_sharded` (DTensor parameters; DTensor results, the
    batch over the batch axes); with another mesh the scan below on the
    gathered parameters.
    """
    if mesh is not None:
        if rules is not None and rules.tensor in mesh.mesh_dim_names \
                and params.item_emb.shape[0] % spmd.axis_size(
                    mesh, rules.tensor) == 0:
            return _serve_sharded(params, batch, c, top_n, vocab_chunk,
                                  batch_chunk, mesh, rules)
        # the reference's unshardable fallback: the scan below, on the
        # whole parameters
        params = _gathered(params)
    if batch["ids"].shape[0] > batch_chunk:
        return map_batch_chunks(
            lambda sub: serve_step(params, sub, c, top_n, vocab_chunk,
                                   batch_chunk),
            batch, batch_chunk, keys=["ids"])
    q = encoder(params, batch["ids"], c)[:, -1, :].contiguous()  # [B, D]
    v = params.item_emb.shape[0]
    chunk = min(vocab_chunk, v)
    vals = torch.full((q.shape[0], top_n), float("-inf"),
                      dtype=torch.float32, device=q.device)
    idx = torch.zeros((q.shape[0], top_n), dtype=torch.int32,
                      device=q.device)
    for lo in range(0, v // chunk * chunk, chunk):
        e = params.item_emb[lo:lo + chunk]
        scores = (q @ e.T.to(c.dtype) + params.out_bias[lo:lo + chunk])
        vals, idx = ref.merge_topk(
            vals, idx, scores.float(),
            torch.arange(lo, lo + chunk, device=q.device), top_n)
    return vals, idx


def _gathered(params: Bert4Rec) -> Any:
    """The parameters' global values (DTensors gathered), in the module's
    attribute layout."""
    import types
    out = types.SimpleNamespace(**{k: spmd.gather_full(getattr(params, k))
                                   for k in TOP_LEVEL})
    out.blocks = {k: spmd.gather_full(v) for k, v in params.blocks.items()}
    return out


def _serve_sharded(params: Bert4Rec, batch: Dict[str, torch.Tensor],
                   c: Bert4RecConfig, top_n: int, vocab_chunk: int,
                   batch_chunk: int, mesh: Any, rules: Any
                   ) -> Tuple[Any, Any]:
    """The reference's ``shard_map`` body: each rank's batch rows (over
    the batch axes where they divide it) encoded, scored against the
    rank's ``V / TP`` catalogue rows in ``vocab_chunk`` blocks with a
    running top-n (every row, ids offset by ``axis_index · V_loc``), the
    [B_loc, TP·n] candidates all-gathered over "model" and their top-n
    kept.  Returns (f32 scores, i32 items) as DTensors."""
    tp = rules.tensor
    bax = batch_axes(mesh, rules)
    ids = batch["ids"]
    b_ax = bax if bax and ids.shape[0] % spmd.axis_size(mesh, bax) == 0 \
        else ()
    ids = spmd.enter(ids, mesh, Spec(b_ax, None))
    e_loc = spmd.redistribute(params.item_emb.to_local(), mesh,
                              spmd.spec_of(params.item_emb), Spec(tp, None))
    b_loc = spmd.redistribute(params.out_bias.to_local(), mesh,
                              spmd.spec_of(params.out_bias), Spec(tp))
    v_loc = e_loc.shape[0]
    off = spmd.axis_index(mesh, tp) * v_loc
    vals, idx = [], []
    for r in range(0, ids.shape[0], batch_chunk):
        x = encoder(params, spmd.from_local(ids[r:r + batch_chunk], mesh,
                                            Spec(b_ax, None)), c, mesh,
                    rules)
        q = spmd.enter(x, mesh, Spec(b_ax, None, None))[:, -1, :]
        q = q.contiguous()
        lv = torch.full((q.shape[0], top_n), float("-inf"),
                        dtype=torch.float32, device=q.device)
        li = torch.zeros((q.shape[0], top_n), dtype=torch.int64,
                         device=q.device)
        for lo in range(0, v_loc, vocab_chunk):
            hi = min(v_loc, lo + vocab_chunk)
            scores = q @ e_loc[lo:hi].T.to(c.dtype) + b_loc[lo:hi]
            lv, li = ref.merge_topk(
                lv, li, scores.float(),
                torch.arange(off + lo, off + hi, device=q.device), top_n)
        tv, ti = merge_topk_over(lv, li, mesh, tp, top_n)
        vals.append(tv)
        idx.append(ti)
    out = Spec(b_ax, None)
    return (spmd.from_local(torch.cat(vals), mesh, out),
            spmd.from_local(torch.cat(idx), mesh, out))


@torch.no_grad()
def retrieval_step(params: Bert4Rec, batch: Dict[str, torch.Tensor],
                   c: Bert4RecConfig, top_n: int = 100, mesh: Any = None,
                   rules: Any = None) -> Tuple[Any, Any]:
    """retrieval_cand: the last hidden state of one sequence scored
    against every row of ``candidates`` [N, D], its top ``top_n``
    (f32[1, n], i32[1, n]) through ``ops.knn_topk`` with the dot metric
    (B3 on the card: O(N·D), the [1, N] scores never written).  With a
    mesh: B3 on each rank's block of the candidates' rows, the lists
    merged (``common.sharded_retrieval``); DTensors."""
    if mesh is not None:
        x, vary = _encoder_sharded(params, batch["ids"], c, mesh, rules)
        return sharded_retrieval(x[:, -1, :].contiguous(),
                                 batch["candidates"], top_n, mesh, rules,
                                 vary)
    q = encoder(params, batch["ids"], c)[:, -1, :].contiguous()  # [1, D]
    return ops.knn_topk(q, batch["candidates"].to(c.dtype), top_n,
                        metric="dot")
