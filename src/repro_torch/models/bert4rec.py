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
batch) -> {"loss"}`` (``common.train_step_of``).  Not ported here: the
shard_map serving path.
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
from repro_torch.models.common import (layer_norm, map_batch_chunks,
                                       masked_xent, normal_, train_step_of)
from repro_torch.models.embedding import check_ids


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


def encoder(params: Bert4Rec, ids: torch.Tensor,
            c: Bert4RecConfig) -> torch.Tensor:
    """ids [B, S] → hidden [B, S, D] (bidirectional, padding masked).

    Raises :class:`~repro_torch.models.embedding.InvalidIdError` on an
    id outside ``[0, vocab)``."""
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


def _block(x: torch.Tensor, blk: Dict[str, torch.Tensor],
           bias: torch.Tensor, c: Bert4RecConfig) -> torch.Tensor:
    """One encoder block: attention over the unmasked keys, then the
    GELU feed-forward, each with a residual and a layer norm."""
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
    return layer_norm(x + f, blk["ln2_w"], blk["ln2_b"])


def forward_logits(params: Bert4Rec, ids: torch.Tensor,
                   c: Bert4RecConfig) -> torch.Tensor:
    """Full-vocab logits at every position [B, S, V] (tied item
    embeddings)."""
    x = encoder(params, ids, c)
    return x @ params.item_emb.T.to(c.dtype) + params.out_bias


def cloze_loss(params: Bert4Rec, batch: Dict[str, torch.Tensor],
               c: Bert4RecConfig) -> torch.Tensor:
    """batch: {"ids": [B, S] (the mask token 1 at masked positions),
    "targets": [B, S] (the true item where masked, −1 elsewhere)}.  The
    full-vocabulary softmax cross-entropy over the masked positions."""
    t = batch["targets"]
    check_ids(torch.clamp(t, min=0), c.vocab, "bert4rec targets")
    logits = forward_logits(params, batch["ids"], c)         # [B, S, V]
    return masked_xent(logits, t)


def sampled_cloze_loss(params: Bert4Rec, batch: Dict[str, torch.Tensor],
                       c: Bert4RecConfig) -> torch.Tensor:
    """The cloze loss against sampled negatives, the big-vocabulary path:
    no [B, S, V] logits.

    batch: {"ids": [B, S], "mask_pos": [B, M], "targets": [B, M] (−1
    pads), "negatives": [K]}: each target's hidden state is scored
    against the gold item and the K shared negatives (a softmax over
    K + 1).  Raises :class:`~repro_torch.models.embedding.InvalidIdError`
    on a position outside ``[0, S)`` or an item outside ``[0, vocab)``."""
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


def make_train_step(c: Bert4RecConfig, optimizer: torch.optim.Optimizer,
                    sampled: bool = False) -> Callable:
    """``train_step(model, batch) -> {"loss"}`` on
    :func:`sampled_cloze_loss` (``sampled``) or :func:`cloze_loss`."""
    fn = sampled_cloze_loss if sampled else cloze_loss
    return train_step_of(lambda m, b: fn(m, b, c), optimizer)


@torch.no_grad()
def serve_step(params: Bert4Rec, batch: Dict[str, torch.Tensor],
               c: Bert4RecConfig, top_n: int = 20, vocab_chunk: int = 65536,
               batch_chunk: int = 16384) -> Tuple[torch.Tensor, torch.Tensor]:
    """Next-item recommendation: (f32[B, n] scores, i32[B, n] items).

    The [B, V] logits are never materialised: the item table is scanned
    in ``vocab_chunk`` rows with a running top-n (stable sort, ties to
    the lowest item).  Only the ``V // vocab_chunk`` whole chunks are
    scored (the reference's single-device scan): at the published
    config rows 983,040–1,000,447 never are.  Batches of more than
    ``batch_chunk`` rows run in batch chunks.  O(B·V·D).
    """
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


@torch.no_grad()
def retrieval_step(params: Bert4Rec, batch: Dict[str, torch.Tensor],
                   c: Bert4RecConfig, top_n: int = 100
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """retrieval_cand: the last hidden state of one sequence scored
    against every row of ``candidates`` [N, D], its top ``top_n``
    (f32[1, n], i32[1, n]) through ``ops.knn_topk`` with the dot metric
    (B3 on the card: O(N·D), the [1, N] scores never written)."""
    q = encoder(params, batch["ids"], c)[:, -1, :].contiguous()  # [1, D]
    return ops.knn_topk(q, batch["candidates"].to(c.dtype), top_n,
                        metric="dot")
