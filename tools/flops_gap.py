#!/usr/bin/env python3
"""Why a cell's counted FLOPs differ from its model FLOPs.

    python3 tools/flops_gap.py RESULTS.json

``RESULTS.json`` is what ``python -m repro_torch.launch.dryrun --all
--out RESULTS.json`` wrote.  For every cell whose ``useful_flops_ratio``
(model FLOPs over counted FLOPs) exceeds 1, the script takes the sizes
the cut rule chose on that card (``Cell.choose(device_bytes)``), writes
out the closed form of the products the port's program runs there,
term by term, beside the model FLOPs formula's terms, and checks the
closed form against the counted FLOPs.  Where the two are equal, the
counter missed no product, and the ratio is the formula's: it counts
work the program does not run, or leaves out work it does.

The closed forms (:func:`lm_prefill`, :func:`tifu_serve`,
:func:`dimenet_train`, :func:`deepfm_train`) count what the counter
counts: the products, 2·M·N·K each, nothing elementwise.  They are held
to the counter at the CPU tests' sizes in ``tests/test_torch_roofline.py``.
``stream_update`` runs no product: its FLOPs are B2's adds, one per valid
id (data-dependent; the same test file pins that they are all).  Runs on
the CPU; reads no card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, Optional

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs import tifu_knn  # noqa: E402
from repro_torch.kernels import work  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

Terms = Dict[str, float]


def lm_prefill(c: T.TransformerConfig, b: int, s: int,
               v_width: Optional[int] = None) -> Terms:
    """The products of ``Transformer.prefill`` of B sequences of S
    tokens.  ``v_width`` is the V width the attention dispatcher is
    handed (``transformer.kernel_v``: MLA's V at its own width on the
    card's bf16 design, padded to Q's width elsewhere)."""
    t = b * s
    n_dense, n_moe = T.layer_groups(c)
    windows = T._layer_windows(c, c.n_layers, 0)
    dv = c.v_dim if v_width is None else v_width
    pairs = sum(work.visible_pairs(s, True, T.kernel_window(w))
                for w in windows)
    out = {
        "attention projections": 2.0 * t * c.n_layers * c._attn_params(),
        "attention (visible pairs x 2(D + Dv))":
            2.0 * (c.qk_dim + dv) * b * c.n_heads * pairs,
        "dense FFN": 2.0 * t * n_dense * 3 * c.d_model * c.d_ff,
        "lm head at the last position": 2.0 * b * c.d_model * c.vocab_size,
    }
    if n_moe:
        cap = T._capacity(t, c)
        out["router"] = 2.0 * t * n_moe * c.d_model * c.n_experts
        out["routed experts (E_pad x capacity slots)"] = \
            2.0 * n_moe * c.e_pad * cap * 3 * c.d_model * c.moe_d_ff
        out["shared experts"] = (2.0 * t * n_moe * 3 * c.d_model
                                 * c.moe_d_ff * c.n_shared_experts)
    return out


def lm_prefill_model(c: T.TransformerConfig, b: int, s: int) -> Terms:
    """The formula's 2·N_active·B·S, split into its embedding (and
    untied head) and its layers."""
    emb = c.vocab_size * c.d_model * (1 if c.tie_embeddings else 2)
    return {"embedding and head at every position": 2.0 * b * s * emb,
            "layers' active parameters at every position":
                2.0 * b * s * (c.n_active_params() - emb)}


def tifu_serve(sz: "tifu_knn.Sizes", blocks: int = 1) -> Terms:
    """``predict_streaming`` (``blocks`` 1) or ``distributed_predict``
    over ``blocks`` row blocks: B3's work on each block; the neighbour
    mean is adds (no product)."""
    q, m, i = sz.n_queries, sz.n_users, sz.n_items
    m_loc = m // blocks
    return {"B3 q.c products": 2.0 * q * m_loc * i * blocks,
            "B3 |c|^2 sums": 2.0 * m_loc * i * blocks}


def tifu_serve_model(sz: "tifu_knn.Sizes", one_hot: bool) -> Terms:
    q, m, i, k = sz.n_queries, sz.n_users, sz.n_items, sz.topk
    return {"scores": 2.0 * q * m * i,
            ("neighbour mean as a [Q, M] one-hot product" if one_hot
             else "neighbour mean"): 2.0 * q * (m if one_hot else k) * i}


def dimenet_train(c, g: dict) -> Terms:
    """DimeNet's training step: each product's forwards, its weight
    gradient, and its input gradient where the input needs one.  The
    blocks run under ``checkpoint``: their forward runs again in the
    backward, up to the last tensor the backward saved (non-reentrant
    checkpoint stops there), so the output head's product, whose result
    no later op saves, runs forward once."""
    d, nb, e, t, n = c.d_hidden, c.n_bilinear, g["n_edges"], g["n_tri"], \
        g["n_nodes"]
    r, sr = c.n_radial, c.n_spherical * c.n_radial
    # term: [(forward FLOPs, forwards, whether the input needs a
    # gradient)]; a block's forward runs twice, the embedding's once
    block = {
        "blocks' E·D^2 products (msg1, msg2, out_edge)":
            [(2.0 * e * d * d, 2, True)] * 3,
        "blocks' bilinear path (w_down, w_bilinear)":
            [(2.0 * t * d * nb, 2, True), (2.0 * t * nb * nb * d, 2, True)],
        "blocks' basis projections (w_rbf, w_sbf)":
            [(2.0 * t * r * d, 2, False), (2.0 * t * sr * nb, 2, False)],
        "blocks' node products (w_out_node, w_out_head)":
            [(2.0 * n * d * d, 2, True), (2.0 * n * d * c.n_targets, 1, True)],
    }
    embed = [(2.0 * e * r * d, 1, False),           # rbf @ rbf_emb
             (2.0 * e * 3 * d * d, 1, True)]        # [h_j; h_i; rbf] @ w
    if c.d_node_feat:
        embed.append((2.0 * n * c.d_node_feat * d, 1, False))

    def fwd_bwd(products):
        return sum(f * (forwards + 1 + grad) for f, forwards, grad
                   in products)
    out = {term: c.n_blocks * fwd_bwd(ps) for term, ps in block.items()}
    out["embedding block"] = fwd_bwd(embed)
    return out


def dimenet_model(c, g: dict) -> Terms:
    """The JAX formula (``configs/dimenet_cfg.py::_flops``), term by
    term: per block the messages' two E·D² products, the bilinear path
    at T·(D·b + b²·D) (one FLOP a multiply-add) and one output E·D²
    product, 6x for the forward and the backward."""
    d, nb, e, t = c.d_hidden, c.n_bilinear, g["n_edges"], g["n_tri"]
    k = 6.0 * c.n_blocks
    return {"messages 2 x 2·E·D^2": k * 2 * e * d * d * 2,
            "bilinear T·(D·b + b^2·D)": k * t * (d * nb + nb * nb * d),
            "output 2·E·D^2": k * 2 * e * d * d}


def deepfm_train(c, n: int) -> Terms:
    """DeepFM's training step: the deep MLP's products, forward, weight
    and input gradients (the field embeddings train, so the first
    layer's input gradient runs too); the FM terms are sums."""
    dims = c.deep_dims()
    w = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    return {"deep MLP weights x 6 x rows": 6.0 * n * w}


def deepfm_train_model(c, n: int) -> Terms:
    dims = c.deep_dims()
    w = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    return {"deep MLP weights x 6 x rows": 6.0 * n * w,
            "deep MLP biases x 6 x rows": 6.0 * n * sum(dims[1:])}


def explain(r: dict) -> Optional[dict]:
    """The closed form and the formula's terms of dry-run record ``r``,
    or ``None`` where the script has no closed form."""
    name, shape = r["arch"], r["shape"]
    arch = get_arch(name)
    if arch.family == "tifu":
        sz = tifu_knn.Sizes()
        if shape == "serve_topk":
            return dict(counted=tifu_serve(sz),
                        model=tifu_serve_model(sz, False))
        if shape == "serve_topk_opt":
            return dict(counted=tifu_serve(sz, sz.n_shards),
                        model=tifu_serve_model(sz, True))
        return None
    cell = arch.cells[shape]
    sz, _, _ = cell.choose(r["device_bytes"])
    if arch.family == "lm" and shape.startswith("prefill"):
        return dict(counted=lm_prefill(sz.config, sz.batch, sz.seq),
                    model=lm_prefill_model(sz.config, sz.batch, sz.seq))
    if name == "dimenet":
        g = cell.batch.graph(sz.config, sz.batch)
        return dict(counted=dimenet_train(sz.config, g),
                    model=dimenet_model(sz.config, g))
    if name == "deepfm" and shape == "train_batch":
        return dict(counted=deepfm_train(sz.config, sz.batch),
                    model=deepfm_train_model(sz.config, sz.batch))
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("results")
    args = ap.parse_args(argv)
    records = json.loads(Path(args.results).read_text())
    bad = 0
    for r in records:
        ratio = r.get("useful_flops_ratio")
        if ratio is None or ratio <= 1.0:
            continue
        counted = r["roofline"]["flops"]
        print(f"{r['arch']} x {r['shape']}: model {r['model_flops']:.6g} "
              f"FLOP, counted {counted:.6g}, useful_flops_ratio {ratio:.6f}")
        ex = explain(r)
        if ex is None:
            print(f"  no closed form; counted by dtype "
                  f"{r['roofline']['flops_by_dtype']}")
            continue
        for side in ("model", "counted"):
            for term, v in ex[side].items():
                print(f"  {side:7s} {term}: {v:.6g}")
        closed = sum(ex["counted"].values())
        same = closed == counted
        bad += not same
        print(f"  closed form {closed:.6g} "
              f"{'== counted' if same else f'!= counted ({counted:.6g})'}")
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
