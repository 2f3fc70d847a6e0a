"""Batched retrieval serving on the PyTorch port: the two-tower model and
the knn_topk kernel (B3) -- 64 user queries against 200,000 candidates
without writing the score matrix.

    PYTHONPATH=src python examples/serve_retrieval_torch.py \
        [--device cpu] [--candidates N]

Builds the towers from a seeded generator, indexes the candidates
through ``item_tower`` (the offline index build), embeds the queries
through ``user_tower``, then takes each query's top 100 by dot score
twice: by ``core.knn.streaming_topk`` (plain PyTorch, corpus chunks of
25,000 rows) and by ``ops.knn_topk`` (B3 on the card, its plain version
on the CPU), and prints how far the two agree.  Runs on the CUDA card
unless given ``--device cpu``.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import recsys_shapes
from repro_torch.core.knn import streaming_topk
from repro_torch.core.types import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import two_tower

CONFIG = two_tower.TwoTowerConfig(n_users=10_000, n_items=50_000,
                                  n_item_cats=100, hist_len=16,
                                  embed_dim=64, tower_mlp=(128, 64))
N_QUERIES, TOP_K, CHUNK = 64, 100, 25_000


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.no_grad()
def serve(device=None, n_cand: int = 200_000, seed: int = 0) -> dict:
    """Index ``n_cand`` candidates, embed the queries, take both top-k
    (no autograd graph: the towers' weights are trainable).

    Returns the queries and candidates, both (values, ids) results, the
    mean fraction of each query's top k the two share, and the host
    seconds of the index build and of each top-k."""
    dev = resolve_device(device)
    c = CONFIG
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = two_tower.init_params(c, gen, dev)

    _sync(dev)
    t0 = time.perf_counter()
    cand = two_tower.item_tower(
        params, recsys_shapes.two_tower_items(c, n_cand, gen), c)
    _sync(dev)
    index_s = time.perf_counter() - t0
    users = recsys_shapes.two_tower_batch(c, N_QUERIES, gen)
    q = two_tower.user_tower(params, users, c)

    def timed(fn):
        _sync(dev)
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        return out, time.perf_counter() - t0
    stream, stream_s = timed(lambda: streaming_topk(
        q, cand, k=TOP_K, metric="dot", chunk=CHUNK))
    kernel, kernel_s = timed(lambda: ops.knn_topk(q, cand, TOP_K,
                                                  metric="dot"))
    agree = float(np.mean([len(set(a) & set(b)) / TOP_K for a, b in zip(
        stream[1].tolist(), kernel[1].tolist())]))
    return dict(queries=q, candidates=cand, stream=stream, kernel=kernel,
                agreement=agree, index_s=index_s, stream_s=stream_s,
                kernel_s=kernel_s)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--candidates", type=int, default=200_000)
    args = ap.parse_args(argv)
    r = serve(args.device, args.candidates)
    n = r["candidates"].shape[0]
    print(f"indexed {n:,} candidates in {r['index_s']:.2f}s")
    print(f"streaming top-{TOP_K} of {N_QUERIES} queries x {n:,} "
          f"candidates: {r['stream_s'] * 1e3:.1f} ms")
    print(f"ops.knn_topk top-{TOP_K}: {r['kernel_s'] * 1e3:.1f} ms")
    print(f"knn_topk agreement with streaming top-k: "
          f"{r['agreement']:.1%}")
    vals, idx = r["stream"]
    print("query 0 top-5 candidates:", idx[0, :5].tolist(), "scores",
          [round(float(v), 3) for v in vals[0, :5]])


if __name__ == "__main__":
    main()
