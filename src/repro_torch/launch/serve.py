"""TIFU-kNN serving driver: batched next-basket recommendation requests
against a live, stream-maintained state store (the PyTorch port).

The trickle demo: generate a dataset, bulk-load it as one mixed stream
(basket additions plus basket and item deletions), then alternate a
trickle of new baskets with request batches served by
``StreamingEngine.recommend`` from the cached corpus (``run_trickle(
quantized=True)`` serves each batch a second time from the int8 cache).
It prints the load rate, each request's latency, the engine's
and the caches' counters and the launch count of every CUDA kernel.
Runs on the CUDA device unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.serve --scale 0.05
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.types import KIND_ADD_BASKET, resolve_device
from repro_torch.data import stream, synthetic
from repro_torch.kernels import build
from repro_torch.streaming.engine import Event, StreamingEngine
from repro_torch.streaming.state_store import StateStore, StoreConfig


@dataclasses.dataclass
class ServeRun:
    """What one trickle run did: the engine, its requests and timings."""

    engine: StreamingEngine
    n_events: int
    load_seconds: float
    requests: List[np.ndarray]          # user ids of each request batch
    recs: List[np.ndarray]              # i32[Q, topn] answer of each
    corpora: List[torch.Tensor]         # corpus each request was served from
    request_seconds: List[float]
    # with quantized=True: the int8 answer of each request batch, the
    # (q, scale) it was served from (keep_corpora) and its latency
    quant_recs: List[np.ndarray] = dataclasses.field(default_factory=list)
    quant_corpora: List[Tuple[torch.Tensor, torch.Tensor]] = \
        dataclasses.field(default_factory=list)
    quant_request_seconds: List[float] = \
        dataclasses.field(default_factory=list)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_trickle(ds: synthetic.BasketDataset, seed: int = 0,
                requests: int = 4, batch: int = 256, topn: int = 10,
                trickle: int = 64, load_batch: int = 512,
                deletion_user_rate: float = 0.01,
                item_deletion_rate: float = 0.005,
                device: Any = None, keep_corpora: bool = False,
                quantized: bool = False) -> ServeRun:
    """Load ``ds`` as one mixed stream, then trickle and serve.

    The same dataset and seed give the same events and requests.
    ``quantized`` serves each request batch a second time through the
    int8 path (``recommend(quantized=True)``).  ``keep_corpora`` keeps a
    copy of the corpus (and of the int8 ``(q, scale)``) each request was
    served from, for holding the answers against it later.
    """
    dev = resolve_device(device)
    p = ds.params
    n_users = len(ds.histories)
    store = StateStore(StoreConfig(
        n_users=n_users, n_items=p.n_items,
        max_baskets=max(len(h) for h in ds.histories.values()) + 8,
        max_basket_size=max(len(b) for h in ds.histories.values()
                            for b in h) + 2), device=dev)
    eng = StreamingEngine(store, p, batch_size=load_batch)
    events = stream.make_stream(ds.histories,
                                deletion_user_rate=deletion_user_rate,
                                item_deletion_rate=item_deletion_rate,
                                seed=seed)
    _sync(dev)
    t0 = time.perf_counter()
    eng.submit(events)
    eng.run_until_drained()
    _sync(dev)
    load_seconds = time.perf_counter() - t0

    rng = np.random.default_rng(seed)
    out = ServeRun(eng, len(events), load_seconds, [], [], [], [])
    for r in range(requests):
        if r and trickle:
            # live updates between requests: only these users' corpus
            # rows are refreshed by the next request
            eng.submit([Event(KIND_ADD_BASKET, int(u), items=rng.choice(
                p.n_items, size=int(rng.integers(1, 6)), replace=False))
                for u in rng.choice(n_users, size=min(trickle, n_users),
                                    replace=False)])
            eng.run_until_drained()
        users = rng.choice(n_users, size=min(batch, n_users), replace=False)
        _sync(dev)
        t0 = time.perf_counter()
        recs = eng.recommend(users, topn=topn)     # ends in a host copy
        out.request_seconds.append(time.perf_counter() - t0)
        out.requests.append(users)
        out.recs.append(recs)
        if keep_corpora:
            out.corpora.append(store.corpus().clone())
        if quantized:
            _sync(dev)
            t0 = time.perf_counter()
            out.quant_recs.append(eng.recommend(users, topn=topn,
                                                quantized=True))
            out.quant_request_seconds.append(time.perf_counter() - t0)
            if keep_corpora:
                # copies at the cache's row pitch, read as the cache is
                out.quant_corpora.append(tuple(
                    torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                        device=t.device).copy_(t)
                    for t in store.quantized_corpus()))
    return out


def main(argv: Optional[List[str]] = None) -> int:
    """Command-line trickle demo."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="tafeng")
    ap.add_argument("--scale", type=float, default=0.05)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--batch", type=int, default=256,
                    help="users per request batch")
    ap.add_argument("--topn", type=int, default=10)
    ap.add_argument("--trickle", type=int, default=64,
                    help="basket additions applied between requests")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain PyTorch versions of the kernels)")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.reset_launch_counts()
    res = run_trickle(synthetic.generate(args.dataset, scale=args.scale),
                      requests=args.requests,
                      batch=args.batch, topn=args.topn,
                      trickle=args.trickle, device=args.device)
    print(summary(res))
    return 0


def summary(res: ServeRun) -> str:
    """Human-readable counters of one run (and the kernel launches)."""
    m = res.engine.metrics
    store = res.engine.store
    lines = [f"loaded {res.n_events} events for {store.cfg.n_users} users "
             f"x {store.cfg.n_items} items in {res.load_seconds:.2f} s "
             f"({res.n_events / res.load_seconds:.0f} events/s)"]
    for i, (users, dt) in enumerate(zip(res.requests, res.request_seconds)):
        lines.append(f"request batch {i}: {len(users)} users in "
                     f"{dt * 1e3:.2f} ms")
    for i, dt in enumerate(res.quant_request_seconds):
        lines.append(f"request batch {i} again, int8: {dt * 1e3:.2f} ms")
    lines.append(f"engine: {m.events_processed} events in {m.batches} "
                 f"micro-batches, {m.host_fetches} host fetches "
                 f"({m.host_fetches / max(m.batches, 1):.2f} per step), "
                 f"{m.refreshes} refreshes, {m.renormalizations} "
                 f"renormalizations, {m.dropped_adds} dropped adds, "
                 f"{m.dead_letters} dead letters")
    lines.append(f"corpus cache: {store.corpus_full_builds} full build(s), "
                 f"{store.corpus_rows_refreshed} row refreshes")
    if res.quant_recs:
        lines.append(f"int8 cache: {store.quant_full_builds} full build(s) "
                     f"({store.quant_threshold_rebuilds} past the "
                     f"threshold), {store.quant_rows_refreshed} row "
                     f"refreshes")
    lines.append("kernel launches: " + ", ".join(
        f"{k}={v}" for k, v in build.launch_counts.items()))
    lines.append(f"sample recommendation for user "
                 f"{int(res.requests[-1][0])}: {res.recs[-1][0].tolist()}")
    return "\n".join(lines)


if __name__ == "__main__":
    raise SystemExit(main())
