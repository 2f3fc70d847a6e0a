"""Streaming unlearning on the PyTorch port: the engine processes a mixed
stream of basket arrivals and GDPR deletion requests, survives a
simulated crash (exactly-once recovery), and serves recommendations from
the live state store.  The port of ``examples/streaming_unlearning.py``,
step for step; it runs on the CUDA card unless ``--device cpu`` is
given.

    PYTHONPATH=src python examples/streaming_unlearning_torch.py [--device cpu]
"""
import argparse
import dataclasses
import tempfile
import time

import numpy as np
import torch

from repro_torch.core import knn
from repro_torch.data import stream, synthetic
from repro_torch.streaming import StateStore, StoreConfig, StreamingEngine

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda",
                help="torch device of the state and the serving path")
args = ap.parse_args()
dev = torch.device(args.device)


def sync() -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


ds = synthetic.generate("instacart", scale=0.02, seed=0)
p = ds.params
n_users = len(ds.histories)
store = StateStore(StoreConfig(
    n_users=n_users, n_items=p.n_items,
    max_baskets=max(len(h) for h in ds.histories.values()) + 8,
    max_basket_size=max((len(b) for h in ds.histories.values()
                         for b in h), default=8) + 2), device=dev)
engine = StreamingEngine(store, p, batch_size=256)

events = stream.make_stream(ds.histories, deletion_user_rate=5e-3,
                            deletion_basket_frac=0.1,
                            item_deletion_rate=2e-3, seed=1)
n_dels = sum(1 for e in events if e.kind != 1)
print(f"stream: {len(events)} events ({n_dels} deletion requests) "
      f"for {n_users} users")

with tempfile.TemporaryDirectory() as ckpt:
    # process half, then simulate a crash + recovery
    engine.submit(events)
    half = len(events) // (2 * engine.batch_size)
    for _ in range(half):
        engine.step()
    engine.checkpoint(ckpt, step=half)
    print(f"processed {engine.metrics.events_processed} events, "
          f"checkpointed, simulating crash...")

    store2 = StateStore(dataclasses.replace(store.cfg), device=dev)
    engine2 = StreamingEngine(store2, p, batch_size=256)
    engine2.restore(ckpt)
    # at-least-once redelivery of the WHOLE stream: duplicates are skipped
    engine2.submit([dataclasses.replace(e, seqno=i)
                    for i, e in enumerate(events)])
    t0 = time.perf_counter()
    n = engine2.run_until_drained()
    sync()
    dt = time.perf_counter() - t0
print(f"recovered + drained {n} remaining events in {dt:.2f}s "
      f"({n/max(dt,1e-9):,.0f} events/s); "
      f"stability refreshes: {engine2.metrics.refreshes}")

# serve from the live store
corpus = store2.state.materialized_user_vecs()
t0 = time.perf_counter()
recs = knn.recommend_for_users(corpus, torch.arange(256, device=dev),
                               k=p.k_neighbors, alpha=p.alpha, topn=10)
sync()
print(f"served 256 users from live state in "
      f"{(time.perf_counter()-t0)*1e3:.1f} ms")
print("user 0 top-10:", np.asarray(recs[0].cpu()))
