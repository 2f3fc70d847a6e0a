#!/usr/bin/env python3
"""Where the sharded engine's step spends its host time, on the card.

    python3 tools/sharded_step_split.py [--shards N] [--events E]
        [--rounds R]

Feeds the mixed stream of ``chip_smoke.py``'s phases 8 and 9 (TaFeng at
its published size, 13,949 users x 11,997 items, each event with its
seqno, micro-batches of 512 a shard) through fresh engines on the one
card, in turns, and splits each load's host seconds by phase:

- ``single``: one ``StreamingEngine`` (the yardstick);
- ``three_pass``: ``ShardedStreamingEngine.step`` (every shard prepares,
  then every shard completes, then every shard finishes);
- ``serial``: the same shards stepped one at a time
  (``prepare, complete, finish`` of shard 0, then of shard 1, ...).

Each runs with the batch tensors and the delete rows' index
(``core.types._dev``) copied to the card two ways, patched in by this
tool: ``blocking`` (``Tensor.to`` from pageable memory, which waits for
the whole stream) and ``pinned`` (a copy into pinned memory, then a
``non_blocking`` one, which does not wait).  Per shard it sums the
seconds in ``_prepare_step``, in ``_HostFetch.wait`` (the only wait the
step means to have), in the rest of ``_complete_step`` and in
``_finish_step``, and the host-to-device copies' share of prepare and
complete; beside them the load's wall seconds and events/s.
Every load's final state is held bitwise against the first one's.
Needs a CUDA card and nvcc; prints the card and one JSON line.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from chip_smoke import mixed_stream  # noqa: E402
from repro_torch.core import types  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.launch.mesh import make_user_shard_devices  # noqa: E402
from repro_torch.parallel.sharding import UserShardSpec  # noqa: E402
from repro_torch.streaming import engine  # noqa: E402
from repro_torch.streaming.state_store import StateStore  # noqa: E402

BATCH = 512


def blocking_dev(x, device):
    return torch.from_numpy(x).to(types.resolve_device(device))


def pinned_dev(x, device):
    dev = types.resolve_device(device)
    t = torch.from_numpy(x)
    if dev.type != "cuda":
        return t.to(dev)
    return t.pin_memory().to(dev, non_blocking=True)


COPIES = {"blocking": blocking_dev, "pinned": pinned_dev}


class Split:
    """Per-shard host seconds by phase, through wrapped methods."""

    def __init__(self, shards):
        self.secs = [defaultdict(float) for _ in shards]
        self.current = None
        wait = engine._HostFetch.wait
        split = self

        def timed_wait(fetch):
            t0 = time.perf_counter()
            try:
                return wait(fetch)
            finally:
                if split.current is not None:
                    split.secs[split.current]["wait"] += \
                        time.perf_counter() - t0

        self._restore = wait
        engine._HostFetch.wait = timed_wait
        for s, sh in enumerate(shards):
            for phase in ("_prepare_step", "_complete_step",
                          "_finish_step"):
                setattr(sh, phase, self._wrap(s, getattr(sh, phase),
                                              phase.strip("_")))

    def _wrap(self, s, fn, name):
        def run(*a):
            self.current = s
            t0 = time.perf_counter()
            try:
                return fn(*a)
            finally:
                self.secs[s][name] += time.perf_counter() - t0
                self.current = None
        return run

    def copies(self, fn):
        """``fn`` (a ``_dev``) timed into the current shard's copies."""
        def run(x, device):
            t0 = time.perf_counter()
            try:
                return fn(x, device)
            finally:
                if self.current is not None:
                    self.secs[self.current]["copies"] += \
                        time.perf_counter() - t0
        return run

    def close(self):
        engine._HostFetch.wait = self._restore

    def per_shard(self):
        """prepare, wait, the rest of complete, finish, and the
        host-to-device copies inside prepare and complete; seconds."""
        return [{"prepare_s": d["prepare_step"], "wait_s": d["wait"],
                 "copies_s": d["copies"],
                 "complete_rest_s": d["complete_step"] - d["wait"],
                 "finish_s": d["finish_step"]} for d in self.secs]


def serial_drain(eng):
    """Drain by stepping the shards one at a time."""
    while True:
        n = sum(sh.step() for sh in eng.shards)
        if n == 0:
            return


def state_of(shards):
    return [(sh.store.state.materialized_user_vecs(),
             sh.store.state.materialized_last_group_vecs(),
             sh.store.state.history, sh.store.state.n_baskets)
            for sh in shards]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shards", type=int, default=2)
    ap.add_argument("--events", type=int, default=0,
                    help="the stream's first E events (0: all of it)")
    ap.add_argument("--rounds", type=int, default=2,
                    help="rounds of turns (each reversed from the last)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sharded_step_split: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    # verbose, as chip_smoke.py builds: the ptxas log it reads is kept
    build.library(verbose=True)
    dev = torch.device("cuda")
    ds = synthetic.generate("tafeng", seed=0, scale=1.0)
    p = ds.params
    cfg, events = mixed_stream(ds)
    if args.events:
        events = events[:args.events]
    n_users = len(ds.histories)
    spec = UserShardSpec(n_users, args.shards)

    def make(kind):
        if kind == "single":
            eng = engine.StreamingEngine(StateStore(cfg, device=dev), p,
                                         batch_size=BATCH)
            return eng, [eng]
        eng = engine.ShardedStreamingEngine.create(
            spec, p, cfg.max_baskets, cfg.max_basket_size,
            devices=make_user_shard_devices(args.shards), batch_size=BATCH)
        return eng, eng.shards

    def load(kind, copies):
        types._dev = engine._dev = COPIES[copies]
        eng, shards = make(kind)
        eng.submit(events)
        split = Split(shards)
        types._dev = engine._dev = split.copies(COPIES[copies])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if kind == "serial":
            serial_drain(eng)
        else:
            eng.run_until_drained()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        split.close()
        assert eng.n_pending == 0
        return eng, shards, wall, split.per_shard()

    # the kernels' build, the caches' first allocations
    warm = events
    events = events[:4096]
    for kind in ("single", "three_pass"):
        for copies in COPIES:
            load(kind, copies)
    events = warm
    want = {}
    variants = [(k, c) for k in ("single", "three_pass", "serial")
                for c in COPIES]
    res = defaultdict(list)
    for rnd in range(args.rounds):
        for kind, copies in (variants if rnd % 2 == 0
                             else list(reversed(variants))):
            eng, shards, wall, split = load(kind, copies)
            got = state_of(shards)
            layout = "single" if kind == "single" else "sharded"
            if layout not in want:
                want[layout] = got
            else:
                for a, b in zip(want[layout], got):
                    assert all(torch.equal(x, y) for x, y in zip(a, b)), \
                        (kind, copies, "state differs")
            fetches = [sh.metrics.host_fetches for sh in shards]
            steps = [sh.metrics.batches for sh in shards]
            res[f"{kind}/{copies}"].append(dict(
                wall_s=wall, events_per_s=len(events) / wall,
                host_fetches=fetches, batches=steps, shards=split))
            print(f"{kind:>10} {copies:>8}: {wall:.3f} s, "
                  f"{len(events) / wall:.0f} events/s; per shard "
                  + "; ".join(
                      f"prepare {d['prepare_s']:.3f} wait "
                      f"{d['wait_s']:.3f} complete {d['complete_rest_s']:.3f}"
                      f" finish {d['finish_s']:.3f} (copies "
                      f"{d['copies_s']:.3f})" for d in split)
                  + f" [{card}]", flush=True)
            del eng, shards
            torch.cuda.empty_cache()
    print(json.dumps({"card": card, "events": len(events),
                      "shards": args.shards, "batch": BATCH,
                      "runs": res}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
