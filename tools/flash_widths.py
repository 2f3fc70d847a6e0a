#!/usr/bin/env python3
"""B9's Hopper design at one shape for each (D, Dv) it takes.

    python3 tools/flash_widths.py [--batch B] [--seq S] [--heads H]
        [--reps N]

Builds the port's kernels, then for each (D, Dv) of
``flash_attention.WGMMA_DV`` -- (64, 64), (128, 128) and MLA's (192,
128) -- makes seeded N(0, 1) bf16 q, k [B, S, H, D] and v [B, S, H, Dv]
(H = KV, causal; default DeepSeek-V3's layer 0: B 4, S 4,096, H 128),
checks that ``flash_attention.plan_flash`` picks ``tma_wgmma`` and that
``flash_attention.launch`` agrees with ``ref.flash_attention_ref``
within the JAX package's bf16 bound (3e-2), and times the launch (CUDA
events, median of ``--reps`` after a warm-up) in two turns, beside its
bound: 2·(D + Dv) flops a visible (query, key) pair at 989 TFLOP/s.  So
the instantiations' shares of their bound compare at one B·H.  Needs a
CUDA card; prints the card's name and power limit and, last, one JSON
line.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build, flash_attention, ref  # noqa: E402

PEAK_BF16 = 989e12
ATOL = 3e-2


def time_ms(fn, reps: int) -> float:
    """Median device time of ``fn`` after a warm-up (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--seq", type=int, default=4096)
    p.add_argument("--heads", type=int, default=128)
    p.add_argument("--reps", type=int, default=5)
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("flash_widths: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    build.library()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    b, s, h = args.batch, args.seq, args.heads
    pairs = b * h * s * (s + 1) / 2
    out = {}
    for turn in range(2):
        for d, dv in flash_attention.WGMMA_DV.items():
            q, k = (torch.randn((b, s, h, d), generator=gen, device=dev
                                ).to(torch.bfloat16) for _ in range(2))
            v = torch.randn((b, s, h, dv), generator=gen, device=dev
                            ).to(torch.bfloat16)
            assert flash_attention.plan_flash(q, k, v).design == \
                "tma_wgmma", (d, dv)
            if turn == 0:
                err = float((flash_attention.launch(q, k, v).float()
                             - ref.flash_attention_ref(q, k, v).float())
                            .abs().max())
                assert err <= ATOL, (d, dv, err)
            ms = time_ms(lambda: flash_attention.launch(q, k, v), args.reps)
            bound_ms = 2.0 * (d + dv) * pairs / PEAK_BF16 * 1e3
            key = f"{d}x{dv}"
            out.setdefault(key, dict(bound_ms=bound_ms, ms=[]))["ms"].append(
                ms)
            print(f"turn {turn}: (D, Dv) ({d}, {dv}) at B={b} S={s} H={h} "
                  f"causal: {ms:.4f} ms, {bound_ms / ms:.3f} of its bound "
                  f"{bound_ms:.4f} ms" + (f"; max |err| {err}" if turn == 0
                                          else ""), flush=True)
            del q, k, v
            torch.cuda.empty_cache()
    print(json.dumps(dict(card=card, batch=b, seq=s, heads=h, widths=out)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
