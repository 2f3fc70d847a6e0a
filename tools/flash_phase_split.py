#!/usr/bin/env python3
"""Where the Hopper attention kernel's time goes, on the card.

    python3 tools/flash_phase_split.py [--root DIR] [--reps N] [--phases]
        [--layer0]

Builds the port's kernels (logging ptxas's registers, spills and notes
for ``flash_wgmma_kernel``), holds ``flash_attention.launch`` against
``ref.flash_attention_ref`` on edge cases of the ``tma_wgmma`` design (S
1, 127 to 129, 191 to 193, 257 and 385, windows, KV < H and KV == H, D
64 and 128, no causal mask) and at granite-3-2b's layer-0 prefill shape
(B=4, S=4,096, H=32, KV=8, D=64, bf16, causal), and times it there and
at D = 128 (CUDA events, median of ``--reps`` runs after a warm-up), with
the ``torch.profiler`` device time and the SM clock and board power that
``nvidia-smi`` samples while the call runs back to back.  SDPA with K/V
repeated is timed beside it.

``--phases`` also times copies of ``flash_attention_wgmma.cu`` with parts
compiled out -- ``products`` (the softmax out: products, loads,
packing), ``softmax`` (both products out), ``feed`` (both out: loads,
barriers, packing, epilogue); their outputs are not checked -- at
granite's shape, without the causal mask, and at B=16, S=1,024 and B=1,
S=16,384 (as many work items, a quarter and four times the key tiles
each), which splits the time into a cost per work item and per tile.

``--layer0`` also checks and times the kernel on granite-3-2b layer 0's
own q, k and v (the seeded weights and tokens of ``chip_smoke.py``).
Every timing is also taken over 10 calls back to back between two
events, beside the single call.

``--root`` names another checkout (a ``git archive`` of an earlier
commit, unpacked under ``build/``): its ``flash_attention.launch`` is
checked and timed at granite's shape, nothing else.  Needs a CUDA card
and nvcc; prints the card and one JSON line.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import torch

GRANITE = (4, 4096, 32, 8, 64)
EDGES = (
    # B, S, H, KV, D, window, causal
    (2, 1, 4, 2, 64, 0, True),
    (1, 127, 4, 4, 64, 0, True),
    (2, 128, 8, 2, 64, 0, True),
    (1, 129, 4, 1, 128, 0, True),
    (2, 257, 4, 2, 64, 100, True),
    (1, 300, 2, 2, 128, 1000, True),
    (1, 257, 4, 2, 64, 0, False),
    (1, 200, 2, 1, 128, 70, False),
    (1, 191, 4, 2, 64, 0, True),
    (2, 193, 4, 4, 64, 150, True),
    (1, 385, 2, 1, 64, 0, False),
)
ATOL = 3e-2
WATCHDOG_S = 300
# calls compiled out by --phases
SOFTMAX_CALL = re.compile(r"^(\s*)(softmax_tile\()", re.M)
PRODUCT_CALLS = re.compile(r"^(\s*)(wgmma_(qk|pv)\([so],)", re.M)


def phase_sources(src: str) -> dict:
    """The --phases copies of the Hopper design's source."""
    products = SOFTMAX_CALL.sub(r"\1if (0) \2", src)
    out = {"whole": src, "products": products,
           "softmax": PRODUCT_CALLS.sub(r"\1if (0) \2", src),
           "feed": PRODUCT_CALLS.sub(r"\1if (0) \2", products)}
    for name, text in out.items():
        assert name == "whole" or text != src, name
    return out


def build_phases(build, csrc: Path, out: Path) -> dict:
    """Compile each --phases copy alone, in parallel; the loaded
    libraries by name."""
    procs = {}
    src = (csrc / "flash_attention_wgmma.cu").read_text()
    for name, text in phase_sources(src).items():
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "k.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-shared", str(d / "k.cu"),
             "-o", str(d / "lib.so")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        lib = ctypes.CDLL(str(out / name / "lib.so"))
        lib.flash_wgmma_launch.argtypes = build.SIGNATURES[
            "flash_wgmma_launch"]
        lib.flash_wgmma_launch.restype = ctypes.c_int
        libs[name] = lib
    return libs


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


def burst_ms(fn, n: int = 10) -> float:
    """Device time per call of ``n`` calls back to back between two CUDA
    events (the host's and the launch's latency paid once)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def layer0_inputs(c):
    """Granite-3-2b layer 0's q, k and v for 4 prompts of 4,096 tokens,
    from the seeded weights and tokens ``chip_smoke.py`` uses."""
    from repro_torch.models import transformer
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    model = transformer.init_params(c, gen, torch.device("cuda"))
    tokens = torch.randint(0, c.vocab_size, (4, 4096), generator=gen,
                           device="cuda")
    layer0 = model.layers[0]
    x = model.embed[tokens].to(c.dtype) * (c.d_model ** 0.5)
    pos = torch.arange(4096, device="cuda").expand(tokens.shape)
    return transformer.project_qkv(
        transformer.rms_norm(x, layer0.ln1, c.norm_eps), layer0, c, pos)


def device_ms(fn, reps: int = 5) -> float:
    """Device time per call of the kernels ``fn`` launched, from
    ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "self_device_time_total",
                        getattr(e, "self_cuda_time_total", 0))
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA)
    return total / reps / 1e3


def clocks(fn, seconds: float = 1.0) -> str:
    """The SM clock and the board's power while ``fn`` runs back to back
    for about ``seconds``: medians of ``nvidia-smi`` samples every 50 ms."""
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "50"],
                           stdout=subprocess.PIPE, text=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    while True:
        for _ in range(20):
            fn()
        end.record()
        end.synchronize()
        if start.elapsed_time(end) > seconds * 1e3:
            break
    smi.terminate()
    rows = [line.split(",") for line in smi.communicate()[0].splitlines()
            if line.count(",") == 1]
    mhz = float(np.median([float(r[0]) for r in rows[2:]] or [0]))
    watts = float(np.median([float(r[1]) for r in rows[2:]] or [0]))
    return f"{mhz:.0f} MHz, {watts:.0f} W"


def inputs(gen, b, s, h, kv, d):
    return [torch.randn((b, s, n, d), generator=gen, device="cuda").to(
        torch.bfloat16) for n in (h, kv, kv)]


def err(got, exp) -> float:
    return float((got.float() - exp.float()).abs().max())


def flops_of(b, s, h, d, causal=True) -> float:
    pairs = s * (s + 1) / 2 if causal else s * s
    return 4.0 * d * b * h * pairs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=None)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--layer0", action="store_true",
                    help="also time granite-3-2b layer 0's own q, k, v")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("flash_phase_split: no CUDA device")
    root = (args.root or Path(__file__).resolve().parents[1]).resolve()
    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels import build, flash_attention, ref

    # a lost barrier phase hangs a kernel: end the process instead
    watchdog = threading.Timer(WATCHDOG_S, lambda: (print(
        "flash_phase_split: no progress in %d s, exiting" % WATCHDOG_S,
        flush=True), os._exit(3)))
    watchdog.daemon = True
    watchdog.start()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}; root {root}", flush=True)
    lib = build.library(verbose=True)
    entry = ""
    for line in build.last_build_log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "flash_wgmma" in entry or "C75" in line:
            print(f"  ptxas {entry[:100]}: {line.strip()}", flush=True)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    b, s, h, kv, d = GRANITE
    q, k, v = inputs(gen, b, s, h, kv, d)
    exp = ref.flash_attention_ref(q, k, v)
    flops = flops_of(b, s, h, d)
    out = {"card": card, "root": str(root), "shape": GRANITE}

    def record(name, fn, expect, n_flops):
        got = fn()
        torch.cuda.synchronize()
        e = err(got, expect)
        assert e <= ATOL, (name, e)
        ms, dev, clk = time_ms(fn, args.reps), device_ms(fn), clocks(fn)
        burst = burst_ms(fn)
        out[name] = dict(max_abs_err=e, ms=ms, burst_ms=burst, device_ms=dev,
                         tflops=n_flops / ms / 1e9, clocks=clk)
        print(f"  {name}: max |err| {e}, {ms:.4f} ms a single call "
              f"({n_flops / ms / 1e9:.1f} TFLOP/s), {burst:.4f} ms a call of "
              f"10 back to back, profiler {dev:.4f} ms; {clk}", flush=True)

    record("launch", lambda: flash_attention.launch(q, k, v), exp, flops)
    if args.layer0:
        from repro_torch.configs import granite_3_2b
        lq, lk, lv = layer0_inputs(granite_3_2b.make_config())
        record("launch, layer 0's activations",
               lambda: flash_attention.launch(lq, lk, lv),
               ref.flash_attention_ref(lq, lk, lv), flops)
        del lq, lk, lv
        torch.cuda.empty_cache()
    if hasattr(flash_attention, "plan_flash"):
        print(f"  plan: {flash_attention.plan_flash(q, k, v)}", flush=True)
        worst = 0.0
        for eb, es, eh, ekv, ed, win, causal in EDGES:
            eq, ek, ev = inputs(gen, eb, es, eh, ekv, ed)
            assert flash_attention.plan_flash(eq, ek, ev).design == \
                "tma_wgmma"
            e = err(flash_attention.launch(eq, ek, ev, causal, win),
                    ref.flash_attention_ref(eq, ek, ev, causal, win))
            assert e <= ATOL, (eb, es, eh, ekv, ed, win, causal, e)
            worst = max(worst, e)
        print(f"  {len(EDGES)} edge cases, max |err| {worst}", flush=True)
        xq, xk, xv = inputs(gen, b, s, h, kv, 128)
        record("launch D=128", lambda: flash_attention.launch(xq, xk, xv),
               ref.flash_attention_ref(xq, xk, xv), flops_of(b, s, h, 128))
        del xq, xk, xv
    if args.phases:
        libs = build_phases(build, root / "src" / "repro_torch" / "kernels" /
                            "csrc", root / "build" / "flash_phases")
        stream = torch.cuda.current_stream().cuda_stream

        def phase(plib, q, k, v, causal=True):
            plan = flash_attention.plan_flash(q, k, v, 0, causal)
            bb, ss, hh, dd = q.shape
            o = torch.empty_like(q)
            build.check(plib.flash_wgmma_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), bb,
                ss, hh, k.shape[2], dd,
                *[x for t in (q, k, v) for x in t.stride()[:3]],
                1.0 / dd ** 0.5, int(causal), 0, plan.stages,
                plan.smem_bytes, stream), "flash_wgmma phase")
            return o

        shapes = [("granite", q, k, v, True), ("granite, no causal mask", q,
                                                k, v, False)]
        for sb, ss in ((16, 1024), (1, 16384)):
            shapes.append((f"B={sb} S={ss}", *inputs(gen, sb, ss, h, kv, d),
                           True))
        for what, sq, sk, sv, causal in shapes:
            for name, plib in libs.items():
                ms = time_ms(lambda pl=plib: phase(pl, sq, sk, sv, causal),
                             args.reps)
                out[f"{name} {what}"] = ms
                print(f"  phase {name} at {what}: {ms:.4f} ms", flush=True)
    group = h // kv
    qt, kt, vt = (t.transpose(1, 2) for t in (
        q, k.repeat_interleave(group, 2), v.repeat_interleave(group, 2)))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fn = lambda: sdpa(qt, kt, vt, is_causal=True)  # noqa: E731
    out["sdpa_ms"], out["sdpa_clocks"] = time_ms(fn, args.reps), clocks(fn)
    print(f"  SDPA: {out['sdpa_ms']:.4f} ms; {out['sdpa_clocks']}",
          flush=True)
    watchdog.cancel()
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
