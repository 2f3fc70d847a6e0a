"""LM training driver (the PyTorch port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \
        --smoke --steps 20 --device cpu      # reduced config, CPU
    PYTHONPATH=src python -m repro_torch.launch.train --arch lm100m \
        --steps 300 --batch 2 --seq 256 --ckpt build/lm100m_ckpt

The reference's flags and behaviour: the model's ``make_train_step``
with AdamW (warmup 20, a cosine to ``--steps``), seeded synthetic
batches with a copy structure the model can learn, a resume from the
latest checkpoint of ``--ckpt`` (in the JAX package's format, so either
package resumes the other's), an asynchronous checkpoint every
``--ckpt-every`` steps and at the end, and a log line every
``--log-every``.  The full assigned configs are refused without
``--smoke`` (they train through the sharded dry run).  As in the
reference, the batch generator restarts at seed 1234 on a resume: the
resumed steps see the first batches again, not those the interrupted
run would have drawn next.  Runs on the CUDA card unless ``--device
cpu`` is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import convert
from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    restore_pytree)
from repro_torch.configs import get_lm
from repro_torch.core.types import resolve_device
from repro_torch.models import transformer as T
from repro_torch.optim import optimizers

BATCH_SEED = 1234


def lm100m_config() -> T.TransformerConfig:
    """The reference's ~100M-parameter LM (12 layers, d_model 768, 12
    heads of 64, vocabulary 32,768, tied, f32)."""
    return T.TransformerConfig(
        name="lm100m", n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
        d_head=64, d_ff=2048, vocab_size=32768, tie_embeddings=True,
        dtype=torch.float32)


def synthetic_lm_batch(rng: np.random.Generator, batch: int, seq: int,
                       vocab: int, device: Any = None
                       ) -> Dict[str, torch.Tensor]:
    """The reference's synthetic batch: ``batch`` rows of ``seq + 1``
    uniform tokens from ``rng``, every even position from 2 on a copy of
    the one before it (structure the loss can learn); tokens the first
    ``seq``, labels the last ``seq``."""
    toks = rng.integers(0, vocab, (batch, seq + 1))
    toks[:, 2::2] = toks[:, 1:-1:2]
    dev = resolve_device(device)
    return {"tokens": torch.as_tensor(toks[:, :-1], device=dev),
            "labels": torch.as_tensor(toks[:, 1:], device=dev)}


@dataclasses.dataclass
class TrainRun:
    """What one :func:`run` did."""

    config: T.TransformerConfig
    step0: int                       # the step it resumed at (0: fresh)
    losses: Dict[int, float]         # step -> loss
    step_seconds: List[float]        # host clock, each ended by the loss


def _config(args: argparse.Namespace) -> T.TransformerConfig:
    if args.arch == "lm100m":
        return lm100m_config()
    _, smoke_config = get_lm(args.arch)
    if not args.smoke:
        raise SystemExit("full assigned configs train via the dry-run "
                         "mesh; use --smoke")
    return smoke_config()


def _state(model: T.Transformer, opt: optimizers.AdamW,
           step: int) -> Dict[str, Any]:
    """The checkpointed tree, the reference's ``{"p", "o", "step"}``."""
    return {"p": convert.transformer_params_tree(model),
            "o": convert.lm_opt_state_tree(opt, model),
            "step": torch.tensor(step, dtype=torch.int32)}


def run(argv: Optional[List[str]] = None) -> TrainRun:
    """The driver's loop on ``argv`` (the command line when ``None``)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="lm100m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", type=str, default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain PyTorch versions of the kernels)")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = resolve_device(args.device)
    c = _config(args)
    print(f"arch={c.name} params≈{c.n_params() / 1e6:.1f}M device={dev}")

    model = T.init_params(c, torch.Generator(device=dev).manual_seed(0),
                          dev)
    opt = optimizers.adamw(model.parameters(), lr=args.lr, warmup_steps=20,
                           total_steps=args.steps)
    step0 = 0
    ckptr = None
    if args.ckpt:
        ckptr = AsyncCheckpointer(args.ckpt)
        if latest_step(args.ckpt) is not None:
            state = restore_pytree(_state(model, opt, 0), args.ckpt)
            convert.load_transformer_params(model, state["p"])
            convert.opt_state_from_numpy(opt, model, state["o"])
            step0 = int(state["step"])
            print(f"resumed from step {step0}")

    train_step = T.make_train_step(c, opt)
    rng = np.random.default_rng(BATCH_SEED)
    out = TrainRun(c, step0, {}, [])
    loss = float("nan")
    for step in range(step0, args.steps):
        batch = synthetic_lm_batch(rng, args.batch, args.seq, c.vocab_size,
                                   dev)
        t0 = time.perf_counter()
        metrics = train_step(model, batch)
        loss = float(metrics["loss"])
        out.step_seconds.append(time.perf_counter() - t0)
        out.losses[step] = loss
        if step % args.log_every == 0 or step == args.steps - 1:
            recent = np.mean(out.step_seconds[-10:])
            print(f"step {step:5d} loss {loss:.4f} "
                  f"({recent * 1e3:.0f} ms/step, "
                  f"{args.batch * args.seq / recent:,.0f} tok/s)",
                  flush=True)
        if ckptr and step and step % args.ckpt_every == 0:
            ckptr.save(_state(model, opt, step + 1), step)
    if ckptr:
        ckptr.save(_state(model, opt, args.steps), args.steps)
        ckptr.close()
    print("final loss:", loss)
    return out


def main(argv: Optional[List[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
