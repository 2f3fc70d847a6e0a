"""End-to-end LM training on the PyTorch port: the port of
``examples/train_lm.py`` (a ~100M-parameter transformer trained for a
few hundred steps with checkpoint/restart), through
``repro_torch.launch.train``.

    # quick demo on the granite smoke config (seconds on the CPU):
    PYTHONPATH=src python examples/train_lm_torch.py --quick --device cpu
    # the full 100M x 300 steps run, on the card:
    PYTHONPATH=src python examples/train_lm_torch.py

Any other flag goes to the driver (``--device cpu`` runs the plain
PyTorch versions of the kernels).  The full run checkpoints into
``build/lm100m_ckpt`` at the root of the checkout and resumes from it.
"""
import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.launch.train import main as train_main  # noqa: E402

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    args, rest = ap.parse_known_args()
    if args.quick:
        argv = ["--arch", "granite-3-2b", "--smoke", "--steps", "30",
                "--batch", "8", "--seq", "64", "--log-every", "5"] + rest
    else:
        argv = ["--arch", "lm100m", "--steps", "300", "--batch", "2",
                "--seq", "256",
                "--ckpt", str(ROOT / "build" / "lm100m_ckpt")] + rest
    raise SystemExit(train_main(argv))
