"""The port's examples run on the CPU at their own small scale.

``examples/streaming_unlearning_torch.py --device cpu`` runs to its end,
and its stream, recovery and served top-10 match those printed by the
JAX package's ``examples/streaming_unlearning.py`` on the same seeded
data.  ``examples/serve_retrieval_torch.py --device cpu --candidates
20000`` runs to its end with its two top-100s (``streaming_topk`` and
``ops.knn_topk``) in full agreement.
"""
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def run(script, *args):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]]
                               if env.get("PYTHONPATH") else []))
    env.setdefault("JAX_PLATFORMS", "cpu")
    out = subprocess.run([sys.executable, str(ROOT / "examples" / script),
                          *args], env=env, capture_output=True, text=True,
                         timeout=300, check=True)
    return out.stdout.splitlines()


def test_streaming_unlearning_torch_matches_the_jax_example():
    port = run("streaming_unlearning_torch.py", "--device", "cpu")
    ref = run("streaming_unlearning.py")

    def pick(lines, prefix):
        return [ln for ln in lines if ln.startswith(prefix)]

    assert pick(port, "stream:") == pick(ref, "stream:")
    assert pick(port, "processed") == pick(ref, "processed")
    # "recovered + drained N remaining events in ...": N equal
    assert [ln.split(" in ")[0] for ln in pick(port, "recovered")] == \
        [ln.split(" in ")[0] for ln in pick(ref, "recovered")]
    top = pick(port, "user 0 top-10:")
    assert len(top) == 1 and top == pick(ref, "user 0 top-10:")


def test_serve_retrieval_torch_top_k_agree():
    out = run("serve_retrieval_torch.py", "--device", "cpu", "--candidates",
              "20000")
    assert out[0].startswith("indexed 20,000 candidates in ")
    assert "knn_topk agreement with streaming top-k: 100.0%" in out
    assert out[-1].startswith("query 0 top-5 candidates:")


def test_train_lm_torch_quick_trains_the_granite_smoke_model():
    """``examples/train_lm_torch.py --quick --device cpu``: the JAX
    example's quick run (granite's smoke config, 30 steps of 8 x 64
    tokens, a line every 5) through the port's driver, its loss
    falling."""
    out = run("train_lm_torch.py", "--quick", "--device", "cpu")
    assert out[0].startswith("arch=granite-smoke ")
    steps = [ln for ln in out if ln.startswith("step ")]
    assert [int(ln.split()[1]) for ln in steps] == [0, 5, 10, 15, 20, 25,
                                                    29]
    assert out[-1].startswith("final loss:")
    assert float(out[-1].split()[-1]) < float(steps[0].split()[3])
