"""The port's examples run on the CPU at their own small scale.

``examples/streaming_unlearning_torch.py --device cpu`` runs to its end,
and its stream, recovery and served top-10 match those printed by the
JAX package's ``examples/streaming_unlearning.py`` on the same seeded
data.  ``examples/serve_retrieval_torch.py --device cpu --candidates
20000`` runs to its end with its two top-100s (``streaming_topk`` and
``ops.knn_topk``) in full agreement.  ``examples/quickstart_torch.py
--device cpu`` prints the JAX quickstart's dataset line and basket
count, its Recall@10 and NDCG@10 within ``QUICKSTART_METRIC_ATOL``, and
a maintained vector within 1e-5 of the retrained one.
"""
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# The JAX quickstart builds its vectors in float64 (RefEngine) and serves
# them cast to float32; the port builds them in float32 through the
# update rules.  The corpora differ by float32 rounding, which may
# reorder near-tied neighbours or items of a few users.  One user's
# Recall@10 or NDCG@10 term weighs 1/418 (~0.0024) of the mean, so this
# lets about four users' top-10 differ by one hit.
QUICKSTART_METRIC_ATOL = 0.01


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


def test_quickstart_torch_matches_the_jax_quickstart():
    port = run("quickstart_torch.py", "--device", "cpu")
    ref = run("quickstart.py")

    def pick(lines, prefix):
        found = [ln for ln in lines if ln.startswith(prefix)]
        assert len(found) == 1, (prefix, lines)
        return found[0]

    assert pick(port, "dataset:") == pick(ref, "dataset:")
    assert pick(port, "built").split(" in ")[0] == \
        pick(ref, "built").split(" in ")[0]

    def metrics(line):
        # "Recall@10 = 0.3970   NDCG@10 = 0.3644"
        words = line.split()
        return float(words[2]), float(words[5])

    got, exp = metrics(pick(port, "Recall@10")), metrics(pick(ref,
                                                              "Recall@10"))
    assert abs(got[0] - exp[0]) <= QUICKSTART_METRIC_ATOL, (got, exp)
    assert abs(got[1] - exp[1]) <= QUICKSTART_METRIC_ATOL, (got, exp)
    assert pick(port, "deleted basket 0 of user").split(" in ")[0] == \
        pick(ref, "deleted basket 0 of user").split(" in ")[0]
    err = float(pick(port, "max |maintained").split("=")[1].split()[0])
    assert err <= 1e-5
    assert pick(port, "forgot item") == pick(ref, "forgot item")
