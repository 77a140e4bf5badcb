"""The port's examples (examples/torch/) run end to end on the CPU at a
tiny size, each in its own process with ``--device cpu``: exit 0 and the
fields their JAX twins print (examples/*.py); those that reach the
Psi-statistics end with the kernels' launch counts, all 0 on the CPU."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples" / "torch"
TIMEOUT = 240


def _run(args, tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="2", TMPDIR=str(tmp_path))
    res = subprocess.run(args, cwd=tmp_path, env=env, capture_output=True, text=True,
                         timeout=TIMEOUT)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    return res.stdout


@pytest.mark.parametrize("script, args, fields", [
    ("gplvm_oil_flow.py", ["--n", "150", "--iters", "10"],
     ["bound:", "objective evaluations", "ARD precisions (sorted):",
      "effective latent dims", "1-NN accuracy in top-2 latent dims:"]),
    ("sparse_gp_regression.py", ["--n", "200", "--iters", "20"],
     ["bound:", "learned noise std:", "test RMSE vs noiseless truth:"]),
    ("large_scale_gplvm.py", ["--n", "2000", "--m", "20", "--block", "500", "--reps", "1"],
     ["1 device(s): cpu", "xla    :", "pallas :", "ms / bound+grad eval", "s/eval"]),
    ("huge_n_single_chip.py", ["--n", "2000", "--m", "20", "--iters", "2"],
     ["device: cpu", "N=2000:", "SCG iterations", "s/eval", "monotone=True"]),
], ids=["gplvm_oil_flow", "sparse_gp_regression", "large_scale_gplvm", "huge_n_single_chip"])
def test_example_runs_on_the_cpu(tmp_path, script, args, fields):
    out = _run([sys.executable, str(EXAMPLES / script), "--device", "cpu", *args], tmp_path)
    for field in fields:
        assert field in out, (field, out)
    if script != "sparse_gp_regression.py":
        last = json.loads(out.strip().splitlines()[-1])
        assert set(last["kernel_launches"]) == {"fwd", "bwd", "fwd_t", "bwd_t", "fwd_cells",
                                                "fwd_cells_t"}
        assert not any(last["kernel_launches"].values()), last


def test_cli_workflow_runs_on_the_cpu(tmp_path):
    """Partitions written, a fit, then a resume from its checkpoint."""
    out = _run(["bash", str(EXAMPLES / "cli_workflow.sh"), "--device", "cpu", "-T", "3"],
               tmp_path)
    assert "wrote 4 partitions" in out and "--- resuming ---" in out
    assert "resumed from" in out and "artifacts in" in out
    assert out.count('"final_bound"') == 2


def test_examples_without_a_card_raise(tmp_path):
    """--device cuda (the default) on a machine without a card raises and
    names --device cpu; nothing runs on the CPU in its place."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, str(EXAMPLES / "sparse_gp_regression.py")],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=TIMEOUT)
    assert res.returncode != 0 and "--device cpu" in res.stderr
    assert "learned noise std" not in res.stdout
