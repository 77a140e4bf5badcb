"""The benchmark's data-parallel fit (``portbench/drive/fit_dp.py``) and its
reference summed over ranks (``portbench/reference/gplvm_dp.py``), on the
CPU over gloo at N=64, M=8, Q=3, D=5 in float64, and the program's spans
and byte count of its collectives (``parallel/distributed.py``).

Tolerances: program and reference both compute in float64 and differ in
the order of their sums alone (~1e-15 relative); through two SCG iterations
whose steps the program chose, the changes differ by ~1e-13. So the bound
is held at 1e-12 relative, the gradients and changes at 1e-9 of their
largest element: a summand counted twice or left out moves them by O(1)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gparml_tpu_torch import graft_entry
from portbench import harness, trace
from portbench.reference import gplvm as ref
from tests import torch_dp_worker as worker

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# each spawn takes ~10 s; the limit only stops a hung rank
TIMEOUT = 90
RANK0 = os.path.join(ROOT, "tests", "torch_fit_dp_rank0.py")
WORKER = os.path.join(ROOT, "tests", "torch_dp_worker.py")


def _ranks(mode, ranks, out):
    graft_entry.run_ranks([WORKER, mode, str(out)], ranks, timeout=TIMEOUT,
                          env={"OMP_NUM_THREADS": "1"})


def _rank0(*args) -> dict:
    done = subprocess.run([sys.executable, RANK0, *map(str, args)], capture_output=True,
                          text=True, timeout=TIMEOUT, cwd=ROOT,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert done.returncode == 0, done.stderr[-4000:]
    return json.loads(done.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("dp_reference")
    _ranks("reference", 4, out)
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(4)]


def _close(got, want, rtol, what):
    scale = max(float(np.abs(want).max()), 1e-300)
    assert float(np.abs(got - want).max()) <= rtol * scale, what


def test_reference_over_ranks_is_the_reference_over_the_whole_n(four_ranks):
    """The reference summed over four ranks gives the one-process
    reference's bound and gradient: the global leaves whole on every rank,
    each rank's latents its own rows."""
    y, arrays = worker.problem()
    g = ref.Globals(*(torch.tensor(np.asarray(a, dtype=np.float64)) for a in arrays.glob))
    f, grads = ref.value_and_grad(torch.tensor(y), torch.tensor(arrays.lat.mu),
                                  torch.tensor(arrays.lat.u_s), g, worker.D,
                                  ref.effective_jitter(1e-6, torch.float64))
    for out in four_ranks:
        assert abs(out["f_ref"] - f) <= 1e-12 * abs(f)
        start, stop = out["rows"]
        for i, want in enumerate(grads):
            want = want.numpy()[start:stop] if i >= 4 else want.numpy()
            _close(out[f"grad_ref_{i}"], want, 1e-12, f"leaf {i}")


def test_each_rank_agrees_with_the_reference_over_ranks(four_ranks):
    """Each rank's bound, every leaf's gradient and a 2-iteration SCG call's
    change, against the reference summed over the ranks at the same points
    (the change: the reference's SCG replayed with the call's steps)."""
    for r, out in enumerate(four_ranks):
        assert abs(out["f"] - out["f_ref"]) <= 1e-12 * abs(out["f_ref"])
        assert abs(out["bound"] - out["bound_ref"]) <= 1e-12 * abs(out["bound_ref"])
        for i in range(6):
            _close(out[f"grad_{i}"], out[f"grad_ref_{i}"], 1e-9, f"rank {r} grad leaf {i}")
            _close(out[f"change_{i}"], out[f"change_ref_{i}"], 1e-9,
                   f"rank {r} change leaf {i}")


def test_the_driver_over_four_ranks_reads_its_checks_near_nought():
    """The cell's driver as the harness runs it, over four gloo ranks: a
    window of whole calls, N x evaluations / the window, and every check
    (the start's by its definition, the bound, the recovered gradient and a
    call's change against the reference summed over the ranks) at float64
    rounding."""
    out = _rank0(4, "run", 0.5)
    c = out["counters"]
    assert c["chips"] == 4 and c["n"] == 64 and out["failed"] == 0
    assert c["calls"] == out["attempted"] >= 1 and c["evals"] >= 2 * c["calls"]
    rate = out["end_to_end"]["fit_points_per_s"]
    assert abs(rate - 64 * c["evals"] / out["window_s"]) <= 1e-9 * rate
    assert set(out["checks"]) == {"start", "loss", "grad", "change"}
    for name, value in out["checks"].items():
        assert 0.0 <= value <= 1e-10, (name, value)


@pytest.mark.parametrize("fault", ["dropped_rank", "half"])
def test_faults_under_the_ranks_read_far_above_the_limits(fault):
    """A rank's statistics left out of the sum, and half the rows at weight
    2 on every rank, move the bound and the gradient by O(1e-2) or more:
    far above any limit of ``correct`` (at most 1e-5 in the fit cells)."""
    readings = _rank0(4, "readings", fault)["program"]
    assert readings["loss"] > 1e-3 and readings["grad"] > 1e-3, readings


@pytest.fixture(scope="module")
def two_rank_spans(tmp_path_factory):
    out = tmp_path_factory.mktemp("dp_spans")
    _ranks("spans", 2, out)
    return [json.loads((out / f"rank{r}.json").read_text()) for r in range(2)]


def test_collectives_open_spans_on_the_calling_thread(two_rank_spans):
    """Under a profiler, a two-rank fit's evaluations each record one
    ``gparml.allreduce.stats`` and one ``gparml.allreduce.grad`` span inside
    their ``gparml.eval``, and every reduction of an SCG scalar one
    ``gparml.allreduce.scalar`` span in the loop; all on the calling thread.
    With no profiler the fit enters none (the worker's second fit raises
    if it does)."""
    for out in two_rank_spans:
        names = [s["name"] for s in out["spans"]]
        assert names.count("gparml.allreduce.stats") == out["n_evals"]
        assert names.count("gparml.allreduce.grad") == out["n_evals"]
        assert names.count("gparml.allreduce.scalar") == out["reductions"] > 0
        assert all(s["same_thread"] for s in out["spans"])
        for s in out["spans"]:
            inside = ("gparml.eval",) if s["name"] != "gparml.allreduce.scalar" else (
                "gparml.fit", "gparml.scg.iteration")
            assert s["parent"] in inside, s


def test_mesh_counts_the_bytes_of_its_collectives(two_rank_spans):
    """``allreduce_bytes``: (M^2 + M D + 4) elements for a sum of the
    statistics; an evaluation adds the replicated leaves' gradients and the
    value (M Q + Q + 3 elements)."""
    m, d, q = worker.M, worker.D, worker.Q
    for out in two_rank_spans:
        size = out["element_size"]
        assert out["stats_bytes"] == (m * m + m * d + 4) * size
        assert out["eval_bytes"] == (m * m + m * d + 4 + m * q + q + 3) * size


MS = 1_000_000  # ns


def _window(with_collectives=True):
    """Two evaluations of a data-parallel SCG iteration on rank 0: each holds
    a 1 ms sum of the statistics and a 0.5 ms sum of the gradients; three
    scalar reductions of 0.25 ms follow; on the device 4 ms of kernels, 1 ms
    of NCCL's kernel and its 1 ms ``nccl:`` annotation, in a 20 ms window."""
    at = [("gparml.scg.iteration", 0, 19),
          ("gparml.eval", 1, 6), ("gparml.allreduce.stats", 2, 3),
          ("gparml.allreduce.grad", 4, 4.5),
          ("gparml.eval", 7, 12), ("gparml.allreduce.stats", 8, 9),
          ("gparml.allreduce.grad", 10, 10.5),
          ("gparml.allreduce.scalar", 13, 13.25), ("gparml.allreduce.scalar", 14, 14.25),
          ("gparml.allreduce.scalar", 15, 15.25)]
    host = [(n, round(s * MS), round(e * MS)) for n, s, e in at
            if with_collectives or not n.startswith("gparml.allreduce")]
    dev = [("gparml::psi_kernel", 1 * MS, 5 * MS, 0),
           ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
            5 * MS, 6 * MS, 0), ("nccl:all_reduce", 5 * MS, 6 * MS, 0)]
    return trace.Trace(0, 20 * MS, dev, host)


COUNTERS = {"evals": 2, "n": 1000, "m": 10, "q": 2, "d": 3, "chips": 4}
KNOWN = {"allreduce_ms.fit_dp": (2 * 1.5 + 3 * 0.25) / 2, "allreduces_per_eval.fit_dp": 7 / 2,
         "nccl_device_ms.fit_dp": 1.0 / 2, "device_idle.fit_dp": 100.0 * 15 / 20}


@pytest.mark.parametrize("name", sorted(KNOWN))
def test_fit_dp_reader_gives_the_known_value(name):
    r = harness.Reading(_window(), COUNTERS, "cpu")
    assert harness.metric_reader(name)(r) == pytest.approx(KNOWN[name], rel=1e-12)


def test_mfu_over_every_rank_card():
    """``mfu.fit_dp``: the evaluations' operations at the global N per
    second of the window, over the TF32 peak of all four cards."""
    from portbench.work import eval_ops

    r = harness.Reading(_window(), COUNTERS, "NVIDIA H100 80GB HBM3")
    rate = eval_ops(1000, 10, 2, 3) * 2 / 0.02
    want = 100.0 * rate / (4 * r.peaks["tf32_flops"])
    assert harness.metric_reader("mfu.fit_dp")(r) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", ["allreduce_ms.fit_dp", "allreduces_per_eval.fit_dp"])
def test_collective_readers_give_none_without_the_spans(name):
    """A program without the collectives' spans (the one before them) gives
    no reading, not a nought."""
    r = harness.Reading(_window(with_collectives=False), COUNTERS, "cpu")
    assert harness.metric_reader(name)(r) is None


def test_a_traced_run_over_two_ranks_reads_the_collectives():
    """The driver's traced window on rank 0 holds the program's spans of its
    collectives: every span metric of the cell reads a positive number."""
    out = _rank0(2, "traced", 0.3)
    m = out["metrics"]
    assert m["allreduce_ms.fit_dp"] > 0 and m["allreduces_per_eval.fit_dp"] >= 2
    assert 0.0 <= m["device_idle.fit_dp"] <= 100.0
