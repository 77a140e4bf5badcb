"""Traffic kind ``fit_dp``: ``fit``'s closed-loop SCG training, data parallel
over the configuration's ``chips`` ranks of one ``torch.distributed`` process
group, one card a rank (nccl; gloo on the CPU, where the tests drive it).

The harness's process is rank 0, on the cell's first card. It loads (or
builds) the kernels' library, then starts ranks 1.. as processes of
``python -m portbench.drive.fit_dp SPEC`` on the cards of their rank, with
torchrun's variables and one rendezvous on localhost (``Ranks``). Each rank
takes its share of the host's CPU threads. When a rank fails, or the run
outlasts its deadline, every rank is killed; a rank also dies with rank 0.

Set-up, on every rank: the same global Y from the seed (the data that
``config5`` makes, ``common.observations``), of which the rank keeps its
contiguous block of N / chips rows (``distributed.process_row_range``).
The start is the one the CLI's ``-p remote`` makes: each rank's latents are
the principal components of its own rows, the global leaves rank 0's
(``distributed.broadcast_pytree``). Then ``fit``'s first steps, in lockstep
through ``gplvm.fit`` under the process group's mesh: a one-iteration call
and one of ``iters_per_call``, which also warm every shape. The window runs
calls of ``iters_per_call`` iterations, each from the last one's
parameters; after each, the ranks synchronize their cards and agree on
whether to go on (``agree``), and the window closes at the end of the first
call that ends after ``--seconds``. The window is rank 0's ``trace.Window``
over its own card, traced there alone; the ranks agree before it opens and
before it closes, so it times the work of every card.

End to end: ``fit_points_per_s`` = N (global) x the evaluations completed
(``FitResult.n_evals``, the same on every rank) / the window's wall time;
``peak_mem_gib``, the largest of the ranks' allocator peaks from the
rank's rows on (``rank_rows``).

Correctness, after the window with the peaks read and the program's state
freed: ``fit``'s ``loss``, ``grad`` and ``change`` against the reference
summed over the ranks (``reference/gplvm_dp.py``), the gradients' and
changes' norms taken over every leaf, the global leaves once and the
latents of every rank; and ``start``, the start judged by its definition
under ranks (``gplvm_dp.start_gap``). Every rank computes them; rank 0's are
the run's.
"""

from __future__ import annotations

import importlib
import json
import math
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from portbench import trace
from portbench.drive import common, fit
from portbench.reference import gplvm as ref
from portbench.reference import gplvm_dp as ref_dp
from portbench.reference import init as ref_init

ROOT = Path(__file__).resolve().parents[2]
# seconds a run may take past its window before every rank is killed
DEADLINE_S = 900.0
# the environment variable that gives a rank rank 0's process id
PARENT = "PORTBENCH_RANK0_PID"
# the program's spans of its collectives over the ranks (metrics/*.fit_dp.py)
ALLREDUCE_SPANS = ("gparml.allreduce.stats", "gparml.allreduce.grad", "gparml.allreduce.scalar")


def cpu_share(ranks: int) -> int:
    """This host's CPU threads over the ranks: four processes that each
    use every core would compete for them."""
    cores = len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") else os.cpu_count()
    return max(1, (cores or 1) // ranks)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _join(rank: int, ranks: int, port: int, device: torch.device) -> None:
    from gparml_tpu_torch.parallel import distributed

    distributed.initialize(f"localhost:{port}", ranks, rank,
                           backend="nccl" if device.type == "cuda" else "gloo",
                           device_type=device.type)


def _leave() -> None:
    from gparml_tpu_torch.parallel import distributed

    distributed.shutdown()


class Ranks:
    """``with Ranks(spec, device, deadline_s) as r:``: this process as rank 0
    of ``spec["config"]["chips"]`` ranks on ``device`` (``r.device``), the
    others started as processes that run ``spec["entry"]`` (``module:function``,
    called with the spec and the rank's device). At a clean end of the block
    every rank must exit 0; a rank that fails, or ranks past ``deadline_s``
    seconds, end this process with exit code 1 after the others are killed."""

    def __init__(self, spec: dict, device: torch.device, deadline_s: float):
        self.device = torch.device(device)
        self.spec = dict(spec, device_type=self.device.type)
        self.ranks = int(spec["config"]["chips"])
        self.deadline = time.monotonic() + deadline_s
        self.procs, self.logs = [], []
        self._done = threading.Event()

    def __enter__(self):
        torch.set_num_threads(cpu_share(self.ranks))
        if self.device.type == "cuda":
            from gparml_tpu_torch.ops import _build

            _build.load()   # built once, before the other ranks load it
        port = _free_port()
        self._dir = tempfile.TemporaryDirectory(prefix="portbench_ranks_")
        for rank in range(1, self.ranks):
            env = dict(os.environ, PYTHONPATH=str(ROOT), MASTER_ADDR="localhost",
                       MASTER_PORT=str(port), WORLD_SIZE=str(self.ranks), RANK=str(rank),
                       LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(self.ranks),
                       OMP_NUM_THREADS=str(cpu_share(self.ranks)), **{PARENT: str(os.getpid())})
            self.logs.append(os.path.join(self._dir.name, f"rank{rank}.log"))
            with open(self.logs[-1], "w") as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-m", "portbench.drive.fit_dp", json.dumps(self.spec)],
                    stdout=log, stderr=subprocess.STDOUT, env=env, cwd=str(ROOT)))
        threading.Thread(target=self._watch, daemon=True).start()
        _join(0, self.ranks, port, self.device)
        return self

    def _tails(self) -> str:
        out = []
        for rank, (p, log) in enumerate(zip(self.procs, self.logs), start=1):
            with open(log, errors="replace") as f:
                out.append(f"--- rank {rank} (rc={p.poll()}):\n{f.read()[-4000:]}")
        return "\n".join(out)

    def _kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait()

    def _watch(self) -> None:
        """Ends this process when a rank fails or the deadline passes (a rank
        left in a collective would wait for good)."""
        while not self._done.wait(0.2):
            failed = [r for r, p in enumerate(self.procs, start=1) if p.poll() not in (None, 0)]
            late = time.monotonic() > self.deadline
            if failed or late:
                self._kill()
                what = "past the deadline" if late else f"rank {failed[0]} failed"
                print(f"portbench: fit_dp {what}\n{self._tails()}", file=sys.stderr, flush=True)
                os._exit(1)

    def __exit__(self, exc_type, *exc):
        try:
            if exc_type is None:
                _leave()
                for p in self.procs:
                    p.wait(timeout=max(1.0, self.deadline - time.monotonic()))
                if any(p.returncode != 0 for p in self.procs):
                    raise RuntimeError(f"a rank exited with an error\n{self._tails()}")
        finally:
            self._done.set()
            self._kill()
            self._dir.cleanup()
        return False


def agree(device: torch.device, stop: bool = False) -> bool:
    """Every rank's card synchronized, then one all_reduce of the ranks'
    votes: True when any rank asks to stop."""
    common.sync(device)
    flag = torch.tensor([float(stop)], device=device)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
    return bool(flag.item())


def rank_rows(cfg: dict, seed: int, device: torch.device) -> torch.Tensor:
    """This rank's contiguous block of the global Y, (rows, D). The draw of
    the whole Y is the benchmark's way to make the data, not the program's
    memory (a deployment loads its own rows): the card's peak is counted
    from here on."""
    from gparml_tpu_torch.parallel import distributed

    y, _ = common.observations(cfg, seed, device)
    start, stop, _ = distributed.process_row_range(cfg["n"])
    rows = y[start:min(stop, cfg["n"])].clone()
    del y
    common.free_device()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    return rows


def first_steps(cfg: dict, mix: dict, seed: int, device: torch.device) -> dict:
    """Set-up on this rank: its rows, the start and the first steps (see the
    module text)."""
    from gparml_tpu_torch.models import gplvm, params as P
    from gparml_tpu_torch.parallel import distributed

    gcfg = common.gplvm_config(cfg)
    mesh = distributed.global_mesh(device)
    y = rank_rows(cfg, seed, device)
    p = gplvm.init_params(common.init_generator(seed, device), y, gcfg)
    glob = distributed.broadcast_pytree([t.detach().cpu().numpy() for t in p.glob.parameters()])
    p = P.GPLVMParams(P.from_leaves([torch.tensor(a, device=device) for a in glob]), p.lat)
    steps, reported = [common.host_leaves(p)], []
    for iters in (1, mix["iters_per_call"]):
        res = gplvm.fit(p, y, gcfg, iters=iters, mesh=mesh)
        p = res.params
        steps.append(common.host_leaves(p))
        reported.append(float(res.bound))
        if iters == 1:
            alpha = float(res.trace["alpha"][0]) if bool(res.trace["accepted"][0]) else 0.0
    common.sync(device)
    ran = np.isfinite(res.trace["alpha"])
    return {"gcfg": gcfg, "mesh": mesh, "y": y, "p": p, "steps": steps, "reported": reported,
            "alpha": alpha, "alphas": res.trace["alpha"][ran].tolist(),
            "accepted": res.trace["accepted"][ran].tolist()}


def fit_rank(spec: dict, device: torch.device, traced: bool = False, since_start=None) -> dict:
    """One rank's run: set-up, the window, the checks; the run's outcome as
    ``fit.run`` gives it (rank 0's is the result)."""
    from gparml_tpu_torch.models import gplvm

    cfg, mix = spec["config"], spec["mix"]
    st = first_steps(cfg, mix, spec["seed"], device)
    gcfg, mesh, y, p = (st.pop(k) for k in ("gcfg", "mesh", "y", "p"))
    agree(device)
    setup_s = since_start() if since_start is not None else 0.0
    vote = dist.get_rank() == 0
    calls = evals = failed = 0
    with trace.Window([device], traced) as w:
        while True:
            res = gplvm.fit(p, y, gcfg, iters=mix["iters_per_call"], mesh=mesh)
            p = res.params
            calls += 1
            evals += int(res.n_evals)
            failed += not math.isfinite(float(res.bound))
            if agree(device, vote and w.elapsed() >= spec["seconds"]):
                break
    peak = int(ref_dp.max_over_ranks(common.peak_bytes(device)))
    del p, res, mesh
    common.free_device()

    t_ref = time.perf_counter()
    checks = reference_checks(cfg, device, y, **st)[0]
    t_ref = time.perf_counter() - t_ref
    n = cfg["n"]
    return {
        "setup_s": setup_s,
        "end_to_end": {"fit_points_per_s": n * evals / w.seconds, "peak_mem_gib": peak / 2 ** 30},
        "memory_peak_bytes": peak,
        "attempted": calls, "failed": failed, "checks": checks, "window": w,
        "reference_s": t_ref,
        "counters": {"evals": evals, "calls": calls, "n": n, "m": cfg["m"], "q": cfg["q"],
                     "d": cfg["d"], "chips": cfg["chips"]},
    }


def start_gap(rm: common.RefModel, leaves0, control: bool = False) -> float:
    """The start's gap over the ranks (``gplvm_dp.start_gap``); ``control``
    replaces this rank's latents by the reference's own principal
    components in float32 with TF32 products."""
    g, mu, u_s = rm.split(leaves0)
    if control:
        ref.set_precision(True)
        mu = ref_init.pca(rm.y.float(), rm.cfg["q"]).double()
        ref.set_precision(False)
    return ref_dp.start_gap(rm.y, mu, u_s, g, rm.cfg["s0"])


def reference_checks(cfg: dict, device, y, steps, reported, alpha, alphas, accepted,
                     control: bool = False):
    """``fit.reference_checks`` over the ranks (see the module text): every
    rank calls it with its own rows and steps and gets the same numbers."""
    rm = common.RefModel(cfg, y, device)
    model = (rm.d, rm.jitter, rm.psi2_eps)

    def readings(dtype):
        yr = rm.y.to(dtype)

        def vg(x):
            return ref_dp.value_and_grad(yr, x[4], x[5], ref.Globals(*x[:4]), *model)

        x0, x1, x2 = (fit._leaves(rm, s, dtype) for s in steps)
        g0 = vg(x0)[1]
        f1, g1 = vg(x1)
        bounds = [-f1, ref_dp.value(yr, x2[4], x2[5], ref.Globals(*x2[:4]), *model)]
        change = fit._diff(ref_dp.replay(vg, x1, alphas, accepted, g0=g1), x1)
        return g0, bounds, change

    ref.set_precision(False)
    grad64, bounds64, change64 = readings(torch.float64)
    got = fit.recovered_gradient(steps[0], steps[1], alpha, device)
    x1, x2 = (fit._leaves(rm, s, torch.float64) for s in steps[1:])
    prog = {"start": start_gap(rm, steps[0]), "grad": ref_dp.leaf_gaps(got, grad64),
            "loss": max(ref.rel_gap(a, b) for a, b in zip(reported, bounds64)),
            "change": ref_dp.leaf_gaps(fit._diff(x2, x1), change64)}
    if not control:
        return prog, None
    del got, x1, x2
    ref.set_precision(True)
    grad32, bounds32, change32 = readings(torch.float32)
    ref.set_precision(False)
    ctrl = {"start": start_gap(rm, steps[0], control=True),
            "grad": ref_dp.leaf_gaps(grad32, grad64),
            "loss": max(ref.rel_gap(a, b) for a, b in zip(bounds32, bounds64)),
            "change": ref_dp.leaf_gaps(change32, change64)}
    return prog, ctrl


def run(ctx) -> dict:
    spec = {"entry": "portbench.drive.fit_dp:fit_rank", "config": ctx.config, "mix": ctx.mix,
            "seed": ctx.seed, "seconds": ctx.seconds}
    with Ranks(spec, ctx.devices[0], DEADLINE_S + 3 * ctx.seconds) as ranks:
        return fit_rank(spec, ranks.device, ctx.traced, ctx.since_start)


def _die_with_rank0() -> None:
    """Have the kernel kill this rank when rank 0's process ends."""
    try:
        import ctypes

        ctypes.CDLL(None).prctl(1, signal.SIGKILL)   # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass
    if os.getppid() != int(os.environ[PARENT]):
        os._exit(1)


def main(argv) -> int:
    """A rank other than 0 (``Ranks`` starts it)."""
    _die_with_rank0()
    spec = json.loads(argv[0])
    rank, ranks = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    torch.set_num_threads(cpu_share(ranks))
    device = torch.device("cuda", rank) if spec["device_type"] == "cuda" else torch.device("cpu")
    _join(rank, ranks, int(os.environ["MASTER_PORT"]), device)
    module, name = spec["entry"].split(":")
    getattr(importlib.import_module(module), name)(spec, device)
    _leave()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
