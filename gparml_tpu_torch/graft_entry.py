"""Entry points: one evaluation on the card, and dry runs of every
training mode over a data mesh and over processes.

Counterpart of the repository's ``__graft_entry__.py``, which stays the JAX
package's:

``entry()``                — (fn, args): fn(params, y) is one fused
                             bound+gradient evaluation of the GPLVM
                             (``gplvm.neg_bound_value_and_grad``) at N=2048,
                             Q=10, M=64, D=12 in float32, the unit of work
                             the reference called likelihood_and_gradient.
``dryrun_multichip(n)``    — one SCG step of the GPLVM over a data mesh of
                             n shards (Y and the latents split by rows, the
                             globals replicated, the statistics summed), then
                             one SGPR SCG iteration and one SVGP Adam step
                             over the same mesh.
``dryrun_multihost(n)``    — n processes of ``python -m
                             gparml_tpu_torch.cli -p remote`` joined in one
                             gloo group on localhost, one device each:
                             per-process partition reads, the fit over every
                             process, per-process embeddings files and the
                             coordinator's checkpoint.

Everything runs on ``cuda:0`` (``dryrun_multichip``: one card a shard where
n cards are visible, else n shards on ``cuda:0``) unless ``device="cpu"``
asks for the CPU; without a card the default raises.

    python -m gparml_tpu_torch.graft_entry [multichip [N] | multihost [N]] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from gparml_tpu_torch import checkpoint, data
from gparml_tpu_torch.models import gplvm, params as P, sgpr, svgp
from gparml_tpu_torch.parallel import mesh as mesh_lib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENTRY_SHAPE = (2048, 12, 10, 64)   # N, D, Q, M


def _device(device) -> torch.device:
    """cuda:0 unless the CPU is asked for by name; raises without a card."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to run on the CPU")
    return torch.device("cuda", 0) if device is None else torch.device(device)


def _make_gplvm(n, d, q, m, device, seed=0):
    """(config, params, Y): Y ~ N(0, 1) (N, D) from ``seed``, float32,
    PCA + farthest-point init."""
    rng = np.random.default_rng(seed)
    y = torch.tensor(rng.standard_normal((n, d)), dtype=torch.float32, device=device)
    cfg = gplvm.GPLVMConfig(q=q, num_inducing=m)
    p0 = gplvm.init_params(torch.Generator(device).manual_seed(seed), y, cfg)
    return cfg, p0, y


def entry(device=None):
    """(fn, (params, y)): fn is one bound+gradient evaluation of the GPLVM,
    (-bound, gradient leaves in ``named_parameters`` order). On the card
    the statistics run through the CUDA kernels (``stats_impl='auto'``)."""
    n, d, q, m = ENTRY_SHAPE
    cfg, p0, y = _make_gplvm(n, d, q, m, _device(device))

    def fn(params, y):
        return gplvm.neg_bound_value_and_grad(params, y, cfg)

    return fn, (p0, y)


def _mesh(n_devices: int, device) -> mesh_lib.Mesh:
    dev = _device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= n_devices:
        return mesh_lib.make_mesh(n_devices)
    return mesh_lib.Mesh([dev] * n_devices)


def _finite(value: float, what: str) -> float:
    if not math.isfinite(value):
        raise RuntimeError(f"non-finite {what}: {value}")
    return value


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """One SCG step of the GPLVM over a data mesh of ``n_devices`` shards
    at N = 8 n_devices, D=4, Q=2, M=6 (Y and the (N, Q) latent leaves split
    by rows, Z and the hypers replicated, the statistics summed over the
    shards), then SGPR and SVGP over the same mesh. Returns the three
    objectives."""
    mesh = _mesh(n_devices, device)
    n, d, q, m = 8 * n_devices, 4, 2, 6
    cfg, p0, y = _make_gplvm(n, d, q, m, mesh.home, seed=1)
    y_s, mu_s, us_s, w = mesh_lib.shard_data(mesh, y, p0.lat.mu.detach(), p0.lat.u_s.detach())
    glob = mesh_lib.replicated(mesh, p0.glob)
    p = P.GPLVMParams(glob=glob, lat=P.LatentParams(mu_s.gather(), us_s.gather()))
    res = gplvm.fit(p, y_s, cfg, iters=1, mesh=mesh, weights=w)
    out = {"gplvm": _finite(float(res.bound), "GPLVM objective")}
    print(f"dryrun_multichip({n_devices}): OK, objective={-out['gplvm']:.4f}")
    out["sgpr"] = _dryrun_sgpr(mesh, n_devices)
    out["svgp"] = _dryrun_svgp(mesh, n_devices)
    return out


def _dryrun_sgpr(mesh: mesh_lib.Mesh, n_devices: int) -> float:
    """One SGPR SCG iteration (the fixed-embeddings mode) over the mesh:
    observed X and Y split by rows, the globals replicated."""
    rng = np.random.default_rng(2)
    n = 8 * n_devices
    x_np = rng.uniform(-2, 2, (n, 2))
    y_np = np.sin(x_np @ np.array([[1.0], [0.5]])) + 0.1 * rng.standard_normal((n, 1))
    cfg = sgpr.SGPRConfig(num_inducing=6)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=mesh.home)
    g0 = sgpr.init_params(torch.Generator(mesh.home).manual_seed(2), t(x_np), t(y_np), cfg)
    ys, xs, w = mesh_lib.shard_data(mesh, y_np, x_np, dtype=torch.float32)
    res = sgpr.fit(g0, xs, ys, cfg, iters=1, mesh=mesh, weights=w)
    f = _finite(float(res.bound), "SGPR objective")
    print(f"dryrun_multichip({n_devices}) sgpr: OK, bound={f:.4f}")
    return f


def _dryrun_svgp(mesh: mesh_lib.Mesh, n_devices: int) -> float:
    """One SVGP minibatch Adam step over the mesh: a window of rows a
    shard, the ELBO's data term summed over the shards."""
    rng = np.random.default_rng(3)
    n = 8 * n_devices
    x_np = rng.uniform(-2, 2, (n, 1))
    y_np = np.sin(2 * x_np) + 0.1 * rng.standard_normal((n, 1))
    cfg = svgp.SVGPConfig(num_inducing=6, batch_size=max(8, n // 2))
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=mesh.home)
    p0 = svgp.init_params(torch.Generator(mesh.home).manual_seed(3), t(x_np), t(y_np), cfg)
    ys, xs, w = mesh_lib.shard_data(mesh, y_np, x_np, dtype=torch.float32)
    res = svgp.fit(p0, xs, ys, cfg, steps=1, learning_rate=1e-2, mesh=mesh, weights=w)
    f = _finite(float(res.elbo), "SVGP elbo")
    print(f"dryrun_multichip({n_devices}) svgp: OK, elbo={f:.4f}")
    return f


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(args, n_ranks: int, work: Optional[str] = None, tag: str = "rank",
              timeout: float = 900.0, env: Optional[dict] = None) -> list:
    """``python *args`` as ``n_ranks`` ranks of a new process group on
    localhost, with torchrun's variables (the rendezvous port bound to 0 and
    read back) and ``env`` on top; rank r logs to ``work/<tag>.rank<r>.log``
    (default ``work``: a temporary directory). When a rank fails or
    ``timeout`` passes, every other rank is killed (a rank left in a
    collective would wait for good) and RuntimeError carries the logs'
    tails. Returns the ranks' outputs."""
    if work is None:
        with tempfile.TemporaryDirectory(prefix="gparml_torch_ranks_") as tmp:
            return run_ranks(args, n_ranks, tmp, tag, timeout, env)
    port = str(_free_port())
    procs, logs = [], []
    for rank in range(n_ranks):
        rank_env = dict(os.environ, PYTHONPATH=ROOT, MASTER_ADDR="localhost", MASTER_PORT=port,
                        WORLD_SIZE=str(n_ranks), RANK=str(rank), LOCAL_RANK=str(rank),
                        LOCAL_WORLD_SIZE=str(n_ranks), **(env or {}))
        logs.append(os.path.join(work, f"{tag}.rank{rank}.log"))
        with open(logs[-1], "w") as log:
            procs.append(subprocess.Popen([sys.executable, *map(str, args)], stdout=log,
                                          stderr=subprocess.STDOUT, env=rank_env, cwd=ROOT))
    deadline = time.monotonic() + timeout
    failed = None
    while failed is None and any(p.poll() is None for p in procs):
        failed = next((r for r, p in enumerate(procs) if p.poll() not in (None, 0)), None)
        if time.monotonic() > deadline:
            failed = "timeout"
        time.sleep(0.1)
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
    outs = []
    for log in logs:
        with open(log, errors="replace") as f:
            outs.append(f.read())
    if failed is None:
        failed = next((r for r, p in enumerate(procs) if p.returncode != 0), None)
    if failed is not None:
        what = f"timed out after {timeout:.0f} s" if failed == "timeout" else f"rank {failed} failed"
        tails = "\n".join(f"--- rank {r} (rc={p.returncode}):\n{out[-4000:]}"
                          for r, (p, out) in enumerate(zip(procs, outs)))
        raise RuntimeError(f"{tag}: {what}\n{tails}")
    return outs


def dryrun_multihost(n_processes: int = 2, devices_per_process: int = 1, device=None,
                     work: Optional[str] = None, timeout: float = 900.0) -> dict:
    """The remote (multi-host) path end to end: ``n_processes`` OS
    processes of ``python -m gparml_tpu_torch.cli -p remote`` joined in one
    gloo group on localhost, each with one device (the CLI's remote mode
    gives a rank one card; a host with several runs one rank a card), fit a
    GPLVM (-T 2, Q=2, M=6) on N = 8 n rows of ``data.synthetic_gplvm``
    written as one partition a process. Checks the summary's device count
    and finite bound, every process's embeddings partition and the
    coordinator's checkpoint. Each rank is killed when a sibling fails or
    ``timeout`` passes. The folders go to ``work`` (default: a temporary
    directory, removed afterwards); returns the coordinator's summary."""
    if devices_per_process != 1:
        raise ValueError(f"devices_per_process={devices_per_process}: a -p remote rank has "
                         "one device; run one process per card instead")
    kind = _device(device).type
    if work is not None:
        return _multihost(n_processes, kind, work, timeout)
    with tempfile.TemporaryDirectory(prefix="gparml_torch_multihost_") as tmp:
        return _multihost(n_processes, kind, tmp, timeout)


def _multihost(n_processes, kind, work, timeout) -> dict:
    n = 8 * n_processes
    y, _ = data.synthetic_gplvm(n=n, d=4, q_true=2, seed=3)
    folders = {k: os.path.join(work, k) for k in ("inputs", "emb", "stats")}
    data.save_partitioned(folders["inputs"], y, n_processes, prefix="Y")
    run_ranks(["-m", "gparml_tpu_torch.cli", "-i", folders["inputs"], "-e", folders["emb"],
               "-s", folders["stats"], "-p", "remote", "-T", "2", "-q", "2", "-m", "6",
               "--device", kind], n_processes, work, "dryrun_multihost", timeout,
              env={"OMP_NUM_THREADS": "1"})

    with open(os.path.join(folders["stats"], "summary.json")) as f:
        summary = json.load(f)
    problems = []
    if summary["devices"] != n_processes:
        problems.append(f"summary counts {summary['devices']} devices, expected "
                        f"{n_processes}")
    if not math.isfinite(summary["final_bound"]):
        problems.append(f"non-finite bound {summary['final_bound']}")
    per = n // n_processes
    for rank in range(n_processes):
        for prefix in ("X_mu", "X_S"):
            path = os.path.join(folders["emb"], f"{prefix}_{rank}.npy")
            part = np.load(path) if os.path.exists(path) else None
            if part is None or part.shape != (per, 2) or not np.all(np.isfinite(part)):
                problems.append(f"rank {rank}'s {prefix} partition: "
                                f"{None if part is None else part.shape}, expected ({per}, 2)")
    ckpt = os.path.join(folders["stats"], "checkpoint.npz")
    if not os.path.exists(ckpt):
        problems.append("no checkpoint from the coordinator")
    else:
        glob, _ = checkpoint.load(ckpt, P.make_global(np.zeros((6, 2)), 1.0, np.ones(2), 1.0))
        if not all(bool(torch.all(torch.isfinite(t))) for t in P.leaves(glob)):
            problems.append("non-finite globals in the checkpoint")
    if problems:
        raise RuntimeError(f"dryrun_multihost({n_processes}): "
                           + "; ".join(problems))
    print(f"dryrun_multihost({n_processes}): OK, "
          f"bound={summary['final_bound']:.4f}")
    return summary


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("command", nargs="?", default="entry",
                    choices=["entry", "multichip", "multihost"])
    ap.add_argument("counts", nargs="*", type=int,
                    help="multichip: shards (8); multihost: processes (2)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    device = "cpu" if args.device == "cpu" else None
    if args.command == "multichip":
        dryrun_multichip(*(args.counts or [8]), device=device)
    elif args.command == "multihost":
        dryrun_multihost(*args.counts, device=device)
    else:
        fn, fn_args = entry(device)
        out = fn(*fn_args)
        print("entry(): OK, -bound =", float(out[0]))


if __name__ == "__main__":
    main()
