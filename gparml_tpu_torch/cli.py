"""Command-line interface: the GPLVM and sparse GP regression modes of
``gparml_tpu/cli.py`` on NVIDIA GPUs.

The same option surface and folder workflow as the JAX package's CLI, the
re-design of GParML's ``parallel_GPLVM.py``: per-partition ``Y_<i>.npy``
inputs, embedding init (PCA, random, or ``--load`` from the embeddings
folder and ``checkpoint.npz``), a joint fit of latents, inducing points and
hypers with SCG, Adam or GD, and the results written back: embeddings
partition files, ``bound_history.jsonl``, ``checkpoint.npz`` and
``summary.json``. With ``--fixed-embeddings`` the embeddings folder holds
observed inputs X (its ``X_mu_<i>.npy``, one row per row of Y) and the run
fits sparse GP regression (``models/sgpr.py``): Z and the hypers only,
``--load`` resuming from ``checkpoint.npz``, the summary's ``mode`` "sgpr";
with ``--optimizer svgp`` as well, the uncollapsed SVGP by minibatch Adam
(``models/svgp.py``: ``--batch-size``, ``--learning-rate``; Z, the hypers
and q(u); ``elbo_history.jsonl``, the summary's ``mode`` "svgp" with the
final ELBO's estimator, ``final_elbo_exact`` and ``final_elbo_n``).
Either package resumes from the other's folders.

  -i/--input         folder of per-partition Y_<i>.npy files
  -e/--embeddings    folder for X_mu_<i>.npy / X_S_<i>.npy
  -p/--parallel      local (this process's cards) | remote (a process group)
  -T/--iterations    optimizer iterations
  -q/--latent-dim    latent dimensionality Q
  -m/--num-inducing  inducing point count M
  -s/--statistics    output folder for history/checkpoint/summary
  --device           cuda (cuda:0, the default) or cpu

The fit runs on ``cuda:0`` through the hand-written CUDA kernels
(``--stats-impl auto``) unless ``--device cpu`` is given, which stands in
for the JAX package's ``JAX_PLATFORMS``; without a card ``--device cuda``
raises. With ``-p local`` and more than one visible card the (N, Q)
layout's statistics run over a mesh of every card (``parallel/mesh.py``),
N padded with weight-0 rows; the checkpoint holds the unpadded latents.
``-p remote`` runs one process per rank of a ``torch.distributed`` group,
from MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK / LOCAL_RANK as
``torchrun`` sets them (``parallel/distributed.py``; its backend is
``nccl`` where each rank has a card of its own, ``gloo`` on the CPU or
where ranks share a card): each process reads only its own block of rows,
initialises from it (SGPR's globals and SVGP's parameters from a sample of
every process's rows), takes the coordinator's globals, fits, writes its own
embeddings partition file, and the coordinator writes a checkpoint of the
globals only (SVGP: its parameters); after the fit every process checks that
it holds the coordinator's globals (SVGP: glob, q_mu and q_sqrt) bit for
bit. ``--load`` resumes either mode, also from the other's folders. The kernels take float32: ``--dtype float64`` on
the card needs ``--stats-impl xla``. A checkpoint's leaves are cast to
``--dtype``. ``--compile-cache`` and ``--scg-mode`` are accepted and do
nothing (XLA compile caching and the TPU's fused SCG program have no
counterpart).

Run ``python -m gparml_tpu_torch.cli --help`` for the full surface.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gparml_tpu_torch",
        description="Bayesian GPLVM trainer on NVIDIA GPUs (PyTorch + CUDA)",
    )
    p.add_argument("-i", "--input", required=True, help="folder of Y_<i>.npy partitions")
    p.add_argument("-e", "--embeddings", required=True, help="embeddings folder")
    p.add_argument("-p", "--parallel", choices=["local", "remote"], default="local",
                   help="local: this process's cards (a mesh over all of them "
                        "when there are several); remote: one process per rank "
                        "of a torch.distributed group (torchrun's variables)")
    p.add_argument("-T", "--iterations", type=int, default=100)
    p.add_argument("-q", "--latent-dim", type=int, default=2, dest="q")
    p.add_argument("-m", "--num-inducing", type=int, default=10, dest="m")
    p.add_argument("-s", "--statistics", default=None, help="output folder for logs/checkpoints")
    p.add_argument("--fixed-embeddings", action="store_true",
                   help="treat embeddings as observed inputs (sparse GP "
                        "regression mode)")
    p.add_argument("--fixed-beta", action="store_true", help="do not optimize noise precision")
    p.add_argument("--init", choices=["pca", "random"], default="pca")
    p.add_argument("--load", action="store_true",
                   help="resume: load existing embeddings (and checkpoint if present)")
    p.add_argument("--optimizer", choices=["scg", "adam", "gd", "svgp"], default="scg",
                   help="svgp: minibatch SVGP (with --fixed-embeddings)")
    p.add_argument("--xtol", type=float, default=1e-8,
                   help="SCG: min relative step size before convergence")
    p.add_argument("--ftol", type=float, default=1e-8,
                   help="SCG: min relative objective change before convergence")
    p.add_argument("--gtol", type=float, default=1e-10,
                   help="SCG: squared gradient norm convergence threshold")
    p.add_argument("--sigma0", type=float, default=1e-4,
                   help="SCG: finite-difference curvature probe scale")
    p.add_argument("--batch-size", type=int, default=4096,
                   help="minibatch size for --fixed-embeddings --optimizer svgp mode")
    p.add_argument("--learning-rate", type=float, default=1e-2)
    p.add_argument("--stats-impl", choices=["auto", "xla", "pallas"], default="auto",
                   help="psi engine: pallas = the CUDA kernels, xla = the plain "
                        "PyTorch engine, auto = the kernels on the card and the "
                        "plain engine on the CPU")
    p.add_argument("--layout", choices=["nq", "qn"], default="nq",
                   help="storage layout of N-sized arrays: qn stores (Q, N) "
                        "latents and (D, N) observations")
    p.add_argument("--block", type=int, default=None,
                   help="N-block size of the plain engine (a divisor of N)")
    p.add_argument("--scg-mode", choices=["auto", "fused", "stepped"],
                   default="auto", dest="scg_mode",
                   help="no-op: the SCG loop always runs on the host")
    p.add_argument("--dtype", choices=["float32", "float64"], default="float32")
    p.add_argument("--bijector", choices=["exp", "softplus"], default="exp")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--display", action="store_true", help="per-iteration optimizer prints")
    p.add_argument("--trace-timing", action="store_true",
                   help="record real per-iteration wall times (history rows "
                        "gain a wall_s column)")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="write a torch.profiler trace of the fit to DIR/trace.json")
    p.add_argument("--compile-cache", metavar="DIR", default="auto",
                   help="no-op: the JAX package's XLA compile cache")
    p.add_argument("--save-partitions", type=int, default=None,
                   help="partition count for saved embeddings (default: match input)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the fit runs: cuda:0 (raises without a card) or "
                        "the CPU")
    return p


def _device(options):
    """cuda:0, or under -p remote this rank's card; or the CPU."""
    import torch

    from gparml_tpu_torch.parallel import distributed

    if getattr(options, "device", "cuda") == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device; pass --device cpu to run on the CPU")
    if options.parallel == "remote":
        return distributed.local_device("cuda")
    return torch.device("cuda", 0)


def _local_mesh(device, layout):
    """-p local: a mesh over every visible card when there is more than
    one (the (N, Q) layout; qn is the single-device layout), else none."""
    import torch

    from gparml_tpu_torch.parallel import mesh as mesh_lib

    if device.type == "cuda" and layout == "nq" and torch.cuda.device_count() > 1:
        return mesh_lib.make_mesh()
    return None


def _check_replicas(params, mesh) -> dict:
    """Under a process group: print this rank's digest of the replicated
    parameters (the globals; SVGP's glob, q_mu and q_sqrt), and raise unless
    every rank holds the coordinator's bits. Returns the summary's entries,
    with the mean time of the sums' all_reduce."""
    from gparml_tpu_torch.models import params as P
    from gparml_tpu_torch.parallel import distributed

    if not distributed.spans_processes(mesh):
        return {}
    leaves = P.leaves(params)
    digest = hashlib.sha256(b"".join(t.cpu().numpy().tobytes() for t in leaves)).hexdigest()
    print(f"rank {distributed.process_index()} globals sha256 {digest}", flush=True)
    if not distributed.replicas_agree(leaves, mesh):
        raise RuntimeError("the replicated globals differ across processes after the fit")
    return {"processes": distributed.process_count(),
            "backend": distributed.backend_name(), "globals_agree": True,
            "stats_allreduce_ms": round(
                mesh.allreduce_seconds / max(mesh.allreduces, 1) * 1e3, 4)}


def _place(options, mesh, n, params, dtype, rebuild, *rows):
    """Under a mesh: the replicated parameters (under -p remote, the
    coordinator's, rebuilt from their leaves by ``rebuild``), and the
    N-sized arrays ``rows`` padded and sharded. Returns (parameters,
    sharded arrays..., weights)."""
    import torch

    from gparml_tpu_torch.parallel import distributed
    from gparml_tpu_torch.parallel import mesh as mesh_lib

    if options.parallel == "remote":
        leaves = distributed.broadcast_pytree([t.detach().cpu().numpy()
                                               for t in params.parameters()])
        params = rebuild([torch.tensor(a, device=mesh.home, dtype=dtype) for a in leaves])
        return (params, *distributed.shard_data_multihost(mesh, n, *rows))
    return (mesh_lib.replicated(mesh, params), *mesh_lib.shard_data(mesh, *rows))


def _scg_options(options):
    """SCGOptions from the option namespace (tolerances optional so run()
    accepts any object with just the core attributes)."""
    from gparml_tpu_torch.opt import scg

    defaults = scg.SCGOptions()
    return scg.SCGOptions(
        max_iters=options.iterations,
        display=options.display,
        xtol=getattr(options, "xtol", defaults.xtol),
        ftol=getattr(options, "ftol", defaults.ftol),
        gtol=getattr(options, "gtol", defaults.gtol),
        sigma0=getattr(options, "sigma0", defaults.sigma0),
        trace_timing=getattr(options, "trace_timing", False),
    )


def _maybe_iter_timer(options):
    """iteration_timer context when --trace-timing is set, else a no-op."""
    if getattr(options, "trace_timing", False):
        from gparml_tpu_torch.utils import logging as glog

        return glog.iteration_timer()
    return contextlib.nullcontext()


def _maybe_profile(options):
    """torch.profiler trace context when --profile DIR is set, else a no-op."""
    log_dir = getattr(options, "profile", None)
    if log_dir:
        from gparml_tpu_torch.utils import logging as glog

        return glog.trace(log_dir)
    return contextlib.nullcontext()


def _history_with_wall(result, it_timer, iters: int):
    """History columns for write_history, plus a real wall_s column when
    --trace-timing collected stamps."""
    hist = result.trace if result.trace is not None else result.history
    ws = it_timer.wall_seconds() if hasattr(it_timer, "wall_seconds") else {}
    if not ws:
        return hist
    hist = dict(hist) if isinstance(hist, dict) else {"bound": hist}
    wall = np.full(int(iters), np.nan)
    for i, dt in ws.items():
        if 0 <= i < iters:
            wall[i] = dt
    hist["wall_s"] = np.round(wall, 6)
    return hist


def _iter_wall_extra(fit_seconds: float, history) -> dict:
    """The uniform average wall time over executed iterations."""
    n_iter = int(np.isfinite(np.asarray(history)).sum())
    return {"avg_iter_wall_s": round(fit_seconds / max(n_iter, 1), 6)}


def run(options) -> dict:
    """Execute a full training run; returns a summary dict (also written to
    the statistics folder by the coordinator). ``options`` is the parsed
    argparse namespace (or anything with the same attributes)."""
    import torch

    from gparml_tpu_torch import checkpoint, data
    from gparml_tpu_torch.models import gplvm, params as P
    from gparml_tpu_torch.ops import psi_cuda
    from gparml_tpu_torch.parallel import distributed
    from gparml_tpu_torch.utils import init as init_utils
    from gparml_tpu_torch.utils import logging as glog

    t_start = time.perf_counter()
    layout = getattr(options, "layout", "nq")
    # remote: every process runs this same program on its own contiguous
    # block of rows (the reference's per-partition workers); the data set
    # is never gathered
    remote = options.parallel == "remote"
    if remote:
        if layout == "qn":
            raise ValueError("--layout qn is the single-device large-N mode; -p remote "
                             "shards (N, Q) rows")
        distributed.initialize(device_type=getattr(options, "device", "cuda"))
    device = _device(options)
    dtype = torch.float64 if options.dtype == "float64" else torch.float32
    if remote:
        mesh = distributed.global_mesh(device)
        n = data.partition_rows(options.input, prefix="Y")
        start, stop, _ = distributed.process_row_range(n, mesh.local_size)
        rows = (start, min(stop, n))
        y_np = data.load_rows(options.input, *rows, prefix="Y")
        d = y_np.shape[1]
    else:
        mesh, rows = _local_mesh(device, layout), None
        y_np = data.load_partitioned(options.input, prefix="Y")
        n, d = y_np.shape
    writer = distributed.is_coordinator()
    if options.fixed_embeddings:
        mode = _run_svgp if options.optimizer == "svgp" else _run_sgpr
        return mode(options, device, dtype, t_start, y_np, n, d, mesh, rows, writer)
    if dtype == torch.float64 and device.type == "cuda" and options.stats_impl != "xla":
        raise ValueError(
            "--dtype float64 on the card needs --stats-impl xla: the CUDA "
            f"kernels (--stats-impl {options.stats_impl}) take float32")
    n_partitions = options.save_partitions or len(
        data._partition_files(options.input, prefix="Y")
    )

    timer = glog.Timer()
    timer.start("init")
    gen = torch.Generator(device).manual_seed(options.seed)
    cfg = gplvm.GPLVMConfig(
        q=options.q,
        num_inducing=options.m,
        bijector=options.bijector,
        block=options.block,
        stats_impl=options.stats_impl,
        init=options.init,
        fixed_beta=options.fixed_beta,
        layout=layout,
        # under qn the observations are (D, N) too
        y_layout="dn" if layout == "qn" else "nd",
        scg_mode=getattr(options, "scg_mode", "auto"),
    )
    y = torch.tensor(np.ascontiguousarray(y_np.T if layout == "qn" else y_np),
                     dtype=dtype, device=device)

    if options.load and os.path.isdir(options.embeddings):
        if remote:
            n_emb = data.partition_rows(options.embeddings, prefix="X_mu")
            if n_emb != n:
                raise ValueError(f"loaded embeddings have {n_emb} rows, expected N={n}")
            mu_np, s_np = data.load_embeddings_rows(options.embeddings, *rows)
        else:
            mu_np, s_np = data.load_embeddings(options.embeddings)
            if mu_np.shape != (n, options.q):
                raise ValueError(
                    f"loaded embeddings {mu_np.shape} do not match (N={n}, Q={options.q})"
                )
        if mu_np.shape[1] != options.q:
            raise ValueError(f"loaded embeddings have Q={mu_np.shape[1]}, expected {options.q}")
        # numpy in: make_latents transposes on the host under qn, and FPS
        # picks Z from a host-side candidate subset of the rows
        np_dtype = np.dtype(options.dtype)
        lat = P.make_latents(mu_np.astype(np_dtype, copy=False),
                             s_np.astype(np_dtype, copy=False),
                             bijector=options.bijector, layout=layout, device=device)
        cand_np = init_utils.host_candidate_rows(mu_np, options.m, seed=options.seed)
        z = init_utils.init_inducing(
            gen, torch.tensor(cand_np, dtype=dtype, device=device), options.m)
        glob = P.make_global(z, 1.0, np.ones(options.q),
                             10.0 / max(float(np.var(y_np)), 1e-6),
                             bijector=options.bijector)
        params = P.GPLVMParams(glob=glob, lat=lat)
    else:
        # under remote from this process's block (a local PCA per partition,
        # the reference's init); the coordinator's globals are taken below
        params = gplvm.init_params(gen, y, cfg)

    ckpt_path = None
    if options.statistics:
        ckpt_path = os.path.join(options.statistics, "checkpoint.npz")
        if options.load and os.path.exists(ckpt_path):
            if remote or not checkpoint.holds_latents(ckpt_path):
                # a remote run's checkpoint holds the globals only; the
                # latents are the embeddings folder's, loaded above
                glob, meta = checkpoint.load(ckpt_path, params.glob)
                params = P.GPLVMParams(glob=glob, lat=params.lat)
            else:
                params, meta = checkpoint.load(ckpt_path, params)
            params = P.from_leaves([t.to(dtype) for t in P.leaves(params)])
            if writer:
                print(f"resumed from {ckpt_path} (iteration {meta.get('iteration')})")

    weights = None
    if mesh is not None:
        glob, y, mu_s, us_s, weights = _place(options, mesh, n, params.glob, dtype,
                                              P.from_leaves, y, params.lat.mu.detach(),
                                              params.lat.u_s.detach())
        params = P.GPLVMParams(glob=glob, lat=P.LatentParams(mu_s.gather(), us_s.gather()))
    timer.stop("init")

    # ---- fit ----
    timer.start("fit")
    scg_options = _scg_options(options)
    launched = dict(psi_cuda.LAUNCHES)
    with _maybe_profile(options), _maybe_iter_timer(options) as it_timer:
        result = gplvm.fit(
            params, y, cfg,
            iters=options.iterations,
            optimizer=options.optimizer,
            learning_rate=options.learning_rate,
            scg_options=scg_options if options.optimizer == "scg" else None,
            mesh=mesh, weights=weights,
        )
        final_bound = float(result.bound)
    fit_s = timer.stop("fit")
    replicas = _check_replicas(result.params.glob, mesh)

    # ---- save ----
    timer.start("save")
    mu, s = gplvm.latents(result.params, cfg)
    if remote:
        # each process writes exactly its own rows as one partition file;
        # the padding (all on the last process) is trimmed
        n_valid = rows[1] - rows[0]
        data.save_embeddings_partition(
            options.embeddings, distributed.local_block(mu)[:n_valid],
            distributed.local_block(s)[:n_valid], partition=distributed.process_index())
        distributed.barrier("embeddings_saved")
    else:
        data.save_embeddings(options.embeddings, mu[:n].detach().cpu().numpy(),
                             s[:n].detach().cpu().numpy(), n_partitions)
    summary = {
        "n": n, "d": d, "q": options.q, "m": options.m,
        "optimizer": options.optimizer,
        "stats_impl": options.stats_impl,
        "iterations": options.iterations,
        "n_evals": int(result.n_evals),
        "final_bound": final_bound,
        "devices": mesh.size if mesh is not None else 1,
        "parallel": options.parallel,
        # this process's kernel calls in the fit (0 on CPU tensors)
        "kernel_launches": {k: v - launched[k] for k, v in psi_cuda.LAUNCHES.items()},
        **replicas,
    }
    if options.statistics and writer:
        os.makedirs(options.statistics, exist_ok=True)
        glog.write_history(
            os.path.join(options.statistics, "bound_history.jsonl"),
            _history_with_wall(result, it_timer, options.iterations),
            extra=_iter_wall_extra(fit_s, result.history),
        )
        meta = {"iteration": options.iterations, "bound": final_bound,
                "config": {k: v for k, v in vars(options).items()
                           if isinstance(v, (int, float, str, bool, type(None)))}}
        if remote:
            # globals only: the processes' embeddings partition files are
            # the latent state
            checkpoint.save(ckpt_path, result.params.glob, meta=meta)
        else:
            # the unpadded latents: a resume may run on another card count
            lat = result.params.lat
            if mesh is not None:
                lat = P.LatentParams(lat.mu[:n], lat.u_s[:n])
            checkpoint.save(ckpt_path, P.GPLVMParams(result.params.glob, lat), meta=meta)
    timer.stop("save")
    summary["wall_time_s"] = round(time.perf_counter() - t_start, 3)
    summary["timings_s"] = {k: round(v, 3) for k, v in timer.summary().items()}
    if options.statistics and writer:
        with open(os.path.join(options.statistics, "summary.json"), "w") as f:
            json.dump(summary, f, indent=2)
    if writer:
        print(json.dumps(summary))
    return summary


def _observed(options, device, dtype, y_np, n, rows):
    """The --fixed-embeddings modes' data: the observed inputs X of the
    embeddings folder (this process's ``rows`` under -p remote), checked
    against Y's N, and (X numpy, X, Y, layout) with X and Y on ``device``,
    stored (Q, N) and (D, N) under --layout qn."""
    import torch

    from gparml_tpu_torch import data

    if rows is not None:
        n_x = data.partition_rows(options.embeddings, prefix="X_mu")
        if n_x != n:
            raise ValueError(
                f"embeddings rows {n_x} != N={n}; --fixed-embeddings "
                "needs observed inputs in the embeddings folder")
        x_np, _ = data.load_embeddings_rows(options.embeddings, *rows)
    else:
        x_np, _ = data.load_embeddings(options.embeddings)
        if x_np.shape[0] != n:
            raise ValueError(
                f"embeddings rows {x_np.shape[0]} != N={n}; --fixed-embeddings "
                "needs observed inputs in the embeddings folder")
    layout = getattr(options, "layout", "nq")
    host = (lambda a: a.T) if layout == "qn" else (lambda a: a)
    x = torch.tensor(np.ascontiguousarray(host(x_np)), dtype=dtype, device=device)
    y = torch.tensor(np.ascontiguousarray(host(y_np)), dtype=dtype, device=device)
    return x_np, x, y, layout


def _run_sgpr(options, device, dtype, t_start, y_np, n, d, mesh, rows, writer) -> dict:
    """The --fixed-embeddings mode: sparse GP regression of Y on the observed
    inputs X of the embeddings folder (the JAX CLI's SGPR branch). ``rows``
    is this process's block under -p remote, else None."""
    import torch

    from gparml_tpu_torch import checkpoint
    from gparml_tpu_torch.models import params as P, sgpr
    from gparml_tpu_torch.parallel import distributed
    from gparml_tpu_torch.utils import logging as glog

    x_np, x, y, layout = _observed(options, device, dtype, y_np, n, rows)
    cfg = sgpr.SGPRConfig(num_inducing=options.m, bijector=options.bijector,
                          block=options.block, fixed_beta=options.fixed_beta,
                          layout=layout, scg_mode=getattr(options, "scg_mode", "auto"))
    gen = torch.Generator(device).manual_seed(options.seed)
    if rows is not None:
        # -p remote: the globals start from a sample of every process's rows
        # (the JAX package's start from the coordinator's block alone, which
        # covers part of the input domain when the rows are ordered by X)
        x_s, y_s = distributed.sample_rows(options.m, options.seed, x_np, y_np)
        g0 = sgpr.init_params(gen, torch.tensor(x_s, dtype=dtype, device=device),
                              torch.tensor(y_s, dtype=dtype, device=device), cfg)
    else:
        g0 = sgpr.init_params(gen, x, y, cfg)
    ckpt_path = (os.path.join(options.statistics, "checkpoint.npz")
                 if options.statistics else None)
    if options.load and ckpt_path and os.path.exists(ckpt_path):
        g0, meta = checkpoint.load(ckpt_path, g0)
        g0 = P.from_leaves([t.detach().to(dtype) for t in g0.parameters()])
        if writer:
            print(f"resumed from {ckpt_path} (iteration {meta.get('iteration')})")
    weights = None
    if mesh is not None:
        # init used this process's rows only: the globals are the coordinator's
        g0, y, x, weights = _place(options, mesh, n, g0, dtype, P.from_leaves, y, x)

    timer = glog.Timer()
    timer.start("fit")
    with _maybe_profile(options), _maybe_iter_timer(options) as it_timer:
        result = sgpr.fit(
            g0, x, y, cfg, iters=options.iterations, optimizer=options.optimizer,
            learning_rate=options.learning_rate,
            scg_options=_scg_options(options) if options.optimizer == "scg" else None,
            mesh=mesh, weights=weights)
        final_bound = float(result.bound)
    fit_s = timer.stop("fit")
    summary = {
        "mode": "sgpr", "n": n, "d": d, "m": options.m,
        "optimizer": options.optimizer, "iterations": options.iterations,
        "n_evals": int(result.n_evals), "final_bound": final_bound,
        "devices": mesh.size if mesh is not None else 1, "parallel": options.parallel,
        **_check_replicas(result.params, mesh),
        "wall_time_s": round(time.perf_counter() - t_start, 3),
    }
    if options.statistics and writer:
        os.makedirs(options.statistics, exist_ok=True)
        glog.write_history(
            os.path.join(options.statistics, "bound_history.jsonl"),
            _history_with_wall(result, it_timer, options.iterations),
            extra=_iter_wall_extra(fit_s, result.history),
        )
        checkpoint.save(ckpt_path, result.params,
                        meta={"iteration": options.iterations, "bound": final_bound})
        with open(os.path.join(options.statistics, "summary.json"), "w") as f:
            json.dump(summary, f, indent=2)
    if writer:
        print(json.dumps(summary))
    return summary


def _run_svgp(options, device, dtype, t_start, y_np, n, d, mesh, rows, writer) -> dict:
    """The --fixed-embeddings --optimizer svgp mode: SVGP of Y on the
    observed inputs X by minibatch Adam (the JAX CLI's SVGP branch).
    ``rows`` is this process's block under -p remote, else None."""
    import torch

    from gparml_tpu_torch import checkpoint
    from gparml_tpu_torch.models import svgp
    from gparml_tpu_torch.parallel import distributed
    from gparml_tpu_torch.utils import logging as glog

    x_np, x, y, layout = _observed(options, device, dtype, y_np, n, rows)
    cfg = svgp.SVGPConfig(num_inducing=options.m, bijector=options.bijector,
                          batch_size=options.batch_size, fixed_beta=options.fixed_beta,
                          layout=layout)
    gen = torch.Generator(device).manual_seed(options.seed)
    if rows is not None:
        # -p remote: the start from a sample of every process's rows, as SGPR's
        x_s, y_s = distributed.sample_rows(options.m, options.seed, x_np, y_np)
        p0 = svgp.init_params(gen, torch.tensor(x_s, dtype=dtype, device=device),
                              torch.tensor(y_s, dtype=dtype, device=device), cfg)
    else:
        p0 = svgp.init_params(gen, x, y, cfg)
    ckpt_path = (os.path.join(options.statistics, "checkpoint.npz")
                 if options.statistics else None)
    if options.load and ckpt_path and os.path.exists(ckpt_path):
        p0, meta = checkpoint.load(ckpt_path, p0)
        p0 = svgp.from_leaves([t.detach().to(dtype) for t in p0.parameters()])
        if writer:
            print(f"resumed from {ckpt_path} (iteration {meta.get('iteration')})")
    weights = None
    if mesh is not None:
        p0, y, x, weights = _place(options, mesh, n, p0, dtype, svgp.from_leaves, y, x)

    timer = glog.Timer()
    timer.start("fit")
    with _maybe_profile(options):
        result = svgp.fit(p0, x, y, cfg, steps=options.iterations,
                          learning_rate=options.learning_rate, seed=options.seed,
                          mesh=mesh, weights=weights)
    timer.stop("fit")
    summary = {
        "mode": "svgp", "n": n, "d": d, "m": options.m,
        "iterations": options.iterations, "batch_size": cfg.batch_size,
        "final_elbo": result.elbo,
        # exact full-data ELBO, or an unbiased estimate over final_elbo_n rows
        "final_elbo_exact": bool(result.elbo_exact),
        "final_elbo_n": int(result.elbo_n),
        "devices": mesh.size if mesh is not None else 1, "parallel": options.parallel,
        **_check_replicas(result.params, mesh),
        "wall_time_s": round(time.perf_counter() - t_start, 3),
    }
    if options.statistics and writer:
        os.makedirs(options.statistics, exist_ok=True)
        glog.write_history(os.path.join(options.statistics, "elbo_history.jsonl"),
                           result.history)
        checkpoint.save(ckpt_path, result.params,
                        meta={"iteration": options.iterations, "bound": result.elbo})
        with open(os.path.join(options.statistics, "summary.json"), "w") as f:
            json.dump(summary, f, indent=2)
    if writer:
        print(json.dumps(summary))
    return summary


def main(argv=None):
    options = build_parser().parse_args(argv)
    return run(options)


if __name__ == "__main__":
    from gparml_tpu_torch.parallel import distributed

    main()
    distributed.shutdown()
