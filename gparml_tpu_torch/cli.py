"""Command-line interface: the GPLVM and sparse GP regression modes of
``gparml_tpu/cli.py`` on one GPU.

The same option surface and folder workflow as the JAX package's CLI, the
re-design of GParML's ``parallel_GPLVM.py``: per-partition ``Y_<i>.npy``
inputs, embedding init (PCA, random, or ``--load`` from the embeddings
folder and ``checkpoint.npz``), a joint fit of latents, inducing points and
hypers with SCG, Adam or GD, and the results written back: embeddings
partition files, ``bound_history.jsonl``, ``checkpoint.npz`` and
``summary.json``. With ``--fixed-embeddings`` the embeddings folder holds
observed inputs X (its ``X_mu_<i>.npy``, one row per row of Y) and the run
fits sparse GP regression (``models/sgpr.py``): Z and the hypers only,
``--load`` resuming from ``checkpoint.npz``, the summary's ``mode`` "sgpr".
Either package resumes from the other's folders.

  -i/--input         folder of per-partition Y_<i>.npy files
  -e/--embeddings    folder for X_mu_<i>.npy / X_S_<i>.npy
  -T/--iterations    optimizer iterations
  -q/--latent-dim    latent dimensionality Q
  -m/--num-inducing  inducing point count M
  -s/--statistics    output folder for history/checkpoint/summary
  --device           cuda (cuda:0, the default) or cpu

The fit runs on ``cuda:0`` through the hand-written CUDA kernels
(``--stats-impl auto``) unless ``--device cpu`` is given, which stands in
for the JAX package's ``JAX_PLATFORMS``; without a card ``--device cuda``
raises. The kernels take float32: ``--dtype float64`` on the card needs
``--stats-impl xla``. A checkpoint's leaves are cast to ``--dtype``.
``--compile-cache`` and ``--scg-mode`` are accepted and do nothing (XLA
compile caching and the TPU's fused SCG program have no counterpart).
Not ported yet, and raising NotImplementedError: ``--optimizer svgp`` and
``-p remote`` (ROADMAP.md Queue 1, items 2 and 3).

Run ``python -m gparml_tpu_torch.cli --help`` for the full surface.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gparml_tpu_torch",
        description="Bayesian GPLVM trainer on one NVIDIA GPU (PyTorch + CUDA)",
    )
    p.add_argument("-i", "--input", required=True, help="folder of Y_<i>.npy partitions")
    p.add_argument("-e", "--embeddings", required=True, help="embeddings folder")
    p.add_argument("-p", "--parallel", choices=["local", "remote"], default="local",
                   help="local: this process's one device; remote (multi-host) "
                        "is not ported yet")
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
                   help="svgp is not ported yet")
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


def _check_ported(options) -> None:
    """Raise for the modes the port does not have yet."""
    if options.optimizer == "svgp":
        raise NotImplementedError(
            "--optimizer svgp (SVGP minibatch training) is not ported yet "
            "(ROADMAP.md Queue 1, item 2: SVGP)")
    if options.parallel == "remote":
        raise NotImplementedError(
            "-p remote (multi-host data parallelism) is not ported yet "
            "(ROADMAP.md Queue 1, item 3: parallel)")


def _device(options):
    import torch

    if getattr(options, "device", "cuda") == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device; pass --device cpu to run on the CPU")
    return torch.device("cuda", 0)


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
    the statistics folder). ``options`` is the parsed argparse namespace (or
    anything with the same attributes)."""
    import torch

    from gparml_tpu_torch import checkpoint, data
    from gparml_tpu_torch.models import gplvm, params as P
    from gparml_tpu_torch.utils import init as init_utils
    from gparml_tpu_torch.utils import logging as glog

    _check_ported(options)
    t_start = time.perf_counter()
    device = _device(options)
    dtype = torch.float64 if options.dtype == "float64" else torch.float32
    if options.fixed_embeddings:
        return _run_sgpr(options, device, dtype, t_start)
    if dtype == torch.float64 and device.type == "cuda" and options.stats_impl != "xla":
        raise ValueError(
            "--dtype float64 on the card needs --stats-impl xla: the CUDA "
            f"kernels (--stats-impl {options.stats_impl}) take float32")

    y_np = data.load_partitioned(options.input, prefix="Y")
    n, d = y_np.shape
    n_partitions = options.save_partitions or len(
        data._partition_files(options.input, prefix="Y")
    )

    timer = glog.Timer()
    timer.start("init")
    gen = torch.Generator(device).manual_seed(options.seed)
    layout = getattr(options, "layout", "nq")
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
        mu_np, s_np = data.load_embeddings(options.embeddings)
        if mu_np.shape != (n, options.q):
            raise ValueError(
                f"loaded embeddings {mu_np.shape} do not match (N={n}, Q={options.q})"
            )
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
        params = gplvm.init_params(gen, y, cfg)

    ckpt_path = None
    if options.statistics:
        ckpt_path = os.path.join(options.statistics, "checkpoint.npz")
        if options.load and os.path.exists(ckpt_path):
            params, meta = checkpoint.load(ckpt_path, params)
            params = P.from_leaves([t.to(dtype) for t in P.leaves(params)])
            print(f"resumed from {ckpt_path} (iteration {meta.get('iteration')})")
    timer.stop("init")

    # ---- fit ----
    timer.start("fit")
    scg_options = _scg_options(options)
    with _maybe_profile(options), _maybe_iter_timer(options) as it_timer:
        result = gplvm.fit(
            params, y, cfg,
            iters=options.iterations,
            optimizer=options.optimizer,
            learning_rate=options.learning_rate,
            scg_options=scg_options if options.optimizer == "scg" else None,
        )
        final_bound = float(result.bound)
    fit_s = timer.stop("fit")

    # ---- save ----
    timer.start("save")
    mu, s = gplvm.latents(result.params, cfg)
    data.save_embeddings(options.embeddings, mu.detach().cpu().numpy(),
                         s.detach().cpu().numpy(), n_partitions)
    summary = {
        "n": n, "d": d, "q": options.q, "m": options.m,
        "optimizer": options.optimizer,
        "stats_impl": options.stats_impl,
        "iterations": options.iterations,
        "n_evals": int(result.n_evals),
        "final_bound": final_bound,
        "devices": 1,
        "parallel": options.parallel,
    }
    if options.statistics:
        os.makedirs(options.statistics, exist_ok=True)
        glog.write_history(
            os.path.join(options.statistics, "bound_history.jsonl"),
            _history_with_wall(result, it_timer, options.iterations),
            extra=_iter_wall_extra(fit_s, result.history),
        )
        meta = {"iteration": options.iterations, "bound": final_bound,
                "config": {k: v for k, v in vars(options).items()
                           if isinstance(v, (int, float, str, bool, type(None)))}}
        checkpoint.save(ckpt_path, result.params, meta=meta)
    timer.stop("save")
    summary["wall_time_s"] = round(time.perf_counter() - t_start, 3)
    summary["timings_s"] = {k: round(v, 3) for k, v in timer.summary().items()}
    if options.statistics:
        with open(os.path.join(options.statistics, "summary.json"), "w") as f:
            json.dump(summary, f, indent=2)
    print(json.dumps(summary))
    return summary


def _run_sgpr(options, device, dtype, t_start) -> dict:
    """The --fixed-embeddings mode: sparse GP regression of Y on the observed
    inputs X of the embeddings folder (the JAX CLI's SGPR branch, one
    device)."""
    import torch

    from gparml_tpu_torch import checkpoint, data
    from gparml_tpu_torch.models import params as P, sgpr
    from gparml_tpu_torch.utils import logging as glog

    y_np = data.load_partitioned(options.input, prefix="Y")
    n, d = y_np.shape
    x_np, _ = data.load_embeddings(options.embeddings)
    if x_np.shape[0] != n:
        raise ValueError(
            f"embeddings rows {x_np.shape[0]} != N={n}; --fixed-embeddings "
            "needs observed inputs in the embeddings folder")
    layout = getattr(options, "layout", "nq")
    # under qn both are stored transposed, (Q, N) and (D, N)
    host = (lambda a: a.T) if layout == "qn" else (lambda a: a)
    x = torch.tensor(np.ascontiguousarray(host(x_np)), dtype=dtype, device=device)
    y = torch.tensor(np.ascontiguousarray(host(y_np)), dtype=dtype, device=device)
    cfg = sgpr.SGPRConfig(num_inducing=options.m, bijector=options.bijector,
                          block=options.block, fixed_beta=options.fixed_beta,
                          layout=layout, scg_mode=getattr(options, "scg_mode", "auto"))
    g0 = sgpr.init_params(torch.Generator(device).manual_seed(options.seed), x, y, cfg)
    ckpt_path = (os.path.join(options.statistics, "checkpoint.npz")
                 if options.statistics else None)
    if options.load and ckpt_path and os.path.exists(ckpt_path):
        g0, meta = checkpoint.load(ckpt_path, g0)
        g0 = P.from_leaves([t.detach().to(dtype) for t in g0.parameters()])
        print(f"resumed from {ckpt_path} (iteration {meta.get('iteration')})")

    timer = glog.Timer()
    timer.start("fit")
    with _maybe_profile(options), _maybe_iter_timer(options) as it_timer:
        result = sgpr.fit(
            g0, x, y, cfg, iters=options.iterations, optimizer=options.optimizer,
            learning_rate=options.learning_rate,
            scg_options=_scg_options(options) if options.optimizer == "scg" else None)
        final_bound = float(result.bound)
    fit_s = timer.stop("fit")
    summary = {
        "mode": "sgpr", "n": n, "d": d, "m": options.m,
        "optimizer": options.optimizer, "iterations": options.iterations,
        "n_evals": int(result.n_evals), "final_bound": final_bound,
        "devices": 1, "parallel": options.parallel,
        "wall_time_s": round(time.perf_counter() - t_start, 3),
    }
    if options.statistics:
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
    print(json.dumps(summary))
    return summary


def main(argv=None):
    options = build_parser().parse_args(argv)
    return run(options)


if __name__ == "__main__":
    main()
