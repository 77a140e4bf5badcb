#!/usr/bin/env python3
"""Errors of the Q <= 64 Psi2 and Psi1 arithmetic on spread latents.

On the inputs of ``chip_smoke.spread_inputs`` (latents 3 * N(0, 1) around
the origin, each inducing point near a latent row, N=400, M=64, D=16,
sf2 = 1.3, unit weights, N(0, 1) cotangents), for each Q of ``CASES`` and
each statistic (sum_n w_n Psi2_n, and Psi1^T (w Y)), the norm-scaled error
of the statistic and of every leaf of its VJP (the other statistic's
cotangent zero), at seed 0; for dsf2 and dalpha, sums over every row and
inducing point whose error is one draw of a cancelling sum, the median over
the draws of SEEDS (CPU) or CARD_SEEDS (card):

  * on the CPU (the default; needs the JAX package): the CPU model of the
    kernels (``ops/psi_tc_model.py``), the port's plain float32 engine and
    the JAX package's own float32 path (``psi_pallas.psi_fused`` in
    interpret mode: at M=64, Ml=128, ``_fwd_kernel`` and ``_bwd_kernel``),
    each against the JAX package's float64 VJP;
  * on the card (``--card``; no JAX): the CUDA kernels in both layouts and
    the CPU model, each against the port's plain engine in float64.

It prints one line a case, each leaf's errors ("(median)" marks the
reduced leaves). tests/test_torch_spread_latents.py
(CPU) and tests/test_torch_cuda.py (card) hold the same numbers to their
limits with these functions.

Run from the repository root: python3 tools/spread_latents.py [--card] [--seeds N]
"""

import argparse
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

N, M, D, SPREAD = 400, 64, 16, 3.0
CASES = (10, 32, 48, 64)
STATS = ("psi2", "psi1")
LEAVES = {"psi2": ("psi2", "mu", "s", "z", "sf2", "alpha"),
          "psi1": ("psi1_y", "mu", "s", "z", "sf2", "alpha", "y")}
# Leaves that sum over every row and inducing point: their error is one
# draw of a cancelling sum, so they are read as the median over SEEDS (the
# CPU, model against the JAX package's float32 path, 5-50x apart) or
# CARD_SEEDS (the kernels against the model, whose medians over 5 draws
# still differ by up to 3.4x where over 25 they agree within 1.1x).
REDUCED = ("sf2", "alpha")
SEEDS = tuple(range(5))
CARD_SEEDS = tuple(range(25))
ARGS = ("mu", "s", "z", "sf2", "alpha", "y")


def inputs(q, seed=0):
    return chip_smoke.spread_inputs(N, M, q, D, SPREAD, seed)


def nrm(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _host(x):
    import torch

    return x.detach().double().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def port(pr, stat, dtype, device="cpu", kernels=False, layout="nq"):
    """The statistic and its VJP through the port's wrappers
    (``ops/psi_cuda.py``): the kernels (``kernels=True``, CUDA tensors) or
    the plain version, in ``layout``; numpy float64 arrays in (N, Q)
    order."""
    import torch

    _, _, fused, fwd_ref, _ = chip_smoke._wrappers(layout)
    qn = layout == "qn"
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)
    xs = [t(pr[k].T.copy() if qn and k in ("mu", "s", "y") else pr[k]).requires_grad_(True)
          for k in ARGS]
    p1y, p2 = (fused if kernels else fwd_ref)(*xs, t(pr["w"]))
    if stat == "psi2":
        out, grads = p2, torch.autograd.grad(p2, xs[:5], t(pr["dp2"]))
    else:
        out, grads = p1y, torch.autograd.grad(p1y, xs, t(pr["dp1y"]))
    grads = [g.T if qn and i in (0, 1, 5) else g for i, g in enumerate(grads)]
    return [_host(a) for a in (out, *grads)]


def model(pr, stat):
    """The CPU model of the kernels' tensor-core arithmetic (float32)."""
    import torch

    from gparml_tpu_torch.ops import psi_tc_model as tm

    t = lambda k: torch.tensor(pr[k], dtype=torch.float32)
    if stat == "psi2":
        out, grads = tm.psi2_vjp(*(t(k) for k in ARGS[:5]), t("w"), t("dp2"))
    else:
        out, grads = tm.psi1_vjp(*(t(k) for k in ARGS), t("w"), t("dp1y"))
    return [_host(a) for a in (out, *grads)]


def jax_truth(pr, stat):
    """The JAX package's float64 statistic and VJP (needs jax_enable_x64)."""
    import jax

    from gparml_tpu.ops import psi as jpsi

    w = pr["w"]
    if stat == "psi2":
        f = lambda mu, s, z, sf2, alpha: jpsi.psi2_sum(mu, s, z, sf2, alpha, w)
        out, vjp = jax.vjp(f, *(pr[k] for k in ARGS[:5]))
        return [_host(a) for a in (out, *vjp(pr["dp2"]))]
    f = lambda mu, s, z, sf2, alpha, y: jpsi.psi1(mu, s, z, sf2, alpha).T @ (w[:, None] * y)
    out, vjp = jax.vjp(f, *(pr[k] for k in ARGS))
    return [_host(a) for a in (out, *vjp(pr["dp1y"]))]


def jax_reference32(pr, stat):
    """The JAX package's float32 path: ``psi_pallas.psi_fused`` in
    interpret mode."""
    import jax
    import jax.numpy as jnp

    from gparml_tpu.ops import psi_pallas

    f32 = lambda a: jnp.asarray(a, jnp.float32)
    out, vjp = jax.vjp(lambda *xs: psi_pallas.psi_fused(*xs, f32(pr["w"]), 32, True),
                       *(f32(pr[k]) for k in ARGS))
    if stat == "psi2":
        grads = vjp((jnp.zeros((M, D), jnp.float32), f32(pr["dp2"])))[:5]
        return [_host(a) for a in (out[1], *grads)]
    grads = vjp((f32(pr["dp1y"]), jnp.zeros((M, M), jnp.float32)))
    return [_host(a) for a in (out[0], *grads)]


def errors(stat, want, *got):
    """{leaf: (error of each of ``got`` against ``want``)}."""
    return {name: tuple(nrm(g[i], want[i]) for g in got)
            for i, name in enumerate(LEAVES[stat])}


def seed_errors(runs):
    """One ``errors`` dict a seed -> seed 0's errors of each leaf, and for
    REDUCED leaves the median over the seeds of each column."""
    return {name: (tuple(float(v) for v in np.median([r[name] for r in runs], axis=0))
                   if name in REDUCED else runs[0][name]) for name in runs[0]}


def cpu_errors(q, stat, seeds=SEEDS):
    """{leaf: (model, plain f32, JAX Pallas f32)}, each against the JAX
    package's float64 VJP (``seed_errors`` over ``seeds``)."""
    import torch

    runs = []
    for seed in seeds:
        pr = inputs(q, seed)
        runs.append(errors(stat, jax_truth(pr, stat), model(pr, stat),
                           port(pr, stat, torch.float32), jax_reference32(pr, stat)))
    return seed_errors(runs)


def card_errors(q, stat, device="cuda", layouts=("nq", "qn"), seeds=CARD_SEEDS):
    """{leaf: (the kernels in each of ``layouts``, model)}, each against the
    plain engine in float64 on ``device`` (``seed_errors`` over ``seeds``)."""
    import torch

    runs = []
    for seed in seeds:
        pr = inputs(q, seed)
        want = port(pr, stat, torch.float64, device)
        got = [port(pr, stat, torch.float32, device, True, lay) for lay in layouts]
        runs.append(errors(stat, want, *got, model(pr, stat)))
    return seed_errors(runs)


def limits(errs, factor, floor):
    """{leaf: the larger of ``floor`` and ``factor`` times the yardstick's
    error of the same leaf (the last of ``errs``' columns)}."""
    return {name: max(floor, factor * e[-1]) for name, e in errs.items()}


def _line(q, stat, errs, names):
    return f"Q={q} {stat}: " + "; ".join(
        f"d{k}{' (median)' if k in REDUCED else ''} "
        + " ".join(f"{n} {v:.2e}" for n, v in zip(names, e)) for k, e in errs.items())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--card", action="store_true",
                    help="the CUDA kernels and the model against the plain float64 engine")
    ap.add_argument("--seeds", type=int,
                    help="draws the reduced leaves' medians are taken over (default: "
                         f"{len(SEEDS)} on the CPU, {len(CARD_SEEDS)} with --card)")
    args = ap.parse_args(argv)
    card = args.card
    seeds = tuple(range(args.seeds)) if args.seeds else CARD_SEEDS if card else SEEDS
    import torch

    if card:
        if not torch.cuda.is_available():
            print("spread_latents: --card needs a CUDA device", file=sys.stderr)
            return 2
        torch.backends.cuda.matmul.allow_tf32 = False
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip())
    else:
        import jax

        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
    for q in CASES:
        for stat in STATS:
            if card:
                print(_line(q, stat, card_errors(q, stat, seeds=seeds),
                            ("kernels nq", "kernels qn", "model")))
            else:
                print(_line(q, stat, cpu_errors(q, stat, seeds),
                            ("model", "plain f32", "JAX Pallas f32")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
