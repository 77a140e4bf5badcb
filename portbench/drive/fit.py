"""Traffic kind ``fit``: closed-loop SCG training through ``gplvm.fit``.

Set-up makes Y from the seed on the card, the start through
``gplvm.init_params`` (PCA and farthest-point sampling), and drives it
through its first steps with the window's own call: one call of
``gplvm.fit`` with one SCG iteration, then one with ``iters_per_call``, as
the window makes them; they also warm every shape. The window then runs
``gplvm.fit`` with ``iters_per_call`` iterations a call, each call
continuing from the last one's parameters, and closes at the end of the
first call that ends after ``--seconds``.

End to end: ``fit_points_per_s`` = N x the evaluations completed
(``FitResult.n_evals``) / the window's synchronized wall time;
``peak_mem_gib``, the peak of the device's allocator over the run.

Correctness (after the window, the peak read and the program's state
freed), against the float64 reference at the configuration's model, with
x0 the start, x1 after the first call and x2 after the second:
``start``, the start judged by its definition (``reference/init.py``);
``loss``, the worst relative gap between the bound each first call
reports and the reference's bound at its parameters (x1, x2); ``grad``,
the worst-leaf gap of norms between the first gradient as SCG took it,
(x0 - x1) / alpha_1 (its first direction is the negative gradient), and
the reference's gradient at x0; ``change``, the worst-leaf gap of norms
between the second call's change x2 - x1 and the change of the
reference's SCG from x1 with the step sizes and acceptances that call
reported (``reference/scg.replay``): its directions, the conjugate
update among them, are the reference's own. The reference follows the
program's own iterates: a start defined up to sign and ties, and SCG's
float32 curvature probe, leave no trajectory of its own to follow
(PERF.md).
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from portbench.drive import common
from portbench.reference import gplvm as ref
from portbench.reference import scg as ref_scg


def first_steps(ctx) -> dict:
    """Set-up: Y, the start and the first steps (see the module text)."""
    from gparml_tpu_torch.models import gplvm

    cfg, dev = ctx.config, ctx.devices[0]
    gcfg = common.gplvm_config(cfg)
    y, _ = common.observations(cfg, ctx.seed, dev)
    p = gplvm.init_params(common.init_generator(ctx.seed, dev), y, gcfg)
    steps, reported = [common.host_leaves(p)], []
    for iters in (1, ctx.mix["iters_per_call"]):
        res = gplvm.fit(p, y, gcfg, iters=iters)
        p = res.params
        steps.append(common.host_leaves(p))
        reported.append(float(res.bound))
        if iters == 1:
            alpha = float(res.trace["alpha"][0]) if bool(res.trace["accepted"][0]) else 0.0
    common.sync(dev)
    ran = np.isfinite(res.trace["alpha"])
    return {"gcfg": gcfg, "y": y, "p": p, "steps": steps, "reported": reported,
            "alpha": alpha, "alphas": res.trace["alpha"][ran].tolist(),
            "accepted": res.trace["accepted"][ran].tolist()}


def run(ctx) -> dict:
    from gparml_tpu_torch.models import gplvm

    cfg, mix, dev = ctx.config, ctx.mix, ctx.devices[0]
    st = first_steps(ctx)
    gcfg, y, p = st.pop("gcfg"), st.pop("y"), st.pop("p")
    setup_s = ctx.since_start()

    calls = evals = failed = 0
    with ctx.window() as w:
        while True:
            res = gplvm.fit(p, y, gcfg, iters=mix["iters_per_call"])
            p = res.params
            calls += 1
            evals += int(res.n_evals)
            failed += not math.isfinite(float(res.bound))
            if w.elapsed() >= ctx.seconds:
                break
    peak = common.peak_bytes(dev)
    del p, res
    common.free_device()

    t_ref = time.perf_counter()
    checks = reference_checks(ctx, y, **st)[0]
    t_ref = time.perf_counter() - t_ref
    n = cfg["n"]
    return {
        "setup_s": setup_s,
        "end_to_end": {"fit_points_per_s": n * evals / w.seconds,
                       "peak_mem_gib": peak / 2 ** 30},
        "memory_peak_bytes": peak,
        "attempted": calls, "failed": failed, "checks": checks, "window": w,
        "reference_s": t_ref,
        "counters": {"evals": evals, "calls": calls, "n": n, "m": cfg["m"], "q": cfg["q"],
                     "d": cfg["d"]},
    }


def reference_checks(ctx, y, steps, reported, alpha, alphas, accepted, control: bool = False):
    """The numbers compared (see the module text); with ``control``, also
    (second) the control's readings: the reference at float32 with TF32
    products in the program's place, its bounds at x1 and x2 standing for
    the reported ones, its gradient at x0 for the recovered one, and its
    own replay of the second call for that call's change. Without, the
    second is None."""
    dev = ctx.devices[0]
    rm = common.RefModel(ctx.config, y, dev)
    model = (rm.d, rm.jitter, rm.psi2_eps)

    def readings(dtype):
        """The reference at ``dtype``: its gradient at x0, its bounds at x1
        and x2, and its replay's change over the second call."""
        yr = rm.y.to(dtype)

        def vg(x):
            return ref.value_and_grad(yr, x[4], x[5], ref.Globals(*x[:4]), *model)

        x0, x1, x2 = (_leaves(rm, s, dtype) for s in steps)
        g0 = vg(x0)[1]
        f1, g1 = vg(x1)
        bounds = [-f1, ref.value(yr, x2[4], x2[5], ref.Globals(*x2[:4]), *model)]
        change = _diff(ref_scg.replay(vg, x1, alphas, accepted, g0=g1), x1)
        return g0, bounds, change

    ref.set_precision(False)
    grad64, bounds64, change64 = readings(torch.float64)
    got = recovered_gradient(steps[0], steps[1], alpha, dev)
    x1, x2 = (_leaves(rm, s, torch.float64) for s in steps[1:])
    prog = {"start": rm.start_gap(steps[0]), "grad": ref.leaf_gaps(got, grad64),
            "loss": max(ref.rel_gap(a, b) for a, b in zip(reported, bounds64)),
            "change": ref.leaf_gaps(_diff(x2, x1), change64)}
    if not control:
        return prog, None
    del got, x1, x2
    ref.set_precision(True)
    grad32, bounds32, change32 = readings(torch.float32)
    ref.set_precision(False)
    ctrl = {"start": rm.start_gap(steps[0], control=True), "grad": ref.leaf_gaps(grad32, grad64),
            "loss": max(ref.rel_gap(a, b) for a, b in zip(bounds32, bounds64)),
            "change": ref.leaf_gaps(change32, change64)}
    return prog, ctrl


def _leaves(rm, step, dtype) -> list:
    """The reference's leaves (z, u_sf2, u_alpha, u_beta, mu rows, u_s rows)
    of a step's host leaves."""
    g, mu, us = rm.split(step, dtype)
    return [*g, mu, us]


def _diff(a, b) -> list:
    return [x - y for x, y in zip(a, b)]


def recovered_gradient(x0, x1, alpha: float, device) -> list:
    """SCG's first direction is -g(x0), so its first accepted step gives
    g(x0) = (x0 - x1) / alpha_1 leaf by leaf; a rejected (or state-keeping)
    step gives zeros."""
    if alpha == 0.0:
        return [torch.zeros_like(a, dtype=torch.float64) for a in x0]
    return [(a.to(device, torch.float64) - b.to(device, torch.float64)) / alpha
            for a, b in zip(x0, x1)]
