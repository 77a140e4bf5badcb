"""Traffic kind ``infer``: latent inference of new observations, one client
in a closed loop, through ``gplvm.infer_latents``.

Set-up makes N + ``pool_batches`` x ``batch`` rows in one draw (the
held-out rows share the training rows' distribution), fits the model from
``gplvm.init_params`` for ``train_iters`` SCG iterations (the trained
state), and warms up with one call on a batch the window does not use.
Each call of the window embeds the next batch of ``batch`` held-out rows
with ``iters`` SCG iterations, in an order drawn from ``--seed``; the
window closes at the end of the first call that ends after ``--seconds``.
The rows and the trained state come from the mix's ``data_seed``, the same
for every run: how many evaluations SCG makes on a batch depends on its
rows, and a tail over a hundred calls moved by 9% between seeds when each
drew its own rows; with one pool, every seed serves the same calls in
another order.

End to end: ``infer_p90_s``, the 90th percentile (linear interpolation) of
the calls' synchronized wall times; ``peak_mem_gib``.

Correctness, on ``check_calls`` calls drawn from the seed among those the
window finished, the slowest among them, against the float64 reference
(whose training statistics come from the trained parameters, the program's
state; the stage that made them is checked by itself): ``start``, the
fit's start judged by its definition (read; its limits file leaves it
out, PERF.md); ``train_loss``, the trained bound the
set-up fit reported against the reference's; ``infer_bound``, the bound a
call reports at its answer against the reference's bound there;
``infer_grad``, the gradient norm SCG reports at the answer against the
reference's; ``infer_gain``, the worst shortfall of an answer's gain over
its nearest-neighbour start, the reference's bound at the answer less its
bound at the start, from the gain of the reference's own SCG (float64,
``iters`` iterations with the program's constants) from that start, as a
share of the latter: an answer left at its start, or half moved, reads
about 1 or 1/2 however consistent its report.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from portbench.drive import common
from portbench.reference import gplvm as ref
from portbench.reference import scg as ref_scg


def prepare(ctx) -> dict:
    """Set-up: the rows, the trained state and a warm-up call."""
    from gparml_tpu_torch.models import gplvm

    cfg, mix, dev = ctx.config, ctx.mix, ctx.devices[0]
    batch = mix["batch"]
    gcfg = common.gplvm_config(cfg)
    data_seed = mix["data_seed"]
    y, held = common.observations(cfg, data_seed, dev, extra_rows=batch * mix["pool_batches"])
    p0 = gplvm.init_params(common.init_generator(data_seed, dev), y, gcfg)
    start = common.host_leaves(p0)
    trained = gplvm.fit(p0, y, gcfg, iters=mix["train_iters"])
    p, train_bound = trained.params, float(trained.bound)
    del p0, trained
    gplvm.infer_latents(p, y, held[:batch], gcfg, iters=mix["iters"])
    common.sync(dev)
    order = 1 + np.random.default_rng(ctx.seed).permutation(mix["pool_batches"] - 1)
    return {"gcfg": gcfg, "y": y, "held": held, "p": p, "start": start,
            "train_bound": train_bound, "order": order.tolist()}


def serve(ctx, st, w, stop) -> dict:
    """Calls of the window until ``stop(w, calls)``: each embeds the next
    batch of the pool in the seed's order (wrapping around past its end)."""
    from gparml_tpu_torch.models import gplvm

    mix, dev = ctx.mix, ctx.devices[0]
    batch = mix["batch"]
    times, answers = [], []
    failed = evals = 0
    while True:
        j = st["order"][len(times) % len(st["order"])]
        t0 = w.elapsed()
        y_new = st["held"][j * batch:(j + 1) * batch]
        mu_s, s_s, res = gplvm.infer_latents(st["p"], st["y"], y_new, st["gcfg"],
                                             iters=mix["iters"])
        common.sync(dev)
        times.append(w.elapsed() - t0)
        gn2 = res.trace["gnorm2"]
        answers.append((j, mu_s, s_s, float(res.bound), float(gn2[np.isfinite(gn2)][-1])))
        evals += int(res.n_evals)
        failed += not (math.isfinite(float(res.bound)) and bool(torch.isfinite(mu_s).all()))
        if stop(w, len(times)):
            break
    return {"times": times, "answers": answers, "failed": failed, "evals": evals}


def run(ctx) -> dict:
    cfg, mix, dev = ctx.config, ctx.mix, ctx.devices[0]
    st = prepare(ctx)
    setup_s = ctx.since_start()
    with ctx.window() as w:
        out = serve(ctx, st, w, lambda w_, calls: w_.elapsed() >= ctx.seconds)
    peak = common.peak_bytes(dev)
    times = out["times"]
    answers = [out["answers"][i] for i in pick_calls(ctx.seed, times, mix["check_calls"])]
    leaves = common.host_leaves(st.pop("p"))
    out["answers"] = None
    common.free_device()

    t_ref = time.perf_counter()
    checks = reference_checks(ctx, st["y"], st["held"], st["start"], leaves, st["train_bound"],
                              answers)[0]
    t_ref = time.perf_counter() - t_ref
    return {
        "setup_s": setup_s,
        "end_to_end": {"infer_p90_s": float(np.percentile(times, 90)),
                       "peak_mem_gib": peak / 2 ** 30},
        "memory_peak_bytes": peak,
        "attempted": len(times), "failed": out["failed"], "checks": checks, "window": w,
        "reference_s": t_ref,
        "counters": {"evals": out["evals"], "calls": len(times), "n": cfg["n"], "m": cfg["m"],
                     "q": cfg["q"], "d": cfg["d"], "batch": mix["batch"]},
    }


def pick_calls(seed: int, times, k: int) -> list:
    """k calls drawn from the seed, the slowest among them."""
    slowest = int(np.argmax(times))
    rng = np.random.default_rng(seed)
    rest = [i for i in rng.permutation(len(times)).tolist() if i != slowest]
    return sorted([slowest] + rest[:k - 1])


def reference_checks(ctx, y, held, start, leaves, train_bound, answers,
                     control: bool = False):
    """The numbers compared (see the module text); with ``control``, also
    (second) the control's readings: the reference at float32 with TF32
    products in the program's place, its trained bound, and its own SCG's
    answers from its own nearest-neighbour start, standing for the
    program's. Without, the second is None."""
    cfg, mix, dev = ctx.config, ctx.mix, ctx.devices[0]
    batch = mix["batch"]
    rm = common.RefModel(cfg, y, dev)
    ref.set_precision(False)
    model = (rm.d, rm.jitter, rm.psi2_eps)
    g, mu, us = rm.split(leaves)
    cells = ref.cells_of(cfg["m"], dev)
    train = ref.stats(rm.y, mu, us, g, cells)
    bound64 = float(ref.bound(train, g, cells, *model))
    sides = [("prog", answers, train_bound)]
    opts = ref_scg.options_for(common.DTYPES[cfg["dtype"]], mix["iters"])
    best = {}   # batch -> (-F at its start, -F at the float64 SCG's answer)
    if control:
        ref.set_precision(True)
        g32, mu32, us32 = rm.split(leaves, torch.float32)
        y32 = rm.y.float()
        train32 = ref.stats(y32, mu32, us32, g32, cells)
        ctrl_answers = []
        for j, *_ in answers:
            obj32 = ref.InferObjective(train32, g32, held[j * batch:(j + 1) * batch].float(),
                                       *model)
            x, f, _, _ = ref_scg.minimize(obj32, obj32.start(y32, mu32, cfg["s0"]), opts)
            gn2 = sum(float(torch.sum(t.double() ** 2)) for t in obj32(x)[1])
            ctrl_answers.append((j, x[0], torch.exp(x[1]), -f, gn2))
        sides.append(("ctrl", ctrl_answers, float(ref.bound(train32, g32, cells, *model))))
        ref.set_precision(False)
    out = {}
    for side, side_answers, side_bound in sides:
        bound_gaps, grad_gaps, shortfalls = [], [], []
        for j, mu_ans, s_ans, bound_rep, gn2_rep in side_answers:
            obj = ref.InferObjective(train, g, held[j * batch:(j + 1) * batch].double(), *model)
            f_ans, g_ans = obj([mu_ans.double(), torch.log(s_ans.double())])
            bound_gaps.append(ref.rel_gap(bound_rep, -f_ans))
            gnorm = math.sqrt(sum(float(torch.sum(t * t)) for t in g_ans))
            grad_gaps.append(abs(math.sqrt(gn2_rep) - gnorm) / gnorm)
            if j not in best:
                x0 = obj.start(rm.y, mu, cfg["s0"])
                best[j] = (obj(x0)[0], ref_scg.minimize(obj, x0, opts)[1])
            f_start, f_best = best[j]
            shortfalls.append((f_ans - f_best) / (f_start - f_best))
        out[side] = {"start": rm.start_gap(start, control=side == "ctrl"),
                     "train_loss": ref.rel_gap(side_bound, bound64),
                     "infer_bound": max(bound_gaps), "infer_grad": max(grad_gaps),
                     "infer_gain": max(shortfalls)}
    return out["prog"], out.get("ctrl")
