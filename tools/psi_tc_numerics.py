#!/usr/bin/env python3
"""Numerics of the tensor-core Psi2 arithmetic, on the CPU.

Runs the plain model of the Psi2 kernels' arithmetic
(``gparml_tpu_torch/ops/psi_tc_model.py``: the exponent as a 3-term TF32
product in expanded form, constants added in float32, exp2) on small random
problems at every Q bucket and past Q = 64 (K chunked, Q = 65, 100, 256 with
alpha scaled by 44/Q as chip_smoke.parity_case scales it, and Q = 100 with
the raw alpha, where Psi2 lies at and below the bottom of float32's normal
range), with the latents centred on the origin and offset by +5 (mu and Z
shifted together), and at Q = 10 with sf2 = 1e-20, where every Psi2 entry
lies below 2^-126 and the kernels' exp2 (ex2.approx.ftz, which the model
flushes as they do) would give zero without the shift; and prints, per
case, the largest
error of max|ref| of sum_n w_n Psi2_n and of each gradient leaf (mu, s, z,
sf2, alpha, against a random cotangent of Psi2) from the port's plain
engine in float64, for:
  * the exponent centred on zeta = mean(Z) or not (zeta = 0);
  * the backward's reductions as the kernels run them, 3-term TF32
    products of g [zb' | zb'^2 | 1] and w e [c mu' | c] over tiles of 64
    combined in float64 ("tc"), or per pair in float32 in the centred
    direct form;
  * the exact shift 2^S folded into the row constants or not (past Q = 64,
    at the widest bucket with the raw alpha, and at sf2 = 1e-20);
and beside them the plain float32 engine's own error on the same inputs.
These are the numbers that chose the kernels' design (PERF.md).

Run from the repository root: python3 tools/psi_tc_numerics.py [--n 200 --m 40]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BUCKETS = (2, 4, 10, 16, 32, 64)
# Past Q = 64: (Q, raw alpha); the Q <= 64 kernels' control at their
# widest bucket with the raw alpha; and (Q, sf2) of the flushed case.
WIDE = ((65, False), (100, False), (256, False), (100, True))
CONTROL = (64, True)
FLUSH_CASE = (10, 1e-20)


def problem(n, m, q, offset, seed=0, raw_alpha=False, sf2=1.3):
    """(mu, s, z, sf2, alpha, w, dp2) as float64 numpy arrays, drawn as
    chip_smoke.parity_case draws them, the latents shifted by ``offset``;
    past Q = 64 alpha is scaled by 44/Q unless ``raw_alpha``. The cotangent
    dp2 scales as 1.3 / sf2, as the bound's does (through K_MM^-1), so
    that the gradients stay in float32's normal range."""
    import numpy as np

    rng = np.random.default_rng(seed + 100 * q + n + m)
    mu = rng.standard_normal((n, q)) + offset
    s = 0.3 + 0.5 * rng.random((n, q))
    z = rng.standard_normal((m, q)) + offset
    alpha = 0.5 + rng.random(q)
    if q > 64 and not raw_alpha:
        alpha *= 44.0 / q
    w = np.r_[np.ones(n - n // 10), np.zeros(n // 10)]
    dp2 = rng.standard_normal((m, m)) * (1.3 / sf2)
    return mu, s, z, np.asarray(sf2), alpha, w, dp2


def reference(mu, s, z, sf2, alpha, w, dp2, dtype):
    """(Psi2 sum, gradient leaves) of the port's plain engine in ``dtype``."""
    import torch
    from gparml_tpu_torch.ops import psi

    xs = [torch.tensor(a, dtype=dtype).requires_grad_(True) for a in (mu, s, z, sf2, alpha)]
    p2 = psi.psi2_sum(*xs, torch.tensor(w, dtype=dtype))
    grads = torch.autograd.grad(p2, xs, grad_outputs=torch.tensor(dp2, dtype=dtype))
    return p2.detach().double(), [g.double() for g in grads]


def errors(got, ref):
    """max abs error / max|ref| of the statistic and each leaf."""
    p2, grads = got
    p2_r, grads_r = ref
    rel = lambda a, b: float((a.double() - b).abs().max() / b.abs().max().clamp_min(1e-300))
    return [rel(p2, p2_r)] + [rel(a, b) for a, b in zip(grads, grads_r)]


def model(mu, s, z, sf2, alpha, w, dp2, centred, form, shift=None):
    """The model's (Psi2 sum, gradient leaves); ``shift`` None: the kernels'
    own S, 0: none."""
    import torch
    from gparml_tpu_torch.ops import psi_tc_model as tm

    t = lambda a: torch.tensor(a, dtype=torch.float32)
    zeta = None if centred else torch.zeros(z.shape[1])
    return tm.psi2_vjp(t(mu), t(s), t(z), t(sf2), t(alpha), t(w), t(dp2), zeta, form, shift)


def _print(q, offset, name, e):
    print(f"{q:>3} {offset:>6.1f} {name:<28}" + "".join(f"{v:>10.2e}" for v in e)
          + f"{max(e):>10.2e}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=200)
    ap.add_argument("--m", type=int, default=40)
    args = ap.parse_args()
    import torch

    torch.set_num_threads(4)
    cols = "psi2 dmu ds dz dsf2 dalpha".split()
    print(f"N={args.n} M={args.m}; max abs err / max|ref| vs the plain engine in float64")
    print(f"{'Q':>3} {'offset':>6} {'variant':<28}" + "".join(f"{c:>10}" for c in cols)
          + f"{'worst':>10}")
    for q in BUCKETS:
        for offset in (0.0, 5.0):
            pr = problem(args.n, args.m, q, offset)
            ref = reference(*pr, torch.float64)
            rows = {"plain f32 engine": reference(*pr, torch.float32)}
            for centred in (True, False):
                for form in ("tc", "direct"):
                    name = f"{'zeta=mean' if centred else 'zeta=0'}, {form}"
                    rows[name] = model(*pr, centred, form)
            for name, got in rows.items():
                _print(q, offset, name, errors(got, ref))
    print("past Q = 64, K chunked, centred, tc form; alpha x 44/Q unless raw")
    for q, raw in WIDE:
        for offset in (0.0, 5.0):
            pr = problem(args.n, args.m, q, offset, raw_alpha=raw)
            ref = reference(*pr, torch.float64)
            tag = ", raw alpha" if raw else ""
            _print(q, offset, "plain f32 engine" + tag, errors(reference(*pr, torch.float32), ref))
            _print(q, offset, "shift 2^S" + tag, errors(model(*pr, True, "tc"), ref))
            _print(q, offset, "no shift" + tag, errors(model(*pr, True, "tc", shift=0), ref))
    q, raw = CONTROL
    print(f"Q = {q} (bucket 64), raw alpha, centred, tc form")
    pr = problem(args.n, args.m, q, 0.0, raw_alpha=raw)
    ref = reference(*pr, torch.float64)
    _print(q, 0.0, "plain f32 engine, raw alpha", errors(reference(*pr, torch.float32), ref))
    _print(q, 0.0, "shift 2^S, raw alpha", errors(model(*pr, True, "tc"), ref))
    _print(q, 0.0, "no shift, raw alpha", errors(model(*pr, True, "tc", shift=0), ref))
    q, sf2 = FLUSH_CASE
    print(f"Q = {q}, sf2 = {sf2:g} (every Psi2 entry below 2^-126), centred, tc form")
    pr = problem(args.n, args.m, q, 0.0, sf2=sf2)
    ref = reference(*pr, torch.float64)
    _print(q, 0.0, "plain f32 engine", errors(reference(*pr, torch.float32), ref))
    _print(q, 0.0, "shift 2^S", errors(model(*pr, True, "tc"), ref))
    _print(q, 0.0, "no shift (flushed)", errors(model(*pr, True, "tc", shift=0), ref))
    return 0


if __name__ == "__main__":
    sys.exit(main())
