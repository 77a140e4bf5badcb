#!/usr/bin/env python3
"""Numerics of the tensor-core Psi2 arithmetic, on the CPU.

Runs the plain model of the Q <= 64 Psi2 kernels' arithmetic
(``gparml_tpu_torch/ops/psi_tc_model.py``: the exponent as a 3-term TF32
product in expanded form, constants added in float32, exp2) on small random
problems at every Q bucket, with the latents centred on the origin and
offset by +5 (mu and Z shifted together), and prints, per case, the largest
error of max|ref| of sum_n w_n Psi2_n and of each gradient leaf (mu, s, z,
sf2, alpha, against a random cotangent of Psi2) from the port's plain
engine in float64, for:
  * the exponent centred on zeta = mean(Z) or not (zeta = 0);
  * the backward's reductions as the kernels run them, 3-term TF32
    products of g [zb' | zb'^2 | 1] and w e [c mu' | c] over tiles of 64
    combined in float64 ("tc"), or per pair in float32 in the centred
    direct form;
and beside them the plain float32 engine's own error on the same inputs.
These are the numbers that chose the kernels' design (PERF.md).

Run from the repository root: python3 tools/psi_tc_numerics.py [--n 200 --m 40]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BUCKETS = (2, 4, 10, 16, 32, 64)


def problem(n, m, q, offset, seed=0):
    """(mu, s, z, sf2, alpha, w, dp2) as float64 numpy arrays, drawn as
    chip_smoke.parity_case draws them, the latents shifted by ``offset``."""
    import numpy as np

    rng = np.random.default_rng(seed + 100 * q + n + m)
    mu = rng.standard_normal((n, q)) + offset
    s = 0.3 + 0.5 * rng.random((n, q))
    z = rng.standard_normal((m, q)) + offset
    alpha = 0.5 + rng.random(q)
    w = np.r_[np.ones(n - n // 10), np.zeros(n // 10)]
    dp2 = rng.standard_normal((m, m))
    return mu, s, z, np.asarray(1.3), alpha, w, dp2


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


def model(mu, s, z, sf2, alpha, w, dp2, centred, form):
    import torch
    from gparml_tpu_torch.ops import psi_tc_model as tm

    t = lambda a: torch.tensor(a, dtype=torch.float32)
    zeta = None if centred else torch.zeros(z.shape[1])
    return tm.psi2_vjp(t(mu), t(s), t(z), t(sf2), t(alpha), t(w), t(dp2), zeta, form)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=200)
    ap.add_argument("--m", type=int, default=40)
    args = ap.parse_args()
    import torch

    torch.set_num_threads(4)
    cols = "psi2 dmu ds dz dsf2 dalpha".split()
    print(f"N={args.n} M={args.m}; max abs err / max|ref| vs the plain engine in float64")
    print(f"{'Q':>3} {'offset':>6} {'variant':<24}" + "".join(f"{c:>10}" for c in cols)
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
                e = errors(got, ref)
                print(f"{q:>3} {offset:>6.1f} {name:<24}" + "".join(f"{v:>10.2e}" for v in e)
                      + f"{max(e):>10.2e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
