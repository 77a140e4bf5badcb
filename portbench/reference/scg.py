"""Scaled conjugate gradients (Moller 1993), plain, on lists of tensors.

``minimize``, the reference's optimizer for latent inference, minimizes
``vg(leaves) -> (f, gradient leaves)`` for a fixed number of iterations,
with the constants of the configuration's dtype (``options_for``): the
finite-difference scale, the lambda range and the convergence tolerances
floored at that dtype's epsilon, as an SCG run at that precision takes
them. ``replay`` follows a run's directions (the negative gradient, then
each conjugate update) with the step sizes and acceptances that run
reported.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class Options(NamedTuple):
    max_iters: int
    sigma0: float
    lam0: float
    lam_min: float
    lam_max: float
    xtol: float
    ftol: float
    gtol: float


def options_for(dtype: torch.dtype, max_iters: int) -> Options:
    """SCG's defaults (sigma0 1e-4, lambda 1 in [1e-15, 1e100], xtol = ftol
    = 1e-8, gtol 1e-10) resolved for ``dtype``: tolerances at least 30
    epsilons, sigma0 at least 10 sqrt(eps), lambda inside the finite range."""
    fi = torch.finfo(dtype)
    floor = 30.0 * float(fi.eps)
    return Options(max_iters, max(1e-4, 10.0 * math.sqrt(float(fi.eps))), 1.0,
                   max(1e-15, 8.0 * float(fi.tiny)), min(1e100, float(fi.max) / 8.0),
                   max(1e-8, floor), max(1e-8, floor), 1e-10)


def _dot(a, b) -> float:
    return float(sum(torch.sum(x * y) for x, y in zip(a, b)))


def _axpy(a, x, y):
    return [yi + a * xi for xi, yi in zip(x, y)]


def minimize(vg, x0, opt: Options):
    """(x, f, iterations run, evaluations)."""
    n_params = sum(t.numel() for t in x0)
    f_now, g_new = vg(x0)
    x, f_old, g_old = list(x0), f_now, g_new
    d = [-g for g in g_new]
    lam, success, nsuccess, it, evals = opt.lam0, True, 0, 0, 1
    mu = kappa = theta = 0.0
    kappa_floor = 1e-300 if x0[0].dtype == torch.float64 else 1e-30
    while it < opt.max_iters:
        if success:
            mu = _dot(d, g_new)
            if mu >= 0:
                d = [-g for g in g_new]
                mu = _dot(d, g_new)
            kappa = max(_dot(d, d), kappa_floor)
            sigma = opt.sigma0 / math.sqrt(kappa)
            _, g_plus = vg(_axpy(sigma, d, x))
            theta = (_dot(d, g_plus) - mu) / sigma
            evals += 1
        delta = theta + lam * kappa
        if delta <= 0:
            lam = lam - theta / kappa
            delta = lam * kappa
        alpha = -mu / delta
        x_new = _axpy(alpha, d, x)
        f_new, g_cand = vg(x_new)
        evals += 1
        ratio = 2.0 * (f_new - f_old) / (alpha * mu)
        ok = ratio >= 0 and math.isfinite(f_new)
        max_d = max(float(t.abs().max()) for t in d)
        max_x = max(float(t.abs().max()) for t in x)
        if ok:
            x, f_now, nsuccess, g_old, g_new = x_new, f_new, nsuccess + 1, g_new, g_cand
        else:
            f_now = f_old
        small_step = abs(alpha) * max_d < opt.xtol * (1.0 + max_x)
        small_df = abs(f_new - f_old) < opt.ftol * (1.0 + abs(f_new))
        gg = _dot(g_new, g_new)
        done = (ok and small_step and small_df) or gg < opt.gtol
        if ok:
            f_old = f_new
        if ratio < 0.25:
            lam = min(4.0 * lam, opt.lam_max)
        if ratio > 0.75:
            lam = max(0.5 * lam, opt.lam_min)
        if not math.isfinite(f_new):
            lam = min(4.0 * lam, opt.lam_max)
        if nsuccess >= n_params:
            d = [-g for g in g_new]
            nsuccess = 0
        elif ok:
            gamma = (_dot(g_old, g_new) - gg) / mu
            d = [gamma * di - gi for di, gi in zip(d, g_new)]
        success = ok
        it += 1
        if done:
            break
    return x, f_now, it, evals


def replay(vg, x0, alphas, accepted, g0=None):
    """The point that SCG reaches from ``x0`` taking the step sizes
    ``alphas`` and acceptances ``accepted`` of a run it follows, with its
    own gradients for the directions: the first the negative gradient, each
    accepted step followed by the conjugate update (a restart where the
    direction does not descend; the periodic restart after as many successes
    as there are parameters lies beyond a run of a few iterations). The
    curvature probes, which only set the step sizes, are not made. ``g0``:
    the gradient at ``x0``, where the caller has it."""
    x, g = list(x0), (vg(x0)[1] if g0 is None else g0)
    d = [-t for t in g]
    success, mu = True, 0.0
    for i, (alpha, ok) in enumerate(zip(alphas, accepted)):
        if success:
            mu = _dot(d, g)
            if mu >= 0:
                d = [-t for t in g]
                mu = _dot(d, g)
        success = bool(ok)
        if not success:
            continue
        x = _axpy(float(alpha), d, x)
        if i == len(alphas) - 1:
            break
        g_old, g = g, vg(x)[1]
        gamma = (_dot(g_old, g) - _dot(g, g)) / mu
        d = [gamma * di - gi for di, gi in zip(d, g)]
    return x
