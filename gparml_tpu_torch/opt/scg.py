"""Scaled Conjugate Gradients (Moller 1993) as one host loop.

Counterpart of ``gparml_tpu/opt/scg.py``: ``SCGOptions``, ``SCGHistory``,
``SCGState``, ``_resolve_options`` and the iteration body ``_make_body``,
run the way the JAX package's ``minimize_stepped`` runs them. The
``lax.cond`` / ``jnp.where`` selections become Python branches on host
scalars; each objective evaluation is one PyTorch value-and-gradient call
whose scalars are read back to the host. The parameter "vector" is a list
of tensors (``models/params.leaves``).

With ``trace_timing`` the loop stamps ``utils.logging.stamp_iteration``
after the first evaluation (-1) and after each iteration, whose scalars it
has read back by then, as the JAX package's io_callback stamps do.

Under a profiler (``utils.logging.span``) each iteration is a
``gparml.scg.iteration`` span, closed where its stamp is taken, and each
blocking device-to-host read of a scalar (``host_read``: the bound, each
dot product, each leaf's largest magnitude) a ``gparml.scg.read`` span. An
accepted iteration after an accepted one makes 2 evaluations and reads 5
dot products (d.g, d.d, d.g+, g.g, g_old.g; a sixth when d is no descent
direction, one fewer on a periodic restart), the bound, and each leaf's
largest magnitude in d and in x: 6 + 2 x leaves reads. An iteration after
a rejected one makes 1 evaluation and skips the first three.

Not ported: the fused ``while_loop`` form and its ``scg_mode`` choice, and
``bucket_iters`` (XLA trace-time costs).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from gparml_tpu_torch.models.params import tree_axpy, tree_dot, tree_neg
from gparml_tpu_torch.utils import logging as glog


class SCGOptions(NamedTuple):
    max_iters: int = 100
    xtol: float = 1e-8        # min relative step size before convergence declared
    ftol: float = 1e-8        # min relative |f - fold| before convergence declared
    gtol: float = 1e-10       # ||grad||^2 threshold
    sigma0: float = 1e-4      # finite-difference probe scale
    lam0: float = 1.0         # initial scale/regularization lambda
    lam_min: float = 1e-15
    lam_max: float = 1e100
    display: bool = False     # print one line per iteration
    trace_timing: bool = False  # stamp real per-iteration wall times


class SCGHistory(NamedTuple):
    """Per-iteration trace, numpy arrays of length max_iters (nan/False past
    the last executed iteration)."""

    f: np.ndarray         # objective after the iteration
    gnorm2: np.ndarray    # ||grad||^2 at the new iterate
    lam: np.ndarray       # scale/regularization lambda after adaptation
    alpha: np.ndarray     # step size along d
    accepted: np.ndarray  # bool: candidate step accepted


class SCGState(NamedTuple):
    x: list            # current parameter leaves
    f_now: float
    f_old: float
    g_new: list        # gradient at x
    g_old: list
    d: list            # search direction
    lam: float
    mu: float          # d . g
    kappa: float       # d . d
    theta: float       # curvature estimate d^T H d
    success: bool      # last step accepted
    nsuccess: int      # successes since last restart
    iteration: int
    done: bool
    n_evals: int       # objective evaluations so far
    history: SCGHistory


def _resolve_options(options: SCGOptions, dtype) -> SCGOptions:
    """Clamp lambda bounds into the objective dtype's finite range and floor
    the convergence tolerances at ~30 dtype epsilons: the absolute 1e-8
    defaults assume float64 and fire on float32 rounding noise."""
    fi = torch.finfo(dtype)
    tol_floor = 30.0 * float(fi.eps)
    return options._replace(
        lam_max=min(options.lam_max, float(fi.max) / 8.0),
        lam_min=max(options.lam_min, float(fi.tiny) * 8.0),
        xtol=max(options.xtol, tol_floor), ftol=max(options.ftol, tol_floor),
        # the curvature probe must out-scale gradient rounding noise
        sigma0=max(options.sigma0, 10.0 * float(fi.eps) ** 0.5),
    )


def host_read(t) -> np.float64:
    """The scalar tensor ``t`` on the host: one blocking read, a
    ``gparml.scg.read`` span under a profiler."""
    with glog.span("gparml.scg.read"):
        return np.float64(float(t))


class LocalReduce:
    """The loop's scalars over leaves that this process holds whole: the
    dot product and largest magnitude of leaf lists, and their element
    count. ``parallel.distributed.LeafReduce`` takes them over a process
    group's processes, the latent leaves holding each one's rows; in the
    JAX package a sharded ``vdot`` is global by itself."""

    def dot(self, a, b) -> np.float64:
        return host_read(tree_dot(a, b))

    def max_abs(self, x) -> np.float64:
        return max(host_read(torch.max(torch.abs(t))) for t in x)

    def numel(self, x) -> int:
        return sum(t.numel() for t in x)


LOCAL = LocalReduce()


def _initial_state(x0, f0, g0, options: SCGOptions) -> SCGState:
    nan = np.full(options.max_iters, np.nan)
    return SCGState(
        x=x0, f_now=f0, f_old=f0, g_new=g0, g_old=g0, d=tree_neg(g0),
        lam=np.float64(options.lam0), mu=np.float64(0.0),
        kappa=np.float64(0.0), theta=np.float64(0.0), success=True,
        nsuccess=0, iteration=0, done=False, n_evals=1,
        history=SCGHistory(f=nan, gnorm2=nan.copy(), lam=nan.copy(),
                           alpha=nan.copy(),
                           accepted=np.zeros(options.max_iters, bool)),
    )


def _step(vg: Callable, st: SCGState, options: SCGOptions, nparams: int,
          kappa_floor: float, reduce: LocalReduce) -> SCGState:
    """One SCG iteration (the JAX package's ``_make_body``); ``vg`` maps
    leaves to (f, grad leaves)."""
    d, mu, kappa, theta, n_evals = st.d, st.mu, st.kappa, st.theta, st.n_evals
    # --- (re)compute direction scalars + curvature probe on success ---
    if st.success:
        mu = reduce.dot(d, st.g_new)
        if mu >= 0:  # not a descent direction: restart
            d = tree_neg(st.g_new)
            mu = reduce.dot(d, st.g_new)
        kappa = max(reduce.dot(d, d), np.float64(kappa_floor))
        sigma = options.sigma0 / np.sqrt(kappa)
        _, g_plus = vg(tree_axpy(sigma, d, st.x))
        theta = (reduce.dot(d, g_plus) - mu) / sigma
        n_evals += 1

    # --- scale curvature: delta = theta + lam * kappa, force positive ---
    lam = st.lam
    delta = theta + lam * kappa
    if delta <= 0:
        lam = lam - theta / kappa
        delta = lam * kappa

    # --- candidate step ---
    alpha = -mu / delta
    x_new = tree_axpy(alpha, d, st.x)
    f_new, g_cand = vg(x_new)
    f_new = host_read(f_new)
    ratio = 2.0 * (f_new - st.f_old) / (alpha * mu)
    ok = bool(ratio >= 0 and np.isfinite(f_new))

    # --- accept / reject ---
    x, f_now, nsuccess, g_old, g_new = st.x, st.f_old, st.nsuccess, st.g_old, st.g_new
    if ok:
        x, f_now, nsuccess, g_old, g_new = x_new, f_new, nsuccess + 1, st.g_new, g_cand

    # convergence tests (relative to parameter and objective scale)
    small_step = abs(alpha) * reduce.max_abs(d) < options.xtol * (1.0 + reduce.max_abs(st.x))
    small_df = abs(f_new - st.f_old) < options.ftol * (1.0 + abs(f_new))
    gg = reduce.dot(g_new, g_new)
    done = bool((ok and small_step and small_df) or gg < options.gtol)
    f_old = f_new if ok else st.f_old

    # --- lambda adaptation ---
    if ratio < 0.25:
        lam = min(4.0 * lam, options.lam_max)
    if ratio > 0.75:
        lam = max(0.5 * lam, options.lam_min)
    if not np.isfinite(f_new):
        lam = min(4.0 * lam, options.lam_max)

    # --- new direction: periodic restart or Polak-Ribiere-style update ---
    if nsuccess >= nparams:
        d = tree_neg(g_new)
        nsuccess = 0
    elif ok:
        gamma = (reduce.dot(g_old, g_new) - gg) / mu
        d = [gamma * di - gi for di, gi in zip(d, g_new)]

    i = st.iteration
    h = st.history
    h.f[i], h.gnorm2[i], h.lam[i], h.alpha[i], h.accepted[i] = f_now, gg, lam, alpha, ok
    if options.display:
        print(f"SCG iter {i}: f={f_now} lambda={lam} accepted={ok}")
    return SCGState(
        x=x, f_now=f_now, f_old=f_old, g_new=g_new, g_old=g_old, d=d,
        lam=lam, mu=mu, kappa=kappa, theta=theta, success=ok,
        nsuccess=nsuccess, iteration=i + 1, done=done, n_evals=n_evals + 1,
        history=h,
    )


def minimize(
    value_and_grad_fn: Callable,
    x0: list,
    options: SCGOptions = SCGOptions(),
    reduce: LocalReduce = LOCAL,
) -> SCGState:
    """Minimize ``value_and_grad_fn`` (leaves -> (f tensor, grad leaves)).
    ``reduce`` takes the loop's scalars (``LocalReduce``).

    Returns the final SCGState; ``state.x`` are the optimized leaves and
    ``state.history`` the per-iteration trace.
    """
    with np.errstate(all="ignore"):
        nparams = reduce.numel(x0)
        f0, g0 = value_and_grad_fn(x0)
        options = _resolve_options(options, f0.dtype)
        kappa_floor = 1e-300 if f0.dtype == torch.float64 else 1e-30
        state = _initial_state(list(x0), host_read(f0), list(g0), options)
        if options.trace_timing and options.max_iters > 0:
            glog.stamp_iteration(-1)
        while state.iteration < options.max_iters and not state.done:
            with glog.span("gparml.scg.iteration"):
                state = _step(value_and_grad_fn, state, options, nparams, kappa_floor, reduce)
                if options.trace_timing:
                    glog.stamp_iteration(state.iteration - 1)
    return state
