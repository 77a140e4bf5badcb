"""Collapsed variational lower bound (Titsias 2009 / Titsias & Lawrence 2010).

Counterpart of ``gparml_tpu/ops/bound.py`` ``bound_from_stats``: the O(M^3)
terms (Cholesky of K_MM, triangular solves, log-dets, traces) from the
summed sufficient statistics. With A = K_MM + beta * Psi2:

  F = -(ND/2) log 2pi + (ND/2) log beta + (D/2) log|K_MM| - (D/2) log|A|
      - (beta/2) sum_n y_n^T y_n - (beta D/2) psi0 + (beta D/2) tr(K_MM^-1 Psi2)
      + (beta^2/2) tr(A^-1 (Psi1^T Y)(Psi1^T Y)^T) - KL(q(X)||p(X))

float64 uses the B-form (B = I + beta Lm^-1 Psi2 Lm^-T); float32 uses the
PSD-by-construction form with the trace and quad clamps. ``posterior`` and
the ``predict*`` functions are not ported yet (ROADMAP.md Queue 1).
"""

from __future__ import annotations

import torch

from gparml_tpu_torch.ops import ard_rbf
from gparml_tpu_torch.ops.psi import SufficientStats

_HALF_LOG_2PI = 0.9189385332046727417803297364056176


def _cholesky(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor that is NaN where the factorization fails (as
    the JAX package's is) instead of raising, and that never syncs the host:
    the optimizer rejects a step whose bound is not finite."""
    lo, info = torch.linalg.cholesky_ex(a)
    return torch.where(info == 0, lo, torch.full_like(lo, float("nan")))


def _solve_lower(lo: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.solve_triangular(lo, b, upper=False)


def _chol_psi2(psi2: torch.Tensor) -> torch.Tensor:
    """float32 Cholesky of the PSD-in-exact-arithmetic Psi2 with a
    scale-aware jitter: 30*eps*tr(Psi2), or 3000*eps*tr where that first
    rung fails. The probe runs without gradient and only the jitter SCALAR is
    selected, so a failed rung's NaN never enters the autograd graph; one
    differentiable Cholesky runs."""
    m = psi2.shape[0]
    eps = torch.finfo(psi2.dtype).eps
    tr = torch.trace(psi2)
    eye = torch.eye(m, dtype=psi2.dtype, device=psi2.device)
    with torch.no_grad():
        probe, info = torch.linalg.cholesky_ex(psi2 + (30.0 * eps * tr) * eye)
        ok = (info == 0) & torch.all(torch.isfinite(probe))
        jit_scale = torch.where(ok, 30.0, 3000.0).to(psi2.dtype)
    return _cholesky(psi2 + (jit_scale * eps * tr) * eye)


def bound_from_stats(
    stats: SufficientStats,
    z: torch.Tensor,
    sf2,
    alpha,
    beta,
    d: int,
    jitter: float = 1e-6,
) -> torch.Tensor:
    """Evidence lower bound F (to be maximized) from summed statistics.

    Args:
      stats: global SufficientStats.
      z: (M, Q) inducing inputs.
      sf2, alpha, beta: kernel signal variance, ARD precisions, noise precision.
      d: output dimensionality D (stats.psi1_y is (M, D)).
      jitter: relative jitter for the K_MM Cholesky.
    """
    m = z.shape[0]
    dtype = stats.psi2.dtype
    n_f = stats.n
    eye = torch.eye(m, dtype=dtype, device=z.device)

    lm = _cholesky(ard_rbf.kmm(z, sf2, alpha, jitter=jitter))
    if dtype == torch.float64:
        tmp = _solve_lower(lm, stats.psi2)
        c2 = _solve_lower(lm, tmp.T)
        tr_kinv_psi2 = torch.trace(c2)
        b = eye + beta * 0.5 * (c2 + c2.T)
    else:
        # float32: C2 = W W^T with W = Lm^-1 Lp is PSD by construction, so
        # chol(B) cannot fail; the trace is clamped to the exact inequality
        # tr(K_MM^-1 Psi2) <= psi0 so an optimizer cannot mine f32 overshoot.
        w = _solve_lower(lm, _chol_psi2(stats.psi2))
        tr_kinv_psi2 = torch.minimum(torch.sum(w * w), stats.psi0)
        b = eye + beta * (w @ w.T)
    lb = _cholesky(b)
    log_det_b = 2.0 * torch.sum(torch.log(torch.diagonal(lb)))

    # tr(A^-1 (Psi1^T Y)(Psi1^T Y)^T) = || LB^-1 Lm^-1 Psi1^T Y ||_F^2
    cb = _solve_lower(lb, _solve_lower(lm, stats.psi1_y))
    quad = torch.sum(cb * cb)
    if dtype != torch.float64:
        # exact inequality beta^2 quad <= beta yy; same overshoot guard
        quad = torch.minimum(quad, stats.yy / beta)

    return (
        -n_f * d * _HALF_LOG_2PI
        + 0.5 * n_f * d * torch.log(beta)
        - 0.5 * d * log_det_b
        - 0.5 * beta * stats.yy
        - 0.5 * beta * d * stats.psi0
        + 0.5 * beta * d * tr_kinv_psi2
        + 0.5 * beta * beta * quad
        - stats.kl
    )
