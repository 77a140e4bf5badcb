"""Collapsed variational lower bound (Titsias 2009 / Titsias & Lawrence 2010).

Counterpart of ``gparml_tpu/ops/bound.py`` ``bound_from_stats``: the O(M^3)
terms (Cholesky of K_MM, triangular solves, log-dets, traces) from the
summed sufficient statistics. With A = K_MM + beta * Psi2:

  F = -(ND/2) log 2pi + (ND/2) log beta + (D/2) log|K_MM| - (D/2) log|A|
      - (beta/2) sum_n y_n^T y_n - (beta D/2) psi0 + (beta D/2) tr(K_MM^-1 Psi2)
      + (beta^2/2) tr(A^-1 (Psi1^T Y)(Psi1^T Y)^T) - KL(q(X)||p(X))

float64 uses the B-form (B = I + beta Lm^-1 Psi2 Lm^-T); float32 uses the
PSD-by-construction form with the trace and quad clamps. ``posterior``,
``predict`` and ``predict_uncertain`` give the collapsed q(u) and the
predictive distribution at certain and at uncertain inputs; they are plain
tensor algebra (cuBLAS / cuSOLVER on the card), outside any kernel.
"""

from __future__ import annotations

import torch

from gparml_tpu_torch.ops import ard_rbf
from gparml_tpu_torch.ops import psi as psi_ops
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


def _jitter_scale(psi2: torch.Tensor) -> torch.Tensor:
    """The rung of ``_chol_psi2``'s jitter, as a scalar without gradient:
    30, or 3000 where the Cholesky of Psi2 + 30*eps*tr(Psi2) I fails."""
    eps = torch.finfo(psi2.dtype).eps
    with torch.no_grad():
        tr = torch.trace(psi2)
        eye = torch.eye(psi2.shape[0], dtype=psi2.dtype, device=psi2.device)
        probe, info = torch.linalg.cholesky_ex(psi2 + (30.0 * eps * tr) * eye)
        ok = (info == 0) & torch.all(torch.isfinite(probe))
        return torch.where(ok, 30.0, 3000.0).to(psi2.dtype)


def _chol_psi2(psi2: torch.Tensor) -> torch.Tensor:
    """float32 Cholesky of the PSD-in-exact-arithmetic Psi2 with a
    scale-aware jitter: 30*eps*tr(Psi2), or 3000*eps*tr where that first
    rung fails. The probe runs without gradient and only the jitter SCALAR is
    selected, so a failed rung's NaN never enters the autograd graph; one
    differentiable Cholesky runs."""
    eps = torch.finfo(psi2.dtype).eps
    eye = torch.eye(psi2.shape[0], dtype=psi2.dtype, device=psi2.device)
    return _cholesky(psi2 + (_jitter_scale(psi2) * eps * torch.trace(psi2)) * eye)


def _b_factor(stats: SufficientStats, lm: torch.Tensor, beta):
    """(Cholesky factor of B = I + beta Lm^-1 Psi2 Lm^-T, tr(K_MM^-1 Psi2)).
    float64 forms B from C2 = Lm^-1 Psi2 Lm^-T; float32 from C2 = W W^T
    with W = Lm^-1 Lp (Lp the Cholesky factor of Psi2), PSD by
    construction, so chol(B) cannot fail."""
    eye = torch.eye(lm.shape[0], dtype=lm.dtype, device=lm.device)
    if stats.psi2.dtype == torch.float64:
        c2 = _solve_lower(lm, _solve_lower(lm, stats.psi2).T)
        return _cholesky(eye + beta * 0.5 * (c2 + c2.T)), torch.trace(c2)
    w = _solve_lower(lm, _chol_psi2(stats.psi2))
    return _cholesky(eye + beta * (w @ w.T)), torch.sum(w * w)


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
    dtype = stats.psi2.dtype
    n_f = stats.n
    lm = _cholesky(ard_rbf.kmm(z, sf2, alpha, jitter=jitter))
    lb, tr_kinv_psi2 = _b_factor(stats, lm, beta)
    if dtype != torch.float64:
        # the exact inequality tr(K_MM^-1 Psi2) <= psi0, so an optimizer
        # cannot mine float32 overshoot
        tr_kinv_psi2 = torch.minimum(tr_kinv_psi2, stats.psi0)
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


def posterior(stats: SufficientStats, z, sf2, alpha, beta, jitter: float = 1e-6):
    """Collapsed optimal q(u) pieces for prediction: (lm, lb, a_inv_psi1y)
    with A^-1 Psi1^T Y = Lm^-T B^-1 Lm^-1 Psi1^T Y; the predictive mean at
    X* is beta * K_{*M} (A^-1 Psi1^T Y)."""
    lm = _cholesky(ard_rbf.kmm(z, sf2, alpha, jitter=jitter))
    lb, _ = _b_factor(stats, lm, beta)
    cb = torch.cholesky_solve(_solve_lower(lm, stats.psi1_y), lb)
    a_inv_psi1y = torch.linalg.solve_triangular(lm.T, cb, upper=True)
    return lm, lb, a_inv_psi1y


def predict(x_star, stats: SufficientStats, z, sf2, alpha, beta, jitter: float = 1e-6):
    """Predictive mean and (diagonal, latent-f + noise) variance at X*:

      mean(x*) = beta K_{*M} A^-1 Psi1^T Y
      var(x*)  = k(x*,x*) - K_{*M} (K_MM^-1 - A^-1) K_{M*} + 1/beta
    """
    lm, lb, a_inv_psi1y = posterior(stats, z, sf2, alpha, beta, jitter=jitter)
    ksm = ard_rbf.k(x_star, z, sf2, alpha)
    mean = beta * (ksm @ a_inv_psi1y)
    t1 = _solve_lower(lm, ksm.T)          # Lm^-1 K_{M*}
    t2 = _solve_lower(lb, t1)             # LB^-1 Lm^-1 K_{M*}
    kss = ard_rbf.k_diag(x_star, sf2)
    var_f = kss - torch.sum(t1 * t1, dim=0) + torch.sum(t2 * t2, dim=0)
    return mean, var_f + 1.0 / beta


def predict_uncertain(mu_star, s_star, stats: SufficientStats, z, sf2, alpha, beta,
                      jitter: float = 1e-6, block: int = 1024):
    """Predictive mean and variance at uncertain inputs q(x*) = N(mu*,
    diag(s*)) (the Bayesian-GPLVM reconstruction), mu* and s* (N*, Q):

      mean(y*) = beta Psi1(x*) A^-1 Psi1^T Y
      var      = sf2 - tr((K_MM^-1 - A^-1) Psi2*) + 1/beta

    The per-point traces are Frobenius products against K_MM^-1 and A^-1,
    both formed once; they are taken over blocks of ``block`` points, one
    (block, M, M) slab of Psi2* at a time, so the working set is
    O(block M^2) at any N* (1 GB in float32 at M=500, block=1024). The last
    block is padded with rows mu=0, s=1, whose traces are dropped. The
    variance is clamped at 0 before 1/beta is added.
    """
    lm, lb, a_inv_psi1y = posterior(stats, z, sf2, alpha, beta, jitter=jitter)
    p1s = psi_ops.psi1(mu_star, s_star, z, sf2, alpha)      # (N*, M)
    mean = beta * (p1s @ a_inv_psi1y)

    m = z.shape[0]
    lm_inv = _solve_lower(lm, torch.eye(m, dtype=lm.dtype, device=lm.device))
    c_k = (lm_inv.T @ lm_inv).reshape(-1)                   # K_MM^-1
    wb = _solve_lower(lb, lm_inv)                            # LB^-1 Lm^-1
    c_a = (wb.T @ wb).reshape(-1)                            # A^-1

    n_star, q = mu_star.shape
    if n_star == 0:
        return mean, torch.zeros((0,), dtype=mu_star.dtype, device=mu_star.device)
    b = max(1, min(block, n_star))
    pad = (-n_star) % b
    if pad:
        mu_star = torch.cat([mu_star, mu_star.new_zeros((pad, q))])
        s_star = torch.cat([s_star, s_star.new_ones((pad, q))])
    tr_k, tr_a = [], []
    for i in range(0, n_star + pad, b):
        log_e0, const_n, v, c = psi_ops._psi2_pieces(mu_star[i:i + b], s_star[i:i + b],
                                                     z, sf2, alpha)
        arg = torch.einsum("nq,mq,pq->nmp", c, z, z).mul_(-0.5)
        arg += v[:, :, None]
        arg += v[:, None, :]
        arg += log_e0[None]
        arg += const_n[:, None, None]
        p2 = arg.exp_().reshape(b, m * m)                    # (b, M M)
        tr_k.append(p2 @ c_k)
        tr_a.append(p2 @ c_a)
        del arg, p2
    tr_k = torch.cat(tr_k)[:n_star]
    tr_a = torch.cat(tr_a)[:n_star]
    var_f = sf2 - tr_k + tr_a
    return mean, torch.clamp(var_f, min=0.0) + 1.0 / beta
