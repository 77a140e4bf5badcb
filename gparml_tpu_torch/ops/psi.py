"""Psi-statistics of the ARD-RBF kernel — the plain PyTorch engine.

Counterpart of ``gparml_tpu/ops/psi.py`` (the "xla" engine there). It is the
CPU engine of the port and the autograd oracle for the hand-written CUDA
kernels in ``psi_cuda.py``. With q(x_n) = N(mu_n, diag(s_n)):

  psi0        = sum_n <k(x_n, x_n)>           = N * sf2
  Psi1[n, m]  = sf2 * prod_q (alpha_q s_nq + 1)^(-1/2)
                    * exp(-1/2 alpha_q (mu_nq - z_mq)^2 / (alpha_q s_nq + 1))
  Psi2[m, m'] = sum_n sf2^2 * prod_q (2 alpha_q s_nq + 1)^(-1/2)
                  * exp(- alpha_q (zb_q - mu_nq)^2 / (2 alpha_q s_nq + 1)
                        - 1/4 alpha_q (z_mq - z_m'q)^2),   zb = (z_m + z_m')/2

Derivatives come from autograd. The blocked form runs the per-block body
under ``torch.utils.checkpoint`` so memory stays O(block * M^2) at any N.
``suff_stats_t`` takes the transposed (Q, N) / (D, N) storage of
GPLVMConfig(layout='qn', y_layout='dn').

With ``s=None`` (sparse GP regression: the inputs X are observed, s = 0)
the statistics collapse to kernel products, Psi1 = K_NM and Psi2 =
K_NM^T K_NM, KL = 0: plain matrix products (cuBLAS on the card), blocked
so that K_NM never exceeds one (block, M) slab.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from gparml_tpu_torch.ops import ard_rbf


class SufficientStats(NamedTuple):
    """Sufficient statistics of the bound; every field is a plain sum over
    data points n, so the decomposition is exact under any partition of N."""

    psi0: torch.Tensor     # () : sum_n <k_nn>
    psi1_y: torch.Tensor   # (M, D) : Psi1^T Y
    psi2: torch.Tensor     # (M, M) : sum_n Psi2_n
    yy: torch.Tensor       # () : sum_{n,d} Y[n,d]^2
    kl: torch.Tensor       # () : KL(q(X) || N(0, I)) partial sum
    n: torch.Tensor        # () : number of data points (constant wrt params)

    def __add__(self, other: "SufficientStats") -> "SufficientStats":
        return SufficientStats(*(a + b for a, b in zip(self, other)))


def psi1(mu: torch.Tensor, s: torch.Tensor, z: torch.Tensor, sf2, alpha) -> torch.Tensor:
    """Psi1 matrix, shape (N, M)."""
    denom = alpha * s + 1.0
    log_norm = -0.5 * torch.sum(torch.log(denom), dim=-1)
    c = alpha / denom
    cm2 = torch.sum(c * mu * mu, dim=-1)
    cmz = (c * mu) @ z.T
    cz2 = c @ (z * z).T
    quad = -0.5 * (cm2[:, None] - 2.0 * cmz + cz2)
    return sf2 * torch.exp(log_norm[:, None] + quad)


def psi2_sum(
    mu: torch.Tensor, s: torch.Tensor, z: torch.Tensor, sf2, alpha,
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """sum_n w_n * Psi2_n, shape (M, M). Materializes (N, M, M) — small N
    only; ``suff_stats(block=...)`` bounds it."""
    log_e0, const_n, v, c = _psi2_pieces(mu, s, z, sf2, alpha)
    b = torch.einsum("nq,mq,pq->nmp", c, z, z)
    log_psi2 = (
        const_n[:, None, None]
        + v[:, :, None]
        + v[:, None, :]
        - 0.5 * b
        + log_e0[None, :, :]
    )
    p2 = torch.exp(log_psi2)
    if weights is not None:
        p2 = p2 * weights[:, None, None]
    return torch.sum(p2, dim=0)


def _psi2_pieces(mu, s, z, sf2, alpha):
    """(log_e0 (M,M), const_n (N,), v (N,M), c (N,Q)) of the decomposition
      log Psi2[n,m,m'] = const_n + v_n[m] + v_n[m'] - 1/2 B_n[m,m'] + E0[m,m']
    with c = alpha / (2 alpha s + 1), B_n = sum_q c_nq z_mq z_m'q,
    E0 = -1/4 sum_q alpha_q (z_mq - z_m'q)^2 (derivation in the JAX module)."""
    den = 2.0 * alpha * s + 1.0
    c = alpha / den
    log_e0 = -0.25 * ard_rbf.sq_dist(z, z, alpha)
    const_n = (
        2.0 * torch.log(sf2)
        - 0.5 * torch.sum(torch.log(den), dim=-1)
        - torch.sum(c * mu * mu, dim=-1)
    )
    v = -0.25 * (c @ (z * z).T) + (c * mu) @ z.T
    return log_e0, const_n, v, c


def kl_qp(mu: torch.Tensor, s: torch.Tensor,
          weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """KL( prod_n N(mu_n, diag(s_n)) || N(0, I) ), a plain sum over (n, q)."""
    per_n = 0.5 * torch.sum(mu * mu + s - torch.log(s) - 1.0, dim=-1)
    if weights is not None:
        per_n = per_n * weights
    return torch.sum(per_n)


def _block_stats(y, mu, s, w, z, sf2, alpha):
    p1 = psi1(mu, s, z, sf2, alpha)
    return p1.T @ (y * w[:, None]), psi2_sum(mu, s, z, sf2, alpha, w)


def _block_stats_sgpr(y, x, w, z, sf2, alpha):
    knm = ard_rbf.k(x, z, sf2, alpha)
    knm_w = knm * torch.sqrt(w)[:, None]
    return knm.T @ (y * w[:, None]), knm_w.T @ knm_w


def suff_stats(
    y: torch.Tensor,
    mu: torch.Tensor,
    s: Optional[torch.Tensor],
    z: torch.Tensor,
    sf2,
    alpha,
    block: Optional[int] = None,
    weights: Optional[torch.Tensor] = None,
) -> SufficientStats:
    """Sufficient statistics {psi0, Psi1^T Y, sum Psi2, sum y^2, KL, n}.

    Args mirror the JAX function: y (N, D), mu/s (N, Q), z (M, Q), sf2 and
    alpha (Q,) positive tensors. ``block`` (a divisor of N) accumulates over
    N-blocks with the block body recomputed in the backward pass;
    ``weights`` (N,) make every statistic a weighted sum and ``n`` their sum.
    ``s=None`` gives the SGPR statistics of observed inputs mu = X: weights
    enter Psi1^T Y as w and Psi2 as sqrt(w) on each side of K_NM.
    """
    n = y.shape[0]
    if weights is None:
        n_f = torch.as_tensor(float(n), dtype=y.dtype, device=y.device)
        yy = torch.sum(y * y)
        w = torch.ones(n, dtype=y.dtype, device=y.device)
    else:
        n_f = torch.sum(weights)
        yy = torch.sum((y * weights[:, None]) * y)
        w = weights
    psi0 = n_f * sf2
    if s is None:
        kl = torch.zeros((), dtype=y.dtype, device=y.device)
        body, rows = _block_stats_sgpr, (y, mu, w)
    else:
        kl = kl_qp(mu, s, weights)
        body, rows = _block_stats, (y, mu, s, w)
    if block is None or block >= n:
        p1y, p2 = body(*rows, z, sf2, alpha)
        return SufficientStats(psi0, p1y, p2, yy, kl, n_f)

    if n % block != 0:
        raise ValueError(f"N={n} must be a multiple of block={block}")
    p1y = p2 = None
    for i in range(0, n, block):
        p1y_b, p2_b = checkpoint(body, *(t[i:i + block] for t in rows), z, sf2, alpha,
                                 use_reentrant=False)
        p1y = p1y_b if p1y is None else p1y + p1y_b
        p2 = p2_b if p2 is None else p2 + p2_b
    return SufficientStats(psi0, p1y, p2, yy, kl, n_f)


def suff_stats_t(
    y_t: torch.Tensor,
    mu_t: torch.Tensor,
    s_t: Optional[torch.Tensor],
    z: torch.Tensor,
    sf2,
    alpha,
    block: Optional[int] = None,
    weights: Optional[torch.Tensor] = None,
) -> SufficientStats:
    """``suff_stats`` from the transposed storage: y_t (D, N), mu_t and s_t
    (Q, N); the gradients come back in that layout.

    The JAX engine transposes one (Q, block) slab per scan step because
    XLA:TPU pads (N, small) arrays in memory. PyTorch has no such padding
    and a transpose is a view, so this hands (N, Q) / (N, D) views of the
    same storage to ``suff_stats``: each block of its blocked form slices
    columns of the (Q, N) arrays and reuses ``psi1`` / ``psi2_sum``, and no
    transposed copy exists. ``block`` must divide N. ``s_t=None`` is the
    SGPR mode, mu_t the transposed inputs X (Q, N).
    """
    return suff_stats(y_t.T, mu_t.T, None if s_t is None else s_t.T, z, sf2, alpha,
                      block=block, weights=weights)
