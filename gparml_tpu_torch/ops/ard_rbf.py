"""ARD-RBF (exponentiated quadratic) kernel.

Counterpart of ``gparml_tpu/ops/ard_rbf.py``:

    k(x, x') = sf2 * exp(-0.5 * sum_q alpha_q * (x_q - x'_q)^2)

with ``alpha_q`` the ARD precisions and ``sf2`` the signal variance.
"""

from __future__ import annotations

import torch


def sq_dist(x1: torch.Tensor, x2: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """(N1, N2) matrix of sum_q alpha_q (x1[n,q] - x2[m,q])^2."""
    ra = torch.sqrt(alpha)
    a = x1 * ra
    b = x2 * ra
    a2 = torch.sum(a * a, dim=-1)
    b2 = torch.sum(b * b, dim=-1)
    d2 = a2[:, None] + b2[None, :] - 2.0 * (a @ b.T)
    return torch.clamp(d2, min=0.0)


def k(x1: torch.Tensor, x2: torch.Tensor, sf2, alpha: torch.Tensor) -> torch.Tensor:
    """Kernel matrix K(x1, x2), shape (N1, N2)."""
    return sf2 * torch.exp(-0.5 * sq_dist(x1, x2, alpha))


def k_diag(x: torch.Tensor, sf2) -> torch.Tensor:
    """diag K(x, x) = sf2 * ones(N)."""
    return torch.ones(x.shape[0], dtype=x.dtype, device=x.device) * sf2


def kmm(z: torch.Tensor, sf2, alpha: torch.Tensor, jitter: float = 1e-6) -> torch.Tensor:
    """K(Z, Z) plus a diagonal jitter scaled by sf2 and floored at 100x the
    dtype's epsilon (1e-6 is too small for a float32 Cholesky)."""
    m = z.shape[0]
    eff = max(float(jitter), 100.0 * float(torch.finfo(z.dtype).eps))
    eye = torch.eye(m, dtype=z.dtype, device=z.device)
    return k(z, z, sf2, alpha) + (eff * sf2) * eye
