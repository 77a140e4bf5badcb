"""The start of a fit, worked out and judged by its definition.

A GPLVM fit starts from the whitened principal components of Y (the top Q
eigenvectors of its covariance, each component scaled to unit variance),
variances s0, sf2 = 1, alpha = 1, beta = 10 / var(Y), and inducing inputs
picked by farthest-point sampling of those latents plus a jitter of 1e-2 of
each latent column's spread. The components are defined up to sign, and up
to a rotation where eigenvalues (nearly) coincide, and the farthest points
up to near ties, so a start is judged by what defines it: ``start_gap`` is the largest of
the hyperparameters' relative gaps, the latents' departure from whiteness
(max |mu^T mu / N - I|) times lambda_Q / lambda_1, and their residual
outside the span of the top Q components (|mu - P mu| / |mu|) times
(lambda_Q - lambda_Q+1) / lambda_1: the covariance error, relative to its
largest eigenvalue, that would move them so. Unscaled, both grow with the
data's own conditioning (1 / lambda_Q and 1 / the gap past it), and sound
float32 starts read from 2e-4 to 3e-3 over seeds.
"""

from __future__ import annotations

import math

import torch


def pca(y: torch.Tensor, q: int) -> torch.Tensor:
    """Whitened top-q principal components of y (N, D)."""
    yc = y - y.mean(0, keepdim=True)
    evals, evecs = torch.linalg.eigh((yc.T @ yc) / y.shape[0])
    top, vals = torch.flip(evecs[:, -q:], [1]), torch.flip(evals[-q:], [0])
    return (yc @ top) / torch.sqrt(torch.clamp(vals, min=1e-12))


def start_gap(y64, mu, u_s, u_sf2, u_alpha, u_beta, s0: float) -> float:
    """The start's gap from its definition (see the module text); every
    argument float64 rows, mu and u_s (N, Q)."""
    n, q = mu.shape
    gaps = [float(torch.max(torch.abs(torch.exp(u_s) - s0))) / s0,
            abs(math.exp(float(u_sf2)) - 1.0),
            float(torch.max(torch.abs(torch.exp(u_alpha) - 1.0))),
            abs(math.exp(float(u_beta)) * float(torch.var(y64, correction=0)) / 10.0 - 1.0)]
    yc = y64 - y64.mean(0, keepdim=True)
    evals, evecs = torch.linalg.eigh((yc.T @ yc) / n)
    evals = torch.flip(evals, [0])
    top = evals[0]
    ref = (yc @ torch.flip(evecs[:, -q:], [1])) / torch.sqrt(evals[:q])
    eye = torch.eye(q, dtype=mu.dtype, device=mu.device)
    white = float(torch.max(torch.abs((mu.T @ mu) / n - eye)))
    coef = (ref.T @ mu) / n          # ref is white: its projection is ref (ref^T mu) / N
    outside = float(torch.linalg.norm(mu - ref @ coef) / torch.linalg.norm(mu))
    # a covariance off by delta (relative to its largest eigenvalue) moves the
    # whitened latents by delta / (the smallest kept eigenvalue) and turns
    # their span by delta / (the gap past it): scaled back, both read the
    # covariance's own error, whatever the data's spectrum
    gap = evals[q - 1] - (evals[q] if q < evals.shape[0] else 0.0)
    gaps += [white * float(evals[q - 1] / top), outside * float(gap / top)]
    return max(gaps)
