"""Initialization helpers: PCA embedding init and inducing-point selection.

Counterpart of ``gparml_tpu/utils/init.py`` (``pca``,
``host_candidate_rows``, ``init_latents``, ``init_inducing``). Randomness
comes from a ``torch.Generator``; it gives other numbers than ``jax.random``
from the same seed, so parity tests hand both packages the same start index
(``fps_indices``). ``host_candidate_rows`` is numpy on both sides and picks
the same rows.
"""

from __future__ import annotations

import numpy as np
import torch


def pca(y: torch.Tensor, q: int) -> torch.Tensor:
    """Project Y (N, D) onto its top-q principal components, scaled to unit
    variance per retained component."""
    yc = y - torch.mean(y, dim=0, keepdim=True)
    cov = (yc.T @ yc) / y.shape[0]
    evals, evecs = torch.linalg.eigh(cov)
    # eigh returns ascending order; take the top q.
    top = torch.flip(evecs[:, -q:], dims=[1])
    top_vals = torch.flip(evals[-q:], dims=[0])
    return (yc @ top) / torch.sqrt(torch.clamp(top_vals, min=1e-12))


def host_candidate_rows(x_np, m: int, seed: int = 0, factor: int = 16,
                        floor: int = 4096):
    """Host-side (numpy) candidate subset for :func:`init_inducing`: at most
    ``max(factor*m, floor)`` rows sampled uniformly without replacement, in
    row order, so farthest-point sampling runs over a (C, Q) block instead
    of all N rows. FPS over a uniform candidate set this much larger than M
    still yields well-separated inducing points."""
    n = x_np.shape[0]
    c = min(n, max(factor * m, floor))
    if c >= n:
        return np.ascontiguousarray(x_np)
    idx = np.sort(np.random.default_rng(seed).choice(n, size=c, replace=False))
    return np.ascontiguousarray(x_np[idx])


def randn(gen: torch.Generator, shape, like: torch.Tensor) -> torch.Tensor:
    """Normal draws from ``gen`` (on its own device), moved to ``like``'s."""
    return torch.randn(shape, generator=gen, dtype=like.dtype,
                       device=gen.device).to(like.device)


def init_latents(gen: torch.Generator, y: torch.Tensor, q: int,
                 method: str = "pca", s0: float = 0.5):
    """Initial (mu, s) for the GPLVM: PCA or random projections, s = s0."""
    if method == "pca":
        mu = pca(y, q)
    elif method == "random":
        mu = randn(gen, (y.shape[0], q), y)
    else:
        raise ValueError(f"unknown init method {method!r}; options: pca, random")
    return mu, torch.full((y.shape[0], q), s0, dtype=y.dtype, device=y.device)


def fps_indices(x: torch.Tensor, m: int, i0: int) -> torch.Tensor:
    """Farthest-point sampling of m row indices of x, starting at row i0:
    each next index is the row farthest (squared distance) from all chosen
    ones, the first maximum on ties. O(N*M)."""
    idx = [torch.as_tensor(i0, device=x.device)]
    mind = torch.sum((x - x[i0]) ** 2, dim=-1)
    for _ in range(m - 1):
        i = torch.argmax(mind)
        idx.append(i)
        mind = torch.minimum(mind, torch.sum((x - x[i]) ** 2, dim=-1))
    return torch.stack(idx)


def init_inducing(gen: torch.Generator, x: torch.Tensor, m: int,
                  noise: float = 1e-2, method: str = "fps") -> torch.Tensor:
    """M inducing inputs from the data rows plus a small data-scaled jitter.
    Farthest-point sampling (default) keeps K_MM Cholesky-safe in float32;
    'random' samples rows uniformly (with replacement only when m > N)."""
    n = x.shape[0]
    if method == "random" or m > n:
        if m <= n:
            idx = torch.randperm(n, generator=gen, device=gen.device)[:m]
        else:
            idx = torch.randint(n, (m,), generator=gen, device=gen.device)
        z = x[idx.to(x.device)]
    else:
        i0 = int(torch.randint(n, (), generator=gen, device=gen.device))
        z = x[fps_indices(x, m, i0)]
    scale = noise * torch.clamp(torch.std(x, dim=0, correction=0), min=1e-6)
    return z + scale * randn(gen, z.shape, x)
