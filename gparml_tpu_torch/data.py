"""Synthetic demo datasets (numpy only).

Copies of ``gparml_tpu/data.py`` ``synthetic_gplvm`` and ``oil_flow_like``,
so the port can make the same data without importing the JAX package. The
partition-folder IO is not ported yet (ROADMAP.md Queue 1).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def synthetic_gplvm(
    n: int = 1000,
    d: int = 12,
    q_true: int = 2,
    noise_std: float = 0.1,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Nonlinear low-dimensional manifold embedded in D dims; returns
    (Y standardized, true latents)."""
    rng = np.random.default_rng(seed)
    t = rng.standard_normal((n, q_true))
    w1 = rng.standard_normal((q_true, 2 * d))
    w2 = rng.standard_normal((2 * d, d)) / np.sqrt(2 * d)
    y = np.tanh(t @ w1) @ w2 + noise_std * rng.standard_normal((n, d))
    y = (y - y.mean(0)) / y.std(0)
    return y, t


def oil_flow_like(
    n: int = 1000, d: int = 12, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Stand-in for the 3-phase oil-flow dataset (N=1000, D=12, 3 classes):
    three well-separated nonlinear 2-D clusters lifted to D dims."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 3, size=n)
    centers = np.array([[2.0, 0.0], [-1.0, 1.7], [-1.0, -1.7]])
    t = centers[labels] + 0.45 * rng.standard_normal((n, 2))
    lift = rng.standard_normal((2, d))
    bend = rng.standard_normal((2, d))
    y = t @ lift + np.sin(t) @ bend + 0.08 * rng.standard_normal((n, d))
    y = (y - y.mean(0)) / y.std(0)
    return y, labels
