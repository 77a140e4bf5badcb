"""Partitioned dataset IO and synthetic demo datasets (numpy only).

Copies of ``gparml_tpu/data.py``, so the port reads and writes the same
folders and makes the same data without importing the JAX package:

  inputs/      Y_0.npy, Y_1.npy, ...        per-partition observations
  embeddings/  X_mu_0.npy, X_S_0.npy, ...   per-partition variational params

Partitions split along axis 0 with ``np.array_split`` and concatenate in
numeric order, so either package reads the other's folders.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional, Tuple

import numpy as np

_PART_RE = re.compile(r"^(?P<prefix>.+?)_?(?P<idx>\d+)\.npy$")


def _partition_files(folder: str, prefix: Optional[str] = None) -> List[str]:
    """Sorted per-partition .npy files in ``folder`` (numeric order)."""
    entries = []
    for name in os.listdir(folder):
        m = _PART_RE.match(name)
        if not m:
            continue
        if prefix is not None and not name.startswith(prefix):
            continue
        entries.append((int(m.group("idx")), name))
    if not entries:
        raise FileNotFoundError(
            f"no partition files{' with prefix ' + prefix if prefix else ''} in {folder}"
        )
    entries.sort()
    return [os.path.join(folder, name) for _, name in entries]


def load_partitioned(folder: str, prefix: Optional[str] = None) -> np.ndarray:
    """Concatenate per-partition arrays (axis 0) in numeric partition order."""
    return np.concatenate([np.load(f) for f in _partition_files(folder, prefix)], axis=0)


def save_partitioned(
    folder: str, arr: np.ndarray, n_partitions: int, prefix: str = "Y"
) -> List[str]:
    """Split ``arr`` into ~equal partitions along axis 0 and save them as
    ``<prefix>_<i>.npy``."""
    os.makedirs(folder, exist_ok=True)
    paths = []
    for i, part in enumerate(np.array_split(arr, n_partitions, axis=0)):
        path = os.path.join(folder, f"{prefix}_{i}.npy")
        np.save(path, part)
        paths.append(path)
    return paths


def partition_rows(folder: str, prefix: Optional[str] = None) -> int:
    """Total row count across partition files, from the npy headers only."""
    return sum(
        np.load(f, mmap_mode="r").shape[0] for f in _partition_files(folder, prefix)
    )


def load_rows(
    folder: str, start: int, stop: int, prefix: Optional[str] = None
) -> np.ndarray:
    """Rows [start, stop) of the concatenated partitioned array, reading only
    the files that overlap the range (mmap-sliced)."""
    files = _partition_files(folder, prefix)
    out = []
    offset = 0
    for f in files:
        arr = np.load(f, mmap_mode="r")
        n = arr.shape[0]
        lo, hi = max(start - offset, 0), min(stop - offset, n)
        if lo < hi:
            out.append(np.asarray(arr[lo:hi]))
        offset += n
        if offset >= stop:
            break
    if out:
        return np.concatenate(out, axis=0) if len(out) > 1 else out[0]
    head = np.load(files[0], mmap_mode="r")
    return np.empty((0,) + head.shape[1:], dtype=head.dtype)


def load_embeddings(folder: str) -> Tuple[np.ndarray, np.ndarray]:
    """(mu, s) from X_mu_*.npy / X_S_*.npy partition files."""
    mu = load_partitioned(folder, prefix="X_mu")
    s = load_partitioned(folder, prefix="X_S")
    if mu.shape != s.shape:
        raise ValueError(f"embeddings shape mismatch: mu {mu.shape} vs s {s.shape}")
    return mu, s


def load_embeddings_rows(
    folder: str, start: int, stop: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Rows [start, stop) of (mu, s) from the embeddings folder."""
    mu = load_rows(folder, start, stop, prefix="X_mu")
    s = load_rows(folder, start, stop, prefix="X_S")
    if mu.shape != s.shape:
        raise ValueError(f"embeddings shape mismatch: mu {mu.shape} vs s {s.shape}")
    return mu, s


def save_embeddings(
    folder: str, mu: np.ndarray, s: np.ndarray, n_partitions: int = 1
) -> None:
    save_partitioned(folder, np.asarray(mu), n_partitions, prefix="X_mu")
    save_partitioned(folder, np.asarray(s), n_partitions, prefix="X_S")


def save_embeddings_partition(
    folder: str, mu: np.ndarray, s: np.ndarray, partition: int
) -> None:
    """Write one partition's (mu, s) files."""
    os.makedirs(folder, exist_ok=True)
    np.save(os.path.join(folder, f"X_mu_{partition}.npy"), np.asarray(mu))
    np.save(os.path.join(folder, f"X_S_{partition}.npy"), np.asarray(s))


def synthetic_regression(
    n: int = 1000, noise_std: float = 0.2, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """1-D sparse-GP regression toy (BASELINE config 1 shape): (X (N, 1)
    sorted, Y (N, 1))."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-3.0, 3.0, (n, 1)), axis=0)
    y = np.sin(2.0 * x) + 0.5 * np.sin(5.0 * x) + noise_std * rng.standard_normal((n, 1))
    return x, y


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
