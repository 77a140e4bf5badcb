"""The benchmark's data: ``oil_flow_like`` made on the device from the seed.

A frozen copy of ``gparml_tpu_torch/data.py`` ``oil_flow_like`` (a stand-in
for the 3-phase oil-flow data: three well-separated nonlinear 2-D clusters
lifted to D dimensions, standardized per column), written with a
``torch.Generator`` on the card instead of numpy on the host, so that
N = 1e7 rows cost no host time and no copy. It draws the same distribution
as the original, not the same numbers. Every draw happens in a few large
calls, in float64, and the result is cast to the configuration's dtype.
"""

from __future__ import annotations

import torch

CENTERS = ((2.0, 0.0), (-1.0, 1.7), (-1.0, -1.7))
SPREAD = 0.45
NOISE = 0.08


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (any integer below 2**63)."""
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def oil_flow_like(gen: torch.Generator, n: int, d: int, dtype=torch.float32) -> torch.Tensor:
    """(n, d) standardized observations drawn from ``gen`` on its device."""
    dev = gen.device
    f64 = torch.float64
    labels = torch.randint(0, len(CENTERS), (n,), generator=gen, device=dev)
    centers = torch.tensor(CENTERS, dtype=f64, device=dev)
    t = centers[labels] + SPREAD * torch.randn((n, 2), generator=gen, dtype=f64, device=dev)
    lift = torch.randn((2, d), generator=gen, dtype=f64, device=dev)
    bend = torch.randn((2, d), generator=gen, dtype=f64, device=dev)
    y = t @ lift + torch.sin(t) @ bend
    y += NOISE * torch.randn((n, d), generator=gen, dtype=f64, device=dev)
    y -= y.mean(0)
    y /= y.std(0, correction=0)
    return y.to(dtype)
