"""Bijectors between constrained (positive) and unconstrained parameters.

Counterpart of ``gparml_tpu/utils/transforms.py``: ``exp`` is the default
transform (the reference optimizes log-values of positive hypers) and
``softplus`` the better-conditioned alternative.
"""

from __future__ import annotations

import torch


class Exp:
    """y = exp(x); the reference's transform for positive hypers."""

    @staticmethod
    def forward(x):
        return torch.exp(x)

    @staticmethod
    def inverse(y):
        return torch.log(y)


class Softplus:
    """y = log(1 + exp(x)); numerically gentler near zero."""

    @staticmethod
    def forward(x):
        return torch.logaddexp(x, torch.zeros_like(x))

    @staticmethod
    def inverse(y):
        # x = log(exp(y) - 1) = y + log(1 - exp(-y)), stable for y > 0
        return y + torch.log(-torch.expm1(-y))


BIJECTORS = {"exp": Exp, "softplus": Softplus}


def get(name: str):
    try:
        return BIJECTORS[name]
    except KeyError:
        raise ValueError(f"unknown bijector {name!r}; options: {sorted(BIJECTORS)}")
