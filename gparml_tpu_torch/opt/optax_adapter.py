"""First-order optimizers: Adam and plain gradient descent.

Counterpart of ``gparml_tpu/opt/optax_adapter.py``, whose ``minimize`` runs
an optax rule under ``lax.scan``. Here the rule is ``torch.optim.Adam`` or
``torch.optim.SGD`` and the loop is a host loop. At their defaults they do
what ``optax.adam`` and ``optax.sgd`` do: Adam with b1 = 0.9, b2 = 0.999,
eps = 1e-8 added to sqrt(v-hat) (optax's eps_root = 0) and bias-corrected
moments; SGD without momentum, x - lr g. Both update each element from its
own gradient, so under a process group (``parallel/distributed.py``) they
need no sum over the processes: the objective's value and the replicated
leaves' gradients already agree on every process.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

_RULES = {"adam": torch.optim.Adam, "gd": torch.optim.SGD}


class OptaxResult(NamedTuple):
    x: list               # the parameter leaves after the last step
    f_now: float          # objective at x
    history: np.ndarray   # (iters,) objective before each step
    n_evals: int


def minimize(
    value_and_grad_fn: Callable,
    x0: list,
    iters: int,
    optimizer: str = "adam",
    learning_rate: float = 1e-2,
) -> OptaxResult:
    """Run ``iters`` steps of ``optimizer`` ('adam' or 'gd') on
    ``value_and_grad_fn`` (leaves -> (f, gradient leaves))."""
    if optimizer not in _RULES:
        raise ValueError(f"unknown optimizer {optimizer!r}; options: {sorted(_RULES)}")
    xs = [torch.nn.Parameter(t.detach().clone()) for t in x0]
    rule = _RULES[optimizer](xs, lr=learning_rate)
    history = np.empty(iters)
    for i in range(iters):
        f, grads = value_and_grad_fn([x.detach() for x in xs])
        history[i] = float(f)
        for x, g in zip(xs, grads):
            x.grad = g
        rule.step()
    f_final, _ = value_and_grad_fn([x.detach() for x in xs])
    return OptaxResult(x=[x.detach() for x in xs], f_now=float(f_final),
                       history=history, n_evals=iters + 1)
