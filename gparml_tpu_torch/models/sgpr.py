"""Sparse variational GP regression (Titsias 2009): the reference's
``--fixed_embeddings`` mode.

Counterpart of ``gparml_tpu/models/sgpr.py``: ``SGPRConfig``, ``FitResult``,
``scg_trace``, ``init_params``, ``suff_stats``, ``log_bound``,
``neg_bound_value_and_grad``, ``fit`` with SCG, Adam or GD, and
``predict``. The inputs X are observed (s = 0), so the Psi-statistics
collapse to kernel products (Psi1 = K_NM, Psi2 = K_NM^T K_NM), KL(q(X))
vanishes, and the parameters are the globals alone (Z, the kernel hypers and
the noise precision). The statistics are plain matrix products in both
packages (cuBLAS on the card); no hand-written kernel is involved. X is
(N, Q) and Y (N, D), or X (Q, N) and Y (D, N) under ``layout='qn'``.
With a ``mesh`` (``parallel/mesh.py``), X, Y and the padding weights split
over its shards and, over a process group, its processes, as in
``models/gplvm.py``; every leaf is replicated.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from gparml_tpu_torch.models import params as P
from gparml_tpu_torch.ops import bound as bound_ops
from gparml_tpu_torch.ops import psi
from gparml_tpu_torch.opt import optax_adapter, scg
from gparml_tpu_torch.parallel import distributed
from gparml_tpu_torch.parallel.stats import shard_sum, suff_stats_auto
from gparml_tpu_torch.utils import init as init_utils


@dataclass(frozen=True)
class SGPRConfig:
    num_inducing: int = 10
    bijector: str = "exp"
    jitter: float = 1e-6
    block: Optional[int] = None      # N-block of the statistics (divides N)
    layout: str = "nq"               # 'qn': x is (Q, N), y is (D, N); single
                                     # device
    fixed_beta: bool = False         # reference --fixed_beta
    fixed_z: bool = False
    fixed_hypers: bool = False
    scg_mode: str = "auto"           # no-op: the port's SCG is one host loop


class FitResult(NamedTuple):
    params: P.GlobalParams
    bound: float
    history: np.ndarray           # per-iteration bound (SCG: nan past the end;
                                  # Adam/GD: before each step)
    n_evals: int
    trace: Optional[dict] = None  # SCG per-iteration {bound, gnorm2, lambda, alpha, accepted}


def scg_trace(st: scg.SCGState) -> dict:
    """Bound-sign per-iteration dict from a final SCGState (the reference's
    display columns)."""
    return {
        "bound": -st.history.f,
        "gnorm2": st.history.gnorm2,
        "lambda": st.history.lam,
        "alpha": st.history.alpha,
        "accepted": st.history.accepted,
    }


def _check_layout(config: SGPRConfig) -> None:
    if config.layout not in ("nq", "qn"):
        raise ValueError(f"layout must be 'nq' or 'qn'; got {config.layout!r}")


def init_params(
    gen: torch.Generator,
    x: torch.Tensor,
    y: torch.Tensor,
    config: SGPRConfig,
    sf2=None,
    alpha=None,
    beta=None,
) -> P.GlobalParams:
    """Data-driven defaults: Z from rows of X (farthest-point sampling from a
    random start, as ``gplvm.init_params``), sf2 = var(Y), alpha =
    1/var(X_q), beta = 10/var(Y). ``gen`` draws the random parts; the params
    live on x's device."""
    _check_layout(config)
    x_rows = x.T if config.layout == "qn" else x
    z = init_utils.init_inducing(gen, x_rows, config.num_inducing)
    var_y = torch.clamp(torch.var(y, correction=0), min=1e-6)
    if sf2 is None:
        sf2 = var_y
    if alpha is None:
        alpha = 1.0 / torch.clamp(torch.var(x_rows, dim=0, correction=0), min=1e-6)
    if beta is None:
        beta = 10.0 / var_y
    return P.make_global(z, sf2, alpha, beta, bijector=config.bijector)


def _stats(g: P.GlobalParams, x, y, config: SGPRConfig, mesh=None, weights=None,
           across_processes=True):
    """The statistics; ``across_processes=False`` keeps a process group's
    mesh to this process's shards, with their graph."""
    _check_layout(config)
    z, sf2, alpha, _ = P.constrain(g, config.bijector)
    if config.layout == "qn":
        if mesh is not None:
            raise ValueError(
                "layout='qn' is the single-device large-N layout; under a mesh "
                "the data shard over (N, Q) rows: use layout='nq'")
        return psi.suff_stats_t(y, x, None, z, sf2, alpha, block=config.block,
                                weights=weights)
    if mesh is not None and not across_processes:
        return shard_sum(y, x, None, z, sf2, alpha, mesh=mesh, block=config.block,
                         weights=weights)
    return suff_stats_auto(y, x, None, z, sf2, alpha, mesh=mesh, block=config.block,
                           weights=weights)


def suff_stats(g: P.GlobalParams, x, y, config: SGPRConfig, mesh=None,
               weights=None) -> psi.SufficientStats:
    return _stats(g, x, y, config, mesh=mesh, weights=weights)


def _d_of(y, config: SGPRConfig) -> int:
    return y.shape[0] if config.layout == "qn" else y.shape[1]


def log_bound(g: P.GlobalParams, x, y, config: SGPRConfig, mesh=None,
              weights=None) -> torch.Tensor:
    """Evidence lower bound F (to maximize)."""
    z, sf2, alpha, beta = P.constrain(g, config.bijector)
    stats = _stats(g, x, y, config, mesh=mesh, weights=weights)
    return bound_ops.bound_from_stats(stats, z, sf2, alpha, beta, d=_d_of(y, config),
                                      jitter=config.jitter)


def neg_bound_value_and_grad(g: P.GlobalParams, x, y, config: SGPRConfig, mask=None,
                             mesh=None, weights=None):
    """(-F, gradient leaves in ``named_parameters`` order, masked); over a
    process group's mesh in two stages (``distributed.value_and_grad``)."""
    leaves = list(g.parameters())
    if distributed.spans_processes(mesh):
        def objective(st):
            z, sf2, alpha, beta = P.constrain(g, config.bijector)
            return -bound_ops.bound_from_stats(st, z, sf2, alpha, beta,
                                               d=_d_of(y, config), jitter=config.jitter)

        f, grads = distributed.value_and_grad(
            lambda: _stats(g, x, y, config, mesh=mesh, weights=weights,
                           across_processes=False),
            objective, leaves, 4, mesh)
    else:
        f = -log_bound(g, x, y, config, mesh=mesh, weights=weights)
        grads = list(torch.autograd.grad(f, leaves))
    if mask is not None:
        grads = P.apply_mask(grads, mask)
    return f.detach(), grads


def fit(
    g0: P.GlobalParams,
    x: torch.Tensor,
    y: torch.Tensor,
    config: SGPRConfig,
    iters: int = 100,
    optimizer: str = "scg",
    learning_rate: float = 1e-2,
    scg_options: Optional[scg.SCGOptions] = None,
    mesh=None,
    weights=None,
) -> FitResult:
    """Maximize the bound with SCG ('scg', as the reference), Adam ('adam')
    or gradient descent ('gd', at ``learning_rate``)."""
    _check_layout(config)
    if y.ndim != 2 or x.ndim != 2:
        raise ValueError(f"X, Y must be 2-D; got {tuple(x.shape)}, {tuple(y.shape)}")
    n_ax, q_ax = (1, 0) if config.layout == "qn" else (0, 1)
    if x.shape[n_ax] != y.shape[n_ax]:
        raise ValueError(f"X has N={x.shape[n_ax]} but Y has N={y.shape[n_ax]} "
                         f"(layout {config.layout!r})")
    if g0.z.shape[1] != x.shape[q_ax]:
        raise ValueError(f"Z dim {g0.z.shape[1]} != X dim {x.shape[q_ax]}")
    if optimizer not in ("scg", "adam", "gd"):
        raise ValueError(f"unknown optimizer {optimizer!r}; options: scg, adam, gd")
    mask = P.grad_mask(g0, fixed_beta=config.fixed_beta, fixed_z=config.fixed_z,
                       fixed_hypers=config.fixed_hypers)

    def vg(leaves):
        return neg_bound_value_and_grad(P.from_leaves(leaves), x, y, config, mask,
                                        mesh=mesh, weights=weights)

    if optimizer != "scg":
        res = optax_adapter.minimize(vg, P.leaves(g0), iters, optimizer=optimizer,
                                     learning_rate=learning_rate)
        return FitResult(P.from_leaves(res.x), -res.f_now, -res.history, res.n_evals)
    st = scg.minimize(vg, P.leaves(g0), scg_options or scg.SCGOptions(max_iters=iters),
                      reduce=distributed.scg_reduce(mesh, [False] * 4))
    return FitResult(P.from_leaves(st.x), -st.f_now, -st.history.f, st.n_evals,
                     scg_trace(st))


def predict(g: P.GlobalParams, x, y, x_star, config: SGPRConfig, mesh=None, weights=None):
    """Predictive mean (N*, D) and variance (N*,), noise included, at
    x_star (N*, Q)."""
    z, sf2, alpha, beta = P.constrain(g, config.bijector)
    stats = _stats(g, x, y, config, mesh=mesh, weights=weights)
    return bound_ops.predict(x_star, stats, z, sf2, alpha, beta, jitter=config.jitter)
