"""Stochastic variational sparse GP regression: the uncollapsed bound,
trained by Adam on minibatches.

Counterpart of ``gparml_tpu/models/svgp.py``: ``SVGPConfig``,
``SVGPParams``, ``FitResult``, ``init_params``, ``extend_for_wraparound``,
``minibatch_window``, ``_data_term``, ``_kl_qu``, ``elbo``,
``elbo_sharded``, ``fit`` (with a mesh, the sharded fit) and ``predict``.
An explicit q(u) = N(m_d, L_d L_d^T) per output dimension makes the data
term a plain sum over points, so minibatch gradients are unbiased
(Hensman, Fusi & Lawrence, UAI 2013) and a step costs O(B M^2) whatever N:

  ELBO = sum_n sum_d [ log N(y_nd | mu_nd, 1/beta) - beta/2 var_nd ]
         - sum_d KL( N(m_d, S_d) || N(0, K_MM) ),

  A = K_nm K_MM^-1,  mu_n = A_n m,  var_nd = k_nn - q_nn + [A S_d A^T]_nn.

Every piece is a small dense product or an M x M factorisation (cuBLAS and
cuSOLVER on the card, float32 without TF32 as the JAX package's
``precision="highest"``); no hand-written kernel is involved. The JAX
package runs the whole fit as one ``lax.scan``; here the steps are a host
loop (``_steps``) that never waits for the card: ``cholesky_ex`` (no info
check), window starts drawn on the host, the history kept on the device
and copied once. The random draws (one permutation of the rows and one
start a step; per shard under a mesh) come from a ``torch.Generator`` on
the host (``_draw``), so they are not ``jax.random``'s: ``_train`` takes
them as arguments, and the tests feed it the JAX package's.

X is (N, Q) and Y (N, D), or X (Q, N) and Y (D, N) under
``layout='qn'`` (single device). With a ``mesh`` (``parallel/mesh.py``),
X, Y and the padding weights split over its shards and, over a process
group, its processes; every leaf is replicated, and the gradient across
processes is ``distributed.value_and_grad``'s.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch import nn

from gparml_tpu_torch.models import params as P
from gparml_tpu_torch.ops import ard_rbf
from gparml_tpu_torch.parallel import distributed
from gparml_tpu_torch.parallel.mesh import shards_of
from gparml_tpu_torch.utils import init as init_utils

_HALF_LOG_2PI = 0.9189385332046727417803297364056176

# Above this many rows the final ELBO is an unbiased estimate from a random
# subset of 4 batches instead of the exact full-data ELBO (which costs
# O(N M^2 D)); FitResult.elbo_exact / .elbo_n say which. Read at call time.
_EXACT_ELBO_MAX_N = 65536


@dataclass(frozen=True)
class SVGPConfig:
    num_inducing: int = 50
    bijector: str = "exp"
    jitter: float = 1e-6
    batch_size: int = 1024
    layout: str = "nq"               # 'qn': x is (Q, N), y is (D, N); single
                                     # device (the mesh path owns rows)
    fixed_beta: bool = False
    fixed_z: bool = False
    fixed_hypers: bool = False


class SVGPParams(nn.Module):
    """The globals (``glob``: Z, kernel hypers, noise precision), q_mu (M, D)
    and the lower-triangular scales q_sqrt (D, M, M). ``named_parameters``
    gives ``glob.z`` ... ``glob.u_beta``, ``q_mu``, ``q_sqrt``: the JAX
    package's tree paths and leaf order."""

    def __init__(self, glob: P.GlobalParams, q_mu, q_sqrt):
        super().__init__()
        self.glob = glob
        self.q_mu = nn.Parameter(torch.as_tensor(q_mu).detach())
        self.q_sqrt = nn.Parameter(torch.as_tensor(q_sqrt).detach())

    def named_parameters(self, prefix="", recurse=True, remove_duplicate=True):
        """glob's leaves, then q_mu and q_sqrt (``nn.Module`` would yield a
        module's own parameters before its children's)."""
        dot = prefix + "." if prefix else ""
        yield from self.glob.named_parameters(dot + "glob", recurse, remove_duplicate)
        yield dot + "q_mu", self.q_mu
        yield dot + "q_sqrt", self.q_sqrt


class FitResult(NamedTuple):
    params: SVGPParams
    elbo: float
    history: np.ndarray      # (steps,) the ELBO estimate before each step
    n_evals: int
    # True: ``elbo`` is the exact full-data ELBO; False: an unbiased
    # random-subset estimate over ``elbo_n`` rows (_EXACT_ELBO_MAX_N).
    elbo_exact: bool = True
    elbo_n: int = 0


def from_leaves(leaves_: Sequence[torch.Tensor]) -> SVGPParams:
    """SVGPParams from its six leaves in ``named_parameters`` order."""
    return SVGPParams(P.GlobalParams(*leaves_[:4]), leaves_[4], leaves_[5])


class SVGPArrays(NamedTuple):
    """numpy mirror of the JAX ``SVGPParams`` pytree (same fields, same
    order)."""

    glob: P.GlobalArrays
    q_mu: np.ndarray
    q_sqrt: np.ndarray


def from_numpy(arrays, device=torch.device("cuda"), dtype=None) -> SVGPParams:
    """Port params from ``jax.tree.map(np.asarray, p)`` of a JAX SVGPParams
    (or an ``SVGPArrays``). The device rule is ``params.from_numpy``'s: the
    GPU unless ``device="cpu"``; without a GPU the default raises."""
    t = P._to_tensor(device, dtype)
    return SVGPParams(P.global_from_numpy(arrays.glob, device, dtype), t(arrays.q_mu),
                      t(arrays.q_sqrt))


def to_numpy(p: SVGPParams) -> SVGPArrays:
    """The inverse of ``from_numpy``."""
    a = lambda x: x.detach().cpu().numpy()
    return SVGPArrays(P.global_to_numpy(p.glob), a(p.q_mu), a(p.q_sqrt))


def _check_layout(config: SVGPConfig) -> None:
    if config.layout not in ("nq", "qn"):
        raise ValueError(f"layout must be 'nq' or 'qn'; got {config.layout!r}")


def init_params(gen: torch.Generator, x: torch.Tensor, y: torch.Tensor,
                config: SVGPConfig) -> SVGPParams:
    """Z from the rows of X (``init_utils.init_inducing``, ``gen`` draws the
    start), sf2 = var(Y) over all elements, alpha = 1/var(X_q), beta =
    10/var(Y), q_mu = 0 and q_sqrt = 0.1 I per output, on x's device. Under
    qn the values come from row-major copies, so both layouts start alike."""
    _check_layout(config)
    m = config.num_inducing
    if config.layout == "qn":
        x, y = x.T.contiguous(), y.T.contiguous()
    d = y.shape[1]
    z = init_utils.init_inducing(gen, x, m)
    var_y = torch.clamp(torch.var(y, correction=0), min=1e-6)
    glob = P.make_global(z, var_y, 1.0 / torch.clamp(torch.var(x, dim=0, correction=0), min=1e-6),
                         10.0 / var_y, bijector=config.bijector)
    eye = torch.eye(m, dtype=x.dtype, device=x.device)
    return SVGPParams(glob, torch.zeros((m, d), dtype=x.dtype, device=x.device),
                      0.1 * eye[None].repeat(d, 1, 1))


def extend_for_wraparound(a: torch.Tensor, b: int, axis: int = 0) -> torch.Tensor:
    """``a`` with its first ``b`` rows (along ``axis``) appended, so that a
    window of ``b`` starting anywhere in [0, n) wraps without a gather."""
    return torch.cat([a, a.narrow(axis, 0, b)], dim=axis)


def minibatch_window(a_ext: torch.Tensor, start: int, b: int, axis: int = 0) -> torch.Tensor:
    """The ``b`` rows (along ``axis``) of the extended array from ``start``.
    With ``start`` uniform in {0, ..., n-1} every one of the n rows is in
    the window with probability exactly b/n."""
    return a_ext.narrow(axis, start, b)


class _Factors(NamedTuple):
    """The constrained globals and K_MM's Cholesky factor Lm and its
    inverse, shared by the data term and the KL."""

    z: torch.Tensor
    sf2: torch.Tensor
    alpha: torch.Tensor
    beta: torch.Tensor
    lm: torch.Tensor
    lm_inv: torch.Tensor


def _factors(glob: P.GlobalParams, config: SVGPConfig) -> _Factors:
    z, sf2, alpha, beta = P.constrain(glob, config.bijector)
    kmm = ard_rbf.kmm(z, sf2, alpha, jitter=config.jitter)
    lm = torch.linalg.cholesky_ex(kmm).L
    eye = torch.eye(z.shape[0], dtype=z.dtype, device=z.device)
    # one M x M triangular inversion; everything B-sized is then a product
    lm_inv = torch.linalg.solve_triangular(lm, eye, upper=False)
    return _Factors(z, sf2, alpha, beta, lm, lm_inv)


def _moments(f: _Factors, q_mu, q_sqrt, x):
    """Mean (B, D) and latent variance (B, D) of f at the rows of x under
    q(u)."""
    knm = ard_rbf.k(x, f.z, f.sf2, f.alpha)                 # (B, M)
    a = f.lm_inv @ knm.T                                     # (M, B): Lm^-1 Kmn
    mean = a.T @ (f.lm_inv @ q_mu)                           # (B, D)
    qnn = torch.sum(a * a, dim=0)                            # (B,)
    # var from q(u): || L_d^T Lm^-T a_n ||^2 per (n, d)
    proj = torch.einsum("dmk,mb->dkb", torch.tril(q_sqrt), f.lm_inv.T @ a)  # (D, M, B)
    var_q = torch.sum(proj * proj, dim=1).T                  # (B, D)
    return mean, (ard_rbf.k_diag(x, f.sf2) - qnn)[:, None] + var_q


def _data_term_of(f: _Factors, q_mu, q_sqrt, x, y, weights):
    d = y.shape[1]
    mean, var_f = _moments(f, q_mu, q_sqrt, x)
    resid = y - mean
    per_point = (d * (-_HALF_LOG_2PI + 0.5 * torch.log(f.beta))
                 - 0.5 * f.beta * (torch.sum(resid * resid, dim=1) + torch.sum(var_f, dim=1)))
    return torch.sum(per_point if weights is None else weights * per_point)


def _kl_of(f: _Factors, q_mu, q_sqrt, d: int):
    m = f.z.shape[0]
    ls = torch.tril(q_sqrt)
    lm_inv_mu = f.lm_inv @ q_mu                                      # (M, D)
    lm_inv_ls = torch.einsum("mk,dkj->dmj", f.lm_inv, ls)
    tr = torch.sum(lm_inv_ls * lm_inv_ls)
    quad = torch.sum(lm_inv_mu * lm_inv_mu)
    diag_ls = torch.abs(torch.diagonal(ls, dim1=1, dim2=2)) + 1e-20
    logdet_s = 2.0 * torch.sum(torch.log(diag_ls))
    logdet_k = 2.0 * torch.sum(torch.log(torch.diagonal(f.lm))) * d
    return 0.5 * (tr + quad - m * d + logdet_k - logdet_s)


def _data_term(p: SVGPParams, x, y, weights, config: SVGPConfig):
    """The weighted data term over a batch of rows, x (B, Q), y (B, D):

      sum_n w_n [ D (-log sqrt(2 pi) + log(beta)/2)
                  - beta/2 (||y_n - mu_n||^2 + sum_d var_nd) ]

    (padded rows carry w = 0; ``weights=None`` is w = 1)."""
    return _data_term_of(_factors(p.glob, config), p.q_mu, p.q_sqrt, x, y, weights)


def _kl_qu(p: SVGPParams, d: int, config: SVGPConfig):
    """KL(q(u_d) || N(0, K_MM)) summed over the d outputs."""
    return _kl_of(_factors(p.glob, config), p.q_mu, p.q_sqrt, d)


def elbo(p: SVGPParams, x, y, n_total, config: SVGPConfig, weights=None):
    """Minibatch ELBO estimate from rows x (B, Q), y (B, D): the data term
    scaled by n_total / B, less the KL (one Cholesky for both)."""
    b, d = y.shape
    f = _factors(p.glob, config)
    return (n_total / b) * _data_term_of(f, p.q_mu, p.q_sqrt, x, y, weights) \
        - _kl_of(f, p.q_mu, p.q_sqrt, d)


def _shard_data_sum(f: _Factors, q_mu, q_sqrt, blocks, home):
    """The data terms of (x, y, w) row blocks, each on its own device with
    the factors and q(u) copied there, summed on ``home`` with their graph
    (the shard_map's data term and its psum within a process)."""
    total = None
    for x, y, w in blocks:
        dev = x.device
        term = _data_term_of(_Factors(*(t.to(dev) for t in f)), q_mu.to(dev), q_sqrt.to(dev),
                             x, y, w).to(home)
        total = term if total is None else total + term
    return total


def _blocks(mesh, x, y, weights):
    return list(zip(*(shards_of(mesh, a) for a in (x, y, weights))))


def elbo_sharded(p: SVGPParams, x, y, config: SVGPConfig, *, mesh, weights=None):
    """The exact full-data ELBO with (x, y, weights) split over the mesh's
    shards (``Sharded`` or (N', ...) tensors) and the parameters replicated:
    each shard's weighted data term on its device, summed on the home
    device, and over a process group's processes (a value only; the
    gradient across processes is ``fit``'s)."""
    d = y.shape[1]
    f = _factors(p.glob, config)
    data = _shard_data_sum(f, p.q_mu, p.q_sqrt, _blocks(mesh, x, y, weights), mesh.home)
    if distributed.spans_processes(mesh):
        (data,) = distributed.sum_over_processes((data,), mesh)
    return data - _kl_of(f, p.q_mu, p.q_sqrt, d)


def _draw(gen: torch.Generator, n: int, steps: int):
    """One permutation of n rows and a start in [0, n) for each step."""
    return torch.randperm(n, generator=gen), torch.randint(n, (steps,), generator=gen).tolist()


def _shard_generator(seed: int, shard: int) -> torch.Generator:
    """The generator of global shard ``shard`` (the JAX package folds the
    shard index into the key)."""
    return torch.Generator().manual_seed(
        int(np.random.SeedSequence([seed, shard]).generate_state(1)[0]))


class _Plan(NamedTuple):
    """The shuffled, wraparound-extended row blocks of a fit and its
    estimator's constants."""

    blocks: list      # [(x_ext, y_ext, w_ext or None)] per local shard
    n_ax: int         # the N axis of x_ext, y_ext: 1 under qn
    n: int            # rows per shard (n_local); all rows without a mesh
    b: int            # window rows per shard (b_local); the data term's scale is n / b
    d: int
    home: torch.device


def _plan(x, y, perms, config: SVGPConfig, mesh=None, weights=None) -> _Plan:
    n_ax = 1 if config.layout == "qn" else 0
    d = y.shape[0] if n_ax else y.shape[1]
    if mesh is None:
        n = x.shape[n_ax]
        b = min(config.batch_size, n)
        # the weights are the mesh's (as in the JAX package's plain fit)
        blocks, home = [(x, y, None)], x.device
    else:
        if config.layout == "qn":
            raise ValueError(
                "layout='qn' is the single-device large-N layout; under a mesh the "
                "data shard over (N, Q) rows: use layout='nq'")
        k = mesh.size
        n_pad = y.shape[0] * mesh.num_processes
        if n_pad % k:
            raise ValueError(f"{n_pad} rows do not split over {k} shards; pad them "
                             "(mesh.shard_data) first")
        n = n_pad // k
        b = min(max(1, min(config.batch_size, n_pad) // k), n)
        blocks, home = _blocks(mesh, x, y, weights), mesh.home
    out = []
    for block, perm in zip(blocks, perms):
        ext = [None if a is None else extend_for_wraparound(
            torch.index_select(a, n_ax if a.ndim == 2 else 0, perm.to(a.device)), b,
            axis=n_ax if a.ndim == 2 else 0) for a in block]
        out.append(tuple(ext))
    return _Plan(out, n_ax, n, b, d, home)


def _window(a_ext, start: int, plan: _Plan):
    """The batch's rows, row-major: under qn the (Q, b) window transposed
    into a contiguous (b, Q) block, so both layouts compute on the same
    bits."""
    if a_ext is None:
        return None
    if a_ext.ndim == 1:
        return minibatch_window(a_ext, start, plan.b)
    w = minibatch_window(a_ext, start, plan.b, axis=plan.n_ax)
    return w.T.contiguous() if plan.n_ax else w


def _neg_elbo_and_grad(p: SVGPParams, blocks, plan: _Plan, config: SVGPConfig, mesh):
    """(-ELBO estimate, gradient of every leaf) from the batches ``blocks``;
    over a process group in two stages (the data term's gradient summed
    over the processes, the KL's added once)."""
    leaves = list(p.parameters())
    scale = plan.n / plan.b
    if distributed.spans_processes(mesh):
        return distributed.value_and_grad(
            lambda: (_shard_data_sum(_factors(p.glob, config), p.q_mu, p.q_sqrt, blocks,
                                     plan.home),),
            lambda st: -(scale * st[0] - _kl_qu(p, plan.d, config)),
            leaves, len(leaves), mesh)
    f = _factors(p.glob, config)
    loss = -(scale * _shard_data_sum(f, p.q_mu, p.q_sqrt, blocks, plan.home)
             - _kl_of(f, p.q_mu, p.q_sqrt, plan.d))
    return loss.detach(), list(torch.autograd.grad(loss, leaves))


def _steps(p0: SVGPParams, plan: _Plan, starts, config: SVGPConfig, learning_rate: float,
           mesh=None):
    """Adam (``torch.optim.Adam`` at optax's defaults) over the windows at
    ``starts`` (one list per shard), the fixed leaves' gradients masked.
    Nothing here waits for the card. Returns (params, history on the
    device)."""
    p = from_leaves([t.detach().to(plan.home).clone() for t in p0.parameters()])
    leaves = list(p.parameters())
    opt = torch.optim.Adam(leaves, lr=learning_rate)
    mask = P.grad_mask(p.glob, fixed_beta=config.fixed_beta, fixed_z=config.fixed_z,
                       fixed_hypers=config.fixed_hypers) + [None, None]
    steps = len(starts[0])
    history = torch.empty(steps, dtype=leaves[0].dtype, device=plan.home)
    for i in range(steps):
        batches = [tuple(_window(a, s[i], plan) for a in block)
                   for block, s in zip(plan.blocks, starts)]
        loss, grads = _neg_elbo_and_grad(p, batches, plan, config, mesh)
        for leaf, g, m in zip(leaves, grads, mask):
            leaf.grad = g if m is None else g * m
        opt.step()
        history[i] = -loss
    return p, history


def _final_elbo(p: SVGPParams, plan: _Plan, config: SVGPConfig, mesh, x, y, weights, sub):
    """(ELBO, exact, rows): the exact full-data ELBO below
    _EXACT_ELBO_MAX_N rows, else the subset estimate, as the JAX package
    reports it."""
    rows = lambda a: a.T if plan.n_ax else a
    if mesh is None:
        xe, ye, _ = plan.blocks[0]
        n = plan.n
        if n <= _EXACT_ELBO_MAX_N:
            return float(elbo(p, rows(xe.narrow(plan.n_ax, 0, n)),
                              rows(ye.narrow(plan.n_ax, 0, n)), n, config)), True, n
        idx = sub.to(xe.device)
        xf, yf = (rows(torch.index_select(a.narrow(plan.n_ax, 0, n), plan.n_ax, idx))
                  for a in (xe, ye))
        return float(elbo(p, xf, yf, n, config)), idx.numel() == n, idx.numel()
    n_pad = plan.n * mesh.size
    if n_pad <= _EXACT_ELBO_MAX_N:
        return float(elbo_sharded(p, x, y, config, mesh=mesh, weights=weights)), True, n_pad
    # a prefix of each shard's shuffled rows is a uniform sample of it
    l_sub = min(plan.n, 4 * plan.b)
    f = _factors(p.glob, config)
    data = _shard_data_sum(f, p.q_mu, p.q_sqrt,
                           [tuple(None if a is None else a[:l_sub] for a in block)
                            for block in plan.blocks], plan.home)
    if distributed.spans_processes(mesh):
        (data,) = distributed.sum_over_processes((data,), mesh)
    value = (plan.n / l_sub) * data - _kl_of(f, p.q_mu, p.q_sqrt, plan.d)
    return float(value), False, l_sub * mesh.size


def _train(p0: SVGPParams, x, y, perms, starts, config: SVGPConfig,
           learning_rate: float = 1e-2, mesh=None, weights=None, sub=None) -> FitResult:
    """The fit given its random draws: ``perms`` and ``starts``, one of each
    per local shard (one without a mesh), and ``sub``, the subset of the
    permuted rows that estimates the final ELBO past _EXACT_ELBO_MAX_N rows
    (single device)."""
    plan = _plan(x, y, perms, config, mesh, weights)
    p, history = _steps(p0, plan, starts, config, learning_rate, mesh)
    with torch.no_grad():
        value, exact, n_rows = _final_elbo(p, plan, config, mesh, x, y, weights, sub)
    return FitResult(params=p, elbo=value, history=history.cpu().numpy(),
                     n_evals=len(starts[0]), elbo_exact=exact, elbo_n=n_rows)


def fit(p0: SVGPParams, x, y, config: SVGPConfig, steps: int = 1000,
        learning_rate: float = 1e-2, seed: int = 0, mesh=None, weights=None) -> FitResult:
    """Adam over minibatch ELBO estimates (the JAX package's ``key`` is
    ``seed``). The rows are permuted once; each step takes the contiguous
    wraparound window at a uniform start, so every row is in a batch with
    probability batch/N.

    With ``mesh``, (x, y, weights) are split over its shards (``Sharded``,
    from ``mesh.shard_data`` or ``distributed.shard_data_multihost``), the
    parameters replicated on its home device: each shard permutes its own
    rows and draws its own windows (its generator seeded by (seed, global
    shard index)), ``batch_size`` is the global batch split evenly, and the
    shards' data terms and their gradients are summed every step."""
    _check_layout(config)
    if mesh is None:
        n = x.shape[1 if config.layout == "qn" else 0]
        gen = torch.Generator().manual_seed(seed)
        perm, starts = _draw(gen, n, steps)
        n_sub = min(n, 4 * min(config.batch_size, n))
        sub = torch.randperm(n, generator=gen)[:n_sub] if n > _EXACT_ELBO_MAX_N else None
        return _train(p0, x, y, [perm], [starts], config, learning_rate, sub=sub)
    n_local = y.shape[0] // mesh.local_size
    first = distributed.process_index() * mesh.local_size
    draws = [_draw(_shard_generator(seed, first + i), n_local, steps)
             for i in range(mesh.local_size)]
    return _train(p0, x, y, [d[0] for d in draws], [d[1] for d in draws], config,
                  learning_rate, mesh=mesh, weights=weights)


def predict(p: SVGPParams, x_star, config: SVGPConfig):
    """Predictive mean (N*, D) and variance (N*, D), noise included, at
    x_star (N*, Q) under q(u)."""
    f = _factors(p.glob, config)
    mean, var = _moments(f, p.q_mu, p.q_sqrt, x_star)
    return mean, var + 1.0 / f.beta
