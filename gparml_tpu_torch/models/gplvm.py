"""Bayesian GPLVM (Titsias & Lawrence 2010) with variational q(X).

Counterpart of ``gparml_tpu/models/gplvm.py``: ``GPLVMConfig``,
``FitResult``, ``init_params``, ``suff_stats``, ``log_bound``,
``neg_bound_value_and_grad``, ``fit`` with SCG, Adam or GD, ``latents``,
and prediction and inference: ``predict_observed`` (at given latent
points), ``infer_latents`` (q(x*) of new observations) and ``reconstruct``
(the observations predicted from q(x*)). Latents q(x_n) = N(mu_n,
diag(s_n)) are (N, Q) leaves, or (Q, N) under ``layout='qn'``, optimized
jointly with the globals; Y is (N, D), or (D, N) under ``y_layout='dn'``.

Every function takes a ``mesh`` (``parallel/mesh.py``) and the padding
``weights`` of ``mesh.shard_data``: Y and the weights split over the
mesh's shards (``Sharded`` row blocks or tensors), the latent leaves one
(N', Q) tensor, the statistics summed over the shards and, over a process
group (``parallel/distributed.py``), over the processes, each of which
holds its own rows. There ``neg_bound_value_and_grad`` assembles the
gradient in two stages (``distributed.value_and_grad``) and SCG's scalars
are sums over the processes (``distributed.LeafReduce``). Under a mesh the
latents are (N, Q) rows: ``fit`` raises for ``layout='qn'``, as in the JAX
package.

Under a profiler, ``fit``, ``infer_latents``, the latter's set-up and each
evaluation open the spans ``utils/logging.py`` lists.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from gparml_tpu_torch.models import params as P
from gparml_tpu_torch.models.sgpr import scg_trace
from gparml_tpu_torch.ops import bound as bound_ops
from gparml_tpu_torch.ops import psi, psi_cuda
from gparml_tpu_torch.opt import optax_adapter, scg
from gparml_tpu_torch.parallel import distributed
from gparml_tpu_torch.parallel.mesh import Sharded
from gparml_tpu_torch.parallel.stats import shard_sum, suff_stats_auto
from gparml_tpu_torch.utils import init as init_utils
from gparml_tpu_torch.utils import logging as glog
from gparml_tpu_torch.utils import transforms


@dataclass(frozen=True)
class GPLVMConfig:
    q: int = 2                       # latent dimensionality (reference -q)
    num_inducing: int = 10           # reference -m
    bijector: str = "exp"
    jitter: float = 1e-6
    block: Optional[int] = None      # N-block of the plain engine (divides N)
    stats_impl: str = "auto"         # psi engine, the JAX package's names:
                                     # 'pallas' = the hand-written CUDA
                                     # kernels (plain versions for CPU
                                     # tensors) | 'xla' = the plain PyTorch
                                     # engine | 'auto' = kernels for CUDA
                                     # tensors, plain engine for CPU tensors
    pallas_tile: int = 64            # no-op: a Pallas tiling hint
    init: str = "pca"                # reference --init {PCA, random}
    layout: str = "nq"               # latent storage: 'nq' (N, Q) | 'qn'
                                     # transposed (Q, N), single device
    y_layout: str = "nd"             # observations: 'nd' (N, D) | 'dn' (D, N)
    s0: float = 0.5                  # initial variational variance
    fixed_embeddings: bool = False   # reference --fixed_embeddings
    fixed_beta: bool = False         # reference --fixed_beta
    fixed_z: bool = False
    fixed_hypers: bool = False
    scg_mode: str = "auto"           # no-op: 'fused' | 'stepped' | 'auto'
                                     # chose a TPU program shape; the port's
                                     # SCG is always one host loop


class FitResult(NamedTuple):
    params: P.GPLVMParams
    bound: float
    history: np.ndarray           # per-iteration bound (SCG: nan past the end;
                                  # Adam/GD: before each step)
    n_evals: int
    trace: Optional[dict] = None  # SCG per-iteration {bound, gnorm2, lambda, alpha, accepted}


def _check_config(config: GPLVMConfig) -> None:
    if config.layout not in ("nq", "qn") or config.y_layout not in ("nd", "dn"):
        raise ValueError(
            f"layout must be 'nq' or 'qn' and y_layout 'nd' or 'dn'; got "
            f"{config.layout!r}, {config.y_layout!r}")
    if config.stats_impl not in ("auto", "xla", "pallas"):
        raise ValueError(f"unknown stats impl {config.stats_impl!r}; "
                         "options: auto, xla, pallas")
    if config.scg_mode not in ("auto", "fused", "stepped"):
        raise ValueError(
            f"scg_mode must be 'fused', 'stepped' or 'auto'; got {config.scg_mode!r}")


def init_params(
    gen: torch.Generator,
    y: torch.Tensor,
    config: GPLVMConfig,
    sf2: float = 1.0,
    alpha=None,
    beta: Optional[float] = None,
) -> P.GPLVMParams:
    """PCA (or random) latent init; Z by farthest-point sampling of the
    initialized latents; hypers default to sf2=1, alpha=1, beta=10/var(Y).
    ``gen`` draws the random parts; the params live on y's device. Y is
    (D, N) under ``y_layout='dn'``."""
    _check_config(config)
    if alpha is None:
        alpha = torch.ones(config.q, dtype=y.dtype, device=y.device)
    if beta is None:
        beta = 10.0 / torch.clamp(torch.var(y, correction=0), min=1e-6)
    if config.layout == "qn" and config.y_layout == "dn" and config.init == "random":
        # (Q, N)-native init: random latents are N(0, 1), so Z is drawn from
        # that distribution directly and no (N, Q) array is made.
        n = y.shape[1]
        mu_t = init_utils.randn(gen, (config.q, n), y)
        z = init_utils.randn(gen, (config.num_inducing, config.q), y)
        z = z + 1e-2 * init_utils.randn(gen, z.shape, y)
        glob = P.make_global(z, sf2, alpha, beta, bijector=config.bijector)
        s_t = torch.full_like(mu_t, config.s0)
        u_s_t = transforms.get(config.bijector).inverse(s_t)
        return P.GPLVMParams(glob=glob, lat=P.LatentParams(mu=mu_t, u_s=u_s_t))
    if config.y_layout == "dn":
        y = y.T   # a view: PCA and FPS read rows
    mu, s = init_utils.init_latents(gen, y, config.q, method=config.init, s0=config.s0)
    z = init_utils.init_inducing(gen, mu, config.num_inducing)
    glob = P.make_global(z, sf2, alpha, beta, bijector=config.bijector)
    lat = P.make_latents(mu, s, bijector=config.bijector, layout=config.layout)
    return P.GPLVMParams(glob=glob, lat=lat)


def _d_of(y, config: GPLVMConfig) -> int:
    return y.shape[0] if config.y_layout == "dn" else y.shape[1]


def _qn_native(config: GPLVMConfig, mesh, cuda: bool) -> bool:
    """The (Q, N)-layout kernel route: qn storage, no mesh, and the
    'pallas' engine ('auto' resolves to it for CUDA tensors, as in
    ``parallel.stats``). On CUDA tensors the kernels take every Q, M and D,
    as in nq: up to Q = 64 one Psi2 forward sweep, which also forms the
    cell sums that dZ takes where dZ is wanted; past it the K-chunked
    kernels. Other qn configurations take the plain transposed engine
    ``psi.suff_stats_t``."""
    if config.layout != "qn" or mesh is not None:
        return False
    impl = config.stats_impl
    if impl == "auto":
        impl = "pallas" if cuda else "xla"
    return impl == "pallas"


def _stats(p: P.GPLVMParams, y, config: GPLVMConfig, mesh=None, weights=None,
           across_processes=True):
    """The statistics; ``across_processes=False`` keeps a process group's
    mesh to this process's shards, with their graph."""
    _check_config(config)
    z, sf2, alpha, _ = P.constrain(p.glob, config.bijector)
    if config.layout == "qn" and mesh is None:
        mu_t, s_t = P.constrain_latents(p.lat, config.bijector, "qn", native=True)
        # the kernels take a contiguous (D, N) Y: one copy when Y is (N, D)
        y_t = y if config.y_layout == "dn" else y.T.contiguous()
        engine = (psi_cuda.suff_stats_t if _qn_native(config, mesh, y.is_cuda)
                  else psi.suff_stats_t)
        return engine(y_t, mu_t, s_t, z, sf2, alpha, block=config.block,
                      weights=weights)
    mu, s = P.constrain_latents(p.lat, config.bijector, config.layout)
    if isinstance(y, Sharded) and config.y_layout == "dn":
        raise ValueError("a Sharded Y holds (N, D) row blocks: use y_layout='nd'")
    # the kernels take a contiguous (N, D) Y: one copy when Y is (D, N)
    y_nd = y.T.contiguous() if config.y_layout == "dn" else y
    if mesh is not None and not across_processes:
        return shard_sum(y_nd, mu, s, z, sf2, alpha, mesh=mesh, block=config.block,
                         weights=weights, impl=config.stats_impl)
    return suff_stats_auto(
        y_nd, mu, s, z, sf2, alpha, mesh=mesh, block=config.block,
        weights=weights, impl=config.stats_impl,
    )


def suff_stats(p: P.GPLVMParams, y, config: GPLVMConfig, mesh=None,
               weights=None) -> psi.SufficientStats:
    return _stats(p, y, config, mesh=mesh, weights=weights)


def log_bound(p: P.GPLVMParams, y, config: GPLVMConfig, mesh=None,
              weights=None) -> torch.Tensor:
    """Evidence lower bound."""
    z, sf2, alpha, beta = P.constrain(p.glob, config.bijector)
    stats = _stats(p, y, config, mesh=mesh, weights=weights)
    return bound_ops.bound_from_stats(
        stats, z, sf2, alpha, beta, d=_d_of(y, config), jitter=config.jitter)


def neg_bound_value_and_grad(p: P.GPLVMParams, y, config: GPLVMConfig,
                             mask=None, mesh=None, weights=None):
    """(-bound, gradient leaves in ``named_parameters`` order). Over a
    process group's mesh the gradient is assembled in two stages
    (``distributed.value_and_grad``): the four global leaves are
    replicated, the latents hold this process's rows."""
    leaves = list(p.parameters())
    with glog.span("gparml.eval"):
        if distributed.spans_processes(mesh):
            def objective(st):
                z, sf2, alpha, beta = P.constrain(p.glob, config.bijector)
                return -bound_ops.bound_from_stats(st, z, sf2, alpha, beta,
                                                   d=_d_of(y, config), jitter=config.jitter)

            f, grads = distributed.value_and_grad(
                lambda: _stats(p, y, config, mesh=mesh, weights=weights, across_processes=False),
                objective, leaves, 4, mesh)
        else:
            with glog.span("gparml.eval.fwd"):
                f = -log_bound(p, y, config, mesh=mesh, weights=weights)
            with glog.span("gparml.eval.bwd"):
                grads = list(torch.autograd.grad(f, leaves))
        if mask is not None:
            grads = P.apply_mask(grads, mask)
        return f.detach(), grads


def _check(p: P.GPLVMParams, y, config: GPLVMConfig):
    if y.ndim != 2:
        raise ValueError(f"Y must be 2-D; got {tuple(y.shape)}")
    if config.layout == "qn":
        q, n = p.lat.mu.shape
    else:
        n, q = p.lat.mu.shape
    y_n = y.shape[1] if config.y_layout == "dn" else y.shape[0]
    if y_n != n:
        raise ValueError(
            f"Y has N={y_n} (layout {config.y_layout!r}) but latents have N={n}")
    if q != config.q:
        raise ValueError(f"latents have Q={q} but config.q={config.q}")
    if tuple(p.glob.z.shape) != (config.num_inducing, config.q):
        raise ValueError(
            f"Z has shape {tuple(p.glob.z.shape)}, expected "
            f"({config.num_inducing}, {config.q})")


def fit(
    p0: P.GPLVMParams,
    y: torch.Tensor,
    config: GPLVMConfig,
    iters: int = 100,
    optimizer: str = "scg",
    learning_rate: float = 1e-2,
    scg_options: Optional[scg.SCGOptions] = None,
    mesh=None,
    weights=None,
) -> FitResult:
    """Maximize the bound over all unmasked leaves with SCG ('scg'), Adam
    ('adam') or gradient descent ('gd', at ``learning_rate``)."""
    with glog.span("gparml.fit"):
        _check_config(config)
        _check(p0, y, config)
        if mesh is not None and config.layout == "qn":
            raise ValueError(
                "layout='qn' is the single-device large-N layout; under a mesh "
                "the latents shard over (N, Q) rows: use layout='nq'")
        if optimizer not in ("scg", "adam", "gd"):
            raise ValueError(f"unknown optimizer {optimizer!r}; options: scg, adam, gd")
        mask = P.grad_mask(
            p0,
            fixed_beta=config.fixed_beta,
            fixed_embeddings=config.fixed_embeddings,
            fixed_z=config.fixed_z,
            fixed_hypers=config.fixed_hypers,
        )

        def vg(leaves):
            return neg_bound_value_and_grad(P.from_leaves(leaves), y, config, mask,
                                            mesh=mesh, weights=weights)

        if optimizer != "scg":
            res = optax_adapter.minimize(vg, P.leaves(p0), iters, optimizer=optimizer,
                                         learning_rate=learning_rate)
            return FitResult(P.from_leaves(res.x), -res.f_now, -res.history, res.n_evals)
        st = scg.minimize(vg, P.leaves(p0), scg_options or scg.SCGOptions(max_iters=iters),
                          reduce=distributed.scg_reduce(mesh, [False] * 4 + [True] * 2))
        return FitResult(P.from_leaves(st.x), -st.f_now, -st.history.f,
                         st.n_evals, scg_trace(st))


def latents(p: P.GPLVMParams, config: GPLVMConfig):
    """The learned latent embedding (mu, s) in natural space, (N, Q) (views
    of the (Q, N) storage under layout='qn')."""
    return P.constrain_latents(p.lat, config.bijector, config.layout)


def predict_observed(p: P.GPLVMParams, y, x_star, config: GPLVMConfig, mesh=None,
                     weights=None):
    """Predictive p(y* | x*) at latent locations x_star (N*, Q): mean (N*, D)
    and variance (N*,), noise included."""
    z, sf2, alpha, beta = P.constrain(p.glob, config.bijector)
    stats = _stats(p, y, config, mesh=mesh, weights=weights)
    return bound_ops.predict(x_star, stats, z, sf2, alpha, beta, jitter=config.jitter)


# Most entries of one piece of the (N*, N) distance matrix of the
# nearest-neighbour init.
_NN_PIECE = 1 << 26


def _nearest_rows(y_new, y_train):
    """argmin_n |y_new_i - y_train_n|^2 for each row i (the first on ties),
    over pieces of the training rows, so that the (N*, N) distance matrix
    never exists whole."""
    step = max(1, _NN_PIECE // max(1, y_new.shape[0]))
    yn2 = torch.sum(y_new * y_new, dim=1)[:, None]
    best = idx = None
    for i in range(0, y_train.shape[0], step):
        part = y_train[i:i + step]
        d2 = yn2 - 2.0 * (y_new @ part.T) + torch.sum(part * part, dim=1)[None, :]
        val, arg = torch.min(d2, dim=1)
        if best is None:
            best, idx = val, arg
        else:
            closer = val < best
            best = torch.where(closer, val, best)
            idx = torch.where(closer, arg + i, idx)
    return idx


def _infer_objective(p: P.GPLVMParams, y_train, y_new, config: GPLVMConfig, mesh=None,
                     weights=None):
    """(vg, lat0) of ``infer_latents``: vg maps the new latents' leaves [mu,
    u_s] (the config's layout) to (-F, their gradient), F the collapsed
    bound of the training and the new data with every trained parameter
    held; lat0 are the leaves of the nearest-neighbour init (over a process
    group, the nearest of every process's rows)."""
    _check_config(config)
    # held: no gradient flows to the trained globals (nor the kernels' dZ)
    glob = P.GlobalParams(*(t.detach() for t in P.leaves(p.glob))).requires_grad_(False)
    z, sf2, alpha, beta = P.constrain(glob, config.bijector)
    with glog.span("gparml.infer.init"), torch.no_grad():
        stats_train = _stats(p, y_train, config, mesh=mesh, weights=weights)
        # the init runs row-major; views of (D, N) storage
        y_tr_rows = y_train.gather() if isinstance(y_train, Sharded) else (
            y_train.T if config.y_layout == "dn" else y_train)
        y_new_rows = y_new.T if config.y_layout == "dn" else y_new
        mu_tr, _ = P.constrain_latents(p.lat, config.bijector, config.layout)
        idx = _nearest_rows(y_new_rows, y_tr_rows)
        mu0 = mu_tr[idx]
        if distributed.spans_processes(mesh):
            d2 = torch.sum((y_new_rows - y_tr_rows[idx]) ** 2, dim=1)
            mu0 = distributed.nearest_over_processes(d2, mu0, mesh)
        lat0 = P.make_latents(mu0, torch.full_like(mu0, config.s0),
                              bijector=config.bijector, layout=config.layout)
    d = y_new_rows.shape[1]

    def vg(leaves):
        with glog.span("gparml.eval"):
            p_new = P.GPLVMParams(glob, P.LatentParams(*leaves))
            with glog.span("gparml.eval.fwd"):
                st = stats_train + _stats(p_new, y_new, config)
                f = -bound_ops.bound_from_stats(st, z, sf2, alpha, beta, d=d,
                                                jitter=config.jitter)
            with glog.span("gparml.eval.bwd"):
                grads = list(torch.autograd.grad(f, list(p_new.lat.parameters())))
            return f.detach(), grads

    return vg, P.leaves(lat0)


def infer_latents(
    p: P.GPLVMParams,
    y_train,
    y_new,
    config: GPLVMConfig,
    iters: int = 100,
    mesh=None,
    weights=None,
    scg_options: Optional[scg.SCGOptions] = None,
):
    """Variational latent inference for new observations y_new (N*, D), or
    (D, N*) under ``y_layout='dn'``: SCG on q(x*) = N(mu*, diag(s*))
    against the collapsed bound of the joint training and new data, every
    trained parameter held.

    The training statistics are computed once, without gradient. Each new
    point starts at the latent mean of its nearest training point in data
    space (s* = config.s0). The new points' statistics take the engine
    ``_stats`` takes for the config (the CUDA kernels for CUDA tensors under
    'auto' or 'pallas'). Returns (mu*, s*) (N*, Q) and a FitResult whose
    ``params`` are ``p`` and whose history and trace are the SCG fit's.
    """
    with glog.span("gparml.infer_latents"):
        vg, lat0 = _infer_objective(p, y_train, y_new, config, mesh=mesh, weights=weights)
        st = scg.minimize(vg, lat0, scg_options or scg.SCGOptions(max_iters=iters))
        mu_s, s_s = P.constrain_latents(P.LatentParams(*st.x), config.bijector, config.layout)
        return mu_s.detach(), s_s.detach(), FitResult(
            params=p, bound=-st.f_now, history=-st.history.f, n_evals=st.n_evals,
            trace=scg_trace(st))


def reconstruct(p: P.GPLVMParams, y_train, mu_star, s_star, config: GPLVMConfig,
                mesh=None, weights=None, block: int = 1024):
    """Predictive mean (N*, D) and variance (N*,) of y* given uncertain
    latents q(x*) = N(mu*, diag(s*)), mu* and s* (N*, Q), through the
    Psi-statistics of x*; ``block`` bounds the variance's working set to
    O(block M^2) at any N* (``bound.predict_uncertain``)."""
    z, sf2, alpha, beta = P.constrain(p.glob, config.bijector)
    stats = _stats(p, y_train, config, mesh=mesh, weights=weights)
    return bound_ops.predict_uncertain(mu_star, s_star, stats, z, sf2, alpha, beta,
                                       jitter=config.jitter, block=block)
