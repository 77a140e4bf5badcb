"""Plain PyTorch reference of the data-parallel Bayesian-GPLVM fit.

The ranks of a ``torch.distributed`` process group each hold a contiguous
block of the rows and the same global leaves (Z, sf2, alpha, beta). Every
statistic of ``gplvm.py`` is a plain sum over rows, so each rank sums its
own rows' statistics in blocks, in any dtype (float64 for the reference),
and one ``all_reduce`` gives every rank the statistics of the whole N. The
bound and its cotangents follow from those on every rank alike; each rank
then carries them back through its own rows (``gplvm._latent_sweep``),
which gives its latents' gradient, and the row sweeps' part of the global
leaves' gradient is summed over the ranks, the bound's direct part counted
once. Dot products and norms over leaves count the global leaves once and
the latents of every rank. Nothing here comes from the program under test.

``start_gap`` judges the start that ``gparml_tpu_torch``'s ``-p remote``
makes: each rank's latents are the whitened principal components of its own
rows (``init.start_gap`` on them) and the global leaves are rank 0's, their
beta 10 / var of rank 0's rows.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from portbench.reference import gplvm as ref
from portbench.reference import init as ref_init

# the global leaves (z, u_sf2, u_alpha, u_beta) lead every leaf list
N_GLOBAL = 4


def _sum(t: torch.Tensor, op=None) -> torch.Tensor:
    """``t`` reduced over the ranks (a sum unless ``op``), in place."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM if op is None else op)
    return t


def max_over_ranks(x: float) -> float:
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return float(_sum(torch.tensor([x], dtype=torch.float64, device=device),
                      dist.ReduceOp.MAX).item())


def stats(y, mu, u_s, g: ref.Globals, cells) -> ref.Stats:
    """The statistics of the whole N: this rank's rows', in blocks, summed
    over the ranks."""
    local = ref.stats(y, mu, u_s, g, cells)
    flat = torch.cat([local.psi0.reshape(1), local.psi1_y.reshape(-1), local.cells,
                      local.yy.reshape(1), local.kl.reshape(1),
                      torch.tensor([local.n], dtype=y.dtype, device=y.device)])
    flat = _sum(flat)
    m_d = local.psi1_y.numel()
    c = local.cells.numel()
    return ref.Stats(flat[0], flat[1:1 + m_d].reshape(local.psi1_y.shape),
                     flat[1 + m_d:1 + m_d + c], flat[1 + m_d + c], flat[2 + m_d + c],
                     float(flat[3 + m_d + c]))


def value(y, mu, u_s, g: ref.Globals, d: int, jitter: float, psi2_eps=None) -> float:
    """F of the whole N at (this rank's mu and u_s, g)."""
    cells = ref.cells_of(g.z.shape[0], y.device)
    return float(ref.bound(stats(y, mu, u_s, g, cells), g, cells, d, jitter, psi2_eps))


def value_and_grad(y, mu, u_s, g: ref.Globals, d: int, jitter: float, psi2_eps=None):
    """(-F of the whole N, gradient of -F): the global leaves' gradient
    (every rank alike), then this rank's latents' (mu, u_s rows)."""
    cells = ref.cells_of(g.z.shape[0], y.device)
    st = stats(y, mu, u_s, g, cells)
    f, gc, gp1y, gglob = ref._cotangents(st, g, cells, d, jitter, psi2_eps, True)
    dmu, dus, gpsi = ref._latent_sweep(y, mu, u_s, g, cells, gc, gp1y, True)
    gpsi = [_sum(t.clone()) for t in gpsi]
    glob = [gglob[0] + gpsi[0], gglob[1] + gpsi[1], gglob[2] + gpsi[2], gglob[3]]
    return -float(f), [-t for t in glob] + [-dmu, -dus]


def dot(a, b) -> float:
    """Sum over leaves of a . b, the global leaves once, the latents of
    every rank."""
    first = dist.get_rank() == 0
    local = sum(torch.sum(x * y) for i, (x, y) in enumerate(zip(a, b))
                if i >= N_GLOBAL or first)
    return float(_sum(torch.as_tensor(local, dtype=torch.float64).reshape(1).clone()).item())


def norms(leaves) -> list:
    """Each leaf's norm over the whole N, as a 0-d float64 tensor: the
    global leaves' own, the latents' over every rank's rows."""
    sq = torch.stack([torch.sum(t.double() ** 2) for t in leaves])
    lat = _sum(sq[N_GLOBAL:].clone())
    return list(torch.sqrt(torch.cat([sq[:N_GLOBAL], lat])).cpu())


def leaf_gaps(got, want) -> float:
    """``gplvm.leaf_gaps`` of the leaves' norms over the whole N."""
    return ref.leaf_gaps(norms(got), norms(want))


def replay(vg, x0, alphas, accepted, g0=None):
    """``scg.replay`` with the dot products over the ranks (``dot``): the
    point SCG reaches from ``x0`` with a run's step sizes and acceptances,
    its directions the reference's own."""
    x, g = list(x0), (vg(x0)[1] if g0 is None else g0)
    d = [-t for t in g]
    success, mu = True, 0.0
    for i, (alpha, ok) in enumerate(zip(alphas, accepted)):
        if success:
            mu = dot(d, g)
            if mu >= 0:
                d = [-t for t in g]
                mu = dot(d, g)
        success = bool(ok)
        if not success:
            continue
        x = [xi + float(alpha) * di for xi, di in zip(x, d)]
        if i == len(alphas) - 1:
            break
        g_old, g = g, vg(x)[1]
        gamma = (dot(g_old, g) - dot(g, g)) / mu
        d = [gamma * di - gi for di, gi in zip(d, g)]
    return x


def start_gap(y64, mu, u_s, g: ref.Globals, s0: float) -> float:
    """The largest over the ranks of ``init.start_gap`` of this rank's rows
    and latents, beta judged against rank 0's rows only (every other rank
    passes the beta of its own rows, a gap of nought)."""
    u_beta = g.u_beta
    if dist.get_rank() != 0:
        u_beta = torch.tensor(math.log(10.0 / float(torch.var(y64, correction=0))),
                              dtype=torch.float64)
    return max_over_ranks(ref_init.start_gap(y64, mu, u_s, g.u_sf2, g.u_alpha, u_beta, s0))
