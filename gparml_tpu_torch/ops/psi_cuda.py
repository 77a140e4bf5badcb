"""Fused Psi-statistics through the hand-written CUDA kernels.

Counterpart of ``gparml_tpu/ops/psi_pallas.py``: ``psi_fused`` (the
``jax.custom_vjp`` there) becomes the ``torch.autograd.Function``
``PsiFused``; ``psi_fwd`` / ``psi_bwd`` are the kernel wrappers that replace
``_call_fwd_flat`` / ``_call_bwd_flat``; ``suff_stats`` mirrors the Pallas
``suff_stats`` (psi0, yy and KL are plain tensor sums).

Dispatch is by the tensors' device and nothing else: CUDA tensors go to the
kernels (``csrc/psi_fwd.cu``, ``csrc/psi_bwd.cu``) and must be float32 and
contiguous, or the wrapper raises; CPU tensors go to the plain versions
``psi_fused_fwd_reference`` / ``psi_fused_bwd_reference`` beside them. There
is no fallback from a failed build or launch.

The TPU-only machinery (bf16 hi/lo rungs, VMEM tile ladders, per-call N
caps and chunking, M/lane padding) has no counterpart. The kernels take any
N and Q up to 64. M and D are bounded by the card's shared memory per block
(227 KB on an H100): the backward's row passes stage Z as M x QM floats
(QM the Q bucket of ``csrc/psi_common.cuh``), and the Psi1 kernels stage 32
rows of Y. On an H100 that is M <= 908 at Q > 32 and M <= 5811 at Q <= 10,
and D <= 1686 at Q > 32. The wrappers raise ValueError past these limits,
which the kernels' launch plan reports (``gparml_psi_{fwd,bwd}_plan``); the
launch geometry itself lives in the CUDA sources only.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from gparml_tpu_torch.ops import _build
from gparml_tpu_torch.ops.psi import SufficientStats, kl_qp
from gparml_tpu_torch.ops import psi as psi_plain

# Kernel launches per wrapper: each successful kernel call adds one.
LAUNCHES = {"fwd": 0, "bwd": 0}

_MAX_Q = 64


# --- plain versions ---------------------------------------------------------

def psi_fused_fwd_reference(mu, s, z, sf2, alpha, y, w, block: Optional[int] = None):
    """(Psi1^T (w Y) (M, D), sum_n w_n Psi2_n (M, M)) by the plain engine."""
    st = psi_plain.suff_stats(y, mu, s, z, sf2, alpha, block=block, weights=w)
    return st.psi1_y, st.psi2


def psi_fused_bwd_reference(mu, s, z, sf2, alpha, y, w, dp1y, dp2,
                            block: Optional[int] = None):
    """(dmu, ds, dz, dsf2, dalpha, dy): autograd of the plain forward
    against the cotangents (dp1y, dp2)."""
    with torch.enable_grad():
        xs = [t.detach().requires_grad_(True) for t in (mu, s, z, sf2, alpha, y)]
        out = psi_fused_fwd_reference(*xs[:5], xs[5], w, block=block)
        return torch.autograd.grad(out, xs, grad_outputs=(dp1y, dp2))


# --- kernel wrappers --------------------------------------------------------

def _on_cuda(tensors) -> bool:
    """True for all-CUDA inputs, False for all-CPU inputs; raises otherwise."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return True
    raise ValueError(f"inputs must all lie on the CPU or on one CUDA device; "
                     f"got {sorted({str(t.device) for t in tensors})}")


def _check_kernel_inputs(named: dict, shapes: dict) -> None:
    for name, t in named.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the CUDA kernels take float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the CUDA kernels take contiguous tensors")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shapes[name]}")


def _shapes(mu, z, y):
    n, q = mu.shape
    m, d = z.shape[0], y.shape[1]
    if q > _MAX_Q:
        raise ValueError(f"the CUDA kernels take Q <= {_MAX_Q}; got Q={q}")
    return n, m, q, d, {
        "mu": (n, q), "s": (n, q), "z": (m, q), "sf2": (), "alpha": (q,),
        "y": (n, d), "w": (n,), "p1y": (m, d), "p2": (m, m),
        "dp1y": (m, d), "dp2": (m, m),
    }


@functools.lru_cache(maxsize=64)
def _plan(n: int, m: int, q: int, d: int, device: torch.device):
    """(splits2, splits1, splits_c, splits_m): the N-splits of the forward's
    and the backward's grids, from the kernels' own launch plan. Raises
    ValueError when a block would need more shared memory than the card
    gives one."""
    lib = _build.load()
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    fwd, bwd = (ctypes.c_int * 4)(), (ctypes.c_int * 4)()
    with torch.cuda.device(device):
        _build.check(lib.gparml_psi_fwd_plan(n, m, q, d, sms, fwd), "psi_fwd_plan")
        _build.check(lib.gparml_psi_bwd_plan(n, m, q, d, sms, bwd), "psi_bwd_plan")
    need, limit = max(fwd[2], bwd[2]), fwd[3]
    if need > limit:
        raise ValueError(
            f"the CUDA kernels need {need} bytes of shared memory per block at "
            f"M={m}, Q={q}, D={d}, and this card gives {limit}: Z is staged "
            f"as M x (Q bucket) floats and 32 rows of Y as 32 x D floats; "
            f"lower M or D")
    return fwd[0], fwd[1], bwd[0], bwd[1]


def psi_fwd(mu, s, z, sf2, alpha, y, w, block: Optional[int] = None):
    """Forward wrapper: (Psi1^T (w Y), sum_n w_n Psi2_n). Launches the
    forward kernels for CUDA tensors; ``block`` applies to the plain version
    only."""
    args = dict(mu=mu, s=s, z=z, sf2=sf2, alpha=alpha, y=y, w=w)
    if not _on_cuda(args.values()):
        return psi_fused_fwd_reference(mu, s, z, sf2, alpha, y, w, block=block)
    n, m, q, d, shapes = _shapes(mu, z, y)
    _check_kernel_inputs(args, shapes)
    splits2, splits1, _, _ = _plan(n, m, q, d, mu.device)
    p2_part = torch.empty((splits2, m, m), dtype=mu.dtype, device=mu.device)
    p1y_part = torch.zeros((splits1, m, d), dtype=mu.dtype, device=mu.device)
    with torch.cuda.device(mu.device):
        rc = _build.load().gparml_psi_fwd(
            *(t.data_ptr() for t in (mu, s, y, w, z, alpha, sf2)),
            n, m, q, d, splits2, splits1, p2_part.data_ptr(), p1y_part.data_ptr(),
            torch.cuda.current_stream(mu.device).cuda_stream)
    _build.check(rc, "psi_fwd")
    LAUNCHES["fwd"] += 1
    return p1y_part.sum(0), p2_part.sum(0)


def psi_bwd(mu, s, z, sf2, alpha, y, w, p1y, p2, dp1y, dp2,
            block: Optional[int] = None):
    """Backward wrapper: (dmu, ds, dz, dsf2, dalpha, dy) from the forward's
    inputs and outputs (p1y, p2) and the cotangents (dp1y, dp2). Launches
    the backward kernels for CUDA tensors; ``block`` applies to the plain
    version only."""
    args = dict(mu=mu, s=s, z=z, sf2=sf2, alpha=alpha, y=y, w=w,
                p1y=p1y, p2=p2, dp1y=dp1y, dp2=dp2)
    if not _on_cuda(args.values()):
        return psi_fused_bwd_reference(mu, s, z, sf2, alpha, y, w, dp1y, dp2,
                                       block=block)
    n, m, q, d, shapes = _shapes(mu, z, y)
    _check_kernel_inputs(args, shapes)
    _, _, splits_c, splits_m = _plan(n, m, q, d, mu.device)
    f32 = dict(dtype=mu.dtype, device=mu.device)
    # Psi2 is symmetric, so only the symmetric part of its cotangent acts;
    # the row pass walks the upper triangle with off-diagonal cells doubled.
    sym = 0.5 * (dp2 + dp2.T)
    kmat = (sym * (2.0 - torch.eye(m, **f32))).contiguous()
    dz2 = (z[:, None, :] - z[None, :, :]) ** 2                    # (M, M, Q)
    e0 = (-0.25 * torch.sum(alpha * dz2, dim=-1)).contiguous()
    dmu = torch.empty((n, q), **f32)
    ds = torch.empty((n, q), **f32)
    dal = torch.empty((n, q), **f32)
    dy = torch.empty((n, d), **f32)
    a_part = torch.empty((splits_c, q, m, m), **f32)
    b_part = torch.empty((splits_m, q, m), **f32)
    with torch.cuda.device(mu.device):
        rc = _build.load().gparml_psi_bwd(
            *(t.data_ptr() for t in (mu, s, y, w, z, alpha, sf2, kmat, e0, dp1y)),
            n, m, q, d, splits_c, splits_m,
            *(t.data_ptr() for t in (dmu, ds, dal, dy, a_part, b_part)),
            torch.cuda.current_stream(mu.device).cuda_stream)
    _build.check(rc, "psi_bwd")
    LAUNCHES["bwd"] += 1
    dz, dsf2, dalpha = _assemble_bwd(z, sf2, alpha, p1y, p2, dp1y, sym, dz2,
                                     dal, a_part.sum(0), b_part.sum(0))
    return dmu, ds, dz, dsf2, dalpha, dy


def _assemble_bwd(z, sf2, alpha, p1y, p2, dp1y, sym, dz2, dal, a, b):
    """(dz, dsf2, dalpha) from the backward kernels' reductions: ``dal``
    (N, Q) the row passes' dalpha shares, ``a`` (Q, M, M) the centred cell
    sums sum_n w e c (mu - zb), ``b`` (Q, M) the centred inducing-point sums
    sum_n h c1 (mu - z); ``sym`` = sym(dPsi2), ``dz2`` (M, M, Q) the squared
    coordinate differences of z."""
    zt = z.T
    sp2 = sym * p2
    # dz_m = 2 sum_m' S [A - (alpha/2)(z_m - z_m') Psi2] + B
    dz_t = 2.0 * (
        (sym * a).sum(-1)
        - 0.5 * alpha[:, None] * (zt * sp2.sum(-1) - (sp2 @ z).T)
    ) + b
    dalpha = dal.sum(0) - 0.25 * torch.einsum("mp,mpq->q", sp2, dz2)
    dlogsf2 = 2.0 * torch.sum(sp2) + torch.sum(dp1y * p1y)
    return dz_t.T, dlogsf2 / sf2, dalpha


class PsiFused(torch.autograd.Function):
    """(Psi1^T (w Y), sum_n w_n Psi2_n), differentiable in (mu, s, z, sf2,
    alpha, y); the weights w are data (no gradient)."""

    @staticmethod
    def forward(ctx, mu, s, z, sf2, alpha, y, w, block):
        p1y, p2 = psi_fwd(mu, s, z, sf2, alpha, y, w, block=block)
        ctx.save_for_backward(mu, s, z, sf2, alpha, y, w, p1y, p2)
        ctx.block = block
        return p1y, p2

    @staticmethod
    def backward(ctx, dp1y, dp2):
        mu, s, z, sf2, alpha, y, w, p1y, p2 = ctx.saved_tensors
        grads = psi_bwd(mu, s, z, sf2, alpha, y, w, p1y, p2,
                        dp1y.contiguous(), dp2.contiguous(), block=ctx.block)
        return (*grads, None, None)


def psi_fused(mu, s, z, sf2, alpha, y, w, block: Optional[int] = None):
    """Fused (Psi1^T (w Y) (M, D), sum_n w_n Psi2_n (M, M))."""
    return PsiFused.apply(mu, s, z, sf2, alpha, y, w, block)


def suff_stats(y, mu, s, z, sf2, alpha, weights=None,
               block: Optional[int] = None) -> SufficientStats:
    """Drop-in for ``psi.suff_stats`` (GPLVM path) with the two heavy
    statistics from ``psi_fused``."""
    if s is None:
        raise ValueError(
            "SGPR (s=None) statistics are plain matmuls; use psi.suff_stats")
    w = torch.ones(y.shape[0], dtype=y.dtype, device=y.device) if weights is None else weights
    n_f = torch.sum(w)
    yy = torch.sum((y * y) * w[:, None])
    psi0 = n_f * sf2
    kl = kl_qp(mu, s, weights)
    p1y, p2 = psi_fused(mu, s, z, sf2, alpha, y, w, block=block)
    return SufficientStats(psi0, p1y, p2, yy, kl, n_f)
