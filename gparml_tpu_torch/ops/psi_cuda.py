"""Fused Psi-statistics through the hand-written CUDA kernels.

Counterpart of ``gparml_tpu/ops/psi_pallas.py``: ``psi_fused`` and
``psi_fused_t`` (the ``jax.custom_vjp``s there) become the
``torch.autograd.Function``s ``PsiFused`` and ``PsiFusedT``; ``psi_fwd`` /
``psi_bwd`` are the kernel wrappers that replace ``_call_fwd_flat`` /
``_call_bwd_flat``, and ``psi_fwd_t`` / ``psi_bwd_t`` replace their
(Q, N)-layout twins ``_call_fwd_flat_t`` / ``_call_bwd_flat_t``;
``suff_stats`` and ``suff_stats_t`` mirror the Pallas entry points (psi0, yy
and KL are plain tensor sums).

The two layouts run the same kernels (``csrc/psi_fwd.cu``,
``csrc/psi_bwd.cu``; the Psi2 and the Psi1 exponents and the products that
follow them run on the tensor cores, ``csrc/psi_tc.cuh``, whose arithmetic
``psi_tc_model.py`` models on the CPU), told the layout by a flag that sets
their element strides: nq takes mu, s (N, Q) and Y (N, D); qn takes mu^T,
s^T (Q, N) and Y^T (D, N) and gives the cotangents of those back in (Q, N) /
(D, N). The kernels sum in the same order in both, so qn gives the nq
results on transposed inputs, bit for bit.

Dispatch is by the tensors' device and nothing else: CUDA tensors go to the
kernels and must be float32 and contiguous, or the wrapper raises; CPU
tensors go to the plain versions ``psi_fused{,_t}_{fwd,bwd}_reference``
beside them. There is no fallback from a failed build or launch.

The TPU-only machinery (bf16 hi/lo rungs, VMEM tile ladders, per-call N
caps and chunking such as ``_psi_fused_t_chunked`` and ``_chunk_plan``, M
and lane padding, the qn path's M window ``qn_native_ok``, the choice
between the flat, staircase and lane-chunked kernels) has no counterpart:
the same wrappers take every shape the Pallas kernels took. The kernels
take any N, M, Q and D: up to Q = 64 (Psi1: 16) through the register
buckets of ``csrc/psi_common.cuh``, past it with K walked in chunks; where
a block's float64 totals of Y's columns or of the latent dimensions would
outgrow its shared memory, the grid takes them in passes. At every Q the
exponents carry exact power-of-two shifts, which the wrapper computes
(``_shifts``), so that no exp2 flushes to zero. The launch geometry lives in
the CUDA sources only (``gparml_psi_{fwd,bwd}_plan``); the wrappers raise
ValueError if a block would need more shared memory than the card gives.

Up to Q = 64 one Psi2 forward sweep (``psi2_fwd_tc_kernel<QM, CELLS>``)
serves every call, and where dZ will be wanted it also forms the centred
cell sums that dZ takes, so that a fit's evaluation sweeps the (row, cell)
pairs twice (forward, the backward's row pass): where a caller will want dZ
(``_emits_cells``), ``PsiFused`` and ``PsiFusedT`` pass the flag that adds
the sums (CELLS) and save them for the backward; ``psi_bwd`` called alone
runs the sweep for them. Where Z needs no gradient no kernel forms them,
and Psi2 is the same, bit for bit. Past Q = 64 the backward's chunked cell
pass forms them.

Each grid splits N and writes one float64 partial per split, which the
wrapper sums; ``PARTIAL_BYTES`` bounds each grid's partials, and the plan
lowers the split count to fit. The kernels add a split's rows into its
partial in float32 pieces of bounded length (the launcher repeats a grid
over N where a kernel's registers would otherwise sum a longer split), so
the split count changes the time, not the accuracy. At small N the
backward's Psi1 row pass also splits the inducing points over blocks; its
float64 per-split row partials (``row_part``, under the same budget) are
summed in a fixed order on the card.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional

import torch

from gparml_tpu_torch.ops import _build
from gparml_tpu_torch.ops.psi import SufficientStats, kl_qp
from gparml_tpu_torch.ops import psi as psi_plain

# Kernel launches per wrapper: each successful kernel call adds one, under
# the lock (a mesh over several cards runs its shards' backwards on
# autograd's per-device threads). fwd_cells / fwd_cells_t count the forward
# calls (of those in fwd / fwd_t) that also formed the cell sums.
LAUNCHES = {"fwd": 0, "bwd": 0, "fwd_t": 0, "bwd_t": 0, "fwd_cells": 0, "fwd_cells_t": 0}
_LAUNCHES_LOCK = threading.Lock()

# Most bytes of one grid's float64 per-split partials.
PARTIAL_BYTES = 1 << 29


# --- plain versions ---------------------------------------------------------

def psi_fused_fwd_reference(mu, s, z, sf2, alpha, y, w, block: Optional[int] = None):
    """(Psi1^T (w Y) (M, D), sum_n w_n Psi2_n (M, M)) by the plain engine."""
    st = psi_plain.suff_stats(y, mu, s, z, sf2, alpha, block=block, weights=w)
    return st.psi1_y, st.psi2


def psi_fused_t_fwd_reference(mu_t, s_t, z, sf2, alpha, y_t, w,
                              block: Optional[int] = None):
    """The same from mu^T, s^T (Q, N) and Y^T (D, N)."""
    st = psi_plain.suff_stats_t(y_t, mu_t, s_t, z, sf2, alpha, block=block,
                                weights=w)
    return st.psi1_y, st.psi2


def _vjp(fwd, mu, s, z, sf2, alpha, y, w, dp1y, dp2, block):
    with torch.enable_grad():
        xs = [t.detach().requires_grad_(True) for t in (mu, s, z, sf2, alpha, y)]
        out = fwd(*xs[:5], xs[5], w, block=block)
        return torch.autograd.grad(out, xs, grad_outputs=(dp1y, dp2))


def psi_fused_bwd_reference(mu, s, z, sf2, alpha, y, w, dp1y, dp2,
                            block: Optional[int] = None):
    """(dmu, ds, dz, dsf2, dalpha, dy): autograd of the plain forward
    against the cotangents (dp1y, dp2)."""
    return _vjp(psi_fused_fwd_reference, mu, s, z, sf2, alpha, y, w, dp1y,
                dp2, block)


def psi_fused_t_bwd_reference(mu_t, s_t, z, sf2, alpha, y_t, w, dp1y, dp2,
                              block: Optional[int] = None):
    """(dmu^T, ds^T, dz, dsf2, dalpha, dy^T): the same in the qn layout."""
    return _vjp(psi_fused_t_fwd_reference, mu_t, s_t, z, sf2, alpha, y_t, w,
                dp1y, dp2, block)


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


def _ptr(t) -> int:
    """A kernel's pointer argument: the tensor's address, or null for None."""
    return 0 if t is None else t.data_ptr()


def _check_kernel_inputs(named: dict, shapes: dict) -> None:
    for name, t in named.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the CUDA kernels take float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the CUDA kernels take contiguous tensors")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shapes[name]}")


def _shapes(layout: str, mu, z, y):
    """(n, m, q, d, expected shapes) of kernel inputs in ``layout``."""
    if layout == "nq":
        (n, q), d = mu.shape, y.shape[1]
        lat, obs = (n, q), (n, d)
    else:
        (q, n), d = mu.shape, y.shape[0]
        lat, obs = (q, n), (d, n)
    m = z.shape[0]
    return n, m, q, d, {
        "mu": lat, "s": lat, "z": (m, q), "sf2": (), "alpha": (q,),
        "y": obs, "w": (n,), "p1y": (m, d), "p2": (m, m),
        "dp1y": (m, d), "dp2": (m, m),
    }


def _plan(n: int, m: int, q: int, d: int, device: torch.device):
    """(splits2, splits1, splits_c, splits_m, splits_p): the N-splits of
    the forward's Psi2 grid (whether or not it forms the cell sums) and Psi1
    grid, and of the backward's grids (splits_c, the chunked cell pass's, 0
    up to Q = 64), and the inducing-point splits of the backward's Psi1 row
    pass, from the kernels' own launch plan (the same in both layouts) under
    ``PARTIAL_BYTES``. Raises ValueError when a block would need more shared
    memory than the card gives one."""
    return _plan_for(n, m, q, d, device, PARTIAL_BYTES)


@functools.lru_cache(maxsize=64)
def _plan_for(n, m, q, d, device, partial_bytes):
    lib = _build.load()
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    fwd, bwd = (ctypes.c_int * 4)(), (ctypes.c_int * 5)()
    with torch.cuda.device(device):
        _build.check(lib.gparml_psi_fwd_plan(n, m, q, d, sms, partial_bytes, fwd),
                     "psi_fwd_plan")
        _build.check(lib.gparml_psi_bwd_plan(n, m, q, d, sms, partial_bytes, bwd),
                     "psi_bwd_plan")
    need, limit = max(fwd[2], bwd[2]), fwd[3]
    if need > limit:
        raise ValueError(
            f"the CUDA kernels need {need} bytes of shared memory per block at "
            f"M={m}, Q={q}, D={d}, and this card gives {limit}")
    return fwd[0], fwd[1], bwd[0], bwd[1], bwd[4]


@functools.lru_cache(maxsize=16)
def _cells(m: int, device: torch.device) -> torch.Tensor:
    """The packed upper-triangle cells (M (M + 1) / 2, 2) int32, (i, j) with
    i <= j row by row, on ``device`` (built once per M and device)."""
    return torch.triu_indices(m, m, device=device).T.contiguous().to(torch.int32)


def _cell_terms(z, alpha):
    """What the Psi2 kernels (``csrc/psi_tc.cuh``) take beside Z: zeta, the
    per-dimension mean of Z, by which they shift mu and Z (data to the
    kernels: Psi2 depends on mu - Z only, so the shift changes no output and
    no gradient, only the magnitudes the tensor-core product carries); the
    packed cells (``_cells``); and their E0 log2e = -1/4 sum_q alpha (z_i -
    z_j)^2 log2e, in float64 from the shifted Z."""
    m, q = z.shape
    cells = _cells(m, z.device)
    i, j = cells.T.long()
    zeta = z.mean(0).contiguous()
    zc = (z - zeta).double()
    za = zc * alpha.double()
    sq = (zc * za).sum(1)
    e0 = -0.25 * (sq[i] + sq[j] - 2.0 * (za @ zc.T)[i, j])
    ce = e0.to(z.dtype) * _LOG2E
    return zeta, cells, ce.contiguous()


_LOG2E = 1.4426950408889634
# Elements of s a piece of ``_shifts`` reads at once.
_SHIFT_PIECE = 1 << 26


def _shifts(layout, s, alpha, sf2):
    """(S, S1): S_k = -floor(max_n lc_n log2e), lc_n = k log sf2 - 1/2
    sum_q log(k alpha_q s_nq + 1) (k = 2: Psi2's row constant; k = 1:
    Psi1's), as float32 scalars on the device (never read on the host): the
    whole numbers the kernels add to every base-2 exponent and take off
    their float64 sums (exact for any whole number; these keep the largest
    row's values just below 2 and the rest clear of float32's subnormal
    range). One sweep over s in pieces of rows, which bound the temporary;
    2 alpha s is exactly twice alpha s, so each S is as a sweep of its own
    would give it."""
    n = s.shape[0] if layout == "nq" else s.shape[1]
    step = max(1, _SHIFT_PIECE // alpha.shape[0])
    least = [None, None]
    for i in range(0, n, step):
        sa = s[i:i + step] * alpha if layout == "nq" else s[:, i:i + step] * alpha[:, None]
        dim = 1 if layout == "nq" else 0
        for j, x in enumerate((2.0 * sa, sa)):
            low = torch.log1p(x).sum(dim).min()
            least[j] = low if least[j] is None else torch.minimum(least[j], low)
    return tuple((-torch.floor((k * torch.log(sf2) - 0.5 * low) * _LOG2E))
                 .to(torch.float32).reshape(()) for k, low in zip((2.0, 1.0), least))


def _terms(layout, s, z, sf2, alpha):
    """(zeta, cells, ce, shift, shift1) for the kernels: Psi2's cell terms
    and the shifts of the Psi2 and the Psi1 exponents."""
    return (*_cell_terms(z, alpha), *_shifts(layout, s, alpha, sf2))


# layout -> (the kernels' qn flag, LAUNCHES keys of the forward, the
# backward and the forward that forms the cell sums)
_LAYOUTS = {"nq": (0, "fwd", "bwd", "fwd_cells"), "qn": (1, "fwd_t", "bwd_t", "fwd_cells_t")}


# The widest Q of the register buckets (csrc/psi_common.cuh qm_for): up to
# it the forward forms the cell sums and its partials hold room for them.
_BUCKET_MAX_Q = 64


def _emits_cells(grad_enabled: bool, z_grad: bool, q: int) -> bool:
    """Whether the forward forms the backward's centred cell sums: where
    autograd records the call (``grad_enabled``), dZ will be wanted
    (``z_grad``) and a Q bucket holds q (Q <= 64; past it the backward's
    chunked cell pass forms them). A fit's evaluation does; latent
    inference (Z held) and statistics under ``torch.no_grad`` do not."""
    return grad_enabled and z_grad and q <= _BUCKET_MAX_Q


def _launch_fwd(layout, mu, s, z, sf2, alpha, y, w, cells=False):
    """(Psi1^T (w Y), sum_n w_n Psi2_n) from the forward kernels; with
    ``cells`` (Q <= 64) also the centred cell sums A (Q, M, M) of the
    backward (``_launch_bwd``'s ``a``), formed in the same sweep."""
    out = _run_fwd(layout, mu, s, z, sf2, alpha, y, w, cells)
    _, key, _, key_cells = _LAYOUTS[layout]
    with _LAUNCHES_LOCK:
        LAUNCHES[key] += 1
        if cells:
            LAUNCHES[key_cells] += 1
    return out


def _run_fwd(layout, mu, s, z, sf2, alpha, y, w, cells):
    """``_launch_fwd``'s kernels, uncounted."""
    args = dict(mu=mu, s=s, z=z, sf2=sf2, alpha=alpha, y=y, w=w)
    n, m, q, d, shapes = _shapes(layout, mu, z, y)
    _check_kernel_inputs(args, shapes)
    qn = _LAYOUTS[layout][0]
    splits2, splits1 = _plan(n, m, q, d, mu.device)[:2]
    f64 = dict(dtype=torch.float64, device=mu.device)
    p1y_part = torch.empty((splits1, m, d), **f64)
    # Psi2's partials, then (Q <= 64) room for the cell sums, whether or not
    # the kernel forms them
    p2_part = torch.empty((splits2, q + 1 if q <= _BUCKET_MAX_Q else 1, m, m), **f64)
    terms = _terms(layout, s, z, sf2, alpha)   # alive until the kernels have read them
    with torch.cuda.device(mu.device):
        rc = _build.load().gparml_psi_fwd(
            *(t.data_ptr() for t in (mu, s, y, w, z, alpha, sf2, *terms)),
            n, m, q, d, qn, splits2, splits1, int(cells), p2_part.data_ptr(),
            p1y_part.data_ptr(), torch.cuda.current_stream(mu.device).cuda_stream)
    _build.check(rc, "psi_fwd")
    out = p1y_part.sum(0).to(mu.dtype), p2_part[:, 0].sum(0).to(mu.dtype)
    return (*out, p2_part[:, 1:].sum(0).to(mu.dtype)) if cells else out


def _launch_bwd(layout, mu, s, z, sf2, alpha, y, w, p1y, p2, dp1y, dp2, a=None, dz=True):
    """(dmu, ds, dz, dsf2, dalpha, dy) from the backward kernels. The
    centred cell sums that dz takes come from ``a`` (the forward's, from
    ``_launch_fwd(..., cells=True)``); without it, from a run of that sweep
    here (Q <= 64) or from the backward's chunked cell pass (past Q = 64).
    Without ``dz`` nothing forms them and dz is None."""
    args = dict(mu=mu, s=s, z=z, sf2=sf2, alpha=alpha, y=y, w=w,
                p1y=p1y, p2=p2, dp1y=dp1y, dp2=dp2)
    n, m, q, d, shapes = _shapes(layout, mu, z, y)
    _check_kernel_inputs(args, shapes)
    qn, _, key, _ = _LAYOUTS[layout]
    _, _, splits_c, splits_m, splits_p = _plan(n, m, q, d, mu.device)
    if dz and a is None and q <= _BUCKET_MAX_Q:
        a = _run_fwd(layout, mu, s, z, sf2, alpha, y, w, True)[2]
    f32 = dict(dtype=mu.dtype, device=mu.device)
    # Psi2 is symmetric, so only the symmetric part of its cotangent acts;
    # the row pass walks the upper triangle with off-diagonal cells doubled.
    sym = 0.5 * (dp2 + dp2.T)
    kmat = (sym * (2.0 - torch.eye(m, **f32))).contiguous()
    dz2 = (z[:, None, :] - z[None, :, :]) ** 2                    # (M, M, Q)
    dmu, ds, dal = (torch.empty(mu.shape, **f32) for _ in range(3))
    dy = torch.empty(y.shape, **f32)
    f64 = dict(dtype=torch.float64, device=mu.device)
    a_part = torch.empty((splits_c, q, m, m), **f64) if dz and a is None else None
    b_part = torch.empty((splits_m, q, m), **f64)
    row_part = torch.empty((splits_p, n, 2 * q + 1 + d) if splits_p > 1 else (0,), **f64)
    terms = _terms(layout, s, z, sf2, alpha)
    with torch.cuda.device(mu.device):
        rc = _build.load().gparml_psi_bwd(
            *(t.data_ptr() for t in (mu, s, y, w, z, alpha, sf2, *terms, kmat, dp1y)),
            n, m, q, d, qn, splits_c, splits_m, splits_p,
            *(_ptr(t) for t in (dmu, ds, dal, dy, a_part, b_part, row_part)),
            torch.cuda.current_stream(mu.device).cuda_stream)
    _build.check(rc, "psi_bwd")
    with _LAUNCHES_LOCK:
        LAUNCHES[key] += 1
    if a_part is not None:
        a = a_part.sum(0).to(mu.dtype)
    dal_sum = dal.sum(0 if layout == "nq" else 1)
    dz, dsf2, dalpha = _assemble_bwd(z, sf2, alpha, p1y, p2, dp1y, sym, dz2, dal_sum,
                                     a if dz else None, b_part.sum(0).to(mu.dtype))
    return dmu, ds, dz, dsf2, dalpha, dy


def psi_fwd(mu, s, z, sf2, alpha, y, w, block: Optional[int] = None):
    """Forward wrapper: (Psi1^T (w Y), sum_n w_n Psi2_n) from mu, s (N, Q)
    and y (N, D). Launches the forward kernels for CUDA tensors; ``block``
    applies to the plain version only."""
    if not _on_cuda((mu, s, z, sf2, alpha, y, w)):
        return psi_fused_fwd_reference(mu, s, z, sf2, alpha, y, w, block=block)
    return _launch_fwd("nq", mu, s, z, sf2, alpha, y, w)


def psi_fwd_t(mu_t, s_t, z, sf2, alpha, y_t, w, block: Optional[int] = None):
    """``psi_fwd`` from mu^T, s^T (Q, N) and y^T (D, N)."""
    if not _on_cuda((mu_t, s_t, z, sf2, alpha, y_t, w)):
        return psi_fused_t_fwd_reference(mu_t, s_t, z, sf2, alpha, y_t, w,
                                         block=block)
    return _launch_fwd("qn", mu_t, s_t, z, sf2, alpha, y_t, w)


def psi_bwd(mu, s, z, sf2, alpha, y, w, p1y, p2, dp1y, dp2,
            block: Optional[int] = None):
    """Backward wrapper: (dmu, ds, dz, dsf2, dalpha, dy) from the forward's
    inputs and outputs (p1y, p2) and the cotangents (dp1y, dp2). Launches
    the backward kernels for CUDA tensors; ``block`` applies to the plain
    version only."""
    if not _on_cuda((mu, s, z, sf2, alpha, y, w, p1y, p2, dp1y, dp2)):
        return psi_fused_bwd_reference(mu, s, z, sf2, alpha, y, w, dp1y, dp2,
                                       block=block)
    return _launch_bwd("nq", mu, s, z, sf2, alpha, y, w, p1y, p2, dp1y, dp2)


def psi_bwd_t(mu_t, s_t, z, sf2, alpha, y_t, w, p1y, p2, dp1y, dp2,
              block: Optional[int] = None):
    """``psi_bwd`` in the qn layout: (dmu^T, ds^T, dz, dsf2, dalpha, dy^T)."""
    if not _on_cuda((mu_t, s_t, z, sf2, alpha, y_t, w, p1y, p2, dp1y, dp2)):
        return psi_fused_t_bwd_reference(mu_t, s_t, z, sf2, alpha, y_t, w,
                                         dp1y, dp2, block=block)
    return _launch_bwd("qn", mu_t, s_t, z, sf2, alpha, y_t, w, p1y, p2,
                       dp1y, dp2)


def _assemble_bwd(z, sf2, alpha, p1y, p2, dp1y, sym, dz2, dal_sum, a, b):
    """(dz, dsf2, dalpha) from the backward kernels' reductions: ``dal_sum``
    (Q,) the sum of the row passes' dalpha shares, ``a`` (Q, M, M) the centred cell
    sums sum_n w e c (mu - zb) (None: no dz), ``b`` (Q, M) the centred
    inducing-point sums sum_n h c1 (mu - z); ``sym`` = sym(dPsi2), ``dz2``
    (M, M, Q) the squared coordinate differences of z."""
    sp2 = sym * p2
    dz = None
    if a is not None:
        # dz_m = 2 sum_m' S [A - (alpha/2)(z_m - z_m') Psi2] + B
        dz = (2.0 * (
            (sym * a).sum(-1)
            - 0.5 * alpha[:, None] * (z.T * sp2.sum(-1) - (sp2 @ z).T)
        ) + b).T
    dalpha = dal_sum - 0.25 * torch.einsum("mp,mpq->q", sp2, dz2)
    dlogsf2 = 2.0 * torch.sum(sp2) + torch.sum(dp1y * p1y)
    return dz, dlogsf2 / sf2, dalpha


def _fused_function(name: str, layout: str, fwd_ref, bwd_ref, doc: str):
    """A ``torch.autograd.Function`` over the layout's kernels (CPU inputs:
    the plain versions ``fwd_ref``, ``bwd_ref``). Its last input, ``cells``
    (``_emits_cells``), sends a CUDA forward through the sweep that also
    forms the cell sums, which it saves for the backward."""

    def forward(ctx, mu, s, z, sf2, alpha, y, w, block, cells):
        xs = (mu, s, z, sf2, alpha, y, w)
        ctx.kernels, ctx.block = _on_cuda(xs), block
        out = (_launch_fwd(layout, *xs, cells=cells) if ctx.kernels
               else fwd_ref(*xs, block=block))
        ctx.save_for_backward(*xs, *out)
        return out[:2]

    def backward(ctx, dp1y, dp2):
        xs, out = ctx.saved_tensors[:7], ctx.saved_tensors[7:]
        dp1y, dp2 = dp1y.contiguous(), dp2.contiguous()
        if ctx.kernels:
            grads = _launch_bwd(layout, *xs, *out[:2], dp1y, dp2, a=out[2] if out[2:] else None,
                                dz=ctx.needs_input_grad[2])
        else:
            grads = bwd_ref(*xs, dp1y, dp2, block=ctx.block)
        return (*grads, None, None, None)

    return type(name, (torch.autograd.Function,), {
        "__doc__": doc, "__module__": __name__,
        "forward": staticmethod(forward), "backward": staticmethod(backward)})


PsiFused = _fused_function(
    "PsiFused", "nq", psi_fused_fwd_reference, psi_fused_bwd_reference,
    """(Psi1^T (w Y), sum_n w_n Psi2_n), differentiable in (mu, s, z, sf2,
    alpha, y); the weights w are data (no gradient).""")
PsiFusedT = _fused_function(
    "PsiFusedT", "qn", psi_fused_t_fwd_reference, psi_fused_t_bwd_reference,
    """``PsiFused`` in the qn layout: mu^T, s^T (Q, N) and y^T (D, N), whose
    gradients come back (Q, N) and (D, N).""")


def psi_fused(mu, s, z, sf2, alpha, y, w, block: Optional[int] = None):
    """Fused (Psi1^T (w Y) (M, D), sum_n w_n Psi2_n (M, M))."""
    cells = _emits_cells(torch.is_grad_enabled(), z.requires_grad, z.shape[1])
    return PsiFused.apply(mu, s, z, sf2, alpha, y, w, block, cells)


def psi_fused_t(mu_t, s_t, z, sf2, alpha, y_t, w, block: Optional[int] = None):
    """``psi_fused`` from mu^T, s^T (Q, N) and y^T (D, N)."""
    cells = _emits_cells(torch.is_grad_enabled(), z.requires_grad, z.shape[1])
    return PsiFusedT.apply(mu_t, s_t, z, sf2, alpha, y_t, w, block, cells)


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


def suff_stats_t(y_t, mu_t, s_t, z, sf2, alpha, weights=None,
                 block: Optional[int] = None) -> SufficientStats:
    """``suff_stats`` in the (Q, N) / (D, N) storage layout (GPLVMConfig
    layout='qn'), with the heavy statistics from ``psi_fused_t``: y_t (D, N),
    mu_t and s_t (Q, N)."""
    if s_t is None:
        raise ValueError(
            "SGPR (s=None) statistics are plain matmuls; use psi.suff_stats_t")
    n = y_t.shape[1]
    w = torch.ones(n, dtype=y_t.dtype, device=y_t.device) if weights is None else weights
    n_f = torch.sum(w)
    yy = torch.sum((y_t * y_t) * w[None, :])
    psi0 = n_f * sf2
    kl = kl_qp(mu_t.T, s_t.T, weights)
    p1y, p2 = psi_fused_t(mu_t, s_t, z, sf2, alpha, y_t, w, block=block)
    return SufficientStats(psi0, p1y, p2, yy, kl, n_f)
