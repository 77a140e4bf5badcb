"""Plain PyTorch model of the tensor-core arithmetic of the Psi2 kernels
(``csrc/psi_tc.cuh``, used by ``csrc/psi_fwd.cu`` and ``csrc/psi_bwd.cu``):
the Q <= 64 buckets and, past Q = 64, the K-chunked kernels.

The kernels write the Psi2 exponent of data row n and upper-triangle cell
(m, m') in expanded form, in base 2:

  L2 = [(lc_n - sum_q c mu'^2) log2e + S] + [E0_mm' log2e]
       + sum_q (2 c mu' log2e)_nq zb'_q + sum_q (-c log2e)_nq zb'_q^2

with mu' = mu - zeta and zb' = (z_m + z_m') / 2 - zeta, zeta the
per-dimension mean of Z (the exponent is invariant under that shift, so the
expanded terms carry the data's spread, not its offset). The last two sums
are one (rows x 2Q) . (2Q x cells) product, which the kernels run on the
tensor cores in TF32 with the 3-term split a_hi b_lo + a_lo b_hi + a_hi b_hi
and float32 accumulation; the row and cell constants are added in float32
after it, then exp2 (``ex2.approx.ftz``, whose results below 2^-126 flush
to zero). S is an exact power-of-two shift (``shift``: S = -floor(max_n
lc_n log2e)), so that every pair's exp2 lies below 2 and the largest rows
stay clear of float32's subnormal range; the kernels undo it on their
float64 totals (x 2^-S, exact). This module computes the same thing on the
CPU:

* ``tf32`` rounds as ``cvt.rna.tf32.f32`` does (round to nearest, ties away
  from zero, on the low 13 mantissa bits of the float32 bit pattern);
* ``tc_matmul`` is the 3-term product;
* ``exponents`` the kernels' (rows, cells) exponent tile, ``ex2`` their
  exp2 with its flush;
* ``psi2_sum`` the forward statistic, ``psi2_bwd`` the backward's
  reductions in either form: ``"tc"`` (what the kernels run: the sums
  g [zb' | zb'^2 | 1] and w e [c mu' | c] as further 3-term TF32 products
  over tiles of 64, combined into t = P zb' - mu' G and so on in float64)
  or ``"direct"`` (per pair in float32, centred on the cell, as the
  previous kernels did), kept so that the two can be compared
  (``tools/psi_tc_numerics.py``).

Past Q = 64 (``chunked``) the kernels walk K in chunks of ``QCHUNK`` latent
dimensions (each chunk both halves of the operands for its dimensions), the
float32 accumulator running on across the chunks.

Per-pair values are float32; sums over pairs are float64, as in the kernels,
whose float32 partial sums span at most one 64-row or 64-cell tile.
"""

from __future__ import annotations

import math

import torch

LOG2E = 1.0 / math.log(2.0)
# Rows and cells of one exponent tile (csrc/psi_tc.cuh kTcRows).
TILE = 64
# Latent dimensions per K chunk of the Q > 64 kernels (csrc/psi_tc.cuh
# kTcQChunk).
QCHUNK = 16


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32``: the low 13
    mantissa bits dropped, rounding to nearest with ties away from zero."""
    bits = x.contiguous().view(torch.int32).to(torch.int64)
    sign = bits & 0x80000000
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & ~0x1FFF
    out = sign | mag
    out = torch.where(out >= 2 ** 31, out - 2 ** 32, out)
    return out.to(torch.int32).view(torch.float32)


def split(x: torch.Tensor):
    """(hi, lo) = (tf32(x), tf32(x - hi))."""
    hi = tf32(x)
    return hi, tf32(x - hi)


def tc_matmul(a: torch.Tensor, b: torch.Tensor, chunks=None) -> torch.Tensor:
    """a (R, K) times b (C, K)^T in the kernels' 3-term TF32 form: the small
    terms a_hi b_lo + a_lo b_hi first, then a_hi b_hi, float32 throughout.
    ``chunks``: a list of K-column index tensors walked in turn, each adding
    its small terms and then its large ones into the one float32
    accumulator (the Q > 64 kernels)."""
    a_hi, a_lo = split(a.float())
    b_hi, b_lo = split(b.float())
    if chunks is None:
        small = a_hi @ b_lo.T + a_lo @ b_hi.T
        return small + a_hi @ b_hi.T
    acc = torch.zeros((a.shape[0], b.shape[0]), dtype=torch.float32)
    for k in chunks:
        acc = acc + (a_hi[:, k] @ b_lo[:, k].T + a_lo[:, k] @ b_hi[:, k].T)
        acc = acc + a_hi[:, k] @ b_hi[:, k].T
    return acc


def k_chunks(q: int):
    """The K columns of each chunk of the Q > 64 kernels: QCHUNK latent
    dimensions, both halves ([2 c mu' | -c] and [zb' | zb'^2]) of each."""
    return [torch.cat([torch.arange(k0, min(k0 + QCHUNK, q)),
                       q + torch.arange(k0, min(k0 + QCHUNK, q))])
            for k0 in range(0, q, QCHUNK)]


# Below this, ex2.approx.ftz returns 0.
FLUSH = 2.0 ** -126


def ex2(x: torch.Tensor) -> torch.Tensor:
    """2^x as the kernels' ``ex2.approx.ftz`` gives it: a result below
    2^-126 (float32's smallest normal) becomes 0."""
    y = torch.exp2(x)
    return torch.where(y < FLUSH, torch.zeros_like(y), y)


def shift_of(s, alpha, sf2) -> float:
    """S = -floor(max_n lc_n log2e), lc_n = 2 log sf2 - 1/2 sum_q log(2 alpha
    s_nq + 1): the power of two the kernels fold into the row
    constants (any integer is exact; this one puts the largest row's pairs
    just below 2)."""
    lc = 2.0 * torch.log(sf2.double()) - 0.5 * torch.log1p(
        2.0 * alpha.double() * s.double()).sum(-1)
    return -math.floor(float(lc.max()) * LOG2E)


def cells(m: int):
    """(i, j) of the upper-triangle cells, i <= j, packed row by row (the
    kernels' linear cell index)."""
    return torch.triu_indices(m, m)


def _row_terms(mu, s, alpha, sf2, zeta, shift=0):
    """(row operand (N, 2Q), row constant (N,), c, den, mu') in float32;
    as in the kernels, sum_q log den is the float64 sum of the logs of
    float32 products of 8 terms, and sum_q c mu'^2 a float64 sum; the
    ``shift`` S is added to the constant in float64 before its rounding."""
    mu, s, alpha = mu.float(), s.float(), alpha.float()
    den = 2.0 * alpha * s + 1.0
    c = alpha / den
    mu_c = mu - zeta.float()
    n, q = den.shape
    pad = torch.ones((n, -q % 8), dtype=den.dtype)
    prods = torch.cat([den, pad], dim=-1).reshape(n, -1, 8).prod(-1)
    lc = 2.0 * torch.log(sf2.float()).double() - 0.5 * torch.log(prods).double().sum(-1)
    rc = ((lc - (c * mu_c * mu_c).double().sum(-1)) * LOG2E + shift).float()
    a = torch.cat([(2.0 * c * mu_c) * LOG2E, -c * LOG2E], dim=-1).float()
    return a, rc, c, den, mu_c


def _cell_terms(z, alpha, zeta):
    """(cell operand (C, 2Q), cell constant (C,), zb' (C, Q)) of the packed
    upper-triangle cells, float32 (E0 summed in float64)."""
    z = z.float()
    i, j = cells(z.shape[0])
    zc = z - zeta.float()
    zb = 0.5 * (zc[i] + zc[j])
    dz = z[i] - z[j]
    e0 = -0.25 * (alpha.double() * (dz * dz).double()).sum(-1)
    ce = (e0.float() * LOG2E).float()
    return torch.cat([zb, zb * zb], dim=-1), ce, zb


def exponents(mu, s, z, sf2, alpha, zeta=None, shift=0):
    """The (N, C) base-2 exponents of the kernels' tile arithmetic (C the
    packed upper-triangle cells), plus ``shift``, with (c, den, mu', zb')
    beside them. ``zeta`` defaults to the per-dimension mean of Z; past
    Q = 64 K is walked in chunks as the kernels walk it."""
    if zeta is None:
        zeta = z.float().mean(0)
    q = z.shape[1]
    a, rc, c, den, mu_c = _row_terms(mu, s, alpha, sf2, zeta, shift)
    b, ce, zb = _cell_terms(z, alpha, zeta)
    l2 = (tc_matmul(a, b, k_chunks(q) if q > 64 else None) + rc[:, None]) + ce[None, :]
    return l2, c, den, mu_c, zb


def _shift_for(s, alpha, sf2, shift):
    """The shift the kernels take: None means theirs, ``shift_of``."""
    return shift_of(s, alpha, sf2) if shift is None else shift


def _mirror(packed, m):
    """(..., C) packed upper-triangle values as (..., M, M), both triangles."""
    i, j = cells(m)
    out = torch.zeros(packed.shape[:-1] + (m, m), dtype=packed.dtype)
    out[..., i, j] = packed
    out[..., j, i] = packed
    return out


def psi2_sum(mu, s, z, sf2, alpha, w, zeta=None, shift=None):
    """sum_n w_n Psi2_n (M, M) in float64: float32 pair values w exp2(L2 + S),
    summed in float64 and scaled by 2^-S (``shift`` S: None for the kernels'
    own)."""
    sh = _shift_for(s, alpha, sf2, shift)
    l2 = exponents(mu, s, z, sf2, alpha, zeta, sh)[0]
    pair = w.float()[:, None] * ex2(l2)
    return _mirror(pair.double().sum(0), z.shape[0]) * 2.0 ** -sh


def _tiled_tc(a, b, axis_len, tile=TILE):
    """sum over tiles of ``tile`` along the contracted axis of a (R, K)
    times b (C, K)^T, each tile a 3-term TF32 product, summed in float64."""
    out = 0
    for k0 in range(0, axis_len, tile):
        out = out + tc_matmul(a[:, k0:k0 + tile], b[:, k0:k0 + tile]).double()
    return out


def _tile_sums(x):
    """Row sums of x (R, C) as the kernels take G: float32 sums over tiles
    of 64 columns, added in float64."""
    return sum(x[:, k0:k0 + TILE].sum(1).double() for k0 in range(0, x.shape[1], TILE))


def psi2_bwd(mu, s, z, sf2, alpha, w, kmat, zeta=None, form="tc", shift=None):
    """The Psi2 part of the backward kernels' reductions: the row pass's
    (dmu, ds, dalpha share) (N, Q) and the cell pass's centred sums
    a_q = sum_n w e c_q (mu_q - zb_q) (Q, M, M), float64.

    ``kmat`` (M, M) is the row pass's cotangent weight, mult * sym(dPsi2)
    (the upper triangle is read). ``form`` "tc" (what the kernels run): per
    tile of 64 cells the row sums T1 = sum g zb', T2 = sum g zb'^2 and per
    tile of 64 rows the cell sums S1 = sum w e c mu', S2 = sum w e c, each a
    3-term TF32 product accumulated in float32, the tiles added in float64;
    then in float64 t = T1 - mu' G, u = T2 - 2 mu' T1 + mu'^2 G,
    a = S1 - zb' S2. "direct": per pair g = K w e, d = zb' - mu', t += g d,
    u += g d^2, a += w e c (mu' - zb'), all float32 per pair (the previous
    kernels'). e carries the shift 2^S (``shift``: None for the kernels'
    own), which the float64 sums drop before they are combined."""
    m, q = z.shape
    sh = _shift_for(s, alpha, sf2, shift)
    unshift = 2.0 ** -sh
    l2, c, den, mu_c, zb = exponents(mu, s, z, sf2, alpha, zeta, sh)
    i, j = cells(m)
    e = ex2(l2)                                            # (N, C)
    we = w.float()[:, None] * e
    g = kmat.float()[i, j][None, :] * we                   # (N, C)
    gsum = (_tile_sums(g) if form == "tc" else g.double().sum(1)) * unshift
    if form == "direct":
        d = zb[None, :, :] - mu_c[:, None, :]              # (N, C, Q)
        gd = g[..., None] * d
        t = gd.double().sum(1) * unshift
        u = (gd * d).double().sum(1) * unshift
        acc = (we[..., None] * (c[:, None, :] * (-d))).double().sum(0) * unshift   # (C, Q)
    elif form == "tc":
        ncell, n = zb.shape[0], mu.shape[0]
        prod = lambda x, y, length: _tiled_tc(x, y.T.contiguous(), length)
        pz = prod(g, zb, ncell) * unshift                                # (N, Q)
        pz2 = prod(g, zb * zb, ncell) * unshift
        mu64 = mu_c.double()
        t = pz - mu64 * gsum[:, None]
        u = pz2 - 2.0 * mu64 * pz + mu64 * mu64 * gsum[:, None]
        wc = w.float()[:, None] * c
        e_t = e.T.contiguous()
        acc = (prod(e_t, wc * mu_c, n) - zb.double() * prod(e_t, wc, n)) * unshift
    else:
        raise ValueError(f"form must be 'tc' or 'direct', got {form!r}")
    t32, u32, g32 = t.float(), u.float(), gsum.float()[:, None]
    s32 = s.float()
    dmu = 2.0 * c * t32
    ds = -c * g32 + 2.0 * c * c * u32
    dal = -(s32 / den) * g32 - u32 / (den * den)
    return dmu.double(), ds.double(), dal.double(), _mirror(acc.T.contiguous(), m)


def psi2_vjp(mu, s, z, sf2, alpha, w, dp2, zeta=None, form="tc", shift=None):
    """(sum_n w_n Psi2_n, (dmu, ds, dz, dsf2, dalpha)) against the cotangent
    dp2 (M, M): the model's statistic, and its reductions assembled by the
    wrapper's own ``psi_cuda._assemble_bwd`` in float32, as the wrapper
    assembles the kernels' (no Psi1 part: its cotangent is zero)."""
    from gparml_tpu_torch.ops.psi_cuda import _assemble_bwd

    m, q = z.shape
    f = lambda x: x.float()
    z32, sf2_32, alpha32 = f(z), f(sf2), f(alpha)
    sym = 0.5 * (f(dp2) + f(dp2).T)
    kmat = sym * (2.0 - torch.eye(m))
    p2 = psi2_sum(mu, s, z, sf2, alpha, w, zeta, shift)
    dmu, ds, dal, a = psi2_bwd(mu, s, z, sf2, alpha, w, kmat, zeta, form, shift)
    dz2 = (z32[:, None, :] - z32[None, :, :]) ** 2
    zero_p1y = torch.zeros((m, 1))
    dz, dsf2, dalpha = _assemble_bwd(z32, sf2_32, alpha32, zero_p1y, p2.float(), zero_p1y,
                                     sym, dz2, dal.float().sum(0), a.float(),
                                     torch.zeros((q, m)))
    return p2, (dmu, ds, dz, dsf2, dalpha)
