"""Plain PyTorch model of the tensor-core arithmetic of the Psi kernels
(``csrc/psi_tc.cuh``, used by ``csrc/psi_fwd.cu`` and ``csrc/psi_bwd.cu``):
for Psi2 the Q <= 64 buckets and, past Q = 64, the K-chunked kernels; for
Psi1 (``psi1y_sum``, ``psi1_bwd``, ``psi1_vjp``, at the end) the buckets up
to Q = 16 and the K-chunked kernels past it.

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

Psi1 is the same arithmetic with the packed cells replaced by the inducing
points (no cell constant):

  L1 = [(l1_n - 1/2 sum_q c1 mu'^2) log2e + S1]
       + sum_q (c1 mu' log2e)_nq z'_q + sum_q (-c1 / 2 log2e)_nq z'_q^2

with c1 = alpha / (alpha s + 1), l1 = log sf2 - 1/2 sum_q log(alpha s + 1),
z' = z - zeta and S1 = -floor(max_n l1_n log2e) (``shift1_of``). The
products that follow run on the tensor cores too, each a 3-term TF32
product over one 64-tile, the tiles added in float64: the forward's
p (Y) with p = w exp2(L1); the backward's y . dPsi1Y_m (K = D, in chunks of
``DCHUNK``, each chunk's product formed on its own and added in float32,
as the K chunks of the exponent past ``PSI1_BUCKET_MAX``) and dY = p dPsi1Y
over 64-point tiles. With h = p (y .
dPsi1Y), the centred sums sum h (mu' - z'), sum h (mu' - z')^2 (over
64-point tiles) and sum h c1 (mu' - z') (over 64-row tiles) are taken pair
by pair in float32, not as further products: their expanded forms cancel
where the latents lie far from zeta.
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


def tc_matmul(a: torch.Tensor, b: torch.Tensor, chunks=None, fresh=False) -> torch.Tensor:
    """a (R, K) times b (C, K)^T in the kernels' 3-term TF32 form: the small
    terms a_hi b_lo + a_lo b_hi first, then a_hi b_hi, float32 throughout.
    ``chunks``: a list of K-column index tensors walked in turn, each adding
    its small terms and then its large ones into the one float32
    accumulator (the Q > 64 Psi2 kernels); with ``fresh`` each chunk's
    product is formed on its own and added to the running sum (the Psi1
    kernels, ``csrc/psi_tc.cuh`` tc_tile_chunk)."""
    a_hi, a_lo = split(a.float())
    b_hi, b_lo = split(b.float())
    if chunks is None:
        small = a_hi @ b_lo.T + a_lo @ b_hi.T
        return small + a_hi @ b_hi.T
    acc = torch.zeros((a.shape[0], b.shape[0]), dtype=torch.float32)
    for k in chunks:
        small = a_hi[:, k] @ b_lo[:, k].T + a_lo[:, k] @ b_hi[:, k].T
        if fresh:
            acc = acc + (small + a_hi[:, k] @ b_hi[:, k].T)
        else:
            acc = acc + small
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


# --- Psi1 ---------------------------------------------------------------------

# Psi1's exponent runs through the register buckets of the kernels up to
# this Q and K-chunked past it (csrc/psi_tc.cuh kTcP1BucketMax).
PSI1_BUCKET_MAX = 16
# Columns of Y (D) one product chunk of the Psi1 kernels takes
# (csrc/psi_tc.cuh kTcDChunk).
DCHUNK = 16


def shift1_of(s, alpha, sf2) -> float:
    """S1 = -floor(max_n l1_n log2e), l1_n = log sf2 - 1/2 sum_q log(alpha
    s_nq + 1): the Psi1 kernels' power of two (the largest row's values just
    below 2)."""
    l1 = torch.log(sf2.double()) - 0.5 * torch.log1p(alpha.double() * s.double()).sum(-1)
    return -math.floor(float(l1.max()) * LOG2E)


def _row_terms1(mu, s, alpha, sf2, zeta, shift=0):
    """Psi1's (row operand (N, 2Q) [c1 mu' | -c1/2] log2e, row constant
    (N,), c1, den1, mu') in float32; the sums as ``_row_terms`` takes them."""
    mu, s, alpha = mu.float(), s.float(), alpha.float()
    den = alpha * s + 1.0
    c = alpha / den
    mu_c = mu - zeta.float()
    n, q = den.shape
    pad = torch.ones((n, -q % 8), dtype=den.dtype)
    prods = torch.cat([den, pad], dim=-1).reshape(n, -1, 8).prod(-1)
    l1 = torch.log(sf2.float()).double() - 0.5 * torch.log(prods).double().sum(-1)
    rc = ((l1 - 0.5 * (c * mu_c * mu_c).double().sum(-1)) * LOG2E + shift).float()
    a = torch.cat([(c * mu_c) * LOG2E, -(0.5 * c) * LOG2E], dim=-1).float()
    return a, rc, c, den, mu_c


def exponents1(mu, s, z, sf2, alpha, zeta=None, shift=0):
    """The (N, M) base-2 Psi1 exponents of the kernels' tile arithmetic plus
    ``shift``, with (c1, den1, mu', z') beside them; past
    ``PSI1_BUCKET_MAX`` K is walked in chunks."""
    if zeta is None:
        zeta = z.float().mean(0)
    q = z.shape[1]
    a, rc, c, den, mu_c = _row_terms1(mu, s, alpha, sf2, zeta, shift)
    zc = z.float() - zeta.float()
    b = torch.cat([zc, zc * zc], dim=-1)
    l1 = tc_matmul(a, b, k_chunks(q) if q > PSI1_BUCKET_MAX else None, fresh=True) + rc[:, None]
    return l1, c, den, mu_c, zc


def _shift1_for(s, alpha, sf2, shift):
    return shift1_of(s, alpha, sf2) if shift is None else shift


def _weighted_psi1(mu, s, z, sf2, alpha, w, zeta, shift):
    """(p = w exp2(L1 + S1) (N, M) float32, 2^-S1, c1, den1, mu', z')."""
    sh = _shift1_for(s, alpha, sf2, shift)
    l1, c, den, mu_c, zc = exponents1(mu, s, z, sf2, alpha, zeta, sh)
    return w.float()[:, None] * ex2(l1), 2.0 ** -sh, c, den, mu_c, zc


def psi1y_sum(mu, s, z, sf2, alpha, y, w, zeta=None, shift=None):
    """Psi1^T (w Y) (M, D) in float64: p^T Y over tiles of 64 rows, each a
    3-term TF32 product, the tiles added in float64, scaled by 2^-S1
    (``shift`` S1: None for the kernels' own)."""
    p, unshift, *_ = _weighted_psi1(mu, s, z, sf2, alpha, w, zeta, shift)
    return _tiled_tc(p.T.contiguous(), y.float().T.contiguous(), p.shape[0]) * unshift


def _pair_sums(x, tile):
    """Sums of x (R, C, ...) over C as the Psi1 kernels take them: float32
    over tiles of ``tile`` along C, the tiles added in float64."""
    return sum(x[:, k0:k0 + tile].sum(1).double() for k0 in range(0, x.shape[1], tile))


def centred_sums1(h, c, mu_c, zc, sums="pair"):
    """(H (N,), t (N, Q), u (N, Q), b (Q, M)) in float64 from h (N, M), c1
    and mu' (N, Q), z' (M, Q), float32: H = sum_m h, t = sum_m h (mu' - z'),
    u = sum_m h (mu' - z')^2, b = sum_n h c1 (mu' - z'). ``sums`` as
    ``psi1_bwd`` takes it; H is a float32 sum over tiles of 64 either way."""
    n, m = h.shape
    hsum = _tile_sums(h)
    if sums == "pair":
        dd = mu_c[:, None, :] - zc[None, :, :]                   # (N, M, Q)
        hd = h[..., None] * dd
        t = _pair_sums(hd, TILE)
        u = _pair_sums(hd * dd, TILE)
        hc = (h[..., None] * c[:, None, :]) * dd                 # (N, M, Q)
        b = _pair_sums(hc.transpose(0, 1), TILE).T               # (Q, M)
    elif sums == "expanded":
        prod = lambda x, y, length: _tiled_tc(x, y.T.contiguous(), length)
        t1, t2 = prod(h, zc, m), prod(h, zc * zc, m)             # (N, Q)
        mu64, h64 = mu_c.double(), hsum[:, None]
        t = mu64 * h64 - t1
        u = mu64 * mu64 * h64 - 2.0 * mu64 * t1 + t2
        h_t = h.T.contiguous()
        b = (prod(h_t, c * mu_c, n) - zc.double() * prod(h_t, c, n)).T
    else:
        raise ValueError(f"sums must be 'pair' or 'expanded', got {sums!r}")
    return hsum, t, u, b.contiguous()


def psi1_bwd(mu, s, z, sf2, alpha, y, w, dp1y, zeta=None, shift=None, sums="pair"):
    """The Psi1 part of the backward kernels' reductions against the
    cotangent dp1y (M, D): the row pass's (dmu, ds, dalpha share) (N, Q) and
    dy (N, D), and the point pass's centred sums b_q = sum_n h c1 (mu' -
    z')_q (Q, M), float64. h = p (y . dp1y_m), the dot a 3-term TF32
    product over D in chunks of DCHUNK, each chunk's product formed on its
    own and added in float32; dY = sum p dp1y a 3-term TF32 product per
    tile of 64 points. The centred sums (``centred_sums1``), ``sums``
    "pair" (what the kernels run): per tile of 64 points H = sum h, t = sum
    h (mu' - z'), u = sum h (mu' - z')^2, per tile of 64 rows b = sum h c1
    (mu' - z'), pair by pair in float32, the tiles added in float64.
    "expanded": T1 = sum h z', T2 = sum h z'^2, S1 = sum h c1 mu', S2 = sum
    h c1 as further 3-term TF32 products over the same tiles, combined in
    float64 into t = mu' H - T1, u = mu'^2 H - 2 mu' T1 + T2, b = S1 - z'
    S2; kept to show that these cancel where the latents lie far from zeta
    (tests/test_torch_psi1_tc.py)."""
    p, unshift, c, den, mu_c, zc = _weighted_psi1(mu, s, z, sf2, alpha, w, zeta, shift)
    m = p.shape[1]
    d = y.shape[1]
    r = dp1y.float()
    dchunks = [torch.arange(k, min(k + DCHUNK, d)) for k in range(0, d, DCHUNK)]
    h = p * tc_matmul(y.float(), r, dchunks, fresh=True)
    hsum, t, u, b = (x * unshift for x in centred_sums1(h, c, mu_c, zc, sums))
    dy = _tiled_tc(p, r.T.contiguous(), m) * unshift
    t32, u32, h32 = t.float(), u.float(), hsum.float()[:, None]
    dmu = -c * t32
    ds = -0.5 * c * h32 + 0.5 * c * c * u32
    dal = -0.5 * (s.float() / den) * h32 - 0.5 * u32 / (den * den)
    return dmu.double(), ds.double(), dal.double(), dy, b.contiguous()


def psi1_vjp(mu, s, z, sf2, alpha, y, w, dp1y, zeta=None, shift=None, sums="pair"):
    """(Psi1^T (w Y), (dmu, ds, dz, dsf2, dalpha, dy)) against the cotangent
    dp1y (M, D): the model's statistic, and its reductions (``psi1_bwd``,
    ``sums``) assembled by ``psi_cuda._assemble_bwd`` in float32 as the
    wrapper assembles the kernels' (no Psi2 part: its cotangent is zero)."""
    from gparml_tpu_torch.ops.psi_cuda import _assemble_bwd

    m, q = z.shape
    f = lambda x: x.float()
    p1y = psi1y_sum(mu, s, z, sf2, alpha, y, w, zeta, shift)
    dmu, ds, dal, dy, b = psi1_bwd(mu, s, z, sf2, alpha, y, w, dp1y, zeta, shift, sums)
    zero = torch.zeros((m, m))
    dz, dsf2, dalpha = _assemble_bwd(f(z), f(sf2), f(alpha), p1y.float(), zero, f(dp1y), zero,
                                     torch.zeros((m, m, q)), dal.float().sum(0),
                                     torch.zeros((q, m, m)), b.float())
    return p1y, (dmu, ds, dz, dsf2, dalpha, dy)
