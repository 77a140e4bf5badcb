"""The tensor-core arithmetic of the Q <= 64 Psi2 kernels, on the CPU.

``gparml_tpu_torch/ops/psi_tc_model.py`` models what the kernels compute:
the exponent in expanded form as a 3-term TF32 product (operands rounded as
``cvt.rna.tf32.f32``), centred on zeta = mean(Z), constants added in float32,
exp2; the backward's reductions as the kernels run them (3-term TF32
products over tiles of 64, combined in float64). Its sum_n w_n Psi2_n, and
its reductions assembled by the wrapper's own ``psi_cuda._assemble_bwd``,
are held against
the JAX package in float64 (``psi.psi2_sum`` and its VJP) at every Q bucket
of the kernels, with the latents centred and offset by +5 (mu and Z
together), at ``chip_smoke.F64_TOL``; past Q = 64 (K chunked) at the
larger of that and twice the plain float32 engine's own error on the same
inputs, as chip_smoke holds the kernels there. At every Q the row
constants carry the exact shift 2^S, and the model flushes an exp2 result
below 2^-126 to zero, as the kernels' ``ex2.approx.ftz`` does."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from gparml_tpu.ops import psi as jpsi  # noqa: E402
from gparml_tpu_torch.ops import psi as tpsi  # noqa: E402
from gparml_tpu_torch.ops import psi_tc_model as tm  # noqa: E402
from tools.psi_tc_numerics import (  # noqa: E402
    BUCKETS, CONTROL, FLUSH_CASE, WIDE, problem, reference)

torch.set_num_threads(2)

# chip_smoke.F64_TOL: the kernels' float32 statistics against float64.
F64_TOL = 1e-5
# chip_smoke.F64_FLOOR_FACTOR: past Q = 64, times the plain f32 engine's error.
F64_FLOOR_FACTOR = 2.0
N, M = 200, 40


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def test_tf32_rounds_to_nearest_ties_away():
    x = torch.tensor([1.0, 1 + 2.0 ** -11, 1 + 2.0 ** -12, -(1 + 2.0 ** -11),
                      1 + 3 * 2.0 ** -12, 3.0e-30, -0.0])
    want = [1.0, 1 + 2.0 ** -10, 1.0, -(1 + 2.0 ** -10), 1 + 2.0 ** -10]
    got = tm.tf32(x)
    assert got[:5].tolist() == want
    bits = got.view(torch.int32)
    assert torch.all(bits & 0x1FFF == 0)
    hi, lo = tm.split(x)
    assert torch.all((hi + lo - x).abs() <= x.abs() * 2.0 ** -21)


@pytest.mark.parametrize("offset", [0.0, 5.0], ids=["centred", "offset5"])
@pytest.mark.parametrize("q", BUCKETS)
def test_tc_psi2_and_gradients_match_jax_float64(q, offset):
    mu, s, z, sf2, alpha, w, dp2 = problem(N, M, q, offset)
    want, vjp = jax.vjp(lambda *xs: jpsi.psi2_sum(*xs, w), mu, s, z, sf2, alpha)
    want_grads = vjp(dp2)
    t = lambda a: torch.tensor(a, dtype=torch.float32)
    p2, grads = tm.psi2_vjp(t(mu), t(s), t(z), t(sf2), t(alpha), t(w), t(dp2))
    errs = {"psi2": _rel(p2, want)}
    errs.update({name: _rel(g, gw) for name, g, gw in
                 zip(("mu", "s", "z", "sf2", "alpha"), grads, want_grads)})
    assert max(errs.values()) <= F64_TOL, errs


def _model_errors(q, offset, raw, shift=None):
    """({leaf: model error vs JAX float64}, the plain f32 engine's worst)."""
    pr = problem(N, M, q, offset, raw_alpha=raw)
    mu, s, z, sf2, alpha, w, dp2 = pr
    want, vjp = jax.vjp(lambda *xs: jpsi.psi2_sum(*xs, w), mu, s, z, sf2, alpha)
    want_grads = vjp(dp2)
    t = lambda a: torch.tensor(a, dtype=torch.float32)
    p2, grads = tm.psi2_vjp(t(mu), t(s), t(z), t(sf2), t(alpha), t(w), t(dp2), shift=shift)
    errs = {"psi2": _rel(p2, want)}
    errs.update({name: _rel(g, gw) for name, g, gw in
                 zip(("mu", "s", "z", "sf2", "alpha"), grads, want_grads)})
    p2_32, grads_32 = reference(*pr, torch.float32)
    plain = max([_rel(p2_32, want)] + [_rel(g, gw) for g, gw in zip(grads_32, want_grads)])
    return errs, plain


@pytest.mark.parametrize("offset", [0.0, 5.0], ids=["centred", "offset5"])
@pytest.mark.parametrize("q,raw", WIDE, ids=[f"q{q}" + ("-raw-alpha" if r else "")
                                             for q, r in WIDE])
def test_chunked_psi2_and_gradients_match_jax_float64(q, raw, offset):
    """Past Q = 64: K walked in chunks, the shift 2^S folded into the row
    constants; Q = 100 with the raw alpha puts Psi2 at and below the
    bottom of float32's normal range, which the shift brings back."""
    errs, plain = _model_errors(q, offset, raw)
    assert max(errs.values()) <= max(F64_TOL, F64_FLOOR_FACTOR * plain), (errs, plain)


def test_chunked_exponent_needs_the_shift_where_psi2_is_subnormal():
    """Without the shift (S = 0), Q = 100 with the raw alpha: g = K w e is
    mostly subnormal in float32 and its TF32 split loses its bits, so the
    gradients are far past the tolerance; that is why the kernels shift."""
    errs, _ = _model_errors(100, 0.0, True, shift=0)
    assert max(errs.values()) > 1e-3, errs


def test_bucket_64_with_raw_alpha_needs_no_shift():
    """The shift is not what keeps the Q <= 64 arithmetic accurate: at the
    widest bucket with the raw alpha the model without it (S = 0) is still
    within F64_TOL of float64."""
    errs, _ = _model_errors(*CONTROL[:1], 0.0, CONTROL[1], shift=0)
    assert max(errs.values()) <= F64_TOL, errs


def test_flushed_psi2_at_q_up_to_64_needs_the_shift():
    """At sf2 = 1e-20 (Q = 10) every Psi2 entry lies below 2^-126, where the
    kernels' ex2.approx.ftz flushes to zero: without the shift the model's
    Psi2 and every gradient leaf are zero. With it, Psi2 and the per-row
    leaves meet F64_TOL; dz, dsf2 and dalpha also read the float32 Psi2
    that the forward hands the backward (subnormal there, as the plain
    float32 engine's is), and meet the floor of twice that engine's error."""
    q, sf2 = FLUSH_CASE
    pr = problem(N, M, q, 0.0, sf2=sf2)
    mu, s, z, sf2_, alpha, w, dp2 = pr
    want, vjp = jax.vjp(lambda *xs: jpsi.psi2_sum(*xs, w), mu, s, z, sf2_, alpha)
    want_grads = vjp(dp2)
    assert float(np.max(want)) < tm.FLUSH
    t = lambda a: torch.tensor(a, dtype=torch.float32)
    names = ("psi2", "mu", "s", "z", "sf2", "alpha")
    errs = {}
    for shift in (0, None):
        p2, grads = tm.psi2_vjp(*(t(a) for a in pr), shift=shift)
        errs[shift] = dict(zip(names, [_rel(p2, want)] + [
            _rel(g, gw) for g, gw in zip(grads, want_grads)]))
    assert min(errs[0].values()) == 1.0, errs[0]
    p2_32, grads_32 = reference(*pr, torch.float32)
    plain = max([_rel(p2_32, want)] + [_rel(g, gw) for g, gw in zip(grads_32, want_grads)])
    assert max(errs[None][k] for k in ("psi2", "mu", "s")) <= F64_TOL, errs[None]
    assert max(errs[None].values()) <= F64_FLOOR_FACTOR * plain, (errs[None], plain)


def test_exponent_tile_is_the_direct_exponent():
    """The expanded, centred 3-term TF32 exponent against the direct form
    lc + E0 - sum c (zb - mu)^2 in float64, base 2, at Q=64 offset by +5."""
    mu, s, z, sf2, alpha, _, _ = problem(50, 20, 64, 5.0)
    t = lambda a: torch.tensor(a, dtype=torch.float32)
    l2 = tm.exponents(t(mu), t(s), t(z), t(sf2), t(alpha))[0].double()
    x = [torch.tensor(a, dtype=torch.float64) for a in (mu, s, z, alpha)]
    mu64, s64, z64, al64 = x
    den = 2 * al64 * s64 + 1
    c = al64 / den
    i, j = tm.cells(20)
    zb = 0.5 * (z64[i] + z64[j])
    e0 = -0.25 * (al64 * (z64[i] - z64[j]) ** 2).sum(-1)
    lc = 2 * np.log(1.3) - 0.5 * torch.log(den).sum(-1)
    ln = lc[:, None] + e0[None] - (c[:, None] * (zb[None] - mu64[:, None]) ** 2).sum(-1)
    assert float((l2 - ln * tm.LOG2E).abs().max()) <= 1e-5 * float(ln.abs().max())


def test_shift_by_zeta_changes_neither_value_nor_gradient():
    """The kernels shift mu and Z by zeta = mean(Z), taken as data: Psi2 is
    invariant under the shift, so the chain through zeta is zero and the
    gradients of the shifted function are the unshifted ones (float64)."""
    mu, s, z, sf2, alpha, w, dp2 = problem(30, 12, 10, 5.0)
    t = lambda a: torch.tensor(a, dtype=torch.float64)

    def grads(shift, detach):
        xs = [t(a).requires_grad_(True) for a in (mu, s, z, sf2, alpha)]
        zeta = xs[2].mean(0)
        zeta = zeta.detach() if detach else zeta
        m_, z_ = (xs[0] - zeta, xs[2] - zeta) if shift else (xs[0], xs[2])
        p2 = tpsi.psi2_sum(m_, xs[1], z_, xs[3], xs[4], t(w))
        return p2.detach(), torch.autograd.grad(p2, xs, grad_outputs=t(dp2))

    p_ref, g_ref = grads(False, True)
    for detach in (True, False):
        p, g = grads(True, detach)
        np.testing.assert_allclose(p.numpy(), p_ref.numpy(), rtol=1e-12, atol=1e-14)
        for a, b in zip(g, g_ref):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9, atol=1e-12)


def test_expanded_form_needs_the_centring():
    """Without the shift (zeta = 0) the expanded exponent's terms carry the
    latents' offset: at Q=64, offset +5, Psi2 is far past F64_TOL, which is
    why the kernels centre."""
    mu, s, z, sf2, alpha, w, _ = problem(N, M, 64, 5.0)
    want = np.asarray(jpsi.psi2_sum(mu, s, z, sf2, alpha, w))
    t = lambda a: torch.tensor(a, dtype=torch.float32)
    raw = tm.psi2_sum(t(mu), t(s), t(z), t(sf2), t(alpha), t(w), zeta=torch.zeros(64))
    centred = tm.psi2_sum(t(mu), t(s), t(z), t(sf2), t(alpha), t(w))
    assert _rel(raw, want) > 10 * F64_TOL
    assert _rel(centred, want) <= F64_TOL
