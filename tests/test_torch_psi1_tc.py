"""The tensor-core arithmetic of the Psi1 kernels, on the CPU.

``gparml_tpu_torch/ops/psi_tc_model.py`` (``psi1y_sum``, ``psi1_bwd``,
``psi1_vjp``) models what the Psi1 kernels compute: the exponent in
expanded form, centred on zeta = mean(Z), as a 3-term TF32 product (K
walked in chunks past Q = 16), the row constant carrying the exact shift
2^S1, exp2 with the flush of ``ex2.approx.ftz``; then Psi1^T (w Y), the dot
y . dPsi1Y_m and dY as further 3-term TF32 products over tiles of 64, and
the backward's centred row and point sums pair by pair in float32 over
tiles of 64, the tiles added in float64. Its Psi1^T (w Y) and
gradients (assembled by the wrapper's own ``psi_cuda._assemble_bwd``) are
held against the JAX package in float64: ``psi.psi1`` and ``jax.vjp`` of
Psi1^T (w Y). Tolerances as the Psi2 model's (tests/test_torch_psi_tc.py):
``chip_smoke.F64_TOL`` up to Q = 64; past it, and on latents spread far
around zeta, the larger of that and ``F64_FLOOR_FACTOR`` times the plain
float32 engine's own error on the same inputs. On such latents the
centred sums are also held against float64 alone, pair by pair and in
their tensor-core expansion, which cancels there. The file also holds ``tests/oracle.py``'s direct ``psi1`` and
``psi2`` against the port's plain engine."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
import jax  # noqa: E402
from gparml_tpu.ops import psi as jpsi  # noqa: E402
from gparml_tpu_torch.ops import psi as tpsi  # noqa: E402
from gparml_tpu_torch.ops import psi_tc_model as tm  # noqa: E402
from tests import oracle  # noqa: E402

torch.set_num_threads(2)

# chip_smoke.F64_TOL and F64_FLOOR_FACTOR.
F64_TOL = 1e-5
F64_FLOOR_FACTOR = 2.0
N, M, D = 200, 40, 5
NAMES = ("psi1_y", "mu", "s", "z", "sf2", "alpha", "y")


def _problem(q, offset, raw_alpha=False, sf2=1.3, seed=0):
    """(mu, s, z, sf2, alpha, y, w, dp1y) as float64 numpy arrays, drawn as
    chip_smoke.parity_case draws them, the latents shifted by ``offset``;
    past Q = 64 alpha scaled by 44/Q unless ``raw_alpha``. The cotangent
    scales as 1.3 / sf2, as the bound's does (through K_MM^-1)."""
    rng = np.random.default_rng(seed + 100 * q + N + M)
    mu = rng.standard_normal((N, q)) + offset
    s = 0.3 + 0.5 * rng.random((N, q))
    z = rng.standard_normal((M, q)) + offset
    alpha = 0.5 + rng.random(q)
    if q > 64 and not raw_alpha:
        alpha *= 44.0 / q
    y = rng.standard_normal((N, D))
    w = np.r_[np.ones(N - N // 10), np.zeros(N // 10)]
    dp1y = rng.standard_normal((M, D)) * (1.3 / sf2)
    return mu, s, z, np.asarray(sf2), alpha, y, w, dp1y


def _jax(pr):
    """JAX float64 Psi1^T (w Y) and its VJP in (mu, s, z, sf2, alpha, y)."""
    *xs, w, dp1y = pr
    f = lambda mu, s, z, sf2, alpha, y: jpsi.psi1(mu, s, z, sf2, alpha).T @ (w[:, None] * y)
    out, vjp = jax.vjp(f, *xs)
    return [np.asarray(out)] + [np.asarray(g) for g in vjp(dp1y)]


def _plain32(pr):
    """The port's plain engine in float32 on the same inputs."""
    *xs, w, dp1y = pr
    t = [torch.tensor(a, dtype=torch.float32).requires_grad_(True) for a in xs]
    out = tpsi.psi1(*t[:5]).T @ (torch.tensor(w, dtype=torch.float32)[:, None] * t[5])
    grads = torch.autograd.grad(out, t, grad_outputs=torch.tensor(dp1y, dtype=torch.float32))
    return [out.detach()] + list(grads)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _errors(q, offset=0.0, raw_alpha=False, sf2=1.3, shift=None):
    """({output: model error vs JAX float64}, {output: plain f32 error})."""
    pr = _problem(q, offset, raw_alpha, sf2)
    want = _jax(pr)
    t = lambda a: torch.tensor(a, dtype=torch.float32)
    p1y, grads = tm.psi1_vjp(*(t(a) for a in pr), shift=shift)
    got = [p1y] + list(grads)
    return ({k: _rel(g, w) for k, g, w in zip(NAMES, got, want)},
            {k: _rel(g, w) for k, g, w in zip(NAMES, _plain32(pr), want)})


@pytest.mark.parametrize("offset", [0.0, 5.0], ids=["centred", "offset5"])
@pytest.mark.parametrize("q", (2, 4, 10, 16, 32, 64))
def test_tc_psi1_and_gradients_match_jax_float64(q, offset):
    """Every Q bucket of the kernels (past 16 K chunked): within F64_TOL."""
    errs, _ = _errors(q, offset)
    assert max(errs.values()) <= F64_TOL, errs


@pytest.mark.parametrize("offset", [0.0, 5.0], ids=["centred", "offset5"])
@pytest.mark.parametrize("q", (65, 100, 256))
def test_chunked_psi1_and_gradients_match_jax_float64(q, offset):
    """Past Q = 64, alpha x 44/Q: within the larger of F64_TOL and twice the
    plain float32 engine's error, leaf by leaf."""
    errs, plain = _errors(q, offset)
    assert all(e <= max(F64_TOL, F64_FLOOR_FACTOR * plain[k]) for k, e in errs.items()), \
        (errs, plain)


def test_chunked_psi1_with_raw_alpha_matches_jax_float64():
    """Q = 100 with alpha unscaled (Psi1 near 1e-23): as past Q = 64."""
    errs, plain = _errors(100, raw_alpha=True)
    assert all(e <= max(F64_TOL, F64_FLOOR_FACTOR * plain[k]) for k, e in errs.items()), \
        (errs, plain)


def test_psi1_at_tiny_sf2_matches_jax_float64():
    """sf2 = 1e-20 at Q = 10 (Psi1 near 1e-21, normal in float32), the
    cotangent scaled by 1/sf2: within F64_TOL."""
    errs, _ = _errors(10, sf2=1e-20)
    assert max(errs.values()) <= F64_TOL, errs


def test_subnormal_psi1_needs_the_shift():
    """Q = 100 with the raw alpha at sf2 = 1e-20: every Psi1 entry lies below
    2^-126, where ex2.approx.ftz flushes. Without the shift (S1 = 0) every
    output is zero (error 1). With it Psi1^T (w Y) and every leaf but dsf2
    meet F64_TOL. dsf2 is assembled as sum(dPsi1Y * Psi1^T (w Y)) / sf2
    from the float32 Psi1^T (w Y) that the forward hands the backward,
    subnormal here, so it is only finite."""
    pr = _problem(100, 0.0, True, 1e-20)
    assert float(np.max(jpsi.psi1(*pr[:5]))) < tm.FLUSH
    unshifted, _ = _errors(100, raw_alpha=True, sf2=1e-20, shift=0)
    assert min(unshifted.values()) == 1.0, unshifted
    errs, _ = _errors(100, raw_alpha=True, sf2=1e-20)
    assert max(v for k, v in errs.items() if k != "sf2") <= F64_TOL, errs
    assert np.isfinite(errs["sf2"]), errs


def test_psi1_exponent_tile_is_the_direct_exponent():
    """The expanded, centred 3-term TF32 exponent against the direct form
    l1 - 1/2 sum c1 (mu - z)^2 in float64, base 2, at Q = 16 (bucket) and
    Q = 64 (K chunked), offset by +5."""
    for q in (16, 64):
        mu, s, z, sf2, alpha, *_ = _problem(q, 5.0)
        t = lambda a: torch.tensor(a, dtype=torch.float32)
        l1 = tm.exponents1(t(mu), t(s), t(z), t(sf2), t(alpha))[0].double()
        mu64, s64, z64, al64 = (torch.tensor(a) for a in (mu, s, z, alpha))
        den = al64 * s64 + 1
        ln = (np.log(1.3) - 0.5 * torch.log(den).sum(-1))[:, None] - 0.5 * (
            (al64 / den)[:, None] * (mu64[:, None] - z64[None]) ** 2).sum(-1)
        assert float((l1 - ln * tm.LOG2E).abs().max()) <= 1e-5 * float(ln.abs().max()), q


def test_psi1_expanded_form_needs_the_centring():
    """Without the shift by zeta the expanded exponent carries the latents'
    offset: at Q = 16, offset +5, the model is past F64_TOL (4.9e-5 of
    max|ref|; 4.0e-5 to 4.6e-5 at Q = 10, 32, 64), centred it is within."""
    pr = _problem(16, 5.0)
    want = _jax(pr)
    t = lambda a: torch.tensor(a, dtype=torch.float32)
    p1y, grads = tm.psi1_vjp(*(t(a) for a in pr), zeta=torch.zeros(16))
    errs = [_rel(g, w) for g, w in zip([p1y] + list(grads), want)]
    assert max(errs) > F64_TOL, errs


@pytest.mark.parametrize("q", [2, 10, 100])
def test_psi1_centred_sums_pair_by_pair_on_wide_latents(q):
    """The backward's centred sums H, t, u, b on latents of std 10 (each
    inducing point near a row, far from zeta), against their float64 values
    on the same float32 h, c1, mu', z': pair by pair (the kernels) within
    1e-6 of max|ref|; their tensor-core expansion (u = mu'^2 H - 2 mu' T1 +
    T2, b = S1 - z' S2) puts u past F64_TOL (2.8e-5 at Q = 2, 4.8e-4 at
    Q = 10, 8.1e-4 at Q = 100). On N(0, 1) latents, as ``_problem`` draws
    them, the expansion cancels little, so no test above could see it."""
    mu, s, z, alpha, rng = chip_smoke.wide_latents(q, 10.0, N, M)
    t = lambda a: torch.tensor(a, dtype=torch.float32)
    l1, c, _, mu_c, zc = tm.exponents1(t(mu), t(s), t(z), t(1.3), t(alpha))
    h = tm.ex2(l1) * t(rng.standard_normal((N, M)))
    h64, c64, mu64, z64 = (a.double() for a in (h, c, mu_c, zc))
    dd = mu64[:, None, :] - z64[None, :, :]
    want = (h64.sum(1), (h64[..., None] * dd).sum(1), (h64[..., None] * dd * dd).sum(1),
            (h64[..., None] * c64[:, None, :] * dd).sum(0).T)
    pair = [_rel(a, b) for a, b in zip(tm.centred_sums1(h, c, mu_c, zc), want)]
    expanded = [_rel(a, b) for a, b in zip(tm.centred_sums1(h, c, mu_c, zc, "expanded"), want)]
    assert max(pair) <= 1e-6, pair
    assert expanded[2] > F64_TOL, expanded


@pytest.mark.parametrize("q, spread", [(10, 2.0), (100, 3.0)])
def test_psi1_on_wide_latents_matches_jax_float64(q, spread):
    """The GPU test's wide latents (tests/test_torch_cuda.py
    ``test_psi1_kernels_on_wide_latents_match_float64``, smaller N): the
    model within max(F64_TOL, F64_FLOOR_FACTOR x the plain float32
    engine's error) of the JAX package's float64, norm-scaled, leaf by
    leaf."""
    mu, s, z, alpha, rng = chip_smoke.wide_latents(q, spread, 400, 64)
    y, dp1y = rng.standard_normal((400, 16)), rng.standard_normal((64, 16))
    pr = (mu, s, z, np.asarray(1.3), alpha, y, np.ones(400), dp1y)
    want = _jax(pr)
    t = lambda a: torch.tensor(a, dtype=torch.float32)
    p1y, grads = tm.psi1_vjp(*(t(a) for a in pr))
    nrm = lambda a, b: float(np.linalg.norm(np.asarray(a, np.float64) - b) / np.linalg.norm(b))
    for name, a, b, c in zip(NAMES, [p1y] + list(grads), _plain32(pr), want):
        assert nrm(a, c) <= max(F64_TOL, F64_FLOOR_FACTOR * nrm(b, c)), (name, nrm(a, c),
                                                                         nrm(b, c))


def test_psi1_on_init_params_latents_matches_jax_float64():
    """The port's own init_params (PCA + FPS on data.oil_flow_like, N=1000,
    Q=10, M=50; its latents reach 5.5 from zeta): within F64_TOL."""
    from gparml_tpu_torch import data
    from gparml_tpu_torch.models import gplvm, params as P

    y_np, _ = data.oil_flow_like(n=1000, d=12)
    y = torch.tensor(y_np, dtype=torch.float64)
    p = gplvm.init_params(torch.Generator().manual_seed(0), y,
                          gplvm.GPLVMConfig(q=10, num_inducing=50, stats_impl="xla"))
    z, sf2, alpha, _ = P.constrain(p.glob)
    mu, s = P.constrain_latents(p.lat)
    host = [a.detach().numpy() for a in (mu, s, z, sf2, alpha)]
    dp1y = np.random.default_rng(0).standard_normal((50, 12))
    pr = (*host, np.asarray(y_np, np.float64), np.ones(1000), dp1y)
    want = _jax(pr)
    t = lambda a: torch.tensor(a, dtype=torch.float32)
    p1y, grads = tm.psi1_vjp(*(t(a) for a in pr))
    errs = {k: _rel(g, w) for k, g, w in zip(NAMES, [p1y] + list(grads), want)}
    assert max(errs.values()) <= F64_TOL, errs


@pytest.mark.parametrize("q", [1, 3])
def test_oracle_psi1_and_psi2_match_plain_engine(q):
    """tests/oracle.py's direct loops against the port's plain engine in
    float64: psi1 entry by entry, and the per-point psi2 summed over N
    against ``psi2_sum``."""
    rng = np.random.default_rng(7 + q)
    n, m = 6, 5
    mu, s = rng.standard_normal((n, q)), 0.2 + rng.random((n, q))
    z, alpha, sf2 = rng.standard_normal((m, q)), 0.5 + rng.random(q), 1.7
    t = lambda a: torch.tensor(a, dtype=torch.float64)
    np.testing.assert_allclose(tpsi.psi1(t(mu), t(s), t(z), t(sf2), t(alpha)).numpy(),
                               oracle.psi1(mu, s, z, sf2, alpha), rtol=1e-12)
    np.testing.assert_allclose(tpsi.psi2_sum(t(mu), t(s), t(z), t(sf2), t(alpha)).numpy(),
                               oracle.psi2(mu, s, z, sf2, alpha).sum(0), rtol=1e-12)
