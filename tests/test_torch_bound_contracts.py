"""The port's bound held to the JAX package's contracts (tests/test_bound.py
and tests/test_psi.py), on the plain engine on the CPU: gradients against
finite differences, invariance to the order of the inducing points, the
float32 SGPR bound at hypers that make K_MM nearly singular, the float32
GPLVM bound and gradient at M >= 200, and the s -> 0 limits of the
Psi-statistics."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gparml_tpu_torch import data  # noqa: E402
from gparml_tpu_torch.models import gplvm, params as P, sgpr  # noqa: E402
from gparml_tpu_torch.ops import ard_rbf, bound, psi  # noqa: E402
from tests.conftest import make_problem  # noqa: E402

F64 = torch.float64


def _t(a, dtype=F64):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _bound(y, mu, s, z, sf2, alpha, beta):
    st = psi.suff_stats(y, mu, s, z, sf2, alpha)
    return bound.bound_from_stats(st, z, sf2, alpha, beta, d=y.shape[1])


def test_gradients_vs_finite_differences(rng):
    """tests/test_bound.py::test_gradients_vs_finite_differences: autograd
    of the whole GPLVM bound against central differences
    (``torch.autograd.gradcheck``, float64) in every input, at the JAX
    test's atol = rtol = 1e-5."""
    y, mu, s, z, sf2, alpha, beta = make_problem(rng, n=8, d=2, q=2, m=4)
    yt = _t(y)
    args = tuple(_t(a).requires_grad_(True) for a in (mu, s, z, sf2, alpha, beta))
    assert torch.autograd.gradcheck(lambda *xs: _bound(yt, *xs), args, atol=1e-5, rtol=1e-5)


def test_bound_invariant_to_inducing_permutation(rng):
    """tests/test_bound.py::test_bound_invariant_to_inducing_permutation:
    permuting the rows of Z leaves the bound invariant (rtol 1e-10)."""
    y, mu, s, z, sf2, alpha, beta = make_problem(rng)
    perm = rng.permutation(z.shape[0])
    f = lambda zz: float(_bound(_t(y), _t(mu), _t(s), _t(zz), _t(sf2), _t(alpha), _t(beta)))
    np.testing.assert_allclose(f(z), f(z[perm]), rtol=1e-10)


def test_f32_bound_bounded_under_ill_conditioning(rng):
    """tests/test_bound.py::test_f32_bound_bounded_under_ill_conditioning,
    through the whole float32 SGPR bound (``sgpr.log_bound``: constrained
    globals, statistics, bound): at a long lengthscale with large sf2 and
    beta K_MM is nearly rank-1 in float32, and the solves can overshoot
    the exact inequalities tr(K_MM^-1 Psi2) <= psi0 and beta^2 quad <= beta
    yy (unclamped the JAX package once read ~+5e9 here). The bound must
    stay finite and negative and above -1e9."""
    n, d, q, m = 400, 1, 1, 12
    x = np.sort(rng.uniform(-3, 3, (n, q)), axis=0)
    y = np.sin(1.5 * x) + 0.2 * rng.standard_normal((n, d))
    z = np.linspace(-3, 3, m)[:, None]
    sf2, alpha, beta = 975.0, np.array([0.0188]), 22539.0
    f32 = lambda a: _t(a, torch.float32)
    g = P.make_global(f32(z), f32(sf2), f32(alpha), f32(beta))
    value = float(sgpr.log_bound(g, f32(x), f32(y), sgpr.SGPRConfig(num_inducing=m)))
    assert np.isfinite(value) and -1e9 < value < 0.0, value


@pytest.mark.parametrize("m", [200, 260])
def test_f32_bound_finite_at_large_m(m):
    """tests/test_bound.py::test_f32_bound_finite_at_large_m: the float32
    GPLVM bound and every gradient leaf finite at M=200 (where a mean-scaled
    Psi2 jitter once broke the float32 Cholesky), and at M=260, the JAX
    test's second size, on the port's ``data.synthetic_gplvm`` with the
    plain engine (``stats_impl="xla"``)."""
    y_np, _ = data.synthetic_gplvm(n=3000, d=6, q_true=2, seed=9)
    y = _t(y_np, torch.float32)
    cfg = gplvm.GPLVMConfig(q=3, num_inducing=m, stats_impl="xla")
    p0 = gplvm.init_params(torch.Generator().manual_seed(0), y, cfg)
    f, grads = gplvm.neg_bound_value_and_grad(p0, y, cfg)
    assert np.isfinite(float(f)), m
    assert all(bool(torch.all(torch.isfinite(g))) for g in grads), m


def test_s_to_zero_limits(rng):
    """tests/test_psi.py::test_s_to_zero_limits: as s -> 0, Psi1 -> K_NM
    and sum Psi2 -> K_NM^T K_NM (rtol 1e-7)."""
    y, mu, s, z, sf2, alpha, beta = make_problem(rng)
    s0 = np.full_like(mu, 1e-14)
    knm = ard_rbf.k(_t(mu), _t(z), _t(sf2), _t(alpha)).numpy()
    p1 = psi.psi1(_t(mu), _t(s0), _t(z), _t(sf2), _t(alpha)).numpy()
    np.testing.assert_allclose(p1, knm, rtol=1e-7)
    p2 = psi.psi2_sum(_t(mu), _t(s0), _t(z), _t(sf2), _t(alpha)).numpy()
    np.testing.assert_allclose(p2, knm.T @ knm, rtol=1e-7)
