"""Parity of the port's collapsed bound (ops/bound.py) with the JAX
package's: the float64 B-form at rtol 1e-8 and the float32
PSD-by-construction form (with its trace and quad clamps) at rtol 1e-4,
values and the gradient with respect to every input."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gparml_tpu.ops import bound as jbound  # noqa: E402
from gparml_tpu.ops import psi as jpsi  # noqa: E402
from gparml_tpu_torch.ops import bound as tbound  # noqa: E402
from gparml_tpu_torch.ops import psi as tpsi  # noqa: E402
from tests.conftest import make_problem  # noqa: E402

torch.set_num_threads(2)

STAT_NAMES = ("psi0", "psi1_y", "psi2", "yy", "kl")
IN_NAMES = STAT_NAMES + ("z", "sf2", "alpha", "beta")


def _inputs(rng, clamp=False, n=40, d=3, q=2, m=6):
    y, mu, s, z, sf2, alpha, beta = make_problem(rng, n=n, d=d, q=q, m=m)
    st = jpsi.suff_stats(y, mu, s, z, sf2, alpha)
    vals = {k: np.asarray(getattr(st, k)) for k in STAT_NAMES}
    if clamp:
        # push both float32 clamps active: tr(K^-1 Psi2) > psi0 and
        # beta * quad > yy
        vals["psi0"] = vals["psi0"] * 0.05
        vals["yy"] = vals["yy"] * 0.01
    vals.update(z=z, sf2=np.asarray(sf2), alpha=alpha, beta=np.asarray(beta))
    return vals, float(n), d


def _jax(vals, n, d, dtype):
    def f(*xs):
        kw = dict(zip(IN_NAMES, xs))
        st = jpsi.SufficientStats(kw["psi0"], kw["psi1_y"], kw["psi2"], kw["yy"],
                                  kw["kl"], jnp.asarray(n, dtype))
        return jbound.bound_from_stats(st, kw["z"], kw["sf2"], kw["alpha"],
                                       kw["beta"], d=d)

    xs = [jnp.asarray(vals[k], dtype) for k in IN_NAMES]
    v, g = jax.value_and_grad(f, argnums=tuple(range(len(xs))))(*xs)
    return float(v), [np.asarray(x, np.float64) for x in g]


def _torch(vals, n, d, dtype):
    xs = [torch.tensor(vals[k], dtype=dtype).requires_grad_(True) for k in IN_NAMES]
    kw = dict(zip(IN_NAMES, xs))
    st = tpsi.SufficientStats(kw["psi0"], kw["psi1_y"], kw["psi2"], kw["yy"],
                              kw["kl"], torch.tensor(n, dtype=dtype))
    v = tbound.bound_from_stats(st, kw["z"], kw["sf2"], kw["alpha"], kw["beta"], d=d)
    g = torch.autograd.grad(v, xs)
    return float(v.detach()), [x.double().numpy() for x in g]


def test_bound_float64_matches_jax(rng):
    vals, n, d = _inputs(rng)
    vj, gj = _jax(vals, n, d, jnp.float64)
    vt, gt = _torch(vals, n, d, torch.float64)
    np.testing.assert_allclose(vt, vj, rtol=1e-8)
    for name, a, b in zip(IN_NAMES, gt, gj):
        np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-10 * np.abs(b).max(),
                                   err_msg=name)


@pytest.mark.parametrize("clamp", [False, True])
def test_bound_float32_matches_jax(rng, clamp):
    vals, n, d = _inputs(rng, clamp=clamp)
    vj, gj = _jax(vals, n, d, jnp.float32)
    vt, gt = _torch(vals, n, d, torch.float32)
    np.testing.assert_allclose(vt, vj, rtol=1e-4)
    for name, a, b in zip(IN_NAMES, gt, gj):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4 * np.abs(b).max(),
                                   err_msg=name)
    if clamp:
        # the clamps cut the gradient paths through tr(K^-1 Psi2) and quad
        i = IN_NAMES.index("psi1_y")
        np.testing.assert_array_equal(gt[i], 0.0)


def test_chol_psi2_ladder_takes_second_rung():
    """A Psi2 whose first-rung probe fails gets the 3000*eps*tr jitter and a
    finite, differentiable factor (the JAX ladder's contract)."""
    m = 6
    v = np.random.default_rng(0).standard_normal((m, 1))
    psi2 = v @ v.T
    # slightly indefinite: below -30*eps*tr, above -3000*eps*tr
    psi2[0, 0] -= 5e-5 * np.trace(psi2)
    t = torch.tensor(psi2, dtype=torch.float32, requires_grad=True)
    with torch.no_grad():
        _, info = torch.linalg.cholesky_ex(
            t + 30.0 * torch.finfo(t.dtype).eps * torch.trace(t) * torch.eye(m))
    assert int(info) != 0
    lo = tbound._chol_psi2(t)
    want = jbound._chol_psi2(jnp.asarray(psi2, jnp.float32))
    assert torch.all(torch.isfinite(lo))
    np.testing.assert_allclose(lo.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-6)
    (g,) = torch.autograd.grad(lo.sum(), t)
    assert torch.all(torch.isfinite(g))


def test_failed_cholesky_gives_nan_not_raise():
    bad = torch.tensor([[1.0, 2.0], [2.0, 1.0]], dtype=torch.float64)
    assert torch.all(torch.isnan(tbound._cholesky(bad)))
