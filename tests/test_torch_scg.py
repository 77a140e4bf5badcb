"""The port's host-loop SCG (``gparml_tpu_torch/opt/scg.py``) held to the
JAX package's SCG contracts (tests/test_scg.py): Rosenbrock convergence,
several parameter leaves with a non-increasing accepted history and a
consistent trace, and the loop's early exit once converged. The quadratic
is ``tests/test_torch_gplvm.py::test_scg_minimize_quadratic``. Float64 on
the CPU, as the JAX tests run with x64."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gparml_tpu_torch.opt import scg  # noqa: E402

F64 = torch.float64


def _value_and_grad(fn):
    """leaves -> (fn(leaves), its gradient leaves), by autograd."""
    def vg(xs):
        xs = [x.detach().requires_grad_(True) for x in xs]
        f = fn(xs)
        return f.detach(), list(torch.autograd.grad(f, xs))
    return vg


def test_rosenbrock():
    """tests/test_scg.py::test_rosenbrock: from (-1.2, 1) to (1, 1)."""
    def rosen(xs):
        (x,) = xs
        return torch.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)

    st = scg.minimize(_value_and_grad(rosen), [torch.tensor([-1.2, 1.0], dtype=F64)],
                      scg.SCGOptions(max_iters=400))
    np.testing.assert_allclose(st.x[0].numpy(), np.ones(2), atol=1e-4)


def test_pytree_params_and_monotone_history():
    """tests/test_scg.py::test_pytree_params_and_monotone_history: the JAX
    pytree {"w": (3, 2), "b": {"c": (5,)}} as the port's list of leaves;
    accepted objective values never increase (rejected steps keep the old
    value), and the trace is populated on every executed iteration."""
    def f(xs):
        w, c = xs
        return torch.sum((w - 3.0) ** 2) + torch.sum((c + 1.0) ** 4)

    x0 = [torch.zeros((3, 2), dtype=F64), torch.ones(5, dtype=F64)]
    st = scg.minimize(_value_and_grad(f), x0, scg.SCGOptions(max_iters=100))
    np.testing.assert_allclose(st.x[0].numpy(), 3.0, atol=1e-5)
    np.testing.assert_allclose(st.x[1].numpy(), -1.0, atol=1e-2)
    hist = st.history.f
    valid = np.isfinite(hist)
    assert np.all(np.diff(hist[valid]) <= 1e-12)
    assert np.all(np.isfinite(st.history.gnorm2[valid]))
    assert np.all(st.history.lam[valid] > 0)
    assert np.all(np.isfinite(st.history.alpha[valid]))
    assert st.history.accepted[valid].any()


def test_early_convergence_stops_evals():
    """tests/test_scg.py::test_early_convergence_stops_evals: once
    converged the loop exits; the history stays nan afterwards."""
    evals = []

    def vg(xs):
        (x,) = xs
        evals.append(1)
        return torch.sum(x ** 2), [2.0 * x]

    st = scg.minimize(vg, [torch.ones(3, dtype=F64)], scg.SCGOptions(max_iters=500))
    assert np.isnan(st.history.f[-1])  # converged long before 500 iterations
    assert float(st.f_now) < 1e-12
    assert st.done and len(evals) == st.n_evals < 500
