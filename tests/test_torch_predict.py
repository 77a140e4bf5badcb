"""The port's prediction and latent inference against the JAX package on the
CPU: ``ops/bound.py`` ``posterior``, ``predict`` and ``predict_uncertain``
(float64 at rtol 1e-8, float32 at 1e-4), the GPLVM's ``predict_observed``,
``reconstruct`` and ``infer_latents`` (float64, nq and qn/dn), and the
oracle mirrors of tests/test_bound.py (prediction recovers the function,
matches Monte Carlo and per-point solves). Inputs come from numpy with a
seed; the JAX side runs its XLA engine (these paths reach no Pallas
kernel)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gparml_tpu.models import gplvm as jg  # noqa: E402
from gparml_tpu.ops import bound as jbound  # noqa: E402
from gparml_tpu.ops import psi as jpsi  # noqa: E402
from gparml_tpu_torch import data as tdata  # noqa: E402
from gparml_tpu_torch.models import gplvm as tg  # noqa: E402
from gparml_tpu_torch.models import params as TP  # noqa: E402
from gparml_tpu_torch.ops import bound as tbound  # noqa: E402
from gparml_tpu_torch.ops import psi as tpsi  # noqa: E402
from tests import oracle  # noqa: E402

torch.set_num_threads(2)

RTOL = {np.float64: 1e-8, np.float32: 1e-4}
DTYPES = [np.float64, np.float32]
IDS = ["f64", "f32"]


def _problem(dtype, n=60, m=10, q=2, d=3, n_star=23, seed=0):
    """GPLVM statistics inputs and uncertain test points, numpy."""
    rng = np.random.default_rng(seed)
    c = lambda a: np.asarray(a, dtype)
    return dict(
        y=c(rng.standard_normal((n, d))), mu=c(rng.standard_normal((n, q))),
        s=c(0.2 + rng.random((n, q))), z=c(rng.standard_normal((m, q))),
        sf2=c(1.3), alpha=c(0.5 + rng.random(q)), beta=c(4.0),
        mu_star=c(rng.standard_normal((n_star, q))),
        s_star=c(0.1 + 0.4 * rng.random((n_star, q))))


def _stats_both(pr):
    """The same statistics from each package: (JAX, port)."""
    keys = ("y", "mu", "s", "z", "sf2", "alpha")
    sj = jpsi.suff_stats(*(jnp.asarray(pr[k]) for k in keys))
    st = tpsi.suff_stats(*(torch.tensor(pr[k]) for k in keys))
    return sj, st


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got.detach() if hasattr(got, "detach") else got),
                               want, rtol=rtol, atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_posterior_matches_jax(dtype):
    pr = _problem(dtype)
    sj, st = _stats_both(pr)
    zj, zt = jnp.asarray(pr["z"]), torch.tensor(pr["z"])
    args = ("sf2", "alpha", "beta")
    want = jbound.posterior(sj, zj, *(jnp.asarray(pr[k]) for k in args))
    got = tbound.posterior(st, zt, *(torch.tensor(pr[k]) for k in args))
    for a, b in zip(got, want):
        _close(a, b, RTOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_predict_matches_jax(dtype):
    pr = _problem(dtype)
    sj, st = _stats_both(pr)
    args = ("z", "sf2", "alpha", "beta")
    want = jbound.predict(jnp.asarray(pr["mu_star"]), sj, *(jnp.asarray(pr[k]) for k in args))
    got = tbound.predict(torch.tensor(pr["mu_star"]), st, *(torch.tensor(pr[k]) for k in args))
    for a, b in zip(got, want):
        _close(a, b, RTOL[dtype])


@pytest.mark.parametrize("block", [1024, 7, 1], ids=["one-block", "ragged", "block1"])
@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_predict_uncertain_matches_jax(dtype, block):
    """Against the JAX function at its default block; block 7 does not
    divide N* = 23 (padded rows dropped) and block 1 is one point a slab."""
    pr = _problem(dtype)
    sj, st = _stats_both(pr)
    args = ("z", "sf2", "alpha", "beta")
    want = jbound.predict_uncertain(jnp.asarray(pr["mu_star"]), jnp.asarray(pr["s_star"]), sj,
                                    *(jnp.asarray(pr[k]) for k in args))
    got = tbound.predict_uncertain(torch.tensor(pr["mu_star"]), torch.tensor(pr["s_star"]),
                                   st, *(torch.tensor(pr[k]) for k in args), block=block)
    for a, b in zip(got, want):
        _close(a, b, RTOL[dtype])


def test_predict_uncertain_block_1_equals_block_1024_and_empty_batch():
    pr = _problem(np.float64)
    _, st = _stats_both(pr)
    t = {k: torch.tensor(v) for k, v in pr.items()}
    rest = (t["z"], t["sf2"], t["alpha"], t["beta"])
    m1, v1 = tbound.predict_uncertain(t["mu_star"], t["s_star"], st, *rest, block=1)
    m2, v2 = tbound.predict_uncertain(t["mu_star"], t["s_star"], st, *rest, block=1024)
    torch.testing.assert_close(m1, m2, rtol=1e-12, atol=0)
    torch.testing.assert_close(v1, v2, rtol=1e-12, atol=0)
    m_e, v_e = tbound.predict_uncertain(t["mu_star"][:0], t["s_star"][:0], st, *rest)
    assert m_e.shape == (0, 3) and v_e.shape == (0,)


# --- oracle mirrors (tests/test_bound.py) ------------------------------------

def _sgpr_stats(y, x, z, sf2, alpha):
    t = lambda a: torch.tensor(np.asarray(a, np.float64))
    return tpsi.suff_stats(t(y), t(x), None, t(z), t(sf2), t(alpha))


def test_predict_recovers_function():
    """SGPR prediction on near-noiseless data interpolates the training data."""
    n, m = 40, 16
    x = np.linspace(-3, 3, n)[:, None]
    y = np.sin(x)
    z = np.linspace(-3, 3, m)[:, None]
    sf2, beta, alpha = 1.0, 1e4, np.array([1.0])
    st = _sgpr_stats(y, x, z, sf2, alpha)
    t = lambda a: torch.tensor(np.asarray(a, np.float64))
    mean, var = tbound.predict(t(x), st, t(z), t(sf2), t(alpha), t(beta))
    np.testing.assert_allclose(mean.numpy(), y, atol=2e-2)
    assert bool(torch.all(var > 0))


def test_predict_uncertain_matches_monte_carlo():
    """predict_uncertain (the reconstruction through Psi1 expectations)
    against Monte Carlo integration of predict over q(x*)."""
    rng = np.random.default_rng(1)
    n, d, q, m = 60, 2, 2, 12
    x = rng.standard_normal((n, q))
    y = np.tanh(x @ rng.standard_normal((q, d)))
    z = rng.standard_normal((m, q))
    sf2, beta, alpha = 1.0, 50.0, np.ones(q)
    st = _sgpr_stats(y, x, z, sf2, alpha)
    t = lambda a: torch.tensor(np.asarray(a, np.float64))
    mu_star, s_star = rng.standard_normal((3, q)), np.full((3, q), 0.3)
    mean_u, var_u = tbound.predict_uncertain(t(mu_star), t(s_star), st, t(z), t(sf2),
                                             t(alpha), t(beta))
    k = 4000
    xs = (mu_star[None] + np.sqrt(s_star)[None] * rng.standard_normal((k, 3, q)))
    mc, _ = tbound.predict(t(xs.reshape(k * 3, q)), st, t(z), t(sf2), t(alpha), t(beta))
    np.testing.assert_allclose(mean_u.numpy(), mc.numpy().reshape(k, 3, d).mean(0), atol=0.02)
    assert bool(torch.all(var_u > 1.0 / beta - 1e-9))


def test_predict_uncertain_matches_per_point_solves():
    """The blocked Frobenius contraction against an independent per-point
    oracle: the oracle's direct Psi2 of each point and two triangular solves
    per trace, at N* = 23 with block 8 (padding dropped)."""
    rng = np.random.default_rng(2)
    n, d, q, m = 80, 2, 2, 12
    x = rng.standard_normal((n, q))
    y = np.tanh(x @ rng.standard_normal((q, d)))
    z = rng.standard_normal((m, q))
    sf2, beta, alpha = 1.0, 50.0, np.ones(q)
    st = _sgpr_stats(y, x, z, sf2, alpha)
    t = lambda a: torch.tensor(np.asarray(a, np.float64))
    mu_star, s_star = rng.standard_normal((23, q)), 0.1 + 0.4 * rng.random((23, q))
    _, var_b = tbound.predict_uncertain(t(mu_star), t(s_star), st, t(z), t(sf2), t(alpha),
                                        t(beta), block=8)
    kmm = oracle.kern(z, z, sf2, alpha) + 1e-6 * sf2 * np.eye(m)
    a = kmm + beta * st.psi2.numpy()
    p2 = oracle.psi2(mu_star, s_star, z, sf2, alpha)           # (N*, M, M)
    tr_k = np.array([np.trace(np.linalg.solve(kmm, p)) for p in p2])
    tr_a = np.array([np.trace(np.linalg.solve(a, p)) for p in p2])
    want = np.maximum(sf2 - tr_k + tr_a, 0.0) + 1.0 / beta
    np.testing.assert_allclose(var_b.numpy(), want, rtol=1e-8)


# --- the GPLVM module ---------------------------------------------------------

def _gplvm(layout, n=50, d=4, q=2, m=8, seed=3):
    """A JAX GPLVM (float64, XLA engine) after a short fit, and its port."""
    y, _ = tdata.synthetic_gplvm(n=n + 10, d=d, q_true=1, seed=seed)
    kw = dict(layout=layout, y_layout="dn" if layout == "qn" else "nd")
    jcfg = jg.GPLVMConfig(q=q, num_inducing=m, stats_impl="xla", scg_mode="stepped", **kw)
    tcfg = tg.GPLVMConfig(q=q, num_inducing=m, stats_impl="xla", **kw)
    host = (lambda a: np.ascontiguousarray(a.T)) if layout == "qn" else (lambda a: a)
    y_tr, y_new = host(y[:n]), host(y[n:])
    jp = jg.init_params(jax.random.PRNGKey(seed), jnp.asarray(y_tr), jcfg)
    tp = TP.from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp, y_tr, y_new


@pytest.mark.parametrize("layout", ["nq", "qn"])
def test_predict_observed_and_reconstruct_match_jax(layout):
    jcfg, tcfg, jp, tp, y_tr, y_new = _gplvm(layout)
    rng = np.random.default_rng(4)
    x_star = rng.standard_normal((7, 2))
    s_star = 0.1 + rng.random((7, 2))
    want = jg.predict_observed(jp, jnp.asarray(y_tr), jnp.asarray(x_star), jcfg)
    got = tg.predict_observed(tp, torch.tensor(y_tr), torch.tensor(x_star), tcfg)
    for a, b in zip(got, want):
        _close(a, b, 1e-8)
    want = jg.reconstruct(jp, jnp.asarray(y_tr), jnp.asarray(x_star), jnp.asarray(s_star), jcfg)
    got = tg.reconstruct(tp, torch.tensor(y_tr), torch.tensor(x_star), torch.tensor(s_star),
                         tcfg, block=3)
    for a, b in zip(got, want):
        _close(a, b, 1e-8)


@pytest.mark.parametrize("layout", ["nq", "qn"])
def test_infer_latents_matches_jax(layout):
    """The nearest-neighbour init picks the JAX package's rows, and the SCG
    trace of the first iterations matches the JAX package's stepped SCG at 1e-8
    (float64, the XLA engine on both sides)."""
    jcfg, tcfg, jp, tp, y_tr, y_new = _gplvm(layout)
    rows = (lambda a: a.T) if layout == "qn" else (lambda a: a)
    d2 = ((rows(y_new)[:, None, :] - rows(y_tr)[None, :, :]) ** 2).sum(-1)
    nn = tg._nearest_rows(torch.tensor(rows(y_new)), torch.tensor(rows(y_tr)))
    np.testing.assert_array_equal(nn.numpy(), d2.argmin(1))
    iters = 6
    mu_j, s_j, rj = jg.infer_latents(jp, jnp.asarray(y_tr), jnp.asarray(y_new), jcfg,
                                     iters=iters)
    mu_t, s_t, rt = tg.infer_latents(tp, torch.tensor(y_tr), torch.tensor(y_new), tcfg,
                                     iters=iters)
    tj = {k: np.asarray(v)[:iters] for k, v in rj.trace.items()}
    assert np.all(np.isfinite(rt.trace["bound"][:iters]))
    np.testing.assert_allclose(rt.trace["bound"][:iters], tj["bound"], rtol=1e-8)
    np.testing.assert_array_equal(rt.trace["accepted"][:iters], tj["accepted"])
    assert rt.n_evals == int(rj.n_evals)
    _close(mu_t, mu_j, 1e-6)
    _close(s_t, s_j, 1e-6)


def test_infer_latents_and_reconstruct():
    """Mirror of tests/test_models.py: inferred latents of held-out
    observations reconstruct them much better than the zero-mean baseline."""
    rng = np.random.default_rng(8)
    n, n_test, d = 120, 10, 6
    t = rng.standard_normal((n + n_test, 1))
    y_all = np.tanh(t @ rng.standard_normal((1, d))) + 0.05 * rng.standard_normal((n + n_test, d))
    y_all = (y_all - y_all.mean(0)) / y_all.std(0)
    y_tr, y_te = torch.tensor(y_all[:n]), torch.tensor(y_all[n:])
    cfg = tg.GPLVMConfig(q=2, num_inducing=12)
    p0 = tg.init_params(torch.Generator().manual_seed(5), y_tr, cfg)
    res = tg.fit(p0, y_tr, cfg, iters=120)
    mu_s, s_s, inf = tg.infer_latents(res.params, y_tr, y_te, cfg, iters=60)
    assert mu_s.shape == (n_test, 2) and bool(torch.all(s_s > 0))
    hist = inf.history[np.isfinite(inf.history)]
    assert hist[-1] >= hist[0]
    mean, var = tg.reconstruct(res.params, y_tr, mu_s, s_s, cfg)
    rmse = float(torch.sqrt(torch.mean((mean.detach() - y_te) ** 2)))
    baseline = float(torch.sqrt(torch.mean(y_te ** 2)))
    assert rmse < 0.5 * baseline
    assert bool(torch.all(var > 0))
