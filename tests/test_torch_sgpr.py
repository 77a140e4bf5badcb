"""The port's sparse GP regression against the JAX package on the CPU: the
SGPR (s=None) statistics, unblocked, blocked, weighted and in the qn layout,
with gradients; ``models/sgpr.py`` (bound and gradient, the SCG and Adam
trajectories, prediction, the fits of tests/test_models.py); the oracle's
bound and dense-GP limit; carrying SGPR parameters and checkpoints across
packages; and the CLI's --fixed-embeddings mode against the JAX CLI.
float64 at rtol 1e-8 unless a test says otherwise; these paths reach no
Pallas kernel in either package."""

import json
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gparml_tpu import checkpoint as jckpt  # noqa: E402
from gparml_tpu import cli as jcli  # noqa: E402
from gparml_tpu.models import params as JP  # noqa: E402
from gparml_tpu.models import sgpr as js  # noqa: E402
from gparml_tpu.ops import psi as jpsi  # noqa: E402
from gparml_tpu_torch import checkpoint as tckpt  # noqa: E402
from gparml_tpu_torch import cli as tcli  # noqa: E402
from gparml_tpu_torch import data as tdata  # noqa: E402
from gparml_tpu_torch.models import gplvm as tg  # noqa: E402
from gparml_tpu_torch.models import params as TP  # noqa: E402
from gparml_tpu_torch.models import sgpr as ts  # noqa: E402
from gparml_tpu_torch.ops import bound as tbound  # noqa: E402
from gparml_tpu_torch.ops import psi as tpsi  # noqa: E402
from tests import oracle  # noqa: E402

torch.set_num_threads(2)

CPU = ["--device", "cpu"]


def _close(got, want, rtol=1e-8):
    want = np.asarray(want)
    got = got.detach().numpy() if hasattr(got, "detach") else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


def _regression(n=48, q=2, d=3, m=7, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, (n, q))
    y = np.sin(x @ rng.standard_normal((q, d))) + 0.1 * rng.standard_normal((n, d))
    return dict(x=x, y=y, z=rng.standard_normal((m, q)), sf2=np.asarray(1.3),
                alpha=0.5 + rng.random(q), w=rng.uniform(0.0, 2.0, n))


@pytest.mark.parametrize("layout", ["nq", "qn"])
@pytest.mark.parametrize("block, weighted", [(None, False), (12, False), (None, True),
                                             (16, True)],
                         ids=["plain", "blocked", "weighted", "weighted-blocked"])
def test_sgpr_statistics_and_gradients_match_jax(layout, block, weighted):
    """psi.suff_stats(_t) with s=None: Psi1^T (w Y), K_NM^T diag(w) K_NM,
    psi0, yy, KL = 0 and n, and the gradients of a probe of them in (x, z,
    sf2, alpha), against the JAX function."""
    pr = _regression()
    w = pr["w"] if weighted else None
    rng = np.random.default_rng(1)
    probe = [rng.standard_normal(()), rng.standard_normal((7, 3)), rng.standard_normal((7, 7)),
             rng.standard_normal(())]

    def f_jax(x, z, sf2, alpha):
        st = jpsi.suff_stats(jnp.asarray(pr["y"]), x, None, z, sf2, alpha, block=block,
                             weights=None if w is None else jnp.asarray(w))
        return st, sum(jnp.sum(a * b) for a, b in zip((st.psi0, st.psi1_y, st.psi2, st.yy),
                                                     probe))

    args = [jnp.asarray(pr[k]) for k in ("x", "z", "sf2", "alpha")]
    stj, _ = f_jax(*args)
    grads_j = jax.grad(lambda *a: f_jax(*a)[1], argnums=(0, 1, 2, 3))(*args)

    xs = [torch.tensor(pr[k]).requires_grad_(True) for k in ("x", "z", "sf2", "alpha")]
    wt = None if w is None else torch.tensor(w)
    if layout == "qn":
        st = tpsi.suff_stats_t(torch.tensor(pr["y"].T.copy()), xs[0].T, None, *xs[1:],
                               block=block, weights=wt)
    else:
        st = tpsi.suff_stats(torch.tensor(pr["y"]), xs[0], None, *xs[1:], block=block,
                             weights=wt)
    for a, b in zip(st, stj):
        _close(a, b)
    f = sum(torch.sum(a * torch.tensor(b)) for a, b in
            zip((st.psi0, st.psi1_y, st.psi2, st.yy), probe))
    for a, b in zip(torch.autograd.grad(f, xs), grads_j):
        _close(a, b)


def test_synthetic_regression_matches_jax_package():
    from gparml_tpu import data as jdata

    for a, b in zip(tdata.synthetic_regression(n=50, noise_std=0.3, seed=3),
                    jdata.synthetic_regression(n=50, noise_std=0.3, seed=3)):
        np.testing.assert_array_equal(a, b)


def test_sgpr_bound_matches_oracle():
    rng = np.random.default_rng(0)
    y, x, z = rng.standard_normal((12, 3)), rng.standard_normal((12, 2)), rng.standard_normal((5, 2))
    sf2, alpha, beta = 1.3, rng.uniform(0.3, 2.0, 2), 2.1
    t = lambda a: torch.tensor(np.asarray(a, np.float64))
    st = tpsi.suff_stats(t(y), t(x), None, t(z), t(sf2), t(alpha))
    got = tbound.bound_from_stats(st, t(z), t(sf2), t(alpha), t(beta), d=3)
    np.testing.assert_allclose(float(got), oracle.bound(y, x, None, z, sf2, alpha, beta),
                               rtol=1e-8)


def test_dense_gp_limit_and_upper_bound():
    """With Z = X and a tiny jitter the bound is the dense GP marginal
    likelihood; with M < N inducing points it lies below it."""
    rng = np.random.default_rng(0)
    n, d, q = 10, 2, 1
    x, y = rng.standard_normal((n, q)), rng.standard_normal((n, d))
    sf2, beta, alpha = 1.1, 2.0, np.ones(q)
    t = lambda a: torch.tensor(np.asarray(a, np.float64))
    st = tpsi.suff_stats(t(y), t(x), None, t(x), t(sf2), t(alpha))
    got = tbound.bound_from_stats(st, t(x), t(sf2), t(alpha), t(beta), d=d, jitter=1e-10)
    want = oracle.dense_gp_loglik(y, x, sf2, alpha, beta)
    np.testing.assert_allclose(float(got), want, rtol=1e-5)
    z = x[:4]
    st = tpsi.suff_stats(t(y), t(x), None, t(z), t(sf2), t(alpha))
    assert float(tbound.bound_from_stats(st, t(z), t(sf2), t(alpha), t(beta), d=d)) < want


def _models(layout="nq", seed=0, weighted=False):
    pr = _regression(seed=seed)
    host = (lambda a: np.ascontiguousarray(a.T)) if layout == "qn" else (lambda a: a)
    x, y = host(pr["x"]), host(pr["y"])
    jcfg = js.SGPRConfig(num_inducing=7, layout=layout, scg_mode="stepped")
    tcfg = ts.SGPRConfig(num_inducing=7, layout=layout)
    g = js.init_params(jax.random.PRNGKey(seed), jnp.asarray(x), jnp.asarray(y), jcfg)
    gt = TP.global_from_numpy(jax.tree.map(np.asarray, g), device="cpu")
    w = pr["w"] if weighted else None
    return jcfg, tcfg, g, gt, x, y, w


@pytest.mark.parametrize("layout, weighted", [("nq", False), ("nq", True), ("qn", False)])
def test_sgpr_bound_gradient_and_predict_match_jax(layout, weighted):
    jcfg, tcfg, g, gt, x, y, w = _models(layout, weighted=weighted)
    wj = None if w is None else jnp.asarray(w)
    wt = None if w is None else torch.tensor(w)
    fj, gj = js.neg_bound_value_and_grad(g, jnp.asarray(x), jnp.asarray(y), jcfg, weights=wj)
    ft, gtr = ts.neg_bound_value_and_grad(gt, torch.tensor(x), torch.tensor(y), tcfg,
                                          weights=wt)
    _close(ft, fj)
    for a, b in zip(gtr, jax.tree.leaves(gj)):
        _close(a, b)
    x_star = np.linspace(-2, 2, 9)[:, None] * np.ones((1, 2))
    want = js.predict(g, jnp.asarray(x), jnp.asarray(y), jnp.asarray(x_star), jcfg, weights=wj)
    got = ts.predict(gt, torch.tensor(x), torch.tensor(y), torch.tensor(x_star), tcfg,
                     weights=wt)
    for a, b in zip(got, want):
        _close(a, b)


def test_init_params_defaults_match_jax():
    """The data-driven hypers (sf2 = var Y, alpha = 1/var X, beta = 10/var
    Y) are the JAX package's; Z is drawn from rows of X by each package's
    own generator, plus a small jitter."""
    jcfg, tcfg, g, _, x, y, _ = _models()
    gt = ts.init_params(torch.Generator().manual_seed(0), torch.tensor(x), torch.tensor(y), tcfg)
    for name in ("u_sf2", "u_alpha", "u_beta"):
        _close(getattr(gt, name), getattr(g, name))
    assert tuple(gt.z.shape) == (7, 2)
    dist = ((gt.z.detach().numpy()[:, None] - x[None]) ** 2).sum(-1).min(1)
    assert np.all(dist < 1e-2)


@pytest.mark.parametrize("optimizer", ["scg", "adam"])
def test_fit_trajectory_matches_jax(optimizer):
    jcfg, tcfg, g, gt, x, y, _ = _models(seed=1)
    kw = dict(iters=8, optimizer=optimizer, learning_rate=5e-2)
    rj = js.fit(g, jnp.asarray(x), jnp.asarray(y), jcfg, **kw)
    rt = ts.fit(gt, torch.tensor(x), torch.tensor(y), tcfg, **kw)
    np.testing.assert_allclose(rt.history[:8], np.asarray(rj.history)[:8], rtol=1e-8)
    if optimizer == "scg":
        np.testing.assert_array_equal(rt.trace["accepted"][:8],
                                      np.asarray(rj.trace["accepted"])[:8])
    assert rt.n_evals == int(rj.n_evals)
    np.testing.assert_allclose(rt.bound, float(rj.bound), rtol=1e-8)
    for a, b in zip(TP.leaves(rt.params), jax.tree.leaves(rj.params)):
        _close(a, b, 1e-6)


def test_float32_bound_is_the_jax_packages_where_k_mm_is_ill_conditioned():
    """At the init of 100 inducing points on one input dimension K_MM is
    nearly singular, and the float32 bound's PSD-by-construction form (the
    jitter 30 eps tr(Psi2)) is another function than the float64 bound: in
    both packages alike. (The float32 sums differ between the packages'
    BLAS, so they agree to 1e-3 here, not to the last bits.)"""
    x, y = tdata.synthetic_regression(n=2000, seed=0)
    x32, y32 = x.astype(np.float32), y.astype(np.float32)
    jcfg = js.SGPRConfig(num_inducing=100)
    g = js.init_params(jax.random.PRNGKey(0), jnp.asarray(x32), jnp.asarray(y32), jcfg)
    want = float(js.log_bound(g, jnp.asarray(x32), jnp.asarray(y32), jcfg))
    want64 = float(js.log_bound(jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), g),
                                jnp.asarray(x), jnp.asarray(y), jcfg))
    gt = TP.global_from_numpy(jax.tree.map(np.asarray, g), device="cpu")
    got = float(ts.log_bound(gt, torch.tensor(x32), torch.tensor(y32),
                             ts.SGPRConfig(num_inducing=100)).detach())
    assert abs(got - want) <= 1e-3 * abs(want)
    assert abs(want - want64) > 0.5 * abs(want64)


def test_sgpr_recovers_noise_and_fits():
    """Mirror of tests/test_models.py: SCG raises the bound, finds the noise
    precision and predicts the function."""
    rng = np.random.default_rng(3)
    n = 200
    x = np.sort(rng.uniform(-3, 3, (n, 1)), axis=0)
    y = np.sin(2.0 * x) + rng.standard_normal((n, 1)) / np.sqrt(25.0)
    xt, yt = torch.tensor(x), torch.tensor(y)
    cfg = ts.SGPRConfig(num_inducing=12)
    res = ts.fit(ts.init_params(torch.Generator().manual_seed(0), xt, yt, cfg), xt, yt, cfg,
                 iters=150)
    hist = res.history[np.isfinite(res.history)]
    assert hist[-1] > hist[0] + 10.0
    assert 10.0 < float(TP.constrain(res.params)[3].detach()) < 60.0
    mean, _ = ts.predict(res.params, xt, yt, xt, cfg)
    assert float(np.sqrt(np.mean((mean.detach().numpy() - np.sin(2.0 * x)) ** 2))) < 0.1


def test_sgpr_adam_also_improves():
    rng = np.random.default_rng(4)
    x = rng.uniform(-2, 2, (100, 1))
    y = np.cos(x) + 0.1 * rng.standard_normal((100, 1))
    xt, yt = torch.tensor(x), torch.tensor(y)
    cfg = ts.SGPRConfig(num_inducing=8)
    res = ts.fit(ts.init_params(torch.Generator().manual_seed(1), xt, yt, cfg), xt, yt, cfg,
                 iters=200, optimizer="adam", learning_rate=5e-2)
    assert res.history[-1] > res.history[0]


def test_sgpr_f32_fit_matches_f64_optimum():
    """Mirror of tests/test_models.py: the float32 fit lands at the float64
    optimum (the bound's clamps hold the trace term's f32 artifact)."""
    rng = np.random.default_rng(0)
    n = 400
    x = np.sort(rng.uniform(-3, 3, (n, 1)), axis=0).astype(np.float32)
    y = (np.sin(1.5 * x) + 0.2 * rng.standard_normal((n, 1))).astype(np.float32)
    xt, yt = torch.tensor(x), torch.tensor(y)
    cfg = ts.SGPRConfig(num_inducing=12)
    g0 = ts.init_params(torch.Generator().manual_seed(0), xt, yt, cfg)
    assert g0.z.dtype == torch.float32
    res = ts.fit(g0, xt, yt, cfg, iters=120)
    hist = res.history[np.isfinite(res.history)]
    assert hist[-1] > hist[0]
    _, sf2, _, beta = TP.constrain(res.params)
    assert 10.0 < float(beta) < 80.0 and float(sf2) < 50.0
    mean, _ = ts.predict(res.params, xt, yt, xt[:50], cfg)
    assert float(np.sqrt(np.mean((mean.detach().numpy() - np.sin(1.5 * x[:50])) ** 2))) < 0.15


def test_gplvm_fixed_embeddings_keeps_latents():
    rng = np.random.default_rng(6)
    y = torch.tensor(rng.standard_normal((40, 4)))
    cfg = tg.GPLVMConfig(q=2, num_inducing=8, fixed_embeddings=True)
    p0 = tg.init_params(torch.Generator().manual_seed(3), y, cfg)
    res = tg.fit(p0, y, cfg, iters=30)
    assert torch.equal(res.params.lat.mu, p0.lat.mu)
    assert torch.equal(res.params.lat.u_s, p0.lat.u_s)
    assert not torch.equal(res.params.glob.z, p0.glob.z)


def test_global_params_cross_packages_and_checkpoints(tmp_path):
    """global_from_numpy / global_to_numpy carry SGPR parameters between the
    packages, and an SGPR checkpoint.npz loads in either."""
    _, _, g, gt, _, _, _ = _models()
    back = TP.global_to_numpy(gt)
    for a, b in zip(back, jax.tree.leaves(g)):
        np.testing.assert_array_equal(a, np.asarray(b))
    tckpt.save(str(tmp_path / "t.npz"), gt, meta={"bound": 1.0})
    gj, meta = jckpt.load(str(tmp_path / "t.npz"), g)
    assert meta["bound"] == 1.0
    for a, b in zip(jax.tree.leaves(gj), back):
        np.testing.assert_array_equal(np.asarray(a), b)
    jckpt.save(str(tmp_path / "j.npz"), jax.tree.map(np.asarray, g), meta={})
    g2, _ = tckpt.load(str(tmp_path / "j.npz"), gt)
    assert isinstance(g2, TP.GlobalParams)
    for a, b in zip(TP.leaves(g2), back):
        np.testing.assert_array_equal(a.numpy(), b)
    assert isinstance(JP.GlobalParams(*jax.tree.leaves(gj)), JP.GlobalParams)


def _history(stats):
    with open(stats / "bound_history.jsonl") as f:
        return [json.loads(line) for line in f]


def test_cli_fixed_embeddings_matches_jax(tmp_path):
    """--fixed-embeddings: the JAX CLI fits X from the embeddings folder and
    writes its checkpoint; then --load -T 5 --dtype float64 in both CLIs,
    each in its own copy of that folder, gives the same bound at each SCG
    iteration and the same final bound. The port's own run (its own Z
    init) raises its bound and writes the mode, the history's wall_s and
    the checkpoint, from which it resumes."""
    x, y = tdata.synthetic_regression(n=60, seed=2)
    tdata.save_partitioned(str(tmp_path / "inputs"), y, 2, prefix="Y")
    run = tmp_path / "run"
    tdata.save_embeddings(str(run / "emb"), x, np.zeros_like(x), n_partitions=2)
    base = ["-i", str(tmp_path / "inputs"), "-m", "6", "--fixed-embeddings",
            "--dtype", "float64"]
    sj0 = jcli.main(base + ["-e", str(run / "emb"), "-s", str(run / "st"), "-T", "10"])
    for who in ("jax", "port"):
        shutil.copytree(run, tmp_path / who)
    resume = ["-T", "5", "--load"]
    sj = jcli.main(base + resume + ["-e", str(tmp_path / "jax" / "emb"),
                                    "-s", str(tmp_path / "jax" / "st")])
    st = tcli.main(base + resume + ["-e", str(tmp_path / "port" / "emb"),
                                    "-s", str(tmp_path / "port" / "st"), *CPU])
    assert st["mode"] == sj["mode"] == "sgpr"
    hj = [r["bound"] for r in _history(tmp_path / "jax" / "st")]
    ht = [r["bound"] for r in _history(tmp_path / "port" / "st")]
    np.testing.assert_allclose(ht, hj, rtol=1e-8)
    np.testing.assert_allclose(st["final_bound"], sj["final_bound"], rtol=1e-8)
    assert st["n_evals"] == sj["n_evals"]

    own = tmp_path / "own"
    argv = base + ["-e", str(run / "emb"), "-s", str(own), "-T", "10", "--trace-timing", *CPU]
    s1 = tcli.main(argv)
    assert s1["mode"] == "sgpr" and set(s1) == set(sj0)
    rows = _history(own)
    assert rows[-1]["bound"] >= rows[0]["bound"]
    assert all(r["wall_s"] > 0 for r in rows if np.isfinite(r["bound"]))
    with np.load(own / "checkpoint.npz") as f:
        assert sorted(k for k in f.files if not k.startswith("__")) == [
            "u_alpha", "u_beta", "u_sf2", "z"]
    s2 = tcli.main(argv[:-3] + ["-T", "3", "--load", *CPU])
    assert s2["final_bound"] >= s1["final_bound"] - 1e-6 * abs(s1["final_bound"])


def test_cli_fixed_embeddings_checks_rows_and_qn(tmp_path):
    x, y = tdata.synthetic_regression(n=40, seed=3)
    tdata.save_partitioned(str(tmp_path / "inputs"), y, 2, prefix="Y")
    tdata.save_embeddings(str(tmp_path / "bad"), x[:30], np.zeros((30, 1)), n_partitions=1)
    with pytest.raises(ValueError, match="embeddings rows 30 != N=40"):
        tcli.main(["-i", str(tmp_path / "inputs"), "-e", str(tmp_path / "bad"),
                   "--fixed-embeddings", *CPU])
    tdata.save_embeddings(str(tmp_path / "emb"), x, np.zeros_like(x), n_partitions=2)
    common = ["-i", str(tmp_path / "inputs"), "-e", str(tmp_path / "emb"), "-m", "5",
              "-T", "6", "--fixed-embeddings", "--dtype", "float64", *CPU]
    s_nq = tcli.main(common)
    s_qn = tcli.main(common + ["--layout", "qn"])
    np.testing.assert_allclose(s_qn["final_bound"], s_nq["final_bound"], rtol=1e-8)
