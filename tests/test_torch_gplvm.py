"""The port's GPLVM slice against the JAX package: the bound and its
gradient on converted params (float64 plain engines; float32 with the JAX
Pallas kernels in interpret mode against the port's CPU path), the SCG
trajectory of a short fit, and the initialization."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gparml_tpu import data as jdata  # noqa: E402
from gparml_tpu.models import gplvm as jg  # noqa: E402
from gparml_tpu.utils import init as jinit  # noqa: E402
from gparml_tpu_torch import data as tdata  # noqa: E402
from gparml_tpu_torch.models import gplvm as tg  # noqa: E402
from gparml_tpu_torch.models import params as TP  # noqa: E402
from gparml_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from gparml_tpu_torch.utils import init as tinit  # noqa: E402

torch.set_num_threads(2)


def _setup(n, q, m, d, dtype, seed=0, alpha=None, **cfg):
    y, _ = jdata.synthetic_gplvm(n=n, d=d, seed=seed)
    y = y.astype(dtype)
    jcfg = jg.GPLVMConfig(q=q, num_inducing=m, **cfg)
    if alpha is not None:
        alpha = jnp.full((q,), alpha, dtype)
    jp = jg.init_params(jax.random.PRNGKey(seed), jnp.asarray(y), jcfg, alpha=alpha)
    tp = TP.from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return y, jcfg, jp, tp


def _tcfg(jcfg, **over):
    kw = {k: getattr(jcfg, k) for k in tg.GPLVMConfig.__dataclass_fields__}
    kw.update(over)
    return tg.GPLVMConfig(**kw)


def test_bound_and_gradient_float64_match_jax():
    y, jcfg, jp, tp = _setup(64, 3, 10, 5, np.float64, stats_impl="xla")
    cfg = _tcfg(jcfg)
    yt = torch.tensor(y)
    np.testing.assert_allclose(float(tg.log_bound(tp, yt, cfg).detach()),
                               float(jg.log_bound(jp, jnp.asarray(y), jcfg)), rtol=1e-8)
    fj, gj = jg.neg_bound_value_and_grad(jp, jnp.asarray(y), jcfg)
    ft, gt = tg.neg_bound_value_and_grad(tp, yt, cfg)
    np.testing.assert_allclose(float(ft), float(fj), rtol=1e-8)
    for (name, _), a, b in zip(tp.named_parameters(), gt, jax.tree.leaves(gj)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-8, atol=1e-10 * np.abs(b).max(),
                                   err_msg=name)


@pytest.mark.parametrize("block", [None, 16])
def test_blocked_plain_engine_matches_jax(block):
    y, jcfg, jp, tp = _setup(64, 3, 10, 5, np.float64, stats_impl="xla", block=block)
    fj, gj = jg.neg_bound_value_and_grad(jp, jnp.asarray(y), jcfg)
    ft, gt = tg.neg_bound_value_and_grad(tp, torch.tensor(y), _tcfg(jcfg))
    np.testing.assert_allclose(float(ft), float(fj), rtol=1e-8)
    for a, b in zip(gt, jax.tree.leaves(gj)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-8, atol=1e-10 * np.abs(b).max())


def test_float32_pallas_against_port_auto():
    """JAX stats_impl='pallas' (interpret mode, M=130 -> flat kernels)
    against the port's 'auto' on CPU tensors (the kernels' plain versions).
    N >= M and ARD precisions of 10 keep K_MM well conditioned: with unit
    precisions 130 inducing points put the float32 bound (of either
    package) 15% off its float64 value, and the comparison would measure
    jitter, not the statistics."""
    y, jcfg, jp, tp = _setup(160, 3, 130, 4, np.float32, alpha=10.0, stats_impl="pallas")
    jcfg = jg.GPLVMConfig(**{**jcfg.__dict__, "pallas_tile": 8})
    fj, gj = jg.neg_bound_value_and_grad(jp, jnp.asarray(y), jcfg)
    ft, gt = tg.neg_bound_value_and_grad(tp, torch.tensor(y), _tcfg(jcfg, stats_impl="auto"))
    np.testing.assert_allclose(float(ft), float(fj), rtol=1e-4)
    for (name, _), a, b in zip(tp.named_parameters(), gt, jax.tree.leaves(gj)):
        b = np.asarray(b, np.float64)
        err = np.linalg.norm(a.double().numpy() - b) / np.linalg.norm(b)
        assert err <= 1e-3, (name, err)


def test_scg_trajectory_matches_jax_stepped():
    y, jcfg, jp, tp = _setup(48, 2, 8, 4, np.float64, seed=1, stats_impl="xla",
                             scg_mode="stepped")
    rj = jg.fit(jp, jnp.asarray(y), jcfg, iters=8)
    rt = tg.fit(tp, torch.tensor(y), _tcfg(jcfg), iters=8)
    tj = {k: np.asarray(v)[:8] for k, v in rj.trace.items()}
    assert np.all(np.isfinite(rt.trace["bound"][:8]))
    np.testing.assert_allclose(rt.trace["bound"][:8], tj["bound"], rtol=1e-8)
    np.testing.assert_allclose(rt.trace["lambda"][:8], tj["lambda"], rtol=1e-6)
    np.testing.assert_allclose(rt.trace["alpha"][:8], tj["alpha"], rtol=1e-6)
    np.testing.assert_array_equal(rt.trace["accepted"][:8], tj["accepted"])
    assert rt.n_evals == int(rj.n_evals)
    np.testing.assert_allclose(rt.bound, float(rj.bound), rtol=1e-8)
    for a, b in zip(TP.leaves(rt.params), jax.tree.leaves(rj.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-9)


def test_scg_fixed_masks_match_jax():
    y, jcfg, jp, tp = _setup(32, 2, 6, 3, np.float64, seed=2, stats_impl="xla",
                             scg_mode="stepped", fixed_z=True, fixed_beta=True)
    rj = jg.fit(jp, jnp.asarray(y), jcfg, iters=4)
    rt = tg.fit(tp, torch.tensor(y), _tcfg(jcfg), iters=4)
    np.testing.assert_allclose(rt.trace["bound"][:4], np.asarray(rj.trace["bound"])[:4],
                               rtol=1e-8)
    np.testing.assert_array_equal(rt.params.glob.z.detach().numpy(), np.asarray(jp.glob.z))
    np.testing.assert_array_equal(rt.params.glob.u_beta.detach().numpy(),
                                  np.asarray(jp.glob.u_beta))


def test_scg_minimize_quadratic():
    """The host-loop SCG converges on a convex quadratic (cf. test_scg.py)."""
    from gparml_tpu_torch.opt import scg

    a = torch.diag(torch.tensor([1.0, 4.0, 9.0, 0.5], dtype=torch.float64))
    b = torch.tensor([1.0, -2.0, 3.0, 0.2], dtype=torch.float64)

    def vg(xs):
        (x,) = xs
        return 0.5 * x @ a @ x - b @ x, [a @ x - b]

    st = scg.minimize(vg, [torch.zeros(4, dtype=torch.float64)], scg.SCGOptions(max_iters=50))
    np.testing.assert_allclose(st.x[0].numpy(), np.linalg.solve(a.numpy(), b.numpy()),
                               atol=1e-4)
    assert st.done and st.iteration < 30
    hist = st.history.f[np.isfinite(st.history.f)]
    assert np.all(np.diff(hist) <= 1e-12)


def test_pca_matches_jax_up_to_sign():
    y, _ = jdata.oil_flow_like(n=200, d=12)
    got = tinit.pca(torch.tensor(y), 4).numpy()
    want = np.asarray(jinit.pca(jnp.asarray(y), 4))
    sign = np.sign(np.sum(got * want, axis=0))
    np.testing.assert_allclose(got * sign, want, rtol=1e-10, atol=1e-12)


def test_fps_matches_jax_given_start_index():
    x = np.asarray(jinit.pca(jnp.asarray(jdata.oil_flow_like(n=300, d=12)[0]), 3))
    key = jax.random.PRNGKey(7)
    z = np.asarray(jinit.init_inducing(key, jnp.asarray(x), 20))
    k1, k2 = jax.random.split(key)
    i0 = int(jax.random.randint(k1, (), 0, x.shape[0]))
    noise = np.asarray(1e-2 * jnp.maximum(jnp.std(x, axis=0), 1e-6)
                       * jax.random.normal(k2, z.shape, dtype=x.dtype))
    idx = tinit.fps_indices(torch.tensor(x), 20, i0).numpy()
    assert len(set(idx.tolist())) == 20
    np.testing.assert_allclose(x[idx], z - noise, rtol=0, atol=1e-12)


def test_init_params_shapes_and_defaults():
    y, _ = tdata.oil_flow_like(n=120, d=6)
    yt = torch.tensor(y)
    cfg = tg.GPLVMConfig(q=3, num_inducing=9)
    p = tg.init_params(torch.Generator().manual_seed(0), yt, cfg)
    assert tuple(p.lat.mu.shape) == (120, 3) and tuple(p.glob.z.shape) == (9, 3)
    np.testing.assert_allclose(p.lat.mu.detach().numpy(), tinit.pca(yt, 3).numpy())
    np.testing.assert_allclose(float(torch.exp(p.glob.u_beta.detach())), 10.0 / np.var(y),
                               rtol=1e-12)
    np.testing.assert_allclose(torch.exp(p.lat.u_s).detach().numpy(), 0.5, rtol=1e-12)
    # random init and random inducing rows also run from the generator
    pr = tg.init_params(torch.Generator().manual_seed(1), yt,
                        tg.GPLVMConfig(q=2, num_inducing=5, init="random"))
    assert torch.all(torch.isfinite(pr.lat.mu))
    z = tinit.init_inducing(torch.Generator().manual_seed(0), yt, 7, method="random")
    assert tuple(z.shape) == (7, 6)


def test_data_copies_match_jax_package():
    for fn in ("synthetic_gplvm", "oil_flow_like"):
        for a, b in zip(getattr(tdata, fn)(n=50, d=5, seed=3),
                        getattr(jdata, fn)(n=50, d=5, seed=3)):
            np.testing.assert_array_equal(a, b)


def test_fit_improves_bound_on_cpu():
    y, _ = tdata.oil_flow_like(n=80, d=6)
    yt = torch.tensor(y, dtype=torch.float32)
    cfg = tg.GPLVMConfig(q=2, num_inducing=8)
    p = tg.init_params(torch.Generator().manual_seed(0), yt, cfg)
    res = tg.fit(p, yt, cfg, iters=6)
    b = res.trace["bound"][:6]
    assert np.all(np.isfinite(b)) and np.all(np.diff(b) >= 0) and b[-1] > b[0]


@pytest.mark.parametrize("case", ["adam", "gd", "qn", "dn", "mesh"])
def test_outside_slice_raises_not_implemented(case):
    """What raised NotImplementedError for want of a mesh now runs: under a
    mesh of two CPU shards the Adam and GD fits, the bound in the qn and dn
    layouts (transposed at the boundary, as in the JAX package) and the
    nq bound equal the same calls without a mesh."""
    y = torch.tensor(np.random.default_rng(1).standard_normal((6, 3)))
    cfg = tg.GPLVMConfig(q=2, num_inducing=3)
    p = tg.init_params(torch.Generator().manual_seed(0), torch.randn(6, 3, dtype=torch.float64), cfg)
    mesh = tmesh.Mesh(["cpu"] * 2)
    if case in ("adam", "gd"):
        with_mesh = tg.fit(p, y, cfg, iters=3, optimizer=case, mesh=mesh)
        np.testing.assert_allclose(with_mesh.history,
                                   tg.fit(p, y, cfg, iters=3, optimizer=case).history,
                                   rtol=1e-12)
        return
    if case == "qn":
        cfg = tg.GPLVMConfig(q=2, num_inducing=3, layout="qn", y_layout="dn")
        p = tg.init_params(torch.Generator().manual_seed(0), y.T, cfg)
        y = y.T
    elif case == "dn":
        cfg, y = tg.GPLVMConfig(q=2, num_inducing=3, y_layout="dn"), y.T
    np.testing.assert_allclose(float(tg.log_bound(p, y, cfg, mesh=mesh).detach()),
                               float(tg.log_bound(p, y, cfg).detach()), rtol=1e-12)


def test_tpu_only_knobs_are_no_ops():
    y, _ = tdata.oil_flow_like(n=40, d=4)
    yt = torch.tensor(y)
    base = tg.GPLVMConfig(q=2, num_inducing=5)
    p = tg.init_params(torch.Generator().manual_seed(0), yt, base)
    f0 = float(tg.log_bound(p, yt, base).detach())
    for over in ({"scg_mode": "fused"}, {"scg_mode": "stepped"}, {"pallas_tile": 8}):
        cfg = tg.GPLVMConfig(q=2, num_inducing=5, **over)
        assert float(tg.log_bound(p, yt, cfg).detach()) == f0
    with pytest.raises(ValueError, match="scg_mode"):
        tg.log_bound(p, yt, tg.GPLVMConfig(q=2, num_inducing=5, scg_mode="bogus"))
