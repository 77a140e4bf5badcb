"""The port's data-parallel statistics over a mesh of shards against the
JAX package's single-device functions, on the CPU in float64: the
counterparts of tests/test_parallel.py. A port ``Mesh`` of k ``cpu``
entries runs k shards one after another in this process, as the JAX tests'
eight virtual CPU devices do; every statistic is an exact sum over rows, so
the sharded values equal the single-device ones at the JAX tests'
tolerances (rtol 1e-12 for statistics and bound, 1e-10 for gradients).

``test_pallas_m_limit_fallback`` has no counterpart: the port's kernels
take any M, so there is no M limit to reroute past."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gparml_tpu.models import gplvm as jg  # noqa: E402
from gparml_tpu.models import params as JP  # noqa: E402
from gparml_tpu.models import sgpr as js  # noqa: E402
from gparml_tpu.ops import bound as jbound  # noqa: E402
from gparml_tpu.ops import psi as jpsi  # noqa: E402
from gparml_tpu.parallel import mesh as jmesh  # noqa: E402
from gparml_tpu_torch.models import gplvm as tg  # noqa: E402
from gparml_tpu_torch.models import params as TP  # noqa: E402
from gparml_tpu_torch.models import sgpr as ts  # noqa: E402
from gparml_tpu_torch.ops import bound as tbound  # noqa: E402
from gparml_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from gparml_tpu_torch.parallel import stats as tstats  # noqa: E402
from tests.conftest import make_problem  # noqa: E402

torch.set_num_threads(2)

SHARDS = (1, 2, 8)


def _cpu_mesh(k):
    return tmesh.Mesh(["cpu"] * k)


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float64))


def _jax_stats(y, mu, s, z, sf2, alpha):
    return jpsi.suff_stats(jnp.asarray(y), jnp.asarray(mu), None if s is None else jnp.asarray(s),
                           jnp.asarray(z), sf2, jnp.asarray(alpha))


def _assert_stats(got, want, rtol):
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=rtol)


def test_meshes_of_explicit_devices(monkeypatch):
    """The counterpart of the eight virtual CPU devices: a Mesh of repeated
    entries; make_mesh spans the visible cards and raises past them."""
    m8 = _cpu_mesh(8)
    assert m8.size == 8 and m8.local_size == 8 and m8.home == torch.device("cpu")
    assert m8.group is None and m8.num_processes == 1
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert tmesh.make_mesh().devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert tmesh.make_mesh(1).size == 1
    with pytest.raises(ValueError, match="requested 3"):
        tmesh.make_mesh(3)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="0 available"):
        tmesh.make_mesh()


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("k", SHARDS)
def test_stats_invariant_across_mesh_sizes(rng, k, impl):
    """Sharded statistics (the plain engine, or the kernels' route, whose
    plain versions run on CPU tensors) equal the JAX single-device ones."""
    y, mu, s, z, sf2, alpha, beta = make_problem(rng, n=32, d=3, q=2, m=5)
    ref = _jax_stats(y, mu, s, z, sf2, alpha)
    mesh = _cpu_mesh(k)
    ys, mus, ss, w = tmesh.shard_data(mesh, y, mu, s)
    assert all(len(t.shards) == k and t.shards[0].shape[0] == 32 // k for t in (ys, mus, ss, w))
    st = tstats.suff_stats_sharded(ys, mus, ss, _t(z), _t(sf2), _t(alpha), mesh=mesh,
                                   weights=w, impl=impl)
    _assert_stats(st, ref, 1e-12)


@pytest.mark.parametrize("k", SHARDS)
def test_bound_and_grads_invariant_across_mesh_sizes(rng, k):
    """Bound and gradients (replicated Z, sharded mu and s) under a mesh
    equal JAX's single-device value_and_grad."""
    y, mu, s, z, sf2, alpha, beta = make_problem(rng, n=32, d=3, q=2, m=5)
    alphaj = jnp.asarray(alpha)

    def ref_obj(zj, mu_, s_):
        st = jpsi.suff_stats(jnp.asarray(y), mu_, s_, zj, sf2, alphaj)
        return jbound.bound_from_stats(st, zj, sf2, alphaj, beta, d=y.shape[1])

    f_ref, g_ref = jax.value_and_grad(ref_obj, argnums=(0, 1, 2))(
        jnp.asarray(z), jnp.asarray(mu), jnp.asarray(s))
    mesh = _cpu_mesh(k)
    ys, mus, ss, w = tmesh.shard_data(mesh, y, mu, s)
    leaves = [_t(z).requires_grad_(), mus.gather().requires_grad_(),
              ss.gather().requires_grad_()]
    st = tstats.suff_stats_sharded(ys, leaves[1], leaves[2], leaves[0], _t(sf2), _t(alpha),
                                   mesh=mesh, weights=w)
    f = tbound.bound_from_stats(st, leaves[0], _t(sf2), _t(alpha), _t(beta), d=y.shape[1])
    grads = torch.autograd.grad(f, leaves)
    np.testing.assert_allclose(float(f.detach()), float(f_ref), rtol=1e-12)
    for a, b in zip(grads, g_ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10)


def test_uneven_n_padding_is_exact(rng):
    """N=29 over 8 shards: rows of ones with weight 0 keep the statistics
    exact, and the padded rows' latent gradients are exactly 0."""
    y, mu, s, z, sf2, alpha, beta = make_problem(rng, n=29, d=3, q=2, m=5)
    ref = _jax_stats(y, mu, s, z, sf2, alpha)
    mesh = _cpu_mesh(8)
    ys, mus, ss, w = tmesh.shard_data(mesh, y, mu, s)
    assert ys.shape[0] == 32 and float(w.gather().sum()) == 29.0
    np.testing.assert_array_equal(ys.gather()[29:].numpy(), np.ones((3, 3)))
    for impl in ("xla", "pallas"):
        mu_l, s_l = mus.gather().requires_grad_(), ss.gather().requires_grad_()
        st = tstats.suff_stats_sharded(ys, mu_l, s_l, _t(z), _t(sf2), _t(alpha), mesh=mesh,
                                       weights=w, impl=impl)
        _assert_stats(st, ref, 1e-12)
        assert float(st.n) == 29.0
        f = tbound.bound_from_stats(st, _t(z), _t(sf2), _t(alpha), _t(beta), d=3)
        for g in torch.autograd.grad(f, [mu_l, s_l]):
            assert torch.count_nonzero(g[29:]) == 0 and torch.count_nonzero(g[:29]) > 0


def test_sgpr_mode_sharded(rng):
    y, x, _, z, sf2, alpha, beta = make_problem(rng, n=24, d=3, q=2, m=5, latent=False)
    ref = _jax_stats(y, x, None, z, sf2, alpha)
    mesh = _cpu_mesh(8)
    ys, xs, w = tmesh.shard_data(mesh, y, x)
    st = tstats.suff_stats_sharded(ys, xs, None, _t(z), _t(sf2), _t(alpha), mesh=mesh,
                                   weights=w)
    _assert_stats(st, ref, 1e-12)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_blocked_scan_inside_shard_map(rng, impl):
    """The blocked plain engine inside each shard (block=4 of 8 rows)
    matches the dense single-device statistics; the kernels' route takes
    ``block`` for its plain versions only."""
    y, mu, s, z, sf2, alpha, beta = make_problem(rng, n=64, d=3, q=2, m=5)
    ref = _jax_stats(y, mu, s, z, sf2, alpha)
    mesh = _cpu_mesh(8)
    ys, mus, ss, w = tmesh.shard_data(mesh, y, mu, s)
    st = tstats.suff_stats_sharded(ys, mus, ss, _t(z), _t(sf2), _t(alpha), mesh=mesh,
                                   weights=w, block=4, impl=impl)
    _assert_stats(st, ref, 1e-10)


def test_sgpr_blocked_scan_inside_shard_map(rng):
    y, mu, s, z, sf2, alpha, beta = make_problem(rng, n=64, d=3, q=2, m=5)
    ref = _jax_stats(y, mu, None, z, sf2, alpha)
    mesh = _cpu_mesh(8)
    ys, mus, _, w = tmesh.shard_data(mesh, y, mu, s)
    st = tstats.suff_stats_sharded(ys, mus, None, _t(z), _t(sf2), _t(alpha), mesh=mesh,
                                   weights=w, block=4)
    _assert_stats(st, ref, 1e-10)


def test_sgpr_predict_under_mesh(rng):
    """SGPR predictions with sharded training data match the JAX package's
    single-device ones, and so do the bound and its gradient, at the test's
    1e-8 (K_MM of six inducing points on one input dimension is
    ill-conditioned, and the bound, -0.39, is a difference of larger
    terms)."""
    x = np.sort(rng.uniform(-2, 2, (40, 1)), axis=0)
    y = np.sin(2 * x)
    jcfg = js.SGPRConfig(num_inducing=6)
    g0 = js.init_params(jax.random.key(0), jnp.asarray(x), jnp.asarray(y), jcfg)
    xs = jnp.linspace(-2, 2, 9)[:, None]
    mean_ref, var_ref = js.predict(g0, jnp.asarray(x), jnp.asarray(y), xs, jcfg)
    f_ref, g_ref = js.neg_bound_value_and_grad(g0, jnp.asarray(x), jnp.asarray(y), jcfg)

    g = TP.global_from_numpy(jax.tree.map(np.asarray, g0), device="cpu")
    cfg = ts.SGPRConfig(num_inducing=6)
    mesh = _cpu_mesh(8)
    ysh, xsh, w = tmesh.shard_data(mesh, y, x)
    mean, var = ts.predict(g, xsh, ysh, _t(xs), cfg, mesh=mesh, weights=w)
    np.testing.assert_allclose(mean.detach().numpy(), np.asarray(mean_ref), rtol=1e-8)
    np.testing.assert_allclose(var.detach().numpy(), np.asarray(var_ref), rtol=1e-8)
    f, grads = ts.neg_bound_value_and_grad(g, xsh, ysh, cfg, mesh=mesh, weights=w)
    np.testing.assert_allclose(float(f), float(f_ref), rtol=1e-8)
    for a, b in zip(grads, jax.tree.leaves(g_ref)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-8)


def _gplvm_problem(rng, n, q=2, m=5, d=3):
    y, mu, s, z, sf2, alpha, beta = make_problem(rng, n=n, d=d, q=q, m=m)
    arrays = JP.GPLVMParams(JP.make_global(jnp.asarray(z), sf2, alpha, beta),
                            JP.make_latents(jnp.asarray(mu), jnp.asarray(s)))
    return y, jax.tree.map(np.asarray, arrays)


def _sharded_params(mesh, y, arrays):
    """(Sharded Y, params with padded latent leaves, weights)."""
    ys, mus, us, w = tmesh.shard_data(mesh, y, arrays.lat.mu, arrays.lat.u_s)
    glob = TP.global_from_numpy(arrays.glob, device="cpu")
    return ys, TP.GPLVMParams(glob, TP.LatentParams(mus.gather(), us.gather())), w


def test_scg_under_mesh_matches_jax(rng):
    """SCG under a mesh of 8 shards (the counterpart of the stepped-vs-fused
    test under a mesh): the port's trajectory is the JAX package's, with
    the JAX fit also under its 8-device mesh."""
    y, arrays = _gplvm_problem(rng, n=24)
    m8 = jmesh.make_mesh(8)
    yj, muj, usj, wj = jmesh.shard_data(m8, y, arrays.lat.mu, arrays.lat.u_s)
    pj = JP.GPLVMParams(JP.GlobalParams(*arrays.glob), JP.LatentParams(muj, usj))
    rj = jg.fit(pj, yj, jg.GPLVMConfig(q=2, num_inducing=5, scg_mode="stepped"), iters=6,
                mesh=m8, weights=wj)
    mesh = _cpu_mesh(8)
    ys, p0, w = _sharded_params(mesh, y, arrays)
    rt = tg.fit(p0, ys, tg.GPLVMConfig(q=2, num_inducing=5), iters=6, mesh=mesh, weights=w)
    hj, ht = np.asarray(rj.history), rt.history
    assert np.isfinite(ht).sum() > 0
    np.testing.assert_allclose(ht[np.isfinite(ht)], hj[np.isfinite(hj)], rtol=1e-6)
    np.testing.assert_array_equal(rt.trace["accepted"], np.asarray(rj.trace["accepted"])[:6])


@pytest.mark.parametrize("k", [2, 8])
def test_gplvm_entry_points_under_mesh(rng, k):
    """log_bound (against the JAX package), neg_bound_value_and_grad,
    predict_observed, infer_latents and reconstruct with the training data
    over a mesh of k shards (N=29: padded) equal the port's single-device
    results."""
    y, arrays = _gplvm_problem(rng, n=29)
    cfg = tg.GPLVMConfig(q=2, num_inducing=5)
    p = TP.from_numpy(arrays, device="cpu")
    yt = _t(y)
    jp = JP.GPLVMParams(JP.GlobalParams(*arrays.glob), JP.LatentParams(*arrays.lat))
    mesh = _cpu_mesh(k)
    ys, pk, w = _sharded_params(mesh, y, arrays)
    f_j = float(jg.log_bound(jp, jnp.asarray(y), jg.GPLVMConfig(q=2, num_inducing=5)))
    np.testing.assert_allclose(
        float(tg.log_bound(pk, ys, cfg, mesh=mesh, weights=w).detach()), f_j, rtol=1e-12)

    f0, g0 = tg.neg_bound_value_and_grad(p, yt, cfg)
    f1, g1 = tg.neg_bound_value_and_grad(pk, ys, cfg, mesh=mesh, weights=w)
    np.testing.assert_allclose(float(f1), float(f0), rtol=1e-12)
    for a, b in zip(g1, g0):
        np.testing.assert_allclose((a[:29] if a.ndim == 2 and a.shape[0] > 29 else a).numpy(),
                                   b.numpy(), rtol=1e-10, atol=1e-14)

    x_star = _t(rng.standard_normal((7, 2)))
    for a, b in zip(tg.predict_observed(pk, ys, x_star, cfg, mesh=mesh, weights=w),
                    tg.predict_observed(p, yt, x_star, cfg)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-10)
    mu_s, s_s = _t(rng.standard_normal((5, 2))), _t(rng.uniform(0.2, 1.0, (5, 2)))
    for a, b in zip(tg.reconstruct(pk, ys, mu_s, s_s, cfg, mesh=mesh, weights=w),
                    tg.reconstruct(p, yt, mu_s, s_s, cfg)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-10)
    y_new = _t(rng.standard_normal((4, 3)))
    mu_a, s_a, ra = tg.infer_latents(pk, ys, y_new, cfg, iters=5, mesh=mesh, weights=w)
    mu_b, s_b, rb = tg.infer_latents(p, yt, y_new, cfg, iters=5)
    np.testing.assert_allclose(ra.history, rb.history, rtol=1e-10)
    np.testing.assert_allclose(mu_a.numpy(), mu_b.numpy(), rtol=1e-8, atol=1e-12)


def test_sharded_placement_and_layouts(rng):
    """shard_data's blocks, data_sharding's divisibility rule, a plain
    tensor split at evaluation time, and the qn layout under a mesh: its
    bound is the nq one (the JAX package transposes at the boundary), its
    fit raises."""
    y, arrays = _gplvm_problem(rng, n=16)
    mesh = _cpu_mesh(4)
    ys, w = tmesh.shard_data(mesh, y)
    assert [tuple(t.shape) for t in ys.shards] == [(4, 3)] * 4 and ys.shape == (16, 3)
    np.testing.assert_array_equal(ys.gather().numpy(), y)
    with pytest.raises(ValueError, match="do not split"):
        tmesh.data_sharding(mesh, _t(y[:15]))
    p = TP.from_numpy(arrays, device="cpu")
    cfg = tg.GPLVMConfig(q=2, num_inducing=5)
    f_ref = float(tg.log_bound(p, _t(y), cfg).detach())
    np.testing.assert_allclose(float(tg.log_bound(p, _t(y), cfg, mesh=mesh).detach()), f_ref,
                               rtol=1e-12)
    cfg_qn = tg.GPLVMConfig(q=2, num_inducing=5, layout="qn", y_layout="dn")
    p_qn = TP.GPLVMParams(p.glob, TP.LatentParams(p.lat.mu.T.contiguous(),
                                                  p.lat.u_s.T.contiguous()))
    np.testing.assert_allclose(float(tg.log_bound(p_qn, _t(y.T), cfg_qn, mesh=mesh).detach()),
                               f_ref,
                               rtol=1e-12)
    with pytest.raises(ValueError, match="layout='qn'"):
        tg.fit(p_qn, _t(y.T), cfg_qn, iters=1, mesh=mesh)
    with pytest.raises(ValueError, match="y_layout='nd'"):
        tg.log_bound(p, ys, tg.GPLVMConfig(q=2, num_inducing=5, y_layout="dn"), mesh=mesh)
