"""The port's sharded SVGP (``svgp.elbo_sharded`` and the fit over a
``Mesh(["cpu"] * k)``) against the JAX package's on its 8 CPU devices:
``elbo_sharded`` with the gradient of every leaf, and the training loop
``_train`` fed the per-shard permutations and window starts that the JAX
package's ``_fit_sharded`` draws (history, final ELBO and parameters at
float64 rtol 1e-8); then the sharded counterparts of tests/test_svgp.py.
The single-device forms are tests/test_torch_svgp.py's."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gparml_tpu.models import svgp as jv  # noqa: E402
from gparml_tpu.parallel import mesh as jmesh  # noqa: E402
from gparml_tpu_torch.models import svgp as tv  # noqa: E402
from gparml_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from tests.test_torch_svgp import (_assert_fit_matches, _close, _gen, _port,  # noqa: E402
                                   _problem, _regression, _tcfg)

torch.set_num_threads(2)


def _jax_shard_draws(key, k, n_local, steps):
    """The per-shard permutations and starts of the JAX package's
    _fit_sharded (the shard index folded into each key)."""
    key, kshuf = jax.random.split(key)
    keys = jax.random.split(key, steps)
    perms, starts = [], []
    for g in range(k):
        perms.append(torch.tensor(np.asarray(
            jax.random.permutation(jax.random.fold_in(kshuf, g), n_local))))
        s = jax.vmap(lambda kk: jax.random.randint(jax.random.fold_in(kk, g), (), 0, n_local))(keys)
        starts.append([int(v) for v in np.asarray(s)])
    return perms, starts


def _sharded(x, y, k):
    mesh = tmesh.Mesh(["cpu"] * k)
    ys, xs, w = tmesh.shard_data(mesh, y, x, dtype=torch.float64)
    return mesh, xs, ys, w


@pytest.mark.parametrize("k", [1, 8])
def test_elbo_sharded_matches_jax(k):
    """Full-data elbo_sharded with N=61 padded over k CPU shards against the
    JAX package's elbo_sharded on its 8 devices: value and every gradient
    leaf at rtol 1e-8."""
    x, y, _, p = _regression(n=61)
    jcfg = jv.SVGPConfig(num_inducing=7)
    m8 = jmesh.make_mesh(8)
    jys, jxs, jw = jmesh.shard_data(m8, y, x)
    vj, gj = jax.jit(jax.value_and_grad(
        lambda q: jv.elbo_sharded(q, jxs, jys, jcfg, mesh=m8, weights=jw)))(p)
    mesh, xs, ys, w = _sharded(x, y, k)
    tp = _port(p)
    vt = tv.elbo_sharded(tp, xs, ys, _tcfg(jcfg), mesh=mesh, weights=w)
    gt = torch.autograd.grad(vt, list(tp.parameters()))
    _close(vt, vj)
    for a, b in zip(gt, jax.tree.leaves(gj)):
        _close(a, b)


@pytest.mark.parametrize("threshold", [None, 50], ids=["exact", "subset"])
def test_sharded_train_matches_jax(monkeypatch, threshold):
    """_train over a mesh of 8 CPU shards, fed the per-shard permutations
    and starts of the JAX package's _fit_sharded on its 8 devices, N=61
    padded to 64: history, final ELBO (exact, or past the threshold the
    per-shard prefix estimate) and every leaf at rtol 1e-8."""
    if threshold is not None:
        monkeypatch.setattr(jv, "_EXACT_ELBO_MAX_N", threshold)
        monkeypatch.setattr(tv, "_EXACT_ELBO_MAX_N", threshold)
    x, y, _, p = _regression(n=61, m=6)
    jcfg = jv.SVGPConfig(num_inducing=6, batch_size=20)
    m8 = jmesh.make_mesh(8)
    jys, jxs, jw = jmesh.shard_data(m8, y, x)
    key = jax.random.key(4)
    rj = jv.fit(p, jxs, jys, jcfg, steps=12, learning_rate=0.05, key=key, mesh=m8, weights=jw)
    mesh, xs, ys, w = _sharded(x, y, 8)
    perms, starts = _jax_shard_draws(key, 8, 8, 12)
    rt = tv._train(_port(p), xs, ys, perms, starts, _tcfg(jcfg), 0.05, mesh=mesh, weights=w)
    assert rt.elbo_exact is (threshold is None)
    _assert_fit_matches(rt, rj)


def test_sharded_rows_must_split_and_qn_raises():
    x, y, _, p = _regression(n=61)
    cfg = tv.SVGPConfig(num_inducing=7, batch_size=16)
    mesh = tmesh.Mesh(["cpu"] * 2)
    with pytest.raises(ValueError, match="do not split"):
        tv._train(_port(p), torch.tensor(x), torch.tensor(y), [torch.arange(30)] * 2,
                  [[0]] * 2, cfg, mesh=mesh)
    with pytest.raises(ValueError, match="layout='qn'"):
        tv.fit(_port(p), torch.tensor(x.T.copy()), torch.tensor(y.T.copy()),
               tv.SVGPConfig(num_inducing=7, layout="qn"), steps=1, mesh=mesh)


@pytest.mark.parametrize("k", [1, 8])
def test_sharded_full_batch_matches_single_device(rng, k):
    """With the full global batch every window covers its whole shard, so
    one step's loss and gradients and elbo_sharded equal the single-device
    full-data values."""
    x, y = _problem(rng, n=64)
    cfg = tv.SVGPConfig(num_inducing=8, batch_size=64)
    p0 = tv.init_params(_gen(), x, y, cfg)
    ref = tv.elbo(p0, x, y, 64, cfg)
    g_ref = torch.autograd.grad(ref, list(p0.parameters()))
    mesh, xs, ys, w = _sharded(x.numpy(), y.numpy(), k)
    val = tv.elbo_sharded(p0, xs, ys, cfg, mesh=mesh, weights=w)
    g = torch.autograd.grad(val, list(p0.parameters()))
    np.testing.assert_allclose(float(val), float(ref), rtol=1e-10)
    for a, b in zip(g, g_ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-8, atol=1e-10)
    res = tv.fit(p0, xs, ys, cfg, steps=1, mesh=mesh, weights=w)
    np.testing.assert_allclose(res.history[0], float(ref), rtol=1e-10)


def test_sharded_training_recovers_function(rng):
    """Sharded training over 8 CPU shards at N=1001 (padding active)
    recovers the function like the single-device path."""
    x, y = _problem(rng, n=1001)
    cfg = tv.SVGPConfig(num_inducing=12, batch_size=256)
    p0 = tv.init_params(_gen(), x, y, cfg)
    mesh, xs, ys, w = _sharded(x.numpy(), y.numpy(), 8)
    res = tv.fit(p0, xs, ys, cfg, steps=900, learning_rate=2e-2, mesh=mesh, weights=w)
    assert np.isfinite(res.elbo)
    assert res.elbo_exact is True and res.elbo_n == 1008
    xq = torch.linspace(-3, 3, 100, dtype=torch.float64)[:, None]
    mean, var = tv.predict(res.params, xq, cfg)
    rmse = float(torch.sqrt(torch.mean((mean - torch.sin(2.0 * xq)) ** 2)))
    assert rmse < 0.12
    assert bool(torch.all(var > 0))


def test_sharded_final_elbo_subset_estimate(rng):
    """Past 65536 rows the sharded fit estimates the final ELBO from a
    per-shard prefix of the shuffled rows; with 4 b_local >= n_local the
    prefix is every row, so the estimate is the exact elbo_sharded."""
    n = 65544
    x, y = _problem(rng, n=n)
    cfg = tv.SVGPConfig(num_inducing=8, batch_size=16392)
    p0 = tv.init_params(_gen(), x, y, cfg)
    mesh, xs, ys, w = _sharded(x.numpy(), y.numpy(), 8)
    res = tv.fit(p0, xs, ys, cfg, steps=2, learning_rate=1e-2, mesh=mesh, weights=w)
    with torch.no_grad():
        exact = float(tv.elbo_sharded(res.params, xs, ys, cfg, mesh=mesh, weights=w))
    np.testing.assert_allclose(res.elbo, exact, rtol=1e-4)
    assert res.elbo_exact is False and res.elbo_n == n
