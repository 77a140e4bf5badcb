"""The (Q, N)-layout GPLVM path of the port against the JAX package:
GPLVMConfig(layout='qn', y_layout='dn'), latents mu^T, s^T (Q, N) and
Y^T (D, N). Mirrors the GPLVM parts of tests/test_psi_qn.py: the plain
transposed engine (ops/psi.py ``suff_stats_t``) in float64, the kernel
entry point (ops/psi_cuda.py ``suff_stats_t``, on CPU tensors its plain
versions) against the JAX Pallas kernels in interpret mode, the model-level
bound, gradient and SCG trajectory, and the routing between engines."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gparml_tpu.models import gplvm as jg  # noqa: E402
from gparml_tpu.ops import psi as jpsi  # noqa: E402
from gparml_tpu.ops import psi_pallas  # noqa: E402
from gparml_tpu_torch.models import gplvm as tg  # noqa: E402
from gparml_tpu_torch.models import params as TP  # noqa: E402
from gparml_tpu_torch.ops import psi as tpsi  # noqa: E402
from gparml_tpu_torch.ops import psi_cuda  # noqa: E402
from gparml_tpu_torch.parallel.mesh import Mesh  # noqa: E402

torch.set_num_threads(2)

ORDER = ("mu", "s", "y", "z", "sf2", "al")


def _data(n, q, d, m, seed=0):
    """The inputs of tests/test_psi_qn.py ``_data``, row-major, float64."""
    rng = np.random.default_rng(seed)
    return dict(mu=rng.standard_normal((n, q)), s=rng.uniform(0.2, 1.5, (n, q)),
                y=rng.standard_normal((n, d)), z=rng.standard_normal((m, q)),
                sf2=np.asarray(1.3), al=rng.uniform(0.5, 2.0, (q,)),
                w=rng.uniform(0.5, 1.5, (n,)))


def _transposed(a, name):
    return a.T if name in ("mu", "s", "y") else a


def _probe(m):
    return np.cos(np.arange(m)[:, None] + np.arange(m)[None, :])


def _jax_value_and_grad(stats_fn, x, probe):
    """(loss, grads in (mu_t, s_t, y_t, z, sf2, al) order) of the probe loss
    of tests/test_psi_qn.py over the JAX statistics of the transposed x."""
    def f(args):
        mu_t, s_t, y_t, z, sf2, al = args
        st = stats_fn(y_t, mu_t, s_t, z, sf2, al)
        return (jnp.sum(st.psi1_y ** 2) + jnp.sum(st.psi2 * probe)
                + st.psi0 + st.yy + st.kl)
    v, g = jax.value_and_grad(f)(tuple(x))
    return float(v), [np.asarray(t) for t in g]


def _torch_value_and_grad(stats_fn, x, probe, dtype):
    xs = [torch.tensor(np.asarray(a), dtype=dtype).requires_grad_(True) for a in x]
    mu_t, s_t, y_t, z, sf2, al = xs
    st = stats_fn(y_t, mu_t, s_t, z, sf2, al)
    f = (torch.sum(st.psi1_y ** 2) + torch.sum(st.psi2 * torch.tensor(probe, dtype=dtype))
         + st.psi0 + st.yy + st.kl)
    return float(f.detach()), [g.numpy() for g in torch.autograd.grad(f, xs)], st


@pytest.mark.parametrize("block", [None, 50])
def test_plain_suff_stats_t_matches_jax(block):
    """The plain transposed engine against JAX ``psi.suff_stats_t`` (the
    blocked transposed XLA scan), weighted, float64: values and every
    gradient at rtol 1e-8 (mirrors test_psi_suff_stats_t_blocked_scan)."""
    q, d, m, n = 4, 3, 25, 200
    pr = _data(n, q, d, m, seed=7)
    x = [_transposed(pr[k], k) for k in ORDER]
    probe = _probe(m)
    w = pr["w"]
    jst = jpsi.suff_stats_t(*(x[i] for i in (2, 0, 1, 3, 4, 5)), block=block, weights=w)
    vj, gj = _jax_value_and_grad(
        lambda *a: jpsi.suff_stats_t(*a, block=block, weights=w), x, probe)
    vt, gt, tst = _torch_value_and_grad(
        lambda *a: tpsi.suff_stats_t(*a, block=block, weights=torch.tensor(w)),
        x, probe, torch.float64)
    for a, b in zip(tst, jst):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(vt, vj, rtol=1e-8)
    for name, a, b in zip(ORDER, gt, gj):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-10 * np.abs(b).max(),
                                   err_msg=name)


def test_plain_suff_stats_t_refuses_what_jax_does_not_take():
    pr = _data(12, 2, 3, 5)
    x = [torch.tensor(_transposed(pr[k], k)) for k in ORDER]
    with pytest.raises(ValueError, match="multiple of block"):
        tpsi.suff_stats_t(x[2], x[0], x[1], *x[3:], block=5)
    # the SGPR (s_t=None) statistics are computed, and take the same block rule
    st = tpsi.suff_stats_t(x[2], x[0], None, *x[3:])
    assert all(bool(torch.all(torch.isfinite(t))) for t in st) and float(st.kl) == 0.0
    with pytest.raises(ValueError, match="multiple of block"):
        tpsi.suff_stats_t(x[2], x[0], None, *x[3:], block=5)
    with pytest.raises(ValueError, match="s=None"):
        psi_cuda.suff_stats_t(x[2], x[0], None, *x[3:])


def test_kernel_suff_stats_t_matches_pallas_interpret():
    """``psi_cuda.suff_stats_t`` (on CPU tensors: the plain versions of the
    qn kernels) against JAX ``psi_pallas.suff_stats_t`` in interpret mode,
    float32, at the Ml=256 shape of test_suff_stats_t_matches_row_major
    (M=140, N=203, Q=5, D=4, weighted). The tolerances are those of the
    nq pair in test_torch_psi.py: Psi2 and the gradients at the Pallas
    kernels' parity tolerance, and Psi1^T Y against the float64 truth,
    because the Pallas flat forward's own float32 Psi1^T Y is ~1e-5 off
    there (bf16 hi/lo rungs; ROADMAP.md Queue 3)."""
    q, d, m, n = 5, 4, 140, 203
    pr = _data(n, q, d, m)
    x = [np.asarray(_transposed(pr[k], k), np.float32) for k in ORDER]
    w = pr["w"].astype(np.float32)
    probe = _probe(m).astype(np.float32)
    jfn = lambda y_t, mu_t, s_t, z, sf2, al: psi_pallas.suff_stats_t(
        y_t, mu_t, s_t, z, sf2, al, weights=jnp.asarray(w), tile=16, interpret=True)
    assert psi_pallas.qn_native_ok(m, q, interpret=True)
    vj, gj = _jax_value_and_grad(jfn, [jnp.asarray(a) for a in x], probe)
    jst = jfn(*(jnp.asarray(x[i]) for i in (2, 0, 1, 3, 4, 5)))
    vt, gt, tst = _torch_value_and_grad(
        lambda *a: psi_cuda.suff_stats_t(*a, weights=torch.tensor(w)), x, probe,
        torch.float32)
    truth = jpsi.suff_stats_t(*(np.asarray(x[i], np.float64) for i in (2, 0, 1, 3, 4, 5)),
                              weights=w.astype(np.float64))
    p1y, p2 = tst.psi1_y.detach().numpy(), tst.psi2.detach().numpy()
    np.testing.assert_allclose(p2, np.asarray(jst.psi2), rtol=8e-5, atol=1e-6)
    np.testing.assert_allclose(p1y, np.asarray(truth.psi1_y), rtol=8e-5, atol=1e-6)
    err = lambda a: np.max(np.abs(np.asarray(a, np.float64) - np.asarray(truth.psi1_y)))
    assert err(p1y) <= err(jst.psi1_y)
    np.testing.assert_allclose(vt, vj, rtol=1e-4)
    for name, a, b in zip(ORDER, gt, gj):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, atol=3e-4 * np.abs(b).max(), rtol=1e-3,
                                   err_msg=name)


def _jax_qn(n, q, m, d, dtype, seed=0, **cfg):
    """(y_t (D, N), JAX config, JAX qn params, the port's copy on the CPU)."""
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((n, d)).astype(dtype)
    jcfg = jg.GPLVMConfig(q=q, num_inducing=m, layout="qn", y_layout="dn", **cfg)
    jp = jg.init_params(jax.random.PRNGKey(seed), jnp.asarray(y.T), jcfg)
    tp = TP.from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return np.ascontiguousarray(y.T), jcfg, jp, tp


def _tcfg(jcfg, **over):
    kw = {k: getattr(jcfg, k) for k in tg.GPLVMConfig.__dataclass_fields__}
    kw.update(over)
    return tg.GPLVMConfig(**kw)


@pytest.mark.parametrize("stats_impl", ["xla", "pallas"])
def test_qn_bound_and_gradient_float64_match_jax(stats_impl):
    """The port's qn/dn bound and gradient on the JAX package's qn params
    against JAX qn/dn with stats_impl='xla', float64: the bound at rtol
    1e-8 and every leaf, latents in (Q, N). 'pallas' on CPU tensors runs
    the kernels' plain versions through ``psi_cuda.suff_stats_t``."""
    y_t, jcfg, jp, tp = _jax_qn(64, 3, 10, 5, np.float64, stats_impl="xla")
    fj, gj = jg.neg_bound_value_and_grad(jp, jnp.asarray(y_t), jcfg)
    ft, gt = tg.neg_bound_value_and_grad(tp, torch.tensor(y_t),
                                         _tcfg(jcfg, stats_impl=stats_impl))
    np.testing.assert_allclose(float(ft), float(fj), rtol=1e-8)
    for (name, _), a, b in zip(tp.named_parameters(), gt, jax.tree.leaves(gj)):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape, name
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-8, atol=1e-10 * np.abs(b).max(),
                                   err_msg=name)


def _nq_copy(p):
    """The same params with (N, Q) latent leaves."""
    lv = TP.leaves(p)
    return TP.from_leaves(lv[:4] + [t.T.contiguous() for t in lv[4:]])


def test_qn_matches_nq_inside_the_port_and_fits():
    """qn/dn and nq/nd give the same bound and the transposed gradient on
    the same params (float64); a 2-iteration qn fit does not lower the
    bound (mirrors test_gplvm_qn_native_bound_and_fit)."""
    y_t, jcfg, _, tp = _jax_qn(96, 4, 30, 6, np.float64, seed=1)
    cfg_qn = _tcfg(jcfg, stats_impl="pallas")
    cfg_nq = _tcfg(jcfg, stats_impl="pallas", layout="nq", y_layout="nd")
    yt = torch.tensor(y_t)
    f_qn, g_qn = tg.neg_bound_value_and_grad(tp, yt, cfg_qn)
    f_nq, g_nq = tg.neg_bound_value_and_grad(_nq_copy(tp), yt.T.contiguous(), cfg_nq)
    np.testing.assert_allclose(float(f_qn), float(f_nq), rtol=1e-12)
    for i, (a, b) in enumerate(zip(g_qn, g_nq)):
        b = b.T if i >= 4 else b
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9,
                                   atol=1e-12 * float(b.abs().max()))
    res = tg.fit(tp, yt, cfg_qn, iters=2)
    b = res.trace["bound"][:2]
    assert np.all(np.isfinite(b)) and res.bound >= -float(f_qn)
    assert tuple(res.params.lat.mu.shape) == (4, 96)


def test_qn_scg_trajectory_matches_jax():
    """An 8-iteration float64 SCG fit in qn/dn follows the JAX qn stepped
    driver per iteration (as test_scg_trajectory_matches_jax_stepped does
    for nq)."""
    y_t, jcfg, jp, tp = _jax_qn(48, 2, 8, 4, np.float64, seed=1, stats_impl="xla",
                                scg_mode="stepped")
    rj = jg.fit(jp, jnp.asarray(y_t), jcfg, iters=8)
    rt = tg.fit(tp, torch.tensor(y_t), _tcfg(jcfg), iters=8)
    tj = {k: np.asarray(v)[:8] for k, v in rj.trace.items()}
    np.testing.assert_allclose(rt.trace["bound"][:8], tj["bound"], rtol=1e-8)
    np.testing.assert_allclose(rt.trace["lambda"][:8], tj["lambda"], rtol=1e-6)
    np.testing.assert_allclose(rt.trace["alpha"][:8], tj["alpha"], rtol=1e-6)
    np.testing.assert_array_equal(rt.trace["accepted"][:8], tj["accepted"])
    assert rt.n_evals == int(rj.n_evals)
    for a, b in zip(TP.leaves(rt.params), jax.tree.leaves(rj.params)):
        assert tuple(a.shape) == np.shape(b)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("stats_impl, kernels", [("pallas", True), ("xla", False),
                                                 ("auto", False)])
@pytest.mark.parametrize("q", [2, 65])
def test_qn_routing(monkeypatch, stats_impl, kernels, q):
    """qn with 'pallas' goes through ``psi_cuda.suff_stats_t`` at any Q;
    'xla', and 'auto' on CPU tensors, through the plain
    ``psi.suff_stats_t``. The kernel wrappers take every Q: past Q = 64
    their shape check hands the same shapes to the chunked kernels."""
    calls = []

    def spy(name, fn):
        def wrapped(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(psi_cuda, "suff_stats_t", spy("kernels", psi_cuda.suff_stats_t))
    monkeypatch.setattr(tpsi, "suff_stats_t", spy("plain", tpsi.suff_stats_t))
    y_t = torch.tensor(np.random.default_rng(0).standard_normal((3, 20)))
    cfg = tg.GPLVMConfig(q=q, num_inducing=4, layout="qn", y_layout="dn",
                         stats_impl=stats_impl, init="random")
    p = tg.init_params(torch.Generator().manual_seed(0), y_t, cfg)
    tg.log_bound(p, y_t, cfg)
    # on CPU tensors the kernels' wrapper then runs its plain version
    assert calls == (["kernels", "plain"] if kernels else ["plain"])
    mu_t, z = p.lat.mu.detach(), p.glob.z.detach()
    n, m, q_k, d, shapes = psi_cuda._shapes("qn", mu_t, z, y_t)
    assert (n, m, q_k, d) == (20, 4, q, 3)
    assert shapes["mu"] == (q, 20) and shapes["y"] == (3, 20)


def test_dn_with_nq_layout_gives_the_nq_result():
    """y_layout='dn' with layout='nq' hands the (N, D) Y to the nq engines:
    the same init, bound and gradient as nq/nd (float64)."""
    y = torch.tensor(np.random.default_rng(3).standard_normal((40, 5)))
    cfg = tg.GPLVMConfig(q=2, num_inducing=6, stats_impl="pallas")
    cfg_dn = tg.GPLVMConfig(q=2, num_inducing=6, stats_impl="pallas", y_layout="dn")
    p = tg.init_params(torch.Generator().manual_seed(0), y, cfg)
    p_dn = tg.init_params(torch.Generator().manual_seed(0), y.T, cfg_dn)
    for a, b in zip(TP.leaves(p), TP.leaves(p_dn)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12, atol=1e-14)
    f, g = tg.neg_bound_value_and_grad(p, y, cfg)
    f_dn, g_dn = tg.neg_bound_value_and_grad(p, y.T, cfg_dn)
    assert float(f) == float(f_dn)
    for a, b in zip(g, g_dn):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12, atol=1e-14)


def test_qn_native_random_init():
    """qn/dn with init='random' draws (Q, N) latents and an (M, Q) Z from
    the generator, with no (N, Q) array; PCA init in qn gives the nq
    init transposed."""
    y_t = torch.tensor(np.random.default_rng(4).standard_normal((5, 30)))
    cfg = tg.GPLVMConfig(q=3, num_inducing=7, layout="qn", y_layout="dn", init="random")
    p = tg.init_params(torch.Generator().manual_seed(0), y_t, cfg)
    assert tuple(p.lat.mu.shape) == (3, 30) and tuple(p.lat.u_s.shape) == (3, 30)
    assert tuple(p.glob.z.shape) == (7, 3)
    assert torch.all(torch.isfinite(p.lat.mu))
    np.testing.assert_allclose(torch.exp(p.lat.u_s).detach().numpy(), cfg.s0, rtol=1e-12)
    np.testing.assert_allclose(float(torch.exp(p.glob.u_beta.detach())),
                               10.0 / float(torch.var(y_t, correction=0)), rtol=1e-12)
    again = tg.init_params(torch.Generator().manual_seed(0), y_t, cfg)
    assert all(torch.equal(a, b) for a, b in zip(TP.leaves(p), TP.leaves(again)))

    cfg_pca = tg.GPLVMConfig(q=3, num_inducing=7, layout="qn", y_layout="dn")
    p_qn = tg.init_params(torch.Generator().manual_seed(0), y_t, cfg_pca)
    p_nq = tg.init_params(torch.Generator().manual_seed(0), y_t.T.contiguous(),
                          tg.GPLVMConfig(q=3, num_inducing=7))
    for i, (a, b) in enumerate(zip(TP.leaves(p_qn), TP.leaves(p_nq))):
        np.testing.assert_allclose(a.numpy(), (b.T if i >= 4 else b).numpy(),
                                   rtol=1e-12, atol=1e-14)


def test_qn_under_a_mesh_raises():
    """fit raises for qn under a mesh, as in the JAX package; the bound
    under a mesh takes the (N, Q) rows and equals the single-device one."""
    y_t = torch.tensor(np.random.default_rng(5).standard_normal((3, 16)))
    cfg = tg.GPLVMConfig(q=2, num_inducing=4, layout="qn", y_layout="dn")
    p = tg.init_params(torch.Generator().manual_seed(0), y_t, cfg)
    mesh = Mesh(["cpu"] * 4)
    with pytest.raises(ValueError, match="layout='qn'"):
        tg.fit(p, y_t, cfg, iters=1, mesh=mesh)
    np.testing.assert_allclose(float(tg.log_bound(p, y_t, cfg, mesh=mesh).detach()),
                               float(tg.log_bound(p, y_t, cfg).detach()), rtol=1e-12)
    with pytest.raises(ValueError, match="y_layout"):
        tg.log_bound(p, y_t, tg.GPLVMConfig(q=2, num_inducing=4, y_layout="nd_"))


def test_svgp_qn_layout_matches_nq():
    """SVGP with layout='qn' (X (Q, N), Y (D, N)) starts from the same
    parameters and draws the same permutation and windows as nq from the
    same seed; each window is transposed into a row-major block, so the
    trajectory is nq's bit for bit (the JAX package's test allows 1e-4).
    Under a mesh qn raises, as in the JAX package."""
    from gparml_tpu_torch.models import svgp as tv

    rng = np.random.default_rng(17)
    n, q, d, m = 300, 2, 3, 12
    x = rng.standard_normal((n, q)).astype(np.float32)
    w = rng.standard_normal((q, d)).astype(np.float32)
    y = (x @ w + 0.1 * rng.standard_normal((n, d))).astype(np.float32)
    cfg = tv.SVGPConfig(num_inducing=m, batch_size=64)
    cfg_qn = tv.SVGPConfig(num_inducing=m, batch_size=64, layout="qn")
    xt, yt = torch.tensor(x), torch.tensor(y)
    p0 = tv.init_params(torch.Generator().manual_seed(5), xt, yt, cfg)
    p0_qn = tv.init_params(torch.Generator().manual_seed(5), xt.T.contiguous(),
                           yt.T.contiguous(), cfg_qn)
    for a, b in zip(p0.parameters(), p0_qn.parameters()):
        assert torch.equal(a, b)
    r1 = tv.fit(p0, xt, yt, cfg, steps=25, seed=9)
    r2 = tv.fit(p0_qn, xt.T.contiguous(), yt.T.contiguous(), cfg_qn, steps=25, seed=9)
    np.testing.assert_array_equal(r2.history, r1.history)
    for a, b in zip(r1.params.parameters(), r2.params.parameters()):
        assert torch.equal(a, b)
    np.testing.assert_allclose(r2.elbo, r1.elbo, rtol=1e-6)
    with pytest.raises(ValueError, match="layout='qn'"):
        tv.fit(p0_qn, xt.T.contiguous(), yt.T.contiguous(), cfg_qn, steps=1,
               mesh=Mesh(["cpu"] * 2))


def test_cli_qn_svgp(tmp_path):
    """--layout qn --optimizer svgp through the port's CLI: the same
    trajectory as the nq run on the same folders, and a resume."""
    from gparml_tpu_torch import cli as tcli
    from gparml_tpu_torch import data as tdata

    rng = np.random.default_rng(23)
    x = np.sort(rng.uniform(-2, 2, (120, 1)), axis=0)
    y = np.sin(2 * x) + 0.1 * rng.standard_normal((120, 1))
    inputs, emb = tmp_path / "inputs", tmp_path / "emb"
    tdata.save_partitioned(str(inputs), y, 3, prefix="Y")
    tdata.save_embeddings(str(emb), x, np.full_like(x, 1e-6), n_partitions=3)
    base = ["-i", str(inputs), "-e", str(emb), "-m", "12", "--fixed-embeddings",
            "--optimizer", "svgp", "-T", "30", "--batch-size", "48", "--device", "cpu"]
    s_nq = tcli.main(base + ["-s", str(tmp_path / "nq")])
    s_qn = tcli.main(base + ["-s", str(tmp_path / "qn"), "--layout", "qn"])
    assert s_qn["mode"] == "svgp" and np.isfinite(s_qn["final_elbo"])
    np.testing.assert_allclose(s_qn["final_elbo"], s_nq["final_elbo"], rtol=1e-6)
    hist = [(tmp_path / k / "elbo_history.jsonl").read_text() for k in ("nq", "qn")]
    assert hist[0] == hist[1]
    s2 = tcli.main(base + ["-s", str(tmp_path / "qn"), "--layout", "qn", "--load", "-T", "10"])
    assert s2["final_elbo"] >= s_qn["final_elbo"] - 25.0
