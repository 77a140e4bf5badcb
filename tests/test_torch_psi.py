"""Parity of the port's Psi-statistics with the JAX package: the plain
engine (ops/psi.py) in float64, and the fused autograd.Function
(ops/psi_cuda.py, on CPU tensors its plain versions) in float32 against the
JAX Pallas kernels run in interpret mode. A CPU model of the CUDA kernels'
reductions checks the backward assembly (``psi_cuda._assemble_bwd``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gparml_tpu.ops import ard_rbf as jard  # noqa: E402
from gparml_tpu.ops import psi as jpsi  # noqa: E402
from gparml_tpu.ops import psi_pallas  # noqa: E402
from gparml_tpu_torch.ops import ard_rbf as tard  # noqa: E402
from gparml_tpu_torch.ops import psi as tpsi  # noqa: E402
from gparml_tpu_torch.ops import psi_cuda  # noqa: E402
from tests.conftest import make_problem  # noqa: E402

torch.set_num_threads(2)

RTOL64, ATOL64 = 1e-9, 1e-12
NAMES = ("mu", "s", "z", "sf2", "alpha", "y")


def _problem(rng, n=12, d=3, q=2, m=5, zero_rows=0):
    y, mu, s, z, sf2, alpha, _ = make_problem(rng, n=n, d=d, q=q, m=m)
    w = np.r_[np.ones(n - zero_rows), np.zeros(zero_rows)]
    return dict(y=y, mu=mu, s=s, z=z, sf2=np.asarray(sf2), alpha=alpha), w


def _t(a, dtype=torch.float64):
    return torch.tensor(np.asarray(a), dtype=dtype)


def test_kernel_ops_match_jax(rng):
    x, z, alpha = rng.standard_normal((7, 3)), rng.standard_normal((5, 3)), rng.uniform(0.3, 2, 3)
    np.testing.assert_allclose(tard.sq_dist(_t(x), _t(z), _t(alpha)).numpy(),
                               np.asarray(jard.sq_dist(x, z, alpha)), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(tard.k(_t(x), _t(z), 1.3, _t(alpha)).numpy(),
                               np.asarray(jard.k(x, z, 1.3, alpha)), rtol=1e-12)
    np.testing.assert_allclose(tard.k_diag(_t(x), 1.3).numpy(),
                               np.asarray(jard.k_diag(x, 1.3)), rtol=1e-12)
    for dtype, jdtype in ((torch.float64, np.float64), (torch.float32, np.float32)):
        np.testing.assert_allclose(
            tard.kmm(_t(z, dtype), 1.3, _t(alpha, dtype)).numpy(),
            np.asarray(jard.kmm(jnp.asarray(z, jdtype), 1.3, jnp.asarray(alpha, jdtype))),
            rtol=1e-6 if dtype == torch.float32 else 1e-12)


def test_psi1_psi2_match_jax(rng):
    pr, w = _problem(rng, zero_rows=4)
    t = {k: _t(v) for k, v in pr.items()}
    args = ("mu", "s", "z", "sf2", "alpha")
    np.testing.assert_allclose(tpsi.psi1(*(t[k] for k in args)).numpy(),
                               np.asarray(jpsi.psi1(*(pr[k] for k in args))),
                               rtol=RTOL64, atol=ATOL64)
    np.testing.assert_allclose(tpsi.psi2_sum(*(t[k] for k in args), _t(w)).numpy(),
                               np.asarray(jpsi.psi2_sum(*(pr[k] for k in args), w)),
                               rtol=RTOL64, atol=ATOL64)
    np.testing.assert_allclose(tpsi.kl_qp(t["mu"], t["s"], _t(w)).numpy(),
                               np.asarray(jpsi.kl_qp(pr["mu"], pr["s"], w)), rtol=RTOL64)


@pytest.mark.parametrize("block,weighted", [(None, False), (None, True), (4, False), (4, True)])
def test_suff_stats_matches_jax(rng, block, weighted):
    pr, w = _problem(rng, n=12, zero_rows=5)
    w_arg = w if weighted else None
    order = ("y", "mu", "s", "z", "sf2", "alpha")
    want = jpsi.suff_stats(*(pr[k] for k in order), block=block, weights=w_arg)
    got = tpsi.suff_stats(*(_t(pr[k]) for k in order), block=block,
                          weights=None if w_arg is None else _t(w))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL64, atol=ATOL64)


def test_suff_stats_block_must_divide_n(rng):
    pr, _ = _problem(rng, n=12)
    with pytest.raises(ValueError, match="multiple of block"):
        tpsi.suff_stats(*(_t(pr[k]) for k in ("y", "mu", "s", "z", "sf2", "alpha")), block=5)
    # the SGPR (s=None) statistics are computed, and take the same block rule
    st = tpsi.suff_stats(_t(pr["y"]), _t(pr["mu"]), None, _t(pr["z"]), _t(pr["sf2"]),
                         _t(pr["alpha"]))
    assert all(bool(torch.all(torch.isfinite(t))) for t in st) and float(st.kl) == 0.0
    with pytest.raises(ValueError, match="multiple of block"):
        tpsi.suff_stats(_t(pr["y"]), _t(pr["mu"]), None, _t(pr["z"]), _t(pr["sf2"]),
                        _t(pr["alpha"]), block=5)


@pytest.mark.parametrize("block", [None, 6])
def test_suff_stats_gradients_match_jax(rng, block):
    pr, w = _problem(rng, n=12, zero_rows=3)
    order = ("y", "mu", "s", "z", "sf2", "alpha")
    probe = np.random.default_rng(5)
    wy, wp = probe.standard_normal((5, 3)), probe.standard_normal((5, 5))

    def jf(y, mu, s, z, sf2, alpha):
        st = jpsi.suff_stats(y, mu, s, z, sf2, alpha, block=block, weights=w)
        return jnp.sum(st.psi1_y * wy) + jnp.sum(st.psi2 * wp) + st.kl + st.psi0 + st.yy

    want = jax.grad(jf, argnums=tuple(range(6)))(*(pr[k] for k in order))
    xs = [_t(pr[k]).requires_grad_(True) for k in order]
    st = tpsi.suff_stats(*xs, block=block, weights=_t(w))
    f = torch.sum(st.psi1_y * _t(wy)) + torch.sum(st.psi2 * _t(wp)) + st.kl + st.psi0 + st.yy
    for a, b in zip(torch.autograd.grad(f, xs), want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL64, atol=ATOL64)


def _f32_inputs(rng, n, m, q=3, d=3, zero_rows=7):
    pr, w = _problem(rng, n=n, d=d, q=q, m=m, zero_rows=zero_rows)
    return pr, w.astype(np.float32)


@pytest.mark.parametrize("m", [130, 200])
def test_psi_fused_forward_matches_pallas_flat(rng, m):
    """M in {130, 200} gives Ml=256: the JAX side runs its flat kernels.

    Psi2 matches the Pallas kernel at its parity tolerance. For Psi1^T Y the
    Pallas flat kernel's own float32 error (bf16 hi/lo rungs) is ~1e-5
    absolute at these shapes, larger than that tolerance, so the port is
    held at the same tolerance against the float64 truth and must be no
    farther from it than the Pallas kernel is."""
    pr, w = _f32_inputs(rng, n=24, m=m)
    order = ("mu", "s", "z", "sf2", "alpha", "y")
    jx = [jnp.asarray(pr[k], jnp.float32) for k in order]
    assert psi_pallas._use_flat(256, pr["mu"].shape[1], interpret=True)
    want = psi_pallas.psi_fused(*jx, jnp.asarray(w), 8, True)
    truth = jpsi.suff_stats(*(pr[k] for k in ("y", "mu", "s", "z", "sf2", "alpha")),
                            weights=w.astype(np.float64))
    p1y, p2 = psi_cuda.psi_fused(*(_t(pr[k], torch.float32) for k in order),
                                 _t(w, torch.float32))
    np.testing.assert_allclose(p2.numpy(), np.asarray(want[1]), rtol=8e-5, atol=1e-6)
    np.testing.assert_allclose(p1y.numpy(), np.asarray(truth.psi1_y), rtol=8e-5, atol=1e-6)
    err = lambda a: np.max(np.abs(np.asarray(a, np.float64) - np.asarray(truth.psi1_y)))
    assert err(p1y.numpy()) <= err(want[0])


@pytest.mark.parametrize("m", [130, 200])
def test_psi_fused_backward_matches_pallas_flat(rng, m):
    pr, w = _f32_inputs(rng, n=24, m=m)
    order = ("mu", "s", "z", "sf2", "alpha", "y")
    probe = np.random.default_rng(m)
    wy = probe.standard_normal((m, 3)).astype(np.float32)
    wp = probe.standard_normal((m, m)).astype(np.float32)

    def jf(*xs):
        p1y, p2 = psi_pallas.psi_fused(*xs, jnp.asarray(w), 8, True)
        return jnp.sum(p1y * wy) + jnp.sum(p2 * wp) * 1e-2

    want = jax.grad(jf, argnums=tuple(range(6)))(
        *(jnp.asarray(pr[k], jnp.float32) for k in order))
    xs = [_t(pr[k], torch.float32).requires_grad_(True) for k in order]
    p1y, p2 = psi_cuda.psi_fused(*xs, _t(w, torch.float32))
    f = torch.sum(p1y * _t(wy, torch.float32)) + torch.sum(p2 * _t(wp, torch.float32)) * 1e-2
    for name, a, b in zip(NAMES, torch.autograd.grad(f, xs), want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, atol=3e-4 * np.abs(b).max(),
                                   rtol=1e-3, err_msg=name)


def test_suff_stats_cuda_module_matches_plain(rng):
    pr, w = _problem(rng, n=12, zero_rows=3)
    order = ("y", "mu", "s", "z", "sf2", "alpha")
    want = tpsi.suff_stats(*(_t(pr[k]) for k in order), weights=_t(w))
    got = psi_cuda.suff_stats(*(_t(pr[k]) for k in order), weights=_t(w))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12, atol=1e-14)
    with pytest.raises(ValueError, match="s=None"):
        psi_cuda.suff_stats(_t(pr["y"]), _t(pr["mu"]), None, _t(pr["z"]),
                            _t(pr["sf2"]), _t(pr["alpha"]))


def test_cpu_tensors_do_not_launch_kernels(rng):
    pr, w = _problem(rng, n=8)
    before = dict(psi_cuda.LAUNCHES)
    xs = [_t(pr[k]).requires_grad_(True) for k in NAMES]
    p1y, p2 = psi_cuda.psi_fused(*xs, _t(w))
    torch.autograd.grad(p1y.sum() + p2.sum(), xs)
    assert psi_cuda.LAUNCHES == before


@pytest.mark.parametrize("grad_enabled, z_grad, q, want", [
    (True, True, 10, True), (True, False, 10, False), (False, True, 10, False),
    (True, True, 64, True), (True, True, 100, False),
], ids=["fit", "infer_latents", "no_grad", "q64", "q100"])
def test_forward_forms_the_cell_sums_where_dz_will_be_wanted(grad_enabled, z_grad, q, want):
    """The route of the Psi autograd.Functions: the forward forms the
    backward's centred cell sums where autograd records it, Z needs a
    gradient and a Q bucket holds Q (<= 64)."""
    assert psi_cuda._emits_cells(grad_enabled, z_grad, q) is want


def _recorded_route(monkeypatch, run):
    """The kernel calls ``run`` makes through PsiFused / PsiFusedT on CPU
    tensors, with the wrappers' launchers replaced by recorders around the
    plain versions: [("fwd", layout, cells) | ("bwd", layout, a given, dz)]."""
    calls = []
    refs = {"nq": (psi_cuda.psi_fused_fwd_reference, psi_cuda.psi_fused_bwd_reference),
            "qn": (psi_cuda.psi_fused_t_fwd_reference, psi_cuda.psi_fused_t_bwd_reference)}

    def fwd(layout, mu, s, z, sf2, alpha, y, w, cells=False):
        calls.append(("fwd", layout, cells))
        out = refs[layout][0](mu, s, z, sf2, alpha, y, w)
        m, q = z.shape
        return (*out, torch.zeros((q, m, m), dtype=z.dtype)) if cells else out

    def bwd(layout, mu, s, z, sf2, alpha, y, w, p1y, p2, dp1y, dp2, a=None, dz=True):
        calls.append(("bwd", layout, a is not None, dz))
        g = refs[layout][1](mu, s, z, sf2, alpha, y, w, dp1y, dp2)
        return (*g[:2], g[2] if dz else None, *g[3:])

    monkeypatch.setattr(psi_cuda, "_on_cuda", lambda xs: True)
    monkeypatch.setattr(psi_cuda, "_launch_fwd", fwd)
    monkeypatch.setattr(psi_cuda, "_launch_bwd", bwd)
    run()
    return calls


@pytest.mark.parametrize("case", ["fit", "fit_qn", "infer_latents", "no_grad", "q100"])
def test_model_paths_take_the_cell_sum_route(monkeypatch, case):
    """Where each model path sends the Psi kernels: a fit's evaluation
    forms the cell sums in the forward and hands them to the backward (both
    layouts); infer_latents (Z held; its training statistics under no_grad)
    forms none and wants no dZ; statistics under no_grad form none; at
    Q = 100 the backward's cell pass forms them."""
    from gparml_tpu_torch.models import gplvm

    q = 100 if case == "q100" else 3
    layout = "qn" if case == "fit_qn" else "nq"
    y = torch.tensor(np.random.default_rng(0).standard_normal((40, 5)), dtype=torch.float64)
    cfg = gplvm.GPLVMConfig(q=q, num_inducing=6, stats_impl="pallas", layout=layout,
                            y_layout="dn" if layout == "qn" else "nd",
                            init="random" if q > 5 else "pca")
    if case == "infer_latents":
        y, y_new = y[:30], y[30:]
    y_in = y.T.contiguous() if layout == "qn" else y
    p = gplvm.init_params(torch.Generator().manual_seed(0), y_in, cfg)

    def run():
        if case == "infer_latents":
            vg, lat0 = gplvm._infer_objective(p, y, y_new, cfg)
            vg(lat0)
        elif case == "no_grad":
            with torch.no_grad():
                gplvm.log_bound(p, y_in, cfg)
        else:
            gplvm.neg_bound_value_and_grad(p, y_in, cfg)

    want = {
        "fit": [("fwd", "nq", True), ("bwd", "nq", True, True)],
        "fit_qn": [("fwd", "qn", True), ("bwd", "qn", True, True)],
        "infer_latents": [("fwd", "nq", False), ("fwd", "nq", False),
                          ("bwd", "nq", False, False)],
        "no_grad": [("fwd", "nq", False)],
        "q100": [("fwd", "nq", False), ("bwd", "nq", False, True)],
    }[case]
    assert _recorded_route(monkeypatch, run) == want


def _kernel_model(mu, s, z, sf2, alpha, y, w, dp1y, sym, zeta=None):
    """What the backward kernels of csrc/psi_bwd.cu compute, written out
    densely: the row passes' (dmu, ds, dalpha share, dy) and the column
    passes' centred sums a (Q, M, M) and b (Q, M). The Psi2 passes see mu
    and Z shifted by ``zeta`` (the mean of Z, which the wrapper takes as
    data; default no shift)."""
    m = z.shape[0]
    zeta = torch.zeros_like(alpha) if zeta is None else zeta
    kmat = sym * (2.0 - torch.eye(m, dtype=z.dtype)) * torch.triu(torch.ones(m, m, dtype=z.dtype))
    dz2 = (z[:, None] - z[None]) ** 2
    e0 = -0.25 * (alpha * dz2).sum(-1)
    den = 2 * alpha * s + 1
    c = alpha / den
    lc = 2 * torch.log(sf2) - 0.5 * torch.log(den).sum(-1)
    zc = z - zeta
    dd = 0.5 * (zc[:, None] + zc[None])[None] - (mu - zeta)[:, None, None]
    e = w[:, None, None] * torch.exp(lc[:, None, None] + e0[None]
                                     - (c[:, None, None] * dd ** 2).sum(-1))
    g = kmat[None] * e
    gsum = g.sum((1, 2))
    t = (g[..., None] * dd).sum((1, 2))
    u = (g[..., None] * dd ** 2).sum((1, 2))
    dmu = 2 * c * t
    ds = -c * gsum[:, None] + 2 * c * c * u
    dal = -(s / den) * gsum[:, None] - u / den ** 2
    den1 = alpha * s + 1
    c1 = alpha / den1
    l1 = torch.log(sf2) - 0.5 * torch.log(den1).sum(-1)
    d1 = mu[:, None] - z[None]
    p = w[:, None] * torch.exp(l1[:, None] - 0.5 * (c1[:, None] * d1 ** 2).sum(-1))
    h = p * (y @ dp1y.T)
    hsum = h.sum(1)
    uu = (h[..., None] * d1 ** 2).sum(1)
    dmu = dmu - c1 * (h[..., None] * d1).sum(1)
    ds = ds - 0.5 * c1 * hsum[:, None] + 0.5 * c1 * c1 * uu
    dal = dal - 0.5 * (s / den1) * hsum[:, None] - 0.5 * uu / den1 ** 2
    a = -torch.einsum("nab,nq,nabq->qab", e, c, dd)
    b = torch.einsum("nm,nq,nmq->qm", h, c1, d1)
    return dmu, ds, dal, p @ dp1y, a, b, dz2


def test_backward_kernel_decomposition_matches_autograd(rng):
    """The CUDA backward's split (row passes, cell and inducing-point sums,
    then ``_assemble_bwd``) reproduces autograd of the plain forward, with
    the Psi2 passes' latents shifted by zeta = mean(Z) as the Q <= 64
    kernels take them, and unshifted as the chunked kernels take them."""
    pr, w = _problem(rng, n=13, d=4, q=3, m=7, zero_rows=4)
    probe = np.random.default_rng(3)
    dp1y, dp2 = _t(probe.standard_normal((7, 4))), _t(probe.standard_normal((7, 7)))
    x = [_t(pr[k]) for k in NAMES]
    want = psi_cuda.psi_fused_bwd_reference(*x, _t(w), dp1y, dp2)
    p1y, p2 = psi_cuda.psi_fused_fwd_reference(*x, _t(w))
    sym = 0.5 * (dp2 + dp2.T)
    for zeta in (None, x[2].mean(0)):
        dmu, ds, dal, dy, a, b, dz2 = _kernel_model(*x, _t(w), dp1y, sym, zeta)
        dz, dsf2, dalpha = psi_cuda._assemble_bwd(x[2], x[3], x[4], p1y, p2, dp1y,
                                                  sym, dz2, dal.sum(0), a, b)
        for name, got, ref in zip(NAMES, (dmu, ds, dz, dsf2, dalpha, dy), want):
            np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-10, atol=1e-13,
                                       err_msg=name)
