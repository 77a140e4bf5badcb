"""The port's Psi statistics at the shapes outside the JAX package's flat
window, where the JAX package runs its other Pallas kernels: M=50, Q=10
(Ml=128: `_fwd_kernel` full square and `_bwd_kernel`), M=130 with Q=44 and
Q=65 (Ml=256, 3Q+2 > 128: `_fwd_kernel` triangles and `_bwd_kernel_stair`)
and M=600, Q=3 (Ml=640: `_fwd_kernel` triangles and the lane-chunked
`_bwd_kernel`). The port's counterpart of all three is the same pair of
wrappers (``psi_cuda.psi_fused``); on CPU tensors they run their plain
versions.

The Pallas kernels take float32 only (their backward writes float32 into
float64 outputs and raises), so each window is held twice: in float64 at
rtol 1e-8 against the JAX package's own float64 statistics of the same
function (``psi.suff_stats``, which its Pallas tests hold the kernels
against), and in float32 against the Pallas kernels themselves in
interpret mode, at the tolerance of the port's flat-window tests. A dense
model of the chunked CUDA backward (Q > 64) is held against autograd at
Q=100."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gparml_tpu.ops import psi as jpsi  # noqa: E402
from gparml_tpu.ops import psi_pallas  # noqa: E402
from gparml_tpu_torch.ops import psi_cuda  # noqa: E402

torch.set_num_threads(2)

NAMES = ("mu", "s", "z", "sf2", "alpha", "y")
# (M, Q, the JAX package's kernels at that shape)
WINDOWS = [(50, 10, "full"), (130, 44, "stair"), (130, 65, "stair"), (600, 3, "lane")]


def _problem(m, q, n=12, d=3, seed=0):
    rng = np.random.default_rng(seed + m + q)
    pr = dict(mu=rng.standard_normal((n, q)), s=rng.uniform(0.2, 1.5, (n, q)),
              z=rng.standard_normal((m, q)), sf2=np.asarray(1.3),
              # exponents of Q terms kept in float32's range, as at Q=10
              alpha=rng.uniform(0.5, 2.0, q) * min(1.0, 10.0 / q),
              y=rng.standard_normal((n, d)))
    w = np.r_[np.ones(n - 2), 0.0, 0.0]
    probe = (rng.standard_normal((m, d)), rng.standard_normal((m, m)))
    return pr, w, probe


def _window(m, q):
    ms, ml = psi_pallas._m_dims(m)
    if psi_pallas._use_flat(ml, q, interpret=True):
        return "flat"
    if ml == 128:
        return "full"
    return "stair" if ml <= psi_pallas._STAIR_ML_LIMIT else "lane"


def _torch_value_and_grad(pr, w, probe, dtype):
    xs = [torch.tensor(pr[k], dtype=dtype).requires_grad_(True) for k in NAMES]
    p1y, p2 = psi_cuda.psi_fused(*xs, torch.tensor(w, dtype=dtype))
    f = (torch.sum(p1y * torch.tensor(probe[0], dtype=dtype))
         + torch.sum(p2 * torch.tensor(probe[1], dtype=dtype)))
    return (float(f.detach()), [p1y.detach().numpy(), p2.detach().numpy()],
            [g.numpy() for g in torch.autograd.grad(f, xs)])


def _jax_value_and_grad(fn, pr, w, probe, dtype):
    def f(*xs):
        p1y, p2 = fn(*xs, jnp.asarray(w, dtype))
        return jnp.sum(p1y * probe[0]) + jnp.sum(p2 * probe[1]), (p1y, p2)
    xs = [jnp.asarray(pr[k], dtype) for k in NAMES]
    (v, out), g = jax.value_and_grad(f, argnums=tuple(range(6)), has_aux=True)(*xs)
    return float(v), [np.asarray(a) for a in out], [np.asarray(a) for a in g]


def _jax_plain(mu, s, z, sf2, alpha, y, w):
    st = jpsi.suff_stats(y, mu, s, z, sf2, alpha, weights=w)
    return st.psi1_y, st.psi2


@pytest.mark.parametrize("m, q, kind", WINDOWS)
def test_window_float64_matches_jax(m, q, kind):
    """Values and VJP in float64 against the JAX package's float64
    statistics at rtol 1e-8."""
    assert _window(m, q) == kind
    pr, w, probe = _problem(m, q)
    vt, out_t, gt = _torch_value_and_grad(pr, w, probe, torch.float64)
    vj, out_j, gj = _jax_value_and_grad(_jax_plain, pr, w, probe, jnp.float64)
    np.testing.assert_allclose(vt, vj, rtol=1e-8)
    for a, b in zip(out_t, out_j):
        np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-12 * np.abs(b).max())
    for name, a, b in zip(NAMES, gt, gj):
        np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-10 * np.abs(b).max(),
                                   err_msg=name)


@pytest.mark.parametrize("m, q, kind", WINDOWS)
def test_window_float32_matches_pallas_interpret(m, q, kind):
    """Values and VJP in float32 against ``psi_pallas.psi_fused`` in
    interpret mode (the JAX package's kernels for this window), at the
    tolerances of the flat-window tests of tests/test_torch_psi.py: Psi2
    and the gradients against the Pallas kernels; Psi1^T Y against the
    float64 truth and no farther from it than the Pallas kernels' (their
    float32 Psi1^T Y is ~1e-5 absolute off at some shapes, ROADMAP.md
    Queue 3). Every gradient leaf of both is within chip_smoke.py's
    GRAD_TOL_F64 (2e-4, norm-scaled) of the float64 truth."""
    assert _window(m, q) == kind
    pr, w, probe = _problem(m, q)
    vt, out_t, gt = _torch_value_and_grad(pr, w, probe, torch.float32)
    vj, out_j, gj = _jax_value_and_grad(
        lambda *a: psi_pallas.psi_fused(*a, 8, True), pr, w, probe, jnp.float32)
    v64, out64, g64 = _torch_value_and_grad(pr, w, probe, torch.float64)
    np.testing.assert_allclose(vt, vj, rtol=1e-4)
    np.testing.assert_allclose(out_t[1], out_j[1], rtol=8e-5, atol=1e-6 * np.abs(out_j[1]).max())
    np.testing.assert_allclose(out_t[0], out64[0], rtol=8e-5, atol=1e-6)
    err = lambda a: np.abs(np.asarray(a, np.float64) - out64[0]).max()
    assert err(out_t[0]) <= err(out_j[0])
    norm_err = lambda a, c: np.linalg.norm(a - c) / np.linalg.norm(c)
    for name, a, b, c in zip(NAMES, gt, gj, g64):
        np.testing.assert_allclose(a, b, atol=3e-4 * np.abs(b).max(), rtol=1e-3,
                                   err_msg=name)
        assert norm_err(a, c) <= 2e-4 and norm_err(b, c) <= 2e-4, name


# The chunked CUDA kernels' decomposition (csrc/psi_bwd.cu, Q > 64): latent
# dimensions in chunks of kTcQChunk = 16; the Psi2 row pass over groups of
# cells, the Psi1 row pass over tiles of inducing points, the cell and point
# passes over tiles of rows. The groups and tiles are smaller here than the
# kernels' (64) so that the model crosses their edges at a test's size; the
# sums are the same.
QC = 16


def _chunks(q):
    return [slice(k, min(k + QC, q)) for k in range(0, q, QC)]


def _exponent(c, dd, q):
    """sum over the latent dimension chunks of c dd^2 (..., Q) -> (...)."""
    return sum((c[..., ch] * dd[..., ch] ** 2).sum(-1) for ch in _chunks(q))


def _chunked_kernel_model(mu, s, z, sf2, alpha, y, w, dp1y, sym, group=4, rows=5):
    """(dmu, ds, dalpha row shares, dy, a (Q, M, M), b (Q, M)) as the
    chunked backward kernels form them."""
    n, q = mu.shape
    m = z.shape[0]
    kmat = sym * (2.0 - torch.eye(m, dtype=z.dtype))
    e0 = -0.25 * (alpha * (z[:, None] - z[None]) ** 2).sum(-1)
    den = 2 * alpha * s + 1
    c = alpha / den
    lc = 2 * torch.log(sf2) - 0.5 * torch.log(den).sum(-1)
    tt, uu = torch.zeros(n, q, dtype=mu.dtype), torch.zeros(n, q, dtype=mu.dtype)
    gsum = torch.zeros(n, dtype=mu.dtype)
    # psi2_bwd_rows_tc_chunked_kernel: per row mi of cells, groups of cells
    for mi in range(m):
        for mj0 in range(mi, m, group):
            mj = torch.arange(mj0, min(m, mj0 + group))
            dd = 0.5 * (z[mi] + z[mj])[None] - mu[:, None]           # (N, G, Q)
            g = kmat[mi, mj] * w[:, None] * torch.exp(
                lc[:, None] + e0[mi, mj] - _exponent(c[:, None], dd, q))
            gsum = gsum + g.sum(1)
            for ch in _chunks(q):
                tt[:, ch] += (g[..., None] * dd[..., ch]).sum(1)
                uu[:, ch] += (g[..., None] * dd[..., ch] ** 2).sum(1)
    dmu = 2 * c * tt
    ds = -c * gsum[:, None] + 2 * c * c * uu
    dal = -(s / den) * gsum[:, None] - uu / den ** 2
    # psi1_bwd_rows_tc_kernel<0>: tiles of inducing points; per tile and
    # dimension chunk, t = sum h (mu - z) and u = sum h (mu - z)^2 pair by
    # pair, H = sum h and dY = sum p dPsi1Y
    den1 = alpha * s + 1
    c1 = alpha / den1
    l1 = torch.log(sf2) - 0.5 * torch.log(den1).sum(-1)
    t1, u1 = torch.zeros(n, q, dtype=mu.dtype), torch.zeros(n, q, dtype=mu.dtype)
    hsum = torch.zeros(n, dtype=mu.dtype)
    dy = torch.zeros_like(y)
    for m0 in range(0, m, group):
        sl = slice(m0, min(m, m0 + group))
        d1 = mu[:, None] - z[None, sl]                                # (N, G, Q)
        p = w[:, None] * torch.exp(l1[:, None] - 0.5 * _exponent(c1[:, None], d1, q))
        h = p * (y @ dp1y[sl].T)
        dy = dy + p @ dp1y[sl]
        hsum = hsum + h.sum(1)
        for ch in _chunks(q):
            t1[:, ch] += (h[..., None] * d1[..., ch]).sum(1)
            u1[:, ch] += (h[..., None] * d1[..., ch] ** 2).sum(1)
    dmu = dmu - c1 * t1
    ds = ds - 0.5 * c1 * hsum[:, None] + 0.5 * c1 * c1 * u1
    dal = dal - 0.5 * (s / den1) * hsum[:, None] - 0.5 * u1 / den1 ** 2
    # psi2_bwd_cells_tc_chunked_kernel and psi1_bwd_m_tc_kernel<0>: tiles of
    # rows, each tile's centred sums added per latent dimension chunk
    zb = 0.5 * (z[:, None] + z[None])                                  # (M, M, Q)
    a = torch.zeros(q, m, m, dtype=mu.dtype)
    b = torch.zeros(q, m, dtype=mu.dtype)
    for r0 in range(0, n, rows):
        r = slice(r0, min(n, r0 + rows))
        dd = zb[None] - mu[r, None, None]                              # (R, M, M, Q)
        e = w[r, None, None] * torch.exp(lc[r, None, None] + e0[None]
                                         - _exponent(c[r, None, None], dd, q))
        d1 = mu[r, None] - z[None]
        hr = w[r, None] * torch.exp(l1[r, None] - 0.5 * _exponent(c1[r, None], d1, q)) \
            * (y[r] @ dp1y.T)
        for ch in _chunks(q):
            a[ch] += torch.einsum("nab,nq,nabq->qab", e, -c[r, ch], dd[..., ch])
            b[ch] += torch.einsum("nm,nq,nmq->qm", hr, c1[r, ch], d1[..., ch])
    return dmu, ds, dal, dy, a, b


def test_chunked_backward_decomposition_matches_autograd():
    """The chunked kernels' split at Q=100 (row passes over groups of cells
    or tiles of inducing points and dimension chunks, cell and
    inducing-point sums over tiles of rows, then ``_assemble_bwd``)
    reproduces autograd of the plain forward in float64."""
    pr, w, _ = _problem(9, 100, n=11, d=4)
    x = [torch.tensor(pr[k]) for k in NAMES]
    wt = torch.tensor(w)
    probe = np.random.default_rng(3)
    dp1y, dp2 = torch.tensor(probe.standard_normal((9, 4))), torch.tensor(probe.standard_normal((9, 9)))
    want = psi_cuda.psi_fused_bwd_reference(*x, wt, dp1y, dp2)
    p1y, p2 = psi_cuda.psi_fused_fwd_reference(*x, wt)
    sym = 0.5 * (dp2 + dp2.T)
    dmu, ds, dal, dy, a, b = _chunked_kernel_model(*x, wt, dp1y, sym)
    dz2 = (x[2][:, None] - x[2][None]) ** 2
    dz, dsf2, dalpha = psi_cuda._assemble_bwd(x[2], x[3], x[4], p1y, p2, dp1y,
                                              sym, dz2, dal.sum(0), a, b)
    for name, got, ref in zip(NAMES, (dmu, ds, dz, dsf2, dalpha, dy), want):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-10,
                                   atol=1e-13 * float(ref.abs().max()), err_msg=name)
