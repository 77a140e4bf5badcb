"""Kernel parity on an NVIDIA GPU: the CUDA Psi-statistics kernels against
their plain PyTorch versions (the cases of chip_smoke.py phase 3) in both
layouts, nq (mu, s (N, Q), Y (N, D)) and qn (mu^T, s^T (Q, N), Y^T (D, N)),
and the kernel wrappers' input checks. Skipped without a CUDA device."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from gparml_tpu_torch.ops import psi_cuda  # noqa: E402
from tools import spread_latents  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _inputs(device, n=40, m=30, q=4, d=5, dtype=torch.float32):
    rng = np.random.default_rng(0)
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)
    return (t(rng.standard_normal((n, q))), t(0.3 + rng.random((n, q))),
            t(rng.standard_normal((m, q))), t(1.3), t(0.5 + rng.random(q)),
            t(rng.standard_normal((n, d))), t(np.ones(n)))


@pytest.mark.parametrize("layout", chip_smoke.LAYOUTS)
@pytest.mark.parametrize("case", chip_smoke.PARITY_CASES, ids=str)
def test_kernel_parity(cuda, case, layout):
    before = len(chip_smoke.FAILURES)
    res = chip_smoke.parity_case(*case, device=cuda, layout=layout)
    assert len(chip_smoke.FAILURES) == before, res


@pytest.mark.parametrize("layout", chip_smoke.LAYOUTS)
def test_one_split_a_grid_matches_plain(cuda, layout):
    """A partial budget of one byte puts every grid in one N-split of
    70 000 rows: the forward's Psi2 sweep adds 1094 row tiles into its
    float64 totals, as the Psi1 passes do, and the results must still meet
    the plain versions. Up to Q = 64 the backward has no cell pass (the
    plan's third entry, 0)."""
    assert psi_cuda._plan_for(70_000, 40, 3, 5, cuda, 1) == (1, 1, 0, 1, 1)
    before = len(chip_smoke.FAILURES)
    with chip_smoke.partial_budget(1):
        res = chip_smoke.parity_case(70_000, 40, 3, 5, 0, device=cuda, layout=layout)
    assert len(chip_smoke.FAILURES) == before, res


@pytest.mark.parametrize("layout", chip_smoke.LAYOUTS)
@pytest.mark.parametrize("q", [65, 100])
def test_chunked_kernels_match_plain(cuda, layout, q):
    """Past Q = 64 the chunked kernels, forward and backward, against their
    plain versions: with the default plan, and with every grid in one
    N-split of 5000 rows. The backward takes no per-row scratch: the plan's
    fifth entry is the Psi1 row pass's inducing-point splits, 1 here."""
    assert psi_cuda._plan_for(5000, 30, q, 6, cuda, 1) == (1, 1, 1, 1, 1)
    before = len(chip_smoke.FAILURES)
    res = chip_smoke.parity_case(300, 90, q, 6, 7, device=cuda, layout=layout)
    with chip_smoke.partial_budget(1):
        res1 = chip_smoke.parity_case(5000, 30, q, 6, 0, device=cuda, layout=layout)
    assert len(chip_smoke.FAILURES) == before, (res, res1)


def test_qn_kernels_equal_nq_kernels_on_transposed_inputs(cuda):
    """Both layouts run the same sums in the same order: bitwise equal,
    except dalpha, whose row shares the wrapper sums over dim 0 of (N, Q)
    in nq and over dim 1 of (Q, N) in qn."""
    xs = _inputs(cuda, n=300, m=70, q=10, d=12)
    ts = [t.T.contiguous() if i in (0, 1, 5) else t for i, t in enumerate(xs)]
    p1y, p2 = psi_cuda.psi_fwd(*xs)
    p1y_t, p2_t = psi_cuda.psi_fwd_t(*ts)
    assert torch.equal(p1y, p1y_t) and torch.equal(p2, p2_t)
    cot = (torch.ones_like(p1y), torch.ones_like(p2))
    g = psi_cuda.psi_bwd(*xs, p1y, p2, *cot)
    g_t = psi_cuda.psi_bwd_t(*ts, p1y, p2, *cot)
    for i, (a, b) in enumerate(zip(g, g_t)):
        if i == 4:
            torch.testing.assert_close(a, b, rtol=1e-6, atol=0)
        else:
            assert torch.equal(a, b.T if i in (0, 1, 5) else b), i


@pytest.mark.parametrize("q", [100, 256])
def test_chunked_qn_kernels_equal_nq_kernels_on_transposed_inputs(cuda, q):
    """Past Q = 64 (K-chunked tensor-core kernels, the exponents shifted by
    2^S; at Q = 256 the backward's dimensions in two passes) both layouts
    still run the same sums in the same order. dalpha, whose row shares the
    wrapper sums in float32 over N in a layout's own order, cancels to
    entries far below its largest at these widths: it is held to 1e-6 of
    its largest entry."""
    xs = list(_inputs(cuda, n=300, m=70, q=q, d=12))
    xs[4] = xs[4] * (44.0 / q)
    ts = [t.T.contiguous() if i in (0, 1, 5) else t for i, t in enumerate(xs)]
    p1y, p2 = psi_cuda.psi_fwd(*xs)
    p1y_t, p2_t = psi_cuda.psi_fwd_t(*ts)
    assert torch.equal(p1y, p1y_t) and torch.equal(p2, p2_t)
    cot = (torch.ones_like(p1y), torch.ones_like(p2))
    g = psi_cuda.psi_bwd(*xs, p1y, p2, *cot)
    g_t = psi_cuda.psi_bwd_t(*ts, p1y, p2, *cot)
    for i, (a, b) in enumerate(zip(g, g_t)):
        if i == 4:
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6 * float(b.abs().max()))
        else:
            assert torch.equal(a, b.T if i in (0, 1, 5) else b), i


def _route_inputs(q, spread, n=1000, m=64, d=6):
    """Float64 inputs and cotangents of the route tests: N(0, 1) latents as
    ``chip_smoke.parity_case`` draws them, or ``chip_smoke.spread_inputs``."""
    if spread:
        return chip_smoke.spread_inputs(n, m, q, d, spread)
    rng = np.random.default_rng(n + m + q)
    return dict(mu=rng.standard_normal((n, q)), s=0.3 + 0.5 * rng.random((n, q)),
                z=rng.standard_normal((m, q)), sf2=np.asarray(1.3), alpha=0.5 + rng.random(q),
                y=rng.standard_normal((n, d)), w=np.ones(n), dp1y=rng.standard_normal((m, d)),
                dp2=rng.standard_normal((m, m)))


def _route_tensors(host, device, layout, dtype=torch.float32):
    """(mu, s, z, sf2, alpha, y, w) in ``layout`` and the cotangents (dp1y,
    dp2), as ``dtype`` tensors."""
    t = lambda a: torch.tensor(np.array(a, order="C"), dtype=dtype, device=device)
    tr = (lambda a: a.T) if layout == "qn" else (lambda a: a)
    xs = (t(tr(host["mu"])), t(tr(host["s"])), t(host["z"]), t(host["sf2"]), t(host["alpha"]),
          t(tr(host["y"])), t(host["w"]))
    return xs, (t(host["dp1y"]), t(host["dp2"]))


@pytest.mark.parametrize("layout", chip_smoke.LAYOUTS)
@pytest.mark.parametrize("spread", [None, 3.0], ids=["normal", "spread"])
@pytest.mark.parametrize("q", [2, 4, 10, 16, 32, 64])
def test_forward_with_cell_sums_matches_the_two_sweeps(cuda, q, spread, layout):
    """At every Q bucket, in both layouts, on N(0, 1) and spread latents:
    the Psi2 forward sweep that forms the cell sums too
    (psi2_fwd_tc_kernel<QM, true>) gives the Psi2 of the sweep without them
    (<QM, false>, the same sums in the same order) and the Psi1^T Y of the
    same Psi1 kernel, bit for bit; its cell sums with
    every grid in one N-split are those of the default plan up to the
    float32 rounding of float64 sums taken in another order; the backward
    given them equals the backward wrapper called alone (which runs that
    sweep for them) bit for bit; and the gradients from either plan's cell
    sums stay within the parity tests' tolerance of the plain version in
    float64 (dz is where the cell sums go)."""
    host = _route_inputs(q, spread)
    xs, cot = _route_tensors(host, cuda, layout)
    fwd, bwd, _, _, bwd_ref = chip_smoke._wrappers(layout)
    p1y, p2 = fwd(*xs)
    p1y_f, p2_f, a = psi_cuda._launch_fwd(layout, *xs, cells=True)
    assert torch.equal(p1y_f, p1y) and torch.equal(p2_f, p2)
    with chip_smoke.partial_budget(1):
        a_1 = psi_cuda._launch_fwd(layout, *xs, cells=True)[2]
    assert chip_smoke._norm_err(a_1.double().cpu().numpy(), a.double().cpu().numpy()) <= 1e-6
    got = psi_cuda._launch_bwd(layout, *xs, p1y_f, p2_f, *cot, a=a)
    alone = bwd(*xs, p1y_f, p2_f, *cot)
    for name, g, h in zip(chip_smoke.GRAD_NAMES, got, alone):
        assert torch.equal(g, h), name
    got_1 = psi_cuda._launch_bwd(layout, *xs, p1y_f, p2_f, *cot, a=a_1)
    xs64, cot64 = _route_tensors(host, cuda, layout, torch.float64)
    want = bwd_ref(*xs64, *cot64)
    for grads in (got, got_1):
        for name, g, h in zip(chip_smoke.GRAD_NAMES, grads, want):
            err = chip_smoke._norm_err(g.double().cpu().numpy(), h.cpu().numpy())
            assert err <= chip_smoke.GRAD_TOL_F64, (name, err)


@pytest.mark.parametrize("layout", chip_smoke.LAYOUTS)
@pytest.mark.parametrize("n, m, q", [(1000, 37, q) for q in (2, 4, 10, 16, 32, 33, 64)]
                         + [(1001, 200, 10), (16, 200, 10), (16, 37, 64), (1001, 64, 64)],
                         ids=str)
def test_pipelined_row_pass_matches_float64(cuda, n, m, q, layout):
    """The backward's Psi2 row pass (psi2_bwd_rows_tc_kernel: a producer
    warpgroup hands 64-cell tiles to the consumer warpgroups through a ring
    of stages) at every Q bucket, and at Q = 33, in both layouts: M = 37
    ends on a ragged tile (703 cells), N = 1001 is no multiple of a block's
    rows, N = 16 and N = 1000 fill a few blocks as infer_latents' batches
    do. Given the forward's cell sums, dmu, ds and dalpha stay within the
    parity tests' tolerance of the plain version in float64."""
    host = _route_inputs(q, None, n=n, m=m)
    xs, cot = _route_tensors(host, cuda, layout)
    p1y, p2, a = psi_cuda._launch_fwd(layout, *xs, cells=True)
    got = psi_cuda._launch_bwd(layout, *xs, p1y, p2, *cot, a=a)
    xs64, cot64 = _route_tensors(host, cuda, layout, torch.float64)
    want = chip_smoke._wrappers(layout)[4](*xs64, *cot64)
    for i in (0, 1, 4):
        err = chip_smoke._norm_err(got[i].double().cpu().numpy(), want[i].cpu().numpy())
        assert err <= chip_smoke.GRAD_TOL_F64, (chip_smoke.GRAD_NAMES[i], err)


def _cell_sums_f64(host, device):
    """The centred cell sums A_q[i, j] = sum_n w_n Psi2_n[i, j] c_nq (mu_nq -
    zb_q) (Q, M, M), zb = (z_i + z_j) / 2 and c = alpha / (2 alpha s + 1), in
    float64 on the host's inputs."""
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float64, device=device)
    mu, s, z, alpha, w = (t(host[k]) for k in ("mu", "s", "z", "alpha", "w"))
    m, q = z.shape
    den = 2.0 * alpha * s + 1.0
    c = alpha / den
    i, j = torch.triu_indices(m, m, device=device)
    zb = 0.5 * (z[i] + z[j])
    e0 = -0.25 * (alpha * (z[i] - z[j]) ** 2).sum(1)
    quad = c @ (zb * zb).T - 2.0 * (c * mu) @ zb.T + (c * mu * mu).sum(1, keepdim=True)
    lc = 2.0 * torch.log(t(host["sf2"])) - 0.5 * torch.log(den).sum(1)
    we = w[:, None] * torch.exp(lc[:, None] + e0[None, :] - quad)        # (N, cells)
    packed = (we.T @ (c * mu) - zb * (we.T @ c)).T                        # (Q, cells)
    a = torch.zeros((q, m, m), dtype=torch.float64, device=device)
    a[:, i, j] = packed
    a[:, j, i] = packed
    return a


@pytest.mark.parametrize("layout", chip_smoke.LAYOUTS)
@pytest.mark.parametrize("cells", [True, False], ids=["fit", "no_dz"])
@pytest.mark.parametrize("n, m, q", [(1000, 37, q) for q in (2, 4, 10, 16, 32, 33, 64)]
                         + [(1001, 200, 10), (16, 200, 10), (16, 37, 64), (1001, 64, 64)],
                         ids=str)
def test_pipelined_forward_sweep_matches_float64(cuda, n, m, q, cells, layout):
    """The Psi2 forward sweep (psi2_fwd_tc_kernel: a producer warpgroup hands
    64-row tiles to the consumer warpgroups through a ring of stages) at
    every Q bucket, and at Q = 33, in both layouts, on the fit's route (the
    cell sums too) and without them: M = 37 ends on a ragged cell block,
    N = 1001 on a ragged row tile, N = 16 and N = 1000 give splits of fewer
    row tiles than the ring has stages, as infer_latents' batches do. Psi2
    stays within F64_TOL of the plain version in float64 (max abs error of
    max|ref|) and the cell sums A within the gradients' tolerance
    (GRAD_TOL_F64, norm-scaled) of their float64 sums."""
    host = _route_inputs(q, None, n=n, m=m)
    xs, _ = _route_tensors(host, cuda, layout)
    out = psi_cuda._launch_fwd(layout, *xs, cells=cells)
    xs64, _ = _route_tensors(host, cuda, layout, torch.float64)
    want = chip_smoke._wrappers(layout)[3](*xs64)[1]
    err = float((out[1].double() - want).abs().max() / want.abs().max())
    assert err <= chip_smoke.F64_TOL, err
    if cells:
        a64 = _cell_sums_f64(host, cuda)
        err = chip_smoke._norm_err(out[2].double().cpu().numpy(), a64.cpu().numpy())
        assert err <= chip_smoke.GRAD_TOL_F64, err


@pytest.mark.parametrize("layout", chip_smoke.LAYOUTS)
def test_held_z_forms_no_cell_sums(cuda, layout):
    """Through the autograd.Function: with Z needing a gradient the forward
    forms the cell sums (fwd_cells counts it) and saves them for the
    backward; with Z held it forms none, saves none and gives no dz, and
    dmu and ds are those of the first, bit for bit."""
    xs, cot = _route_tensors(_route_inputs(10, None), cuda, layout)
    fused = chip_smoke._wrappers(layout)[2]
    keys = ("fwd", "fwd_cells") if layout == "nq" else ("fwd_t", "fwd_cells_t")

    def run(z_grad):
        ins = [x.clone().requires_grad_(i != 2 or z_grad) for i, x in enumerate(xs[:6])]
        before = dict(psi_cuda.LAUNCHES)
        p1y, p2 = fused(*ins, xs[6])
        saved = len(p2.grad_fn.saved_tensors)
        f = torch.sum(p1y * cot[0]) + torch.sum(p2 * cot[1])
        grads = torch.autograd.grad(f, [x for x in ins if x.requires_grad])
        counts = tuple(psi_cuda.LAUNCHES[k] - before[k] for k in keys)
        return counts, saved, grads

    counts, saved, g_fit = run(True)
    assert counts == (1, 1) and saved == 10
    counts, saved, g_held = run(False)
    assert counts == (1, 0) and saved == 9 and len(g_held) == 5
    assert torch.equal(g_held[0], g_fit[0]) and torch.equal(g_held[1], g_fit[1])


@pytest.mark.parametrize("layout", ["nq", "qn"])
def test_fit_forms_the_cell_sums_in_every_forward(cuda, layout):
    """A fit's evaluations on the card: every forward call forms the cell
    sums (fwd_cells / fwd = 1), one backward a forward."""
    from gparml_tpu_torch import data
    from gparml_tpu_torch.models import gplvm

    y_np, _ = data.oil_flow_like(n=3000, d=5, seed=1)
    y = torch.tensor(y_np.T.copy() if layout == "qn" else y_np, dtype=torch.float32,
                     device=cuda)
    cfg = gplvm.GPLVMConfig(q=3, num_inducing=20, layout=layout,
                            y_layout="dn" if layout == "qn" else "nd")
    p = gplvm.init_params(torch.Generator(cuda).manual_seed(0), y, cfg)
    keys = ("fwd", "bwd", "fwd_cells") if layout == "nq" else ("fwd_t", "bwd_t", "fwd_cells_t")
    before = dict(psi_cuda.LAUNCHES)
    gplvm.fit(p, y, cfg, iters=3)
    fwd, bwd, cells = (psi_cuda.LAUNCHES[k] - before[k] for k in keys)
    assert fwd > 0 and cells == fwd and bwd == fwd


@pytest.mark.parametrize("q", [4, 65])
def test_wrappers_count_launches(cuda, q):
    """One count a wrapper call, up to Q = 64 and past it."""
    xs = _inputs(cuda, q=q)
    before = dict(psi_cuda.LAUNCHES)
    p1y, p2 = psi_cuda.psi_fwd(*xs)
    psi_cuda.psi_bwd(*xs, p1y, p2, torch.ones_like(p1y), torch.ones_like(p2))
    torch.cuda.synchronize()
    assert psi_cuda.LAUNCHES["fwd"] == before["fwd"] + 1
    assert psi_cuda.LAUNCHES["bwd"] == before["bwd"] + 1
    assert psi_cuda.LAUNCHES["fwd_t"] == before["fwd_t"]


@pytest.mark.parametrize("q", [4, 65])
def test_qn_wrappers_count_launches(cuda, q):
    xs = [t.T.contiguous() if i in (0, 1, 5) else t
          for i, t in enumerate(_inputs(cuda, q=q))]
    before = dict(psi_cuda.LAUNCHES)
    p1y, p2 = psi_cuda.psi_fwd_t(*xs)
    psi_cuda.psi_bwd_t(*xs, p1y, p2, torch.ones_like(p1y), torch.ones_like(p2))
    torch.cuda.synchronize()
    assert psi_cuda.LAUNCHES["fwd_t"] == before["fwd_t"] + 1
    assert psi_cuda.LAUNCHES["bwd_t"] == before["bwd_t"] + 1
    assert psi_cuda.LAUNCHES["fwd"] == before["fwd"]
    with pytest.raises(ValueError, match="shape"):
        psi_cuda.psi_fwd_t(*_inputs(cuda))


def test_wrapper_rejects_what_the_kernels_do_not_take(cuda):
    xs = _inputs(cuda)
    with pytest.raises(TypeError, match="float32"):
        psi_cuda.psi_fwd(*_inputs(cuda, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        psi_cuda.psi_fwd(xs[0].T.contiguous().T, *xs[1:])
    with pytest.raises(ValueError, match="shape"):
        psi_cuda.psi_fwd(*xs[:6], xs[6][:-1])
    with pytest.raises(ValueError, match="one CUDA device"):
        psi_cuda.psi_fwd(xs[0].cpu(), *xs[1:])


def test_m_limit_at_q_over_32(cuda):
    """At 32 < Q <= 64 M has no limit: the Psi1 passes walk the inducing
    points in tiles of 64, so M=908, 909 and 4000 plan within the card's
    shared memory, as past Q = 64; and the wrappers run at M=4000, Q=64
    against their plain versions."""
    for m, q in ((908, 44), (909, 44), (4000, 44), (4000, 64), (4000, 65), (4000, 300)):
        psi_cuda._plan(8, m, q, 4, cuda)
    xs = _inputs(cuda, n=8, m=4000, q=64, d=4)
    cot = (torch.randn((4000, 4), device=cuda), torch.randn((4000, 4000), device=cuda))
    before = dict(psi_cuda.LAUNCHES)
    got = psi_cuda.psi_fwd(*xs)
    got_b = psi_cuda.psi_bwd(*xs, *got, *cot)
    assert psi_cuda.LAUNCHES["fwd"] == before["fwd"] + 1
    assert psi_cuda.LAUNCHES["bwd"] == before["bwd"] + 1
    want = psi_cuda.psi_fused_fwd_reference(*xs)
    want_b = psi_cuda.psi_fused_bwd_reference(*xs, *cot)
    for a, b in zip((*got, *got_b), (*want, *want_b)):
        assert float((a - b).abs().max()) <= chip_smoke.GRAD_TOL_F32 * float(b.abs().max())


# D = 20000: past what the direct-form Psi1 kernels staged (32 rows of Y
# as 32 x D floats, 2.5 MB). The tensor-core Psi1 kernels walk D in chunks
# and take its float64 totals in column passes, so no shape is past the
# card's shared memory any more.
@pytest.mark.parametrize("m, q, d", [(40, 10, 20000), (40, 100, 20000)])
def test_wrappers_reject_shapes_past_shared_memory(cuda, m, q, d):
    """The plan at D = 20000 stays within the card's shared memory, and the
    wrappers run there against their plain versions (the name dates from
    when such shapes were refused: D no longer sets a limit)."""
    psi_cuda._plan(8, m, q, d, cuda)
    xs = list(_inputs(cuda, n=8, m=m, q=q, d=d))
    xs[4] = xs[4] * min(1.0, 44.0 / q)
    cot = (torch.randn((m, d), device=cuda), torch.randn((m, m), device=cuda))
    got = psi_cuda.psi_fwd(*xs)
    got_b = psi_cuda.psi_bwd(*xs, *got, *cot)
    want = psi_cuda.psi_fused_fwd_reference(*xs)
    want_b = psi_cuda.psi_fused_bwd_reference(*xs, *cot)
    for a, b in zip((*got, *got_b), (*want, *want_b)):
        assert float((a - b).abs().max()) <= chip_smoke.GRAD_TOL_F32 * float(b.abs().max())


def _psi1_case(cuda, n, m, q, d, layout="nq", seed=0, spread=None):
    """Psi1^T (w Y) and the gradients of sum(Psi1^T (w Y) * W) (no Psi2
    cotangent, so only the Psi1 kernels' reductions act) by the kernels,
    and by the plain version in float32 and float64; inputs drawn as
    chip_smoke.parity_case draws them, or with ``spread`` the latents
    spread * N(0, 1) and each inducing point a latent row moved by
    0.3 * N(0, 1) (as an init that picks Z among the latents gives)."""
    rng = np.random.default_rng(seed + n + m + q)
    host = dict(mu=rng.standard_normal((n, q)), s=0.3 + 0.5 * rng.random((n, q)),
                z=rng.standard_normal((m, q)), sf2=np.asarray(1.3),
                alpha=(0.5 + rng.random(q)) * min(1.0, 44.0 / q),
                y=rng.standard_normal((n, d)))
    if spread is not None:
        host["mu"] = host["mu"] * spread
        host["z"] = host["mu"][rng.choice(n, m, replace=False)] + 0.3 * host["z"]
    if layout == "qn":
        host.update({k: np.ascontiguousarray(host[k].T) for k in ("mu", "s", "y")})
    w = np.r_[np.ones(n - 3), np.zeros(3)]
    wy = rng.standard_normal((m, d))
    fused = psi_cuda.psi_fused if layout == "nq" else psi_cuda.psi_fused_t
    ref = (psi_cuda.psi_fused_fwd_reference if layout == "nq"
           else psi_cuda.psi_fused_t_fwd_reference)

    def run(dtype, fn):
        t = lambda a: torch.tensor(a, dtype=dtype, device=cuda)
        xs = [t(host[k]).requires_grad_(True) for k in chip_smoke.GRAD_NAMES]
        p1y, _ = fn(*xs, t(w))
        grads = torch.autograd.grad(torch.sum(p1y * t(wy)), xs)
        return [a.detach().double() for a in (p1y, *grads)]

    return run(torch.float32, fused), run(torch.float32, ref), run(torch.float64, ref)


@pytest.mark.parametrize("layout", chip_smoke.LAYOUTS)
@pytest.mark.parametrize("q", [2, 3, 10, 16, 27, 32, 44, 64, 65, 100, 256])
def test_psi1_kernels_match_plain_at_every_bucket(cuda, layout, q):
    """The Psi1 kernels alone (Psi2's cotangent zero) at each of their
    buckets (up to Q = 16) and K-chunked (past it, also past 64), with D
    over two chunks and more than one point tile: against the plain float32
    version at chip_smoke's GRAD_TOL_F32 (max abs of max|ref|), and against
    float64 at GRAD_TOL_F64 (norm-scaled)."""
    got, plain, ref = _psi1_case(cuda, 300, 150, q, 20, layout)
    for name, a, b, c in zip(("psi1_y",) + chip_smoke.GRAD_NAMES, got, plain, ref):
        assert float((a - b).abs().max()) <= chip_smoke.GRAD_TOL_F32 * float(b.abs().max()), name
        assert float(torch.linalg.norm(a - c) / torch.linalg.norm(c)) <= chip_smoke.GRAD_TOL_F64, name


@pytest.mark.parametrize("layout", chip_smoke.LAYOUTS)
@pytest.mark.parametrize("q, spread", [(10, 2.0), (100, 3.0)])
def test_psi1_kernels_on_wide_latents_match_float64(cuda, layout, q, spread):
    """Latents spread to +-8..10 around zeta (std 2 at Q = 10, 3 at
    Q = 100), each inducing point near a latent row: the expanded centred
    sums (u = mu'^2 H - 2 mu' T1 + T2) would cancel there, and the
    exponent's K sums run to hundreds where it is tens (Q = 100, where one
    float32 accumulator over the K chunks lost to the plain engine). Each
    output within max(F64_TOL, F64_FLOOR_FACTOR x the plain float32
    version's error) of float64, norm-scaled (the CPU model's counterpart:
    tests/test_torch_psi1_tc.py ``test_psi1_on_wide_latents_matches_jax_float64``)."""
    got, plain, ref = _psi1_case(cuda, 2000, 128, q, 20, layout, spread=spread)
    nrm = lambda a, b: float(torch.linalg.norm(a - b) / torch.linalg.norm(b))
    for name, a, b, c in zip(("psi1_y",) + chip_smoke.GRAD_NAMES, got, plain, ref):
        limit = max(chip_smoke.F64_TOL, chip_smoke.F64_FLOOR_FACTOR * nrm(b, c))
        assert nrm(a, c) <= limit, (name, nrm(a, c), limit)


@pytest.mark.parametrize("layout", chip_smoke.LAYOUTS)
@pytest.mark.parametrize("stat", spread_latents.STATS)
@pytest.mark.parametrize("q", spread_latents.CASES)
def test_spread_latent_kernels_within_twice_the_model(cuda, q, stat, layout):
    """Psi2 and Psi1 (each with the other's cotangent zero) on latents
    spread as a fit spreads them (``chip_smoke.spread_inputs``, N=400,
    M=64, D=16, spread 3), where the expanded exponent's terms grow with
    the spread: the kernels' statistic and every VJP leaf, norm-scaled
    against the plain version in float64 on the card, within the larger of
    F64_TOL and twice the CPU model's (``ops/psi_tc_model.py``) error on the
    same inputs, computed here, each leaf against the same leaf (dsf2 and
    dalpha, sums whose error is one draw of a cancelling sum, read as the
    median over seeds 0-24: ``tools/spread_latents.card_errors``; over
    seeds 0-4 the kernels' Psi1 dsf2 at Q=48 read 3.4x the model's, over
    25 draws 1.09x). The model
    stands for the arithmetic the kernels are meant to run; a kernel past
    twice its error rounds or accumulates otherwise. The limit the kernels
    must also stay under is the JAX package's own float32 path (Pallas in
    interpret mode) on these inputs, from tests/test_torch_spread_latents.py
    on the CPU (``python3 tools/spread_latents.py``, the same seed-0 and
    median readings), leaf by leaf: 8.7e-5 to 3.6e-4 at Q=10, 6.0e-5 (Psi1's
    dsf2) to 6.6e-4 at Q=32, 2.0e-4 to 4.3e-4 at Q=48, 1.9e-4 to 5.1e-4 at
    Q=64. Twice the model's error stays under the reference's on every leaf
    (closest at Q=48, Psi2's dmu: 1.5e-4 against 2.4e-4)."""
    errs = spread_latents.card_errors(q, stat, cuda, (layout,))
    limits = spread_latents.limits(errs, chip_smoke.F64_FLOOR_FACTOR, chip_smoke.F64_TOL)
    for name, (kernel, model) in errs.items():
        assert kernel <= limits[name], (name, kernel, model, limits[name], errs)


@pytest.mark.parametrize("q", [10, 100])
def test_psi1_point_splits_match_one_split(cuda, q):
    """N=16, M=640: the Psi1 row pass's one row block fills too little of
    the card, so the plan splits its inducing points over blocks (float64
    row partials, summed in a fixed order); with every grid in one split
    (a partial budget of one byte) it does not. Both agree to float64
    summation order."""
    plan = psi_cuda._plan_for(16, 640, q, 12, cuda, psi_cuda.PARTIAL_BYTES)
    assert plan[4] > 1, plan
    split = _psi1_case(cuda, 16, 640, q, 12)[0]
    with chip_smoke.partial_budget(1):
        one = _psi1_case(cuda, 16, 640, q, 12)[0]
    for a, b in zip(split, one):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6 * float(b.abs().max()))


@pytest.mark.parametrize("q", [3, 44])
def test_psi1_qn_kernels_equal_nq_kernels_with_point_splits(cuda, q):
    """At N=300, M=130 the Psi1 row pass splits its inducing points (5 row
    blocks); both layouts still run the same sums in the same order, also
    at Q=44 (Psi1 K-chunked, Psi2's bucket 64): bitwise equal but dalpha
    (as in the tests above)."""
    xs = list(_inputs(cuda, n=300, m=130, q=q, d=12))
    assert psi_cuda._plan(300, 130, q, 12, cuda)[4] > 1
    ts = [t.T.contiguous() if i in (0, 1, 5) else t for i, t in enumerate(xs)]
    p1y, p2 = psi_cuda.psi_fwd(*xs)
    p1y_t, p2_t = psi_cuda.psi_fwd_t(*ts)
    assert torch.equal(p1y, p1y_t) and torch.equal(p2, p2_t)
    cot = (torch.ones_like(p1y), torch.ones_like(p2))
    g = psi_cuda.psi_bwd(*xs, p1y, p2, *cot)
    g_t = psi_cuda.psi_bwd_t(*ts, p1y, p2, *cot)
    for i, (a, b) in enumerate(zip(g, g_t)):
        if i == 4:
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6 * float(b.abs().max()))
        else:
            assert torch.equal(a, b.T if i in (0, 1, 5) else b), i


@pytest.mark.parametrize("layout", chip_smoke.LAYOUTS)
def test_flushed_psi2_matches_plain_float64(cuda, layout):
    """chip_smoke's flush case: every Psi2 entry below 2^-126 (sf2 = 1e-20)
    at Q = 10; the kernels shift their exponents, so nothing flushes."""
    before = len(chip_smoke.FAILURES)
    res = chip_smoke.flush_case(*chip_smoke.FLUSH_CASE, device=cuda, layout=layout)
    assert len(chip_smoke.FAILURES) == before, res


@pytest.mark.parametrize("layout", ["nq", "qn"])
def test_infer_latents_launches_the_kernels(cuda, layout):
    """infer_latents on CUDA tensors computes the new points' statistics
    (and the training statistics) with the kernels, never the plain engine;
    and its objective's first evaluation matches the plain engine's on the
    same inputs (chip_smoke.SLICE_TOL, as phase 7 holds it)."""
    from gparml_tpu_torch import data
    from gparml_tpu_torch.models import gplvm

    y_np, _ = data.oil_flow_like(n=330, d=5, seed=2)
    y_all = torch.tensor(y_np.T.copy() if layout == "qn" else y_np, dtype=torch.float32,
                         device=cuda)
    y_tr, y_new = (y_all[:, :300], y_all[:, 300:]) if layout == "qn" else (y_all[:300],
                                                                           y_all[300:])
    y_tr, y_new = y_tr.contiguous(), y_new.contiguous()
    kw = dict(layout=layout, y_layout="dn" if layout == "qn" else "nd")
    cfg = gplvm.GPLVMConfig(q=3, num_inducing=12, **kw)
    p = gplvm.init_params(torch.Generator(cuda).manual_seed(0), y_tr, cfg)
    keys = ("fwd_t", "bwd_t") if layout == "qn" else ("fwd", "bwd")
    before = dict(psi_cuda.LAUNCHES)
    mu, s, res = gplvm.infer_latents(p, y_tr, y_new, cfg, iters=4)
    assert all(psi_cuda.LAUNCHES[k] > before[k] for k in keys), psi_cuda.LAUNCHES
    # Z is held: no forward forms the cell sums (fwd_cells / fwd = 0)
    cells = "fwd_cells_t" if layout == "qn" else "fwd_cells"
    assert psi_cuda.LAUNCHES[cells] == before[cells], psi_cuda.LAUNCHES
    assert mu.shape == (30, 3) and bool(torch.all(s > 0))
    b = res.trace["bound"][:4]
    assert np.all(np.isfinite(b)) and np.all(np.diff(b) >= 0)
    cfg_x = gplvm.GPLVMConfig(q=3, num_inducing=12, stats_impl="xla", **kw)
    vg, lat0 = gplvm._infer_objective(p, y_tr, y_new, cfg)
    f, g = vg(lat0)
    f_x, g_x = gplvm._infer_objective(p, y_tr, y_new, cfg_x)[0](lat0)
    assert abs(float(f) - float(f_x)) <= chip_smoke.SLICE_TOL * abs(float(f_x))
    for a, b in zip(g, g_x):
        assert float(torch.linalg.norm(a - b)) <= chip_smoke.SLICE_TOL * float(torch.linalg.norm(b))
