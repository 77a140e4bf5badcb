"""The reference against the port's plain engine in float64 (CPU): the
bound and every gradient leaf, in both layouts, the inference objective
and the reference's SCG against the port's."""

import numpy as np
import pytest
import torch

from portbench.reference import gplvm as ref
from portbench.reference import init as ref_init
from portbench.reference import scg as ref_scg
from gparml_tpu_torch.models import gplvm, params as P

F64 = torch.float64


def _model(layout="nq", n=300, q=3, m=12, d=5, seed=0):
    torch.manual_seed(seed)
    y = torch.randn(n + 40, d, dtype=F64)
    y, y_new = y[:n], y[n:]
    cfg = gplvm.GPLVMConfig(q=q, num_inducing=m, stats_impl="xla", layout=layout,
                            y_layout="dn" if layout == "qn" else "nd")
    y_prog = y.T.contiguous() if layout == "qn" else y
    p = gplvm.init_params(torch.Generator().manual_seed(seed + 1), y_prog, cfg)
    with torch.no_grad():   # away from the start, where every leaf moves
        p.lat.u_s.add_(0.3 * torch.randn_like(p.lat.u_s))
        p.glob.u_alpha.add_(0.2 * torch.randn(q, dtype=F64))
        p.lat.mu.add_(0.5 * torch.randn_like(p.lat.mu))
    return y, y_prog, y_new, cfg, p


@pytest.mark.parametrize("layout", ["nq", "qn"])
@pytest.mark.parametrize("block_elems", [1 << 26, 600])
def test_value_and_grad_match_the_plain_engine(layout, block_elems, monkeypatch):
    monkeypatch.setattr(ref, "_BLOCK_ELEMS", block_elems)
    y, y_prog, _, cfg, p = _model(layout)
    f, g = gplvm.neg_bound_value_and_grad(p, y_prog, cfg)
    lv = P.leaves(p)
    rows = [ref.to_rows(t, layout, F64) for t in lv[4:]]
    fr, gr = ref.value_and_grad(y, *rows, ref.globals_of(lv, F64), 5,
                                ref.effective_jitter(cfg.jitter, F64))
    assert abs(float(f) - fr) <= 1e-12 * abs(fr)
    assert abs(ref.value(y, *rows, ref.globals_of(lv, F64), 5, 1e-6) + fr) <= 1e-12 * abs(fr)
    for a, b in zip(g, gr):
        a = a.T if (layout == "qn" and a.shape != b.shape) else a
        assert float((a - b).abs().max()) <= 1e-10 * float(b.abs().max())
    assert ref.leaf_gaps(g, gr) <= 1e-12


def test_infer_objective_and_scg_match_the_port():
    y, _, y_new, cfg, p = _model()
    mu_s, s_s, res = gplvm.infer_latents(p, y, y_new, cfg, iters=10)
    lv = P.leaves(p)
    g = ref.globals_of(lv, F64)
    obj = ref.InferObjective(ref.stats(y, lv[4], lv[5], g, ref.cells_of(12, "cpu")), g,
                             y_new, 5, 1e-6)
    vg, lat0 = gplvm._infer_objective(p, y, y_new, cfg)
    start = obj.start(y, lv[4], cfg.s0)
    assert all(torch.equal(a, b) for a, b in zip(start, lat0))
    f, gr = vg(lat0)
    fr, grr = obj(lat0)
    assert abs(float(f) - fr) <= 1e-12 * abs(fr)
    assert all(float((a - b).abs().max()) <= 1e-10 * float(b.abs().max()) for a, b in zip(gr, grr))
    x, f_end, iters, _ = ref_scg.minimize(obj, start, ref_scg.options_for(F64, 10))
    assert iters == 10 and abs(-f_end - res.bound) <= 1e-10 * abs(res.bound)
    assert float((x[0] - mu_s).abs().max()) <= 1e-6


def test_replay_follows_the_ports_scg():
    y, _, _, cfg, p = _model()
    res = gplvm.fit(p, y, cfg, iters=3)
    lv = P.leaves(p)

    def vg(x):
        return ref.value_and_grad(y, x[4], x[5], ref.Globals(*x[:4]), 5,
                                  ref.effective_jitter(cfg.jitter, F64))

    ran = np.isfinite(res.trace["alpha"])
    assert ran.sum() == 3 and res.trace["accepted"].all()
    x = ref_scg.replay(vg, lv, res.trace["alpha"][ran], res.trace["accepted"][ran])
    for a, b in zip(x, P.leaves(res.params)):
        assert float((a - b).abs().max()) <= 1e-9 * (1.0 + float(b.abs().max()))
    steepest = ref_scg.replay(vg, lv, res.trace["alpha"][ran][:1], [True])
    x1 = P.leaves(gplvm.fit(p, y, cfg, iters=1).params)
    assert all(float((a - b).abs().max()) <= 1e-9 * (1.0 + float(b.abs().max()))
               for a, b in zip(steepest, x1))


def test_start_gap_reads_the_ports_start_small_and_a_random_one_large():
    y, _, _, cfg, _ = _model()
    p = gplvm.init_params(torch.Generator().manual_seed(3), y, cfg)
    lv = P.leaves(p)
    args = (lv[5], lv[1], lv[2], lv[3], cfg.s0)
    assert ref_init.start_gap(y, lv[4], *args) <= 1e-10
    assert ref_init.start_gap(y, torch.randn_like(lv[4]), *args) >= 1e-3


def test_lower_precision_gives_a_finite_bound():
    y, _, _, cfg, p = _model()
    lv = P.leaves(p)
    f32 = [t.float() for t in lv]
    fr, _ = ref.value_and_grad(y.float(), f32[4], f32[5], ref.Globals(*f32[:4]), 5, 1.2e-5)
    f64 = ref.value(y, lv[4], lv[5], ref.globals_of(lv, F64), 5, 1.2e-5)
    assert abs(-fr - f64) <= 1e-4 * abs(f64)
