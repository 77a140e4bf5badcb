"""The port's host spans (``utils/logging.span``): recorded under a
profiler and nested as the GPLVM's fit and inference calls nest, one
evaluation span for each of ``FitResult.n_evals``, SCG's blocking reads
counted from ``opt/scg.py``; without a profiler, the shared no-op."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gparml_tpu_torch import data as tdata
from gparml_tpu_torch.models import gplvm, sgpr
from gparml_tpu_torch.utils import logging as glog

torch.set_num_threads(2)

CALL = {"fit": "gparml.fit", "infer": "gparml.infer_latents"}
# the leaves SCG moves: the four globals and the latents' two; q(x*)'s two
LEAVES = {"fit": 6, "infer": 2}


def _model():
    y, _ = tdata.synthetic_gplvm(n=30, d=4, q_true=1, seed=2)
    y = torch.as_tensor(y, dtype=torch.float64)
    cfg = gplvm.GPLVMConfig(q=2, num_inducing=5)
    return y, cfg, gplvm.init_params(torch.Generator().manual_seed(0), y, cfg)


def _call(kind, y, cfg, p0, trained):
    if kind == "fit":
        return gplvm.fit(p0, y, cfg, iters=4)
    return gplvm.infer_latents(trained, y, y[:6] + 0.05, cfg, iters=4)[2]


def _profiled(kind):
    y, cfg, p0 = _model()
    trained = gplvm.fit(p0, y, cfg, iters=2).params if kind == "infer" else None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = _call(kind, y, cfg, p0, trained)
    return res, [e for e in prof.events() if e.name.startswith("gparml.")]


def _children(e, name):
    return [c for c in e.cpu_children if c.name == name]


def _expected_reads(evals: int, accepted: bool, leaves: int) -> int:
    """One SCG iteration's reads (``opt/scg.py`` ``_step``): with the
    curvature probe d.g, d.d, d.g+; then the bound, each leaf's largest
    magnitude in d and in x, g.g, and g_old.g when the step was accepted."""
    return 3 * (evals == 2) + 1 + 2 * leaves + 1 + int(accepted)


@pytest.mark.parametrize("kind", ["fit", "infer"])
def test_spans_nest_as_the_calls_do(kind):
    res, spans = _profiled(kind)
    for e in spans:   # one clock: each span inside its parent's interval
        p = e.cpu_parent
        assert p is None or (p.time_range.start <= e.time_range.start
                             and e.time_range.end <= p.time_range.end)
    (call,) = [e for e in spans if e.name == CALL[kind]]
    assert call.cpu_parent is None or not call.cpu_parent.name.startswith("gparml.")
    iterations = [e for e in spans if e.name == "gparml.scg.iteration"]
    evals = [e for e in spans if e.name == "gparml.eval"]
    reads = [e for e in spans if e.name == "gparml.scg.read"]
    assert len(evals) == res.n_evals
    assert len(iterations) == int(np.sum(np.isfinite(res.trace["bound"])))
    assert all(e.cpu_parent is call for e in iterations)
    # the first evaluation and its bound's read open the call's loop
    assert len(_children(call, "gparml.eval")) == len(_children(call, "gparml.scg.read")) == 1
    for e in evals:
        assert e.cpu_parent.name in (CALL[kind], "gparml.scg.iteration")
        assert [c.name for c in e.cpu_children if c.name.startswith("gparml.")] == [
            "gparml.eval.fwd", "gparml.eval.bwd"]
    assert all(e.cpu_parent.name in (CALL[kind], "gparml.scg.iteration") for e in reads)
    for it, accepted in zip(iterations, res.trace["accepted"]):
        n = len(_children(it, "gparml.eval"))
        assert 1 <= n <= 2
        assert len(_children(it, "gparml.scg.read")) == _expected_reads(n, accepted,
                                                                        LEAVES[kind])
    init = [e for e in spans if e.name == "gparml.infer.init"]
    if kind == "infer":
        assert len(init) == 1 and init[0].cpu_parent is call
        assert init[0].time_range.end <= min(e.time_range.start for e in evals)
    else:
        assert not init


def test_other_models_get_the_scg_spans():
    y, _ = tdata.synthetic_gplvm(n=30, d=3, q_true=1, seed=4)
    y = torch.as_tensor(y, dtype=torch.float64)
    x = torch.linspace(-1.0, 1.0, 30, dtype=torch.float64)[:, None]
    cfg = sgpr.SGPRConfig(num_inducing=4)
    p0 = sgpr.init_params(torch.Generator().manual_seed(0), x, y, cfg)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = sgpr.fit(p0, x, y, cfg, iters=3)
    names = [e.name for e in prof.events() if e.name.startswith("gparml.")]
    assert names.count("gparml.scg.iteration") == int(np.sum(np.isfinite(res.trace["bound"])))
    assert names.count("gparml.scg.read") > names.count("gparml.scg.iteration")
    assert "gparml.eval" not in names


def _low_level():
    from torch._C._profiler import _ExperimentalConfig
    from torch.autograd import (ProfilerActivity as Activity, ProfilerConfig, ProfilerState,
                                _disable_profiler, _enable_profiler, _prepare_profiler)

    config = ProfilerConfig(ProfilerState.KINETO, False, False, False, False, False,
                            _ExperimentalConfig())
    _prepare_profiler(config, {Activity.CPU})
    _enable_profiler(config, {Activity.CPU})
    try:
        with glog.span("gparml.eval"):
            torch.ones(3).sum()
    finally:
        events = _disable_profiler().events()
    return [e.name() for e in events]


def _high_level():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with glog.span("gparml.eval"):
            torch.ones(3).sum()
    return [e.name for e in prof.events()]


@pytest.mark.parametrize("record", [_high_level, _low_level], ids=["profile", "low_level"])
def test_span_records_under_either_way_of_starting_a_profiler(record):
    assert glog.span("gparml.eval") is glog._NO_SPAN
    assert record().count("gparml.eval") == 1
    assert glog.span("gparml.eval") is glog._NO_SPAN


def test_without_a_profiler_no_record_function_is_entered(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a span was entered with no profiler recording")

    monkeypatch.setattr(glog, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    y, cfg, p0 = _model()
    res = gplvm.fit(p0, y, cfg, iters=2)
    _, _, inf = gplvm.infer_latents(res.params, y, y[:5], cfg, iters=2)
    assert np.isfinite(res.bound) and np.isfinite(inf.bound)
    assert glog.span("gparml.fit") is glog.span("gparml.eval") is glog._NO_SPAN
