"""The control on the card: the reference at float32 with TF32 products in
the program's place fails a number of each cell's limits: the fit cells on
a cut of their size (N=5e4, M=100, where TF32 already reads far past the
limits), the inference cell at its own (at the cut its TF32 readings stay
under them); ``control.py`` reads every cell at its own size.

    python -m pytest portbench/tests/test_portbench_control.py -q
"""

import time

import pytest
import torch

from portbench import harness
from portbench.drive import common, fit, infer
from portbench.tests import tiny

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return [torch.device("cuda", 0)]


def _cell(name):
    c = tiny.cell(name, dtype="float32")
    c.config = dict(c.config, n=50_000, q=10, m=100, d=12)
    return c


@pytest.mark.parametrize("name", ["slice.fit", "config5.fit"])
def test_control_fails_a_fit_limit(cuda, name):
    c = _cell(name)
    ctx = harness.Context(c, 3_000_000_777, 0.0, False, cuda, time.perf_counter())
    st = fit.first_steps(ctx)
    y = st.pop("y")
    del st["p"], st["gcfg"]
    common.free_device()
    got = fit.reference_checks(ctx, y, **st, control=True)[1]
    assert any(got[k] > v for k, v in c.limits.items()), (got, c.limits)


def test_control_fails_an_inference_limit(cuda):
    c = harness.Cell("slice.infer")
    ctx = harness.Context(c, 3_000_000_778, 0.0, False, cuda, time.perf_counter())
    st = infer.prepare(ctx)
    with ctx.window() as w:
        out = infer.serve(ctx, st, w, lambda w_, calls: calls >= 2)
    leaves = common.host_leaves(st.pop("p"))
    got = infer.reference_checks(ctx, st["y"], st["held"], st["start"], leaves,
                                 st["train_bound"], out["answers"], control=True)[1]
    assert any(got[k] > v for k, v in c.limits.items()), (got, c.limits)
