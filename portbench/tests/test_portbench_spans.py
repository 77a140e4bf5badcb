"""The readers of the program's spans (``portbench/spans.py``,
``metrics/*`` with ``"source": "program_span"``): known values on a
hand-made window, None on a window without evaluations, and a real traced
run of each cell on the CPU, so that a renamed span fails here."""

import math
import time

import pytest
import torch

from portbench import harness, spans, trace
from portbench.tests import tiny

MS = 1_000_000  # ns


def _window():
    """One inference call: the set-up, the first evaluation and its read,
    then two SCG iterations of 2 and 1 evaluations and 4 and 2 reads."""
    at = [("gparml.infer_latents", 0, 20), ("gparml.infer.init", 0, 2),
          ("gparml.eval", 2, 4), ("gparml.eval.fwd", 2, 2.5), ("aten::mm", 2.1, 2.2),
          ("gparml.eval.bwd", 2.5, 3.5), ("gparml.scg.read", 4, 4.2),
          ("gparml.scg.iteration", 5, 12),
          ("gparml.scg.read", 5, 5.1), ("gparml.scg.read", 5.2, 5.3),
          ("gparml.eval", 6, 8), ("gparml.eval.fwd", 6, 6.6), ("gparml.eval.bwd", 6.6, 7.8),
          ("gparml.scg.read", 8.5, 8.6),
          ("gparml.eval", 9, 11), ("gparml.eval.fwd", 9, 9.4), ("gparml.eval.bwd", 9.4, 10.8),
          ("gparml.scg.read", 11, 11.5),
          ("gparml.scg.iteration", 13, 19),
          ("gparml.eval", 14, 16), ("gparml.eval.fwd", 14, 14.5),
          ("gparml.eval.bwd", 14.5, 15.5),
          ("gparml.scg.read", 17, 17.5), ("gparml.scg.read", 18, 18.2)]
    host = [(n, round(s * MS), round(e * MS)) for n, s, e in at]
    return trace.Trace(0, 21 * MS, [("k", MS, 2 * MS, 0)], host)


# 4 evaluations; iterations 13 ms less 6 ms of evaluations and 1.5 ms of reads
# inside them; 7 reads; forward 2.0 ms, backward 4.6 ms; one set-up of 2 ms
KNOWN = {"scg_host_ms.infer": 5.5 / 4, "scg_host_ms.fit": 5.5 / 4,
         "scg_reads_per_eval.infer": 7 / 4, "eval_fwd_ms.infer": 2.0 / 4,
         "eval_bwd_ms.infer": 4.6 / 4, "infer_init_ms.infer": 2.0}
SPAN_METRICS = sorted(m["name"] for m in harness.load_json(harness.ROOT / "BENCHMARK.json")
                      ["per_layer"] if m["source"] == "program_span")


def test_every_span_metric_has_a_known_value():
    assert SPAN_METRICS == sorted(KNOWN)


@pytest.mark.parametrize("name", sorted(KNOWN))
def test_reader_gives_the_known_value(name):
    r = harness.Reading(_window(), {}, "cpu")
    assert harness.metric_reader(name)(r) == pytest.approx(KNOWN[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(KNOWN))
def test_reader_gives_none_without_evaluations(name):
    t = _window()
    no_evals = [(t.names[i], s, e) for i, s, e in zip(t.host_name.tolist(),
                                                      t.host_start.tolist(),
                                                      t.host_end.tolist())
                if not t.names[i].startswith("gparml.eval")]
    for host in (no_evals, [("aten::mm", MS, 2 * MS)]):
        r = harness.Reading(trace.Trace(0, 21 * MS, [], host), {}, "cpu")
        assert harness.metric_reader(name)(r) is None


@pytest.mark.parametrize("cell", ["slice.fit", "config5.fit", "slice.infer"])
def test_a_traced_cpu_run_reads_every_span_metric(cell):
    c = tiny.cell(cell)
    ctx = harness.Context(c, 3_000_000_321, 0.3, True, [torch.device("cpu")],
                          time.perf_counter())
    out = c.driver().run(ctx)
    t, counters = out["window"].trace, out["counters"]
    assert spans.count(t, spans.EVAL) == counters["evals"] > 0
    reading = harness.Reading(t, counters, "cpu")
    read = {m["name"]: harness.metric_reader(m["name"])(reading) for m in c.per_layer
            if m["source"] == "program_span"}
    assert read and all(v is not None and math.isfinite(v) and v > 0 for v in read.values())
    if cell == "slice.infer":
        assert spans.count(t, spans.INFER_INIT) == counters["calls"]
        assert 4 <= read["scg_reads_per_eval.infer"] <= 7
