"""A run of each cell, past the harness's look for a card, on the CPU at a
tiny size in float64: correct when sound, and not correct with each fault
that the cell can have planted under its timed path."""

import pytest

from portbench import faults
from portbench.tests import tiny

CELL_FAULTS = [("slice.fit", "unchanged"), ("slice.fit", "half"), ("slice.fit", "steepest"),
               ("config5.fit", "unchanged"), ("config5.fit", "half"),
               ("config5.fit", "steepest"), ("slice.infer", "unchanged_infer"),
               ("slice.infer", "half"), ("slice.infer", "altered")]


@pytest.mark.parametrize("name", ["slice.fit", "config5.fit", "slice.infer"])
def test_sound_run_is_correct(name):
    r = tiny.run(tiny.cell(name))
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    c = tiny.cell(name)
    assert set(r["metrics"]) == {m["name"] for m in c.end_to_end}
    assert "setup_s" in r["metrics"] and len(r["metrics"]) >= 2


@pytest.mark.parametrize("name,fault", CELL_FAULTS)
def test_planted_fault_is_not_correct(name, fault):
    with faults.planted(fault):
        r = tiny.run(tiny.cell(name))
    assert not r["correct"], r["checks"]


def test_traced_run_reads_its_layer_metrics():
    r = tiny.run(tiny.cell("slice.infer"), traced=True)
    assert set(r["device"]) >= {"busy_s", "window_s"} and "breakdown" in r
    assert "device_idle.infer" in r["metrics"]
