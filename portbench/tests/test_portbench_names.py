"""BENCHMARK.json against the contract's rules, and every name resolved."""

import json
import re

import pytest

from portbench import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")


@pytest.mark.parametrize("name", CELLS)
def test_cell_finds_its_files(name):
    c = harness.Cell(name)
    assert c.driver().run
    assert c.limits and all(v > 0 for v in c.limits.values())
    for m in c.per_layer:
        assert callable(harness.metric_reader(m["name"]))
    for key in ("n", "q", "m", "d", "layout", "y_layout", "dtype", "jitter", "s0"):
        assert key in c.config, key


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"][1].startswith("portbench/") and len(BENCH["command"]) <= 32
    assert all(LINE.match(w) for w in BENCH["command"])
    r = BENCH["run_seconds"]
    assert isinstance(r, int) and 1 <= r <= 51
    # a full check of 24 cells: 2 + 14 x 24 runs of r + 60 s, 2 x 90 s a cell to
    # compile, 1200 s spare
    assert (2 + 14 * 24) * (r + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_lines():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(set(names)) == len(names)
        assert all(NAME.match(n) for n in names), names
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert c["file"].startswith("portbench/") and all(NAME.match(k) for k in c["reduced"])
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert LINE.match(w["why"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert LINE.match(m["layer"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_config_files_state_their_cuts():
    for c in BENCH["configs"]:
        conf = json.loads((harness.ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and sorted(conf["reduced"]) == sorted(c["reduced"])
        assert all(k in conf["published"] for k in c["reduced"])


def test_every_cell_reports_setup_another_and_a_layer_metric():
    for name in CELLS:
        c = harness.Cell(name)
        e2e = {m["name"] for m in c.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert c.per_layer


def test_layer_metrics_are_reported_where_what_they_move_is():
    e2e_cells = {m["name"]: set(m.get("workloads", CELLS)) for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e_cells
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS and cell in e2e_cells[m["moves"]], (m["name"], cell)
    for name in CELLS:
        layered = {m["name"] for m in harness.Cell(name).per_layer}
        assert layered == {m["name"] for m in BENCH["per_layer"]
                           if name in m.get("workloads", CELLS)}


def test_paths_hold_only_names_of_allowed_characters():
    root = harness.ROOT / "portbench"
    for p in root.rglob("*"):
        if "__pycache__" in p.parts or "out" in p.relative_to(root).parts[:1]:
            continue
        assert re.match(r"^[A-Za-z0-9_.\-/]+$", str(p.relative_to(harness.ROOT))), p
