"""The harness: finds a cell's configuration, traffic, limits and metrics by
the names in ``BENCHMARK.json``, runs the cell's driver, reads the per-layer
metrics from the trace, judges the numbers compared against their limits,
and prints the result.

A cell names a configuration (``configs/<name>.json``, the file that
``BENCHMARK.json`` gives it) and a traffic mix (``traffic/<name>.json``,
whose ``drive`` names the loop in ``drive/`` that runs it); its limits are
``limits/<cell>.json``; each per-layer metric is read by
``metrics/<metric>.py``'s ``read``. Adding any of these is adding files and
entries: nothing here names a cell, a configuration or a metric.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import torch

from portbench import trace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Top-level modules that must not be loaded in a run: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "gparml_tpu")


class Refusal(RuntimeError):
    """A run that cannot give a result (no card, a name not found, JAX loaded)."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise Refusal(f"no {what} named {name!r} in BENCHMARK.json")


class Cell:
    """Everything a run of one cell reads, found by name."""

    def __init__(self, name: str):
        self.bench = load_json(ROOT / "BENCHMARK.json")
        self.entry = find(self.bench["workloads"], name, "workload")
        self.name = name
        conf = find(self.bench["configs"], self.entry["config"], "configuration")
        self.config = load_json(ROOT / conf["file"])
        self.mix = load_json(HERE / "traffic" / f"{self.entry['traffic']}.json")
        self.limits = load_json(HERE / "limits" / f"{name}.json")
        self.chips = int(self.entry["chips"])
        self.end_to_end = [m for m in self.bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in self.bench["per_layer"]
                          if name in m.get("workloads", [name]) and m["moves"] in reported]

    def driver(self):
        return importlib.import_module(f"portbench.drive.{self.mix['drive']}")


def metric_reader(name: str):
    """``read`` of ``metrics/<name>.py`` (names may hold dots)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Context:
    """What a driver gets: the cell's configuration and mix, the seed, the
    window's length, its devices (as many as the cell asks for) and the
    window itself (``window()``), traced or not."""

    def __init__(self, cell: Cell, seed: int, seconds: float, traced: bool, devices,
                 t_start: float):
        self.cell, self.config, self.mix = cell.name, cell.config, cell.mix
        self.seed, self.seconds, self.traced = seed, seconds, traced
        self.devices = list(devices)
        self.t_start = t_start

    def since_start(self) -> float:
        return time.perf_counter() - self.t_start

    def window(self) -> trace.Window:
        return trace.Window(self.devices, self.traced)


class Reading:
    """What a per-layer metric reads: the window's trace, the driver's
    counters, and the card's peak rates (``peaks.json``; None for a card
    not in the table)."""

    def __init__(self, trace_: trace.Trace, counters: dict, device_name: str):
        self.trace, self.counters = trace_, counters
        self.peaks = load_json(HERE / "peaks.json").get(device_name)


def cuda_devices(chips: int):
    """The cell's cards; a run without them gives no result."""
    if not torch.cuda.is_available():
        raise Refusal("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        raise Refusal(f"the cell needs {chips} cards; {torch.cuda.device_count()} visible")
    return [torch.device("cuda", i) for i in range(chips)]


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def judge(checks: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}): every number compared at or
    under its limit, a missing or non-finite number failing."""
    out, ok = {}, True
    for name, limit in limits.items():
        value = checks.get(name)
        good = value is not None and math.isfinite(value) and value <= limit
        ok &= good
        out[name] = {"value": value, "limit": limit}
    return ok, out


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, devices, t_start: float,
             device_name: str) -> dict:
    """The result line of one run (a dict), before the check for JAX."""
    ctx = Context(cell, seed, seconds, traced, devices, t_start)
    out = cell.driver().run(ctx)
    win = out["window"]
    device = {"platform": "gpu", "kind": device_name, "count": len(devices),
              "memory_peak_bytes": int(out["memory_peak_bytes"])}
    if traced:
        t = win.trace
        if t is None:
            raise Refusal("the profiler recorded no window")
        reading = Reading(t, out["counters"], device_name)
        metrics = {}
        for m in cell.per_layer:
            v = metric_reader(m["name"])(reading)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device["busy_s"] = t.busy_s()
        device["window_s"] = t.window_s
        breakdown = {"device_ops": t.top_device_ops(10), "idle_gaps": t.idle_gaps(10)}
    else:
        values = dict(out["end_to_end"], setup_s=out["setup_s"])
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in values}
        breakdown = None
    correct, checks = judge(out["checks"], cell.limits)
    correct &= out["failed"] == 0
    result = {"correct": bool(correct), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics, "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    print(f"portbench: set-up {out['setup_s']:.2f} s, window {win.seconds:.2f} s, "
          f"trace read {win.parse_s or 0.0:.2f} s, reference {out['reference_s']:.2f} s",
          file=sys.stderr)
    return result


def checks_text(checks: dict) -> list:
    return [f"check {name}: {c['value']!r} (limit {c['limit']!r})" for name, c in checks.items()]


def main(argv, t_start: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json on the card.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        cell = Cell(args.workload)
        devices = cuda_devices(cell.chips)
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace), devices, t_start,
                          torch.cuda.get_device_name(devices[0]))
    except Refusal as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"portbench: modules that must not load were loaded: {found}", file=sys.stderr)
        return 3
    for line in checks_text(result["checks"]):
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0
