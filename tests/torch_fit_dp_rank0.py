"""Rank 0 of the benchmark's data-parallel fit at a tiny size on the CPU
(NOT a test module).

    python tests/torch_fit_dp_rank0.py RANKS run SECONDS
    python tests/torch_fit_dp_rank0.py RANKS traced SECONDS
    python tests/torch_fit_dp_rank0.py RANKS readings FAULT

``run`` runs ``portbench/drive/fit_dp.py`` as the harness runs it, and
``traced`` with its window traced, adding the cell's per-layer metrics;
``readings`` runs ``portbench/control_dp.py``'s readings of one seed with
its fault FAULT planted under the program on every rank. Both use RANKS
gloo ranks and the cell ``config5_dp4.fit`` cut to a float64 configuration
of N=64, M=8, Q=3, D=5, and print one JSON line: the run's end-to-end
numbers, counters and checks, or the readings. tests/test_torch_fit_dp.py
reads it.
"""

import json
import os
import sys
import time

T0 = time.perf_counter()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TINY = {"n": 64, "m": 8, "q": 3, "d": 5, "dtype": "float64"}
SEED = 3_000_000_123


def main(argv) -> int:
    import torch

    from portbench import control_dp, harness
    from portbench.drive import fit_dp

    ranks, mode, arg = int(argv[0]), argv[1], argv[2]
    cell = harness.Cell("config5_dp4.fit")
    cell.config = dict(cell.config, chips=ranks, **TINY)
    cpu = torch.device("cpu")
    if mode in ("run", "traced"):
        ctx = harness.Context(cell, SEED, float(arg), mode == "traced", [cpu], T0)
        out = fit_dp.run(ctx)
        result = {"end_to_end": out["end_to_end"], "counters": out["counters"],
                  "checks": out["checks"], "attempted": out["attempted"],
                  "failed": out["failed"], "window_s": out["window"].seconds}
        if mode == "traced":
            reading = harness.Reading(out["window"].trace, out["counters"], "cpu")
            result["metrics"] = {m["name"]: harness.metric_reader(m["name"])(reading)
                                 for m in cell.per_layer}
        print(json.dumps(result))
        return 0
    spec = {"entry": "portbench.control_dp:rank_readings", "workload": cell.name,
            "config": cell.config, "mix": cell.mix, "seeds": [SEED], "control_seeds": [],
            "fault": arg}
    with fit_dp.Ranks(spec, cpu, 300.0) as r:
        control_dp.rank_readings(r.spec, r.device)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
