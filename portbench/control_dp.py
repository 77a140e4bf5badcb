"""Readings for the limits of ``correct`` in a ``fit_dp`` cell, on the cards
at the cell's own size: ``control.py`` for ranks.

    python3 portbench/control_dp.py --workload <cell> --seeds 1 2 ... \
        [--control-seeds 7 8 9] [--fault NAME] [--out FILE]

The ranks start once (``drive/fit_dp.Ranks``); for each seed every rank runs
the cell's set-up (its rows, the start and the first steps, no window) and
the reference's checks, and rank 0 prints one JSON line: the program's
readings of every number compared and, for a control seed, the control's
(the reference at float32 with TF32 products in the program's place).
``--fault`` plants a fault under the program on every rank: one of
``faults.py``, or ``dropped_rank``, the statistics of the last rank left out
of their sum over the ranks. The benchmark's own runs never run this.
"""

import os
import sys
import time

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from portbench import faults, harness  # noqa: E402
from portbench.drive import common, fit_dp  # noqa: E402

FAULTS = faults.FAULTS + ("dropped_rank",)
# seconds a seed's readings may take before every rank is killed
SEED_S = 600.0


@contextlib.contextmanager
def dropped_rank():
    """The last rank's statistics left out of the sum over the ranks (its
    rows still in its own gradient)."""
    from gparml_tpu_torch.parallel import distributed

    orig = distributed.all_reduce_stats

    def summed(st, mesh):
        if distributed.process_index() == distributed.process_count() - 1:
            st = type(st)(*(torch.zeros_like(t) for t in st))
        return orig(st, mesh)

    distributed.all_reduce_stats = summed
    try:
        yield
    finally:
        distributed.all_reduce_stats = orig


def planted(name):
    return dropped_rank() if name == "dropped_rank" else faults.planted(name)


def rank_readings(spec: dict, device: torch.device) -> None:
    """Every seed's readings on this rank; rank 0 prints and appends them."""
    cfg = spec["config"]
    sink = open(spec["out"], "a") if spec.get("out") and dist.get_rank() == 0 else None
    for seed in spec["seeds"]:
        t0 = time.perf_counter()
        with planted(spec["fault"]):
            st = fit_dp.first_steps(cfg, spec["mix"], seed, device)
        y = st.pop("y")
        for k in ("p", "gcfg", "mesh"):
            del st[k]
        common.free_device()
        prog, ctrl = fit_dp.reference_checks(cfg, device, y, **st,
                                             control=seed in spec["control_seeds"])
        del y
        common.free_device()
        if dist.get_rank() == 0:
            line = json.dumps({"workload": spec["workload"], "seed": seed, "fault": spec["fault"],
                               "program": prog, "control": ctrl,
                               "seconds": time.perf_counter() - t0})
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
    if sink:
        sink.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault", choices=FAULTS)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    cell = harness.Cell(args.workload)
    devices = harness.cuda_devices(cell.chips)
    seeds = args.seeds + [s for s in args.control_seeds if s not in args.seeds]
    spec = {"entry": "portbench.control_dp:rank_readings", "workload": cell.name,
            "config": cell.config, "mix": cell.mix, "seeds": seeds,
            "control_seeds": args.control_seeds, "fault": args.fault,
            "out": os.path.abspath(args.out) if args.out else None}
    with fit_dp.Ranks(spec, devices[0], SEED_S * max(1, len(seeds))) as ranks:
        rank_readings(ranks.spec, ranks.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
