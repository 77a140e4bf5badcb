"""Readings for the limits of ``correct``, on the card at a cell's own size.

    python3 portbench/control.py --workload <cell> --seeds 1 2 ... \
        [--control-seeds 7 8 9] [--fault NAME] [--out FILE]

For each seed it runs the cell's set-up (a fit cell's start and first
steps; an inference cell's trained state and ``check_calls`` calls at the
cell's own load, with no measured window, on the seed's own rows) and
prints one JSON line: the program's readings of every number compared,
and, for a control seed, the control's (the reference at float32 with
TF32 products in the program's place). ``--fault`` plants a fault of ``faults.py`` under the program. The
benchmark's own runs never run this.
"""

import os
import sys
import time

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import argparse  # noqa: E402
import json  # noqa: E402

from portbench import faults, harness  # noqa: E402
from portbench.drive import common, fit, infer  # noqa: E402


def start_readings(cell, seed, devices, control):
    """The start alone: Y and ``gplvm.init_params``, no step."""
    from gparml_tpu_torch.models import gplvm

    y, _ = common.observations(cell.config, seed, devices[0])
    p = gplvm.init_params(common.init_generator(seed, devices[0]), y,
                          common.gplvm_config(cell.config))
    leaves = common.host_leaves(p)
    del p
    rm = common.RefModel(cell.config, y, devices[0])
    return ({"start": rm.start_gap(leaves)},
            {"start": rm.start_gap(leaves, control=True)} if control else None)


def readings(cell, seed, devices, control, fault, start_only=False):
    if start_only:
        return start_readings(cell, seed, devices, control)
    ctx = harness.Context(cell, seed, 0.0, False, devices, time.perf_counter())
    with faults.planted(fault):
        if cell.mix["drive"] == "fit":
            st = fit.first_steps(ctx)
            y = st.pop("y")
            del st["p"], st["gcfg"]
            common.free_device()
            prog, ctrl = fit.reference_checks(ctx, y, **st, control=control)
        else:
            # each seed's own rows and trained state: a superset of the
            # runs' one pool
            ctx.mix = dict(ctx.mix, data_seed=seed)
            st = infer.prepare(ctx)
            with ctx.window() as w:
                out = infer.serve(ctx, st, w, lambda w_, calls: calls >= cell.mix["check_calls"])
            leaves = common.host_leaves(st.pop("p"))
            common.free_device()
            args = (ctx, st["y"], st["held"], st["start"], leaves, st["train_bound"],
                    out["answers"])
            prog, ctrl = infer.reference_checks(*args, control=control)
    return prog, ctrl


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault", choices=faults.FAULTS)
    ap.add_argument("--start-only", action="store_true",
                    help="read the start alone (no step, no window)")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    cell = harness.Cell(args.workload)
    devices = harness.cuda_devices(cell.chips)
    sink = open(args.out, "a") if args.out else None
    for seed in args.seeds + [s for s in args.control_seeds if s not in args.seeds]:
        t0 = time.perf_counter()
        prog, ctrl = readings(cell, seed, devices, seed in args.control_seeds, args.fault,
                              args.start_only)
        line = json.dumps({"workload": cell.name, "seed": seed, "fault": args.fault,
                           "program": prog, "control": ctrl,
                           "seconds": time.perf_counter() - t0})
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()
        common.free_device()
    return 0


if __name__ == "__main__":
    sys.exit(main())
