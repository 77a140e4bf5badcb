#!/usr/bin/env python3
"""Where the time of one GPLVM bound+gradient evaluation goes on the GPU.

Drives gparml_tpu_torch's neg_bound_value_and_grad (stats_impl="auto", the
CUDA kernels) at the slice shape (default N=1e6, Q=10, M=200, D=12,
float32), then traces `--reps` evaluations with torch.profiler and prints
the device time per kernel or operator, the device busy share of the traced
window, and the card's name and power limit. `--layout qn` runs
GPLVMConfig(layout='qn', y_layout='dn'): latents (Q, N) and Y (D, N).

Run from the repository root on a machine with an NVIDIA GPU:
    python3 tools/torch_slice_profile.py [--n 1000000 --m 200 --q 10 --d 12]
    python3 tools/torch_slice_profile.py --layout qn --n 10000000 --m 500 --reps 1
"""

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--m", type=int, default=200)
    ap.add_argument("--q", type=int, default=10)
    ap.add_argument("--d", type=int, default=12)
    ap.add_argument("--layout", choices=("nq", "qn"), default="nq")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--rows", type=int, default=20, help="table rows to print")
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gparml_tpu_torch import data
    from gparml_tpu_torch.models import gplvm

    if not torch.cuda.is_available():
        print("torch_slice_profile: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    y_np, _ = data.oil_flow_like(n=args.n, d=args.d)
    if args.layout == "qn":
        y_np = y_np.T
    y = torch.tensor(np.ascontiguousarray(y_np, dtype=np.float32), device=dev)
    cfg = gplvm.GPLVMConfig(q=args.q, num_inducing=args.m, stats_impl="auto",
                            layout=args.layout,
                            y_layout="dn" if args.layout == "qn" else "nd")
    p = gplvm.init_params(torch.Generator(dev).manual_seed(0), y, cfg)
    gplvm.neg_bound_value_and_grad(p, y, cfg)   # build + warm-up
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.reps):
            gplvm.neg_bound_value_and_grad(p, y, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side kernel and copy events only: CPU-side ranges (aten ops,
    # autograd Functions) report their children's device time again
    per_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us, count = per_name.get(e.name, (0.0, 0))
            per_name[e.name] = (us + e.time_range.elapsed_us(), count + 1)
    rows = sorted(((us, count, name) for name, (us, count) in per_name.items()),
                  reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    print(f"{args.layout} N={args.n} M={args.m} Q={args.q} D={args.d}: "
          f"{wall / args.reps:.4f} s/eval "
          f"traced; device busy {busy / wall:.1%} of the window")
    print(f"kernel time {busy / args.reps * 1e3:.3f} ms/eval")
    print(f"{'device ms/eval':>15} {'calls/eval':>10}  name")
    for us, count, key in rows[:args.rows]:
        print(f"{us / 1e3 / args.reps:15.3f} {count / args.reps:10.1f}  {key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
