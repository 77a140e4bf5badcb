#!/usr/bin/env python3
"""Where the time of one GPLVM bound+gradient evaluation goes on the GPU.

Drives gparml_tpu_torch's neg_bound_value_and_grad (stats_impl="auto", the
CUDA kernels) at one shape (default the slice: N=1e6, Q=10, M=200, D=12,
float32; data.oil_flow_like, PCA + FPS init, seed 0), times `--reps`
evaluations untraced (s/eval, the least), then traces `--reps` more with
torch.profiler and prints the device time per kernel or operator, the
device busy share of the traced window, and the card's name and power
limit. `--layout qn` runs GPLVMConfig(layout='qn', y_layout='dn'): latents
(Q, N) and Y (D, N). `--shape` takes named shapes (SHAPES), one after
another in the one process, in place of the sizes.

`--tree DIR` imports gparml_tpu_torch from another checkout's root (its
kernels are built there, under its own build/), for an A/B of two trees on
one card in one call; `--json` prints one JSON line a shape: s/eval,
device ms per evaluation of every `gparml::` `__global__` (template argument
kept) and of the Psi1 kernels together.

Run from the repository root on a machine with an NVIDIA GPU:
    python3 tools/torch_slice_profile.py [--n 1000000 --m 200 --q 10 --d 12]
    python3 tools/torch_slice_profile.py --layout qn --n 10000000 --m 500 --reps 1
A/B, the parent unpacked under build/ (which git ignores), parent, change,
change, parent:
    git archive HEAD | tar -x -C build/parent
    for t in build/parent . . build/parent; do python3 tools/torch_slice_profile.py \\
        --tree $t --json --shape slice m100 config5 q100 infer config2; done
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# name -> (layout, N, M, Q, D): the slice; phase 6(b) of chip_smoke.py;
# BASELINE config 5; Q = 100 (phase 6(c)); the statistics of phase 7's
# infer_latents (N* = 1e3 held-out rows); BASELINE config 2's size
SHAPES = {"slice": ("nq", 1_000_000, 200, 10, 12),
          "m100": ("nq", 1_000_000, 100, 10, 12),
          "config5": ("qn", 10_000_000, 500, 10, 12),
          "q100": ("nq", 100_000, 256, 100, 128),
          "infer": ("nq", 1_000, 200, 10, 12),
          "config2": ("nq", 1_000, 50, 10, 12)}


def _kernel_name(name):
    """A profiler event's name, `gparml::` kernels shortened to their
    identifier and template argument."""
    return name.split("(")[0].split("gparml::")[-1] if "gparml::" in name else name


def _profile(shape, layout, n, m, q, d, reps, rows_shown, label, as_json):
    """Time and trace neg_bound_value_and_grad at one shape; print its
    lines (or its JSON line)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gparml_tpu_torch import data
    from gparml_tpu_torch.models import gplvm

    dev = torch.device("cuda", 0)
    y_np, _ = data.oil_flow_like(n=n, d=d)
    if layout == "qn":
        y_np = y_np.T
    y = torch.tensor(np.ascontiguousarray(y_np, dtype=np.float32), device=dev)
    del y_np
    cfg = gplvm.GPLVMConfig(q=q, num_inducing=m, stats_impl="auto", layout=layout,
                            y_layout="dn" if layout == "qn" else "nd")
    p = gplvm.init_params(torch.Generator(dev).manual_seed(0), y, cfg)
    t0 = time.perf_counter()
    gplvm.neg_bound_value_and_grad(p, y, cfg)   # build + warm-up
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        gplvm.neg_bound_value_and_grad(p, y, cfg)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
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
    print(f"{label}: {layout} N={n} M={m} Q={q} D={d}: {min(times):.4f} s/eval untraced "
          f"(first call {first:.1f} s, the build included), {wall / reps:.4f} traced; "
          f"device busy {busy / wall:.1%} of the window")
    print(f"kernel time {busy / reps * 1e3:.3f} ms/eval")
    if as_json:
        ms = {}
        for us, _, name in rows:
            if "gparml::" in name:
                key = _kernel_name(name)
                ms[key] = ms.get(key, 0.0) + us / 1e3 / reps
        print(json.dumps({"tree": label, "shape": shape, "layout": layout, "n": n, "m": m,
                          "q": q, "d": d, "s_per_eval": min(times), "globals_ms": ms,
                          "psi1_ms": sum(v for k, v in ms.items() if k.startswith("psi1"))}),
              flush=True)
    else:
        print(f"{'device ms/eval':>15} {'calls/eval':>10}  name")
        for us, count, key in rows[:rows_shown]:
            print(f"{us / 1e3 / reps:15.3f} {count / reps:10.1f}  {key[:90]}")
    del p, y
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--m", type=int, default=200)
    ap.add_argument("--q", type=int, default=10)
    ap.add_argument("--d", type=int, default=12)
    ap.add_argument("--layout", choices=("nq", "qn"), default="nq")
    ap.add_argument("--shape", nargs="+", choices=sorted(SHAPES), default=None,
                    help="named shapes, one after another, in place of the sizes")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--rows", type=int, default=20, help="table rows to print")
    ap.add_argument("--tree", default=ROOT, help="root of the checkout to import")
    ap.add_argument("--json", action="store_true", help="print one JSON line a shape")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    from gparml_tpu_torch.ops import _build

    found = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(_build.__file__))))
    if found != tree:
        print(f"torch_slice_profile: gparml_tpu_torch imported from {found}, not {tree}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch_slice_profile: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    label = os.path.relpath(tree, ROOT)
    t0 = time.perf_counter()
    _build.load()
    print(f"{label}: build {time.perf_counter() - t0:.1f} s", flush=True)
    shapes = ([(name, *SHAPES[name]) for name in args.shape] if args.shape else
              [(None, args.layout, args.n, args.m, args.q, args.d)])
    for shape in shapes:
        _profile(*shape, args.reps, args.rows, label, args.json)
    return 0


if __name__ == "__main__":
    sys.exit(main())
