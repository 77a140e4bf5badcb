#!/usr/bin/env python3
"""Phases 1 and 9 of chip_smoke.py alone: the card and SVGP minibatch
training (the API at the production shape in both layouts, a mesh of 4
shards on the card, the CLI on BASELINE config 1's folders, -p remote with
two processes sharing the card), each check as chip_smoke.py makes it.
SVGP runs no hand-written kernel, so nothing is built. Exits 1 if a check
failed.

Run from the repository root on a machine with an NVIDIA GPU:
    python3 tools/chip_phase9.py
"""

import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("chip_phase9: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="phase9_", dir=os.path.join(ROOT, "build"))
    t_all = time.perf_counter()
    try:
        t0 = time.perf_counter()
        x, y, p = cs.phase9_api(dev)
        print(f"phase 9(a): {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        cs.phase9_mesh(dev, x, y, p)
        print(f"phase 9(b): {time.perf_counter() - t0:.1f} s")
        del x, y, p
        torch.cuda.empty_cache()
        for name, phase in (("9(c)", lambda: cs.phase9_cli(dev, work)),
                            ("9(d)", lambda: cs.phase9_remote(dev, work))):
            t0 = time.perf_counter()
            phase()
            print(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"phase 9: {time.perf_counter() - t_all:.1f} s; failed checks: {cs.FAILURES}")
    return 1 if cs.FAILURES else 0


if __name__ == "__main__":
    sys.exit(main())
