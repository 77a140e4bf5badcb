#!/usr/bin/env python3
"""Phases 1, 2 and 8 of chip_smoke.py alone: the card, the kernel build and
the data-parallel statistics (a mesh of 4 shards on one card, -p remote
with two processes sharing it, config 1 through -p remote), each check as
chip_smoke.py makes it. Exits 1 if a check failed.

Run from the repository root on a machine with an NVIDIA GPU:
    python3 tools/chip_phase8.py
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
    from gparml_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("chip_phase8: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _build.load()
    print(f"build {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda", 0)
    kernels = [{"name": "psi_fwd"}, {"name": "psi_bwd"}]
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="phase8_", dir=os.path.join(ROOT, "build"))
    try:
        for name, phase in (("8(a)", lambda: cs.phase8_mesh(dev, kernels)),
                            ("8(b)", lambda: cs.phase8_remote(dev, work)),
                            ("8(c)", lambda: cs.phase8_sgpr(dev, work))):
            t0 = time.perf_counter()
            phase()
            print(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"sharded launches {[k.get('launches_sharded') for k in kernels]}; "
          f"failed checks: {cs.FAILURES}")
    return 1 if cs.FAILURES else 0


if __name__ == "__main__":
    sys.exit(main())
