"""Run one cell of the benchmark of ``gparml_tpu_torch`` on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result as one JSON object; the numbers compared for ``correct`` are the
last lines of standard error and the result's last key. Without a CUDA
device (or with fewer than the cell asks for) it exits with code 2 and
prints no result. See ``harness.py``.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root, in place of this folder, whose module names
# (trace, data) would shadow others
sys.path[0] = ROOT

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
