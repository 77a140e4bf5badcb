"""What the port's examples share: the repository root on ``sys.path``,
the ``--device`` option and the dtype that goes with it, and the kernels'
launch counts."""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import torch  # noqa: E402


def parser(doc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda:0 (the default; raises without a card) or the CPU")
    return ap


def device_and_dtype(name: str):
    """(device, dtype): cuda:0 in float32, the CUDA kernels' type, or the
    CPU in float64, as the JAX package's demos run there. No card under
    --device cuda raises."""
    if name == "cpu":
        return torch.device("cpu"), torch.float64
    if not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device; pass --device cpu to run on the CPU")
    return torch.device("cuda", 0), torch.float32


def print_launches() -> None:
    """Print, as the last line, this process's CUDA kernel launch counts
    (``psi_cuda.LAUNCHES``; all 0 on the CPU, where the wrappers run their
    plain versions)."""
    from gparml_tpu_torch.ops import psi_cuda

    print(json.dumps({"kernel_launches": dict(psi_cuda.LAUNCHES)}))
