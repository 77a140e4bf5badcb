"""Build and load the hand-written CUDA kernels (``gparml_tpu_torch/csrc``).

No JAX counterpart (Pallas compiled the TPU kernels inside ``pallas_call``).
At first use, one ``nvcc`` for each ``csrc/*.cu``, all started together,
compiles it for Hopper (``sm_90a``) without fast math, and a last ``nvcc``
links the objects into one shared library with a plain C interface. The
library lands in ``build/gparml_tpu_torch/<hash>/`` beside the package, keyed
by a hash of the sources and flags, and is loaded with ``ctypes``: every
pointer and the stream pass as ``c_void_p``, and each entry point returns
``cudaGetLastError()``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "csrc"
_BUILD_ROOT = _PKG.parent / "build" / "gparml_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _IP = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
_SZ = ctypes.c_size_t
# name -> argument types, in the order of the extern "C" signatures
_ENTRY_POINTS = {
    # n m q d num_sms | partial_bytes | plan (forward int[4], backward
    # int[5]): N-splits, shared memory need, limit, and the backward's Psi1
    # row-pass point splits
    "gparml_psi_fwd_plan": [_I] * 5 + [_SZ, _IP],
    "gparml_psi_bwd_plan": [_I] * 5 + [_SZ, _IP],
    # mu s y w z alpha sf2 zeta cells ce shift shift1 | n m q d qn splits2
    # splits1 cell_sums | p2_part p1y_part stream
    "gparml_psi_fwd": [_P] * 12 + [_I] * 8 + [_P] * 3,
    # mu s y w z alpha sf2 zeta cells ce shift shift1 kmat r1 | n m q d qn
    # splits_c splits_m splits_p | dmu ds dal dy a_part b_part row_part stream
    "gparml_psi_bwd": [_P] * 14 + [_I] * 8 + [_P] * 8,
    # q cell_sums | out (int[4]): psi2_fwd_tc_kernel<Q's bucket, cell_sums>'s
    # blocks an SM holds, the blocks its launch bounds ask for, registers,
    # local bytes
    "gparml_psi_fwd_residency": [_I, _I, _IP],
}

# Seconds the last ``load()`` spent compiling (0.0 when the library was
# already built); chip_smoke.py reports it.
last_build_seconds = 0.0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources() -> list:
    return sorted(p for p in _SRC.iterdir() if p.suffix in (".cu", ".cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return _BUILD_ROOT / h.hexdigest()[:16] / "libgparml_psi.so"


def build() -> Path:
    """Compile the kernels unless the library for these sources exists."""
    global last_build_seconds
    lib = library_path()
    if lib.exists():
        last_build_seconds = 0.0
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), os.getpid()
    srcs = [p for p in _sources() if p.suffix == ".cu"]
    objs = [lib.parent / f".{p.stem}.{tag}.o" for p in srcs]
    tmp = lib.with_name(f".{lib.name}.{tag}")
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(p)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for p, o in zip(srcs, objs)]
    logs = [proc.communicate()[0] for proc in procs]   # waits for every one
    failed = [(p.name, proc.returncode, log)
              for p, proc, log in zip(srcs, procs, logs) if proc.returncode != 0]
    if not failed:
        res = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                             capture_output=True, text=True)
        logs.append(res.stdout + res.stderr)
        if res.returncode != 0:
            failed.append(("link", res.returncode, logs[-1]))
    last_build_seconds = time.perf_counter() - t0
    (lib.parent / "nvcc.log").write_text("".join(logs))
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        name, rc, log = failed[0]
        raise RuntimeError(f"nvcc failed on {name} ({rc}):\n{log[-4000:]}")
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
