#!/usr/bin/env python3
"""What sets the pace of the K-chunked (Q > 64) Psi2 kernels, by ablation.

Each variant is a copy of gparml_tpu_torch/csrc with one piece of the
chunked kernels taken out by a text substitution (the tensor-core
products, the per-chunk operand builds, the cells' builds, the
backward's reductions, or their float64 adds), built with nvcc into its
own library under build/chunked_ablation/ and timed, device ms per
kernel from torch.profiler, at N=1e5, M=256, Q=100, D=128 (random inputs).
The outputs of a variant are wrong by construction: only its time means
anything. Prints the card's name and power limit first.

Run from the repository root on a machine with an NVIDIA GPU:
    python3 tools/chunked_ablation.py
"""

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# variant -> {source: [(text, replacement), ...]}
VARIANTS = {
    "base": {},
    "fwd without products": {"psi_fwd.cu": [
        ("      tc_tile<KC>(cop.hi + tile * KC", "      if (q < 0) tc_tile<KC>(cop.hi + tile * KC")]},
    "fwd without chunk builds": {"psi_fwd.cu": [
        ("      rows.put(q, n0, hi, k0, &rop, nullptr, &rc);\n      cch.put(&cop, nullptr);",
         "      if (k0 == 0) {\n        rows.put(q, n0, hi, k0, &rop, nullptr, &rc);\n"
         "        cch.put(&cop, nullptr);\n      }"),
        ("      if (k0 + kTcQChunk < q) {  // the next chunk's loads",
         "      if (q < 0) {  // the next chunk's loads")]},
    "fwd without the cells' builds": {"psi_fwd.cu": [
        ("      cch.put(&cop, nullptr);", "      if (k0 == 0) cch.put(&cop, nullptr);"),
        ("        cch.load(z, zeta, s_ij, q, k0 + kTcQChunk);", "")]},
    "bwd without reductions": {"psi_bwd.cu": [
        ("      tc_chunked_reductions(", "      if (q < 0) tc_chunked_reductions(")]},
    "bwd without products": {"psi_bwd.cu": [
        ("    tc_tile<kTcKChunk>(sm.fix.hi", "    if (q < 0) tc_tile<kTcKChunk>(sm.fix.hi"),
        ("    tc_reduce_split<N2>(a, sm.b2[wg]", "    if (pe < 0) tc_reduce_split<N2>(a, sm.b2[wg]")]},
    "bwd without chunk builds": {"psi_bwd.cu": [
        ("    put_fix(k0, sm.fix);\n    put_walk(k0, sm.walk);",
         "    if (k0 == 0) {\n      put_fix(k0, sm.fix);\n      put_walk(k0, sm.walk);\n    }"),
        ("    if (k0 + kTcQChunk < q) {  // the next chunk's loads",
         "    if (q < 0) {  // the next chunk's loads"),
        ("    put(kd, sm.b2);", "    if (kd == pq) put(kd, sm.b2);"),
        ("    if (kd + kTcQChunk < pe) load(kd + kTcQChunk);", "")]},
    "bwd without float64 adds": {"psi_bwd.cu": [
        ("    tc_in_turn([&] { tc_add_chunk(", "    if (pe < 0) tc_in_turn([&] { tc_add_chunk(")]},
}
SHAPE = (100_000, 256, 100, 128)


def build(work, variants=VARIANTS):
    """{variant: ctypes library}, every variant's sources compiled at once."""
    from gparml_tpu_torch.ops import _build

    nvcc, procs = _build._nvcc(), []
    for i, (name, subs) in enumerate(variants.items()):
        d = work / f"v{i}"
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(ROOT / "gparml_tpu_torch" / "csrc", d)
        for src, pairs in subs.items():
            text = (d / src).read_text()
            for old, new in pairs:
                if old not in text:
                    raise SystemExit(f"{name}: {old!r} not in {src}")
                text = text.replace(old, new)
            (d / src).write_text(text)
        for src in ("psi_fwd", "psi_bwd"):
            procs.append(subprocess.Popen(
                [nvcc, *_build.NVCC_FLAGS, "-c", "-o", str(d / f"{src}.o"), str(d / f"{src}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for p in procs:
        out = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"nvcc failed:\n{out[-3000:]}")
    libs = {}
    for i, name in enumerate(variants):
        d = work / f"v{i}"
        subprocess.run([nvcc, "-shared", "-o", str(d / "lib.so"), str(d / "psi_fwd.o"),
                        str(d / "psi_bwd.o")], check=True)
        lib = ctypes.CDLL(str(d / "lib.so"))
        for fn, argtypes in _build._ENTRY_POINTS.items():
            f = getattr(lib, fn)
            f.argtypes, f.restype = argtypes, ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gparml_tpu_torch.ops import _build, psi_cuda

    if not torch.cuda.is_available():
        print("chunked_ablation: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    libs = build(ROOT / "build" / "chunked_ablation")
    dev = torch.device("cuda", 0)
    n, m, q, d = SHAPE
    g = torch.Generator(dev).manual_seed(0)
    xs = (torch.randn(n, q, generator=g, device=dev),
          0.3 + 0.5 * torch.rand(n, q, generator=g, device=dev),
          torch.randn(m, q, generator=g, device=dev), torch.tensor(1.3, device=dev),
          torch.full((q,), 44.0 / q, device=dev), torch.randn(n, d, generator=g, device=dev),
          torch.ones(n, device=dev))
    cot = (torch.randn(m, d, generator=g, device=dev), torch.randn(m, m, generator=g, device=dev))
    for name in VARIANTS:
        _build.load = lambda lib=libs[name]: lib
        psi_cuda._plan_for.cache_clear()
        out = psi_cuda.psi_fwd(*xs)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                psi_cuda.psi_fwd(*xs)
                psi_cuda.psi_bwd(*xs, *out, *cot)
            torch.cuda.synchronize()
        ms = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA and "tc_chunked" in e.name:
                k = e.name.split("(")[0].replace("gparml::", "")
                ms[k] = ms.get(k, 0.0) + e.time_range.elapsed_us() / 2e3
        print(f"{name:<30} " + "  ".join(f"{k} {v:.2f}" for k, v in sorted(ms.items())),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
