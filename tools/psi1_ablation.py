#!/usr/bin/env python3
"""What sets the pace of the Psi1 backward passes, by ablation.

Each variant is a copy of gparml_tpu_torch/csrc with one piece of the Psi1
row pass or point pass taken out by a text substitution (the exponent
product, the dot y . dPsi1Y, the exp2 epilogue, the per-pair centred sums,
the dY product, the walked side's operand builds, the epilogue), built with nvcc into its own library under
build/psi1_ablation/ and timed, device ms per kernel from torch.profiler,
at the slice's shape (N=1e6, M=200, Q=10, D=12; random inputs). The
outputs of a variant are wrong by construction: only its time means
anything. Prints the card's name and power limit first.

Run from the repository root on a machine with an NVIDIA GPU:
    python3 tools/psi1_ablation.py [--ms 64 128 192 256]
"""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# variant -> {source: [(text, replacement), ...]}
VARIANTS = {
    "base": {},
    "rows without the exponent product": {"psi_bwd.cu": [
        ("      tc_tile<KP>(fix.hi + rw * KP, fix.lo + rw * KP, walk.hi, walk.lo, x);",
         "      if (q < 0) tc_tile<KP>(fix.hi + rw * KP, fix.lo + rw * KP, walk.hi, walk.lo, x);")]},
    "rows without the dot": {"psi_bwd.cu": [
        ("      tc_tile_chunk<kTcDChunk>(da.hi + rw * kTcDChunk,",
         "      if (q < 0) tc_tile_chunk<kTcDChunk>(da.hi + rw * kTcDChunk,")]},
    "rows without exp2": {"psi_bwd.cu": [
        ("      x[i] = p0 + tc_n(i) < m ? s_w[r] * tc_exp2(x[i] + s_rc[r]) : 0.f;",
         "      x[i] = p0 + tc_n(i) < m ? s_w[r] * (x[i] + s_rc[r]) : 0.f;")]},
    "rows without the per-pair sums": {"psi_bwd.cu": [
        ("      const int kb = j * kTcQChunk, ke = min(q, kb + kTcQChunk);",
         "      const int kb = j * kTcQChunk, ke = kb;")]},
    "rows without dY reductions": {"psi_bwd.cu": [
        ("        tc_reduce_split<kTcDChunk>(a, dt.hi, dt.lo, d2, scratch);\n        tc_add_cols<kTcDChunk>(d2, tot_w, ld, (j - y0) * kTcDChunk);",
         "        if (q < 0) tc_reduce_split<kTcDChunk>(a, dt.hi, dt.lo, d2, scratch);\n        if (q < 0) tc_add_cols<kTcDChunk>(d2, tot_w, ld, (j - y0) * kTcDChunk);")]},
    "rows without the points' builds": {"psi_bwd.cu": [
        ("    if (one_d) rl.put(rs, has_t ? &db : nullptr, in_y0 ? &dt : nullptr);\n    if constexpr (QM > 0) {\n      pl.template put<KP>(walk, has_t ? s_zt : nullptr);",
         "    if (one_d && pt == pt0) rl.put(rs, has_t ? &db : nullptr, in_y0 ? &dt : nullptr);\n    if constexpr (QM > 0) {\n      if (pt == pt0) pl.template put<KP>(walk, has_t ? s_zt : nullptr);")]},
    "rows without the epilogue": {"psi_bwd.cu": [
        ("  if (!has_t) return;\n  const int k0 = t0 * kTcQChunk,",
         "  if (q > 0) return;\n  const int k0 = t0 * kTcQChunk,")]},
    "m without the rows' builds": {"psi_bwd.cu": [
        ("      tc_build_rows<QM, KP, kTcRows, true>(st, alpha, zeta, logsf2, sh, q, walk, s_rc, nullptr,\n                                           s_cm);",
         "      if (t == 0) tc_build_rows<QM, KP, kTcRows, true>(st, alpha, zeta, logsf2, sh, q, walk, s_rc, nullptr,\n                                           s_cm);")]},
    "m without the per-pair sums": {"psi_bwd.cu": [
        ("        const int kb = c * kTcQChunk, ke = min(q, kb + kTcQChunk);",
         "        const int kb = c * kTcQChunk, ke = kb;")]},
}
SHAPE = (1_000_000, 200, 10, 12)


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ms", type=int, nargs="*", default=[],
                    help="also time the base variant at these M")
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gparml_tpu_torch.ops import _build, psi_cuda
    from tools.chunked_ablation import build

    if not torch.cuda.is_available():
        print("psi1_ablation: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    libs = build(ROOT / "build" / "psi1_ablation", VARIANTS)
    dev = torch.device("cuda", 0)
    n, m, q, d = SHAPE
    g = torch.Generator(dev).manual_seed(0)
    xs = (torch.randn(n, q, generator=g, device=dev),
          0.3 + 0.5 * torch.rand(n, q, generator=g, device=dev),
          torch.randn(m, q, generator=g, device=dev), torch.tensor(1.3, device=dev),
          torch.ones(q, device=dev), torch.randn(n, d, generator=g, device=dev),
          torch.ones(n, device=dev))
    cot = (torch.randn(m, d, generator=g, device=dev), torch.randn(m, m, generator=g, device=dev))
    runs = [(name, xs, cot) for name in VARIANTS]
    for mm in args.ms:   # the base variant at other M: per-block and per-tile costs
        gm = torch.Generator(dev).manual_seed(1)
        runs.append((f"base at M={mm}",
                     xs[:2] + (torch.randn(mm, q, generator=gm, device=dev),) + xs[3:],
                     (torch.randn(mm, d, generator=gm, device=dev),
                      torch.randn(mm, mm, generator=gm, device=dev))))
    for name, xs, cot in runs:
        _build.load = lambda lib=libs[name.split(" at M=")[0]]: lib
        psi_cuda._plan_for.cache_clear()
        out = psi_cuda.psi_fwd(*xs)
        psi_cuda.psi_bwd(*xs, *out, *cot)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                psi_cuda.psi_bwd(*xs, *out, *cot)
            torch.cuda.synchronize()
        ms = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA and "psi1_bwd" in e.name:
                k = e.name.split("(")[0].split("gparml::")[-1]
                ms[k] = ms.get(k, 0.0) + e.time_range.elapsed_us() / 3e3
        print(f"{name:<36} " + "  ".join(f"{k} {v:.3f}" for k, v in sorted(ms.items())),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
