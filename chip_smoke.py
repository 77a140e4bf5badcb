#!/usr/bin/env python3
"""Drive the PyTorch port (gparml_tpu_torch) once on one NVIDIA GPU.

Phases, one line each:
  1. device: requires CUDA; prints the card's name and power limit
     (nvidia-smi --query-gpu=name,power.limit --format=csv,noheader);
  2. build: compiles the CUDA kernels from gparml_tpu_torch/csrc with nvcc;
  3. kernel parity: the forward and backward kernels against their plain
     PyTorch versions through a scalar probe objective, in float32 and
     against the plain version in float64;
  4. the GPLVM main path at N=1e6, Q=10, M=200, D=12, float32: kernel and
     plain-version times at that shape, neg_bound_value_and_grad with the
     kernels ("auto") and with the plain engine ("xla", block=4000), then a
     5-iteration SCG fit. Both float32 paths are also held against the
     plain engine in float64 on the same inputs, kernel by kernel and
     gradient leaf by gradient leaf.
The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}. Any failure raises and exits non-zero.

Run from the repository root: python3 chip_smoke.py
"""

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# Hardware-smoke tolerances of the JAX package (tests/tpu_smoke_runner.py):
# value rtol 2e-4 and per-leaf gradient max-abs error <= 1e-3 of max|ref|
# against the float32 plain version; the reference measured its own kernels
# 1.7e-4 (norm-scaled) from float64, so 2e-4 against the float64 plain
# version.
VALUE_RTOL = 2e-4
GRAD_TOL_F32 = 1e-3
GRAD_TOL_F64 = 2e-4
# At the slice shape both float32 paths sum 1e6 rows in different orders.
SLICE_TOL = 1e-3

# (N, M, Q, D, rows with zero weight): the flat-kernel shape of the JAX
# smoke, a weighted N=1000, the top of the TPU's flat window (M=512), a
# ragged shape with D > 16 (the backward's D chunking), and Q=44 (bucket 64);
# then one case for each other Q bucket of csrc/psi_common.cuh: Q=2 (the
# default GPLVMConfig), Q=3 (bucket 4), Q=16 and Q=27 (bucket 32).
PARITY_CASES = (
    (64, 200, 10, 12, 0),
    (1000, 200, 10, 12, 300),
    (24, 512, 10, 12, 0),
    (37, 50, 10, 20, 0),
    (24, 256, 44, 4, 0),
    (64, 40, 2, 3, 0),
    (50, 70, 3, 5, 10),
    (48, 100, 16, 12, 0),
    (40, 64, 27, 6, 0),
)
GRAD_NAMES = ("mu", "s", "z", "sf2", "alpha", "y")


def _require(ok, what) -> None:
    """Fail the run (a check that survives ``python -O``, unlike assert)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def _norm_err(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def parity_case(n, m, q, d, nzero, device="cuda"):
    """Kernel vs plain version on one shape; returns a dict of errors and
    raises past the tolerances."""
    import torch
    from gparml_tpu_torch.ops import psi_cuda

    rng = np.random.default_rng(m + n)
    host = dict(
        mu=rng.standard_normal((n, q)), s=0.3 + 0.5 * rng.random((n, q)),
        z=rng.standard_normal((m, q)), sf2=np.asarray(1.3),
        alpha=0.5 + rng.random(q), y=rng.standard_normal((n, d)),
    )
    w = np.r_[np.ones(n - nzero), np.zeros(nzero)]
    wy = rng.standard_normal((m, d))
    wp = rng.standard_normal((m, m))

    def run(dtype, fused):
        t = lambda a: torch.tensor(a, dtype=dtype, device=device)
        xs = [t(host[k]).requires_grad_(True) for k in GRAD_NAMES]
        if fused:
            p1y, p2 = psi_cuda.psi_fused(*xs, t(w))
        else:
            p1y, p2 = psi_cuda.psi_fused_fwd_reference(*xs, t(w))
        f = torch.sum(p1y * t(wy)) * 1e-2 + torch.sum(p2 * t(wp)) * 1e-3
        grads = torch.autograd.grad(f, xs)
        return float(f.detach()), [g.double().cpu().numpy() for g in grads]

    fk, gk = run(torch.float32, True)
    fr, gr = run(torch.float32, False)
    f64, g64 = run(torch.float64, False)
    out = {"value_rel": abs(fk - fr) / abs(fr), "value_rel_f64": abs(fk - f64) / abs(f64)}
    for name, a, b, c in zip(GRAD_NAMES, gk, gr, g64):
        out[f"d{name}"] = float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))
        out[f"d{name}_f64"] = _norm_err(a, c)
    bad = [k for k, v in out.items() if not math.isfinite(v)]
    bad += [k for k in ("value_rel",) if out[k] > VALUE_RTOL]
    bad += [f"d{k}" for k in GRAD_NAMES if out[f"d{k}"] > GRAD_TOL_F32]
    bad += [f"d{k}_f64" for k in GRAD_NAMES if out[f"d{k}_f64"] > GRAD_TOL_F64]
    _require(not bad, f"parity N={n} M={m} Q={q} D={d}: {bad} {out}")
    return out


def _cuda_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _max_rel(a, b):
    return max(float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)
               for x, y in zip(a, b))


def _ptxas_q10(log):
    """{kernel: (registers, spill-store bytes)} of the Q-bucket-10
    instantiations, from nvcc's -Xptxas -v output."""
    out, name, spill = {}, None, 0
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            mangled, spill = ln.split("'")[1], 0
            name = mangled.split("gparml")[1].lstrip("0123456789").split("I")[0] \
                if "ILi10E" in mangled else None
        elif name and "spill stores" in ln:
            spill = int(ln.split("bytes spill stores")[0].split(",")[-1])
        elif name and "Used" in ln and "registers" in ln:
            out[name] = (int(ln.split("Used")[1].split()[0]), spill)
            name = None
    return out


def _eval_seconds(gplvm, p, y, config, reps=4):
    """min wall seconds of neg_bound_value_and_grad after one warm-up."""
    import torch

    out = gplvm.neg_bound_value_and_grad(p, y, config)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gplvm.neg_bound_value_and_grad(p, y, config)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return min(times), out


def _neg_bound_f64_bound(p, y, config):
    """(-bound, gradient leaves) with the statistics from ``config``'s engine
    at the params' dtype and the bound computed in float64 from them."""
    import torch
    from gparml_tpu_torch.models import gplvm, params as P
    from gparml_tpu_torch.ops import bound as bound_ops

    z, sf2, alpha, beta = (t.double() for t in P.constrain(p.glob, config.bijector))
    st = gplvm.suff_stats(p, y, config)
    st = type(st)(*(t.double() for t in st))
    f = -bound_ops.bound_from_stats(st, z, sf2, alpha, beta, d=y.shape[1],
                                    jitter=config.jitter)
    return f.detach(), torch.autograd.grad(f, list(p.parameters()))


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "gparml_tpu_torch")):
        print("chip_smoke: gparml_tpu_torch/ not found beside the script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import torch

    # phase 1: device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    kind = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(f"phase 1 device: {kind} x{torch.cuda.device_count()}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}; tf32 off")

    # phase 2: build
    from gparml_tpu_torch.ops import _build, psi_cuda

    t0 = time.perf_counter()
    _build.load()
    print(f"phase 2 build: {time.perf_counter() - t0:.2f} s (nvcc "
          f"{_build.last_build_seconds:.2f} s); ptxas at Q=10: " + ", ".join(
              f"{k} {r} regs {sp} B spilled" for k, (r, sp) in _ptxas_q10(
                  (_build.library_path().parent / "nvcc.log").read_text()).items()))

    # phase 3: kernel parity
    for case in PARITY_CASES:
        res = parity_case(*case)
        print(f"phase 3 parity N={case[0]} M={case[1]} Q={case[2]} D={case[3]} "
              f"zero-w={case[4]}: " + " ".join(f"{k}={v:.2e}" for k, v in res.items()))

    # phase 4: the slice at N=1e6, Q=10, M=200, D=12
    from gparml_tpu_torch import data
    from gparml_tpu_torch.models import gplvm, params as P

    n, q, m, d = 1_000_000, 10, 200, 12
    t0 = time.perf_counter()
    y_np, _ = data.oil_flow_like(n=n, d=d)
    y = torch.tensor(y_np, dtype=torch.float32, device=dev)
    cfg = gplvm.GPLVMConfig(q=q, num_inducing=m, stats_impl="auto")
    p = gplvm.init_params(torch.Generator(dev).manual_seed(0), y, cfg)
    torch.cuda.synchronize()
    print(f"phase 4 data+init: {time.perf_counter() - t0:.2f} s")

    # kernels vs plain versions at the slice shape (launches here are not
    # counted as the main path's)
    with torch.no_grad():
        z, sf2, alpha, _ = P.constrain(p.glob, cfg.bijector)
        mu, s = P.constrain_latents(p.lat, cfg.bijector)
        z, sf2, alpha, mu, s = (t.detach().contiguous() for t in (z, sf2, alpha, mu, s))
    w = torch.ones(n, dtype=torch.float32, device=dev)
    fwd_in = (mu, s, z, sf2, alpha, y, w)
    gen = torch.Generator(dev).manual_seed(1)
    cot = (torch.randn((m, d), generator=gen, device=dev),
           torch.randn((m, m), generator=gen, device=dev))
    fwd_k = psi_cuda.psi_fwd(*fwd_in)
    fwd_r = psi_cuda.psi_fused_fwd_reference(*fwd_in, block=4000)
    bwd_k = psi_cuda.psi_bwd(*fwd_in, *fwd_k, *cot)
    bwd_r = psi_cuda.psi_fused_bwd_reference(*fwd_in, *cot, block=4000)
    fwd_err, bwd_err = _max_rel(fwd_k, fwd_r), _max_rel(bwd_k, bwd_r)
    _require(fwd_err <= SLICE_TOL and bwd_err <= SLICE_TOL,
             f"slice-shape kernels vs plain: fwd {fwd_err}, bwd {bwd_err}")
    # both float32 sides against the plain version in float64
    in64 = [t.double() for t in fwd_in]
    fwd_64 = psi_cuda.psi_fused_fwd_reference(*in64, block=4000)
    bwd_64 = psi_cuda.psi_fused_bwd_reference(
        *in64, *(t.double() for t in cot), block=4000)
    err64 = {"fwd": (_max_rel(fwd_k, fwd_64), _max_rel(fwd_r, fwd_64)),
             "bwd": (_max_rel(bwd_k, bwd_64), _max_rel(bwd_r, bwd_64))}
    del in64, fwd_64, bwd_64
    _require(max(e[0] for e in err64.values()) <= SLICE_TOL,
             f"slice-shape kernels vs plain float64: {err64}")
    kernels = [
        {"name": "psi_fwd", "route": "cuda",
         "source": "gparml_tpu_torch/csrc/psi_fwd.cu",
         "replaces": "gparml_tpu/ops/psi_pallas.py:634",
         "max_abs_err": max(float((a - b).abs().max()) for a, b in zip(fwd_k, fwd_r)),
         "ms": _cuda_ms(lambda: psi_cuda.psi_fwd(*fwd_in), 5),
         "plain_ms": _cuda_ms(lambda: psi_cuda.psi_fused_fwd_reference(*fwd_in, block=4000), 2)},
        {"name": "psi_bwd", "route": "cuda",
         "source": "gparml_tpu_torch/csrc/psi_bwd.cu",
         "replaces": "gparml_tpu/ops/psi_pallas.py:794",
         "max_abs_err": max(float((a - b).abs().max()) for a, b in zip(bwd_k, bwd_r)),
         "ms": _cuda_ms(lambda: psi_cuda.psi_bwd(*fwd_in, *fwd_k, *cot), 3),
         "plain_ms": _cuda_ms(lambda: psi_cuda.psi_fused_bwd_reference(*fwd_in, *cot, block=4000), 1)},
    ]
    del fwd_k, fwd_r, bwd_k, bwd_r
    print("phase 4 kernels at the slice shape: " + "; ".join(
        f"{k['name']} {k['ms']:.2f} ms (plain {k['plain_ms']:.2f} ms), "
        f"max rel err {e:.2e}; vs plain f64: kernel {e64[0]:.2e}, plain f32 "
        f"{e64[1]:.2e}" for k, e, e64 in zip(
            kernels, (fwd_err, bwd_err), (err64["fwd"], err64["bwd"]))))

    # the main path: bound+gradient evaluations and a 5-iteration SCG fit
    psi_cuda.LAUNCHES.update(fwd=0, bwd=0)
    torch.cuda.reset_peak_memory_stats()
    sec_k, (f_k, g_k) = _eval_seconds(gplvm, p, y, cfg)
    t0 = time.perf_counter()
    res = gplvm.fit(p, y, cfg, iters=5)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = dict(psi_cuda.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for k in kernels:
        k["launches"] = launches[k["name"][4:]]
    bound = res.trace["bound"][:5]
    _require(np.all(np.isfinite(bound)), f"fit bound not finite: {bound}")
    _require(np.all(np.diff(bound) >= 0), f"fit bound decreased: {bound}")
    _require(launches["fwd"] > 0 and launches["bwd"] > 0,
             f"main path skipped a kernel: {launches}")

    cfg_x = gplvm.GPLVMConfig(q=q, num_inducing=m, stats_impl="xla", block=4000)
    sec_x, (f_x, g_x) = _eval_seconds(gplvm, p, y, cfg_x)
    # the same evaluation by the plain engine in float64: which float32 side
    # is off
    p64 = P.from_leaves([t.double() for t in P.leaves(p)])
    f_64, g_64 = gplvm.neg_bound_value_and_grad(p64, y.double(), cfg_x)
    del p64
    # the float32 statistics of each engine with the bound in float64: the
    # engines' own error, apart from the float32 bound's
    f_kb, g_kb = _neg_bound_f64_bound(p, y, cfg)
    f_xb, g_xb = _neg_bound_f64_bound(p, y, cfg_x)
    rel_f = abs(float(f_k) - float(f_x)) / abs(float(f_x))
    reads = {"kernels": (f_k, g_k), "plain f32": (f_x, g_x),
             "kernels+f64 bound": (f_kb, g_kb), "plain f32+f64 bound": (f_xb, g_xb)}
    bound_err = {k: abs(float(f) - float(f_64)) / abs(float(f_64))
                 for k, (f, _) in reads.items()}
    names = [k for k, _ in p.named_parameters()]
    vs64 = {k: {nm: _norm_err(a.double().cpu().numpy(), b.double().cpu().numpy())
                for nm, a, b in zip(names, g, g_64)} for k, (_, g) in reads.items()}
    vs_plain = {nm: _norm_err(a.double().cpu().numpy(), b.double().cpu().numpy())
                for nm, a, b in zip(names, g_k, g_x)}
    del g_64, g_kb, g_xb
    rel_g = max(vs_plain.values())
    _require(rel_f <= SLICE_TOL and rel_g <= SLICE_TOL,
             f"slice bound/grad vs plain engine: {rel_f}, {vs_plain}")
    kb = vs64["kernels+f64 bound"]
    _require(bound_err["kernels+f64 bound"] <= SLICE_TOL and max(kb.values()) <= SLICE_TOL,
             f"slice kernels' statistics with a float64 bound vs float64: "
             f"{bound_err}, {vs64}")
    torch.cuda.synchronize()
    print(f"phase 4 slice N={n} Q={q} M={m} D={d} f32: kernels {sec_k:.4f} s/eval, "
          f"plain engine {sec_x:.4f} s/eval; bound vs plain rel {rel_f:.2e}, "
          f"grad norm-scaled {rel_g:.2e}; fit 5 iters {fit_s:.2f} s, "
          f"{res.n_evals} evals, bound {bound[0]:.6g} -> {bound[-1]:.6g}; "
          f"launches {launches}; peak {peak_gb:.2f} GB")
    print("phase 4 slice gradient per leaf, kernels vs plain f32 (norm-scaled): "
          + ", ".join(f"{k} {v:.2e}" for k, v in vs_plain.items()))
    for k, errs in vs64.items():
        print(f"phase 4 slice vs plain f64, {k}: bound rel {bound_err[k]:.2e}; "
              "gradient " + ", ".join(f"{nm} {v:.2e}" for nm, v in errs.items()))

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
