#!/usr/bin/env python3
"""Drive the PyTorch port (gparml_tpu_torch) once on one NVIDIA GPU.

Phases, one line each or more:
  1. device: requires CUDA; prints the card's name and power limit
     (nvidia-smi --query-gpu=name,power.limit --format=csv,noheader);
  2. build: compiles the CUDA kernels from gparml_tpu_torch/csrc with nvcc
     (one process per source, all started together), prints ptxas's
     registers and spills, and counts the HGMMA instructions of every
     tensor-core Psi2 kernel (the Q <= 64 buckets and the K-chunked kernels
     past Q = 64) in the library's SASS (none fails);
  3. kernel parity: the forward and backward kernels against their plain
     PyTorch versions through a scalar probe objective, in float32 and
     against the plain version in float64, in the nq layout (mu, s (N, Q),
     Y (N, D)) and in the qn layout (mu^T, s^T (Q, N), Y^T (D, N)), also
     with the latents offset by +5 from the origin, and at Q = 100 with
     alpha unscaled, where every Psi2 entry is below float32's normal range;
  4. the GPLVM main path at N=1e6, Q=10, M=200, D=12, float32: kernel and
     plain-version times at that shape, neg_bound_value_and_grad with the
     kernels ("auto") and with the plain engine ("xla", block=4000), then a
     5-iteration SCG fit. Both float32 paths are also held against the
     plain engine in float64 on the same inputs, kernel by kernel and
     gradient leaf by gradient leaf;
  5. the (Q, N)-layout path, GPLVMConfig(layout='qn', y_layout='dn'):
     at N=1e5, M=500, Q=10, D=12 the qn kernels against their plain versions
     (also with every grid in one N-split) and the bound+gradient against
     the plain engine in float64, as in phase 4; then BASELINE config 5,
     N=1e7, M=500, Q=10, D=12: s/eval, a 2-iteration SCG fit, the qn path
     against the nq kernel path on the same inputs transposed, and the
     kernels' full-N outputs against their plain versions on the same
     inputs, run over 100 column slices and summed in float64 (the plain
     versions' times at N=1e7 are those slices' sums), and against the
     float64 sum of the kernels' own outputs over those slices;
  6. the partition-folder CLI in GPLVM mode (gparml_tpu_torch.cli.main, in
     this process, on folders of 4 partitions under build/): (a) BASELINE
     config 2 (oil-flow-like N=1000, D=12, Q=10, M=50, 300 SCG iterations)
     with its ARD precisions and 1-NN accuracy, then a resume with --load;
     (b) N=1e6, D=12, Q=10, M=100 with --trace-timing in both layouts, then
     Adam; (c) Q=100: N=1e5, D=128, M=256, and one bound+gradient at the
     fitted params held against the plain engine in float64. (b) and (c)
     time the kernel wrappers at their shapes (the windows of the TPU's
     `_fwd_kernel`, `_bwd_kernel` and `_bwd_kernel_stair`) against their
     plain versions; (c) also times the wrappers at Q = 256 beside their
     bounds.
Each phase that drives the main path sets the kernels' launch counts to 0
just before it and reads them just after (phase 6: each CLI run). The line before the last is the
kernel table as JSON; the last line is {"ok": true, "device": {...}}. A
failed check prints a "chip_smoke check failed" line, the run goes on to
its end for the readings, and then exits non-zero without those two lines.

Run from the repository root: python3 chip_smoke.py
"""

import contextlib
import functools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
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
# At the slice shapes both float32 paths sum 1e5..1e7 rows in different
# orders.
SLICE_TOL = 1e-3
# The kernels' float32 statistics against the plain version in float64,
# directly and through a float64 bound: sound kernels read <= 1.8e-6 at
# N=1e5..1e6, Q=10, and long float32 running sums 1.2e-5..4.4e-5. Past
# Q = 64 an exponent sums Q terms and the plain float32 engine itself reads
# more (2.5e-5 at Q=70, N=1e3 on the CPU), so there the kernels are held to
# the larger of F64_TOL and F64_FLOOR_FACTOR times the plain float32
# engine's own distance on the same inputs.
F64_TOL = 1e-5
F64_FLOOR_FACTOR = 2.0
# The qn path against the nq kernel path on the same inputs: the kernels
# sum in the same order in both layouts; the plain reductions around them
# (KL, sum y^2, dalpha's row sum) may not.
LAYOUT_TOL = 1e-6
# Full-N sums against the float64 sum of the kernels' outputs over 100
# short slices: sound kernels read <= 7.5e-8, splits of 5e6 rows 3.1e-6.
LONG_SUM_TOL = 1e-6

# Peak rates of one H100 SXM at its 700 W limit (NVIDIA's data sheet):
# float32 on the CUDA cores, and HBM bytes; dense TF32 on the tensor cores,
# and the MUFU's exp2 per clock per SM (the SM count and clock are read
# from the card).
F32_PEAK = 67e12
HBM_RATE = 3.35e12
TF32_PEAK = 495e12
MUFU_PER_CLOCK_SM = 16

# (N, M, Q, D, rows with zero weight): the flat-kernel shape of the JAX
# smoke, a weighted N=1000, the top of the TPU's flat window (M=512), a
# ragged shape with D > 16 (the backward's D chunking), and Q=44 (bucket 64),
# also at the H100's M limit there (908: Z fills the shared memory); then
# one case for each other Q bucket of csrc/psi_common.cuh: Q=2 (the
# default GPLVMConfig), Q=3 (bucket 4), Q=16 and Q=27 (bucket 32). Then the
# windows of the TPU's other kernels (`_fwd_kernel`, `_bwd_kernel_stair`,
# `_bwd_kernel`): the CLI's default (M=10, Q=2), the top of Ml=128
# (M=128), the JAX smoke's lane-chunked shape (M=640), the top of the
# staircase window (M=512, Q=44); and the chunked kernels (Q > 64), also
# at M=640 and Q=256. Last, for the tensor-core Psi2 exponent (centred on
# the mean of Z): the latents (mu and Z) offset by +5 at the slice's M, and
# bucket 64 at a small N with many cells. A sixth entry is that offset; a
# seventh, True, keeps alpha unscaled past Q = 64 (``parity_case``): at
# Q = 100 every Psi2 entry is then below float32's normal range, which the
# chunked kernels' exact shift of the exponents is for.
PARITY_CASES = (
    (64, 200, 10, 12, 0),
    (1000, 200, 10, 12, 300),
    (24, 512, 10, 12, 0),
    (37, 50, 10, 20, 0),
    (24, 256, 44, 4, 0),
    (16, 908, 44, 4, 0),
    (64, 40, 2, 3, 0),
    (50, 70, 3, 5, 10),
    (48, 100, 16, 12, 0),
    (40, 64, 27, 6, 0),
    (64, 10, 2, 3, 0),
    (64, 128, 10, 12, 0),
    (16, 640, 10, 12, 0),
    (24, 512, 44, 4, 0),
    (24, 100, 65, 8, 0),
    (24, 256, 100, 16, 5),
    (16, 640, 100, 12, 0),
    (16, 300, 256, 8, 0),
    (1000, 200, 10, 12, 0, 5.0),
    (64, 512, 64, 12, 0),
    (24, 256, 100, 16, 5, 0.0, True),
)
LAYOUTS = ("nq", "qn")
# (N, Q, M, D) of phase 4's slice (BASELINE config 4), of phase 5's check
# shape (JAX bench's m500_n1e5_sec; with the plain engine's N-block) and of
# BASELINE config 5.
SLICE = (1_000_000, 10, 200, 12)
QN_CHECK = (100_000, 10, 500, 12, 1000)
CONFIG5 = (10_000_000, 10, 500, 12)
# Phase 6, the CLI: BASELINE config 2 (N, D, Q, M, SCG iterations, resumed
# iterations); N=1e6 at M=100 (N, D, Q, M, SCG iterations, Adam steps, the
# plain engine's N-block); Q > 64 (N, D, Q, M, SCG iterations, N-block).
CONFIG2 = (1000, 12, 10, 50, 300, 20)
CLI_LARGE = (1_000_000, 12, 10, 100, 5, 20, 4000)
CLI_WIDE_Q = (100_000, 128, 100, 256, 3, 1000)
# The chunked kernels' widest timed shape (N, M, Q, D).
WIDEST_Q = (100_000, 256, 256, 128)
CLI_PARTITIONS = 4
GRAD_NAMES = ("mu", "s", "z", "sf2", "alpha", "y")

FAILURES = []


def _require(ok, what) -> None:
    """Record a failed check (a check that survives ``python -O``, unlike
    assert); main() exits non-zero at the end if any failed."""
    if not ok:
        FAILURES.append(what)
        print(f"chip_smoke check failed: {what}", flush=True)


def _norm_err(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _wrappers(layout):
    """(fwd, bwd, fused, fwd_reference, bwd_reference) of a layout."""
    from gparml_tpu_torch.ops import psi_cuda as pc

    if layout == "nq":
        return (pc.psi_fwd, pc.psi_bwd, pc.psi_fused, pc.psi_fused_fwd_reference,
                pc.psi_fused_bwd_reference)
    return (pc.psi_fwd_t, pc.psi_bwd_t, pc.psi_fused_t,
            pc.psi_fused_t_fwd_reference, pc.psi_fused_t_bwd_reference)


def parity_case(n, m, q, d, nzero, offset=0.0, raw_alpha=False, device="cuda", layout="nq"):
    """Kernel vs plain version on one shape in one layout, the latents (mu
    and Z) shifted by ``offset``, alpha unscaled past Q = 64 with
    ``raw_alpha``; returns a dict of errors and fails the run past the
    tolerances."""
    import torch

    _, _, fused, fwd_ref, _ = _wrappers(layout)
    rng = np.random.default_rng(m + n)
    host = dict(
        mu=rng.standard_normal((n, q)) + offset, s=0.3 + 0.5 * rng.random((n, q)),
        z=rng.standard_normal((m, q)) + offset, sf2=np.asarray(1.3),
        alpha=0.5 + rng.random(q), y=rng.standard_normal((n, d)),
    )
    if q > 64 and not raw_alpha:
        # exponents of Q terms: scaled to Q=44's range, past which every
        # Psi2 entry would underflow float32's normal range
        host["alpha"] *= 44.0 / q
    if layout == "qn":
        host.update({k: np.ascontiguousarray(host[k].T) for k in ("mu", "s", "y")})
    w = np.r_[np.ones(n - nzero), np.zeros(nzero)]
    wy = rng.standard_normal((m, d))
    wp = rng.standard_normal((m, m))

    def run(dtype, kernels):
        t = lambda a: torch.tensor(a, dtype=dtype, device=device)
        xs = [t(host[k]).requires_grad_(True) for k in GRAD_NAMES]
        p1y, p2 = (fused if kernels else fwd_ref)(*xs, t(w))
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
    _require(not bad, f"parity {layout} N={n} M={m} Q={q} D={d} offset={offset} "
             f"raw_alpha={raw_alpha}: {bad} {out}")
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


def _max_abs(a, b):
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def _ptxas(log):
    """{kernel: (registers, spill-store bytes)} of the Q-bucket-10
    instantiations, of the tensor-core Psi2 kernels' bucket 64 and of the
    chunked kernels (Q > 64), from nvcc's -Xptxas -v output."""
    out, name, spill = {}, None, 0
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            mangled, spill = ln.split("'")[1], 0
            rest = mangled.split("gparml", 1)[1]
            digits = rest[:len(rest) - len(rest.lstrip("0123456789"))]
            ident = rest[len(digits):len(digits) + int(digits)]
            name = (ident + ("<64>" if "ILi64E" in mangled else "")
                    if "ILi10E" in mangled or "chunked" in ident
                    or ("_tc_" in ident and "ILi64E" in mangled) else None)
        elif name and "spill stores" in ln:
            spill = int(ln.split("bytes spill stores")[0].split(",")[-1])
        elif name and "Used" in ln and "registers" in ln:
            out[name] = (int(ln.split("Used")[1].split()[0]), spill)
            name = None
    return out


def _hgmma_counts(lib_path):
    """{tensor-core kernel instantiation: HGMMA instructions in its SASS}
    from ``cuobjdump -sass`` of the built library (every ``*_tc_kernel``)."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    counts, name = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            mangled = ln.split("Function :")[1].strip()
            rest = mangled.split("gparml", 1)[-1]
            digits = rest[:len(rest) - len(rest.lstrip("0123456789"))]
            ident = rest[len(digits):len(digits) + int(digits)] if digits else mangled
            qm = mangled.split("ILi", 1)[1].split("E", 1)[0] if "ILi" in mangled else ""
            name = (f"{ident}<{qm}>" if qm else ident) if "_tc_" in ident else None
            if name:
                counts[name] = 0
        elif name and "HGMMA" in ln:
            counts[name] += 1
    return counts


@functools.lru_cache(maxsize=1)
def _mufu_rate():
    """exp2 a second on the card's MUFU: 16 a clock per SM x SMs x the
    card's maximum SM clock (nvidia-smi clocks.max.sm)."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    return MUFU_PER_CLOCK_SM * sms * mhz * 1e6


def _globals(kind, q):
    """The ``__global__`` kernels a forward or backward wrapper call
    launches at latent width q (csrc/psi_{fwd,bwd}.cu)."""
    if q > 64:
        names = (("psi2_fwd_tc_chunked_kernel", "psi1y_fwd_chunked_kernel") if kind == "fwd" else
                 ("psi2_bwd_rows_tc_chunked_kernel", "psi1_bwd_rows_chunked_kernel",
                  "psi2_bwd_cells_tc_chunked_kernel", "psi1_bwd_m_chunked_kernel"))
        return list(names)
    qm = next(b for b in (2, 4, 10, 16, 32, 64) if q <= b)
    names = (("psi2_fwd_tc_kernel", "psi1y_fwd_kernel") if kind == "fwd" else
             ("psi2_bwd_rows_tc_kernel", "psi1_bwd_rows_kernel", "psi2_bwd_cells_tc_kernel",
              "psi1_bwd_m_kernel"))
    return [f"{k}<{qm}>" for k in names]


def _set_bounds(entry, kind, n, m, q, d):
    """A kernel-table entry's bounds: ``bound_ms`` / ``bound_by``, the FP32
    direct form (``_bound``), and, since the Psi2 exponents come from the
    tensor cores at every Q, ``bound_tc_ms`` / ``bound_tc_by``
    (``_bound_tc``); and ``globals``, the kernels the call launches."""
    entry["bound_ms"], entry["bound_by"] = _bound(kind, n, m, q, d)
    entry["bound_tc_ms"], entry["bound_tc_by"] = _bound_tc(kind, n, m, q, d, _mufu_rate())
    entry["globals"] = _globals(kind, q)


def _entry_text(k):
    """A kernel-table entry's times and bounds, for the phase lines."""
    tc = (f", tensor-core form {k['bound_tc_ms']:.2f} ms by {k['bound_tc_by']}"
          if "bound_tc_ms" in k else "")
    return (f"{k['name']} {k['ms']:.2f} ms (plain {k['plain_ms']:.2f} ms, bound "
            f"{k['bound_ms']:.2f} ms{tc})")


def _bound_tc(kind, n, m, q, d, mufu_rate):
    """(bound ms, what bounds it) of a wrapper call whose Psi2 work runs on
    the tensor cores: the largest of the pairs' exp (Psi2 and Psi1)
    on the MUFU; the TF32 products at the tensor cores' rate, 2 FLOP a
    multiply-add, each counted once: the Psi2 exponent (K = 2Q) and, in the
    backward, the row sums [zb' | zb'^2 | 1] (2Q + 1) and the cell sums
    [c mu' | c] (2Q); the float32 operations left on the CUDA cores: a
    pair's two constant adds and the weighting (forward: w e added, 3;
    backward: g = K w e and w e, 3), and the Psi1 part as ``_work`` counts
    it less its exp; and the bytes."""
    _, nbytes = _work(kind, n, m, q, d)
    pairs2, pairs1 = n * (m * (m + 1) // 2), n * m
    k_sum = 2 * q if kind == "fwd" else 2 * q + (2 * q + 1) + 2 * q
    psi1_ops = (4 * q + 3 + 2 * d) if kind == "fwd" else (10 * q + 5 + 4 * d)
    times = {
        "exp (MUFU)": (pairs2 + pairs1) / mufu_rate,
        "TF32 products": 2 * k_sum * pairs2 / TF32_PEAK,
        "float32 operations": (5 * pairs2 + psi1_ops * pairs1) / F32_PEAK,
        "bytes": nbytes / HBM_RATE,
    }
    by = max(times, key=times.get)
    return times[by] * 1e3, by


def _work(kind, n, m, q, d):
    """(float32 operations, bytes) of one forward ('fwd') or backward
    ('bwd') wrapper call: the operations the function needs per (row, cell)
    and per (row, inducing point) pair, each computed once (an expf as one
    operation, an FMA as two), and each input read and each output written
    once."""
    cells = m * (m + 1) // 2
    if kind == "fwd":
        # Psi2: per q a difference, a product, an FMA; then two adds, the
        # exp and the weighted FMA: 4Q + 5. Psi1^T Y: 4Q + 4 + 2D.
        ops = n * (cells * (4 * q + 5) + m * (4 * q + 4 + 2 * d))
        elems = n * (2 * q + d + 1) + (m * q + q + 1) + (m * d + m * m)
    else:
        # Psi2: the exponent once, 4Q + 4 (as in the forward, times w);
        # g = K w e and G += g, 2; t_q += g d_q, u_q += g d_q^2, 4Q; the
        # centred cell sum A_q += w e (c_q d_q), one FMA on the exponent's
        # product, 2Q: 10Q + 6. Psi1: the exponent 4Q + 4, y . dPsi1Y_m and
        # dY += p dPsi1Y_m 4D, h and H 2, T and U 4Q, B 2Q: 10Q + 6 + 4D.
        ops = n * (cells * (10 * q + 6) + m * (10 * q + 6 + 4 * d))
        elems = (n * (2 * q + d + 1) + (m * q + q + 1) + 2 * (m * d + m * m)
                 + n * (2 * q + d) + (m * q + q + 1))
    return ops, 4 * elems


def _bound(kind, n, m, q, d):
    """(bound ms, what bounds it): the larger of the operations over the
    card's float32 peak and the bytes over its memory rate."""
    ops, nbytes = _work(kind, n, m, q, d)
    t_ops, t_bytes = ops / F32_PEAK * 1e3, nbytes / HBM_RATE * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


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
    f = -bound_ops.bound_from_stats(st, z, sf2, alpha, beta, d=gplvm._d_of(y, config),
                                    jitter=config.jitter)
    return f.detach(), torch.autograd.grad(f, list(p.parameters()))


@contextlib.contextmanager
def partial_budget(nbytes):
    """The kernels' ``psi_cuda.PARTIAL_BYTES`` set to ``nbytes`` (None:
    unchanged; 1: every grid in one N-split, however long)."""
    from gparml_tpu_torch.ops import psi_cuda

    saved = psi_cuda.PARTIAL_BYTES
    psi_cuda.PARTIAL_BYTES = saved if nbytes is None else nbytes
    try:
        yield
    finally:
        psi_cuda.PARTIAL_BYTES = saved


def _kernels_vs_plain(label, layout, fwd_in, cot, block, one_split=False):
    """The layout's kernel wrappers against their plain versions on one
    input: float32 vs float32 and both against the plain float64 version
    (``_f64_tol``); with ``one_split`` the kernels also run with every grid
    in one N-split. Returns (forward outputs, forward and backward max abs
    error vs plain f32, a printable summary) of the default plan."""
    fwd, bwd, _, fwd_ref, bwd_ref = _wrappers(layout)
    q = fwd_in[2].shape[1]
    fwd_r = fwd_ref(*fwd_in, block=block)
    bwd_r = bwd_ref(*fwd_in, *cot, block=block)
    in64 = [t.double() for t in fwd_in]
    fwd_64 = fwd_ref(*in64, block=block)
    bwd_64 = bwd_ref(*in64, *(t.double() for t in cot), block=block)
    del in64
    texts, out = [], None
    for plan, nbytes in (("default plan", None), ("one split a grid", 1))[:1 + one_split]:
        with partial_budget(nbytes):
            fwd_k = fwd(*fwd_in)
            bwd_k = bwd(*fwd_in, *fwd_k, *cot)
        fwd_err, bwd_err = _max_rel(fwd_k, fwd_r), _max_rel(bwd_k, bwd_r)
        _require(fwd_err <= SLICE_TOL and bwd_err <= SLICE_TOL,
                 f"{label} ({plan}) kernels vs plain: fwd {fwd_err}, bwd {bwd_err}")
        err64 = {"fwd": (_max_rel(fwd_k, fwd_64), _max_rel(fwd_r, fwd_64)),
                 "bwd": (_max_rel(bwd_k, bwd_64), _max_rel(bwd_r, bwd_64))}
        _require(all(e[0] <= _f64_tol(e[1], q) for e in err64.values()),
                 f"{label} ({plan}) kernels vs plain float64: {err64}")
        texts.append(f"{plan}: " + "; ".join(
            f"{k} max rel err {e:.2e}; vs plain f64: kernel {e64[0]:.2e}, plain f32 "
            f"{e64[1]:.2e}" for k, e, e64 in zip(
                ("fwd", "bwd"), (fwd_err, bwd_err), (err64["fwd"], err64["bwd"]))))
        if out is None:
            out = fwd_k, (_max_abs(fwd_k, fwd_r), _max_abs(bwd_k, bwd_r))
        del bwd_k
    return (*out, " | ".join(texts))


def _f64_tol(plain_err, q):
    """The kernels' float64 tolerance at latent width q, given the plain
    float32 version's own distance ``plain_err`` on the same inputs."""
    return max(F64_TOL, F64_FLOOR_FACTOR * plain_err) if q > 64 else F64_TOL


def _hold_against_plain(label, p, y, cfg, cfg_x, f_k, g_k, f_x, g_x):
    """Hold the kernel path's (-bound, gradient) (f_k, g_k) against the
    plain engine's float32 (f_x, g_x), and the kernels' float32 statistics
    through a float64 bound against the plain engine in float64, per leaf
    (``_f64_tol``); print both and the full float32 paths' distance from
    float64."""
    from gparml_tpu_torch.models import gplvm, params as P

    p64 = P.from_leaves([t.double() for t in P.leaves(p)])
    f_64, g_64 = gplvm.neg_bound_value_and_grad(p64, y.double(), cfg_x)
    del p64
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
    rel_g = max(vs_plain.values())
    _require(rel_f <= SLICE_TOL and rel_g <= SLICE_TOL,
             f"{label} bound/grad vs plain engine: {rel_f}, {vs_plain}")
    kb, xb = vs64["kernels+f64 bound"], vs64["plain f32+f64 bound"]
    key = "kernels+f64 bound"
    _require(bound_err[key] <= _f64_tol(bound_err["plain f32+f64 bound"], cfg.q)
             and all(kb[nm] <= _f64_tol(xb[nm], cfg.q) for nm in kb),
             f"{label} kernels' statistics with a float64 bound vs float64: "
             f"{bound_err}, {vs64}")
    print(f"{label} gradient per leaf, kernels vs plain f32 (norm-scaled): "
          + ", ".join(f"{k} {v:.2e}" for k, v in vs_plain.items()))
    for k, errs in vs64.items():
        print(f"{label} vs plain f64, {k}: bound rel {bound_err[k]:.2e}; "
              "gradient " + ", ".join(f"{nm} {v:.2e}" for nm, v in errs.items()))
    return rel_f, rel_g


def _kernel_inputs(p, y, cfg, native=False):
    """Detached (mu, s, z, sf2, alpha, y, w) of params ``p`` as the kernels
    take them (``native``: the qn storage layout)."""
    import torch
    from gparml_tpu_torch.models import params as P

    with torch.no_grad():
        z, sf2, alpha, _ = P.constrain(p.glob, cfg.bijector)
        mu, s = P.constrain_latents(p.lat, cfg.bijector, cfg.layout, native=native)
        xs = [t.detach().contiguous() for t in (mu, s, z, sf2, alpha, y)]
    n = mu.shape[1] if native else mu.shape[0]
    return (*xs, torch.ones(n, dtype=y.dtype, device=y.device))


def _cotangents(m, d, dev):
    import torch

    gen = torch.Generator(dev).manual_seed(1)
    return (torch.randn((m, d), generator=gen, device=dev),
            torch.randn((m, m), generator=gen, device=dev))


def phase4(dev, kernels):
    """The nq slice at N=1e6, Q=10, M=200, D=12."""
    import torch
    from gparml_tpu_torch import data
    from gparml_tpu_torch.models import gplvm, params as P
    from gparml_tpu_torch.ops import psi_cuda

    n, q, m, d = SLICE
    block = 4000 if n % 4000 == 0 else None
    t0 = time.perf_counter()
    y_np, _ = data.oil_flow_like(n=n, d=d)
    y = torch.tensor(y_np, dtype=torch.float32, device=dev)
    cfg = gplvm.GPLVMConfig(q=q, num_inducing=m, stats_impl="auto")
    p = gplvm.init_params(torch.Generator(dev).manual_seed(0), y, cfg)
    torch.cuda.synchronize()
    print(f"phase 4 data+init: {time.perf_counter() - t0:.2f} s")

    # kernels vs plain versions at the slice shape (launches here are not
    # counted as the main path's)
    fwd_in = _kernel_inputs(p, y, cfg)
    cot = _cotangents(m, d, dev)
    fwd_k, abs_err, text = _kernels_vs_plain("phase 4 slice-shape", "nq", fwd_in, cot, block)
    entries = [
        {"name": "psi_fwd", "route": "cuda",
         "source": "gparml_tpu_torch/csrc/psi_fwd.cu",
         "replaces": "gparml_tpu/ops/psi_pallas.py:634",
         "max_abs_err": abs_err[0],
         "ms": _cuda_ms(lambda: psi_cuda.psi_fwd(*fwd_in), 5),
         "plain_ms": _cuda_ms(lambda: psi_cuda.psi_fused_fwd_reference(*fwd_in, block=block), 2)},
        {"name": "psi_bwd", "route": "cuda",
         "source": "gparml_tpu_torch/csrc/psi_bwd.cu",
         "replaces": "gparml_tpu/ops/psi_pallas.py:794",
         "max_abs_err": abs_err[1],
         "ms": _cuda_ms(lambda: psi_cuda.psi_bwd(*fwd_in, *fwd_k, *cot), 3),
         "plain_ms": _cuda_ms(lambda: psi_cuda.psi_fused_bwd_reference(*fwd_in, *cot, block=block), 1)},
    ]
    for k, kind in zip(entries, ("fwd", "bwd")):
        _set_bounds(k, kind, n, m, q, d)
        k["library_ms"] = None   # no single PyTorch call computes Psi1^T Y or sum Psi2
    del fwd_k, fwd_in
    print("phase 4 kernels at the slice shape: "
          + "; ".join(map(_entry_text, entries)) + "; " + text)

    # the main path: bound+gradient evaluations and a 5-iteration SCG fit
    psi_cuda.LAUNCHES.update(fwd=0, bwd=0)
    torch.cuda.reset_peak_memory_stats()
    sec_k, (f_k, g_k) = _eval_seconds(gplvm, p, y, cfg)
    t0 = time.perf_counter()
    res = gplvm.fit(p, y, cfg, iters=5)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {k: psi_cuda.LAUNCHES[k] for k in ("fwd", "bwd")}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for k in entries:
        k["launches"] = launches[k["name"][4:]]
    bound = res.trace["bound"][:5]
    _require(np.all(np.isfinite(bound)), f"phase 4 fit bound not finite: {bound}")
    _require(np.all(np.diff(bound) >= 0), f"phase 4 fit bound decreased: {bound}")
    _require(launches["fwd"] > 0 and launches["bwd"] > 0,
             f"phase 4 main path skipped a kernel: {launches}")

    cfg_x = gplvm.GPLVMConfig(q=q, num_inducing=m, stats_impl="xla", block=block)
    sec_x, (f_x, g_x) = _eval_seconds(gplvm, p, y, cfg_x)
    rel_f, rel_g = _hold_against_plain("phase 4 slice", p, y, cfg, cfg_x, f_k, g_k, f_x, g_x)
    torch.cuda.synchronize()
    print(f"phase 4 slice N={n} Q={q} M={m} D={d} f32: kernels {sec_k:.4f} s/eval, "
          f"plain engine {sec_x:.4f} s/eval; bound vs plain rel {rel_f:.2e}, "
          f"grad norm-scaled {rel_g:.2e}; fit 5 iters {fit_s:.2f} s, "
          f"{res.n_evals} evals, bound {bound[0]:.6g} -> {bound[-1]:.6g}; "
          f"launches {launches}; peak {peak_gb:.2f} GB")
    kernels.extend(entries)


def _qn_data(n, d, dev):
    """oil_flow_like(n, d) as a float32 (D, N) tensor on the card."""
    import torch
    from gparml_tpu_torch import data

    y_np, _ = data.oil_flow_like(n=n, d=d)
    return torch.tensor(np.ascontiguousarray(y_np.T, dtype=np.float32), device=dev)


def phase5_small(dev):
    """qn at N=1e5, M=500, Q=10, D=12: the kernels against their plain
    versions (with the default plan and with every grid in one N-split),
    and the bound+gradient against the plain engine in float64."""
    import torch
    from gparml_tpu_torch.models import gplvm

    n, q, m, d, block = QN_CHECK
    y_t = _qn_data(n, d, dev)
    cfg = gplvm.GPLVMConfig(q=q, num_inducing=m, layout="qn", y_layout="dn",
                            stats_impl="auto")
    cfg_x = gplvm.GPLVMConfig(q=q, num_inducing=m, layout="qn", y_layout="dn",
                              stats_impl="xla", block=block)
    p = gplvm.init_params(torch.Generator(dev).manual_seed(0), y_t, cfg)
    fwd_in = _kernel_inputs(p, y_t, cfg, native=True)
    cot = _cotangents(m, d, dev)
    _, _, text = _kernels_vs_plain("phase 5 N=1e5", "qn", fwd_in, cot, block,
                                   one_split=True)
    del fwd_in
    print(f"phase 5 N={n} M={m} Q={q} D={d} qn kernels: {text}")

    f_k, g_k = gplvm.neg_bound_value_and_grad(p, y_t, cfg)
    f_x, g_x = gplvm.neg_bound_value_and_grad(p, y_t, cfg_x)
    rel_f, rel_g = _hold_against_plain(f"phase 5 N={n} qn", p, y_t, cfg, cfg_x,
                                       f_k, g_k, f_x, g_x)
    print(f"phase 5 N={n} qn bound+gradient: vs plain f32 bound rel {rel_f:.2e}, "
          f"grad norm-scaled {rel_g:.2e}")


# Outputs of psi_fwd_t then psi_bwd_t, and those summed over N.
_OUTPUTS = ("psi1_y", "psi2", "dmu", "ds", "dz", "dsf2", "dalpha", "dy")
_SUMMED = ("psi1_y", "psi2", "dz", "dsf2", "dalpha")


def _full_n_checks(fwd_in, cot, full, block, slices=100):
    """The full-N kernel outputs ``full`` ({name: tensor}) against two
    references built over ``slices`` column slices of the same inputs: the
    plain versions (float32, N-block ``block``) and the kernels themselves,
    the N-summed outputs of each slice summed in float64 and the per-row
    outputs compared slice by slice. Returns ({output: (max abs error vs
    the plain versions, max|plain|)}, {N-summed output: error of max|ref|
    vs the kernels' slices}, (plain forward ms, plain backward ms) over the
    slices, the backward's including its forward as psi_fused_t_bwd_reference
    does)."""
    import torch
    from gparml_tpu_torch.ops import psi_cuda

    mu_t, s_t, z, sf2, alpha, y_t, w = fwd_in
    n = mu_t.shape[1]
    step = n // slices
    vs_plain = {k: (0.0, 0.0) for k in _OUTPUTS}
    plain_sum, kern_sum = {}, {}
    ms = [0.0, 0.0]
    for i in range(0, n, step):
        cols = [t[:, i:i + step].contiguous() for t in (mu_t, s_t, y_t)]
        part = (cols[0], cols[1], z, sf2, alpha, cols[2], w[i:i + step].contiguous())
        xs = [t.detach().requires_grad_(True) for t in part[:6]]
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        with torch.enable_grad():
            ev[0].record()
            out = psi_cuda.psi_fused_t_fwd_reference(*xs, part[6], block=block)
            ev[1].record()
            grads = torch.autograd.grad(out, xs, grad_outputs=cot)
            ev[2].record()
        ev[2].synchronize()
        ms[0] += ev[0].elapsed_time(ev[1])
        ms[1] += ev[0].elapsed_time(ev[2])
        plain = dict(zip(_OUTPUTS, (*(t.detach() for t in out), *grads)))
        p1y, p2 = psi_cuda.psi_fwd_t(*part)
        kern = dict(zip(_OUTPUTS, (p1y, p2, *psi_cuda.psi_bwd_t(*part, p1y, p2, *cot))))
        for k in _OUTPUTS:
            if k in _SUMMED:
                plain_sum[k] = plain_sum.get(k, 0) + plain[k].double()
                kern_sum[k] = kern_sum.get(k, 0) + kern[k].double()
            else:
                err, ref = vs_plain[k]
                vs_plain[k] = (max(err, float((full[k][:, i:i + step] - plain[k]).abs().max())),
                               max(ref, float(plain[k].abs().max())))
        del xs, out, grads, plain, kern
    for k in _SUMMED:
        vs_plain[k] = (float((full[k].double() - plain_sum[k]).abs().max()),
                       float(plain_sum[k].abs().max()))
    long_sums = {k: float((full[k].double() - kern_sum[k]).abs().max()
                          / kern_sum[k].abs().max()) for k in _SUMMED}
    return vs_plain, long_sums, tuple(ms)


def _layout_errors(p, y_t, cfg, out_qn):
    """The qn path against the nq kernel path on the same inputs,
    transposed: the statistics (and whether the kernels' two are bitwise
    equal) and the bound+gradient, given the qn path's (-bound, gradient)
    ``out_qn``. Returns ({name: max rel err}, bitwise)."""
    import torch
    from gparml_tpu_torch.models import gplvm, params as P

    cfg_nq = gplvm.GPLVMConfig(q=cfg.q, num_inducing=cfg.num_inducing, stats_impl="auto")
    lv = P.leaves(p)
    p_nq = P.from_leaves(lv[:4] + [t.T.contiguous() for t in lv[4:]])
    y_nd = y_t.T.contiguous()
    with torch.no_grad():
        st_qn = gplvm.suff_stats(p, y_t, cfg)
        st_nq = gplvm.suff_stats(p_nq, y_nd, cfg_nq)
    bitwise = all(torch.equal(a, b) for a, b in zip(st_qn[1:3], st_nq[1:3]))
    errs = {f"stats.{k}": _max_rel([a], [b]) for k, a, b in zip(st_qn._fields, st_qn, st_nq)}
    del st_qn, st_nq
    f_nq, g_nq = gplvm.neg_bound_value_and_grad(p_nq, y_nd, cfg_nq)
    f_qn, g_qn = out_qn
    errs["bound"] = abs(float(f_qn) - float(f_nq)) / abs(float(f_nq))
    for (name, _), a, b in zip(p.named_parameters(), g_qn, g_nq):
        errs[name] = _max_rel([a], [b.T if name.startswith("lat.") else b])
    return errs, bitwise


def phase5_config5(dev, kernels):
    """BASELINE config 5 in qn/dn: N=1e7, M=500, Q=10, D=12, float32."""
    import torch
    from gparml_tpu_torch.models import gplvm
    from gparml_tpu_torch.ops import psi_cuda

    n, q, m, d = CONFIG5
    block = QN_CHECK[4]
    t0 = time.perf_counter()
    y_t = _qn_data(n, d, dev)
    cfg = gplvm.GPLVMConfig(q=q, num_inducing=m, layout="qn", y_layout="dn",
                            stats_impl="auto")
    p = gplvm.init_params(torch.Generator(dev).manual_seed(0), y_t, cfg)
    torch.cuda.synchronize()
    print(f"phase 5 config 5 data+init: {time.perf_counter() - t0:.2f} s")

    # the main path: bound+gradient evaluations and a 2-iteration SCG fit
    psi_cuda.LAUNCHES.update(fwd_t=0, bwd_t=0)
    torch.cuda.reset_peak_memory_stats()
    sec, out = _eval_seconds(gplvm, p, y_t, cfg, reps=2)
    t0 = time.perf_counter()
    res = gplvm.fit(p, y_t, cfg, iters=2)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {k: psi_cuda.LAUNCHES[k] for k in ("fwd_t", "bwd_t")}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    bound = res.trace["bound"][:2]
    _require(np.all(np.isfinite(bound)), f"phase 5 fit bound not finite: {bound}")
    _require(np.all(np.diff(bound) >= 0) and bound[0] >= -float(out[0]),
             f"phase 5 fit bound decreased: {-float(out[0])} -> {bound}")
    _require(launches["fwd_t"] > 0 and launches["bwd_t"] > 0,
             f"phase 5 main path skipped a kernel: {launches}")
    print(f"phase 5 config 5 N={n} Q={q} M={m} D={d} qn/dn f32: {sec:.4f} s/eval; "
          f"fit 2 iters {fit_s:.2f} s, {res.n_evals} evals, bound "
          f"{-float(out[0]):.6g} -> {bound[-1]:.6g}; launches {launches}; "
          f"peak {peak_gb:.2f} GB")
    del res

    # the qn path against the nq kernel path on the same inputs
    errs, bitwise = _layout_errors(p, y_t, cfg, out)
    _require(max(errs.values()) <= LAYOUT_TOL, f"phase 5 qn vs nq kernel path: {errs}")
    print(f"phase 5 config 5 qn vs nq kernel path (max rel): kernels' statistics "
          f"bitwise equal: {bitwise}; " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    del out

    # the kernels at config 5 against their plain versions on the same inputs
    fwd_in = _kernel_inputs(p, y_t, cfg, native=True)
    cot = _cotangents(m, d, dev)
    full_fwd = psi_cuda.psi_fwd_t(*fwd_in)
    full = dict(zip(_OUTPUTS, (*full_fwd, *psi_cuda.psi_bwd_t(*fwd_in, *full_fwd, *cot))))
    t0 = time.perf_counter()
    vs_plain, sums, plain_ms = _full_n_checks(fwd_in, cot, full, block)
    rel = {k: e / max(r, 1e-30) for k, (e, r) in vs_plain.items()}
    _require(max(rel.values()) <= SLICE_TOL, f"phase 5 config 5 kernels vs plain: {rel}")
    _require(max(sums.values()) <= LONG_SUM_TOL, f"phase 5 long sums at N={n}: {sums}")
    print(f"phase 5 config 5 kernels vs plain versions over 100 slices "
          f"({time.perf_counter() - t0:.2f} s; max abs err of max|plain|): "
          + ", ".join(f"{k} {v:.2e}" for k, v in rel.items()))
    print("phase 5 config 5 full-N sums vs float64 sum of the kernels over 100 "
          "slices (of max|ref|): " + ", ".join(f"{k} {v:.2e}" for k, v in sums.items()))
    del full
    for name, kind, fn, reps, names, pms in (
            ("psi_fwd_t", "fwd", lambda: psi_cuda.psi_fwd_t(*fwd_in), 2,
             _OUTPUTS[:2], plain_ms[0]),
            ("psi_bwd_t", "bwd", lambda: psi_cuda.psi_bwd_t(*fwd_in, *full_fwd, *cot), 1,
             _OUTPUTS[2:], plain_ms[1])):
        entry = {"name": name, "route": "cuda",
                 "source": f"gparml_tpu_torch/csrc/psi_{kind}.cu",
                 "replaces": "gparml_tpu/ops/psi_pallas.py:" + ("671" if kind == "fwd" else "820"),
                 "launches": launches[kind + "_t"],
                 "max_abs_err": max(vs_plain[k][0] for k in names),
                 "ms": _cuda_ms(fn, reps), "plain_ms": pms}
        _set_bounds(entry, kind, n, m, q, d)
        entry["library_ms"] = None   # no single PyTorch call computes Psi1^T Y or sum Psi2
        kernels.append(entry)
    print("phase 5 config 5 kernels: " + "; ".join(map(_entry_text, kernels[-2:])))


def _window_times(case, dev):
    """Card and plain-version times of the nq wrappers on a phase 3 case:
    at these small N they read launch overhead."""
    import torch

    n, m, q, d = case[:4]
    gen = torch.Generator(dev).manual_seed(n + m)
    r = lambda *shape: torch.randn(*shape, generator=gen, device=dev)
    xs = (r(n, q), 0.3 + 0.5 * torch.rand(n, q, generator=gen, device=dev), r(m, q),
          torch.tensor(1.3, device=dev), torch.full((q,), min(1.0, 10.0 / q), device=dev),
          r(n, d), torch.ones(n, device=dev))
    fwd, bwd, _, fwd_ref, bwd_ref = _wrappers("nq")
    out = fwd(*xs)
    cot = _cotangents(m, d, dev)
    return (_cuda_ms(lambda: fwd(*xs), 20), _cuda_ms(lambda: bwd(*xs, *out, *cot), 20),
            _cuda_ms(lambda: fwd_ref(*xs), 3), _cuda_ms(lambda: bwd_ref(*xs, *cot), 3))


def _cli_run(argv):
    """gparml_tpu_torch.cli.main(argv) with the kernels' launch counts set to
    0 just before and read just after: (summary, launches, seconds)."""
    import torch
    from gparml_tpu_torch import cli
    from gparml_tpu_torch.ops import psi_cuda

    psi_cuda.LAUNCHES.update({k: 0 for k in psi_cuda.LAUNCHES})
    t0 = time.perf_counter()
    summary = cli.main([str(a) for a in argv])
    torch.cuda.synchronize()
    return summary, dict(psi_cuda.LAUNCHES), time.perf_counter() - t0


def _history(stats):
    with open(os.path.join(stats, "bound_history.jsonl")) as f:
        return [json.loads(line) for line in f]


def _checkpoint_params(stats, dev):
    """The params of a CLI run's checkpoint.npz, on the card."""
    from gparml_tpu_torch.models import params as P

    with np.load(os.path.join(stats, "checkpoint.npz")) as f:
        arrays = P.GPLVMArrays(
            P.GlobalArrays(*(f[f"glob/{k}"] for k in P.GlobalArrays._fields)),
            P.LatentArrays(*(f[f"lat/{k}"] for k in P.LatentArrays._fields)))
    return P.from_numpy(arrays, device=dev)


def _knn_accuracy(x, labels):
    """1-NN classification accuracy (examples/gplvm_oil_flow.py)."""
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    return float((labels[d2.argmin(1)] == labels).mean())


def _kernel_entries(label, fwd_in, cot, block, shape, launches, replaces):
    """Table entries of the nq forward and backward wrappers at ``shape``
    (N, M, Q, D): held against their plain versions (``_kernels_vs_plain``)
    and timed beside them; ``replaces`` names the TPU kernels of the window."""
    from gparml_tpu_torch.ops import psi_cuda

    n, m, q, d = shape
    fwd_k, abs_err, text = _kernels_vs_plain(label, "nq", fwd_in, cot, block)
    entries = []
    for kind, err, fn, ref, reps in (
            ("fwd", abs_err[0], lambda: psi_cuda.psi_fwd(*fwd_in),
             lambda: psi_cuda.psi_fused_fwd_reference(*fwd_in, block=block), 5),
            ("bwd", abs_err[1], lambda: psi_cuda.psi_bwd(*fwd_in, *fwd_k, *cot),
             lambda: psi_cuda.psi_fused_bwd_reference(*fwd_in, *cot, block=block), 3)):
        name, line = replaces[kind]
        entry = {"name": name, "route": "cuda",
                 "source": f"gparml_tpu_torch/csrc/psi_{kind}.cu",
                 "replaces": f"gparml_tpu/ops/psi_pallas.py:{line}",
                 "launches": launches[kind], "max_abs_err": err,
                 "ms": _cuda_ms(fn, reps), "plain_ms": _cuda_ms(ref, 1)}
        _set_bounds(entry, kind, n, m, q, d)
        entry["library_ms"] = None   # no single PyTorch call computes Psi1^T Y or sum Psi2
        entries.append(entry)
    print(f"{label} kernels: " + "; ".join(map(_entry_text, entries)) + "; " + text)
    return entries


def _write_inputs(folder, y_np):
    from gparml_tpu_torch import data

    data.save_partitioned(os.path.join(folder, "inputs"), y_np, CLI_PARTITIONS, prefix="Y")
    return os.path.join(folder, "inputs")


def phase6_config2(dev, work):
    """BASELINE config 2 through the CLI, then a resume from its folders."""
    import torch
    from gparml_tpu_torch import data
    from gparml_tpu_torch.models import gplvm

    n, d, q, m, iters, more = CONFIG2
    y_np, labels = data.oil_flow_like(n=n, d=d, seed=0)
    folder = os.path.join(work, "config2")
    stats, emb = os.path.join(folder, "st"), os.path.join(folder, "emb")
    base = ["-i", _write_inputs(folder, y_np), "-e", emb, "-s", stats,
            "-q", q, "-m", m, "--seed", 0, "--device", dev.type]
    s1, l1, sec1 = _cli_run(base + ["-T", iters, "--trace-timing"])
    rows = _history(stats)
    hist = [r["bound"] for r in rows]
    per_eval = sum(r["wall_s"] for r in rows) / max(s1["n_evals"] - 1, 1)
    _require(l1["fwd"] > 0 and l1["bwd"] > 0, f"phase 6 config 2 skipped a kernel: {l1}")
    _require(np.all(np.isfinite(hist)) and np.all(np.diff(hist) >= 0),
             f"phase 6 config 2 bound not finite or decreasing: {hist[:3]}...{hist[-3:]}")
    with np.load(os.path.join(stats, "checkpoint.npz")) as f:
        alpha = np.exp(f["glob/u_alpha"])
    mu, _ = data.load_embeddings(emb)
    top = np.argsort(alpha)[::-1][:2]
    acc = _knn_accuracy(mu[:, top], labels)
    tail = abs(hist[-1] - hist[-11]) / abs(hist[-1]) if len(hist) > 10 else float("nan")
    print(f"phase 6 config 2 N={n} D={d} Q={q} M={m} -T {iters}: {sec1:.2f} s, bound "
          f"{hist[0]:.1f} -> {hist[-1]:.1f} ({s1['n_evals']} evaluations, {len(hist)} "
          f"iterations; last 10 changed it by {tail:.2e}; {per_eval * 1e3:.3f} ms/eval "
          f"from the wall column); ARD precisions (sorted): "
          f"{np.array2string(np.sort(alpha)[::-1], precision=4)}; effective latent dims "
          f"(alpha > 1% of max): {int((alpha > 0.01 * alpha.max()).sum())}; 1-NN accuracy "
          f"in top-2 latent dims: {acc:.3f} (chance ~0.33); launches {l1}")

    # the resume starts from the saved state: its bound, evaluated here
    p = _checkpoint_params(stats, dev)
    y = torch.tensor(y_np, dtype=torch.float32, device=dev)
    f0 = float(gplvm.log_bound(p, y, gplvm.GPLVMConfig(q=q, num_inducing=m)).detach())
    s2, l2, sec2 = _cli_run(base + ["-T", more, "--load"])
    rel = abs(f0 - s1["final_bound"]) / abs(s1["final_bound"])
    _require(rel <= 1e-5, f"phase 6 config 2 checkpoint bound {f0} vs saved {s1['final_bound']}")
    _require(s2["final_bound"] >= f0, f"phase 6 resume ended below its start: {f0} -> {s2}")
    _require(l2["fwd"] > 0 and l2["bwd"] > 0, f"phase 6 resume skipped a kernel: {l2}")
    print(f"phase 6 config 2 resume --load -T {more}: {sec2:.2f} s, starts at {f0:.6g} "
          f"(saved {s1['final_bound']:.6g}, rel {rel:.2e}), ends at {s2['final_bound']:.6g} "
          f"({s2['n_evals']} evaluations); launches {l2}")


def phase6_large(dev, work, kernels):
    """N=1e6, M=100 (the TPU's Ml=128 window) through the CLI in both
    layouts with --trace-timing, then Adam; the kernels timed there."""
    import torch
    from gparml_tpu_torch import data
    from gparml_tpu_torch.models import gplvm

    n, d, q, m, iters, steps, block = CLI_LARGE
    y_np, _ = data.oil_flow_like(n=n, d=d, seed=0)
    folder = os.path.join(work, "large")
    inputs = _write_inputs(folder, y_np)
    runs = {}
    for layout, extra in (("nq", ["-T", iters, "--trace-timing"]),
                          ("qn", ["-T", iters, "--trace-timing", "--layout", "qn"]),
                          ("adam", ["-T", steps, "--optimizer", "adam"])):
        stats = os.path.join(folder, f"st_{layout}")
        torch.cuda.reset_peak_memory_stats()
        s, launches, sec = _cli_run(["-i", inputs, "-e", os.path.join(folder, f"emb_{layout}"),
                                     "-s", stats, "-q", q, "-m", m, "--device", dev.type,
                                     *extra])
        peak = torch.cuda.max_memory_allocated() / 1e9
        keys = ("fwd_t", "bwd_t") if layout == "qn" else ("fwd", "bwd")
        _require(all(launches[k] > 0 for k in keys),
                 f"phase 6 N={n} {layout} skipped a kernel: {launches}")
        _require(math.isfinite(s["final_bound"]), f"phase 6 N={n} {layout}: {s}")
        hist = _history(stats)
        wall = sum(r.get("wall_s", 0.0) for r in hist)
        per_eval = (f"{wall / max(s['n_evals'] - 1, 1):.4f} s/eval from the wall column"
                    if layout != "adam" else f"{sec / s['n_evals']:.4f} s/eval (run / evals)")
        print(f"phase 6 N={n} D={d} Q={q} M={m} {layout}: {sec:.2f} s, bound "
              f"{hist[0]['bound']:.6g} -> {s['final_bound']:.6g}, {s['n_evals']} "
              f"evaluations, {per_eval}; peak {peak:.2f} GB; launches {launches}")
        runs[layout] = launches
    p = _checkpoint_params(os.path.join(folder, "st_nq"), dev)
    y = torch.tensor(y_np, dtype=torch.float32, device=dev)
    fwd_in = _kernel_inputs(p, y, gplvm.GPLVMConfig(q=q, num_inducing=m))
    kernels.extend(_kernel_entries(
        f"phase 6 N={n} M={m} Q={q}", fwd_in, _cotangents(m, d, dev), block, (n, m, q, d),
        runs["nq"], {"fwd": ("psi_fwd_ml128", 225), "bwd": ("psi_bwd_ml128", 249)}))


def phase6_wide_q(dev, work, kernels):
    """Q=100 (the chunked kernels; the TPU's staircase window) through the
    CLI, then one bound+gradient at the fitted params against the plain
    engine in float64, and the kernels timed there."""
    import torch
    from gparml_tpu_torch import data
    from gparml_tpu_torch.models import gplvm

    n, d, q, m, iters, block = CLI_WIDE_Q
    y_np, _ = data.oil_flow_like(n=n, d=d, seed=0)
    folder = os.path.join(work, "wide_q")
    stats = os.path.join(folder, "st")
    s, launches, sec = _cli_run(["-i", _write_inputs(folder, y_np), "-e",
                                 os.path.join(folder, "emb"), "-s", stats,
                                 "-q", q, "-m", m, "-T", iters, "--device", dev.type])
    _require(launches["fwd"] > 0 and launches["bwd"] > 0,
             f"phase 6 Q={q} skipped a kernel: {launches}")
    hist = _history(stats)
    print(f"phase 6 N={n} D={d} Q={q} M={m}: {sec:.2f} s, bound {hist[0]['bound']:.6g} -> "
          f"{s['final_bound']:.6g}, {s['n_evals']} evaluations; launches {launches}")
    p = _checkpoint_params(stats, dev)
    y = torch.tensor(y_np, dtype=torch.float32, device=dev)
    cfg = gplvm.GPLVMConfig(q=q, num_inducing=m)
    cfg_x = gplvm.GPLVMConfig(q=q, num_inducing=m, stats_impl="xla", block=block)
    f_k, g_k = gplvm.neg_bound_value_and_grad(p, y, cfg)
    f_x, g_x = gplvm.neg_bound_value_and_grad(p, y, cfg_x)
    _hold_against_plain(f"phase 6 Q={q}", p, y, cfg, cfg_x, f_k, g_k, f_x, g_x)
    fwd_in = _kernel_inputs(p, y, cfg)
    kernels.extend(_kernel_entries(
        f"phase 6 N={n} M={m} Q={q}", fwd_in, _cotangents(m, d, dev), block, (n, m, q, d),
        launches, {"fwd": ("psi_fwd_chunked", 225), "bwd": ("psi_bwd_chunked", 409)}))
    del fwd_in
    _widest_q_times(dev)


def _widest_q_times(dev):
    """The wrappers' times at WIDEST_Q (the dimensions in two passes in the
    backward), on random inputs, beside both bounds."""
    import torch
    from gparml_tpu_torch.ops import psi_cuda

    n, m, q, d = WIDEST_Q
    gen = torch.Generator(dev).manual_seed(q)
    xs = (torch.randn(n, q, generator=gen, device=dev),
          0.3 + 0.5 * torch.rand(n, q, generator=gen, device=dev),
          torch.randn(m, q, generator=gen, device=dev), torch.tensor(1.3, device=dev),
          torch.full((q,), 44.0 / q, device=dev), torch.randn(n, d, generator=gen, device=dev),
          torch.ones(n, device=dev))
    out = psi_cuda.psi_fwd(*xs)
    cot = _cotangents(m, d, dev)
    texts = []
    for kind, fn, reps in (("fwd", lambda: psi_cuda.psi_fwd(*xs), 3),
                           ("bwd", lambda: psi_cuda.psi_bwd(*xs, *out, *cot), 2)):
        entry = {"ms": _cuda_ms(fn, reps)}
        _set_bounds(entry, kind, n, m, q, d)
        texts.append(f"psi_{kind} {entry['ms']:.2f} ms (bound {entry['bound_ms']:.2f} ms by "
                     f"{entry['bound_by']}, tensor-core form {entry['bound_tc_ms']:.2f} ms by "
                     f"{entry['bound_tc_by']})")
    _require(all(bool(torch.isfinite(t).all()) for t in out), f"phase 6 Q={q} outputs not finite")
    print(f"phase 6 widest Q, N={n} M={m} Q={q} D={d}: " + "; ".join(texts))


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
    from gparml_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load()
    print(f"phase 2 build: {time.perf_counter() - t0:.2f} s (nvcc "
          f"{_build.last_build_seconds:.2f} s); ptxas at Q=10, the tensor-core kernels "
          f"at Q=64, and Q > 64: " + ", ".join(
              f"{k} {r} regs {sp} B spilled" for k, (r, sp) in _ptxas(
                  (_build.library_path().parent / "nvcc.log").read_text()).items()))
    hgmma = _hgmma_counts(_build.library_path())
    _require(len(hgmma) == 21 and min(hgmma.values()) > 0,
             f"phase 2: a tensor-core kernel has no HGMMA in its SASS: {hgmma}")
    print("phase 2 HGMMA instructions in the SASS: " + ", ".join(
        f"{k} {v}" for k, v in sorted(hgmma.items())))

    # phase 3: kernel parity, both layouts
    t0 = time.perf_counter()
    for case in PARITY_CASES:
        for layout in LAYOUTS:
            res = parity_case(*case, layout=layout)
            print(f"phase 3 parity {layout} N={case[0]} M={case[1]} Q={case[2]} "
                  f"D={case[3]} zero-w={case[4]}{' raw alpha' if case[6:] else ''}: "
                  + " ".join(f"{k}={v:.2e}" for k, v in res.items()))
    for case in [c for c in PARITY_CASES[10:] if not c[6:]]:
        print("phase 3 times nq N={} M={} Q={} D={}: fwd {:.3f} ms, bwd {:.3f} ms; plain "
              "fwd {:.3f} ms, bwd {:.3f} ms".format(*case[:4], *_window_times(case, dev)))
    print(f"phase 3: {time.perf_counter() - t0:.2f} s")

    kernels = []
    t0 = time.perf_counter()
    phase4(dev, kernels)
    print(f"phase 4: {time.perf_counter() - t0:.2f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase5_small(dev)
    torch.cuda.empty_cache()
    phase5_config5(dev, kernels)
    print(f"phase 5: {time.perf_counter() - t0:.2f} s")

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_cli_", dir=os.path.join(ROOT, "build"))
    try:
        phase6_config2(dev, work)
        phase6_large(dev, work, kernels)
        torch.cuda.empty_cache()
        phase6_wide_q(dev, work, kernels)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"phase 6: {time.perf_counter() - t0:.2f} s")

    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} checks failed", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
