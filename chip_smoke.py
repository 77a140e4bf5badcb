#!/usr/bin/env python3
"""Drive the PyTorch port (gparml_tpu_torch) once on one NVIDIA GPU.

Phases, one line each or more:
  1. device: requires CUDA; prints the card's name and power limit
     (nvidia-smi --query-gpu=name,power.limit --format=csv,noheader);
  2. build: compiles the CUDA kernels from gparml_tpu_torch/csrc with nvcc
     (one process per source, all started together), prints ptxas's
     registers and spills, requires the Psi2 forward, with and without the
     cell sums, to keep its launch bounds' blocks per SM at every Q bucket
     (the card's occupancy calculator, from its registers and shared
     memory), and
     counts the HGMMA instructions of every
     tensor-core kernel (Psi2's Q <= 64 buckets and K-chunked kernels past
     Q = 64, Psi1's Q <= 16 buckets and K-chunked instantiation past it) in
     the library's SASS (none fails);
  3. kernel parity: the forward and backward kernels against their plain
     PyTorch versions through a scalar probe objective, in float32 and
     against the plain version in float64, in the nq layout (mu, s (N, Q),
     Y (N, D)) and in the qn layout (mu^T, s^T (Q, N), Y^T (D, N)), also
     with the latents offset by +5 from the origin, and at Q = 100 with
     alpha unscaled, where every Psi2 entry is below float32's normal range;
     at M=1000, Q=44 (the Psi1 passes walk 16 tiles of points); and the
     flush case: the slice's shape at sf2 = 1e-20, every Psi2 entry below
     2^-126, Psi2 and the gradients of a Psi2 probe against the plain
     version in float64; then the device ms of the Psi2 forward sweep with
     the cell sums and without them, and of the backward's row pass, each
     beside its 3-term TF32 floor, at the slice's shape and at
     infer_latents' batch (N=1000) at every Q bucket and at config 5's (qn)
     up to Q = 16;
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
     bounds;
  7. prediction, latent inference and sparse GP regression: (a) the slice's
     GPLVM (N=1e6 rows and 1e4 more held out, drawn in one call), fitted
     for 5 SCG iterations, then predict_observed at 1e4 latent points,
     infer_latents on 1e3 held-out rows (20 SCG iterations; the kernels
     must launch, the bound must not decrease, and the first evaluation is
     held against the plain engine in float64 as phase 4 holds the bound)
     and reconstruct of those rows (held against the plain float64 route;
     RMSE under half the zero-mean baseline); (b) reconstruct at config 5
     (phase 5's parameters, 1e4 points; run right after phase 5), its
     first 1024 points against the float64 route on the same statistics;
     (c) SGPR: BASELINE config 1 through the CLI (--fixed-embeddings, 200
     SCG iterations, the learned noise std within 0.15-0.25, then a resume
     with --load) and the API at N=1e6, Q=1, M=200 in both layouts (one
     bound+gradient against float64, and 5 SCG iterations);
  8. the data-parallel statistics: (a) a mesh of 4 shards on the one card
     at the slice's shape, N=1e6 and N=1e6-3 (padded): the bound+gradient
     with the mesh against the unsharded kernel route (phase 4's
     tolerances), one forward and one backward kernel call per shard, the
     padded rows' latent gradients exactly 0, s/eval of both; (b) -p remote
     on two processes of the one card over gloo (python -m
     gparml_tpu_torch.cli with torchrun's variables): BASELINE config 2 (300
     SCG iterations, then --load -T 20) and the slice (5 SCG iterations,
     --trace-timing), each with its bound at -T 0 --load against -p local
     on the same checkpoint (rtol 1e-5), both ranks' globals equal bit for
     bit, both partition files and the backend; (c) BASELINE config 1 (SGPR)
     through -p remote, its noise std within 7(c)'s bounds. Rank 0's
     summary gives the mean time of the statistics' all_reduce;
  9. SVGP minibatch training (models/svgp.py: cuBLAS and cuSOLVER, no
     hand-written kernel): (a) the API at the JAX package's production
     shape, N=2e6, Q=4, D=3, M=100, batch 4096 (tools/svgp_bench.py's
     generator), 2000 Adam steps in nq, then in qn: steps/s, peak memory,
     qn's history against nq's, the final ELBO's estimator (4 batches), the
     learned noise std, the RMSE at 1e4 fresh points, one ELBO+gradient
     against float64 on the card, and 20 steps under
     torch.cuda.set_sync_debug_mode("error"); (b) a mesh of 4 shards on the
     card at N=2e6-3: elbo_sharded against elbo, and 500 steps against
     unsharded; (c) --optimizer svgp through the CLI on BASELINE config 1's
     folders in both layouts, then a resume; (d) the same under -p remote on
     two processes of the card, the ranks' glob, q_mu and q_sqrt bit for bit;
 10. the entry points (gparml_tpu_torch/graft_entry.py) and the examples
     (examples/torch/; ``--phases 0``): (a) entry(), one bound+gradient at
     N=2048, Q=10, M=64, D=12 on the card, one forward and one backward
     kernel call, held against the plain engine as phase 4 holds the slice;
     (b) dryrun_multichip(4) on a mesh of 4 shards of the card (a GPLVM SCG
     step, an SGPR SCG iteration, an SVGP step); (c) dryrun_multihost(2, 1),
     two CLI processes on the card over gloo; (d) large_scale_gplvm.py at
     the slice's shape (N=1e6, M=200), huge_n_single_chip.py at config 5's
     (N=1e7, M=500, one SCG iteration) and gplvm_oil_flow.py (config 2),
     each a subprocess whose exit code fails the run, and whose last line,
     its kernel launch counts, must show the kernels of its window.
Phases 4, 5 (config 5), 6(b), 6(c) and 7(a) (the statistics of
infer_latents' 1e3 rows) also print the device ms a call of every
``__global__`` the wrappers launch (torch.profiler; the kernel table's
``globals_ms``). The kernel table's times, bounds and ``globals`` are those
of the kernel calls a fit's evaluation makes (``_route``): up to Q = 64 the
forward that also forms the cell sums, and the backward given them; 7(a)'s
those of infer_latents (Z held: no kernel forms the cell sums).
Each phase that drives the main path sets the kernels' launch counts to 0
just before it and reads them just after (phase 6: each CLI run; phase 7:
each call; phase 8: the sharded evaluation, and each remote CLI run counts
its own, which rank 0's summary reports; phase 9: each fit and CLI run,
which launch none; phase 10: entry()'s evaluation and the multichip dry
run, and each example's process reports its own). The line before the
last is the kernel table as JSON (``launches_sharded``: phase 8(a)'s calls
in one sharded evaluation; ``launches_entry``: phase 10(a)'s in entry()'s;
``launches_examples``: phase 10(d)'s in the examples' processes); the
last line is {"ok": true, "device": {...}}. A
failed check prints a "chip_smoke check failed" line, the run goes on to
its end for the readings, and then exits non-zero without those two lines.

Run from the repository root: python3 chip_smoke.py
`--phases 3` (or any of the digits 3-9, and 0 for phase 10, e.g. `--phases
890`) runs phases 1 and 2 and those alone, each check as in the whole run; it prints which
checks failed and not the last two lines (phase 7(b) needs phase 5). The
short first call after a kernel change is `python3 chip_smoke.py --phases 3`.
"""

import argparse
import contextlib
import ctypes
import functools
import json
import math
import os
import re
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
# Predictions (mean, variance) in float32 against the same float32 form
# evaluated in float64 on the same statistics (``_float32_form``): max abs
# error of max|ref|.
PREDICT_TOL = SLICE_TOL

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
# also at M=908 (where Z once filled the shared memory of the direct-form
# Psi1 row pass); then
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
# chunked kernels' exact shift of the exponents is for. After them, Q=44
# past M=908, at M=1000: the Psi1 passes walk 16 tiles of inducing points.
# Last, an eighth entry spreads the latents (``spread_inputs``): std 3
# around the origin, each inducing point near a latent row, as a fit leaves
# them, where the expanded exponent's terms c mu' z' grow with the spread
# (Q = 48 and 64, Psi2's bucket 64, the largest of the Q <= 64 kernels).
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
    (40, 1000, 44, 12, 5),
    (400, 64, 48, 16, 0, 0.0, False, 3.0),
    (400, 64, 64, 16, 0, 0.0, False, 3.0),
)
LAYOUTS = ("nq", "qn")
# (N, M, Q, D, sf2) of the flush case: the slice's shape (phase 3's first
# case) with every Psi2 entry below 2^-126, where the kernels' exp2
# (ex2.approx.ftz) gives zero unless the exponent is shifted.
FLUSH_CASE = (1000, 200, 10, 12, 1e-20)
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
# Phase 7, prediction and inference. (a) the slice's GPLVM: (N, Q, M, D,
# SCG iterations of its fit, rows drawn past N and held out, latent points
# of predict_observed, held-out rows inferred, SCG iterations of
# infer_latents, the plain engine's N-block); (b) reconstruct at config 5
# from phase 5's parameters: (points, of which held against float64);
# (c) SGPR: BASELINE config 1 through the CLI (N, D, Q, M, SCG iterations,
# resumed iterations, bounds of the learned noise std; true 0.2), and the
# API at N=1e6 (N, Q, M, SCG iterations).
SERVE = (1_000_000, 10, 200, 12, 5, 10_000, 10_000, 1_000, 20, 4000)
RECON_C5 = (10_000, 1024)
SGPR_CLI = (1000, 1, 1, 10, 200, 20, (0.15, 0.25))
SGPR_API = (1_000_000, 1, 200, 5)
GRAD_NAMES = ("mu", "s", "z", "sf2", "alpha", "y")
# Phase 8, the data-parallel statistics. (a) a mesh of MESH_SHARDS shards
# on the one card at the slice's shape (N, Q, M, D), also at N - 3 so that
# padding runs; (b) -p remote on REMOTE_RANKS processes of a gloo group on
# the one card: BASELINE config 2 (CONFIG2) and the slice through the CLI
# (N, D, Q, M, SCG iterations), each process given REMOTE_TIMEOUT seconds;
# (c) BASELINE config 1 (SGPR_CLI) through -p remote.
MESH_SHARDS = 4
MESH_SLICE = SLICE
REMOTE_RANKS = 2
REMOTE_SLICE = (1_000_000, 12, 10, 200, 5)
REMOTE_TIMEOUT = 300
# Phase 9, SVGP at the JAX package's production shape (docs/DESIGN.md §6,
# tools/svgp_bench.py's generator, ``_svgp_data``): (N, Q, D, M, batch,
# Adam steps, learning rate). The learned noise std must fall within
# SVGP_NOISE (true 0.1) and the predictive mean's RMSE against tanh(x W) at
# SVGP_TEST_POINTS fresh points stay below SVGP_RMSE. Both were rehearsed on
# the CPU with the JAX package and the port at N=2e5, seeds 0-2
# (tools/svgp_rehearsal.py): the JAX package's noise std read 0.1175,
# 0.1330, 0.1066, so the bound 0.08-0.13 is widened to its seed-0 result
# plus the spread of the three (0.1175 + 0.0264); its RMSE read 0.033-0.083.
# qn's history must be within SVGP_QN_RTOL of nq's. One ELBO and gradient
# at a fixed window of `batch` rows at the initial parameters, float32 on
# the card, is held against float64 on the card within 2x the CPU's float32
# distance plus SVGP_F64_FLOOR (norm-scaled). The first SVGP_SYNC_STEPS steps run again under
# torch.cuda.set_sync_debug_mode("error"). (b) a mesh of MESH_SHARDS shards on
# the card at N - 3: elbo_sharded against elbo (SVGP_MESH_RTOL) and
# SVGP_MESH_STEPS sharded steps; (c) the CLI on BASELINE config 1's folders
# (SGPR_CLI's N, M and noise bounds): -T, then --load -T, with --batch-size
# and --learning-rate (SVGP_CLI), in both layouts, the resumed ELBO at most
# SVGP_RESUME_DROP below the first. The rate is the JAX package's CLI tests'
# 0.05: at the default 0.01, 600 steps leave the noise std at 0.3376 in the
# JAX CLI and 0.2908 in the port's (seed 0, tools/svgp_rehearsal.py --cli),
# outside 7(c)'s bounds; at 0.05 they read 0.2220-0.2244 and 0.2374.
# (d) -p remote on REMOTE_RANKS processes: -T, then --load -T (SVGP_REMOTE).
SVGP_API = (2_000_000, 4, 3, 100, 4096, 2000, 1e-2)
SVGP_NOISE = (0.08, 0.144)
SVGP_RMSE = 0.1
SVGP_TEST_POINTS = 10_000
SVGP_QN_RTOL = 1e-4
SVGP_F64_FLOOR = 1e-5
SVGP_SYNC_STEPS = 20
SVGP_MESH_RTOL = 1e-5
SVGP_MESH_STEPS = 500
SVGP_CLI = (600, 100, 256, 0.05)
SVGP_RESUME_DROP = 5.0
SVGP_REMOTE = (300, 100)
# Phase 10, the entry points of gparml_tpu_torch/graft_entry.py and the
# examples of examples/torch/: (a) entry() (N=2048, Q=10, M=64, D=12: the
# Ml=128 window); (b) dryrun_multichip on a mesh of GRAFT_SHARDS shards of
# the card; (c) dryrun_multihost with GRAFT_RANKS processes of one shard
# each on the card (each killed at REMOTE_TIMEOUT); (d) each example at its
# card shape as a subprocess, given EXAMPLE_TIMEOUT seconds: (script,
# arguments, {launch counter: the kernel table's entry for the TPU window
# its shape runs}); the example's last line gives its process's counts,
# and each counter named must be past 0.
GRAFT_SHARDS = 4
GRAFT_RANKS = 2
EXAMPLES = (
    ("large_scale_gplvm.py", ["--n", 1_000_000, "--m", 200],
     {"fwd": "psi_fwd", "bwd": "psi_bwd"}),
    ("huge_n_single_chip.py", ["--n", 10_000_000, "--m", 500, "--iters", 1],
     {"fwd_t": "psi_fwd_t", "bwd_t": "psi_bwd_t"}),
    ("gplvm_oil_flow.py", [], {"fwd": "psi_fwd_ml128", "bwd": "psi_bwd_ml128"}),
)
EXAMPLE_TIMEOUT = 300


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


def wide_latents(q, spread, n, m, seed=0):
    """Latents spread * N(0, 1) around the origin, each inducing point a
    latent row moved by 0.3 * N(0, 1) (as an init that picks Z among the
    latents gives), so that zeta lies near 0 while |mu'| reaches 4 spread;
    alpha scaled by min(1, 44/Q). Returns (mu, s, z, alpha, rng), float64,
    and the generator for further draws."""
    rng = np.random.default_rng(seed + 100 * q + n + m)
    mu = rng.standard_normal((n, q)) * spread
    s = 0.3 + 0.5 * rng.random((n, q))
    z = mu[rng.choice(n, m, replace=False)] + 0.3 * rng.standard_normal((m, q))
    alpha = (0.5 + rng.random(q)) * min(1.0, 44.0 / q)
    return mu, s, z, alpha, rng


def spread_inputs(n, m, q, d, spread, seed=0):
    """A spread case's float64 inputs: ``wide_latents``, sf2 = 1.3, Y (N,
    D), unit weights, and the cotangents dp1y (M, D) and dp2 (M, M), all
    N(0, 1) draws."""
    mu, s, z, alpha, rng = wide_latents(q, spread, n, m, seed)
    return dict(mu=mu, s=s, z=z, sf2=np.asarray(1.3), alpha=alpha,
                y=rng.standard_normal((n, d)), w=np.ones(n),
                dp1y=rng.standard_normal((m, d)), dp2=rng.standard_normal((m, m)))


def parity_case(n, m, q, d, nzero, offset=0.0, raw_alpha=False, spread=None, device="cuda",
                layout="nq"):
    """Kernel vs plain version on one shape in one layout, the latents (mu
    and Z) shifted by ``offset``, alpha unscaled past Q = 64 with
    ``raw_alpha``; returns a dict of errors and fails the run past the
    tolerances. With ``spread`` the inputs are ``spread_inputs``' (the
    probe's weights its cotangents)."""
    import torch

    _, _, fused, fwd_ref, _ = _wrappers(layout)
    rng = np.random.default_rng(m + n)
    if spread is None:
        host = dict(
            mu=rng.standard_normal((n, q)) + offset, s=0.3 + 0.5 * rng.random((n, q)),
            z=rng.standard_normal((m, q)) + offset, sf2=np.asarray(1.3),
            alpha=0.5 + rng.random(q), y=rng.standard_normal((n, d)),
        )
        if q > 64 and not raw_alpha:
            # exponents of Q terms: scaled to Q=44's range, past which every
            # Psi2 entry would underflow float32's normal range
            host["alpha"] *= 44.0 / q
        wy = rng.standard_normal((m, d))
        wp = rng.standard_normal((m, m))
    else:
        host = spread_inputs(n, m, q, d, spread)
        wy, wp = host["dp1y"], host["dp2"]
    if layout == "qn":
        host.update({k: np.ascontiguousarray(host[k].T) for k in ("mu", "s", "y")})
    w = np.r_[np.ones(n - nzero), np.zeros(nzero)]

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
             f"raw_alpha={raw_alpha} spread={spread}: {bad} {out}")
    return out


def flush_case(n, m, q, d, sf2, device="cuda", layout="nq"):
    """Psi2 where every entry lies below 2^-126 (``sf2`` tiny): the kernels'
    Psi2 and the gradients of the probe sum(Psi2 * W) / sf2 (the scale of
    the bound's dPsi2, through K_MM^-1) against the plain version in
    float64, beside the plain float32 version's own errors (max abs error
    / max|ref| per output). The kernels are held to the larger of F64_TOL
    and F64_FLOOR_FACTOR times the plain float32 error of each output:
    both hand the backward's assembly the float32 Psi2, subnormal here.
    Fails the run past that; returns {output: (kernel error, plain f32
    error)}."""
    import torch

    _, _, fused, fwd_ref, _ = _wrappers(layout)
    rng = np.random.default_rng(m + n)
    host = dict(mu=rng.standard_normal((n, q)), s=0.3 + 0.5 * rng.random((n, q)),
                z=rng.standard_normal((m, q)), sf2=np.asarray(sf2),
                alpha=0.5 + rng.random(q), y=rng.standard_normal((n, d)))
    if layout == "qn":
        host.update({k: np.ascontiguousarray(host[k].T) for k in ("mu", "s", "y")})
    w = np.ones(n)
    wp = rng.standard_normal((m, m)) / sf2

    def run(dtype, kernels):
        t = lambda a: torch.tensor(a, dtype=dtype, device=device)
        xs = [t(host[k]).requires_grad_(True) for k in GRAD_NAMES[:5]]
        _, p2 = (fused if kernels else fwd_ref)(*xs, t(host["y"]), t(w))
        grads = torch.autograd.grad(torch.sum(p2 * t(wp)), xs)
        return [a.detach().double().cpu().numpy() for a in (p2, *grads)]

    got, plain, ref = run(torch.float32, True), run(torch.float32, False), run(torch.float64, False)
    err = lambda a, b: float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))
    names = ("psi2",) + tuple(f"d{k}" for k in GRAD_NAMES[:5])
    out = {k: (err(a, c), err(b, c)) for k, a, b, c in zip(names, got, plain, ref)}
    bad = [k for k, (e, e32) in out.items()
           if not math.isfinite(e) or e > max(F64_TOL, F64_FLOOR_FACTOR * e32)]
    _require(not bad, f"flush {layout} N={n} M={m} Q={q} D={d} sf2={sf2}: {bad} {out}")
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


def _global_ms(fn, reps=2):
    """{``__global__`` kernel: device ms a call of fn} over ``reps`` calls
    after a warm-up, from torch.profiler's device events (the template
    argument kept, the parameter list and namespace dropped)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        torch.ones(1, device="cuda").add_(1)   # the window's last kernel is not one of fn's
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and "gparml::" in e.name:
            name = e.name.split("(")[0].split("gparml::")[-1]
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
    return out


def _ms_text(ms):
    return ", ".join(f"{k} {v:.3f}" for k, v in sorted(ms.items()))


def _max_rel(a, b):
    return max(float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)
               for x, y in zip(a, b))


def _max_abs(a, b):
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def _ptxas(log):
    """{kernel: (registers, spill-store bytes)} from nvcc's -Xptxas -v
    output: the Q-bucket-10 instantiations of every kernel, the tensor-core
    kernels' buckets 32 and 64 and their K-chunked forms (Psi1's past
    Q = 16 is its instantiation 0), and the Psi1 row pass's finish; names
    as the profiler prints them (``_kernel_id``)."""
    out, name, spill = {}, None, 0
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            mangled, spill = ln.split("'")[1], 0
            ident, args = _kernel_id(mangled)
            qm = args[0] if args else ""
            keep = (qm == "10" or not qm or ("_tc_" in ident and qm in ("0", "32", "64")))
            name = (f"{ident}<{', '.join(args)}>" if args else ident) if keep else None
        elif name and "spill stores" in ln:
            spill = int(ln.split("bytes spill stores")[0].split(",")[-1])
        elif name and "Used" in ln and "registers" in ln:
            out[name] = (int(ln.split("Used")[1].split()[0]), spill)
            name = None
    return out


def _kernel_id(mangled):
    """(identifier, template arguments) of a ``gparml::`` kernel's mangled
    name, the arguments as the profiler prints them (``10``, ``true``)."""
    rest = mangled.split("gparml", 1)[-1]
    digits = rest[:len(rest) - len(rest.lstrip("0123456789"))]
    if not digits:
        return mangled, []
    ident = rest[len(digits):len(digits) + int(digits)]
    tail, args = rest[len(digits) + int(digits):], []
    if tail.startswith("I"):
        for kind, value in re.findall(r"L([ib])(\d+)E", tail[1:tail.index("EE") + 1]):
            args.append(value if kind == "i" else ("true" if value == "1" else "false"))
    return ident, args


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
            ident, args = _kernel_id(ln.split("Function :")[1].strip())
            name = (f"{ident}<{', '.join(args)}>" if args else ident) if "_tc_" in ident else None
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


# The tensor-core kernel instantiations phase 2 finds HGMMA in: Psi2's
# three at the six Q buckets (the forward without and with the cell sums,
# the backward's row pass) and three K-chunked (the forward, the row and
# the cell pass), and Psi1's three at its four buckets (Q <= 16) and
# K-chunked (instantiation 0).
TC_KERNELS = 3 * (6 + 1) + 3 * (4 + 1)


def _globals(kind, q, cells=False):
    """The ``__global__`` kernels a forward or backward call launches at
    latent width q (csrc/psi_{fwd,bwd}.cu), Psi1's last; ``cells``: the
    forward forms the cell sums (``_route``), the backward is given them.
    The backward's Psi1 row pass adds ``psi1_bwd_rows_finish_kernel`` when
    the plan splits its inducing points (small N)."""
    qm = next((b for b in (2, 4, 10, 16, 32, 64) if q <= b), 0)
    p1 = qm if qm <= 16 else 0
    if qm:
        psi2 = ([f"psi2_fwd_tc_kernel<{qm}, {'true' if cells else 'false'}>"] if kind == "fwd"
                else [f"psi2_bwd_rows_tc_kernel<{qm}>"])
    else:
        psi2 = (["psi2_fwd_tc_chunked_kernel"] if kind == "fwd" else
                ["psi2_bwd_rows_tc_chunked_kernel", "psi2_bwd_cells_tc_chunked_kernel"])
    psi1 = (["psi1y_fwd_tc_kernel"] if kind == "fwd" else
            ["psi1_bwd_rows_tc_kernel", "psi1_bwd_m_tc_kernel"])
    return psi2 + [f"{k}<{p1}>" for k in psi1]


def _set_bounds(entry, kind, n, m, q, d, cells=False):
    """A kernel-table entry's bounds: ``bound_ms`` / ``bound_by``, the FP32
    direct form (``_bound``), and, since the exponents come from the
    tensor cores at every Q, ``bound_tc_ms`` / ``bound_tc_by``
    (``_bound_tc``); the same two of its Psi1 kernels alone,
    ``psi1_bound_ms`` and ``psi1_bound_tc_ms`` (``_psi1_bounds``); and
    ``globals``, the kernels the call launches. ``cells``: the forward forms
    the cell sums and the backward is given them (``_route``)."""
    entry["bound_ms"], entry["bound_by"] = _bound(kind, n, m, q, d, cells)
    entry["bound_tc_ms"], entry["bound_tc_by"] = _bound_tc(kind, n, m, q, d, _mufu_rate(),
                                                           cells)
    entry["psi1_bound_ms"], entry["psi1_bound_tc_ms"] = _psi1_bounds(kind, n, m, q, d,
                                                                     _mufu_rate())
    entry["globals"] = _globals(kind, q, cells)


def _psi1_pair(kind, q, d):
    """Psi1's work a (row, inducing point) pair of a forward ('fwd') or
    backward ('bwd') wrapper call, each piece computed once: (float32
    operations of the direct form, an expf as one and an FMA as two; K of
    the TF32 products of the tensor-core form, a multiply-add each; float32
    operations left on the CUDA cores beside those products).
    Forward: the exponent 4Q + 4 and p y 2D; as products the exponent
    (K = 2Q) and p Y (D), leaving the constant add and the weighting (2).
    Backward: the exponent 4Q + 4, y . dPsi1Y_m and dY += p dPsi1Y_m 4D, h
    and H 2, T and U 4Q, B 2Q; as products the exponent (2Q), the dot
    y . dPsi1Y (D), dY = p dPsi1Y (D), the centred row sums (2Q) and point
    sums (2Q) (the least they could cost: the kernels take them pair by
    pair, for accuracy), leaving the constant add, the weighting, h = p dot
    and its sum (4)."""
    if kind == "fwd":
        return 4 * q + 4 + 2 * d, 2 * q + d, 2
    return 10 * q + 6 + 4 * d, 2 * q + 2 * d + 4 * q, 4


def _psi1_elems(kind, n, m, q, d):
    """Elements Psi1's part of a wrapper call must move: each input read
    once (mu, s, Y, w, Z, alpha, sf2; the backward also dPsi1Y) and each
    output written once (the forward Psi1^T (w Y); the backward dmu, ds, dY,
    dZ, dalpha and dsf2)."""
    inputs = n * (2 * q + d + 1) + m * q + q + 1
    if kind == "fwd":
        return inputs + m * d
    return inputs + m * d + n * (2 * q + d) + m * q + q + 1


def _psi1_bounds(kind, n, m, q, d, mufu_rate):
    """(FP32 direct bound ms, tensor-core bound ms) of a wrapper call's Psi1
    kernels alone: the larger of their float32 operations (``_psi1_pair``)
    at the float32 peak and their bytes (``_psi1_elems``) at the memory
    rate; and the largest of the exp of each (row, point) pair on the MUFU,
    the TF32 products, the float32 rest and the bytes."""
    pairs = n * m
    ops, k1, rest = _psi1_pair(kind, q, d)
    t_bytes = 4 * _psi1_elems(kind, n, m, q, d) / HBM_RATE
    fp32 = max(ops * pairs / F32_PEAK, t_bytes)
    tc = max(pairs / mufu_rate, 2 * k1 * pairs / TF32_PEAK, rest * pairs / F32_PEAK, t_bytes)
    return fp32 * 1e3, tc * 1e3


def _entry_text(k):
    """A kernel-table entry's times and bounds, for the phase lines."""
    tc = (f", tensor-core form {k['bound_tc_ms']:.2f} ms by {k['bound_tc_by']}"
          if "bound_tc_ms" in k else "")
    p1 = (f"; Psi1 kernels' bound {k['psi1_bound_ms']:.3f} ms, tensor-core form "
          f"{k['psi1_bound_tc_ms']:.3f} ms" if "psi1_bound_ms" in k else "")
    return (f"{k['name']} {k['ms']:.2f} ms (plain {k['plain_ms']:.2f} ms, bound "
            f"{k['bound_ms']:.2f} ms{tc}{p1})")


def _bound_tc(kind, n, m, q, d, mufu_rate, cells=False):
    """(bound ms, what bounds it) of a wrapper call whose Psi2 and Psi1 work
    runs on the tensor cores: the largest of the pairs' exp (Psi2 and Psi1)
    on the MUFU; the TF32 products at the tensor cores' rate, 2 FLOP a
    multiply-add, each counted once: the exponents (K = 2Q a pair of either
    kind) and, for Psi2, the backward's row sums [zb' | zb'^2 | 1] (2Q + 1)
    and the cell sums [c mu' | c] (2Q; with ``cells`` the forward's); for
    Psi1, ``_psi1_pair``'s; the float32 operations left on the CUDA cores:
    per Psi2 pair the two constant adds and the weighting (forward: w e
    added, 3; backward: g = K w e and w e, 3), per Psi1 pair
    ``_psi1_pair``'s; and the bytes (``_work``)."""
    _, nbytes = _work(kind, n, m, q, d, cells)
    pairs2, pairs1 = n * (m * (m + 1) // 2), n * m
    k_cells = 2 * q if (kind == "fwd") == cells else 0   # the cell sums' product
    k_sum = 2 * q + k_cells + (0 if kind == "fwd" else 2 * q + 1)
    _, k1_sum, rest1 = _psi1_pair(kind, q, d)
    times = {
        "exp (MUFU)": (pairs2 + pairs1) / mufu_rate,
        "TF32 products": 2 * (k_sum * pairs2 + k1_sum * pairs1) / TF32_PEAK,
        "float32 operations": (5 * pairs2 + rest1 * pairs1) / F32_PEAK,
        "bytes": nbytes / HBM_RATE,
    }
    by = max(times, key=times.get)
    return times[by] * 1e3, by


def _work(kind, n, m, q, d, cells=False):
    """(float32 operations, bytes) of one forward ('fwd') or backward
    ('bwd') wrapper call: the operations the function needs per (row, cell)
    and per (row, inducing point) pair, each computed once (an expf as one
    operation, an FMA as two), and each input read and each output written
    once. ``cells``: the centred cell sums A move from the backward to the
    forward (2Q a (row, cell) pair), which writes A (Q, M, M) and the
    backward reads it."""
    pairs = m * (m + 1) // 2
    ops1 = _psi1_pair(kind, q, d)[0]
    if kind == "fwd":
        # Psi2: per q a difference, a product, an FMA; then two adds, the
        # exp and the weighted FMA: 4Q + 5. Out: Psi2 beside Psi1^T (w Y).
        ops = n * (pairs * (4 * q + 5) + m * ops1)
        elems = _psi1_elems(kind, n, m, q, d) + m * m
    else:
        # Psi2: the exponent once, 4Q + 4 (as in the forward, times w);
        # g = K w e and G += g, 2; t_q += g d_q, u_q += g d_q^2, 4Q; the
        # centred cell sum A_q += w e (c_q d_q), one FMA on the exponent's
        # product, 2Q: 10Q + 6. In: also Psi1^T (w Y), Psi2 and dPsi2.
        ops = n * (pairs * (10 * q + 6) + m * ops1)
        elems = _psi1_elems(kind, n, m, q, d) + m * d + 2 * m * m
    if cells:
        moved = n * pairs * 2 * q
        ops += moved if kind == "fwd" else -moved
        elems += q * m * m
    return ops, 4 * elems


def _bound(kind, n, m, q, d, cells=False):
    """(bound ms, what bounds it): the larger of the operations over the
    card's float32 peak and the bytes over its memory rate (``_work``)."""
    ops, nbytes = _work(kind, n, m, q, d, cells)
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


def _route(layout, xs, cot):
    """(cells, forward, backward): the kernel calls a fit's evaluation makes
    on the kernel inputs ``xs`` (``PsiFused``'s route,
    ``psi_cuda._emits_cells``): up to Q = 64 the forward that also forms the
    cell sums, and the backward given them (no cell sums formed), with the
    cotangents ``cot``; past it the forward and the backward wrappers."""
    from gparml_tpu_torch.ops import psi_cuda

    cells = psi_cuda._emits_cells(True, True, xs[2].shape[1])
    out = psi_cuda._launch_fwd(layout, *xs, cells=cells)
    a = out[2] if cells else None
    return (cells, lambda: psi_cuda._launch_fwd(layout, *xs, cells=cells),
            lambda: psi_cuda._launch_bwd(layout, *xs, *out[:2], *cot, a=a))


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
    cells, fwd_fn, bwd_fn = _route("nq", fwd_in, cot)
    entries = [
        {"name": "psi_fwd", "route": "cuda",
         "source": "gparml_tpu_torch/csrc/psi_fwd.cu",
         "replaces": "gparml_tpu/ops/psi_pallas.py:634",
         "max_abs_err": abs_err[0],
         "ms": _cuda_ms(fwd_fn, 5),
         "plain_ms": _cuda_ms(lambda: psi_cuda.psi_fused_fwd_reference(*fwd_in, block=block), 2)},
        {"name": "psi_bwd", "route": "cuda",
         "source": "gparml_tpu_torch/csrc/psi_bwd.cu",
         "replaces": "gparml_tpu/ops/psi_pallas.py:794",
         "max_abs_err": abs_err[1],
         "ms": _cuda_ms(bwd_fn, 3),
         "plain_ms": _cuda_ms(lambda: psi_cuda.psi_fused_bwd_reference(*fwd_in, *cot, block=block), 1)},
    ]
    for k, kind in zip(entries, ("fwd", "bwd")):
        _set_bounds(k, kind, n, m, q, d, cells)
        k["library_ms"] = None   # no single PyTorch call computes Psi1^T Y or sum Psi2
    entries[0]["globals_ms"] = _global_ms(fwd_fn, 3)
    entries[1]["globals_ms"] = _global_ms(bwd_fn, 3)
    del fwd_k, fwd_in, fwd_fn, bwd_fn
    print("phase 4 kernels at the slice shape: "
          + "; ".join(map(_entry_text, entries)) + "; " + text)
    print("phase 4 device ms a call at the slice shape: "
          + _ms_text({**entries[0]["globals_ms"], **entries[1]["globals_ms"]}))

    # the main path: bound+gradient evaluations and a 5-iteration SCG fit
    psi_cuda.LAUNCHES.update(fwd=0, bwd=0, fwd_cells=0)
    torch.cuda.reset_peak_memory_stats()
    sec_k, (f_k, g_k) = _eval_seconds(gplvm, p, y, cfg)
    t0 = time.perf_counter()
    res = gplvm.fit(p, y, cfg, iters=5)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {k: psi_cuda.LAUNCHES[k] for k in ("fwd", "bwd", "fwd_cells")}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for k in entries:
        k["launches"] = launches[k["name"][4:]]
    bound = res.trace["bound"][:5]
    _require(np.all(np.isfinite(bound)), f"phase 4 fit bound not finite: {bound}")
    _require(np.all(np.diff(bound) >= 0), f"phase 4 fit bound decreased: {bound}")
    _require(launches["fwd"] > 0 and launches["bwd"] > 0,
             f"phase 4 main path skipped a kernel: {launches}")
    _require(launches["fwd_cells"] == launches["fwd"],
             f"phase 4 main path: a forward did not form the cell sums: {launches}")

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
    psi_cuda.LAUNCHES.update(fwd_t=0, bwd_t=0, fwd_cells_t=0)
    torch.cuda.reset_peak_memory_stats()
    sec, out = _eval_seconds(gplvm, p, y_t, cfg, reps=2)
    t0 = time.perf_counter()
    res = gplvm.fit(p, y_t, cfg, iters=2)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {k: psi_cuda.LAUNCHES[k] for k in ("fwd_t", "bwd_t", "fwd_cells_t")}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    bound = res.trace["bound"][:2]
    _require(np.all(np.isfinite(bound)), f"phase 5 fit bound not finite: {bound}")
    _require(np.all(np.diff(bound) >= 0) and bound[0] >= -float(out[0]),
             f"phase 5 fit bound decreased: {-float(out[0])} -> {bound}")
    _require(launches["fwd_t"] > 0 and launches["bwd_t"] > 0,
             f"phase 5 main path skipped a kernel: {launches}")
    _require(launches["fwd_cells_t"] == launches["fwd_t"],
             f"phase 5 main path: a forward did not form the cell sums: {launches}")
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
    del full, full_fwd
    cells, fwd_fn, bwd_fn = _route("qn", fwd_in, cot)
    for name, kind, fn, reps, names, pms in (
            ("psi_fwd_t", "fwd", fwd_fn, 2, _OUTPUTS[:2], plain_ms[0]),
            ("psi_bwd_t", "bwd", bwd_fn, 1, _OUTPUTS[2:], plain_ms[1])):
        entry = {"name": name, "route": "cuda",
                 "source": f"gparml_tpu_torch/csrc/psi_{kind}.cu",
                 "replaces": "gparml_tpu/ops/psi_pallas.py:" + ("671" if kind == "fwd" else "820"),
                 "launches": launches[kind + "_t"],
                 "max_abs_err": max(vs_plain[k][0] for k in names),
                 "ms": _cuda_ms(fn, reps), "plain_ms": pms, "globals_ms": _global_ms(fn, 1)}
        _set_bounds(entry, kind, n, m, q, d, cells)
        entry["library_ms"] = None   # no single PyTorch call computes Psi1^T Y or sum Psi2
        kernels.append(entry)
    print("phase 5 config 5 kernels: " + "; ".join(map(_entry_text, kernels[-2:])))
    print("phase 5 config 5 device ms a call: " + _ms_text(
        {**kernels[-2]["globals_ms"], **kernels[-1]["globals_ms"]}))
    return p, y_t


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


# (N, M, D, layout, Q buckets) of phase 3's times of the Psi2 forward sweep
# with and without the cell sums and of the backward's row pass: the
# slice's shape (nq) and infer_latents' batch of the slice (N=1000) at every
# Q bucket, config 5's (qn, N=1e7, M=500) up to Q = 16 (a call there does
# 62 times the slice's pairs: past Q = 16 minutes for the three kernels).
ROUTE_SHAPES = ((1_000_000, 200, 12, "nq", (2, 4, 10, 16, 32, 64)),
                (10_000_000, 500, 12, "qn", (2, 4, 10, 16)),
                (1_000, 200, 12, "nq", (2, 4, 10, 16, 32, 64)))


def _tc_floor_ms(kernel, n, m, q):
    """The 3-term TF32 floor of a Psi2 sweep up to Q = 64: its products at
    the tensor cores' rate, 3 (K + N2) x 2 flops a (row, cell) pair, with K
    the exponents' padded K (csrc/psi_tc.cuh tc_k) and N2 that of the
    kernel's reduction: the forward with the cell sums ('fwd_cells',
    tc_n2_cells), without them ('fwd', none), the backward's row pass
    ('rows', tc_n2_rows)."""
    qm = next(b for b in (2, 4, 10, 16, 32, 64) if q <= b)
    k = (2 * qm + 7) // 8 * 8
    n2 = {"fwd_cells": k, "fwd": 0, "rows": (2 * qm + 1 + 7) // 8 * 8}[kernel]
    return 3 * (k + n2) * 2 * n * (m * (m + 1) // 2) / TF32_PEAK * 1e3


def _route_times(n, m, q, d, layout, dev):
    """Device ms a call of the Psi2 forward sweep that forms the cell sums
    too (``psi2_fwd_tc_kernel<QM, true>``), of the same sweep without them
    (``<QM, false>``, where no dZ is wanted) and of the backward's Psi2 row
    pass given those sums (``psi2_bwd_rows_tc_kernel``), on N(0, 1) latents
    at (n, m, q, d) in ``layout``."""
    import torch
    from gparml_tpu_torch.ops import psi_cuda

    gen = torch.Generator(dev).manual_seed(n + m + q)
    r = lambda *shape: torch.randn(*shape, generator=gen, device=dev)
    lat = (n, q) if layout == "nq" else (q, n)
    xs = (r(*lat), 0.3 + 0.5 * torch.rand(*lat, generator=gen, device=dev), r(m, q),
          torch.tensor(1.3, device=dev), torch.full((q,), min(1.0, 10.0 / q), device=dev),
          r(*((n, d) if layout == "nq" else (d, n))), torch.ones(n, device=dev))
    fused = _global_ms(lambda: psi_cuda._launch_fwd(layout, *xs, cells=True))
    alone = _global_ms(lambda: psi_cuda._launch_fwd(layout, *xs))
    p1y, p2, a = psi_cuda._launch_fwd(layout, *xs, cells=True)
    cot = _cotangents(m, d, dev)
    rows = _global_ms(lambda: psi_cuda._launch_bwd(layout, *xs, p1y, p2, *cot, a=a))
    return (fused[f"psi2_fwd_tc_kernel<{q}, true>"], alone[f"psi2_fwd_tc_kernel<{q}, false>"],
            rows[f"psi2_bwd_rows_tc_kernel<{q}>"])


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
    """Table entries of the nq forward and backward kernels at ``shape``
    (N, M, Q, D): the wrappers held against their plain versions
    (``_kernels_vs_plain``), and the fit's route (``_route``) timed beside
    them; ``replaces`` names the TPU kernels of the window."""
    from gparml_tpu_torch.ops import psi_cuda

    n, m, q, d = shape
    _, abs_err, text = _kernels_vs_plain(label, "nq", fwd_in, cot, block)
    cells, fwd_fn, bwd_fn = _route("nq", fwd_in, cot)
    entries = []
    for kind, err, fn, ref, reps in (
            ("fwd", abs_err[0], fwd_fn,
             lambda: psi_cuda.psi_fused_fwd_reference(*fwd_in, block=block), 5),
            ("bwd", abs_err[1], bwd_fn,
             lambda: psi_cuda.psi_fused_bwd_reference(*fwd_in, *cot, block=block), 3)):
        name, line = replaces[kind]
        entry = {"name": name, "route": "cuda",
                 "source": f"gparml_tpu_torch/csrc/psi_{kind}.cu",
                 "replaces": f"gparml_tpu/ops/psi_pallas.py:{line}",
                 "launches": launches[kind], "max_abs_err": err,
                 "ms": _cuda_ms(fn, reps), "plain_ms": _cuda_ms(ref, 1),
                 "globals_ms": _global_ms(fn)}
        _set_bounds(entry, kind, n, m, q, d, cells)
        entry["library_ms"] = None   # no single PyTorch call computes Psi1^T Y or sum Psi2
        entries.append(entry)
    print(f"{label} kernels: " + "; ".join(map(_entry_text, entries)) + "; " + text)
    print(f"{label} device ms a call: " + _ms_text(
        {**entries[0]["globals_ms"], **entries[1]["globals_ms"]}))
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


def _timed(fn):
    """(wall seconds, fn()) with the card synchronized around the call."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def _rel_err(got, ref):
    """{output index: max abs error / max|ref|} of two tuples of tensors."""
    return [float((a.double() - b.double()).abs().max() / b.double().abs().max().clamp_min(1e-300))
            for a, b in zip(got, ref)]


def _float32_form(st32, st64):
    """st64 with Psi2 as the float32 posterior takes it: plus the jitter of
    ``bound._chol_psi2`` (30 or 3000 float32 eps times tr(Psi2), the rung
    st32's float32 Psi2 takes). The B-form on it is the float32 form's
    function evaluated in float64: what the float32 route computes, without
    its rounding."""
    import torch
    from gparml_tpu_torch.ops import bound as bound_ops

    m = st64.psi2.shape[0]
    jit = (float(bound_ops._jitter_scale(st32.psi2)) * float(torch.finfo(torch.float32).eps)
           * torch.trace(st64.psi2))
    eye = torch.eye(m, dtype=torch.float64, device=st64.psi2.device)
    return st64._replace(psi2=st64.psi2 + jit * eye)


def _hold_predictions(label, fn, k32, x32, k64, x64, ref64):
    """Hold a prediction function ``fn(stats, dtype)`` -> (mean, variance)
    computed from the kernels' statistics against its references, as the
    bound is held in phase 4: the kernels' float32 route against the plain
    engine's (SLICE_TOL); the kernels' statistics through the float64
    algebra against the plain float64 route (F64_TOL, or twice the plain
    float32 statistics' own distance through the same algebra); and the
    float32 route against its float32 form in float64 on the same
    statistics (PREDICT_TOL). The float32 form's distance from the plain
    float64 route is its jitter's, the JAX package's own: printed, not
    held. k32/x32: the kernels' and the plain engine's float32 statistics;
    k64/x64 those cast to float64; ref64 the plain float64 engine's."""
    import torch

    got = fn(k32, torch.float32)
    vs_plain = _rel_err(got, fn(x32, torch.float32))
    want = fn(ref64, torch.float64)
    vs64 = _rel_err(fn(k64, torch.float64), want)
    plain64 = _rel_err(fn(x64, torch.float64), want)
    form = _rel_err(got, fn(_float32_form(k32, k64), torch.float64))
    _require(max(vs_plain) <= SLICE_TOL, f"{label} vs the plain engine: {vs_plain}")
    _require(all(e <= max(F64_TOL, F64_FLOOR_FACTOR * e0) for e, e0 in zip(vs64, plain64)),
             f"{label} kernels' statistics through float64 vs float64: {vs64} "
             f"(plain f32 statistics {plain64})")
    _require(max(form) <= PREDICT_TOL, f"{label} float32 route vs its form in float64: {form}")
    print(f"{label} (mean, variance) max abs err of max|ref|: kernels vs plain f32 "
          f"{vs_plain[0]:.2e}, {vs_plain[1]:.2e}; kernels' statistics + f64 vs plain f64 "
          f"{vs64[0]:.2e}, {vs64[1]:.2e} (plain f32 statistics {plain64[0]:.2e}, "
          f"{plain64[1]:.2e}); f32 route vs its form in f64 {form[0]:.2e}, {form[1]:.2e}; "
          f"whole f32 route vs plain f64 " + ", ".join(f"{e:.2e}" for e in _rel_err(got, want)))
    return got


def _glob_of(p, dtype=None):
    """(z, sf2, alpha, beta) of p's globals, detached, in ``dtype``."""
    from gparml_tpu_torch.models import params as P

    return tuple(t.detach().to(dtype or t.dtype) for t in P.constrain(p.glob))


def _infer_f64_bound(p, y, y_new, cfg, lat):
    """(-bound, gradient in the new latents ``lat``) of infer_latents'
    objective with ``cfg``'s engine at float32 and the bound in float64."""
    import torch
    from gparml_tpu_torch.models import gplvm, params as P
    from gparml_tpu_torch.ops import bound as bound_ops

    glob = P.GlobalParams(*(t.detach() for t in P.leaves(p.glob)))
    with torch.no_grad():
        st_tr = gplvm.suff_stats(p, y, cfg)
    p_new = P.GPLVMParams(glob, P.LatentParams(*lat))
    st_new = gplvm.suff_stats(p_new, y_new, cfg)
    st = type(st_tr)(*(a.double() + b.double() for a, b in zip(st_tr, st_new)))
    z, sf2, alpha, beta = _glob_of(p, torch.float64)
    f = -bound_ops.bound_from_stats(st, z, sf2, alpha, beta, d=gplvm._d_of(y, cfg),
                                    jitter=cfg.jitter)
    return f.detach(), torch.autograd.grad(f, list(p_new.lat.parameters()))


def phase7_serving(dev):
    """7(a): the slice's GPLVM (N=1e6, Q=10, M=200, D=12, nq, float32)
    fitted, then predict_observed, infer_latents on held-out rows and
    reconstruct from the inferred q(x*)."""
    import torch
    from gparml_tpu_torch import data
    from gparml_tpu_torch.models import gplvm, params as P
    from gparml_tpu_torch.ops import bound as bound_ops, psi_cuda

    n, q, m, d, iters, n_held, n_pred, n_inf, inf_iters, block = SERVE
    t0 = time.perf_counter()
    # one draw of N + held rows: oil_flow_like's rows depend on n
    y_np, _ = data.oil_flow_like(n=n + n_held, d=d)
    y_all = torch.tensor(y_np, dtype=torch.float32, device=dev)
    y, y_new = y_all[:n], y_all[n:n + n_inf].contiguous()
    cfg = gplvm.GPLVMConfig(q=q, num_inducing=m, stats_impl="auto")
    cfg_x = gplvm.GPLVMConfig(q=q, num_inducing=m, stats_impl="xla", block=block)
    p0 = gplvm.init_params(torch.Generator(dev).manual_seed(0), y, cfg)
    fit_s, res = _timed(lambda: gplvm.fit(p0, y, cfg, iters=iters))
    p = res.params
    print(f"phase 7(a) N={n}+{n_held} held out, Q={q} M={m} D={d}: data+init "
          f"{time.perf_counter() - t0 - fit_s:.2f} s, fit {iters} SCG iterations "
          f"{fit_s:.2f} s, bound {res.trace['bound'][0]:.6g} -> {res.bound:.6g}")

    p64, y64 = P.from_leaves([t.double() for t in P.leaves(p)]), y.double()
    with torch.no_grad():
        st = {"k32": gplvm.suff_stats(p, y, cfg), "x32": gplvm.suff_stats(p, y, cfg_x),
              "ref64": gplvm.suff_stats(p64, y64, cfg_x)}
    st["k64"] = type(st["k32"])(*(t.double() for t in st["k32"]))
    st["x64"] = type(st["x32"])(*(t.double() for t in st["x32"]))
    glob = {torch.float32: _glob_of(p), torch.float64: _glob_of(p, torch.float64)}

    # predict_observed at latent points: the fitted means of the first rows
    x_star = gplvm.latents(p, cfg)[0][:n_pred].detach().contiguous()
    psi_cuda.LAUNCHES.update({k: 0 for k in psi_cuda.LAUNCHES})
    with torch.no_grad():
        sec, out = _timed(lambda: gplvm.predict_observed(p, y, x_star, cfg))
    launches = dict(psi_cuda.LAUNCHES)
    _require(launches["fwd"] > 0 and all(torch.isfinite(t).all() for t in out)
             and tuple(out[0].shape) == (n_pred, d), f"phase 7(a) predict_observed: {launches}")
    print(f"phase 7(a) predict_observed at {n_pred} latent points: {sec:.3f} s; "
          f"launches {launches}")
    _hold_predictions(
        "phase 7(a) predict_observed",
        lambda s_, dt: bound_ops.predict(x_star.to(dt), s_, *glob[dt]), **st)

    # infer_latents: kernel launches, a non-decreasing bound, and its first
    # evaluation against the plain engine in float64, as phase 4 holds the
    # bound
    psi_cuda.LAUNCHES.update({k: 0 for k in psi_cuda.LAUNCHES})
    sec, (mu_s, s_s, inf) = _timed(lambda: gplvm.infer_latents(p, y, y_new, cfg,
                                                               iters=inf_iters))
    launches = dict(psi_cuda.LAUNCHES)
    bound = inf.trace["bound"]
    done = int(np.isfinite(bound).sum())
    _require(launches["fwd"] > 0 and launches["bwd"] > 0,
             f"phase 7(a) infer_latents skipped a kernel: {launches}")
    _require(done > 0 and np.all(np.diff(bound[:done]) >= 0),
             f"phase 7(a) infer_latents bound decreased: {bound}")
    print(f"phase 7(a) infer_latents {n_inf} rows, {inf_iters} SCG iterations: {sec:.3f} s "
          f"({done} iterations, {inf.n_evals} evaluations, {sec / max(done, 1):.4f} s per "
          f"iteration), bound {bound[0]:.8g} -> {bound[done - 1]:.8g}; launches {launches}")
    z_, sf2_, al_, _ = (t.detach().contiguous() for t in P.constrain(p.glob, cfg.bijector))
    inf_in = (mu_s.detach().contiguous(), s_s.detach().contiguous(), z_, sf2_, al_, y_new,
              torch.ones(n_inf, device=dev))
    cot = _cotangents(m, d, dev)
    p_inf = psi_cuda.psi_fwd(*inf_in)
    # as infer_latents runs them: Z held, so no kernel forms the cell sums
    bwd_held = lambda: psi_cuda._launch_bwd("nq", *inf_in, *p_inf, *cot, dz=False)
    print(f"phase 7(a) infer_latents' statistics N={n_inf} M={m} Q={q} D={d}, device ms a "
          f"call: " + _ms_text({**_global_ms(lambda: psi_cuda.psi_fwd(*inf_in), 5),
                                **_global_ms(bwd_held, 5)}))
    del inf_in, p_inf
    vg, lat0 = gplvm._infer_objective(p, y, y_new, cfg)
    f_k, g_k = vg(lat0)
    f_x, g_x = gplvm._infer_objective(p, y, y_new, cfg_x)[0](lat0)
    f_64, g_64 = gplvm._infer_objective(p64, y64, y_new.double(), cfg_x)[0](
        [t.double() for t in lat0])
    f_kb, g_kb = _infer_f64_bound(p, y, y_new, cfg, lat0)
    f_xb, g_xb = _infer_f64_bound(p, y, y_new, cfg_x, lat0)
    rel = lambda a, b: abs(float(a) - float(b)) / abs(float(b))
    norm = lambda gs, hs: [_norm_err(a.double().cpu().numpy(), b.double().cpu().numpy())
                           for a, b in zip(gs, hs)]
    vs_plain, kb, xb = norm(g_k, g_x), norm(g_kb, g_64), norm(g_xb, g_64)
    _require(rel(f_k, f_x) <= SLICE_TOL and max(vs_plain) <= SLICE_TOL,
             f"phase 7(a) infer first evaluation vs plain: {rel(f_k, f_x)}, {vs_plain}")
    _require(rel(f_kb, f_64) <= F64_TOL and max(kb) <= F64_TOL,
             f"phase 7(a) infer first evaluation, kernels' statistics with a float64 "
             f"bound vs float64: {rel(f_kb, f_64)}, {kb}")
    print(f"phase 7(a) infer first evaluation (bound rel; gradient mu, u_s norm-scaled): "
          f"kernels vs plain f32 {rel(f_k, f_x):.2e}; {vs_plain[0]:.2e}, {vs_plain[1]:.2e}; "
          f"kernels' statistics + f64 bound vs plain f64 {rel(f_kb, f_64):.2e}; "
          f"{kb[0]:.2e}, {kb[1]:.2e} (plain f32 statistics {rel(f_xb, f_64):.2e}; "
          f"{xb[0]:.2e}, {xb[1]:.2e}); whole f32 path vs f64 {rel(f_k, f_64):.2e}; "
          + ", ".join(f"{e:.2e}" for e in norm(g_k, g_64)))

    # reconstruct the held-out rows from the inferred q(x*)
    psi_cuda.LAUNCHES.update({k: 0 for k in psi_cuda.LAUNCHES})
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        sec, out = _timed(lambda: gplvm.reconstruct(p, y, mu_s, s_s, cfg))
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches = dict(psi_cuda.LAUNCHES)
    mean = _hold_predictions(
        "phase 7(a) reconstruct",
        lambda s_, dt: bound_ops.predict_uncertain(mu_s.to(dt), s_s.to(dt), s_, *glob[dt]),
        **st)[0]
    rmse = float(torch.sqrt(torch.mean((mean - y_new) ** 2)))
    base = float(torch.sqrt(torch.mean(y_new ** 2)))
    _require(rmse < 0.5 * base, f"phase 7(a) reconstruct RMSE {rmse} vs zero-mean {base}")
    print(f"phase 7(a) reconstruct {n_inf} rows: {sec:.3f} s, peak {peak:.2f} GB; RMSE "
          f"{rmse:.4f} (zero-mean baseline {base:.4f}, ratio {rmse / base:.3f}); "
          f"launches {launches}")


def phase7_config5(dev, p, y_t):
    """7(b): reconstruct at config 5's width (N=1e7, M=500, qn/dn) from phase
    5's parameters, at the latents of its first rows."""
    import torch
    from gparml_tpu_torch.models import gplvm
    from gparml_tpu_torch.ops import bound as bound_ops, psi_cuda

    n_star, n_check = RECON_C5
    q, m = CONFIG5[1], CONFIG5[2]
    cfg = gplvm.GPLVMConfig(q=q, num_inducing=m, layout="qn", y_layout="dn",
                            stats_impl="auto")
    mu, s = (t[:n_star].detach().contiguous() for t in gplvm.latents(p, cfg))
    psi_cuda.LAUNCHES.update({k: 0 for k in psi_cuda.LAUNCHES})
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with torch.no_grad():
        sec, (mean, var) = _timed(lambda: gplvm.reconstruct(p, y_t, mu, s, cfg))
        peak = torch.cuda.max_memory_allocated()
        launches = dict(psi_cuda.LAUNCHES)
        st = gplvm.suff_stats(p, y_t, cfg)
        st64 = type(st)(*(t.double() for t in st))
        ref = lambda s_: bound_ops.predict_uncertain(
            mu[:n_check].double(), s[:n_check].double(), s_, *_glob_of(p, torch.float64))
        got = (mean[:n_check], var[:n_check])
        form, errs = _rel_err(got, ref(_float32_form(st, st64))), _rel_err(got, ref(st64))
    _require(launches["fwd_t"] > 0 and tuple(mean.shape) == (n_star, y_t.shape[0])
             and bool(torch.isfinite(mean).all() and torch.isfinite(var).all()),
             f"phase 7(b) reconstruct: {launches}")
    _require(max(form) <= PREDICT_TOL,
             f"phase 7(b) reconstruct vs its float32 form in float64: {form}")
    print(f"phase 7(b) config 5 reconstruct N={y_t.shape[1]} M={m} qn/dn, {n_star} points: "
          f"{sec:.3f} s, peak {peak / 1e9:.2f} GB ({(peak - base) / 1e9:.2f} GB above the "
          f"model and data); launches {launches}; first {n_check} (mean, variance), max abs "
          f"err of max|ref|, on the kernels' statistics: vs the float32 form in float64 "
          f"{form[0]:.2e}, {form[1]:.2e}; vs the float64 route {errs[0]:.2e}, {errs[1]:.2e}")


def phase7_sgpr(dev, work):
    """7(c): SGPR. BASELINE config 1 through the CLI (--fixed-embeddings),
    then a resume; and the API at N=1e6 in both layouts: one bound+gradient
    held against float64, and an SCG fit."""
    import torch
    from gparml_tpu_torch import data
    from gparml_tpu_torch.models import params as P, sgpr
    from gparml_tpu_torch.ops import bound as bound_ops

    n, d, q, m, iters, more, (lo, hi) = SGPR_CLI
    x_np, y_np = data.synthetic_regression(n=n, seed=0)
    folder = os.path.join(work, "sgpr")
    stats, emb = os.path.join(folder, "st"), os.path.join(folder, "emb")
    data.save_embeddings(emb, x_np, np.zeros_like(x_np), CLI_PARTITIONS)
    base = ["-i", _write_inputs(folder, y_np), "-e", emb, "-s", stats, "-m", m,
            "--fixed-embeddings", "--seed", 0, "--device", dev.type]
    s1, l1, sec1 = _cli_run(base + ["-T", iters, "--trace-timing"])
    rows = _history(stats)
    hist = np.array([r["bound"] for r in rows])
    hist = hist[np.isfinite(hist)]
    with np.load(os.path.join(stats, "checkpoint.npz")) as f:
        g = P.global_from_numpy(P.GlobalArrays(*(f[k] for k in P.GlobalArrays._fields)),
                                device=dev)
    noise = float(1.0 / torch.sqrt(P.constrain(g)[3].detach()))
    _require(s1["mode"] == "sgpr" and len(hist) > 0 and np.all(np.diff(hist) >= 0),
             f"phase 7(c) config 1 bound not non-decreasing: {hist[:3]}...{hist[-3:]}")
    _require(lo <= noise <= hi, f"phase 7(c) config 1 noise std {noise} outside [{lo}, {hi}]")
    x = torch.tensor(x_np, dtype=torch.float32, device=dev)
    y = torch.tensor(y_np, dtype=torch.float32, device=dev)
    f0 = float(sgpr.log_bound(g, x, y, sgpr.SGPRConfig(num_inducing=m)).detach())
    s2, l2, sec2 = _cli_run(base + ["-T", more, "--load"])
    rel = abs(f0 - s1["final_bound"]) / abs(s1["final_bound"])
    _require(rel <= 1e-5, f"phase 7(c) checkpoint bound {f0} vs saved {s1['final_bound']}")
    _require(s2["final_bound"] >= f0, f"phase 7(c) resume ended below its start: {f0} -> {s2}")
    per_eval = np.nansum([r.get("wall_s", np.nan) for r in rows]) / max(s1["n_evals"] - 1, 1)
    print(f"phase 7(c) BASELINE config 1 through the CLI, N={n} D={d} Q={q} M={m} -T {iters}: "
          f"{sec1:.2f} s, bound {hist[0]:.6g} -> {hist[-1]:.6g} ({s1['n_evals']} evaluations, "
          f"{per_eval * 1e3:.3f} ms/eval from the wall column); noise std {noise:.4f} (true "
          f"0.2); launches {l1} (SGPR runs no kernel); "
          f"resume --load -T {more}: {sec2:.2f} s, starts at {f0:.6g} (saved "
          f"{s1['final_bound']:.6g}, rel {rel:.2e}), ends at {s2['final_bound']:.6g}")

    n, q, m, iters = SGPR_API
    x_np, y_np = data.synthetic_regression(n=n, seed=0)
    for layout in ("nq", "qn"):
        host = (lambda a: np.ascontiguousarray(a.T)) if layout == "qn" else (lambda a: a)
        x = torch.tensor(host(x_np), dtype=torch.float32, device=dev)
        y = torch.tensor(host(y_np), dtype=torch.float32, device=dev)
        cfg = sgpr.SGPRConfig(num_inducing=m, layout=layout)
        g = sgpr.init_params(torch.Generator(dev).manual_seed(0), x, y, cfg)
        sgpr.neg_bound_value_and_grad(g, x, y, cfg)
        secs = []
        for _ in range(3):
            sec, (f32, g32) = _timed(lambda: sgpr.neg_bound_value_and_grad(g, x, y, cfg))
            secs.append(sec)
        # the float64 statistics through the float32 bound (the bound the
        # float32 route takes), and the whole float64 route
        g64 = P.from_leaves([t.double() for t in P.leaves(g)])
        x64, y64 = x.double(), y.double()
        st64 = sgpr.suff_stats(g64, x64, y64, cfg)
        with torch.no_grad():
            st_err = dict(zip(("psi0", "psi1_y", "psi2", "yy"),
                              _rel_err(sgpr.suff_stats(g, x, y, cfg)[:4], st64[:4])))
        z, sf2, alpha, beta = (t.float() for t in P.constrain(g64))
        f_s64 = -bound_ops.bound_from_stats(type(st64)(*(t.float() for t in st64)), z, sf2,
                                            alpha, beta, d=1, jitter=cfg.jitter)
        g_s64 = torch.autograd.grad(f_s64, list(g64.parameters()))
        f64, gr64 = sgpr.neg_bound_value_and_grad(g64, x64, y64, cfg)
        names = [k for k, _ in g.named_parameters()]
        rel = lambda a, b: abs(float(a) - float(b)) / abs(float(b))
        norm = lambda gs, hs: {k: _norm_err(a.double().cpu().numpy(), b.double().cpu().numpy())
                               for k, a, b in zip(names, gs, hs)}
        err_s, err_64 = norm(g32, g_s64), norm(g32, gr64)
        # The statistics are cuBLAS float32 products summed over N rows, held
        # as phase 4 holds two float32 paths that sum 1e5..1e7 rows. The
        # bound and gradient are printed beside float64 and not held: at
        # M=200 on one input dimension K_MM's condition number is ~1e8, and
        # the float32 bound's PSD-by-construction form (its jitter 30 eps
        # tr(Psi2)) is another function there, in the JAX package as here.
        _require(max(st_err.values()) <= SLICE_TOL,
                 f"phase 7(c) SGPR {layout} float32 statistics vs float64: {st_err}")
        _require(all(math.isfinite(float(f)) and all(bool(torch.isfinite(t).all()) for t in gs)
                     for f, gs in ((f32, g32), (f64, gr64))),
                 f"phase 7(c) SGPR {layout} bound+gradient not finite")
        fit_s, res = _timed(lambda: sgpr.fit(g, x, y, cfg, iters=iters))
        b = res.trace["bound"][:iters]
        _require(np.all(np.isfinite(b)) and np.all(np.diff(b) >= 0),
                 f"phase 7(c) SGPR {layout} fit bound: {b}")
        print(f"phase 7(c) SGPR API N={n} Q={q} M={m} {layout}: {min(secs):.4f} s/eval; "
              f"float32 statistics vs float64 (max abs err of max|ref|) "
              + ", ".join(f"{k} {v:.2e}" for k, v in st_err.items())
              + f"; bound+gradient vs the float64 statistics through the float32 bound: "
              f"bound rel {rel(f32, f_s64.detach()):.2e}, gradient "
              + ", ".join(f"{k} {v:.2e}" for k, v in err_s.items())
              + f"; vs the float64 route (bound {-float(f64):.8g} against {-float(f32):.8g}): "
              f"bound rel {rel(f32, f64):.2e}, gradient "
              + ", ".join(f"{k} {v:.2e}" for k, v in err_64.items())
              + f"; fit {iters} SCG iterations {fit_s:.2f} s, {res.n_evals} evaluations, "
              f"bound {b[0]:.8g} -> {b[-1]:.8g}, noise std "
              f"{float(1.0 / torch.sqrt(P.constrain(res.params)[3].detach())):.4f}")


def phase8_mesh(dev, kernels):
    """8(a): a mesh of MESH_SHARDS shards on the one card at the slice's
    shape, at N and N - 3 (padded): neg_bound_value_and_grad with the mesh
    against the unsharded kernel route on the same inputs, one forward and
    one backward kernel call per shard, the padded rows' latent gradients
    exactly 0, and s/eval of both."""
    import torch
    from gparml_tpu_torch import data
    from gparml_tpu_torch.models import gplvm, params as P
    from gparml_tpu_torch.ops import psi_cuda
    from gparml_tpu_torch.parallel import mesh as mesh_lib

    n0, q, m, d = MESH_SLICE
    cfg = gplvm.GPLVMConfig(q=q, num_inducing=m, stats_impl="auto")
    mesh = mesh_lib.Mesh([dev] * MESH_SHARDS)
    for n in (n0, n0 - 3):
        y_np, _ = data.oil_flow_like(n=n, d=d)
        y = torch.tensor(y_np, dtype=torch.float32, device=dev)
        p = gplvm.init_params(torch.Generator(dev).manual_seed(0), y, cfg)
        ys, mus, uss, w = mesh_lib.shard_data(mesh, y, p.lat.mu.detach(), p.lat.u_s.detach())
        pk = P.GPLVMParams(p.glob, P.LatentParams(mus.gather(), uss.gather()))
        sharded = lambda: gplvm.neg_bound_value_and_grad(pk, ys, cfg, mesh=mesh, weights=w)
        sec_1, (f_1, g_1) = _eval_seconds(gplvm, p, y, cfg)
        psi_cuda.LAUNCHES.update({k: 0 for k in psi_cuda.LAUNCHES})
        f_k, g_k = sharded()
        torch.cuda.synchronize()
        launches = {k: psi_cuda.LAUNCHES[k] for k in ("fwd", "bwd")}
        sec_k = min(_timed(sharded)[0] for _ in range(4))
        rel_f = abs(float(f_k) - float(f_1)) / abs(float(f_1))
        errs = {nm: float(((a[:n] if a.ndim == 2 and a.shape[0] > m else a) - b).abs().max()
                          / b.abs().max().clamp_min(1e-30))
                for (nm, _), a, b in zip(p.named_parameters(), g_k, g_1)}
        pad_nonzero = sum(int(torch.count_nonzero(g[n:])) for g in g_k[4:])
        _require(launches == {"fwd": MESH_SHARDS, "bwd": MESH_SHARDS},
                 f"phase 8(a) N={n}: not one kernel call per shard: {launches}")
        _require(rel_f <= VALUE_RTOL and max(errs.values()) <= GRAD_TOL_F32,
                 f"phase 8(a) N={n} mesh vs unsharded: bound rel {rel_f}, gradients {errs}")
        _require(tuple(g_k[4].shape) == (ys.shape[0], q) and pad_nonzero == 0,
                 f"phase 8(a) N={n}: {pad_nonzero} non-zero gradients in padded rows")
        if n == n0:
            for k in kernels:
                if k["name"] in ("psi_fwd", "psi_bwd"):
                    k["launches_sharded"] = launches[k["name"][4:]]
        print(f"phase 8(a) mesh of {MESH_SHARDS} shards on {dev}, N={n} (padded to "
              f"{ys.shape[0]}) Q={q} M={m} D={d}: sharded {sec_k:.4f} s/eval, unsharded "
              f"{sec_1:.4f} s/eval; launches per evaluation {launches}; bound rel "
              f"{rel_f:.2e}; gradient max abs err of max|ref| "
              + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
              + f"; padded rows' latent gradients non-zero: {pad_nonzero}")
        del y, p, pk, ys, mus, uss, w, g_k, g_1
        torch.cuda.empty_cache()


def _ranks(args, work, tag):
    """``python *args`` as REMOTE_RANKS ranks of a new process group on this
    card (``graft_entry.run_ranks``: every rank is killed once one fails or
    REMOTE_TIMEOUT passes). Returns (their outputs, seconds, ok)."""
    from gparml_tpu_torch.graft_entry import run_ranks

    t0 = time.perf_counter()
    try:
        outs = run_ranks(args, REMOTE_RANKS, work, tag, REMOTE_TIMEOUT)
    except RuntimeError as err:
        _require(False, f"phase {err}")
        return [], time.perf_counter() - t0, False
    return outs, time.perf_counter() - t0, True


def _remote_cli(argv, work, tag):
    """The CLI under -p remote on REMOTE_RANKS ranks of this card: (rank 0's
    summary or None, outputs, seconds); checks the backend printed, both
    ranks' digests of the globals and the summary's agreement flag."""
    outs, sec, ok = _ranks(["-m", "gparml_tpu_torch.cli", "-p", "remote", *argv], work, tag)
    if not ok:
        return None, outs, sec
    summary = json.loads([ln for ln in outs[0].splitlines() if ln.startswith("{")][-1])
    digests = [ln.split()[-1] for o in outs for ln in o.splitlines() if "globals sha256" in ln]
    backends = [ln for o in outs for ln in o.splitlines() if ln.startswith("torch.distributed:")]
    _require(len(backends) == REMOTE_RANKS and all("backend gloo" in b for b in backends),
             f"phase {tag}: backend lines {backends}")
    _require(len(digests) == REMOTE_RANKS and len(set(digests)) == 1
             and summary.get("globals_agree") is True,
             f"phase {tag}: the ranks' globals differ: {digests}, {summary}")
    return summary, outs, sec


def phase8_remote(dev, work):
    """8(b): -p remote on two processes of this card over gloo, through
    ``python -m gparml_tpu_torch.cli`` with torchrun's variables: BASELINE
    config 2 (then a resume) and the slice with --trace-timing. Each run's
    bound at -T 0 --load against -p local on the same checkpoint, both
    ranks' globals bit for bit, both partition files, the backend."""
    from gparml_tpu_torch import data

    n2, d2, q2, m2, iters2, more2 = CONFIG2
    for label, (n, d, q, m, iters), more, extra in (
            ("config 2", (n2, d2, q2, m2, iters2), more2, []),
            ("slice", REMOTE_SLICE, None, ["--trace-timing"])):
        y_np, _ = data.oil_flow_like(n=n, d=d, seed=0)
        folder = os.path.join(work, "remote_" + label.replace(" ", ""))
        stats, emb = os.path.join(folder, "st"), os.path.join(folder, "emb")
        base = ["-i", _write_inputs(folder, y_np), "-e", emb, "-s", stats, "-q", q, "-m", m,
                "--seed", 0, "--device", dev.type]
        s1, outs, sec1 = _remote_cli(base + ["-T", iters, *extra], work, f"8(b) {label} fit")
        if s1 is None:
            continue
        rows = [np.load(os.path.join(emb, f"X_mu_{r}.npy")).shape for r in range(REMOTE_RANKS)]
        _require(rows == [(n // REMOTE_RANKS, q)] * REMOTE_RANKS,
                 f"phase 8(b) {label}: partition files {rows}")
        launches = s1["kernel_launches"]
        _require(launches["fwd"] > 0 and launches["bwd"] > 0,
                 f"phase 8(b) {label}: rank 0 skipped a kernel: {launches}")
        hist = [r for r in _history(stats)]
        per_eval = (sum(r["wall_s"] for r in hist) / max(s1["n_evals"] - 1, 1)
                    if extra else float("nan"))
        text = (f"phase 8(b) {label} -p remote, {REMOTE_RANKS} ranks on one card, N={n} D={d} "
                f"Q={q} M={m} -T {iters}: {sec1:.2f} s, bound {hist[0]['bound']:.6g} -> "
                f"{s1['final_bound']:.6g} ({s1['n_evals']} evaluations"
                + (f", {per_eval:.4f} s/eval from the wall column" if extra else "")
                + f"; the statistics' all_reduce {s1['stats_allreduce_ms']:.3f} ms "
                f"({m * m + m * d + 4} float32)"
                + f"); rank 0's launches {launches}; partition files {rows}; backend "
                f"{s1['backend']}; globals equal bit for bit on both ranks")
        if more:
            s2, _, sec2 = _remote_cli(base + ["-T", more, "--load"], work, f"8(b) {label} resume")
            if s2 is not None:
                _require(s2["final_bound"] >= s1["final_bound"] - 1e-5 * abs(s1["final_bound"]),
                         f"phase 8(b) {label} resume ended below its start: {s1} -> {s2}")
                text += (f"; resume --load -T {more}: {sec2:.2f} s, ends at "
                         f"{s2['final_bound']:.6g}")
        s0, _, sec0 = _remote_cli(base + ["-T", 0, "--load"], work, f"8(b) {label} -T 0")
        local, _, _ = _cli_run(base + ["-T", 0, "--load"])
        if s0 is not None:
            rel = abs(s0["final_bound"] - local["final_bound"]) / abs(local["final_bound"])
            _require(rel <= 1e-5, f"phase 8(b) {label}: -T 0 --load remote "
                     f"{s0['final_bound']} vs local {local['final_bound']}")
            text += (f"; -T 0 --load: remote {s0['final_bound']:.8g} ({sec0:.2f} s), local "
                     f"{local['final_bound']:.8g}, rel {rel:.2e}")
        print(text)


def phase8_sgpr(dev, work):
    """8(c): BASELINE config 1 (SGPR) through -p remote: the learned noise
    std within phase 7(c)'s bounds."""
    import torch
    from gparml_tpu_torch import data
    from gparml_tpu_torch.models import params as P

    n, d, q, m, iters, _, (lo, hi) = SGPR_CLI
    x_np, y_np = data.synthetic_regression(n=n, seed=0)
    folder = os.path.join(work, "remote_sgpr")
    stats, emb = os.path.join(folder, "st"), os.path.join(folder, "emb")
    data.save_embeddings(emb, x_np, np.zeros_like(x_np), CLI_PARTITIONS)
    base = ["-i", _write_inputs(folder, y_np), "-e", emb, "-s", stats, "-m", m,
            "--fixed-embeddings", "--seed", 0, "--device", dev.type]
    s1, _, sec = _remote_cli(base + ["-T", iters], work, "8(c) config 1")
    if s1 is not None:
        with np.load(os.path.join(stats, "checkpoint.npz")) as f:
            g = P.global_from_numpy(P.GlobalArrays(*(f[k] for k in P.GlobalArrays._fields)),
                                    device="cpu")
        noise = float(1.0 / torch.sqrt(P.constrain(g)[3].detach()))
        _require(lo <= noise <= hi, f"phase 8(c) config 1 noise std {noise} outside [{lo}, {hi}]")
        print(f"phase 8(c) BASELINE config 1 -p remote, {REMOTE_RANKS} ranks, N={n} D={d} "
              f"Q={q} M={m} -T {iters}: {sec:.2f} s, bound {s1['final_bound']:.6g} "
              f"({s1['n_evals']} evaluations); noise std {noise:.4f} (true 0.2)")


def _svgp_data(n, seed=0, n_test=0):
    """tools/svgp_bench.py's generator, float32: x ~ U(-2, 2)^(n x Q), W ~
    N(0, 1)^(Q x D), y = tanh(x W) + 0.1 eps; then ``n_test`` fresh points
    and their noise-free targets. Returns (x, y, x_test, f_test)."""
    _, q, d = SVGP_API[:3]
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, (n, q)).astype(np.float32)
    w = rng.standard_normal((q, d)).astype(np.float32)
    y = (np.tanh(x @ w) + 0.1 * rng.standard_normal((n, d))).astype(np.float32)
    x_test = rng.uniform(-2, 2, (n_test, q)).astype(np.float32)
    return x, y, x_test, np.tanh(x_test @ w)


def _svgp_noise(params):
    from gparml_tpu_torch.models import params as P

    return float(P.constrain(params.glob)[3].detach()) ** -0.5


def _svgp_f64_check(dev, p, x, y, n_total, cfg):
    """One ELBO and gradient at the rows (x, y) in float32 on the card
    against float64 on the card, each leaf norm-scaled, within 2x the CPU's
    float32 distance from the same float64 plus SVGP_F64_FLOOR. Returns
    (errors on the card, tolerances)."""
    import torch
    from gparml_tpu_torch.models import svgp

    def run(device, dtype):
        q = svgp.from_leaves([t.detach().to(device, dtype) for t in p.parameters()])
        val = svgp.elbo(q, x.to(device, dtype), y.to(device, dtype), n_total, cfg)
        return [t.detach().double().cpu() for t in
                [val, *torch.autograd.grad(val, list(q.parameters()))]]

    ref = run(dev, torch.float64)
    card, cpu = run(dev, torch.float32), run("cpu", torch.float32)
    names = ["elbo"] + [k for k, _ in p.named_parameters()]
    err = lambda a, b: float(torch.linalg.norm(a - b) / torch.linalg.norm(b).clamp_min(1e-300))
    errs = {k: err(a, b) for k, a, b in zip(names, card, ref)}
    tols = {k: 2.0 * err(a, b) + SVGP_F64_FLOOR for k, a, b in zip(names, cpu, ref)}
    _require(all(errs[k] <= tols[k] for k in names),
             f"phase 9(a) float32 ELBO+gradient vs float64: {errs} against {tols}")
    return errs, tols


def phase9_api(dev):
    """9(a): SVGP through the API at the production shape, nq then qn from
    the same generator; the learned noise, the predictions at fresh points,
    the final ELBO's estimator; one ELBO+gradient against float64; the step
    loop under the sync debug mode. Returns (data, nq params)."""
    import torch
    from gparml_tpu_torch.models import svgp
    from gparml_tpu_torch.ops import psi_cuda

    n, q, d, m, batch, steps, lr = SVGP_API
    x_np, y_np, xt_np, ft = _svgp_data(n, seed=0, n_test=SVGP_TEST_POINTS)
    x = torch.tensor(x_np, device=dev)
    y = torch.tensor(y_np, device=dev)
    runs, inits = {}, {}
    for layout in ("nq", "qn"):
        cfg = svgp.SVGPConfig(num_inducing=m, batch_size=batch, layout=layout)
        xs, ys = (x, y) if layout == "nq" else (x.T.contiguous(), y.T.contiguous())
        p0 = svgp.init_params(torch.Generator(dev).manual_seed(0), xs, ys, cfg)
        svgp.fit(p0, xs, ys, cfg, steps=3, learning_rate=lr)   # warm-up (cuBLAS, cuSOLVER)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        psi_cuda.LAUNCHES.update({k: 0 for k in psi_cuda.LAUNCHES})
        sec, res = _timed(lambda: svgp.fit(p0, xs, ys, cfg, steps=steps, learning_rate=lr,
                                           seed=0))
        launches = dict(psi_cuda.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        with torch.no_grad():
            mean, var = svgp.predict(res.params, torch.tensor(xt_np, device=dev), cfg)
        rmse = float(np.sqrt(np.mean((mean.cpu().numpy() - ft) ** 2)))
        noise = _svgp_noise(res.params)
        lo, hi = SVGP_NOISE
        _require(np.all(np.isfinite(res.history)) and math.isfinite(res.elbo),
                 f"phase 9(a) {layout}: ELBO not finite")
        _require(res.elbo_exact is False and res.elbo_n == 4 * batch,
                 f"phase 9(a) {layout}: final ELBO estimator {res.elbo_exact}, {res.elbo_n}")
        _require(lo <= noise <= hi, f"phase 9(a) {layout}: noise std {noise} outside [{lo}, {hi}]")
        _require(rmse < SVGP_RMSE and bool((var > 0).all()),
                 f"phase 9(a) {layout}: RMSE {rmse}, least variance {float(var.min())}")
        runs[layout], inits[layout] = res, p0
        print(f"phase 9(a) SVGP API {layout} N={n} Q={q} D={d} M={m} batch {batch}, {steps} "
              f"Adam steps at lr {lr}: {sec:.2f} s, {steps / sec:.1f} steps/s (with the "
              f"permutation and the final ELBO); peak {peak / 1e9:.3f} GB "
              f"({(peak - base) / 1e9:.3f} GB above the data); ELBO {res.history[0]:.8g} -> "
              f"{res.history[-1]:.8g}, final {res.elbo:.8g} (exact {res.elbo_exact}, "
              f"{res.elbo_n} rows); noise std {noise:.4f} (true 0.1); RMSE at "
              f"{SVGP_TEST_POINTS} fresh points {rmse:.4f}; least variance "
              f"{float(var.min()):.3e}; kernel launches {launches} (SVGP runs none)")
    h_nq, h_qn = runs["nq"].history, runs["qn"].history
    rel = float(np.max(np.abs(h_qn - h_nq) / np.abs(h_nq)))
    _require(rel <= SVGP_QN_RTOL, f"phase 9(a) qn history vs nq: max rel {rel}")
    print(f"phase 9(a) qn vs nq: history max rel {rel:.3e}, bitwise equal "
          f"{bool(np.array_equal(h_qn, h_nq))}; final ELBO {runs['qn'].elbo:.8g} vs "
          f"{runs['nq'].elbo:.8g}")

    # at the start, where the gradients are O(1): past a few steps the
    # float32 gradient is a difference of nearly equal terms (1e-3..6e-2 of
    # float64 on the CPU after 2000 steps, tools/svgp_rehearsal.py)
    cfg = svgp.SVGPConfig(num_inducing=m, batch_size=batch)
    p = runs["nq"].params
    errs, tols = _svgp_f64_check(dev, inits["nq"], x[:batch], y[:batch], n, cfg)
    print(f"phase 9(a) one ELBO+gradient at the first {batch} rows at the initial "
          f"parameters, float32 on the card vs "
          f"float64 on the card (norm-scaled; tolerance 2x the CPU's float32 + "
          f"{SVGP_F64_FLOOR:g}): " + ", ".join(f"{k} {errs[k]:.2e} ({tols[k]:.2e})"
                                              for k in errs))

    # the step loop alone under the sync debug mode: no host sync may occur
    perm, starts = svgp._draw(torch.Generator().manual_seed(1), n, SVGP_SYNC_STEPS)
    plan = svgp._plan(x, y, [perm], cfg)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    error = None
    try:
        svgp._steps(p, plan, [starts], cfg, lr)
    except RuntimeError as exc:
        error = str(exc).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    _require(error is None, f"phase 9(a) the step loop synchronizes with the card: {error}")
    sec = min(_timed(lambda: svgp._steps(p, plan, [starts], cfg, lr))[0] for _ in range(3))
    print(f"phase 9(a) {SVGP_SYNC_STEPS} steps under set_sync_debug_mode('error'): no sync; "
          f"the loop alone {SVGP_SYNC_STEPS / sec:.1f} steps/s")
    _svgp_profile(lambda: svgp._steps(p, plan, [starts], cfg, lr), SVGP_SYNC_STEPS)
    return x, y, p


def _svgp_profile(run, steps):
    """torch.profiler over ``run`` (``steps`` SVGP steps): the device's busy
    share of the window, its kernels a step and their time, the largest."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per_name = {}
    for e in prof.events():
        # kernels, copies and sets; not the ranges that user annotations
        # (Optimizer.step) draw around them on the device's timeline
        if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation:
            us, count = per_name.get(e.name, (0.0, 0))
            per_name[e.name] = (us + e.time_range.elapsed_us(), count + 1)
    busy = sum(us for us, _ in per_name.values()) / 1e6
    calls = sum(c for _, c in per_name.values())
    top = sorted(((us, c, k) for k, (us, c) in per_name.items()), reverse=True)[:4]
    print(f"phase 9(a) profile of {steps} steps: {wall / steps * 1e3:.3f} ms/step traced, "
          f"device busy {busy / wall:.1%}, {calls / steps:.0f} device calls and "
          f"{busy / steps * 1e3:.3f} device ms a step; largest: " + "; ".join(
              f"{k[:60]} {us / steps:.1f} us x{c / steps:.0f}" for us, c, k in top))


def phase9_mesh(dev, x, y, p):
    """9(b): a mesh of MESH_SHARDS shards on the card at N - 3 (weight-0
    padding): the full-batch elbo_sharded against elbo, and SVGP_MESH_STEPS
    sharded steps against unsharded."""
    import torch
    from gparml_tpu_torch.models import svgp
    from gparml_tpu_torch.parallel import mesh as mesh_lib

    n = SVGP_API[0] - 3
    _, _, _, m, batch, _, lr = SVGP_API
    cfg = svgp.SVGPConfig(num_inducing=m, batch_size=batch)
    x, y = x[:n], y[:n]
    mesh = mesh_lib.Mesh([dev] * MESH_SHARDS)
    ys, xs, w = mesh_lib.shard_data(mesh, y, x)
    with torch.no_grad():
        full = float(svgp.elbo(p, x, y, n, cfg))
        sharded = float(svgp.elbo_sharded(p, xs, ys, cfg, mesh=mesh, weights=w))
    rel = abs(sharded - full) / abs(full)
    _require(rel <= SVGP_MESH_RTOL, f"phase 9(b) elbo_sharded {sharded} vs elbo {full}")
    p0 = svgp.init_params(torch.Generator(dev).manual_seed(0), x, y, cfg)
    sec_1, r1 = _timed(lambda: svgp.fit(p0, x, y, cfg, steps=SVGP_MESH_STEPS, learning_rate=lr))
    sec_k, rk = _timed(lambda: svgp.fit(p0, xs, ys, cfg, steps=SVGP_MESH_STEPS,
                                        learning_rate=lr, mesh=mesh, weights=w))
    b_local = batch // MESH_SHARDS
    _require(np.all(np.isfinite(rk.history)) and rk.elbo_exact is False
             and rk.elbo_n == 4 * b_local * MESH_SHARDS,
             f"phase 9(b) sharded fit: {rk.history[-3:]}, {rk.elbo_exact}, {rk.elbo_n}")
    print(f"phase 9(b) mesh of {MESH_SHARDS} shards on {dev}, N={n} (padded to {ys.shape[0]}): "
          f"full-batch elbo_sharded {sharded:.8g} vs elbo {full:.8g} (rel {rel:.2e}); "
          f"{SVGP_MESH_STEPS} steps sharded {SVGP_MESH_STEPS / sec_k:.1f} steps/s, unsharded "
          f"{SVGP_MESH_STEPS / sec_1:.1f} steps/s; final ELBO sharded {rk.elbo:.8g} "
          f"({rk.elbo_n} rows), unsharded {r1.elbo:.8g}")


def _svgp_folders(work, tag):
    """BASELINE config 1's folders (SGPR_CLI's N) under ``work``."""
    from gparml_tpu_torch import data

    x_np, y_np = data.synthetic_regression(n=SGPR_CLI[0], seed=0)
    folder = os.path.join(work, tag)
    emb = os.path.join(folder, "emb")
    data.save_embeddings(emb, x_np, np.zeros_like(x_np), CLI_PARTITIONS)
    return folder, ["-i", _write_inputs(folder, y_np), "-e", emb, "-m", SGPR_CLI[3],
                    "--fixed-embeddings", "--optimizer", "svgp", "--seed", 0]


def _checkpoint_noise(stats):
    with np.load(os.path.join(stats, "checkpoint.npz")) as f:
        return float(np.exp(-0.5 * f["glob/u_beta"]))


def phase9_cli(dev, work):
    """9(c): --fixed-embeddings --optimizer svgp on BASELINE config 1's
    folders, then a resume, in both layouts."""
    iters, more, batch, lr = SVGP_CLI
    lo, hi = SGPR_CLI[6]
    folder, base = _svgp_folders(work, "svgp")
    for layout in ("nq", "qn"):
        stats = os.path.join(folder, f"st_{layout}")
        argv = base + ["-s", stats, "--batch-size", batch, "--learning-rate", lr,
                       "--layout", layout, "--device", dev.type]
        s1, l1, sec1 = _cli_run(argv + ["-T", iters])
        noise = _checkpoint_noise(stats)
        s2, _, sec2 = _cli_run(argv + ["-T", more, "--load"])
        _require(s1["mode"] == "svgp" and lo <= noise <= hi,
                 f"phase 9(c) {layout}: noise std {noise} outside [{lo}, {hi}]")
        _require(s2["final_elbo"] >= s1["final_elbo"] - SVGP_RESUME_DROP,
                 f"phase 9(c) {layout}: resumed ELBO {s2['final_elbo']} below "
                 f"{s1['final_elbo']} - {SVGP_RESUME_DROP}")
        print(f"phase 9(c) BASELINE config 1 through the CLI, --optimizer svgp --layout "
              f"{layout} -T {iters} --batch-size {batch} --learning-rate {lr}: {sec1:.2f} s, "
              f"final ELBO "
              f"{s1['final_elbo']:.6g} (exact {s1['final_elbo_exact']}); noise std "
              f"{noise:.4f} (true 0.2); launches {l1}; resume --load -T {more}: {sec2:.2f} s, "
              f"ELBO {s2['final_elbo']:.6g}")


def phase9_remote(dev, work):
    """9(d): --optimizer svgp under -p remote on REMOTE_RANKS processes of
    the card, then a resume: the ranks' glob, q_mu and q_sqrt bit for bit
    (``_remote_cli``), the ELBO finite."""
    iters, more = SVGP_REMOTE
    folder, base = _svgp_folders(work, "remote_svgp")
    argv = base + ["-s", os.path.join(folder, "st"), "--batch-size", SVGP_CLI[2],
                   "--learning-rate", SVGP_CLI[3], "--device", dev.type]
    text = f"phase 9(d) --optimizer svgp -p remote, {REMOTE_RANKS} ranks on one card"
    for label, extra in (("fit", ["-T", iters]), ("resume", ["-T", more, "--load"])):
        s, _, sec = _remote_cli(argv + extra, work, f"9(d) svgp {label}")
        if s is None:
            continue
        _require(math.isfinite(s["final_elbo"]) and s["devices"] == REMOTE_RANKS,
                 f"phase 9(d) {label}: {s}")
        text += (f"; {label} {' '.join(map(str, extra))}: {sec:.2f} s, ELBO "
                 f"{s['final_elbo']:.6g}, the data term's all_reduce "
                 f"{s['stats_allreduce_ms']:.3f} ms, replicas equal bit for bit")
    print(text)


def phase10_entry(dev, kernels):
    """10(a): ``graft_entry.entry()`` on the card: one forward and one
    backward kernel call in its evaluation, the value and gradient held
    against the plain engine (float32, and in float64 through a float64
    bound) as phase 4 holds the slice's, and its s/eval."""
    import torch
    from gparml_tpu_torch import graft_entry
    from gparml_tpu_torch.models import gplvm
    from gparml_tpu_torch.ops import psi_cuda

    n, d, q, m = graft_entry.ENTRY_SHAPE
    fn, (p, y) = graft_entry.entry(dev)
    psi_cuda.LAUNCHES.update({k: 0 for k in psi_cuda.LAUNCHES})
    f_k, g_k = fn(p, y)
    torch.cuda.synchronize()
    launches = dict(psi_cuda.LAUNCHES)
    _require(launches == {"fwd": 1, "bwd": 1, "fwd_t": 0, "bwd_t": 0, "fwd_cells": 1,
                          "fwd_cells_t": 0},
             f"phase 10(a) entry(): not one forward (forming the cell sums) and one "
             f"backward kernel call: {launches}")
    for k in kernels:
        if k["name"] in ("psi_fwd_ml128", "psi_bwd_ml128"):
            k["launches_entry"] = launches[k["name"][4:7]]
    cfg = gplvm.GPLVMConfig(q=q, num_inducing=m, stats_impl="auto")
    cfg_x = gplvm.GPLVMConfig(q=q, num_inducing=m, stats_impl="xla")
    f_x, g_x = gplvm.neg_bound_value_and_grad(p, y, cfg_x)
    rel_f, rel_g = _hold_against_plain("phase 10(a) entry()", p, y, cfg, cfg_x, f_k, g_k,
                                       f_x, g_x)
    sec = min(_timed(lambda: fn(p, y))[0] for _ in range(5))
    print(f"phase 10(a) entry() N={n} Q={q} M={m} D={d}: -bound {float(f_k):.8g}, "
          f"{sec:.5f} s/eval; launches {launches}; vs plain f32: bound rel {rel_f:.2e}, "
          f"gradient {rel_g:.2e}")


def _dryrun(label, fn):
    """fn()'s result, or None after recording its failure (the dry runs
    raise RuntimeError on a failed check of their own)."""
    try:
        return fn()
    except RuntimeError as err:
        _require(False, f"phase {label}: {err}")
        return None


def phase10_dryruns(dev, work):
    """10(b): ``dryrun_multichip`` on a mesh of GRAFT_SHARDS shards of the
    card (a GPLVM SCG step, an SGPR SCG iteration and an SVGP step), the
    kernels called for every shard; 10(c): ``dryrun_multihost`` with
    GRAFT_RANKS processes on the card, rank 0's kernel calls."""
    from gparml_tpu_torch import graft_entry
    from gparml_tpu_torch.ops import psi_cuda

    psi_cuda.LAUNCHES.update({k: 0 for k in psi_cuda.LAUNCHES})
    sec, out = _timed(lambda: _dryrun("10(b)", lambda: graft_entry.dryrun_multichip(
        GRAFT_SHARDS, dev)))
    launches = dict(psi_cuda.LAUNCHES)
    _require(launches["fwd"] >= GRAFT_SHARDS and launches["bwd"] >= GRAFT_SHARDS,
             f"phase 10(b) dryrun_multichip({GRAFT_SHARDS}): kernels skipped: {launches}")
    print(f"phase 10(b) dryrun_multichip({GRAFT_SHARDS}) on {dev}: {sec:.2f} s, {out}; "
          f"launches {launches}")
    sec, summary = _timed(lambda: _dryrun("10(c)", lambda: graft_entry.dryrun_multihost(
        GRAFT_RANKS, 1, dev, work=os.path.join(work, "graft_multihost"), timeout=REMOTE_TIMEOUT)))
    if summary is not None:
        launches = summary["kernel_launches"]
        _require(launches["fwd"] > 0 and launches["bwd"] > 0,
                 f"phase 10(c) dryrun_multihost: rank 0 skipped a kernel: {launches}")
        print(f"phase 10(c) dryrun_multihost({GRAFT_RANKS}, 1) on {dev}: {sec:.2f} s, bound "
              f"{summary['final_bound']:.6g}, {summary['devices']} devices, backend "
              f"{summary['backend']}; rank 0's launches {launches}")


def phase10_examples(dev, kernels):
    """10(d): each of EXAMPLES as a subprocess on the card, at its card
    shape; a non-zero exit, or a kernel it should reach left at 0 launches
    in its last line, fails the run. Prints each one's output and puts its
    counts in the kernel table (``launches_examples``)."""
    for script, args, counted in EXAMPLES:
        argv = [sys.executable, os.path.join(ROOT, "examples", "torch", script),
                "--device", dev.type, *map(str, args)]
        t0 = time.perf_counter()
        try:
            res = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True,
                                 timeout=EXAMPLE_TIMEOUT)
        except subprocess.TimeoutExpired:
            _require(False, f"phase 10(d) {script}: past {EXAMPLE_TIMEOUT} s")
            continue
        lines = res.stdout.strip().splitlines()
        _require(res.returncode == 0, f"phase 10(d) {script} exited {res.returncode}:\n"
                 + res.stdout[-2000:] + res.stderr[-3000:])
        try:
            launches = json.loads(lines[-1])["kernel_launches"]
        except (IndexError, ValueError, KeyError):
            launches = {}
        _require(all(launches.get(c, 0) > 0 for c in counted),
                 f"phase 10(d) {script}: kernels skipped, last line {lines[-1:]}")
        for k in kernels:
            for counter, name in counted.items():
                if k["name"] == name:
                    k["launches_examples"] = k.get("launches_examples", 0) + launches.get(counter, 0)
        print(f"phase 10(d) {script} {' '.join(map(str, args))}: {time.perf_counter() - t0:.2f} "
              f"s, exit {res.returncode}: " + " | ".join(lines))


def phase2():
    """Build the kernels; print ptxas's registers and spills and each
    tensor-core kernel's HGMMA instructions (none fails the run)."""
    from gparml_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load()
    print(f"phase 2 build: {time.perf_counter() - t0:.2f} s (nvcc "
          f"{_build.last_build_seconds:.2f} s); ptxas at Q=10, the tensor-core kernels "
          f"at Q=32, 64 and K-chunked: " + ", ".join(
              f"{k} {r} regs {sp} B spilled" for k, (r, sp) in _ptxas(
                  (_build.library_path().parent / "nvcc.log").read_text()).items()))
    # the Psi2 forward, with and without the cell sums, keeps its launch
    # bounds' blocks per SM at every bucket
    texts = []
    for q in (2, 4, 10, 16, 32, 64):
        for cells in (True, False):
            out = (ctypes.c_int * 4)()
            _build.check(_build.load().gparml_psi_fwd_residency(q, cells, out), "fwd_residency")
            blocks, want, regs, local = out
            name = f"psi2_fwd_tc_kernel<{q}, {'true' if cells else 'false'}>"
            texts.append(f"{name} {blocks} blocks ({want} asked), {regs} regs, {local} B local")
            _require(blocks >= want, f"phase 2: {name} keeps {blocks} blocks an SM, its launch "
                     f"bounds ask for {want}")
    print("phase 2 residency: " + "; ".join(texts))
    hgmma = _hgmma_counts(_build.library_path())
    _require(len(hgmma) == TC_KERNELS and min(hgmma.values()) > 0,
             f"phase 2: a tensor-core kernel has no HGMMA in its SASS: {hgmma}")
    print("phase 2 HGMMA instructions in the SASS: " + ", ".join(
        f"{k} {v}" for k, v in sorted(hgmma.items())))


def phase3(dev):
    """Kernel parity in both layouts, the flush case, and the windows'
    times."""
    t0 = time.perf_counter()
    for case in PARITY_CASES:
        for layout in LAYOUTS:
            res = parity_case(*case, layout=layout)
            print(f"phase 3 parity {layout} N={case[0]} M={case[1]} Q={case[2]} "
                  f"D={case[3]} zero-w={case[4]}{' raw alpha' if case[6:7] == (True,) else ''}"
                  f"{f' spread {case[7]}' if case[7:] else ''}: "
                  + " ".join(f"{k}={v:.2e}" for k, v in res.items()))
    for layout in LAYOUTS:
        res = flush_case(*FLUSH_CASE, layout=layout)
        print("phase 3 flush {} N={} M={} Q={} D={} sf2={:g}: ".format(layout, *FLUSH_CASE)
              + " ".join(f"{k}={e:.2e} (plain f32 {e32:.2e})" for k, (e, e32) in res.items()))
    for case in [c for c in PARITY_CASES[10:] if not c[6:]]:
        print("phase 3 times nq N={} M={} Q={} D={}: fwd {:.3f} ms, bwd {:.3f} ms; plain "
              "fwd {:.3f} ms, bwd {:.3f} ms".format(*case[:4], *_window_times(case, dev)))
    import torch

    for n, m, d, layout, buckets in ROUTE_SHAPES:
        for q in buckets:
            fused, alone, rows = _route_times(n, m, q, d, layout, dev)
            floor = lambda k: _tc_floor_ms(k, n, m, q)
            print(f"phase 3 route {layout} N={n} M={m} Q={q} D={d}: psi2_fwd_tc_kernel<{q}, "
                  f"true> {fused:.3f} ms (3-term floor {floor('fwd_cells'):.3f}); "
                  f"psi2_fwd_tc_kernel<{q}, false> {alone:.3f} ms (floor {floor('fwd'):.3f}); "
                  f"psi2_bwd_rows_tc_kernel {rows:.3f} ms (floor {floor('rows'):.3f})")
            torch.cuda.empty_cache()
    print(f"phase 3: {time.perf_counter() - t0:.2f} s")


ALL_PHASES = "34567890"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=ALL_PHASES,
                    help="the phases after the device and the build to run (digits 3-9, "
                         "and 0 for phase 10)")
    run = set(ap.parse_args(argv).phases)
    if not run <= set(ALL_PHASES):
        ap.error(f"--phases takes digits of {ALL_PHASES}")
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

    phase2()
    if "3" in run:
        phase3(dev)

    kernels = []
    if "4" in run:
        t0 = time.perf_counter()
        phase4(dev, kernels)
        print(f"phase 4: {time.perf_counter() - t0:.2f} s")
        torch.cuda.empty_cache()
    p5, t7 = None, 0.0
    if "5" in run:
        t0 = time.perf_counter()
        phase5_small(dev)
        torch.cuda.empty_cache()
        p5 = phase5_config5(dev, kernels)
        print(f"phase 5: {time.perf_counter() - t0:.2f} s")
    if "7" in run and p5 is not None:
        t7 = time.perf_counter()
        phase7_config5(dev, *p5)
        t7 = time.perf_counter() - t7
    del p5

    torch.cuda.empty_cache()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_cli_", dir=os.path.join(ROOT, "build"))
    try:
        if "6" in run:
            t0 = time.perf_counter()
            phase6_config2(dev, work)
            phase6_large(dev, work, kernels)
            torch.cuda.empty_cache()
            phase6_wide_q(dev, work, kernels)
            print(f"phase 6: {time.perf_counter() - t0:.2f} s")
            torch.cuda.empty_cache()
        if "7" in run:
            t0 = time.perf_counter()
            phase7_serving(dev)
            torch.cuda.empty_cache()
            phase7_sgpr(dev, work)
            print(f"phase 7: {time.perf_counter() - t0 + t7:.2f} s")
            torch.cuda.empty_cache()
        if "8" in run:
            t0 = time.perf_counter()
            phase8_mesh(dev, kernels)
            phase8_remote(dev, work)
            phase8_sgpr(dev, work)
            print(f"phase 8: {time.perf_counter() - t0:.2f} s")
            torch.cuda.empty_cache()
        if "9" in run:
            t0 = time.perf_counter()
            x9, y9, p9 = phase9_api(dev)
            phase9_mesh(dev, x9, y9, p9)
            del x9, y9, p9
            torch.cuda.empty_cache()
            phase9_cli(dev, work)
            phase9_remote(dev, work)
            print(f"phase 9: {time.perf_counter() - t0:.2f} s")
            torch.cuda.empty_cache()
        if "0" in run:
            t0 = time.perf_counter()
            phase10_entry(dev, kernels)
            phase10_dryruns(dev, work)
            torch.cuda.empty_cache()
            phase10_examples(dev, kernels)
            print(f"phase 10: {time.perf_counter() - t0:.2f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} checks failed", file=sys.stderr)
        return 1
    if run != set(ALL_PHASES):
        names = ", ".join("10" if c == "0" else c for c in sorted(run, key=ALL_PHASES.index))
        print(f"chip_smoke: phases 1, 2 and {names} passed; failed checks: none")
        return 0
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
