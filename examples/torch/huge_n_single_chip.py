"""GPLVM training at N=1e7 on one card with the PyTorch port (BASELINE
config 5: N=10^7, M=500): the user-facing recipe of the (Q, N) layout.

``layout='qn'`` with ``y_layout='dn'`` stores every N-sized array
transposed, (Q, N) latents and (D, N) observations, the layout in which
the CUDA kernels' per-row reads coalesce; the data are generated directly
in it. SCG is a host loop (``scg_mode`` is accepted and does nothing). The
counterpart of examples/huge_n_single_chip.py.

Defaults are CI-sized; the card's shape is

    python examples/torch/huge_n_single_chip.py --n 10000000 --m 500 --iters 1

which read 6.20-7.64 s per bound+grad evaluation over three runs (one
SCG iteration, 3 evaluations, the first with its set-up) on an NVIDIA
H100 80GB HBM3 at a 700.00 W power limit (chip_smoke.py phase 10). ``--device cpu``
runs on the CPU, in float64.
"""

import time

import numpy as np
import torch

import _common
from gparml_tpu_torch.models import gplvm
from gparml_tpu_torch.models import params as P


def main(argv=None):
    ap = _common.parser(__doc__)
    ap.add_argument("--n", type=int, default=20_000)
    ap.add_argument("--d", type=int, default=12)
    ap.add_argument("--q", type=int, default=10)
    ap.add_argument("--m", type=int, default=50)
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)
    device, dtype = _common.device_and_dtype(args.device)
    print(f"device: {torch.cuda.get_device_name(0) if device.type == 'cuda' else 'cpu'}")

    # generated on the device, directly in the transposed layout
    gen = torch.Generator(device).manual_seed(0)
    randn = lambda *shape: torch.randn(shape, generator=gen, dtype=dtype, device=device)
    y_t = randn(args.d, args.n)
    mu_t = randn(args.q, args.n)
    u_s_t = torch.full((args.q, args.n), float(np.log(0.5)), dtype=dtype, device=device)
    glob = P.make_global(randn(args.m, args.q), 1.0, np.ones(args.q), 10.0)
    params = P.GPLVMParams(glob=glob, lat=P.LatentParams(mu=mu_t, u_s=u_s_t))
    cfg = gplvm.GPLVMConfig(q=args.q, num_inducing=args.m, layout="qn", y_layout="dn")

    t0 = time.perf_counter()
    res = gplvm.fit(params, y_t, cfg, iters=args.iters)
    bound = float(res.bound)
    wall = time.perf_counter() - t0
    hist = np.asarray(res.history)
    hist = hist[np.isfinite(hist)]
    print(f"N={args.n}: {len(hist)} SCG iterations, {res.n_evals} evaluations in "
          f"{wall:.1f} s ({wall / max(res.n_evals, 1):.3f} s/eval), bound {hist[0]:.1f} -> "
          f"{bound:.1f}, monotone={bool(np.all(np.diff(hist) >= -1e-3 * np.abs(hist[:-1])))}")
    _common.print_launches()


if __name__ == "__main__":
    main()
