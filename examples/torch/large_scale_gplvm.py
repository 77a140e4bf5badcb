"""Large-scale GPLVM bound+gradient timing with the PyTorch port
(BASELINE config 4 shape: N=1e6, Q=10, M=200, D=12; scaled by --n) over a
data mesh of every visible card, through both Psi-statistics engines: the
plain PyTorch engine ("xla", the JAX package's name, in N-blocks of
--block rows) and the hand-written CUDA kernels ("pallas"; on the CPU their
plain versions). The counterpart of examples/large_scale_gplvm.py.

    python examples/torch/large_scale_gplvm.py --n 1000000 --m 200 [--device cpu]
"""

import time

import numpy as np
import torch

import _common
from gparml_tpu_torch.models import gplvm
from gparml_tpu_torch.models import params as P
from gparml_tpu_torch.parallel import mesh as mesh_lib


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def main(argv=None):
    ap = _common.parser(__doc__)
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--d", type=int, default=12)
    ap.add_argument("--q", type=int, default=10)
    ap.add_argument("--m", type=int, default=200)
    ap.add_argument("--block", type=int, default=4000)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    device, dtype = _common.device_and_dtype(args.device)
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    print(f"{max(cards, 1)} device(s): "
          f"{torch.cuda.get_device_name(0) if cards else 'cpu'}, {dtype}")

    rng = np.random.default_rng(0)
    y = rng.standard_normal((args.n, args.d))
    mu = rng.standard_normal((args.n, args.q))
    s = np.full((args.n, args.q), 0.5)
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)
    glob = P.make_global(t(rng.standard_normal((args.m, args.q))), 1.0, np.ones(args.q), 10.0)

    mesh = mesh_lib.make_mesh() if cards > 1 else None
    weights = None
    if mesh is not None:
        y_t, mu_s, s_s, weights = mesh_lib.shard_data(mesh, y, mu, s, dtype=dtype)
        lat = P.make_latents(mu_s.gather(), s_s.gather())
    else:
        y_t, lat = t(y), P.make_latents(t(mu), t(s))
    params = P.GPLVMParams(glob=glob, lat=lat)

    for impl in ("xla", "pallas"):
        # the plain engine's N-block must divide N (a shard's rows under a mesh)
        rows = y_t.shards[0].shape[0] if mesh is not None else args.n
        block = next(b for b in range(min(args.block, rows), 0, -1) if rows % b == 0)
        cfg = gplvm.GPLVMConfig(q=args.q, num_inducing=args.m, block=block, stats_impl=impl)
        f = lambda: gplvm.neg_bound_value_and_grad(params, y_t, cfg, mesh=mesh, weights=weights)
        value = float(f()[0])
        ts = []
        for _ in range(args.reps):
            _sync(device)
            t0 = time.perf_counter()
            value = float(f()[0])
            _sync(device)
            ts.append(time.perf_counter() - t0)
        print(f"{impl:7s}: {min(ts) * 1e3:10.1f} ms / bound+grad eval "
              f"(s/eval {min(ts):.4f}, -bound {value:.6g})")
    _common.print_launches()


if __name__ == "__main__":
    main()
