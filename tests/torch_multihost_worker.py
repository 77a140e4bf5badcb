"""One rank of the port's two-process API check (NOT a test module).

Run as ``python tests/torch_multihost_worker.py OUT_DIR`` with RANK,
WORLD_SIZE, MASTER_ADDR and MASTER_PORT set, one process per rank:
joins a gloo process group on the CPU, takes its own block of rows of a
float64 GPLVM and SGPR problem made from a seed (``problem``), and writes
to OUT_DIR/rank<r>.npz the two-stage gradient of every leaf, the
predictions and inferred latents of the trained statistics, and the
globals and bound history after a short SCG fit. tests/test_torch_multihost.py
holds these against one process.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

N, D, Q, M = 29, 4, 2, 5
FIT_ITERS = 5


def problem():
    """(Y, GPLVM parameter arrays, SGPR X, x_star, y_new) from seed 3."""
    from gparml_tpu_torch.models import params as P

    rng = np.random.default_rng(3)
    y = rng.standard_normal((N, D))
    mu = rng.standard_normal((N, Q))
    u_s = np.log(rng.uniform(0.2, 1.5, (N, Q)))
    glob = P.GlobalArrays(rng.standard_normal((M, Q)), np.log(1.3),
                          np.log(rng.uniform(0.3, 2.0, Q)), np.log(2.1))
    return (y, P.GPLVMArrays(glob, P.LatentArrays(mu, u_s)),
            rng.uniform(-2, 2, (N, Q)), rng.standard_normal((6, Q)),
            rng.standard_normal((3, D)))


def main(out_dir):
    import torch

    from gparml_tpu_torch.models import gplvm, params as P, sgpr
    from gparml_tpu_torch.parallel import distributed

    torch.set_num_threads(1)
    distributed.initialize(device_type="cpu")
    mesh = distributed.global_mesh("cpu")
    y, arrays, x, x_star, y_new = problem()
    start, stop, _ = distributed.process_row_range(N)
    rows = slice(start, min(stop, N))
    ys, mus, uss, xs, w = distributed.shard_data_multihost(
        mesh, N, y[rows], arrays.lat.mu[rows], arrays.lat.u_s[rows], x[rows])
    glob = P.global_from_numpy(arrays.glob, device="cpu", dtype=torch.float64)
    p = P.GPLVMParams(glob, P.LatentParams(mus.gather(), uss.gather()))
    cfg = gplvm.GPLVMConfig(q=Q, num_inducing=M)
    f, grads = gplvm.neg_bound_value_and_grad(p, ys, cfg, mesh=mesh, weights=w)
    scfg = sgpr.SGPRConfig(num_inducing=M)
    f_s, grads_s = sgpr.neg_bound_value_and_grad(glob, xs, ys, scfg, mesh=mesh, weights=w)
    mean, var = gplvm.predict_observed(p, ys, torch.tensor(x_star), cfg, mesh=mesh, weights=w)
    mu_new, _, inferred = gplvm.infer_latents(p, ys, torch.tensor(y_new), cfg, iters=3,
                                              mesh=mesh, weights=w)
    res = gplvm.fit(p, ys, cfg, iters=FIT_ITERS, mesh=mesh, weights=w)
    out = {"f": float(f), "f_sgpr": float(f_s), "mean": mean.detach().numpy(),
           "var": var.detach().numpy(), "mu_new": mu_new.numpy(),
           "infer_history": inferred.history, "history": res.history,
           "rows": np.array([start, stop])}
    out.update({f"grad_{i}": g.numpy() for i, g in enumerate(grads)})
    out.update({f"grad_sgpr_{i}": g.numpy() for i, g in enumerate(grads_s)})
    out.update({f"fit_{i}": t.numpy() for i, t in enumerate(P.leaves(res.params))})
    np.savez(os.path.join(out_dir, f"rank{distributed.process_index()}.npz"), **out)
    distributed.shutdown()


if __name__ == "__main__":
    main(sys.argv[1])
