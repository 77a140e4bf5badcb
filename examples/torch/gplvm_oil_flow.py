"""Bayesian GPLVM on an oil-flow-style dataset with the PyTorch port
(BASELINE config 2: N=1k, D=12, Q=10, M=50, SCG to convergence).

The model must separate the three classes in latent space: the
reference's flagship experiment, judged by nearest-neighbour classification
accuracy in the two latent dimensions of largest ARD precision. Two
precisions stand apart from the rest, but after 300 SCG iterations none
falls below 1% of the largest, so all 10 count as effective; the JAX twin
reads the same on the CPU in float64. The counterpart of
examples/gplvm_oil_flow.py.

    python examples/torch/gplvm_oil_flow.py [--device cpu]
"""

import numpy as np
import torch

import _common
from gparml_tpu_torch import data
from gparml_tpu_torch.models import gplvm
from gparml_tpu_torch.models import params as P


def knn_accuracy(x, labels):
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    return float((labels[d2.argmin(1)] == labels).mean())


def main(argv=None):
    ap = _common.parser(__doc__)
    ap.add_argument("--n", type=int, default=1000)
    ap.add_argument("--iters", type=int, default=300)
    args = ap.parse_args(argv)
    device, dtype = _common.device_and_dtype(args.device)

    y_np, labels = data.oil_flow_like(n=args.n, d=12, seed=0)
    y = torch.tensor(y_np, dtype=dtype, device=device)
    cfg = gplvm.GPLVMConfig(q=10, num_inducing=50)
    p0 = gplvm.init_params(torch.Generator(device).manual_seed(0), y, cfg)
    res = gplvm.fit(p0, y, cfg, iters=args.iters)

    hist = np.asarray(res.history)
    hist = hist[np.isfinite(hist)]
    print(f"bound: {hist[0]:.1f} -> {hist[-1]:.1f} "
          f"({int(res.n_evals)} objective evaluations)")

    _, _, alpha, _ = P.constrain(res.params.glob)
    alpha = alpha.detach().cpu().numpy()
    print("ARD precisions (sorted):", np.array2string(np.sort(alpha)[::-1], precision=4))
    print(f"effective latent dims (alpha > 1% of max): {(alpha > 0.01 * alpha.max()).sum()}")

    mu, _ = gplvm.latents(res.params, cfg)
    # class structure in the dominant latent dims
    top = np.argsort(alpha)[::-1][:2]
    acc = knn_accuracy(mu.detach().cpu().numpy()[:, top], labels)
    print(f"1-NN accuracy in top-2 latent dims: {acc:.3f} (chance ~0.33)")
    _common.print_launches()


if __name__ == "__main__":
    main()
