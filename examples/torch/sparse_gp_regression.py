"""Sparse GP regression with the PyTorch port (BASELINE config 1: N=1k,
D=1, M=10).

Fits the hyperparameters and inducing points with SCG and reports the
recovered noise level and the test RMSE. The counterpart of
examples/sparse_gp_regression.py.

    python examples/torch/sparse_gp_regression.py [--device cpu]
"""

import numpy as np
import torch

import _common
from gparml_tpu_torch import data
from gparml_tpu_torch.models import params as P
from gparml_tpu_torch.models import sgpr


def main(argv=None):
    ap = _common.parser(__doc__)
    ap.add_argument("--n", type=int, default=1000)
    ap.add_argument("--iters", type=int, default=200)
    args = ap.parse_args(argv)
    device, dtype = _common.device_and_dtype(args.device)

    x_np, y_np = data.synthetic_regression(n=args.n, noise_std=0.2, seed=0)
    x = torch.tensor(x_np, dtype=dtype, device=device)
    y = torch.tensor(y_np, dtype=dtype, device=device)
    cfg = sgpr.SGPRConfig(num_inducing=10)
    g0 = sgpr.init_params(torch.Generator(device).manual_seed(0), x, y, cfg)
    res = sgpr.fit(g0, x, y, cfg, iters=args.iters)

    hist = np.asarray(res.history)
    hist = hist[np.isfinite(hist)]
    _, _, _, beta = P.constrain(res.params)
    print(f"bound: {hist[0]:.2f} -> {hist[-1]:.2f} "
          f"({int(res.n_evals)} objective evaluations)")
    print(f"learned noise std: {float(1 / torch.sqrt(beta.detach())):.4f} (true 0.2)")

    xs = torch.linspace(-3, 3, 200, dtype=dtype, device=device)[:, None]
    mean, _ = sgpr.predict(res.params, x, y, xs, cfg)
    xs_np = xs.cpu().numpy()
    truth = np.sin(2 * xs_np) + 0.5 * np.sin(5 * xs_np)
    rmse = float(np.sqrt(np.mean((mean.detach().cpu().numpy() - truth) ** 2)))
    print(f"test RMSE vs noiseless truth: {rmse:.4f}")


if __name__ == "__main__":
    main()
