"""CPU rehearsal of chip_smoke.py phase 9's SVGP bounds, with the JAX
package and the port side by side (both on the CPU, float32).

(a) For each seed: data from chip_smoke's ``_svgp_data`` at N rows (phase 9
runs N=2e6; the default here is 2e5), M=100, batch 4096, 2000 Adam steps at
lr 1e-2 in each package from its own generator: the learned noise std
(true 0.1), the predictive mean's RMSE against tanh(x W) at 1e4 fresh
points, the least predictive variance, the final ELBO's estimator, and the
seconds. Then, on the port's fitted parameters, one ELBO and gradient at
the first 4096 rows in float32 against float64 (norm-scaled, per leaf): the
CPU's float32 distance that phase 9 doubles for the card.
(c) With --cli, BASELINE config 1's folders through both CLIs
(--fixed-embeddings --optimizer svgp, -T 600 --batch-size 256
--learning-rate LR --seed S, then --load -T 100) in both layouts: the noise
std and both final ELBOs.

Run: python tools/svgp_rehearsal.py [--n 200000] [--seeds 0 1 2]
     [--packages jax port] [--cli [--cli-learning-rate 0.01]]
Prints one JSON line per result.
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _port_fit(seed, x, y, xt, ft, m, batch, steps, lr):
    import torch
    from gparml_tpu_torch.models import params as P, svgp

    cfg = svgp.SVGPConfig(num_inducing=m, batch_size=batch)
    xs, ys = torch.tensor(x), torch.tensor(y)
    t0 = time.perf_counter()
    p0 = svgp.init_params(torch.Generator().manual_seed(seed), xs, ys, cfg)
    res = svgp.fit(p0, xs, ys, cfg, steps=steps, learning_rate=lr, seed=seed)
    sec = time.perf_counter() - t0
    with torch.no_grad():
        mean, var = svgp.predict(res.params, torch.tensor(xt), cfg)
    beta = float(P.constrain(res.params.glob)[3])
    out = dict(package="port", seed=seed, noise_std=beta ** -0.5,
               rmse=float(np.sqrt(np.mean((mean.numpy() - ft) ** 2))),
               min_var=float(var.min()), elbo=res.elbo, elbo_exact=res.elbo_exact,
               elbo_n=res.elbo_n, seconds=sec)
    return out, res.params, cfg


def _jax_fit(seed, x, y, xt, ft, m, batch, steps, lr):
    import jax
    import jax.numpy as jnp
    from gparml_tpu.models import params as P, svgp

    cfg = svgp.SVGPConfig(num_inducing=m, batch_size=batch)
    t0 = time.perf_counter()
    p0 = svgp.init_params(jax.random.key(seed), jnp.asarray(x), jnp.asarray(y), cfg)
    res = svgp.fit(p0, jnp.asarray(x), jnp.asarray(y), cfg, steps=steps, learning_rate=lr,
                   key=jax.random.key(seed))
    elbo = float(res.elbo)
    sec = time.perf_counter() - t0
    mean, var = svgp.predict(res.params, jnp.asarray(xt), cfg)
    beta = float(P.constrain(res.params.glob)[3])
    return dict(package="jax", seed=seed, noise_std=beta ** -0.5,
                rmse=float(np.sqrt(np.mean((np.asarray(mean) - ft) ** 2))),
                min_var=float(np.min(np.asarray(var))), elbo=elbo,
                elbo_exact=bool(res.elbo_exact), elbo_n=int(res.elbo_n), seconds=sec)


def _f32_distance(params, x, y, n_total, cfg):
    """Per-leaf norm-scaled distance of the float32 ELBO and gradient from
    float64 at the given rows (the port on the CPU)."""
    import torch
    from gparml_tpu_torch.models import svgp

    out = {}
    for dt in (torch.float32, torch.float64):
        p = svgp.from_leaves([t.detach().to(dt) for t in params.parameters()])
        val = svgp.elbo(p, torch.tensor(x, dtype=dt), torch.tensor(y, dtype=dt), n_total, cfg)
        out[dt] = [val] + list(torch.autograd.grad(val, list(p.parameters())))
    names = ["elbo"] + [k for k, _ in params.named_parameters()]
    return {k: float(torch.linalg.norm(a.double() - b) / torch.linalg.norm(b))
            for k, a, b in zip(names, out[torch.float32], out[torch.float64])}


def _cli(work, lr, seeds):
    """BASELINE config 1 through both CLIs: fit, then resume."""
    from gparml_tpu import cli as jcli
    from gparml_tpu_torch import cli as tcli
    from gparml_tpu_torch import data

    x, y = data.synthetic_regression(n=1000, seed=0)
    data.save_partitioned(os.path.join(work, "inputs"), y, 4, prefix="Y")
    data.save_embeddings(os.path.join(work, "emb"), x, np.zeros_like(x), 4)
    runs = [(name, main, extra, layout, seed)
            for name, main, extra in (("jax", jcli.main, []),
                                      ("port", tcli.main, ["--device", "cpu"]))
            for layout in ("nq", "qn") for seed in seeds]
    for name, main, extra, layout, seed in runs:
        stats = os.path.join(work, f"{name}_{layout}_{seed}")
        base = ["-i", os.path.join(work, "inputs"), "-e", os.path.join(work, "emb"), "-s",
                stats, "-m", "10", "--fixed-embeddings", "--optimizer", "svgp",
                "--batch-size", "256", "--learning-rate", str(lr), "--seed", str(seed),
                "--layout", layout, *extra]
        s1 = main(base + ["-T", "600"])
        with np.load(os.path.join(stats, "checkpoint.npz")) as f:
            noise = float(np.exp(-0.5 * f["glob/u_beta"]))
        s2 = main(base + ["-T", "100", "--load"])
        print(json.dumps(dict(cli=name, layout=layout, seed=seed, learning_rate=lr,
                              noise_std=noise, elbo=s1["final_elbo"],
                              resumed_elbo=s2["final_elbo"])), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--packages", nargs="+", default=["jax", "port"])
    ap.add_argument("--cli", action="store_true")
    ap.add_argument("--cli-learning-rate", type=float, default=1e-2)
    a = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import chip_smoke

    _, _, _, m, batch, _, lr = chip_smoke.SVGP_API
    for seed in a.seeds:
        x, y, xt, ft = chip_smoke._svgp_data(a.n, seed, chip_smoke.SVGP_TEST_POINTS)
        if "jax" in a.packages:
            print(json.dumps(_jax_fit(seed, x, y, xt, ft, m, batch, a.steps, lr)), flush=True)
        if "port" in a.packages:
            out, params, cfg = _port_fit(seed, x, y, xt, ft, m, batch, a.steps, lr)
            out["f32_vs_f64"] = _f32_distance(params, x[:batch], y[:batch], a.n, cfg)
            print(json.dumps(out), flush=True)
    if a.cli:
        with tempfile.TemporaryDirectory() as work:
            _cli(work, a.cli_learning_rate, a.seeds)


if __name__ == "__main__":
    main()
