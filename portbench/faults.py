"""Faults planted under the timed path, to show that ``correct`` catches
them (``control.py --fault``, ``tests/test_portbench_faults.py``).

- ``unchanged``: every ``gplvm.fit`` call returns the state it was given
  (with the bound and trace its step reported);
- ``unchanged_infer``: every ``gplvm.infer_latents`` call returns the
  nearest-neighbour start it began from, reporting the bound and gradient
  norm there;
- ``half``: the statistics take the first half of the rows at weight 2
  and leave the rest out (the mean over half the batch);
- ``altered``: every ``gplvm.infer_latents`` answer has its latent means
  moved by 0.5 where it is produced;
- ``steepest``: every ``gplvm.fit`` call of k iterations runs as k calls
  of one, so that no conjugate update is made.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

FAULTS = ("unchanged", "unchanged_infer", "half", "altered", "steepest")


def _replacements(name, gplvm) -> dict:
    """{attribute of ``gplvm``: its faulty replacement} of fault ``name``."""
    orig = {a: getattr(gplvm, a) for a in ("fit", "_stats", "infer_latents")}

    def fit_unchanged(p, y, config, *args, **kw):
        return orig["fit"](p, y, config, *args, **kw)._replace(params=p)

    def infer_unchanged(p, y_train, y_new, config, *args, **kw):
        from gparml_tpu_torch.models import params as P

        mu, s, res = orig["infer_latents"](p, y_train, y_new, config, *args, **kw)
        vg, lat0 = gplvm._infer_objective(p, y_train, y_new, config)
        f0, g0 = vg(lat0)
        mu0, s0 = P.constrain_latents(P.LatentParams(*lat0), config.bijector, config.layout)
        gn2 = np.full_like(res.trace["gnorm2"], sum(float(torch.sum(t * t)) for t in g0))
        return mu0, s0, res._replace(bound=-float(f0), trace=dict(res.trace, gnorm2=gn2))

    def stats_half(p, y, config, mesh=None, weights=None, across_processes=True):
        n = y.shape[1] if config.y_layout == "dn" else y.shape[0]
        w = torch.zeros(n, dtype=y.dtype, device=y.device)
        w[: n // 2] = 2.0
        return orig["_stats"](p, y, config, mesh=mesh, weights=w,
                              across_processes=across_processes)

    def infer_altered(*args, **kw):
        mu, s, res = orig["infer_latents"](*args, **kw)
        return mu + 0.5, s, res

    def fit_steepest(p, y, config, iters=100, **kw):
        parts = []
        for _ in range(iters):
            parts.append(orig["fit"](p, y, config, iters=1, **kw))
            p = parts[-1].params
        trace = {k: np.concatenate([r.trace[k] for r in parts]) for k in parts[0].trace}
        return parts[-1]._replace(n_evals=sum(r.n_evals for r in parts),
                                  history=np.concatenate([r.history for r in parts]),
                                  trace=trace)

    return {"unchanged": {"fit": fit_unchanged},
            "unchanged_infer": {"infer_latents": infer_unchanged},
            "half": {"_stats": stats_half},
            "altered": {"infer_latents": infer_altered},
            "steepest": {"fit": fit_steepest}}[name]


@contextlib.contextmanager
def planted(name):
    """Plant fault ``name`` (None: none) in the program for the block."""
    if name is None:
        yield
        return
    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}; options: {', '.join(FAULTS)}")
    from gparml_tpu_torch.models import gplvm

    repl = _replacements(name, gplvm)
    orig = {a: getattr(gplvm, a) for a in repl}
    for a, f in repl.items():
        setattr(gplvm, a, f)
    try:
        yield
    finally:
        for a, f in orig.items():
            setattr(gplvm, a, f)
