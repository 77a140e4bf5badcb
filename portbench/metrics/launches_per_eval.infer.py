"""launches_per_eval.infer (launches): kernels launched on the device per
objective evaluation of the window's inference calls (SCG's evaluations,
``FitResult.n_evals``, summed over the calls)."""


def read(r):
    evals = r.counters.get("evals")
    return None if not evals else r.trace.launches() / evals
