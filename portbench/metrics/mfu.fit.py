"""mfu.fit (%): the evaluations' algorithmic float32 operations per second
of the traced window, over the dense TF32 tensor-core peak.

The operations of an evaluation are the Psi forward and backward work and
the bound's M x M algebra, counted from the shapes (``work.eval_ops``);
the evaluations are those the window completed, over the window's length,
as the end-to-end rate takes them. It bounds a kernel's gain even after a
later change takes that kernel off the path.
"""

from portbench.work import eval_ops


def read(r):
    c, peaks = r.counters, r.peaks
    if peaks is None or not c.get("evals") or r.trace.window_s <= 0:
        return None
    rate = eval_ops(c["n"], c["m"], c["q"], c["d"]) * c["evals"] / r.trace.window_s
    return 100.0 * rate / peaks["tf32_flops"]
