"""mfu.fit_dp (%): the whole step's share of the cards' peak: the
evaluations' algorithmic float32 operations at the global N
(``work.eval_ops``) times the evaluations the traced window completed, per
second of that window, over the dense TF32 tensor-core peak of all the
ranks' cards. The bound's M x M algebra, which every rank computes, counts
once."""

from portbench.work import eval_ops


def read(r):
    c, peaks = r.counters, r.peaks
    if peaks is None or not c.get("evals") or r.trace.window_s <= 0:
        return None
    rate = eval_ops(c["n"], c["m"], c["q"], c["d"]) * c["evals"] / r.trace.window_s
    return 100.0 * rate / (c["chips"] * peaks["tf32_flops"])
