"""allreduces_per_eval.fit_dp (allreduces): rank 0's collectives over the
ranks (``gparml.allreduce.*`` spans: the statistics, the gradients and
value, each of SCG's scalars) over the window's ``gparml.eval`` spans. A
program without those spans gives none."""

from portbench import spans
from portbench.drive.fit_dp import ALLREDUCE_SPANS


def read(r):
    n = sum(spans.count(r.trace, name) for name in ALLREDUCE_SPANS)
    return spans.per_eval(r.trace, n) if n else None
