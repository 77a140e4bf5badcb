"""allreduce_ms.fit_dp (ms): rank 0's host time in the collectives over the
ranks, the ``gparml.allreduce.stats``, ``.grad`` and ``.scalar`` spans of
``parallel/distributed.py``, over the window's ``gparml.eval`` spans. Each
span opens once its operands are ready, so it holds the collective and the
wait for the slowest rank, not rank 0's own device work. A program without
those spans gives none."""

from portbench import spans
from portbench.drive.fit_dp import ALLREDUCE_SPANS


def read(r):
    if not sum(spans.count(r.trace, name) for name in ALLREDUCE_SPANS):
        return None
    return spans.per_eval(r.trace, sum(spans.total_ms(r.trace, name) for name in ALLREDUCE_SPANS))
