"""scg_host_ms.fit (ms): the host time of SCG's own loop an evaluation:
the ``gparml.scg.iteration`` spans less the evaluations and blocking reads
inside them, over the window's ``gparml.eval`` spans. The harness finds a
metric's reader by the metric's name, so each cell kind's metric has a
file of its own."""

from portbench import spans


def read(r):
    return spans.per_eval(r.trace, spans.self_ms(r.trace, spans.ITERATION,
                                                 (spans.EVAL, spans.READ)))
