"""scg_reads_per_eval.infer (reads): SCG's blocking device-to-host reads of
a scalar (``gparml.scg.read`` spans) over the window's evaluations
(``gparml.eval`` spans)."""

from portbench import spans


def read(r):
    return spans.per_eval(r.trace, spans.count(r.trace, spans.READ))
