"""eval_fwd_ms.infer (ms): host time an evaluation spends building the
bound's graph and launching its work (``gparml.eval.fwd`` spans), over the
window's ``gparml.eval`` spans."""

from portbench import spans


def read(r):
    return spans.per_eval(r.trace, spans.total_ms(r.trace, spans.EVAL_FWD))
