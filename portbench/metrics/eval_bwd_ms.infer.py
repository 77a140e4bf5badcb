"""eval_bwd_ms.infer (ms): the time an evaluation's calling thread waits
on ``torch.autograd.grad`` (``gparml.eval.bwd`` spans), whose engine runs
the backward on a thread of its own, over the window's ``gparml.eval``
spans."""

from portbench import spans


def read(r):
    return spans.per_eval(r.trace, spans.total_ms(r.trace, spans.EVAL_BWD))
