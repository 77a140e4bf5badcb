"""infer_init_ms.infer (ms): an inference call's set-up, the training
statistics at N and the nearest-neighbour start (``gparml.infer.init``
spans), over the window's calls (one span each)."""

from portbench import spans


def read(r):
    n = spans.count(r.trace, spans.INFER_INIT)
    if not n or not spans.count(r.trace, spans.EVAL):
        return None
    return spans.total_ms(r.trace, spans.INFER_INIT) / n
