"""The program's own spans in a window's ``Trace``.

``gparml_tpu_torch/utils/logging.py`` ``span`` opens them while a profiler
records: host events of the calling thread, on the clock of the device's
events, nested as the calls nest (``gparml.scg.iteration`` holds its
``gparml.eval`` and ``gparml.scg.read`` spans). A program without them
gives no span, and the readers built on these functions give None.
"""

from __future__ import annotations

import numpy as np

EVAL = "gparml.eval"
EVAL_FWD = "gparml.eval.fwd"
EVAL_BWD = "gparml.eval.bwd"
ITERATION = "gparml.scg.iteration"
READ = "gparml.scg.read"
INFER_INIT = "gparml.infer.init"


def of(t, name: str):
    """(starts, ends), ns, of the window's spans ``name``, in order of start."""
    try:
        i = t.names.index(name)
    except ValueError:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
    mask = t.host_name == i
    return t.host_start[mask], t.host_end[mask]


def count(t, name: str) -> int:
    return len(of(t, name)[0])


def total_ms(t, name: str) -> float:
    s, e = of(t, name)
    return float(np.sum(e - s)) / 1e6


def inside_ms(t, outer: str, name: str) -> float:
    """ms of the spans ``name`` that open inside a span ``outer`` (spans
    ``outer`` follow one another on the thread, none inside another)."""
    o_start, o_end = of(t, outer)
    s, e = of(t, name)
    if not len(o_start) or not len(s):
        return 0.0
    k = np.searchsorted(o_start, s, side="right") - 1
    ok = (k >= 0) & (s < o_end[np.maximum(k, 0)])
    return float(np.sum((e - s)[ok])) / 1e6


def self_ms(t, outer: str, children) -> float:
    """ms of the spans ``outer`` less the spans ``children`` inside them."""
    return total_ms(t, outer) - sum(inside_ms(t, outer, c) for c in children)


def per_eval(t, value: float):
    """``value`` over the window's evaluations; None when it holds none."""
    n = count(t, EVAL)
    return value / n if n else None
