"""Structured per-iteration metrics.

Counterpart of ``gparml_tpu/utils/logging.py``: ``write_history`` persists a
per-iteration history as JSONL or CSV, ``iteration_timer`` collects the real
per-iteration wall times that an SCG fit with ``trace_timing=True`` stamps
through ``stamp_iteration``, ``Timer`` times sections, and ``trace`` records
a ``torch.profiler`` trace (the JAX package's ``jax.profiler`` trace). The
port's SCG is a host loop that reads each iteration's scalars back, so a
stamp follows the device work of its iteration.

``span`` marks the host layers of a fit or an inference call in whatever
profiler is recording (``trace``, or any other ``torch.profiler`` session),
on the clock of its device events, and costs a check and a shared no-op
when none is. The spans, each opened where its work happens, so that they
nest on the calling thread:

  * ``gparml.fit``, ``gparml.infer_latents``: one call of
    ``models/gplvm.py`` ``fit`` or ``infer_latents``;
  * ``gparml.infer.init``: ``infer_latents``'s training statistics and
    nearest-neighbour start;
  * ``gparml.scg.iteration``: one iteration of ``opt/scg.py`` ``minimize``;
  * ``gparml.eval``: one objective evaluation (bound and gradient), and in
    it ``gparml.eval.fwd`` (the bound's graph built and its work launched)
    and ``gparml.eval.bwd`` (the wait on ``torch.autograd.grad``, whose
    engine runs the backward of device tensors on a thread of its own);
  * ``gparml.scg.read``: one blocking device-to-host read of an SCG scalar;
  * over a process group (``parallel/distributed.py``):
    ``gparml.allreduce.stats`` and ``gparml.allreduce.grad`` in each
    evaluation, the all_reduce of the statistics and that of the replicated
    gradients and the value, and ``gparml.allreduce.scalar``, each reduction
    of an SCG scalar over the processes.
"""

from __future__ import annotations

import contextlib
import csv
import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch
from torch._C._autograd import _profiler_enabled
from torch._C._profiler import _RecordFunctionFast


def write_history(
    path: str,
    history,
    fmt: Optional[str] = None,
    extra: Optional[Dict] = None,
) -> None:
    """Persist a per-iteration history as JSONL or CSV.

    ``history`` is either a nan-padded (T,) bound array or a dict of named
    (T,) columns (e.g. an SCG trace: bound, gnorm2, lambda, alpha, accepted).
    Rows where the bound is nan (loop already converged) are dropped.
    ``fmt`` defaults from the file extension (.jsonl / .csv)."""
    if not isinstance(history, dict):
        history = {"bound": history}
    cols = {k: np.asarray(v) for k, v in history.items()}
    valid = np.isfinite(cols.get("bound", next(iter(cols.values()))))
    if fmt is None:
        fmt = "csv" if path.endswith(".csv") else "jsonl"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def _py(v):
        return bool(v) if v.dtype == np.bool_ else float(v)

    rows = [
        {"iteration": int(i), **{k: _py(v[i]) for k, v in cols.items()},
         **(extra or {})}
        for i in np.nonzero(valid)[0]
    ]
    if fmt == "csv":
        with open(path, "w", newline="") as f:
            if rows:
                writer = csv.DictWriter(f, fieldnames=list(rows[0]))
                writer.writeheader()
                writer.writerows(rows)
    else:
        with open(path, "w") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")


# The context ``span`` returns while no profiler records: one for every call.
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context that records a host span ``name`` while a profiler records,
    else the shared no-op.

    The check is the profiler's own C++ state, which every way of starting
    one sets (``torch.profiler.profile`` and the low-level
    ``torch.autograd._enable_profiler`` alike). The span is an operator
    scope (``_RecordFunctionFast``), not a user annotation
    (``torch.profiler.record_function``): the profiler copies each user
    annotation onto the device's timeline as well, around the kernels
    launched inside it, and such a copy reads as device work to a reader
    that counts the device's operations."""
    if _profiler_enabled():
        return _RecordFunctionFast(name)
    return _NO_SPAN


# The live iteration_timer instances, innermost last: stamps go to the
# innermost one.
_ACTIVE_TIMERS: list = []


def stamp_iteration(i) -> None:
    """Record that SCG iteration ``i`` ended (-1: the loop started), for the
    innermost live iteration_timer; dropped when none is live."""
    if _ACTIVE_TIMERS:
        _ACTIVE_TIMERS[-1].stamps.append((int(i), time.perf_counter()))


class iteration_timer:
    """Collect real per-iteration wall times from a fit whose optimizer ran
    with ``trace_timing=True``. Usage::

        with logging.iteration_timer() as it:
            result = fit(..., scg_options=SCGOptions(trace_timing=True))
        wall = it.wall_seconds()   # {iteration: seconds}

    The optimizer stamps once at loop entry (iteration -1, after the first
    evaluation) and once per executed iteration; deltas between consecutive
    stamps are the per-iteration wall times."""

    def __init__(self):
        self.stamps: list = []

    def __enter__(self):
        self.stamps = []
        _ACTIVE_TIMERS.append(self)
        return self

    def __exit__(self, *exc):
        if self in _ACTIVE_TIMERS:
            _ACTIVE_TIMERS.remove(self)
        return False

    def wall_seconds(self) -> Dict[int, float]:
        out: Dict[int, float] = {}
        prev_t = None
        for i, t in self.stamps:
            if prev_t is not None and i >= 0:
                out[i] = t - prev_t
            prev_t = t
        return out


class Timer:
    """Wall-clock section timer for fit loops and benchmark harnesses."""

    def __init__(self):
        self.sections: Dict[str, float] = {}
        self._start: Dict[str, float] = {}

    def start(self, name: str):
        self._start[name] = time.perf_counter()

    def stop(self, name: str) -> float:
        dt = time.perf_counter() - self._start.pop(name)
        self.sections[name] = self.sections.get(name, 0.0) + dt
        return dt

    def summary(self) -> Dict[str, float]:
        return dict(self.sections)


@contextlib.contextmanager
def trace(log_dir: str):
    """Context manager: a ``torch.profiler`` trace of the block, the CPU
    and, where PyTorch sees a card, the CUDA activity, written to
    ``log_dir/trace.json`` (Chrome trace format, opens in Perfetto), the
    program's spans (``span``) among its host events.

    Usage::
        with logging.trace('/tmp/trace'):
            fit(...)
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
