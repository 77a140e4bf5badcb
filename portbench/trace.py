"""The measured window, and the device trace taken over it.

``Window`` times a window on the host clock between two synchronizations
of the cell's devices. With tracing on, ``torch.profiler`` records host and
device activity over it, and the window is marked by a
``portbench.window`` annotation; ``parse`` reduces the raw events to a
``Trace``: the device's operations (kernels, copies, sets) and the host's
operations on the window's thread, clipped to the window. Per-layer
metrics read from the ``Trace`` (``metrics/``).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

WINDOW = "portbench.window"
_DEVICE = {"kernel": 0, "gpu_memcpy": 1, "gpu_memset": 2}
_HOST = {"cpu_op", "user_annotation"}


def short_name(name: str) -> str:
    """A kernel's name without its return type and parameter list."""
    name = name.split("(")[0].strip()
    return name[5:] if name.startswith("void ") else name


class Trace:
    """Device and host events of one window, on one clock (ns)."""

    def __init__(self, start, end, dev, host):
        self.start, self.end = start, end
        names = sorted({e[0] for e in dev} | {e[0] for e in host})
        index = {n: i for i, n in enumerate(names)}
        self.names = names
        self.dev_name = np.array([index[e[0]] for e in dev], dtype=np.int64)
        self.dev_start = np.array([max(e[1], start) for e in dev], dtype=np.int64)
        self.dev_end = np.array([min(e[2], end) for e in dev], dtype=np.int64)
        self.dev_kind = np.array([e[3] for e in dev], dtype=np.int64)
        order = np.argsort(np.array([e[1] for e in host], dtype=np.int64), kind="stable")
        self.host_name = np.array([index[host[i][0]] for i in order], dtype=np.int64)
        self.host_start = np.array([host[i][1] for i in order], dtype=np.int64)
        self.host_end = np.array([host[i][2] for i in order], dtype=np.int64)
        self._busy = None

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e9

    def busy_intervals(self):
        """The union of the device's operations, as merged (start, end) pairs."""
        if self._busy is None:
            order = np.argsort(self.dev_start, kind="stable")
            merged = []
            for s, e in zip(self.dev_start[order].tolist(), self.dev_end[order].tolist()):
                if e <= s:
                    continue
                if merged and s <= merged[-1][1]:
                    merged[-1][1] = max(merged[-1][1], e)
                else:
                    merged.append([s, e])
            self._busy = merged
        return self._busy

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def kernels(self):
        """Mask of the device events that are kernels."""
        return self.dev_kind == 0

    def seconds_where(self, name_pred) -> float:
        """Device seconds of the kernels whose full name satisfies name_pred."""
        ok = np.array([bool(name_pred(n)) for n in self.names], dtype=bool)
        mask = (ok[self.dev_name] if len(self.dev_name) else np.zeros(0, dtype=bool))
        mask &= self.kernels()
        return float(np.sum(self.dev_end[mask] - self.dev_start[mask])) / 1e9

    def launches(self) -> int:
        return int(np.sum(self.kernels()))

    def top_device_ops(self, k: int = 10):
        """[[short name, seconds], ...]: the device operations that took most time."""
        tot = {}
        for i, s, e in zip(self.dev_name.tolist(), self.dev_start.tolist(), self.dev_end.tolist()):
            key = short_name(self.names[i])
            tot[key] = tot.get(key, 0) + (e - s)
        best = sorted(tot.items(), key=lambda kv: -kv[1])[:k]
        return [[n, v / 1e9] for n, v in best]

    def idle_gaps(self, k: int = 10):
        """[[host operation, seconds], ...]: the device's idle time summed by
        the innermost host operation running at each gap's midpoint (one
        sweep over the host's events, which nest on their thread)."""
        gaps, prev = [], self.start
        for s, e in self.busy_intervals():
            if s > prev:
                gaps.append(((s + prev) // 2, s - prev))
            prev = max(prev, e)
        if self.end > prev:
            gaps.append(((self.end + prev) // 2, self.end - prev))
        gaps.sort()
        starts, ends = self.host_start.tolist(), self.host_end.tolist()
        names = self.host_name.tolist()
        tot, stack, j = {}, [], 0
        for mid, length in gaps:
            while j < len(starts) and starts[j] <= mid:
                while stack and stack[-1][0] < starts[j]:
                    stack.pop()
                stack.append((ends[j], names[j]))
                j += 1
            while stack and stack[-1][0] < mid:
                stack.pop()
            name = self.names[stack[-1][1]] if stack else "(no host op)"
            tot[name] = tot.get(name, 0) + length
        best = sorted(tot.items(), key=lambda kv: -kv[1])[:k]
        return [[n, v / 1e9] for n, v in best]


def _kind(e) -> str:
    """The kineto activity type of a raw event, from its device and name:
    the CUDA build of PyTorch 2.11 that the card runs gives its raw events
    no ``activity_type``."""
    if e.device_type() == torch.autograd.DeviceType.CUDA:
        name = e.name()
        if name == WINDOW:
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    return "user_annotation" if e.name() == WINDOW else "cpu_op"


def parse(events) -> Optional[Trace]:
    """The window's ``Trace`` from the profiler's raw events, or None when
    they hold no window annotation."""
    mark = [e for e in events if e.name() == WINDOW and _kind(e) == "user_annotation"]
    if not mark:
        return None
    start, end, tid = mark[0].start_ns(), mark[0].end_ns(), mark[0].start_thread_id()
    dev, host = [], []
    for e in events:
        at = _kind(e)
        kind = _DEVICE.get(at)
        if kind is not None:
            s, t = e.start_ns(), e.end_ns()
            if t > start and s < end:
                dev.append((e.name(), s, t, kind))
        elif at in _HOST and e.start_thread_id() == tid:
            s, t = e.start_ns(), e.end_ns()
            if t >= start and s <= end and e.name() != WINDOW:
                host.append((e.name(), s, t))
    return Trace(start, end, dev, host)


class Window:
    """``with Window(devices, traced) as w:`` times the block on the host
    clock between synchronizations of ``devices`` (``w.seconds``) and, when
    ``traced``, leaves its ``Trace`` in ``w.trace``."""

    def __init__(self, devices, traced: bool):
        self.devices, self.traced = list(devices), traced
        self.seconds = self.parse_s = None
        self.trace = None
        self._prof = self._mark = None

    def sync(self):
        for d in self.devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    def __enter__(self):
        if self.traced:
            self._prof = _Profiler()
            self._mark = torch.profiler.record_function(WINDOW)
        self.sync()
        if self._mark is not None:
            self._mark.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.sync()
        self.seconds = time.perf_counter() - self._t0
        if self._mark is not None:
            self._mark.__exit__(*exc)
        if self._prof is not None:
            events = self._prof.stop()
            if exc[0] is None:
                t0 = time.perf_counter()
                self.trace = parse(events)
                self.parse_s = time.perf_counter() - t0
            self._prof = None
        return False


class _Profiler:
    """Kineto over host and device activity, started and stopped through
    the profiler's own entry points, whose raw events are read as they are
    (``torch.profiler.profile`` may first turn every event into a Python
    object, minutes for the millions a window of small evaluations makes)."""

    def __init__(self):
        from torch._C._profiler import _ExperimentalConfig
        from torch.autograd import (ProfilerActivity, ProfilerConfig, ProfilerState,
                                    _enable_profiler, _prepare_profiler)
        config = ProfilerConfig(ProfilerState.KINETO, False, False, False, False, False,
                                _ExperimentalConfig())
        activities = {ProfilerActivity.CPU, ProfilerActivity.CUDA}
        _prepare_profiler(config, activities)
        _enable_profiler(config, activities)

    def stop(self):
        from torch.autograd import _disable_profiler
        return _disable_profiler().events()
