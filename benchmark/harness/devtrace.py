"""The traced run's device trace: `torch.profiler` (CPU and CUDA) over a
steady sub-window of the measured window, reduced in memory to what the
per-layer readers and the result line need.

The profiler is started and stopped by the thread that runs no stream, so
the sub-window falls where the cell's file puts it whatever the length of
one request.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import numpy as np

NAME_CHARS = 160


@dataclass
class DeviceTrace:
    window_s: float  # length of the profiled sub-window
    busy_s: float  # union of device activity in it
    kernels: dict = field(default_factory=dict)  # name: [count, seconds]
    gaps: list = field(default_factory=list)  # [[label, seconds]]


class SpanClock:
    """Between start() and stop(), the port's `span`
    (cavif_tpu_torch.utils.trace) also records each span's name and
    wall-clock start and end in ns, the profiler's clock, so that idle gaps
    can be labelled by the stage the host was in. The port's own
    accounting is unchanged."""

    def __init__(self, trace_module):
        self.mod = trace_module
        self.orig = trace_module.span
        self.rows = []
        self._lock = threading.Lock()

    def start(self) -> None:
        orig, rows, lock = self.orig, self.rows, self._lock

        @contextmanager
        def span(name):
            t0 = time.time_ns()
            try:
                with orig(name):
                    yield
            finally:
                with lock:
                    rows.append((name, t0, time.time_ns()))

        self.mod.span = span

    def stop(self) -> None:
        self.mod.span = self.orig


def warm(cuda: bool) -> None:
    """Start and stop the profiler once around a small device op, so that
    the activity tracer's start-up (seconds on the card) falls in set-up
    and not in the measured window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts):
        x = torch.ones(1024, device="cuda" if cuda else "cpu")
        (x * 2).sum().item()


class SubWindow:
    """Profile from `start_s` after `run` is called for `seconds`, or
    until the measured window's work is done if that comes first."""

    POLL_S = 0.05

    def __init__(self, start_s: float, seconds: float, cuda: bool):
        self.start_s, self.seconds, self.cuda = start_s, seconds, cuda

    def _wait(self, seconds: float, done) -> bool:
        """Sleep `seconds`; True if `done()` came first."""
        end = time.perf_counter() + seconds
        while time.perf_counter() < end:
            if done():
                return True
            time.sleep(min(self.POLL_S, max(0.0, end - time.perf_counter())))
        return False

    def run(self, done):
        """(the profiler's results, the sub-window's start and end in ns of
        the wall clock, the profiler's clock), or None
        where the work was done before it began. Call from the thread that
        runs no stream; reduce the results once the streams have ended, so
        that the reduction takes no time from them."""
        from torch.profiler import ProfilerActivity, profile

        if self._wait(self.start_s, done):
            return None
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        t0 = time.time_ns()
        self._wait(self.seconds, done)
        t1 = time.time_ns()
        prof.stop()
        return prof.profiler.kineto_results, t0, t1


def _union(starts: np.ndarray, ends: np.ndarray):
    """Disjoint, sorted intervals covering the given ones."""
    if starts.size == 0:
        return starts, ends
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], np.maximum.accumulate(ends[order])
    new = np.ones(s.size, bool)
    new[1:] = s[1:] > e[:-1]
    idx = np.flatnonzero(new)
    return s[idx], np.append(e[idx[1:] - 1], e[-1])


def _label(mids, starts, ends, names, fmt, out):
    """Label each gap (by its midpoint `mids`, sorted) that has no label
    in `out` yet with the innermost (shortest) interval containing it."""
    pick = np.full(mids.size, -1)
    for j in np.argsort(ends - starts)[::-1]:  # longest first: inner wins
        lo, hi = np.searchsorted(mids, [starts[j], ends[j]])
        pick[lo:hi] = j
    for g in np.flatnonzero((pick >= 0) & (out == None)):  # noqa: E711
        out[g] = fmt % names[pick[g]]


def reduce(results, t0: int, t1: int, host_spans=()) -> DeviceTrace:
    """Device busy time, kernel totals by name and the idle time by what
    the host was doing, between wall-clock ns `t0` and `t1`, from a
    profiler's in-memory results. Each idle gap is labelled by the
    innermost of the port's spans (`host_spans`: (name, start ns, end ns)
    on the profiler's clock, any thread) that holds its midpoint, else by
    the innermost profiled host op that does."""
    from torch.autograd import DeviceType

    window_s = (t1 - t0) / 1e9
    dev_s, dev_e, cpu_s, cpu_e, cpu_n = [], [], [], [], []
    kernels: dict = {}
    for ev in results.events():
        s = ev.start_ns()
        e = s + ev.duration_ns()
        if ev.device_type() == DeviceType.CUDA:
            s, e = max(s, t0), min(e, t1)
            if e <= s:
                continue
            dev_s.append(s)
            dev_e.append(e)
            name = ev.name()[:NAME_CHARS]
            k = kernels.setdefault(name, [0, 0.0])
            k[0] += 1
            k[1] += (e - s) / 1e9
        elif e > s:
            cpu_s.append(s)
            cpu_e.append(e)
            cpu_n.append(ev.name()[:NAME_CHARS])
    us, ue = _union(np.asarray(dev_s, np.int64), np.asarray(dev_e, np.int64))
    busy = float((ue - us).sum()) / 1e9
    gs = np.append(np.int64(t0), ue)
    ge = np.append(us, np.int64(t1))
    keep = ge > gs
    gs, ge = gs[keep], ge[keep]
    mids = (gs + ge) // 2
    labels = np.full(mids.size, None, dtype=object)
    _label(mids, np.asarray([r[1] for r in host_spans], np.int64),
           np.asarray([r[2] for r in host_spans], np.int64),
           [r[0] for r in host_spans], "host in span %s", labels)
    _label(mids, np.asarray(cpu_s, np.int64), np.asarray(cpu_e, np.int64),
           cpu_n, "host in op %s", labels)
    totals: dict = {}
    for label, dur in zip(labels, (ge - gs) / 1e9):
        key = label or "host outside the port's spans"
        totals[key] = totals.get(key, 0.0) + float(dur)
    gaps = sorted(([k, v] for k, v in totals.items()), key=lambda kv: -kv[1])
    return DeviceTrace(window_s=window_s, busy_s=busy, kernels=kernels,
                       gaps=gaps)


COPIES = ("Memcpy", "Memset")


def saw_kernels(tr: DeviceTrace) -> bool:
    """Whether the trace holds a kernel, not copies and fills alone. Every
    request of every cell launches kernels; a sub-window with copies but
    no kernel has lost its kernel records, and its idle share would read
    the kernels' time as idle."""
    return any(not name.startswith(COPIES) for name in tr.kernels)


def breakdown(tr: DeviceTrace, n: int = 10) -> dict:
    ops = sorted(([k, v[1]] for k, v in tr.kernels.items()),
                 key=lambda kv: -kv[1])
    return {"device_ops": ops[:n], "idle_gaps": tr.gaps[:n]}
