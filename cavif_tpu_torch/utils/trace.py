"""Per-stage tracing of the encode pipeline: spans as records, set-up phases.

Enable with CAVIF_TPU_TRACE=1 or `set_enabled(True)`. While tracing is on,
every `span(name)` appends one `Record` to its thread's buffer: its id, the
id of the enclosing span (`parent`) and of the enclosing root span
(`request`: the pipeline's `encode` span, one per encode), the thread, the
name, its start and end in ns of the wall clock (the clock of
torch.profiler's events) and the thread's CPU time inside it
(`time.thread_time_ns()`). Both ends come from one clock, the monotonic
one, shifted onto the wall clock by one offset taken when tracing is
turned on, so that a span nested in another starts and ends inside it;
NTP slews the monotonic clock at the wall clock's rate, so the two do not
drift apart over a traced window. The innermost open span lives in a ContextVar,
so a thread started under `contextvars.copy_context()` keeps its parent
and request. A thread keeps at most CAP records; what the cap drops is
counted under `trace.dropped`.

Under `set_accumulate(True)` the records of every thread are kept for
`records()`, and the process-wide `ACCUM` adds up every span: `<name>`
wall seconds, `n_<name>` count, `cpu_<name>` thread-CPU seconds; `count()`
adds counters and `read_marks()` the CUDA-event seconds between `mark()`s
as `gpu_<tag>`. With CAVIF_TPU_TRACE set in the environment, `report()`
(called by the pipeline after each encode) prints the calling thread's
spans since `reset()` to stderr.

Disabled (the default), `span`, `count` and `mark` cost one boolean check.

`SETUP` holds the seconds of the port's one-time set-up phases (`setup.*`:
the import, kernel libraries, the tile coder, the attachment probe, first
program builds), recorded whether tracing is on or not.
"""

from __future__ import annotations

import contextvars
import functools
import itertools
import os
import sys
import threading
import time
from contextlib import contextmanager
from typing import NamedTuple, Optional

_ENV = bool(os.environ.get("CAVIF_TPU_TRACE"))
ENABLED = _ENV
CAP = 65536  # records kept per thread


class Record(NamedTuple):
    id: int
    parent: Optional[int]
    request: int
    thread: int
    name: str
    start_ns: int
    end_ns: int
    cpu_ns: int


ACCUM: dict = {}  # cross-thread totals (set_accumulate)
ACCUM_ENABLED = False
SETUP: dict = {}  # {phase: seconds}, once per process
_lock = threading.Lock()
_tls = threading.local()
_ids = itertools.count(1)
# (id, request) of the innermost open span of the current context
_OPEN: contextvars.ContextVar = contextvars.ContextVar(
    "cavif_trace_open", default=None)
_buffers: list = []  # every thread's record buffer since set_accumulate(True)
_gen = 0  # bumped by set_accumulate(True): threads start new buffers


def _wall_offset() -> int:
    return time.time_ns() - time.monotonic_ns()


# the wall clock less the monotonic one: a record's start is
# time.monotonic_ns() + this
_OFFSET_NS = _wall_offset()


def set_enabled(flag: bool) -> None:
    """Programmatic switch (the drivers and the benchmark trace a window
    without CAVIF_TPU_TRACE in the environment; report() stays silent).
    Turning tracing on takes the wall-clock offset afresh."""
    global ENABLED, _OFFSET_NS
    if flag and not ENABLED:
        _OFFSET_NS = _wall_offset()
    ENABLED = bool(flag)


def set_accumulate(flag: bool) -> None:
    """Keep every thread's records for records() and add every span to
    the process-wide ACCUM (the batch pools run encodes on many threads).
    True starts both afresh."""
    global ACCUM_ENABLED, _gen
    with _lock:
        ACCUM_ENABLED = bool(flag)
        if flag:
            ACCUM.clear()
            _buffers.clear()
            _gen += 1


def _buffer() -> list:
    buf = getattr(_tls, "buf", None)
    if buf is None or _tls.gen != _gen:
        buf = _tls.buf = []
        _tls.gen, _tls.mark, _tls.extra = _gen, 0, {}
        if ACCUM_ENABLED:
            with _lock:
                _buffers.append(buf)
    return buf


def _add(table: dict) -> None:
    """Counters and seconds into this thread's report and, accumulating,
    into ACCUM."""
    _buffer()
    extra = _tls.extra
    for k, v in table.items():
        extra[k] = extra.get(k, 0) + v
    if ACCUM_ENABLED:
        with _lock:
            for k, v in table.items():
                ACCUM[k] = ACCUM.get(k, 0) + v


@contextmanager
def span(name: str):
    """Record the enclosed block as a span `name`."""
    if not ENABLED:
        yield
        return
    outer = _OPEN.get()
    sid = next(_ids)
    request = outer[1] if outer else sid
    token = _OPEN.set((sid, request))
    r0 = time.monotonic_ns()
    c0 = time.thread_time_ns()
    try:
        yield
    finally:
        cpu = time.thread_time_ns() - c0
        wall = time.monotonic_ns() - r0
        # where the thread CPU clock advances in steps (a scheduler tick on
        # some hosts), a short span can read more CPU than wall time; the
        # thread ran at most the span's length
        cpu = min(cpu, wall)
        _OPEN.reset(token)
        buf = _buffer()
        if len(buf) < CAP:
            start = _OFFSET_NS + r0
            buf.append(Record(sid, outer and outer[0], request,
                              threading.get_ident(), name, start,
                              start + wall, cpu))
        else:
            _add({"trace.dropped": 1})
        if ACCUM_ENABLED:
            with _lock:
                ACCUM[name] = ACCUM.get(name, 0.0) + wall / 1e9
                ACCUM["n_" + name] = ACCUM.get("n_" + name, 0) + 1
                ACCUM["cpu_" + name] = (ACCUM.get("cpu_" + name, 0.0)
                                        + cpu / 1e9)


def count(name: str, n: int = 1) -> None:
    """Add an event counter (reported beside the spans; e.g.
    `ec_replay_miss` when the deferred-EC replay cache overflowed and a
    tile re-ran the whole block pipeline)."""
    if ENABLED:
        _add({name: n})


def mark(tag: Optional[str], tensor) -> None:
    """While tracing is on and `tensor` is on a CUDA device, record a
    timing event on its current stream: the device time from this mark to
    the thread's next one is `tag`'s (a mark with tag None only ends the
    one before). read_marks() reads them."""
    if not ENABLED or tensor.device.type != "cuda":
        return
    import torch

    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(tensor.device))
    marks = getattr(_tls, "marks", None)
    if marks is None:
        marks = _tls.marks = []
    marks.append((tag, ev))


def read_marks() -> None:
    """Add the device seconds between this thread's consecutive marks as
    `gpu_<tag>` and forget the marks. Call after the host has waited for
    the last mark's work: it adds no synchronisation, and a pair whose end
    has not completed is not read but counted under `trace.gpu_unread`."""
    marks = getattr(_tls, "marks", None)
    if not marks:
        return
    _tls.marks = []
    got: dict = {}
    for (tag, a), (_, b) in zip(marks, marks[1:]):
        if tag is None:
            continue
        if b.query():
            key = "gpu_" + tag
            got[key] = got.get(key, 0.0) + a.elapsed_time(b) / 1e3
        else:
            got["trace.gpu_unread"] = got.get("trace.gpu_unread", 0) + 1
    if got and ENABLED:
        _add(got)


def records() -> list:
    """Every thread's records since set_accumulate(True), by start."""
    with _lock:
        bufs = list(_buffers)
    return sorted((r for b in bufs for r in list(b)),
                  key=lambda r: r.start_ns)


def reset() -> None:
    """Start the calling thread's report (the pipeline, before an
    encode). Not accumulating, the thread's older records go."""
    if not ENABLED:
        return
    buf = _buffer()
    if not ACCUM_ENABLED:
        buf.clear()
    _tls.mark, _tls.extra = len(buf), {}


def report(label: str = "encode") -> None:
    """Print the calling thread's spans since reset(), by wall time, with
    their CPU seconds, and its counters, to stderr, then start anew. Only
    where CAVIF_TPU_TRACE turned tracing on."""
    if not (ENABLED and _ENV):
        return
    buf = _buffer()
    recs = buf[_tls.mark:]
    if not recs and not _tls.extra:
        return
    wall: dict = {}
    cpu: dict = {}
    for r in recs:
        wall[r.name] = wall.get(r.name, 0.0) + (r.end_ns - r.start_ns) / 1e9
        cpu[r.name] = cpu.get(r.name, 0.0) + r.cpu_ns / 1e9
    total = sum((r.end_ns - r.start_ns) / 1e9 for r in recs
                if r.parent is None) or sum(wall.values())
    lines = [f"[cavif-tpu trace] {label}: {total:.3f}s"]
    for name, dt in sorted(wall.items(), key=lambda kv: -kv[1]):
        share = 100.0 * dt / total if total else 0.0
        lines.append(f"  {name:<24s} {dt:8.3f}s  {share:5.1f}%  "
                     f"cpu {cpu[name]:8.3f}s")
    for name, v in sorted(_tls.extra.items()):
        lines.append(f"  {name:<24s} {v:g}")
    print("\n".join(lines), file=sys.stderr)
    reset()


def walls() -> dict:
    """The wall seconds and counters of ACCUM: its keys without the `n_`,
    `cpu_` and `gpu_` ones."""
    return {k: v for k, v in ACCUM.items()
            if not k.startswith(("n_", "cpu_", "gpu_"))}


# -- set-up phases ------------------------------------------------------------


@contextmanager
def setup(phase: str):
    """Add the enclosed block's seconds to SETUP[phase], less those of
    set-up phases nested inside it on the same thread, so that SETUP's
    phases add up to the time they took."""
    inner = getattr(_tls, "setup_inner", None)
    if inner is None:
        inner = _tls.setup_inner = []
    inner.append(0.0)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        nested = inner.pop()
        if inner:
            inner[-1] += dt
        with _lock:
            SETUP[phase] = SETUP.get(phase, 0.0) + dt - nested


def setup_phase(phase: str):
    """Decorator: each call of the function is set-up phase `phase` (put
    it under an lru_cache, so that only first builds are timed)."""
    def wrap(fn):
        @functools.wraps(fn)
        def timed(*args, **kwargs):
            with setup(phase):
                return fn(*args, **kwargs)
        return timed
    return wrap
