"""Lightweight per-stage tracing for the encode pipeline.

The reference has no tracing at all (SURVEY.md §5.1); this build keeps a
near-zero-cost span registry so the MP/s headline can be broken down per
stage. Enable with CAVIF_TPU_TRACE=1: every `span("name")` accumulates
wall-clock into a thread-local table and `report()` (called by the
pipeline at the end of an encode) prints the breakdown to stderr.

Disabled (the default), `span` is a no-op context manager guarded by one
boolean check.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from contextlib import contextmanager

ENABLED = bool(os.environ.get("CAVIF_TPU_TRACE"))

_tls = threading.local()


def _table():
    t = getattr(_tls, "table", None)
    if t is None:
        t = _tls.table = {}
    return t


ACCUM: dict = {}  # cross-thread span totals (set_accumulate)
_acc_lock = threading.Lock()
ACCUM_ENABLED = False


def set_accumulate(flag: bool) -> None:
    """Also merge every span into a process-global table (batch stage
    breakdowns: the sharded/hybrid pools run encodes on many threads
    whose thread-local tables are otherwise unreachable)."""
    global ACCUM_ENABLED
    ACCUM_ENABLED = bool(flag)
    if flag:
        with _acc_lock:
            ACCUM.clear()


@contextmanager
def span(name: str):
    """Accumulate the wall time of the enclosed block under `name`."""
    if not ENABLED:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        tab = _table()
        tab[name] = tab.get(name, 0.0) + dt
        if ACCUM_ENABLED:
            with _acc_lock:
                ACCUM[name] = ACCUM.get(name, 0.0) + dt
                ACCUM["n_" + name] = ACCUM.get("n_" + name, 0) + 1


def count(name: str, n: int = 1) -> None:
    """Accumulate an event counter into the span table (reported next to
    the timings; e.g. `ec_replay_miss` when the deferred-EC replay cache
    overflowed and a tile re-ran the whole block pipeline)."""
    if not ENABLED:
        return
    tab = _table()
    tab[name] = tab.get(name, 0.0) + n
    if ACCUM_ENABLED:
        with _acc_lock:
            ACCUM[name] = ACCUM.get(name, 0.0) + n


def set_enabled(flag: bool) -> None:
    """Programmatic switch (bench.py uses it to capture one traced encode
    without requiring CAVIF_TPU_TRACE in the parent environment)."""
    global ENABLED
    ENABLED = bool(flag)


def snapshot(clear: bool = True) -> dict:
    """Return (and by default clear) the accumulated span table for the
    calling thread — the programmatic form of report()."""
    tab = dict(_table())
    if clear:
        _table().clear()
    return tab


def reset() -> None:
    if ENABLED:
        _table().clear()


LAST: dict = {}  # most recent report()ed table (bench.py reads it)


def report(label: str = "encode") -> None:
    """Print the accumulated spans (sorted by time) and clear them; the
    table survives in `LAST` for programmatic consumers."""
    if not ENABLED:
        return
    tab = _table()
    if not tab:
        return
    LAST.clear()
    LAST.update(tab)
    total = sum(tab.values())
    lines = [f"[cavif-tpu trace] {label}: {total:.3f}s"]
    for name, dt in sorted(tab.items(), key=lambda kv: -kv[1]):
        lines.append(f"  {name:<22s} {dt:8.3f}s  {100.0 * dt / total:5.1f}%")
    print("\n".join(lines), file=sys.stderr)
    tab.clear()
