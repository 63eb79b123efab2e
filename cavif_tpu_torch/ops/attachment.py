"""Attachment capability probe: measured round-trip latency of the
device attachment, recorded once per process.

Several device subsystems are profitable only below an attachment-
latency threshold: a pass-2 wavefront executor's per-scan-step fixed
cost is the attachment's dispatch overhead (host C++ wins through a
slow link, the device wins direct-attached), and the device in-loop
filter chain (ops/device_filters.py) pays two round trips per frame.
Instead of a documented one-off measurement, the decision is a RECORDED
probe: one trivial op's full round trip on the card, timed at first
use, cached for the process and overridable for tests.

The probe reports what it measured; it never picks a device. Without a
CUDA device it times the same op on the CPU and reports backend "cpu",
which engages nothing.
"""

from __future__ import annotations

import time

_PROBE = None


def probe(force: bool = False) -> dict:
    """Measure (once) the attachment's small-op round-trip latency:
    (x + 1) on an int32 tensor of 8, fetched to the host, after one
    warm-up. Returns {"rtt_ms": median of 3, "backend": "cuda" or
    "cpu"}."""
    global _PROBE
    if _PROBE is not None and not force:
        return _PROBE
    import torch

    backend = "cuda" if torch.cuda.is_available() else "cpu"
    x = torch.zeros(8, dtype=torch.int32, device=backend)

    def round_trip():
        y = (x + 1).cpu()
        if backend == "cuda":
            torch.cuda.synchronize()
        return y

    round_trip()  # warm-up: context, allocator, first launch
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        round_trip()
        ts.append(time.perf_counter() - t0)
    _PROBE = {"rtt_ms": round(sorted(ts)[1] * 1e3, 3), "backend": backend}
    return _PROBE


def set_probe(value) -> None:
    """Test/deployment override (None re-arms the measurement)."""
    global _PROBE
    _PROBE = value


def direct_attached(threshold_ms: float = 3.0) -> bool:
    """True when the accelerator behaves like a direct attachment:
    a real (non-CPU) backend whose small-op round trip is below
    `threshold_ms`. A link through a network tunnel measures ~25 ms; a
    PCIe attachment measures well under 1 ms."""
    p = probe()
    return p["backend"] != "cpu" and p["rtt_ms"] < threshold_ms


def engage_device_pass2() -> bool:
    """Auto-engage decision for a device pass-2 wavefront executor: its
    serial scan pays about one dispatch per wavefront level, so it only
    wins when the per-step cost is hardware loop overhead, i.e. a
    sub-millisecond attachment."""
    return direct_attached(threshold_ms=0.5)


def engage_device_filters() -> bool:
    """Auto-engage decision for the device filter chain: two round trips
    plus the device-side stencil work per frame. Through a slow link the
    chain starves the device that pass 1 needs; direct-attached it frees
    the host CPU that the C++ filters take."""
    return direct_attached(threshold_ms=3.0)
