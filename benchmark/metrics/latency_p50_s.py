"""latency_p50_s: median seconds per request, from the entry's call to its
returned AVIF bytes, over every request of the window. Host clock."""

import statistics


def read(win, cell):
    return statistics.median(win.latencies) if win.latencies else None
