"""latency_p90_s: the 90th percentile of seconds per request over every
request of the window (statistics.quantiles, inclusive method); with
fewer than 100 requests fewer than ten lie beyond it. Host clock."""

import statistics


def read(win, cell):
    if len(win.latencies) < 2:
        return None
    return statistics.quantiles(win.latencies, n=10, method="inclusive")[8]
