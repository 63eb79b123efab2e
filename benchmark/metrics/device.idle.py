"""device.idle: the share of the profiled sub-window, in %, in which no
kernel, copy or fill ran on the card (torch.profiler's CUDA activity,
as a union of intervals). No reading from a trace that lost its kernel
records (copies alone)."""

from harness.devtrace import saw_kernels


def read(win, cell):
    d = win.device
    if d is None or d.window_s <= 0 or not saw_kernels(d):
        return None
    return 100.0 * (1.0 - d.busy_s / d.window_s)
