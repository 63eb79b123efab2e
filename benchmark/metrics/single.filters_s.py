"""single.filters_s: seconds of the port's `device_filters` span (the filter
chain of `ops/device_filters.py`) per image completed in the traced
window of a single stream."""


def read(win, cell):
    done = sum(a.avif is not None for a in win.answers)
    if not win.spans or not done or "device_filters" not in win.spans:
        return None
    return win.spans["device_filters"] / done
