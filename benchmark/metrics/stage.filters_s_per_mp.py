"""stage.filters_s_per_mp: the port's `device_filters` span (the filter
chain of `ops/device_filters.py`), summed over every thread of the traced
window, per input megapixel completed. Images the batch scheduler sends to
the host cascade run the host filters instead and add nothing here."""


def read(win, cell):
    if not win.spans or not win.pixels:
        return None
    return win.spans.get("device_filters", 0.0) / (win.pixels / 1e6)
