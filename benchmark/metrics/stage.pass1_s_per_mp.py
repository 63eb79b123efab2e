"""stage.pass1_s_per_mp: the port's `device_pass1` span (upload, the pass-1
program, the packed fetch), summed over every thread of the traced
window, per input megapixel completed. Thread-seconds include waiting for
the interpreter lock and the card."""


def read(win, cell):
    if not win.spans or not win.pixels:
        return None
    return win.spans.get("device_pass1", 0.0) / (win.pixels / 1e6)
