"""stage.tiles_s_per_mp: the host tile coder's spans (`tiles_pass1+2`,
`tiles_ec`, `tiles_lr_reserialize`: `native/tilecoder.cpp` driven from
`av1/encoder.py`), summed over every thread of the traced window, per
input megapixel completed."""

SPANS = ("tiles_pass1+2", "tiles_ec", "tiles_lr_reserialize")


def read(win, cell):
    if not win.spans or not win.pixels:
        return None
    return sum(win.spans.get(s, 0.0) for s in SPANS) / (win.pixels / 1e6)
