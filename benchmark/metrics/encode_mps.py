"""encode_mps: input megapixels of the encodes completed in the window,
over the window's wall time from its start to the completion of the work
in flight. Host clock."""


def read(win, cell):
    return win.pixels / 1e6 / win.seconds if win.pixels else None
