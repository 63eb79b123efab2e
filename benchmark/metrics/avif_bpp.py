"""avif_bpp: bits of AVIF per input pixel over every file the window
returned: what the files cost to store and to send."""


def read(win, cell):
    return 8.0 * win.avif_bytes / win.pixels if win.pixels else None
