"""rmse_levels: the RMS difference, in 8-bit levels, between every file the
window returned, as dav1d decodes it, and the image it was encoded from,
pooled over all their samples: the quality the files keep. Beside
avif_bpp it keeps bytes from being saved by giving up quality. The plain
reference decodes the files after the window closed (Session.check)."""

import math


def read(win, cell):
    return math.sqrt(win.sq_err / win.samples) if win.samples else None
