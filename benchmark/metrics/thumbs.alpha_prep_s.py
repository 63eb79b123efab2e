"""thumbs.alpha_prep_s: seconds of the port's `alpha.prep` span per call in
the traced window: an RGBA image's alpha preprocessing before its encode
(`pipeline.py` `encode_rgba_pipeline`: the alpha mode's pass over the
colour, `dirty_alpha` for UnassociatedClean, the opaque test and the alpha
plane's conversion). No reading where the port has no such span."""


def read(win, cell):
    n = win.spans.get("n_alpha.prep")
    if not n:
        return None
    return win.spans["alpha.prep"] / n
