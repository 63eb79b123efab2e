"""thumbs.alpha_stream_s: seconds of the port's `alpha.stream` span per alpha
stream in the traced window: the monochrome AV1 encode of an RGBA image's
alpha plane (`pipeline.py` `_encode_streams`, on a thread of its own beside
the colour stream: its pass 1, filter chain, tile coder). No reading where
the port has no such span."""


def read(win, cell):
    n = win.spans.get("n_alpha.stream")
    if not n:
        return None
    return win.spans["alpha.stream"] / n
