"""thumbs.card_share: the share of the window's completed images whose colour
pass 1 ran on the card, in %: the count of the port's `device_pass1` span
(`n_device_pass1`) less its counter `device_pass1.mono` (the alpha planes'
frames among them, `av1/encoder.py`), over the images answered, traced run.
The batch scheduler (`parallel/batch.py`, hybrid path) sends the rest to the
host cascade. `pool.card_share` counts an RGBA image's alpha frame as an
image of its own. No reading where the port has no such counter."""

COUNTER = "device_pass1.mono"


def read(win, cell):
    done = sum(a.avif is not None for a in win.answers)
    if not done or COUNTER not in win.spans:
        return None
    colour = win.spans.get("n_device_pass1", 0) - win.spans[COUNTER]
    return 100.0 * colour / done
