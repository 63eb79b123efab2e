"""pool.card_share: the share of the window's completed images whose pass 1
ran on the card, in %: the count of the port's `device_pass1` span
(`n_device_pass1`, traced run) over the images answered. The batch
scheduler (`parallel/batch.py`, hybrid path) sends the rest to the host
cascade."""


def read(win, cell):
    done = sum(a.avif is not None for a in win.answers)
    if not win.spans or not done:
        return None
    return 100.0 * win.spans.get("n_device_pass1", 0) / done
