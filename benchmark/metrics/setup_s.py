"""setup_s: seconds from the start of the run's process (the first line of
run.py) to the first timed request: imports, the card's start, the image
pool, the encoder and the warm-up of the cell's shapes, and in the first
run of a checkout the kernels' builds. Host clock."""


def read(win, cell):
    return win.setup_s
