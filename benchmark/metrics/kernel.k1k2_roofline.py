"""kernel.k1k2_roofline: the pass-1 kernels' share of their roofline, in %.

K1 (`csrc/pass1_dir_cost.cu`, the `dir_tc_kernel` template) and K2
(`csrc/pass1_nd_cost.cu`, `nd_cost_kernel`) each launch once per block
shape of a frame. Frames run on the card in the profiled sub-window =
their launches there over the launches of one frame; their work = that
many times the frozen per-frame counts (roofline/k1k2.py) of the cell's
configuration. The least time the card could take is the larger of the
flops over the bf16 tensor-core peak and the bytes over the HBM peak
(roofline/peaks.json); the share is that time over the device time of
those launches in the trace. For the speed-4 shapes the flops bound it
(8.7e12 flops against 1.26e10 bytes per 8K frame). A frame whose launches
the sub-window cuts counts in part, by launches and not by each shape's
work. No launch in the sub-window: no reading.
"""

from roofline import k1k2, peaks

KERNELS = ("dir_tc_kernel", "nd_cost_kernel")


def read(win, cell):
    if win.device is None:
        return None
    n = t = 0
    for name, (count, seconds) in win.device.kernels.items():
        if any(k in name for k in KERNELS):
            n += count
            t += seconds
    if not n or t <= 0:
        return None
    img, p1 = cell.config["image"], cell.config["pass1"]
    shapes = k1k2.shapes(img["height"], img["width"], p1["planes"],
                         p1["max_px"], p1["use_deltas"])
    frames = n / (len(KERNELS) * len(shapes))
    pk = peaks()
    least = max(frames * k1k2.flops(shapes) / pk["bf16_flops_per_s"],
                frames * k1k2.nbytes(shapes) / pk["hbm_bytes_per_s"])
    return 100.0 * least / t
