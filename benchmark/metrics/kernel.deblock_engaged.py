"""kernel.deblock_engaged: the share of the filter chain's F1 round trips
whose deblock went through the hand-written CUDA kernel
(cavif_tpu_torch/csrc/deblock.cu), in %: the port's counter
`device_filters.deblock_kernel` (counted where the kernel launches,
`ops/device_filters.py` `deblock_pass`, once per frame: at the launch of
the luma apply's horizontal pass) over the count of the chain's
`device_filters.f1` span (`n_device_filters.f1`), traced run. No reading
where the port has no F1 span, or no such counter (its deblock is then
plain PyTorch)."""

COUNTER = "device_filters.deblock_kernel"


def read(win, cell):
    n = win.spans.get("n_device_filters.f1")
    if not n or COUNTER not in win.spans:
        return None
    return 100.0 * win.spans[COUNTER] / n
