"""The reader of kernel.deblock_engaged: the share of the filter chain's F1
round trips whose deblock launched the hand-written CUDA kernel. It reads
its arithmetic from a synthetic window, and nothing where the port has no
F1 span or no such counter (a port whose deblock is plain PyTorch)."""

import pytest

from test_bench_tracing import CHAIN, PARENT, read, win

NAME = "kernel.deblock_engaged"


def test_deblock_kernel_share_of_the_chain_calls():
    # 3 of 4 F1 round trips launched the deblock kernel
    w = win({**CHAIN, "n_device_filters.f1": 4,
             "device_filters.deblock_kernel": 3})
    assert read(NAME, w) == pytest.approx(75.0)
    w = win({**CHAIN, "n_device_filters.f1": 4,
             "device_filters.deblock_kernel": 0})
    assert read(NAME, w) == 0.0


def test_no_deblock_share_without_the_f1_span_or_the_counter():
    # F1 spans but no counter: the deblock ran as plain PyTorch
    assert read(NAME, win({**CHAIN, "n_device_filters.f1": 4})) is None
    assert read(NAME, win({"device_filters.deblock_kernel": 3})) is None


@pytest.mark.parametrize("spans", [PARENT, {}], ids=["parent", "empty"])
def test_no_reading_without_the_spans(spans):
    assert read(NAME, win(spans)) is None
