"""The metric arithmetic on synthetic windows, spans and profiler events."""

import statistics
from types import SimpleNamespace

import numpy as np
import pytest
from harness import devtrace, spec
from harness.session import Answer, Window
from roofline import k1k2, peaks
from torch.autograd import DeviceType


def win(**kw):
    base = dict(seconds=10.0, latencies=[1.0, 2.0, 3.0, 4.0],
                answers=[Answer(i, b"x" * 100) for i in range(4)],
                pixels=4_000_000, avif_bytes=400)
    base.update(kw)
    return Window(**base)


def read(name, w, cell=None):
    return spec.reader(name)(w, cell)


def test_rates_and_sizes():
    w = win(pixels=20_000_000, avif_bytes=1_000_000, seconds=8.0)
    assert read("encode_mps", w) == pytest.approx(2.5)
    assert read("avif_bpp", w) == pytest.approx(0.4)
    w.setup_s = 31.5
    assert read("setup_s", w) == 31.5
    assert read("encode_mps", win(pixels=0)) is None


def test_quality_pools_the_squared_error_of_every_file():
    # two files of 100 samples at RMS 3 and 4 levels: sqrt((900+1600)/200)
    w = win(sq_err=9.0 * 100 + 16.0 * 100, samples=200)
    assert read("rmse_levels", w) == pytest.approx(12.5 ** 0.5)
    assert read("rmse_levels", win()) is None  # nothing decoded


def test_latency_percentiles_cover_every_request():
    lat = [float(i) for i in range(1, 101)]
    w = win(latencies=lat)
    assert read("latency_p50_s", w) == pytest.approx(50.5)
    assert read("latency_p90_s", w) == pytest.approx(
        statistics.quantiles(lat, n=10, method="inclusive")[8])
    assert read("latency_p90_s", w) == pytest.approx(90.1)


def test_span_readers():
    spans = {"n_device_pass1": 3, "device_pass1": 0.4,
             "device_filters": 2.0, "tiles_pass1+2": 1.0, "tiles_ec": 0.5,
             "tiles_lr_reserialize": 0.25}
    w = win(spans=spans)
    assert read("pool.card_share", w) == pytest.approx(75.0)
    assert read("stage.pass1_s_per_mp", w) == pytest.approx(0.1)
    assert read("stage.filters_s_per_mp", w) == pytest.approx(0.5)
    assert read("stage.tiles_s_per_mp", w) == pytest.approx(0.4375)
    assert read("single.filters_s", w) == pytest.approx(0.5)
    for name in ("pool.card_share", "stage.pass1_s_per_mp",
                 "single.filters_s"):
        assert read(name, win()) is None  # untraced: no reading


class Ev:
    def __init__(self, name, dev, start, dur):
        self._n, self._d, self._s, self._t = name, dev, start, dur

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._t


class Results:
    def __init__(self, events):
        self.ev = events

    def events(self):
        return self.ev


def test_idle_is_the_complement_of_the_device_union():
    t0, G, C = 1_000, DeviceType.CUDA, DeviceType.CPU
    evs = [Ev("early", G, t0 - 50, 40),  # before the window: left out
           Ev("k1", G, t0 + 100, 200), Ev("k2", G, t0 + 250, 100),  # 100-350
           Ev("copy", G, t0 + 600, 100),  # 600-700
           Ev("late", G, t0 + 950, 200),  # clipped to 950-1000
           Ev("aten::to", C, t0 + 350, 250)]
    spans = [("tiles_ec", t0 + 700, t0 + 950), ("mux", t0 + 0, t0 + 100)]
    tr = devtrace.reduce(Results(evs), t0, t0 + 1000, spans)
    assert tr.busy_s == pytest.approx(400e-9)
    assert tr.kernels["k1"] == [1, pytest.approx(200e-9)]
    assert tr.kernels["late"] == [1, pytest.approx(50e-9)]
    gaps = dict(tr.gaps)
    assert gaps["host in op aten::to"] == pytest.approx(250e-9)
    assert gaps["host in span tiles_ec"] == pytest.approx(250e-9)
    assert gaps["host in span mux"] == pytest.approx(100e-9)
    w = win(device=tr)
    assert read("device.idle", w) == pytest.approx(60.0)
    assert read("single.device_idle", w) == pytest.approx(60.0)
    # copies alone: the kernel records were lost, so no idle share
    lost = devtrace.reduce(Results([Ev("Memcpy DtoH (Device -> Pageable)",
                                       G, t0 + 100, 200)]), t0, t0 + 1000)
    assert lost.busy_s == pytest.approx(200e-9)
    for name in ("device.idle", "single.device_idle",
                 "kernel.k1k2_roofline"):
        assert read(name, win(device=lost)) is None
    b = devtrace.breakdown(tr)
    assert b["device_ops"][0][0] == "k1"
    assert sum(v for _, v in b["idle_gaps"]) == pytest.approx(600e-9)


def test_union_merges_overlaps_and_nesting():
    s, e = devtrace._union(np.array([5, 0, 1, 10]), np.array([6, 4, 2, 12]))
    assert s.tolist() == [0, 5, 10] and e.tolist() == [4, 6, 12]


@pytest.mark.parametrize("h,w", [(1024, 1024), (4320, 7680), (64, 48)])
def test_frozen_counts_equal_the_ports_at_writing(h, w):
    from cavif_tpu_torch.ops import device_pass1 as dp

    H, W = k1k2.program_size(h, w)
    key = (H, W, 10, "ycbcr", 3, 4, 32, True, 23.0, 2.0, 4.0)
    shapes = k1k2.shapes(h, w, 3, 32, True)
    assert len(shapes) == 10
    assert k1k2.flops(shapes) == dp.kernel_flops(key)
    assert k1k2.nbytes(shapes) == dp.kernel_bytes(key)


def test_roofline_share_of_the_named_kernels():
    cfg = {"image": {"height": 1024, "width": 1024},
           "pass1": {"planes": 3, "max_px": 32, "use_deltas": True}}
    cell = SimpleNamespace(config=cfg)
    shapes = k1k2.shapes(1024, 1024, 3, 32, True)
    pk = peaks()
    least = max(k1k2.flops(shapes) / pk["bf16_flops_per_s"],
                k1k2.nbytes(shapes) / pk["hbm_bytes_per_s"])
    # three frames' launches in 2.8 ms each, beside a kernel not counted
    kern = {"void dir_tc_kernel<4, 4, 0, 0>(DirArgs)": [30, 3 * 1.9e-3],
            "void nd_cost_kernel<4>(Args)": [30, 3 * 0.9e-3],
            "void at::native::elementwise_kernel": [500, 1.0]}
    tr = devtrace.DeviceTrace(window_s=1.0, busy_s=0.5, kernels=kern)
    got = read("kernel.k1k2_roofline", win(device=tr), cell)
    assert got == pytest.approx(100.0 * least / 2.8e-3)
    assert 5.0 < got < 15.0
    assert least == k1k2.flops(shapes) / pk["bf16_flops_per_s"]
    tr.kernels = {"void at::native::elementwise_kernel": [5, 1.0]}
    assert read("kernel.k1k2_roofline", win(device=tr), cell) is None
