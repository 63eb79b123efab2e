"""The host readings of each result (`host`) and the harness's steadying
step, on the CPU."""

import gc

import pytest
import run as R
from harness import host

from helpers import args, tiny


@pytest.fixture(scope="module")
def result():
    name = "defaults1mp-single"
    res, _ = R.run(args(name, seconds=1.0), tiny(name, pool=2), device="cpu")
    assert res["correct"]
    return res


def test_the_new_host_readings_are_numbers(result):
    h = result["host"]
    for g in range(3):
        assert isinstance(h[f"gc_count_{g}"], int) and h[f"gc_count_{g}"] >= 0
        assert isinstance(h[f"gc_pause_s_{g}"], (int, float))
        assert h[f"gc_pause_s_{g}"] >= 0
    assert h["gc_frozen"] > 0  # set-up's objects frozen before the window
    assert h["process_cpu_s"] > 0 and h["wall_s"] >= 1.0


def test_the_gc_clock_counts_collections_by_generation():
    clock = host.GcClock()
    clock.start()
    try:
        gc.collect(0)
        gc.collect(2)
    finally:
        clock.stop()
    got = clock.reading()
    assert got["gc_count_0"] >= 1 and got["gc_count_2"] >= 1
    assert got["gc_pause_s_2"] > 0
    assert clock._callback not in gc.callbacks


def test_settle_freezes_what_set_up_left():
    gc.unfreeze()
    try:
        host.settle()
        assert gc.get_freeze_count() > 0
    finally:
        gc.unfreeze()
