"""The port's tracer (cavif_tpu_torch/utils/trace.py): spans as records with
ids, parents, requests, threads, wall-clock bounds on the profiler's clock
and thread CPU time; an RGBA encode's alpha spans nested in its root; the
totals of ACCUM; the per-thread cap; the stderr report under
CAVIF_TPU_TRACE; the set-up phases; the filter chain's split
into kernel issue and wait, and its CUDA-event times on the card."""

import contextvars
import dataclasses
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from cavif_tpu_torch import Encoder
from cavif_tpu_torch.testing import device_under_test
from cavif_tpu_torch.tools import bench
from cavif_tpu_torch.utils import trace

ROOT = Path(__file__).resolve().parent.parent
GPU_KEYS = ("gpu_device_filters.deblock", "gpu_device_filters.cdef",
            "gpu_device_filters.lr_stats", "gpu_device_filters.f2")


@pytest.fixture(autouse=True)
def _tracer_off_after():
    """Every test leaves the tracer as the suite found it: off."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    trace.set_accumulate(False)
    trace.set_enabled(False)


@pytest.fixture
def traced():
    trace.set_enabled(True)
    trace.set_accumulate(True)


def _image(size=64, seed=7):
    rng = np.random.default_rng(seed)
    ramp = np.linspace(0, 255, size, dtype=np.float64)
    img = (ramp[None, :, None] * 0.6 + ramp[:, None, None] * 0.3
           + rng.normal(0, 12, (size, size, 3)))
    return np.clip(img, 0, 255).astype(np.uint8)


def _encoder():
    return dataclasses.replace(Encoder.new(), device=device_under_test())


def test_tracing_off_leaves_no_records():
    trace.set_accumulate(True)
    trace.set_enabled(False)
    _encoder().encode_rgb(_image())
    assert trace.records() == []
    assert trace.ACCUM == {}


def test_nested_spans_carry_parent_request_and_thread(traced):
    seen = {}
    both = threading.Barrier(2, timeout=30)  # alive together: two idents

    def work(tag):
        with trace.span("root." + tag):
            with trace.span("child." + tag):
                with trace.span("leaf." + tag):
                    both.wait()
        seen[tag] = threading.get_ident()

    threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    recs = {r.name: r for r in trace.records()}
    assert len(recs) == 6
    for tag in "ab":
        root, child, leaf = (recs[f"{k}.{tag}"]
                             for k in ("root", "child", "leaf"))
        assert root.parent is None and root.request == root.id
        assert child.parent == root.id and child.request == root.id
        assert leaf.parent == child.id and leaf.request == root.id
        assert {root.thread, child.thread, leaf.thread} == {seen[tag]}
        assert root.start_ns <= child.start_ns <= leaf.start_ns
        assert leaf.end_ns <= child.end_ns <= root.end_ns
    assert recs["root.a"].thread != recs["root.b"].thread
    assert recs["root.a"].id != recs["root.b"].id


def test_the_alpha_prep_nests_dirty_alpha_under_the_encode(traced):
    """An RGBA encode's alpha preprocessing is part of the encode: its span
    `alpha.prep` is a child of the root `encode`, `dirty_alpha` a child of
    it, both with the encode's request and inside their parent's bounds;
    the alpha stream follows on a thread of its own, a child of the
    encode."""
    img = _image()
    alpha = np.full(img.shape[:2], 255, np.uint8)
    alpha[16:32, 8:56] = np.random.default_rng(3).integers(0, 255, (16, 48))
    _encoder().encode_rgba(np.dstack([img, alpha]))
    recs = trace.records()
    (enc,) = [r for r in recs if r.name == "encode"]
    (prep,) = [r for r in recs if r.name == "alpha.prep"]
    (dirty,) = [r for r in recs if r.name == "dirty_alpha"]
    (stream,) = [r for r in recs if r.name == "alpha.stream"]
    assert enc.parent is None and enc.request == enc.id
    assert prep.parent == enc.id and prep.request == enc.id
    assert dirty.parent == prep.id and dirty.request == enc.id
    assert stream.parent == enc.id and stream.request == enc.id
    assert enc.start_ns <= prep.start_ns <= dirty.start_ns
    assert dirty.end_ns <= prep.end_ns <= stream.start_ns
    assert stream.end_ns <= enc.end_ns
    assert prep.thread == dirty.thread == enc.thread != stream.thread


def test_a_thread_started_under_a_context_copy_keeps_its_parent(traced):
    out = {}

    def stream():
        with trace.span("stream"):
            out["thread"] = threading.get_ident()

    with trace.span("encode"):
        t = threading.Thread(target=contextvars.copy_context().run,
                             args=(stream,))
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        bare = threading.Thread(target=stream)  # an empty context
        bare.start()
        bare.join(timeout=30)
    recs = trace.records()
    root = next(r for r in recs if r.name == "encode")
    copied, alone = sorted((r for r in recs if r.name == "stream"),
                           key=lambda r: r.start_ns)
    assert copied.parent == root.id and copied.request == root.id
    assert copied.thread != root.thread
    assert alone.parent is None and alone.request == alone.id


def test_cpu_time_never_exceeds_wall_time(traced):
    _encoder().encode_rgb(_image())
    acc = dict(trace.ACCUM)
    names = [k[2:] for k in acc if k.startswith("n_")]
    assert "encode" in names and "tiles_pass1+2" in names
    for name in names:
        assert 0 <= acc["cpu_" + name] <= acc[name], name
    for r in trace.records():
        assert 0 <= r.cpu_ns <= r.end_ns - r.start_ns, r
    encode = [r for r in trace.records() if r.name == "encode"]
    assert len(encode) == 1
    assert {r.request for r in trace.records()} == {encode[0].id}


def test_the_cap_drops_records_and_counts_them(traced, monkeypatch):
    monkeypatch.setattr(trace, "CAP", 5)
    for _ in range(8):
        with trace.span("s"):
            pass
    assert len(trace.records()) == 5
    assert trace.ACCUM["trace.dropped"] == 3
    assert trace.ACCUM["n_s"] == 8  # the totals count every span


def test_concurrent_spans_lose_no_update(traced):
    """More threads than cores, switching as often as the interpreter
    lets them: ACCUM's counts and the records add up."""
    n_threads, per = 16, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(per):
                with trace.span("x"):
                    trace.count("events")

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    recs = trace.records()
    assert trace.ACCUM["n_x"] == trace.ACCUM["events"] == n_threads * per
    assert len(recs) == n_threads * per
    assert len({r.id for r in recs}) == len(recs)


def test_spans_share_the_profiler_s_clock(traced):
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("outer"):
            x.mul_(3)
    rec = next(r for r in trace.records() if r.name == "outer")
    ops = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "aten::mul_"]
    assert ops
    for e in ops:
        assert rec.start_ns <= e.start_ns() <= rec.end_ns


def test_the_environment_switch_prints_the_report():
    code = ("import dataclasses, sys; import numpy as np; "
            "from cavif_tpu_torch import Encoder; "
            "enc = dataclasses.replace(Encoder.new(), device=sys.argv[1]); "
            "rng = np.random.default_rng(3); "
            "enc.encode_rgb(rng.integers(0, 256, (128, 128, 3), np.uint8))")
    env = dict(os.environ, CAVIF_TPU_TRACE="1", OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", code, device_under_test()],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    report = r.stderr[r.stderr.index("[cavif-tpu trace] rgb 128x128"):]
    lines = report.splitlines()
    names = [ln.split()[0] for ln in lines[1:] if ln.startswith("  ")]
    assert "encode" in names and "tiles_pass1+2" in names, report
    assert names[0] == "encode"  # the root span is the longest


def test_the_programmatic_switch_prints_nothing(traced, capsys):
    _encoder().encode_rgb(_image())
    assert "[cavif-tpu trace]" not in capsys.readouterr().err


def test_set_up_phases():
    assert trace.SETUP["setup.import"] > 0
    _encoder().encode_rgb(_image())
    assert "setup.native" in trace.SETUP
    assert all(v >= 0 for v in trace.SETUP.values())


def test_nested_set_up_phases_count_once():
    trace.SETUP.pop("test.outer", None)
    trace.SETUP.pop("test.inner", None)
    with trace.setup("test.outer"):
        with trace.setup("test.inner"):
            sum(range(100000))
    try:
        inner = trace.SETUP["test.inner"]
        assert 0 < inner
        assert 0 <= trace.SETUP["test.outer"] < inner
    finally:
        del trace.SETUP["test.outer"], trace.SETUP["test.inner"]


def test_stage_breakdown_reads_the_accumulated_spans():
    stages = bench.stage_breakdown(_encoder(), _image())
    assert stages["tiles_pass1+2"] > 0 and stages["encode"] > 0
    assert not any(k.startswith(("n_", "cpu_", "gpu_")) for k in stages)
    assert list(stages.values()) == sorted(stages.values(), reverse=True)
    assert not trace.ENABLED and not trace.ACCUM_ENABLED


def _chain_encode(monkeypatch):
    """One traced encode with the filter chain on the device under test
    (forced on: on the CPU its gate leaves it off)."""
    monkeypatch.setenv("CAVIF_TPU_DEVICE_FILTERS", "1")
    enc = _encoder()
    img = _image(256)
    enc.encode_rgb(img)  # first use: programs and constants
    trace.set_enabled(True)
    trace.set_accumulate(True)
    enc.encode_rgb(img)
    return dict(trace.ACCUM)


def test_the_chain_s_issue_and_wait_add_up_to_its_round_trips(monkeypatch):
    """On the CPU here and on the card in the card run: each round trip's
    issue and wait hold 95-100% of it."""
    acc = _chain_encode(monkeypatch)
    for f in ("device_filters.f1", "device_filters.f2"):
        parts = acc[f + ".issue"] + acc[f + ".wait"]
        assert 0.95 * acc[f] <= parts <= acc[f], (f, acc)
        assert acc["n_" + f + ".issue"] == acc["n_" + f + ".wait"] == 1
    recs = {r.name: r for r in trace.records()}
    assert recs["device_filters.f1.issue"].parent == recs[
        "device_filters.f1"].id
    assert recs["device_filters.f1"].parent == recs["device_filters"].id


@pytest.mark.card
def test_the_chain_s_device_time_by_cuda_events(monkeypatch):
    if device_under_test() != "cuda":
        pytest.skip("CUDA events need the card (CAVIF_TORCH_TEST_DEVICE=cuda)")
    acc = _chain_encode(monkeypatch)
    for k in GPU_KEYS:
        assert acc[k] > 0, (k, acc)
    assert "trace.gpu_unread" not in acc
    # the events bound the chain's device work, which the host waits for
    # inside the round trips
    assert sum(acc[k] for k in GPU_KEYS) <= (acc["device_filters.f1"]
                                             + acc["device_filters.f2"])
