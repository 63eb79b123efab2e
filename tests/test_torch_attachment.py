"""The port's attachment probe (cavif_tpu_torch.ops.attachment): the
recorded round-trip latency that gates the device filter chain, with the
cases of tests/test_attachment.py. The auto gate engages only for a frame
whose pass 1 runs on the card ("cuda"): never for a CPU pass 1 ("cpu") or
the host cascade (None). CAVIF_TPU_DEVICE_FILTERS wins both ways. The batch
paths take the probe before their workers start."""

import threading

import numpy as np
import pytest
import torch

from cavif_tpu_torch.ops import attachment
from cavif_tpu_torch.ops.device_filters import device_filters_enabled


@pytest.fixture(autouse=True)
def _restore():
    old = attachment._PROBE
    yield
    attachment.set_probe(old)


def test_probe_measures_and_caches():
    attachment.set_probe(None)
    p = attachment.probe()
    assert p["rtt_ms"] >= 0
    assert p["backend"] == ("cuda" if torch.cuda.is_available() else "cpu")
    assert attachment.probe() is p  # cached
    assert attachment.probe(force=True) is not p  # re-measured


def test_probe_without_a_card_engages_nothing():
    """A CPU-only process reports backend "cpu", however fast its round
    trip: a report, not a fallback."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    attachment.set_probe(None)
    assert attachment.probe()["backend"] == "cpu"
    assert not attachment.direct_attached(threshold_ms=1e9)
    assert not attachment.engage_device_filters()


@pytest.mark.parametrize("rtt,backend,p2,filt", [
    (0.1, "cuda", True, True),     # direct-attached card
    (1.5, "cuda", False, True),    # fast-ish attachment: filters only
    (25.0, "cuda", False, False),  # slow link: neither
    (0.1, "cpu", False, False),    # no accelerator: neither
])
def test_engage_decisions(rtt, backend, p2, filt):
    attachment.set_probe({"rtt_ms": rtt, "backend": backend})
    assert attachment.engage_device_pass2() == p2
    assert attachment.engage_device_filters() == filt


class _FE:
    _device_search = "cuda"


@pytest.mark.parametrize("dev,auto", [
    ("cuda", True), ("cuda:0", True), ("cpu", False), (None, False),
])
def test_device_filters_auto_gate(monkeypatch, dev, auto):
    fe = _FE()
    fe._device_search = dev
    monkeypatch.delenv("CAVIF_TPU_DEVICE_FILTERS", raising=False)
    attachment.set_probe({"rtt_ms": 25.0, "backend": "cuda"})
    assert not device_filters_enabled(fe)
    attachment.set_probe({"rtt_ms": 0.2, "backend": "cuda"})
    assert device_filters_enabled(fe) == auto
    # env force wins both ways
    monkeypatch.setenv("CAVIF_TPU_DEVICE_FILTERS", "1")
    assert device_filters_enabled(fe)
    for off in ("0", "off", ""):
        monkeypatch.setenv("CAVIF_TPU_DEVICE_FILTERS", off)
        assert not device_filters_enabled(fe)


def test_forced_chain_runs_on_the_card_without_a_cpu_pass1(monkeypatch):
    """A frame whose pass 1 ran on the host (or took injected grids) gets
    the chain on the card when the variable forces it; without a card
    that raises instead of running on the CPU."""
    from cavif_tpu_torch.ops import device_filters as df

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for dev in (None, "inject"):
        fe = _FE()
        fe._device_search = dev
        with pytest.raises(RuntimeError, match="cuda"):
            df._chain_device(fe)
    fe = _FE()
    fe._device_search = "cpu"
    assert df._chain_device(fe) == "cpu"


class _SlowUnderLoad:
    """A probe that measures once, as the real one does, and reads a slow
    round trip (25 ms, over the chain's 3 ms gate) when a list's workers
    already run beside it, and a fast one (0.5 ms) when it runs alone."""

    def __init__(self):
        self.started = threading.Event()  # set by the first worker
        self.measured = []  # (thread, whether a worker had started)

    def __call__(self, force=False):
        if attachment._PROBE is None or force:
            busy = self.started.is_set()
            self.measured.append((threading.current_thread(), busy))
            attachment._PROBE = {"rtt_ms": 25.0 if busy else 0.5,
                                 "backend": "cuda"}
        return attachment._PROBE


@pytest.mark.parametrize("device", [None, "cuda"], ids=["hybrid", "threads"])
def test_encode_batch_probes_before_any_worker_starts(monkeypatch, device):
    """encode_batch on the card takes the attachment probe on the calling
    thread before its pool starts, so a round trip slowed by the list's
    own workers cannot turn the filter chain off: every image of the list
    sees the chain engaged. `None` is the card as a user leaves it (the
    hybrid scheduler), "cuda" the card named (the thread pool)."""
    from dataclasses import replace

    from cavif_tpu_torch import Encoder
    from cavif_tpu_torch.parallel import batch as pbatch

    probe = _SlowUnderLoad()
    monkeypatch.setattr(attachment, "probe", probe)
    attachment.set_probe(None)
    monkeypatch.delenv("CAVIF_TPU_DEVICE_SEARCH", raising=False)
    monkeypatch.delenv("CAVIF_TPU_DEVICE_FILTERS", raising=False)
    engaged = []

    def encode_one(enc, img):
        probe.started.set()
        engaged.append(attachment.engage_device_filters())
        return object()

    monkeypatch.setattr(pbatch, "_encode_one", encode_one)
    images = [np.zeros((8, 8, 3), np.uint8)] * 6
    out = pbatch.encode_batch(images, replace(Encoder.new(), device=device),
                              max_workers=3)
    assert all(r.error is None for r in out)
    assert probe.measured == [(threading.current_thread(), False)]
    assert engaged == [True] * len(images)


def test_encode_batch_sharded_probes_before_its_preparation(monkeypatch):
    """The sharded batch on the card takes the probe before it prepares a
    single image or starts its pool."""
    from cavif_tpu_torch import Encoder, pipeline
    from cavif_tpu_torch.parallel import batch as pbatch

    class Stop(Exception):
        pass

    seen = []

    def probe(force=False):
        seen.append("probe")
        raise Stop

    monkeypatch.setattr(attachment, "probe", probe)
    monkeypatch.setattr(pipeline, "prepare_alpha",
                        lambda *a: seen.append("prep"))
    rgba = np.full((8, 8, 4), 7, np.uint8)
    with pytest.raises(Stop):
        pbatch.encode_batch_sharded([rgba, rgba], Encoder.new())
    assert seen == ["probe"]
