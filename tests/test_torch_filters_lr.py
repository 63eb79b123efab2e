"""The port's device loop restoration and filter chain
(cavif_tpu_torch.ops.device_filters) on the CPU, held EXACTLY against the
port's native C++ (native.lr_wiener_plane / lr_sgr_plane, the host encoder
chain) and against the JAX package's device functions on the same inputs.

The Wiener and SGR cases are those of tests/test_device_filters.py. The
encodes hold the whole AVIF byte for byte with the chain forced on
(CAVIF_TPU_DEVICE_FILTERS=1, pass 1 and the chain on the CPU) against the
host C++ chain (=0). Tolerance everywhere: none."""

import dataclasses

import numpy as np
import pytest

from cavif_tpu.av1.config import AV1Config as RefAV1Config
from cavif_tpu.av1.encoder import FrameEncoder as RefFrameEncoder
from cavif_tpu.av1.speed import SpeedTweaks as RefSpeedTweaks
from cavif_tpu.ops import device_filters as ref_df
from cavif_tpu_torch import Encoder, native
from cavif_tpu_torch.av1.config import AV1Config
from cavif_tpu_torch.av1.encoder import FrameEncoder
from cavif_tpu_torch.av1.speed import SpeedTweaks
from cavif_tpu_torch.ops import device_filters as df


def _lr_content(h, w, seed, amp=30):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    base = 400 + 300 * np.sin(xx / 31.0) * np.cos(yy / 41.0)
    src = np.clip(base + rng.normal(0, amp, (h, w)), 0, 1023)
    rec = np.clip(src + rng.normal(0, amp / 2, (h, w)), 0, 1023)
    return src.astype(np.int32), rec.astype(np.int32)


def _grid(h, w, u=256):
    return max((h + u // 2) // u, 1), max((w + u // 2) // u, 1)


def _same_results(names, host, dev, ref):
    for name, a, b, c in zip(names, host, dev, ref):
        a, b, c = np.asarray(a), np.asarray(b), np.asarray(c)
        assert np.array_equal(a, b), (name, "native", a, b)
        assert b.dtype == c.dtype and np.array_equal(b, c), (name, "jax")


@pytest.mark.parametrize("dims,ntaps,mu,seed", [
    ((300, 300), 3, 0.0, 1),
    ((256, 512), 3, 0.1, 2),
    ((130, 270), 2, 0.0, 3),
    ((384, 384), 2, 0.1, 4),
    ((100, 100), 3, 0.0, 5),   # single unit absorbing everything
])
def test_wiener_matches_native_and_reference(dims, ntaps, mu, seed):
    """Gram-path Wiener must reproduce the C++ per-unit decisions,
    taps, SSE/base and variance stats exactly."""
    h, w = dims
    src, rec = _lr_content(h, w, seed)
    rows, cols = _grid(h, w)
    margin = 2.0 * 30.0 * 40.0
    host = native.lr_wiener_plane(
        src, rec, h, w, 256, rows, cols, ntaps=ntaps, margin=margin,
        n_threads=2, want_var=True, mu=mu,
    )
    args = (src, rec, h, w, 256, rows, cols, ntaps, margin)
    dev = df.lr_wiener_plane_device(*args, want_var=True, mu=mu,
                                    device="cpu")
    ref = ref_df.lr_wiener_plane_device(*args, want_var=True, mu=mu)
    _same_results(("use", "taps", "sse", "base", "var"), host, dev, ref)


@pytest.mark.parametrize("dims,tier,mu,seed", [
    ((300, 300), 2, 0.0, 1),
    ((256, 512), 0, 0.0, 2),
    ((384, 300), 1, 0.0, 3),
    ((300, 384), 2, 0.1, 4),
    ((100, 100), 1, 0.1, 5),
])
def test_sgr_matches_native_and_reference(dims, tier, mu, seed):
    """Device SGR (passes + moments + exact SSE) must reproduce the C++
    per-unit set/weights/SSE/variance exactly."""
    h, w = dims
    src, rec = _lr_content(h, w, seed, amp=35)
    rows, cols = _grid(h, w)
    host = native.lr_sgr_plane(
        src, rec, h, w, 256, rows, cols, 10, tier, n_threads=2,
        want_var=True, mu=mu,
    )
    args = (src, rec, h, w, 256, rows, cols, 10, tier)
    dev = df.lr_sgr_plane_device(*args, want_var=True, mu=mu,
                                 device="cpu")
    ref = ref_df.lr_sgr_plane_device(*args, want_var=True, mu=mu)
    _same_results(("set", "xqd", "sse", "var"), host, dev, ref)


def _chain_on_off(monkeypatch, enc, img):
    monkeypatch.setenv("CAVIF_TPU_DEVICE_FILTERS", "0")
    a = enc.encode_rgb(img).avif_file
    ran = []
    real = df.run_filter_chain

    def counted(fe):
        out = real(fe)
        ran.append(out is not None)
        return out

    monkeypatch.setattr(df, "run_filter_chain", counted)
    monkeypatch.setenv("CAVIF_TPU_DEVICE_FILTERS", "1")
    b = enc.encode_rgb(img).avif_file
    assert ran and all(ran), ran  # the chain ran and did not give way
    return a, b


def test_filter_chain_end_to_end_byte_identity(monkeypatch):
    """Full encode with the device filter chain (forced on, on the CPU)
    must produce the same AVIF bytes as the host C++ chain."""
    rng = np.random.default_rng(3)
    grad = np.mgrid[0:192, 0:224][0].astype(np.float64) * 1.3
    img = np.clip(
        grad[..., None] + rng.normal(0, 25, (192, 224, 3)) + 80, 0, 255
    ).astype(np.uint8)
    enc = dataclasses.replace(Encoder.new().with_quality(70).with_speed(4),
                              device="cpu")
    a, b = _chain_on_off(monkeypatch, enc, img)
    assert a == b


def test_filter_chain_tune_ssim_byte_identity(monkeypatch):
    """Same identity under tune=ssim (the psy-LR mu>0 path exercises
    the Gram-based gamma rescale and variance-penalized selection)."""
    rng = np.random.default_rng(9)
    img = np.clip(
        rng.normal(128, 40, (160, 160, 3)), 0, 255
    ).astype(np.uint8)
    enc = dataclasses.replace(
        Encoder.new().with_quality(85).with_speed(4).with_tune("ssim"),
        device="cpu",
    )
    a, b = _chain_on_off(monkeypatch, enc, img)
    assert a == b


@pytest.mark.parametrize("arb", ["1", "0"])
def test_run_filter_chain_matches_reference(monkeypatch, arb):
    """Host pass 1 in both packages (identical recon), then each
    package's run_filter_chain on the same frame: the port on the CPU,
    the reference on the JAX CPU backend. Decisions and the restoration
    units must be equal. With the CDEF-vs-deblock arbitration on, this
    frame drops CDEF (LR runs on the deblocked branch); with it off
    (CAVIF_TPU_CDEF_ARB=0) CDEF stays and LR runs on its output."""
    rng = np.random.default_rng(11)
    y, x = np.mgrid[0:160, 0:192].astype(np.float64)
    lum = np.clip(300 + 250 * np.sin(x / 19.0) * np.cos(y / 27.0)
                  + rng.normal(0, 30, x.shape), 0, 1023)
    img = np.stack([lum, np.clip(lum * 0.9 + 30, 0, 1023),
                    np.clip(lum * 1.1 - 20, 0, 1023)], -1).astype(np.int32)
    monkeypatch.setenv("CAVIF_TPU_DEVICE_FILTERS", "0")
    monkeypatch.setenv("CAVIF_TPU_CDEF_ARB", arb)
    out = {}
    for name, cfg_t, st_t, fe_t, mod in (
        ("port", AV1Config, SpeedTweaks, FrameEncoder, df),
        ("ref", RefAV1Config, RefSpeedTweaks, RefFrameEncoder, ref_df),
    ):
        cfg = cfg_t(width=192, height=160, bit_depth=10, quantizer=120,
                    tweaks=st_t.from_preset(4, 120), chroma_sampling="444",
                    full_range=True, matrix_coefficients=None, threads=1,
                    device="off")
        fe = fe_t(img, cfg)
        fe.encode()  # host pass 1 and host filters: the tile state
        host_units = dict(fe._lr_units or {})
        if name == "port":
            fe._device_search = "cpu"  # run the port's chain on the CPU
        res = mod.run_filter_chain(fe)
        assert res is not None
        out[name] = (res, dict(fe._lr_units or {}), host_units)
    (pres, punits, phost), (rres, runits, rhost) = out["port"], out["ref"]
    assert pres == rres
    assert bool(pres[1]) == (arb == "0"), pres  # which branch LR saw
    assert punits == runits
    assert punits == phost == rhost  # the host chain's units too
