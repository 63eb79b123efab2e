"""BASELINE.json's configurations (2)-(4) through the port on the CPU.

The port with its pass 1 on the CPU (device="cpu", f32) against the JAX
package's FrameEncoder with its XLA pass 1 on the CPU, on the same seeded
image, as tests/test_torch_encode.py does for the default configuration:
8 bits at Q40 and Q95, the gbr model (--color=rgb) at speed 1 (the 64 px
tier) and speed 10, and RGBA with dirty and cleaned alpha. For every
stream (colour, and alpha for RGBA) the pass-1 grids differ on fewer than
1e-3 of their entries beyond near-ties, the bytes are equal wherever the
grids are (the port encoding on the reference's grids writes the
reference's bytes), and the colour stream is inside the host envelope (the port's
own host cascade, device="off": bytes at most 1.05x, PSNR of the
decoder-exact pre-filter reconstruction at least the host's minus 0.1 dB). The CLI on the CPU (CAVIF_TPU_DEVICE_SEARCH=cpu) writes the
library's bytes. The TX_64 family keeps f32 products in the card's bf16
mode."""

import os
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import cavif_tpu_torch as port
from cavif_tpu.av1.config import AV1Config as RefAV1Config
from cavif_tpu.av1.encoder import FrameEncoder as RefFrameEncoder
from cavif_tpu.av1.speed import SpeedTweaks as RefSpeedTweaks
from cavif_tpu_torch.av1 import tables
from cavif_tpu_torch.av1.config import AV1Config
from cavif_tpu_torch.av1.encoder import FrameEncoder
from cavif_tpu_torch.av1.speed import SpeedTweaks
from cavif_tpu_torch.container.parse import read_avif
from cavif_tpu_torch.ops import colorspace
from cavif_tpu_torch.ops import device_pass1 as dp
from cavif_tpu_torch.ops.ingest import load_rgba
from cavif_tpu_torch.ops.quality import quality_to_quantizer

ROOT = Path(__file__).resolve().parent.parent
H, W = 128, 192


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Torch on one thread, here and in the CLI's subprocess (so both
    sum in the same order): the suite runs several test files at once,
    and the OpenMP teams of the CLI's encode threads would oversubscribe
    the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# BASELINE configs (2) 8 bits over the quality range, (4) --color=rgb at
# speeds 1 and 10, (3) RGBA with and without --dirty-alpha
CASES = {
    "8bit_q40": dict(quality=40.0, depth=8),
    "8bit_q95": dict(quality=95.0, depth=8),
    "gbr_s1": dict(color="rgb", speed=1),
    "gbr_s10": dict(color="rgb", speed=10),
    "rgba_dirty": dict(alpha="dirty"),
    "rgba_clean": dict(alpha="clean"),
}


def _image(h=H, w=W, seed=5):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    lum = np.clip(110 + 80 * np.sin(x / 41.0) * np.cos(y / 29.0)
                  + 60.0 * ((x // 64 + y // 64) % 2) * 0.3
                  + rng.normal(0, 6, x.shape), 0, 255)
    return np.dstack([np.clip(lum + 18 * np.sin(y / 23.0), 0, 255), lum,
                      np.clip(lum - 22 * np.cos(x / 31.0), 0, 255)]
                     ).astype(np.uint8)


def _rgba(img):
    """A transparent left quarter (the cleaning rewrites its colour), a
    ramp, and an opaque right part."""
    h, w = img.shape[:2]
    xx = np.mgrid[0:h, 0:w][1]
    alpha = np.clip((xx - w // 4) * 255 // (w // 4), 0, 255).astype(np.uint8)
    return np.dstack([img, alpha])


def _encoder(quality=80.0, speed=4, depth=10, color="ycbcr", alpha="clean"):
    """The library Encoder with the CLI's derivations (alpha quality from
    quality, threads unset)."""
    aq = min((quality + 100.0) / 2.0, quality + quality / 4.0 + 2.0)
    return (
        port.Encoder.new().with_quality(quality).with_speed(speed)
        .with_bit_depth(depth).with_alpha_quality(aq)
        .with_internal_color_model(port.ColorModel.YCbCr if color == "ycbcr"
                                   else port.ColorModel.RGB)
        .with_alpha_color_mode(port.AlphaColorMode.UnassociatedDirty
                               if alpha == "dirty"
                               else port.AlphaColorMode.UnassociatedClean)
        .with_num_threads(None)
    )


def _streams(case):
    """[(name, planes, stream keywords, src8)] of the case's encode, as the
    pipeline builds them: the colour stream, and for RGBA the alpha
    stream."""
    enc = _encoder(**case)
    depth = enc.output_depth.bits
    img = _image()
    rgb, a8 = img, None
    if "alpha" in case:
        rgba = _rgba(img)
        conv = enc._convert_alpha_8bit(rgba)
        rgb = np.ascontiguousarray((rgba if conv is None else conv)[..., :3])
        a8 = np.ascontiguousarray(rgba[..., 3])
    ycc = enc.color_model is port.ColorModel.YCbCr
    planes = (colorspace.rgb_to_ycbcr_host(rgb, depth=depth) if ycc
              else colorspace.rgb_to_gbr_host(rgb, depth=depth))
    out = [("colour", planes, dict(
        bit_depth=depth, quantizer=enc.quantizer, speed=enc.speed,
        chroma_sampling="444", full_range=True,
        matrix_coefficients=6 if ycc else 0), rgb)]
    if a8 is not None:
        out.append(("alpha", colorspace.alpha_plane_host(a8, depth=depth),
                    dict(bit_depth=depth, quantizer=enc.alpha_quantizer,
                         speed=enc.speed, chroma_sampling="400",
                         full_range=True, matrix_coefficients=None), a8))
    return out


def _beyond_ties(call, grids_p, grids_r) -> int:
    """Entries where the two packages' grids differ, less the mode picks
    that are near-ties (within rtol 1e-5) in the port's own f32 costs of
    the block, recomputed from the pass-1 call's recorded input `call`
    = (src, keywords): such ties break by each package's f32 summation
    order (ROADMAP.md C, "CPU near-ties"). The DP's codes count as they
    are."""
    src, kw = call
    model, depth = kw["model"], kw["depth"]
    x = torch.from_numpy(np.ascontiguousarray(src))
    planes = dp._convert(x, model, depth)
    n = 0
    for (shape, name), g in grids_r.items():
        d = np.argwhere(grids_p[(shape, name)] != g)
        if not len(d):
            continue
        if name == "code":
            n += len(d)
            continue
        bw, bh = shape
        ud = (bool(kw["use_deltas"]) and min(bw, bh) >= 8
              and max(bw, bh) < 64)
        sc = dp.ShapeCost(bw, bh, depth, ud, "f32")
        c = sc(planes, kw["dc_q"], kw["ac_q"], dp._f32(kw["lam"]),
               kw["tile_px"]).double()
        c = c[0] if name == "y_md" else c[1] + c[2]
        mi, dv, _ = dp._cand_tables(ud)
        md = mi.astype(np.int32) | ((dv.astype(np.int32) + 3) << 4)
        for by, bx in d:
            row = c[by, bx]
            a = float(row[int(np.flatnonzero(md == grids_p[shape, name][
                by, bx])[0])])
            b = float(row[int(np.flatnonzero(md == g[by, bx])[0])])
            n += abs(a - b) > 1e-5 * max(abs(a), abs(b), 1.0)
    return n


def _frame(fe_cls, cfg_cls, tweaks_cls, planes, kw, src8, device,
           grids=None):
    """(bytes, pass-1 grids, PSNR of the pre-filter reconstruction) of one
    stream; with `grids` the frame is encoded on those pass-1 decisions
    (injected: no pass 1 runs)."""
    kw = dict(kw)
    speed = kw.pop("speed")
    cfg = cfg_cls(width=W, height=H, tweaks=tweaks_cls.from_preset(
        speed, kw["quantizer"]), threads=None, tune="psnr", device=device,
        **kw)
    fe = fe_cls(planes, cfg, src8=src8)
    if grids is not None:
        fe._device_search = "inject"
        fe._dev_state = (grids, fe._dev_part_dict(grids))
    # keep the reconstruction where the encode makes no filter search
    fe._recon_stack = np.zeros_like(fe._src_stack())
    data = fe.encode()
    src = planes if planes.ndim == 3 else planes[..., None]
    rec = fe._recon_full()
    mse = np.mean([((rec[p, :H, :W].astype(np.float64) - src[..., p]) ** 2)
                   .mean() for p in range(src.shape[2])])
    peak = (1 << kw["bit_depth"]) - 1
    grids = fe._dev_state[0] if fe._dev_state else None
    return data, grids, 10 * np.log10(peak ** 2 / max(mse, 1e-12))


@pytest.mark.parametrize("name", list(CASES))
def test_config_matches_reference_and_host_envelope(name, monkeypatch):
    calls = []
    real = dp.run_pass1

    def recorded(src, **kw):
        calls.append((src, kw))
        return real(src, **kw)

    monkeypatch.setattr(dp, "run_pass1", recorded)
    for stream, planes, kw, src8 in _streams(CASES[name]):
        what = f"{name} {stream}"
        calls.clear()
        data_p, grids_p, psnr_p = _frame(FrameEncoder, AV1Config,
                                         SpeedTweaks, planes, kw, src8, "cpu")
        data_r, grids_r, _ = _frame(RefFrameEncoder, RefAV1Config,
                                    RefSpeedTweaks, planes, kw, src8, "xla")
        assert sorted(grids_p) == sorted(grids_r), what
        n = sum(g.size for g in grids_r.values())
        diff = sum(int((grids_p[k] != grids_r[k]).sum()) for k in grids_r)
        if diff:
            assert len(calls) == 1, what
            beyond = _beyond_ties(calls[0], grids_p, grids_r)
            print(f"{what}: grids differ on {diff} of {n} entries, "
                  f"{beyond} beyond near-ties")
            assert beyond < 1e-3 * n, (what, diff, beyond, n)
        else:
            assert data_p == data_r, what
        # on the reference's decisions the port writes the reference's
        # bytes: everything after pass 1 is the same
        data_i, _, _ = _frame(FrameEncoder, AV1Config, SpeedTweaks, planes,
                              kw, src8, "cpu", grids=grids_r)
        assert data_i == data_r, what
        if stream == "alpha":
            continue  # the envelope holds colour streams, as on the card
        data_h, _, psnr_h = _frame(FrameEncoder, AV1Config, SpeedTweaks,
                                   planes, kw, src8, "off")
        assert len(data_p) <= 1.05 * len(data_h), (what, len(data_p),
                                                   len(data_h))
        assert psnr_p >= psnr_h - 0.1, (what, psnr_p, psnr_h)
        if kw["speed"] == 1 and stream == "colour":
            assert ((64, 64), "code") in grids_p, what


def test_cli_equals_library(tmp_path):
    """The CLI (on the CPU through CAVIF_TPU_DEVICE_SEARCH=cpu) over two
    PNGs at once writes the library's bytes with the same settings."""
    imgs = [_image(), np.ascontiguousarray(np.roll(_image(), 13, axis=1))]
    env = dict(os.environ, CAVIF_TPU_DEVICE_SEARCH="cpu", OMP_NUM_THREADS="1")
    runs = (("depth8", ["--depth=8"], dict(depth=8)),
            ("rgb_s1", ["--color=rgb", "--speed", "1"],
             dict(color="rgb", speed=1)))
    for name, flags, settings in runs:
        d = tmp_path / name
        d.mkdir()
        pngs = []
        for i, x in enumerate(imgs):
            Image.fromarray(x).save(d / f"image{i}.png")
            pngs.append(d / f"image{i}.png")
        r = subprocess.run([sys.executable, "-m", "cavif_tpu_torch", *flags,
                            *map(str, pngs)], cwd=ROOT, env=env,
                           capture_output=True, text=True, timeout=600)
        assert r.returncode == 0, r.stderr[-3000:]
        enc = replace(_encoder(**settings), device="cpu")
        for p in pngs:
            got = p.with_suffix(".avif").read_bytes()
            assert got[4:12] == b"ftypavif"
            want = enc.encode_rgba(load_rgba(p.read_bytes(), False))
            assert got == want.avif_file, (name, p.name)
            info = read_avif(got)
            assert info.bit_depth == settings.get("depth", 10)


def test_tx64_products_stay_f32_in_bf16_mode():
    """The card's bf16 mode rounds the inputs of the products of the
    shapes up to 32 px; the TX_64 family (the 64 px tier at speeds 0-1)
    keeps f32 products, since its tail term (residual energy minus
    coded-area energy) drowns in bf16 rounding: the 64 tier then won
    blocks it should not, and the gbr model at speed 1 came out far
    outside the host envelope on the card."""
    rgb = _image(256, 256)
    planes = dp._convert(torch.from_numpy(rgb), "gbr", 10)
    q = quality_to_quantizer(80.0)
    base = max(1, q)
    dc_q, ac_q = tables.dc_q(base, 10), tables.ac_q(base, 10)
    lam = 0.8 * (ac_q * 0.125) ** 2 / 16.0
    out = {}
    for mm in ("bf16", "f32"):
        sc = dp.ShapeCost(64, 64, 10, False, mm)
        assert sc.kt.dtype == torch.float32 and sc.mdir.dtype == torch.float32
        out[mm] = sc(planes, dc_q, ac_q, dp._f32(lam), (256, 256))
    assert torch.equal(out["bf16"], out["f32"])
    # the shapes up to 32 px keep the card's bf16 products
    assert dp.ShapeCost(32, 32, 10, True, "bf16").mk.dtype == torch.bfloat16
