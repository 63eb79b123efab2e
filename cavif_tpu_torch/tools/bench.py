"""The port's benchmark driver: prints ONE JSON line with the headline metric.

    python -m cavif_tpu_torch.tools.bench                # on the card
    python -m cavif_tpu_torch.tools.bench --device cpu --size 64 --images 3

Port of the repository's bench.py, with the same configuration and the
same JSON keys. Headline: full AVIF encode MP/s at quality 80 / speed 4
(the reference's defaults: Q80 -> quantizer 121, 10-bit, 4:4:4 YCbCr
BT.601 full range; cavif src/main.rs:54,60 and ravif
src/av1encoder.rs:526-530), as the median over 4 `encode_batch` runs of
max(24, ncpu) rolled copies of the 1024x1024 test image, with the spread;
beside it the minimum of 7 single encodes, one traced encode's stage
split, the libaom anchor through Pillow, the attachment probe and its
engage flags, and the card's roofline of the device pass-1 program.

vs_baseline is measured against REF_MPS, an estimate of multithreaded
cavif (rav1e speed 4, quality 80) throughput on a many-core host; the
reference publishes no numbers (BASELINE.md).

`--device cpu`, `--size` and `--images` exist so the CPU tests can run
the driver small; the numbers of record come from the card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from dataclasses import replace

import numpy as np

REF_MPS = 3.0  # estimated cavif --quality 80 --speed 4 multithread MP/s
# H100 SXM data-sheet peaks: dense bf16 tensor-core FLOP/s, HBM3 bytes/s
PEAK_BF16, PEAK_BYTES = 989e12, 3.35e12


def test_image(h: int, w: int) -> np.ndarray:
    """Photo-like synthetic content: smooth shading + texture + edges
    (seed 42; the reference benchmark's image)."""
    rng = np.random.default_rng(42)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    base = (
        110 + 80 * np.sin(x / 97.0) * np.cos(y / 61.0)
        + 40 * np.sin((x + 2 * y) / 31.0)
    )
    texture = rng.normal(0.0, 6.0, size=(h, w))
    edges = 60.0 * ((x // 128 + y // 128) % 2)
    lum = np.clip(base + texture + edges * 0.3, 0, 255)
    r = np.clip(lum + 18 * np.sin(y / 83.0), 0, 255)
    b = np.clip(lum - 22 * np.cos(x / 71.0), 0, 255)
    return np.stack([r, lum, b], axis=-1).astype(np.uint8)


def card_name() -> str:
    """The card's name and power limit as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` prints them, or "no card" where
    nvidia-smi does not run."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "no card"


def libaom_anchor(img: np.ndarray, our_bytes: int):
    """Same-host anchor: libaom speed 6 (through Pillow/libavif) encoding
    the same content at the quality whose output size best matches ours.
    Returns (libaom MP/s, its bytes, its quality), or None where Pillow
    lacks AVIF."""
    import io

    try:
        from PIL import Image
    except Exception:
        return None
    pim = Image.fromarray(img)
    try:
        sizes = {}
        for q in (45, 55, 65, 75):
            buf = io.BytesIO()
            pim.save(buf, format="AVIF", quality=q, speed=6)
            sizes[q] = buf.tell()
    except Exception:
        return None
    q = min(sizes, key=lambda k: abs(sizes[k] - our_bytes))
    times = []
    for _ in range(3):
        buf = io.BytesIO()
        t0 = time.perf_counter()
        pim.save(buf, format="AVIF", quality=q, speed=6)
        times.append(time.perf_counter() - t0)
    mp = img.shape[0] * img.shape[1] / 1e6
    return mp / min(times), sizes[q], q


def stage_breakdown(enc, img) -> dict:
    """One traced single encode: wall seconds per stage, largest first."""
    from ..utils import trace

    trace.set_enabled(True)
    trace.snapshot()
    try:
        enc.encode_rgb(img)
        tab = trace.snapshot()
        if not tab:  # the pipeline's report() already drained the table
            tab = dict(trace.LAST)
    finally:
        trace.set_enabled(False)
    return {k: round(v, 4) for k, v in sorted(tab.items(),
                                              key=lambda kv: -kv[1])}


def device_roofline(img, dt_device_s, device: str = "cuda") -> dict:
    """The card's roofline of the device pass-1 program that the last
    encode ran (ops/device_pass1.LAST_KEY, with its recorded quantizers,
    lambda and tile split): the program timed with its input already on
    the device (CUDA events on the card, the host clock on the CPU),
    against K1's and K2's analytic flops and bytes (kernel_flops,
    kernel_bytes: the two kernels only) at the H100's peaks. The
    reference's counterpart (bench.py `_device_mfu`) used XLA's cost
    analysis of the whole program and TPU peaks; `mfu_incl_transfer`
    divides by the traced `device_pass1` span instead (upload, program,
    fetch and the host's work around them)."""
    import torch

    from ..ops import device_pass1 as dp

    key = dp.LAST_KEY
    if key is None:
        return {"error": "no device pass-1 ran"}
    H, W = key[0], key[1]
    h, w = img.shape[:2]
    if key[3] != "ycbcr" or (H, W) != (-(-h // 256) * 256,
                                       -(-w // 256) * 256):
        return {"error": f"unexpected program key {key}"}
    dc_q, ac_q, lam, (th, tw) = dp.LAST_ARGS
    prog = dp._program(key, "f32" if device == "cpu" else "bf16", device)
    # the encoder's own edge padding to the program's frame
    src = np.pad(img, ((0, H - h), (0, W - w), (0, 0)), mode="edge")
    args = (dp._f32(dc_q), dp._f32(ac_q), dp._f32(lam), int(th), int(tw))
    cuda = device.startswith("cuda")
    with torch.inference_mode():
        x = torch.from_numpy(np.ascontiguousarray(src)).to(device)[None]
        prog(x, *args)  # warm
        times = []
        for _ in range(3):
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                prog(x, *args)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end) / 1e3)
            else:
                t0 = time.perf_counter()
                prog(x, *args)
                times.append(time.perf_counter() - t0)
    dt = min(times)
    flops, nbytes = dp.kernel_flops(key), dp.kernel_bytes(key)
    return {
        "kernel_flops": flops,
        "kernel_bytes": nbytes,
        "exec_s": round(dt, 6),
        "mfu_exec": round(flops / dt / PEAK_BF16, 6),
        "hbm_frac_exec": round(nbytes / dt / PEAK_BYTES, 6),
        "mfu_incl_transfer": round(flops / dt_device_s / PEAK_BF16, 6)
        if dt_device_s else None,
        "timing": "CUDA events" if cuda else "host clock (cpu)",
        "peaks": f"{card_name()}: H100 SXM 989 TFLOP/s dense bf16, "
                 "3.35 TB/s HBM3",
    }


def attachment_flags() -> dict:
    """The attachment probe and its engage decisions."""
    from ..ops import attachment

    att = dict(attachment.probe())
    att["device_pass2_engaged"] = attachment.engage_device_pass2()
    att["device_filters_engaged"] = attachment.engage_device_filters()
    return att


def encoder(device: str):
    """The benchmark's encoder, Q80 speed 4: on the card by default
    (device left unset, as a user's), or pinned to the CPU."""
    from .. import Encoder

    enc = Encoder.new().with_quality(80).with_speed(4)
    return enc if device.startswith("cuda") else replace(enc, device=device)


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="python -m cavif_tpu_torch.tools.bench")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--size", type=int, default=1024,
                    help="side of the square test image (default 1024)")
    ap.add_argument("--images", type=int, default=None,
                    help="batch length (default max(24, ncpu) with the "
                         "device pass 1, else max(8, ncpu))")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    from ..ops import device_pass1 as dp
    from ..parallel import encode_batch
    from ..parallel.batch import _device_engaged

    a = parse_args(argv)
    device = dp.resolve_device(a.device)
    img = test_image(a.size, a.size)
    enc = encoder(device)

    out = enc.encode_rgb(img)  # warm-up: kernel loads, tables, pools
    enc.encode_rgb(img)
    stages = stage_breakdown(enc, img)

    # single stream keeps the min (the machine's capability for the stage
    # table); the headline below is the median over batch runs
    times = []
    for _ in range(7):
        t0 = time.perf_counter()
        out = enc.encode_rgb(img)
        times.append(time.perf_counter() - t0)
    dt_single = min(times)

    # batch throughput: the reference's primary mode is a rayon par_iter
    # over files; encode_batch is the fan-out here. With the device pass 1
    # engaged the pool is oversubscribed 2x so the card stays fed while
    # workers are in their host stages.
    ncpu = os.cpu_count() or 1
    on_device = _device_engaged() if enc.device is None else True
    nimg = a.images or max(24 if on_device else 8, ncpu)
    workers = 2 * ncpu + 1 if on_device else None
    imgs = [np.ascontiguousarray(np.roll(img, 13 * i, axis=1))
            for i in range(nimg)]
    bt = []
    for _ in range(4):
        t0 = time.perf_counter()
        # threads, never forked workers: the card's context (and the CPU
        # run's torch thread pool) does not survive a fork
        res = encode_batch(imgs, enc, max_workers=workers, processes=False)
        bt.append(time.perf_counter() - t0)
    bad = [r.error for r in res if r.encoded is None]
    if bad:
        raise bad[0]
    dt_batch = min(bt) / len(imgs)

    mp = img.shape[0] * img.shape[1] / 1e6
    # the headline is the MEDIAN batch run with the spread beside it,
    # never a best-of figure
    runs = sorted(mp * len(imgs) / t for t in bt)
    med = 0.5 * (runs[len(runs) // 2 - 1] + runs[len(runs) // 2])
    anchor = libaom_anchor(img, len(out.avif_file))
    if anchor is not None:
        aom_mps, aom_bytes, aom_q = anchor
        measured = {
            "vs_libaom_measured": round(med / aom_mps, 3),
            "libaom_s6_mps": round(aom_mps, 3),
            "libaom_s6_bytes": aom_bytes,
            "libaom_s6_quality": aom_q,
        }
    else:
        measured = {"vs_libaom_measured": None}
    roof = (device_roofline(img, stages.get("device_pass1"), device)
            if on_device else None)
    print(json.dumps({
        "metric": "encode_mps_q80_s4",
        "value": round(med, 3),
        "value_median": round(med, 3),
        "value_spread": [round(runs[0], 3), round(runs[-1], 3)],
        "unit": "MP/s",
        **measured,
        "vs_baseline": round(med / REF_MPS, 3),
        "vs_baseline_anchor": "ESTIMATED REF_MPS=3.0 (see BASELINE.md)",
        "detail": {
            "image": f"{a.size}x{a.size} synthetic photo-like RGB",
            "avif_bytes": len(out.avif_file),
            "seconds_per_image_single": round(dt_single, 4),
            "seconds_per_image_batch_best": round(dt_batch, 4),
            "batch_size": len(imgs),
            "device_pass1": bool(on_device),
            "stage_seconds_single": stages,
            "device_pass1_mfu": roof,
            "attachment_probe": attachment_flags(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
