"""A/B quality harness: bytes / PSNR / SSIM on the synthetic corpus.

    python -m cavif_tpu_torch.tools.ab_quality [--speed N] [--aom] [--json]
    python -m cavif_tpu_torch.tools.ab_quality --device cpu   # no card
    python -m cavif_tpu_torch.tools.ab_quality --device off   # host cascade

Port of the repository's tools/ab_quality.py. Measures the encoder at
Q80+Q60 speed 4 over four 768x768 images (photo-like, hard edges, smooth
gradient, noisy texture) plus the 1024x1024 bench image, decoding with
Pillow (libavif/dav1d) as the oracle. SSIM follows the BASELINE.md
methodology: grayscale (ITU-R 601 luma), 11-tap gaussian window
sigma=1.5, standard Wang constants. The metric code is the reference's
numpy, unchanged: it defines the metric.

--aom also measures libaom (via Pillow save) at a matched-size sweep for
interpolated matched-bitrate comparison. --device picks the pass-1
placement of the port's encoder: "cuda" (the card, the default; raises
without one), "cpu" (the same program on the CPU) or "off" (the host C++
cascade).
"""

from __future__ import annotations

import argparse
import io
import json
import time
from dataclasses import replace

import numpy as np

DEVICES = ("cuda", "cpu", "off")


def gray(img: np.ndarray) -> np.ndarray:
    return (
        0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
    ).astype(np.float64)


def ssim(a: np.ndarray, b: np.ndarray) -> float:
    """SSIM on grayscale, 11x11 gaussian sigma=1.5 (separable)."""
    k = np.arange(11) - 5.0
    g = np.exp(-(k * k) / (2 * 1.5 * 1.5))
    g /= g.sum()

    def filt(x):
        # separable valid-mode convolution
        x = np.apply_along_axis(lambda r: np.convolve(r, g, "valid"), 1, x)
        return np.apply_along_axis(lambda c: np.convolve(c, g, "valid"), 0, x)

    C1, C2 = (0.01 * 255) ** 2, (0.03 * 255) ** 2
    mu_a, mu_b = filt(a), filt(b)
    saa = filt(a * a) - mu_a * mu_a
    sbb = filt(b * b) - mu_b * mu_b
    sab = filt(a * b) - mu_a * mu_b
    num = (2 * mu_a * mu_b + C1) * (2 * sab + C2)
    den = (mu_a**2 + mu_b**2 + C1) * (saa + sbb + C2)
    return float((num / den).mean())


def images():
    """[(name, (H, W, 3) uint8)]: the four 768x768 images from seed 42 and
    the bench image (tools/bench.py `test_image`, the reference bench's
    `_test_image(1024, 1024)`)."""
    from .bench import test_image

    out = []
    rng = np.random.default_rng(42)
    y, x = np.mgrid[0:768, 0:768].astype(np.float64)
    a = (110 + 80 * np.sin(x / 97.0) * np.cos(y / 61.0)
         + 40 * np.sin((x + 2 * y) / 31.0) + rng.normal(0, 6, x.shape))
    out.append(("photo", np.stack(
        [np.clip(a + 18 * np.sin(y / 83.0), 0, 255), np.clip(a, 0, 255),
         np.clip(a - 22 * np.cos(x / 71.0), 0, 255)], -1).astype(np.uint8)))
    b = (np.where((x // 24 + y // 24) % 2 < 1, 230.0, 40.0)
         + np.where((x * 3 + y * 7) % 97 < 5, 180, 0))
    out.append(("edges", np.stack([np.clip(b, 0, 255)] * 3, -1).astype(np.uint8)))
    c = x * 0.2 + y * 0.13
    out.append(("gradient", np.stack(
        [np.clip(c, 0, 255), np.clip(255 - c * 0.8, 0, 255),
         np.clip(c * 0.5 + 60, 0, 255)], -1).astype(np.uint8)))
    d = 128 + rng.normal(0, 35, x.shape)
    out.append(("texture", np.stack(
        [np.clip(d, 0, 255), np.clip(d * 0.9, 0, 255),
         np.clip(d * 1.1 - 10, 0, 255)], -1).astype(np.uint8)))
    out.append(("bench1024", test_image(1024, 1024)))
    return out


def encoder(quality: float, speed: int, device: str, tune: str = "psnr"):
    """The port's Encoder at `quality` / `speed` / `tune`, its pass 1 on
    `device` ("cuda", "cpu" or "off"; None leaves the encoder's default,
    the card unless CAVIF_TPU_DEVICE_SEARCH says otherwise)."""
    from .. import Encoder

    if device is not None and device not in DEVICES:
        raise ValueError(f"device must be one of {DEVICES}, not {device!r}")
    return replace(Encoder.new().with_quality(quality).with_speed(speed)
                   .with_tune(tune), device=device)


def _metrics(img: np.ndarray, data: bytes):
    """(PSNR, SSIM) of the Pillow-decoded AVIF `data` against `img` (the
    reference's bdrate._metrics; Pillow raises on a file it cannot
    decode)."""
    from PIL import Image

    dec = np.asarray(Image.open(io.BytesIO(data)).convert("RGB")).astype(
        np.float64)
    err = ((dec - img.astype(np.float64)) ** 2).mean()
    p = 10 * np.log10(255**2 / max(err, 1e-9))
    s = ssim(gray(img.astype(np.float64)), gray(dec))
    return p, s


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m cavif_tpu_torch.tools.ab_quality")
    ap.add_argument("--speed", type=int, default=4)
    ap.add_argument("--aom", action="store_true")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--device", default="cuda", choices=DEVICES,
                    help="pass-1 placement: cuda (default; raises without "
                         "a card), cpu, or off (the host cascade)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    from PIL import Image

    args = parse_args(argv)
    rows = []
    for q in (80, 60):
        enc = encoder(q, args.speed, args.device)
        for name, im in images():
            t0 = time.perf_counter()
            res = enc.encode_rgb(im)
            dt = time.perf_counter() - t0
            p, s = _metrics(im, res.avif_file)
            rows.append(dict(q=q, img=name, bytes=len(res.avif_file),
                             psnr=round(p, 4), ssim=round(s, 6),
                             sec=round(dt, 3)))
            if not args.json:
                print(f"q{q} {name:10s} {len(res.avif_file):7d} B "
                      f"{p:7.3f} dB  ssim {s:.5f}  {dt:.2f}s")
        if args.aom:
            for name, im in images():
                for aq in (55, 60, 65):
                    buf = io.BytesIO()
                    Image.fromarray(im).save(
                        buf, format="AVIF", quality=aq, speed=6
                    )
                    p, s = _metrics(im, buf.getvalue())
                    rows.append(dict(q=f"aom{aq}", img=name,
                                     bytes=buf.tell(), psnr=round(p, 4),
                                     ssim=round(s, 6)))
                    if not args.json:
                        print(f"aom q{aq} {name:10s} {buf.tell():7d} B "
                              f"{p:7.3f} dB  ssim {s:.5f}")
    tot = sum(r["bytes"] for r in rows if isinstance(r["q"], int))
    mp = np.mean([r["psnr"] for r in rows if isinstance(r["q"], int)])
    ms = np.mean([r["ssim"] for r in rows if isinstance(r["q"], int)])
    if args.json:
        print(json.dumps({"rows": rows, "total_bytes": tot,
                          "mean_psnr": round(float(mp), 4),
                          "mean_ssim": round(float(ms), 6)}))
    else:
        print(f"TOTAL bytes={tot} meanPSNR={mp:.4f} meanSSIM={ms:.6f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
