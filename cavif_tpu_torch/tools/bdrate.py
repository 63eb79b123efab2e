"""Bjontegaard-delta comparison vs libaom on the synthetic corpus.

    python -m cavif_tpu_torch.tools.bdrate [--speed 4] [--tune psnr|ssim]
    python -m cavif_tpu_torch.tools.bdrate --device off   # host cascade

Port of the repository's tools/bdrate.py. Sweeps this encoder (quality
40..95, speed given) and libaom (via Pillow's AVIF plugin, quality 35..90,
speed 6 — the common "good" preset) over the ab_quality corpus, then
reports BD-PSNR / BD-SSIM (quality delta at matched bitrate,
PCHIP-interpolated over log-rate, per the JVET recommendation) and
BD-rate (bitrate delta at matched quality) per image and averaged.

Positive BD-PSNR / BD-SSIM = this encoder is better at the same bits.
Negative BD-rate = this encoder needs fewer bits for the same quality.

The sweeps are functions (`sweep`, `aom_sweep`) over an image list, and
`bd` reduces two of them, so that other callers can hold one encoder
against another on part of the corpus. --device as in ab_quality: "cuda"
(the default), "cpu" or "off".
"""

from __future__ import annotations

import argparse
import io

import numpy as np

from .ab_quality import DEVICES, _metrics, encoder, images

QUALITIES = tuple(range(40, 96, 4))  # this encoder's dense sweep
AOM_QUALITIES = tuple(range(35, 91, 4))  # libaom's, through Pillow
AOM_SPEED = 6


def _mono(r, q):
    """Sort by rate and drop duplicate-rate points (PCHIP needs strictly
    increasing x; quality sweeps can plateau in bytes)."""
    i = np.argsort(r)
    r, q = np.asarray(r)[i], np.asarray(q)[i]
    keep = np.concatenate([[True], np.diff(r) > 0])
    return r[keep], q[keep]


def _bd_quality(r1, q1, r2, q2):
    """BD quality delta (encoder 2 minus encoder 1) at matched rate:
    PCHIP interpolation over log10(rate), integrated on the overlap."""
    from scipy.interpolate import PchipInterpolator

    r1, q1 = _mono(r1, q1)
    r2, q2 = _mono(r2, q2)
    if len(r1) < 3 or len(r2) < 3:  # degenerate sweep (rate plateaus)
        return None
    lr1, lr2 = np.log10(r1), np.log10(r2)
    lo = max(lr1.min(), lr2.min())
    hi = min(lr1.max(), lr2.max())
    if hi - lo < 0.1:  # need >= ~26% rate-range overlap for a stable fit
        return None
    p1 = PchipInterpolator(lr1, q1)
    p2 = PchipInterpolator(lr2, q2)
    xs = np.linspace(lo, hi, 256)
    return float(np.mean(p2(xs) - p1(xs)))


def _bd_rate(r1, q1, r2, q2):
    """BD-rate (%) of encoder 2 vs encoder 1 at matched quality."""
    from scipy.interpolate import PchipInterpolator

    r1, q1 = np.asarray(r1), np.asarray(q1)
    r2, q2 = np.asarray(r2), np.asarray(q2)
    if len(r1) < 3 or len(r2) < 3:
        return None
    lo = max(q1.min(), q2.min())
    hi = min(q1.max(), q2.max())
    if hi - lo < 0.5:  # dB (or SSIM) overlap too thin for a stable fit
        return None
    keep1 = np.concatenate([[True], np.diff(np.sort(q1)) > 0])
    keep2 = np.concatenate([[True], np.diff(np.sort(q2)) > 0])
    i1s, i2s = np.argsort(q1), np.argsort(q2)
    r1, q1 = r1[i1s][keep1], q1[i1s][keep1]
    r2, q2 = r2[i2s][keep2], q2[i2s][keep2]
    if len(r1) < 3 or len(r2) < 3:
        return None
    p1 = PchipInterpolator(q1, np.log10(r1))
    p2 = PchipInterpolator(q2, np.log10(r2))
    xs = np.linspace(lo, hi, 256)
    return float((10 ** np.mean(p2(xs) - p1(xs)) - 1.0) * 100.0)


def sweep(imgs, device="cuda", qualities=QUALITIES, speed=4, tune="psnr"):
    """{name: [(bytes, PSNR, SSIM) per quality]} of the port's encoder with
    its pass 1 on `device` over imgs = [(name, (H, W, 3) uint8)]. Every
    AVIF is decoded by Pillow (_metrics), which raises on one it cannot
    decode."""
    # dense sweeps: the quality->rate curve has preset kinks (the
    # low/high-quality flag flips at ~Q55/Q80 change cdef/lrf/partition
    # policy, mirroring the reference's thresholds), and 6-point PCHIP
    # over a kinked curve was measured to inflate |BD-SSIM| ~1.6x
    # against a 14-point sweep of the same build
    encs = [encoder(q, speed, device, tune) for q in qualities]
    out = {}
    for name, img in imgs:
        pts = []
        for enc in encs:
            b = enc.encode_rgb(img).avif_file
            pts.append((len(b),) + _metrics(img, b))
        out[name] = pts
    return out


def aom_sweep(imgs, qualities=AOM_QUALITIES, speed=AOM_SPEED):
    """{name: [(bytes, PSNR, SSIM) per quality]} of libaom through Pillow's
    AVIF plugin over imgs."""
    from PIL import Image

    out = {}
    for name, img in imgs:
        pts = []
        for q in qualities:
            buf = io.BytesIO()
            Image.fromarray(img).save(buf, format="AVIF", quality=q,
                                      speed=speed)
            pts.append((buf.tell(),) + _metrics(img, buf.getvalue()))
        out[name] = pts
    return out


def bd(anchor, ours):
    """(BD-PSNR, BD-SSIM, BD-rate) of the points `ours` against `anchor`,
    each a list of (bytes, PSNR, SSIM); None where a sweep is degenerate.
    A degenerate rate sweep (edges-style plateau) makes the quality->rate
    inverse meaningless too, so BD-rate is skipped with BD-PSNR."""
    r1, p1, s1 = (np.asarray([a[i] for a in anchor]) for i in range(3))
    r2, p2, s2 = (np.asarray([o[i] for o in ours]) for i in range(3))
    bdp = _bd_quality(r1, p1, r2, p2)
    bds = _bd_quality(r1, s1, r2, s2)
    bdr = _bd_rate(r1, p1, r2, p2) if bdp is not None else None
    return bdp, bds, bdr


def _fmt(v, f):
    return "n/a" if v is None else f % v


def report(anchors: dict, ours: dict, label: str = "libaom-s6") -> dict:
    """Print one BD line per image of `ours` against `anchors` and the mean
    line (as the reference's main does); returns {name: (bdp, bds, bdr)}
    and "MEAN": the means over the images where each exists (None where
    none does)."""
    out = {}
    bdp_all, bds_all, bdr_all = [], [], []
    for name in ours:
        bdp, bds, bdr = out[name] = bd(anchors[name], ours[name])
        print(f"{name:10s} BD-PSNR {_fmt(bdp, '%+.3f')} dB  "
              f"BD-SSIM {_fmt(bds, '%+.5f')}  BD-rate {_fmt(bdr, '%+.1f')}%")
        if bdp is not None:
            bdp_all.append(bdp)
        if bds is not None:
            bds_all.append(bds)
        if bdr is not None:
            bdr_all.append(bdr)
    if bdp_all:
        print(f"MEAN vs {label}: BD-PSNR {np.mean(bdp_all):+.3f} dB  "
              f"BD-SSIM {np.mean(bds_all):+.5f}  "
              f"BD-rate {np.mean(bdr_all):+.1f}%")
    else:
        print("no overlapping sweeps")
    out["MEAN"] = tuple(float(np.mean(v)) if v else None
                        for v in (bdp_all, bds_all, bdr_all))
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m cavif_tpu_torch.tools.bdrate")
    ap.add_argument("--speed", type=int, default=4)
    ap.add_argument("--tune", default="psnr")
    ap.add_argument("--device", default="cuda", choices=DEVICES,
                    help="pass-1 placement: cuda (default; raises without "
                         "a card), cpu, or off (the host cascade)")
    ap.add_argument("--vs-host", action="store_true",
                    help="also sweep the host cascade (device off) and "
                         "report it against libaom and --device against it")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    imgs = images()
    ours = sweep(imgs, args.device, speed=args.speed, tune=args.tune)
    aom = aom_sweep(imgs)
    report(aom, ours)
    if args.vs_host:
        host = sweep(imgs, "off", speed=args.speed, tune=args.tune)
        print("host cascade:")
        report(aom, host)
        print(f"{args.device} against the host cascade:")
        report(host, ours, "host")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
