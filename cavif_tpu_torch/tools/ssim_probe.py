"""Matched-rate SSIM/PSNR probe for coefficient-level levers.

    python -m cavif_tpu_torch.tools.ssim_probe                # the card
    python -m cavif_tpu_torch.tools.ssim_probe --device off   # host cascade

Port of the repository's tools/ssim_probe.py. For each candidate config
(env-knob settings), sweeps 3 qualities on the two BD-gap images (photo,
bench1024), PCHIP-interpolates SSIM and PSNR at the BASE config's Q80 byte
count, and prints the deltas. Fast inner loop for hunting the lever that
moves SSIM at matched rate (the BD-SSIM gap lives on these images;
`python -m cavif_tpu_torch.tools.bdrate` is the full verdict).

Each config runs in a child process (`--child`; the native tile coder
reads the env knobs once, at load) whose pass 1 runs on --device: the card
by default, "cpu" for the same program on the CPU, "off" for the host
cascade (the reference's children always run the host cascade). The knob
names are those that the port's verbatim copy of the native code reads.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

QUALITIES = (76, 84, 90)
PROBE_IMAGES = ("photo", "bench1024")

CONFIGS = [
    ("base", {}),
    ("trellis-off", {"CAVIF_TPU_TRELLIS_CTX": "0"}),
    ("cdef-arb-off", {"CAVIF_TPU_CDEF_ARB": "0"}),
    ("psy-full-.5", {"CAVIF_TPU_PSY_FULL": "0.5"}),
]


def _child(device: str) -> None:
    """Encode the probe images at the sweep qualities with pass 1 on
    `device`; print {img: [(bytes, psnr, ssim), ...]} as one JSON line."""
    from .ab_quality import images
    from .bdrate import sweep

    imgs = [(n, im) for n, im in images() if n in PROBE_IMAGES]
    print(json.dumps(sweep(imgs, device=device, qualities=QUALITIES)))


def run_config(env, device="cuda"):
    """Encode the probe images at the sweep qualities in a child process
    (env-derived constants are read at import) with pass 1 on `device`;
    returns {img: [(bytes, psnr, ssim), ...]}."""
    from .._child import run_json

    return run_json("cavif_tpu_torch.tools.ssim_probe",
                    ["--child", "--device", device], {**os.environ, **env})


def parse_args(argv=None):
    from .ab_quality import DEVICES

    ap = argparse.ArgumentParser(
        prog="python -m cavif_tpu_torch.tools.ssim_probe")
    ap.add_argument("--device", default="cuda", choices=DEVICES,
                    help="pass 1 of every config: cuda (default; raises "
                         "without a card), cpu, or off (host cascade)")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    from scipy.interpolate import PchipInterpolator

    a = parse_args(argv)
    if a.child:
        _child(a.device)
        return 0
    results = {}
    for name, env in CONFIGS:
        results[name] = run_config(env, a.device)
        print(f"ran {name}", file=sys.stderr)

    base = results["base"]
    for img in base:
        ref_bytes = base[img][1][0]  # Q80 bytes of the base config
        print(f"--- {img} @ {ref_bytes} B (base Q80) ---")
        for name, _ in CONFIGS:
            rows = results[name][img]
            r = np.asarray([x[0] for x in rows], np.float64)
            p = np.asarray([x[1] for x in rows])
            s = np.asarray([x[2] for x in rows])
            i = np.argsort(r)
            lr = np.log10(r[i])
            fp = PchipInterpolator(lr, p[i])
            fs = PchipInterpolator(lr, s[i])
            x = np.log10(ref_bytes)
            x = min(max(x, lr.min()), lr.max())
            pp, ss = float(fp(x)), float(fs(x))
            if name == "base":
                bp, bs = pp, ss
                print(f"{name:12s} PSNR {pp:7.3f}  SSIM {ss:.5f}")
            else:
                print(
                    f"{name:12s} PSNR {pp:7.3f} ({pp-bp:+.3f})  "
                    f"SSIM {ss:.5f} ({ss-bs:+.5f})"
                )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
