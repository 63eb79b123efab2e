"""The BASELINE.json "batch of 512 mixed inputs" configuration, end to end.

    python -m cavif_tpu_torch.tools.batch512_bench [--n 512] [--paths hybrid,sharded]
    python -m cavif_tpu_torch.tools.batch512_bench --device cpu --n 8 --scale 4 --reps 1

Port of the repository's tools/batch512_bench.py: n synthetic images over
four shape buckets (every 8th an RGBA image with a live alpha region; the
reference's par_iter over arbitrary files, cavif src/main.rs:223), encoded
at Q80 speed 4 through both batch paths:

- hybrid: parallel.encode_batch, the card and the host cores on
  different images;
- sharded: parallel.encode_batch_sharded, per-bucket batched pass-1
  programs on the card, the host's pass 2 streamed per sub-batch.

Each path first encodes the first 8 images once (the four buckets and an
RGBA image), which warms its programs and pools; then it prints each
rep's wall and MP/s, the warm MP/s (the best rep) and the stage totals of
the last rep (spans summed over threads). `--device cpu` and `--scale`
(shapes divided by it) exist so the CPU tests can run it small.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from .bench import encoder

SHAPES = ((384, 512), (512, 512), (256, 384), (512, 768))


def make_images(n: int, scale: int = 1):
    """(images, total MP): the reference's generator (seed 11), shapes
    cycling through SHAPES (each side divided by `scale`), image i RGBA
    with a live alpha region when i % 8 == 3."""
    rng = np.random.default_rng(11)
    imgs = []
    total_mp = 0.0
    for i in range(n):
        h, w = (s // scale for s in SHAPES[i % len(SHAPES)])
        y, x = np.mgrid[0:h, 0:w].astype(np.float64)
        base = (
            120 + 70 * np.sin(x / (37 + 13 * (i % 7)))
            * np.cos(y / (53 + 7 * (i % 5)))
        )
        lum = np.clip(base + rng.normal(0, 5, (h, w)), 0, 255)
        img = np.stack(
            [np.clip(lum + 12, 0, 255), lum, np.clip(lum - 15, 0, 255)],
            axis=-1,
        ).astype(np.uint8)
        if i % 8 == 3:  # live alpha region
            a = np.full((h, w), 255, np.uint8)
            a[h // 4 : h // 2, w // 4 : 3 * w // 4] = rng.integers(
                0, 255, (h // 4, w // 2), np.uint8
            )
            img = np.dstack([img, a])
        imgs.append(img)
        total_mp += h * w / 1e6
    return imgs, total_mp


def run_path(path: str, imgs, enc):
    """(AVIF bytes per image, wall seconds) of one pass of `imgs` through
    the "hybrid" or "sharded" path; a failed image raises."""
    from ..parallel.batch import encode_batch, encode_batch_sharded

    t0 = time.perf_counter()
    if path == "hybrid":
        # threads, as on the card: a forked worker cannot use the card,
        # and the CPU run's torch thread pool does not survive a fork
        res = encode_batch(imgs, enc, processes=False)
        bad = [r.error for r in res if r.encoded is None]
        if bad:
            raise bad[0]
        out = [r.encoded.avif_file for r in res]
    elif path == "sharded":
        out = encode_batch_sharded(imgs, enc)
    else:
        raise ValueError(f"unknown path {path!r}")
    return out, time.perf_counter() - t0


def parse_args(argv):
    ap = argparse.ArgumentParser(
        prog="python -m cavif_tpu_torch.tools.batch512_bench")
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--paths", default="hybrid,sharded")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--scale", type=int, default=1,
                    help="divide every bucket's sides by this (CPU runs)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    from ..ops import device_pass1 as dp
    from ..utils import trace

    a = parse_args(argv)
    device = dp.resolve_device(a.device)
    imgs, total_mp = make_images(a.n, a.scale)
    enc = encoder(device)
    print(f"{a.n} images, {total_mp:.1f} MP total", flush=True)
    for path in a.paths.split(","):
        # warm the path's programs and pools on the first 8 images (the
        # four buckets and an RGBA image) before the timed reps
        run_path(path, imgs[:8], enc)
        walls = []
        for rep in range(a.reps):
            last = rep == a.reps - 1
            if last:
                trace.set_enabled(True)
                trace.set_accumulate(True)
            try:
                out, dt = run_path(path, imgs, enc)
                tab = {k: v for k, v in trace.ACCUM.items()
                       if not k.startswith("n_")} if last else {}
                counts = dict(trace.ACCUM) if last else {}
            finally:
                if last:
                    trace.set_enabled(False)
                    trace.set_accumulate(False)
            walls.append(dt)
            print(f"  {path} rep{rep}: {dt:.1f} s = {total_mp / dt:.2f} "
                  f"MP/s ({sum(len(b) for b in out)} B)", flush=True)
        print(f"  {path} stage totals (thread-seconds over {a.n} images; "
              f"wall {walls[-1]:.1f} s):", flush=True)
        for k, v in sorted(tab.items(), key=lambda kv: -kv[1]):
            n = counts.get("n_" + k, 0)
            print(f"    {k:24s} {v:8.1f} s  "
                  f"({1e3 * v / max(n, 1):6.1f} ms x {n})", flush=True)
        print(f"{path}: warm {total_mp / min(walls):.2f} MP/s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
