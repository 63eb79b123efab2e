"""8K single-image steady-state measurement (BASELINE.json config 5).

    python -m cavif_tpu_torch.tools.bench8k [--reps 3] [--trace]
    python -m cavif_tpu_torch.tools.bench8k --device cpu --size 64x96 --reps 1

Port of the repository's tools/bench8k.py: the benchmark's photo-like
image (tools/bench.py `test_image`) at 7680x4320, encoded at Q80 speed 4
once cold, then --reps warm encodes with MP/s each and their median;
--trace adds one traced encode's per-stage table. Beside every encode it
prints the card's peak allocated memory (torch.cuda.max_memory_allocated).
`--device cpu` and `--size` exist so the CPU tests can run it small.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from .bench import encoder, test_image

HEIGHT, WIDTH = 4320, 7680


def img8k(h: int = HEIGHT, w: int = WIDTH) -> np.ndarray:
    """The benchmark's generator at 8K, so stage splits compare with the
    1 MP runs."""
    return test_image(h, w)


def encode(enc, img):
    """(AVIF bytes, wall seconds, peak card bytes or None) of one
    encode_rgb; the peak counts from this encode's start."""
    import torch

    cuda = enc.device is None or str(enc.device).startswith("cuda")
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    avif = enc.encode_rgb(img).avif_file
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return avif, wall, torch.cuda.max_memory_allocated() if cuda else None


def _gib(peak) -> str:
    return "n/a" if peak is None else f"{peak / 2 ** 30:.2f} GiB"


def parse_args(argv):
    ap = argparse.ArgumentParser(
        prog="python -m cavif_tpu_torch.tools.bench8k")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--size", default=f"{WIDTH}x{HEIGHT}",
                    help="WIDTHxHEIGHT (default 7680x4320)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    from ..ops import device_pass1 as dp
    from ..utils import trace

    a = parse_args(argv)
    device = dp.resolve_device(a.device)
    w, h = (int(v) for v in a.size.split("x"))
    img = img8k(h, w)
    mp = h * w / 1e6
    enc = encoder(device)

    b, dt, peak = encode(enc, img)
    print(f"cold: {dt:.1f} s  bytes {len(b)}  peak {_gib(peak)}", flush=True)
    rates = []
    for i in range(a.reps):
        b, dt, peak = encode(enc, img)
        rates.append(mp / dt)
        print(f"rep {i}: {dt:.2f} s  {mp / dt:.2f} MP/s  peak {_gib(peak)}",
              flush=True)
    if rates:
        print(f"median {np.median(rates):.2f} MP/s  bytes {len(b)}",
              flush=True)
    if a.trace:
        trace.set_enabled(True)
        trace.set_accumulate(True)
        try:
            _, dt, peak = encode(enc, img)
            tab = {k: v for k, v in trace.ACCUM.items()
                   if not k.startswith("n_")}
        finally:
            trace.set_enabled(False)
            trace.set_accumulate(False)
        print(f"traced rep: {dt:.2f} s  peak {_gib(peak)}")
        for k, v in sorted(tab.items(), key=lambda kv: -kv[1])[:12]:
            print(f"  {k:20s} {v:7.2f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
