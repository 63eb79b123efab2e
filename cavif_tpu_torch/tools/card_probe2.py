"""Probe 2: design-space measurement for the fused device pass 1 on the card.

    python -m cavif_tpu_torch.tools.card_probe2              # on the card
    python -m cavif_tpu_torch.tools.card_probe2 --device cpu --size 128

Port of the repository's tools/tpu_probe2.py. Measures the block search
(ops/block_search.py at its default backend: kernel K3 on the card, its
plain version on the CPU; every line says which):
  V0  device-resident planes, per-tier 13-mode search (compute only)
  V0b all three tiers in one call
  V1  uint8 RGB upload -> on-device BT.601 -> 3 tiers searched for all 3
      planes -> modes and costs fetched (end to end)
  H2D of the uint8 image alone (3 MiB at 1024)
  V2  the n = 16 tier 4x (the proxy the reference used for the expanded
      directional set: 49 vs 13 candidates ~ 3.8x the quantizer/RD work)
Times are host-clock ms of calls that end in a synchronize or a fetch.
Every probe takes `device` ("cuda" by default; it raises without a card,
there is no CPU fallback) and `size` (pixels per side, 1024 by default).
"""

from __future__ import annotations

import argparse

import numpy as np

from .card_probe import _device, _sync, label, timeit

TIERS = (8, 16, 32)
QARGS = (499, 616, 30.0)  # dc_q, ac_q, lambda
DEPTH = 10


def _inputs(size: int):
    """The reference's inputs from one seed-0 stream: (3, size, size)
    int32 planes, then a (size, size, 3) uint8 RGB image."""
    rng = np.random.default_rng(0)
    planes = rng.integers(0, 1024, size=(3, size, size), dtype=np.int32)
    rgb = rng.integers(0, 256, size=(size, size, 3), dtype=np.uint8)
    return planes, rgb


def _kind(device: str) -> str:
    return ("K3 on " + label(device) if device.startswith("cuda")
            else "K3's plain version on cpu")


def _tier(planes, n: int):
    """(modes, costs) of one tier on resident planes (K3 on a card)."""
    from ..ops import block_search as bs

    return bs._search(planes, n, DEPTH, *QARGS, "auto")


def _report(what, device, fn, n=5, warmup=2) -> dict:
    mn, avg = timeit(fn, n=n, warmup=warmup)
    print(f"{what} [{_kind(device)}]: min {mn*1e3:.1f} ms "
          f"avg {avg*1e3:.1f} ms")
    return dict(min_ms=mn * 1e3, avg_ms=avg * 1e3)


def v0_resident(device: str = "cuda", size: int = 1024) -> dict:
    """V0: planes already on the device, one tier per call."""
    import torch

    device = _device(device)
    planes = torch.from_numpy(_inputs(size)[0]).to(device)
    out = {}
    for n in TIERS:
        def call():
            _tier(planes, n)
            _sync(device)

        out[n] = _report(f"V0 resident tier n={n}", device, call)
    return out


def v0b_fused(device: str = "cuda", size: int = 1024) -> dict:
    """V0b: the three tiers in one call on resident planes."""
    import torch

    device = _device(device)
    planes = torch.from_numpy(_inputs(size)[0]).to(device)

    def call():
        for n in TIERS:
            _tier(planes, n)
        _sync(device)

    return _report("V0b fused 3 tiers resident", device, call)


def v1_end_to_end(device: str = "cuda", size: int = 1024) -> dict:
    """V1: the uint8 upload, the colour conversion, three tiers, and the
    modes and costs fetched to the host."""
    import torch

    from ..ops import device_pass1 as dp

    device = _device(device)
    rgb = _inputs(size)[1]

    def call():
        planes = dp._convert(torch.from_numpy(rgb).to(device), "ycbcr",
                             DEPTH)
        out = {n: _tier(planes, n) for n in TIERS}
        return {n: (m.cpu().numpy(), c.cpu().numpy())
                for n, (m, c) in out.items()}

    return _report("V1 e2e uint8 upload + convert + 3 tiers + D2H", device,
                   call)


def h2d_uint8(device: str = "cuda", size: int = 1024) -> dict:
    """The uint8 image's upload alone."""
    import torch

    device = _device(device)
    rgb = _inputs(size)[1]

    def call():
        torch.from_numpy(rgb).to(device)
        _sync(device)

    mn, avg = timeit(call, n=8)
    print(f"H2D {rgb.nbytes / 2**20:.0f} MiB uint8 ({label(device)}): min "
          f"{mn*1e3:.1f} ms avg {avg*1e3:.1f} ms")
    return dict(min_ms=mn * 1e3, avg_ms=avg * 1e3)


def v2_x4(device: str = "cuda", size: int = 1024) -> dict:
    """V2: the n = 16 tier four times per call (delta-search proxy)."""
    import torch

    device = _device(device)
    planes = torch.from_numpy(_inputs(size)[0]).to(device)

    def call():
        for _ in range(4):
            _tier(planes, 16)
        _sync(device)

    return _report("V2 4x tier n=16 (delta-search proxy)", device, call)


PROBES = (v0_resident, v0b_fused, v1_end_to_end, h2d_uint8, v2_x4)


def run(device: str = "cuda", size: int = 1024) -> dict:
    """Every probe in order: {probe name: its numbers}."""
    import torch

    device = _device(device)
    print(f"backend: {label(device)}, torch {torch.__version__}, "
          f"image {size}x{size}")
    with torch.inference_mode():
        return {f.__name__: f(device, size) for f in PROBES}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cavif_tpu_torch.tools.card_probe2")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--size", type=int, default=1024)
    a = ap.parse_args(argv)
    run(a.device, a.size)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
