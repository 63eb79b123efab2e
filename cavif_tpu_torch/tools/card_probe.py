"""Probe the card: round-trip latency, transfers, the block search's
throughput per tier on its plain version and on kernel K3, and the host's
native pass 1 for the same work. Measurement harness for sizing the
default device path (prints timings; not a test).

    python -m cavif_tpu_torch.tools.card_probe               # on the card
    python -m cavif_tpu_torch.tools.card_probe --device cpu --size 128

Port of the repository's tools/tpu_probe.py, sections 1-6: the small-op
round trip; H2D and D2H of three 1024x1024 int32 planes (12 MiB); the
whole-plane search per tier n = 8, 16, 32 on its plain PyTorch version
(the reference's "xla search"); the partition program (tiers 8-32, K3 on
the card); K3 through ops/block_search.py at n = 8 and 16 (the
reference's "pallas search"); the host native pass-1 skeleton. Times are
host-clock ms of calls that end in a fetch or a synchronize; "first call"
is the first call's seconds (the kernels' build and load on the card,
where the reference compiled). A failure raises: nothing is caught.
Every probe takes `device` ("cuda" by default; it raises without a card,
there is no CPU fallback) and `size` (pixels per plane side, 1024 by
default).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

SEARCH = (499, 616, 30.0, 10)  # dc_q, ac_q, lambda, bit depth


def timeit(fn, n=5, warmup=2):
    """(min, mean) host-clock seconds of fn() over n calls after warmup."""
    for _ in range(warmup):
        fn()
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return min(ts), sum(ts) / len(ts)


def _device(device: str) -> str:
    from ..ops import device_pass1 as dp

    return dp.resolve_device(device)  # raises without a card for "cuda"


def _sync(device: str) -> None:
    import torch

    if device.startswith("cuda"):
        torch.cuda.synchronize()


def label(device: str) -> str:
    """The device as the lines name it: the card's name, or "cpu"."""
    import torch

    if device.startswith("cuda"):
        return torch.cuda.get_device_name(torch.device(device))
    return "cpu"


def planes(size: int = 1024) -> np.ndarray:
    """The probes' three 10-bit planes: (3, size, size) int32, seed 0."""
    return np.random.default_rng(0).integers(0, 1024, size=(3, size, size),
                                             dtype=np.int32)


def round_trip(device: str = "cuda", size: int = 1024) -> dict:
    """1. A tiny op and its fetch to the host (`size` is not used)."""
    import torch

    device = _device(device)
    x = torch.ones((8, 8), dtype=torch.float32, device=device)
    x.add(1.0).cpu()
    mn, avg = timeit(lambda: x.add(1.0).cpu().numpy(), n=20, warmup=3)
    print(f"tiny-op round trip ({label(device)}): min {mn*1e3:.2f} ms "
          f"avg {avg*1e3:.2f} ms")
    return dict(min_ms=mn * 1e3, avg_ms=avg * 1e3)


def transfers(device: str = "cuda", size: int = 1024) -> dict:
    """2. H2D and D2H of the three int32 planes (12 MiB at 1024)."""
    import torch

    device = _device(device)
    p = planes(size)
    mib = p.nbytes / 2**20

    def h2d():
        torch.from_numpy(p).to(device)
        _sync(device)

    mn, avg = timeit(h2d, n=10)
    print(f"H2D {mib:.0f} MiB ({label(device)}): min {mn*1e3:.2f} ms "
          f"avg {avg*1e3:.2f} ms")
    d = torch.from_numpy(p).to(device)
    mn2, avg2 = timeit(lambda: d.cpu().numpy(), n=10)
    print(f"D2H {mib:.0f} MiB ({label(device)}): min {mn2*1e3:.2f} ms "
          f"avg {avg2*1e3:.2f} ms")
    return dict(h2d_min_ms=mn * 1e3, h2d_avg_ms=avg * 1e3,
                d2h_min_ms=mn2 * 1e3, d2h_avg_ms=avg2 * 1e3)


def _search_tiers(device, size, tiers, backend, what) -> dict:
    from ..ops import block_search as bs

    device = _device(device)
    p = planes(size)
    out = {}
    for n in tiers:
        def call():
            return bs.plane_mode_search_costs(p, *SEARCH, n=n,
                                              backend=backend, device=device)

        t0 = time.perf_counter()
        call()
        first = time.perf_counter() - t0
        mn, avg = timeit(call, n=5)
        print(f"{what} n={n} ({label(device)}): first call {first:.2f}s "
              f"steady min {mn*1e3:.1f} ms avg {avg*1e3:.1f} ms")
        out[n] = dict(first_s=first, min_ms=mn * 1e3, avg_ms=avg * 1e3)
    return out


def plain_search(device: str = "cuda", size: int = 1024) -> dict:
    """3. The whole-plane 13-candidate search per tier on its plain
    PyTorch version (backend "plain")."""
    return _search_tiers(device, size, (8, 16, 32), "plain",
                         "plain search")


def partition(device: str = "cuda", size: int = 1024) -> dict:
    """4. The multi-tier partition program (tiers 8-32 and the DP) at the
    default backend: K3 on the card, the plain version on the CPU."""
    from ..ops import block_search as bs

    device = _device(device)
    p = planes(size)
    kind = "K3" if device.startswith("cuda") else "plain version"

    def call():
        return bs.plane_partition_search(p, *SEARCH, device=device)

    t0 = time.perf_counter()
    call()
    first = time.perf_counter() - t0
    mn, avg = timeit(call, n=5)
    print(f"partition program (8/16/32, {kind}; {label(device)}): first "
          f"call {first:.2f}s steady min {mn*1e3:.1f} ms avg "
          f"{avg*1e3:.1f} ms")
    return dict(first_s=first, min_ms=mn * 1e3, avg_ms=avg * 1e3)


def k3_search(device: str = "cuda", size: int = 1024) -> dict:
    """5. The search at n = 8 and 16 through kernel K3 (backend "auto": K3
    on the card, its plain version on the CPU)."""
    what = ("K3 search" if _device(device).startswith("cuda")
            else "K3's plain version")
    return _search_tiers(device, size, (8, 16), "auto", what)


def host_pass1(device: str = "cuda", size: int = 1024) -> dict:
    """6. The host native pass-1 search and skeleton over the same planes
    at Q80's quantizer, speed 4, on every host core (`device` only names
    the run: this is host work)."""
    from .. import native  # noqa: F401  (build)
    from ..av1.config import AV1Config
    from ..av1.encoder import FrameEncoder
    from ..av1.speed import SpeedTweaks

    _device(device)
    p = planes(size)
    # the reference's call predates AV1Config's chroma_sampling: the
    # three planes are a 4:4:4 frame
    cfg = AV1Config(
        width=size, height=size, bit_depth=10, quantizer=121,
        tweaks=SpeedTweaks.from_preset(4, 121), chroma_sampling="444",
        threads=os.cpu_count(), device="off",
    )
    enc = FrameEncoder(np.stack([p[0], p[1], p[2]], axis=-1) >> 0, cfg)

    def run():
        enc._ops_cache.clear()
        enc._tile_skeleton(0, enc.mi_rows, 0, enc.mi_cols)

    mn, avg = timeit(run, n=3, warmup=1)
    print(f"host native pass1+skeleton ({os.cpu_count()} host threads): "
          f"min {mn*1e3:.1f} ms avg {avg*1e3:.1f} ms")
    return dict(min_ms=mn * 1e3, avg_ms=avg * 1e3)


PROBES = (round_trip, transfers, plain_search, partition, k3_search,
          host_pass1)


def run(device: str = "cuda", size: int = 1024) -> dict:
    """Every probe in order: {probe name: its numbers}."""
    import torch

    device = _device(device)
    print(f"backend: {label(device)}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, planes 3x{size}x{size}")
    with torch.inference_mode():
        return {f.__name__: f(device, size) for f in PROBES}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cavif_tpu_torch.tools.card_probe")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--size", type=int, default=1024)
    a = ap.parse_args(argv)
    run(a.device, a.size)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
