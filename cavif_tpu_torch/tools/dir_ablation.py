"""Ablation harness of the directional-cost kernel K5
(ops/proto_kernels.dir_ablation).

    python -m cavif_tpu_torch.tools.dir_ablation [tier] [--device cpu] [--rows R]

Times every variant (full, mm_only, no_quant, no_sign, red_bf16) at every
tile on tier b's inputs (dir_proto.build), which splits the fused kernel's
time between the product, the quantizer and the reduction. The kernel is
K1's design (csrc/dir_tc.cuh), so the split is K1's too. It runs on the
card unless `--device cpu` is given; there the plain version stands in.
"""

from __future__ import annotations

import sys

import torch

from ..ops import device_pass1 as dp
from ..ops import proto_kernels as pk
from . import dir_proto


def make(d: dict, variant: str, tile=pk.DEFAULT_TILE, device="cuda"):
    """(f, ext, bkt): f(ext, bkt) -> (R, C) costs of `variant` with bf16
    products, and the harness dict d's inputs on `device`. MK's tiles are
    packed once here, outside the calls."""
    kw = dir_proto.from_numpy(d, device)
    ext, bkt = kw.pop("ext"), kw.pop("bkt")
    kw["mk"] = kw["mk"].to(torch.bfloat16)
    kw["mk_tiles"] = pk.pack_tiles(kw["mk"], d["n2"], tile)

    def f(e, b):
        return pk.dir_ablation(e, b, **kw, variant=variant, tile=tile)

    return f, ext, bkt


def bench(f, a, b, n: int = 20) -> float:
    """Seconds per call of f(a, b) (dir_proto.bench)."""
    return dir_proto.bench(f, a, b, n)[0]


def main(argv=None) -> int:
    a = dir_proto.parse_args("python -m cavif_tpu_torch.tools.dir_ablation",
                             argv)
    dev = dp.resolve_device(a.device)
    R = a.rows or 3 * (1024 // a.tier) ** 2
    d = dir_proto.build(a.tier, R)
    print(f"tier {a.tier}: R={R} on {dev}")
    for tile in pk.TILES:
        for variant in pk.VARIANTS:
            f, ext, bkt = make(d, variant, tile, dev)
            t = bench(f, ext, bkt)
            print(f"  tile={tile[0]}x{tile[1]:<2d} {variant:9s} "
                  f"{t * 1e3:9.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
