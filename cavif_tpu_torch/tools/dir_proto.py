"""Harness of the fused directional-cost kernel K4
(ops/proto_kernels.fused_dir_cost).

    python -m cavif_tpu_torch.tools.dir_proto [tier] [--device cpu] [--rows R]

For the square tier b in {4, 8, 16, 32} (default 8) it draws the inputs of
a 1024x1024 three-plane frame, R = 3 (1024 / b)^2 rows of random 10-bit
neighbours and blocks priced against the 56 directional candidates with
angle deltas (E = 4b + 1 neighbours, n2 = b^2 lanes), then times the plain
version with f32 products (`plain`, the accuracy yardstick) and K4 at every
tile and reduce mode (`fused`, bf16 products), with each one's largest
relative cost difference and share of argmin flips against the yardstick.
It runs on the card unless `--device cpu` is given; there the kernel's
plain version stands in for it.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..av1.transforms import AC_BIAS, get_gain
from ..ops import device_pass1 as dp
from ..ops import proto_kernels as pk

TIERS = (4, 8, 16, 32)


def build(b: int, R: int, seed: int = 0) -> dict:
    """Tier b's harness inputs for R rows, as numpy arrays: ext (R, E),
    bkt (R, n2), MK (E, C*n2), cc/inv_scale/scale/bias (n2,) f32, lam
    (f32), n2, C, E. ext and then the blocks are drawn from
    default_rng(seed); MK and cc are the block shape's constants
    (device_pass1.shape_consts(b, b, True))."""
    rng = np.random.default_rng(seed)
    c = dp.shape_consts(b, b, True)
    n2 = b * b
    E = c["mk"].shape[0]
    C = c["mk"].shape[1] // n2
    gain = np.float32(get_gain(b, b))
    ext = rng.integers(0, 1024, (R, E)).astype(np.float32)
    blocks = rng.integers(0, 1024, (R, n2)).astype(np.float32)
    # the Kronecker DCT in column-major order: numpy then makes the same
    # BLAS call, with the same bits, as for the transposed np.kron result
    bkt = blocks @ np.asfortranarray(c["kt"])
    dc_q, ac_q, lam = np.float32(20.0), np.float32(25.0), np.float32(210.0)
    msk = np.zeros(n2, np.float32)
    msk[0] = 1.0
    acf, dcf = ac_q * gain, dc_q * gain
    inv_scale = (1 - msk) / acf + msk / dcf
    scale = (1 - msk) * acf + msk * dcf
    bias = (1 - msk) * AC_BIAS + msk * 0.5
    return dict(MK=np.array(c["mk"]), cc=np.array(c["cc"]), ext=ext, bkt=bkt,
                lam=lam, n2=n2, C=C, E=E,
                inv_scale=inv_scale.astype(np.float32),
                scale=scale.astype(np.float32), bias=bias.astype(np.float32))


def from_numpy(d: dict, device="cuda") -> dict:
    """The kernels' keyword arguments from a harness dict (`build`'s, or
    any dict with its keys): ext, bkt, mk (f32), cc, inv, scale, bias as
    tensors on `device`, lam a float."""
    dev = dp.resolve_device(device)

    def t(k):
        return torch.from_numpy(np.ascontiguousarray(d[k], np.float32)).to(dev)

    return dict(ext=t("ext"), bkt=t("bkt"), mk=t("MK"), cc=t("cc"),
                inv=t("inv_scale"), scale=t("scale"), bias=t("bias"),
                lam=float(d["lam"]))


def _consts(d: dict, device, mk_dtype) -> dict:
    kw = from_numpy(d, device)
    del kw["ext"], kw["bkt"]
    kw["mk"] = kw["mk"].to(mk_dtype)
    return kw


def plain(d: dict, device="cuda"):
    """f(ext, bkt) -> (R, C): the plain version with f32 products."""
    kw = _consts(d, device, torch.float32)
    return lambda ext, bkt: pk.fused_dir_cost_ref(ext, bkt, **kw)


def fused(d: dict, reduce: str = "matmul", tile=pk.DEFAULT_TILE,
          device="cuda"):
    """f(ext, bkt) -> (R, C): K4 with bf16 products."""
    kw = _consts(d, device, torch.bfloat16)
    return lambda ext, bkt: pk.fused_dir_cost(ext, bkt, **kw, reduce=reduce,
                                              tile=tile)


def bench(f, ext, bkt, n: int = 10):
    """(seconds per call of f(ext, bkt) after one warm call, result): CUDA
    events on the card, the host clock on the CPU."""
    r = f(ext, bkt)
    if ext.device.type == "cuda":
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            r = f(ext, bkt)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / n, r
    t0 = time.perf_counter()
    for _ in range(n):
        r = f(ext, bkt)
    return (time.perf_counter() - t0) / n, r


def compare(got, ref):
    """(largest relative cost difference, share of rows whose argmin
    differs)."""
    diff = (got - ref).abs() / ref.abs().clamp_min(1.0)
    flips = (got.argmin(1) != ref.argmin(1)).float().mean()
    return float(diff.max()), float(flips)


def parse_args(prog: str, argv):
    ap = argparse.ArgumentParser(prog=prog)
    ap.add_argument("tier", nargs="?", type=int, default=8, choices=TIERS)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--rows", type=int, default=None,
                    help="rows R (default 3 (1024 / tier)^2)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    a = parse_args("python -m cavif_tpu_torch.tools.dir_proto", argv)
    dev = dp.resolve_device(a.device)
    b = a.tier
    R = a.rows or 3 * (1024 // b) ** 2
    d = build(b, R)
    kw = from_numpy(d, dev)
    ext, bkt = kw["ext"], kw["bkt"]
    tx, rx = bench(plain(d, dev), ext, bkt)
    print(f"tier {b}: R={R} C={d['C']} n2={d['n2']} E={d['E']} on {dev}")
    print(f"  plain (f32 products)       {tx * 1e3:9.4f} ms")
    for tile in pk.TILES:
        for mode in pk.REDUCE_MODES:
            tp, rp = bench(fused(d, mode, tile, dev), ext, bkt)
            rel, flips = compare(rp, rx)
            print(f"  fused tile={tile[0]}x{tile[1]:<3d} {mode:6s} "
                  f"{tp * 1e3:9.4f} ms  maxrel {rel:.2e}  "
                  f"argmin flips {flips:.4%}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
