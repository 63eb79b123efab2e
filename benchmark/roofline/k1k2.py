"""Frozen operation and byte counts of the port's device pass-1 kernels K1
(directional costs, `csrc/pass1_dir_cost.cu`) and K2 (non-directional
costs, `csrc/pass1_nd_cost.cu`), per frame.

A copy of `ops/device_pass1.py` `_fused_shapes`, `kernel_flops` and
`kernel_bytes` as they stand when the benchmark was written, with their
constants: a later change to the program cannot move the yardstick.
Useful (logical, unpadded) work: per block shape of at most 32 px with R
rows and C directional candidates over E edge pixels and n2 = bw * bh,
K1 does 2·R·E·C·n2 + R·C·n2 flops and K2 5·2·R·n2² + 2·R·(bw + bh)·n2;
each input is read once and each output written once.
"""

from __future__ import annotations

SQ_TIERS = (4, 8, 16, 32)
RECT_SHAPES = ((8, 4), (4, 8), (16, 8), (8, 16), (32, 16), (16, 32))
DIR_MODES = 8  # V, H, D45, D135, D113, D157, D203, D67
DELTAS = 6  # angle deltas -3..3 without 0
PROGRAM_ALIGN = 256  # the encoder pads a frame's pass-1 program to this


def program_size(height: int, width: int) -> tuple:
    """The padded frame that the encoder's pass-1 program runs over."""
    up = lambda v: -(-v // PROGRAM_ALIGN) * PROGRAM_ALIGN  # noqa: E731
    return up(height), up(width)


def shapes(height: int, width: int, planes: int, max_px: int,
           use_deltas: bool) -> list:
    """[(bw, bh, R, C, E, n2)] of the shapes K1 and K2 price in one frame:
    one launch of each kernel per shape."""
    H, W = program_size(height, width)
    sq = SQ_TIERS + ((64,) if max_px >= 64 else ())
    out = []
    for bw, bh in [(s, s) for s in sq] + list(RECT_SHAPES):
        if max(bw, bh) > 32:
            continue
        ud = bool(use_deltas) and min(bw, bh) >= 8
        cands = DIR_MODES * (1 + (DELTAS if ud else 0))
        out.append((bw, bh, planes * (H // bh) * (W // bw), cands,
                    2 * (bw + bh) + 1, bw * bh))
    return out


def flops(shape_list) -> float:
    return sum(2.0 * R * E * C * n2 + R * C * n2
               + 5 * 2.0 * R * n2 * n2 + 2.0 * R * (bw + bh) * n2
               for bw, bh, R, C, E, n2 in shape_list)


def nbytes(shape_list) -> float:
    return sum(4.0 * R * (E + n2 + C) + 2.0 * E * C * n2 + 16.0 * n2
               + 4.0 * R * (bw + bh + 2 + n2 + 5) + 2.0 * n2 * n2
               + 20.0 * n2
               for bw, bh, R, C, E, n2 in shape_list)
