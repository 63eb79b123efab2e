"""Inputs of the pass-2 wavefront executors (ops/device_pass2.py).

- `host_walk_case`: one real host encode (FrameEncoder on the host
  cascade, python entropy coder) of a 10-bit luma plane with a forced
  uniform 16 px NONE partition, whose final per-block decisions and coded
  levels are captured from this encoder's tile writer; the host's
  reconstruction is what the executors must reproduce bit for bit.
- `random_frame`: seeded decisions and coded levels of a (P, H, W) frame
  with angle deltas on the directional modes.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..av1.config import AV1Config
from ..av1.encoder import FrameEncoder
from ..av1.speed import SpeedTweaks
from ..av1.symbols import PARTITION_NONE


class _Capture:
    """A tile writer that records each block's final decision and coded
    levels, then writes through to the wrapped writer."""

    def __init__(self, tw, coeffs: dict, blocks: dict):
        self._tw, self._coeffs, self._blocks = tw, coeffs, blocks

    def __getattr__(self, name):
        return getattr(self._tw, name)

    def write_coeffs(self, pl, r4, c4, txw, txh, levels, **kw):
        self._coeffs[(r4 // 4, c4 // 4)] = (
            np.array(levels), kw.get("v_adst", 0), kw.get("h_adst", 0))
        return self._tw.write_coeffs(pl, r4, c4, txw, txh, levels, **kw)

    def write_block(self, rr, cc, w4, h4, y_mode, uv_mode, skip,
                    cfl_allowed, **kw):
        self._blocks[(rr // 4, cc // 4)] = (y_mode, kw.get("y_delta", 0))
        return self._tw.write_block(rr, cc, w4, h4, y_mode, uv_mode, skip,
                                    cfl_allowed, **kw)


def host_walk_case(H: int = 128, W: int = 128, seed: int = 9, q: int = 100):
    """(levels, modes, deltas, va, ha, dc_q, ac_q, recon) of one host
    encode under a uniform 16 px NONE partition: levels (nby, nbx, 16, 16)
    int32, the decisions (nby, nbx), the frame's quantizers and the host
    walk's (H, W) reconstruction."""
    n = 16
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:H, 0:W]
    img = np.clip(
        400 + 40 * np.sin(x / 17.0) + 30 * np.cos(y / 23.0)
        + 3 * x - 2 * y + rng.integers(-60, 60, (H, W)),
        0, 1023,
    ).astype(np.int32)
    tw = dataclasses.replace(
        SpeedTweaks.from_preset(4, q), cdef=False, lrf=False
    )
    cfg = AV1Config(
        width=W, height=H, bit_depth=10, quantizer=q, tweaks=tw,
        chroma_sampling="400", full_range=True, matrix_coefficients=None,
        threads=1, ec_backend="python", device="off",
    )
    fe = FrameEncoder(img, cfg)
    fe._lf_hint = lambda: 0
    nby, nbx = H // n, W // n

    def uniform_rdo(partials, origin, r0, r1, c0, c1):
        blocks = [(by * 4, bx * 4, 4, 4) for by in range(nby)
                  for bx in range(nbx)]
        modes = fe._batch_search(blocks, origin)
        part = {(b[0], b[1], 4): PARTITION_NONE for b in blocks}
        return part, modes

    fe._rdo_partition = uniform_rdo
    coeffs, blocks = {}, {}
    walk = fe._encode_partition

    def capture_walk(ctx, tw, r, c, bsl):
        # pass 2 hands its tile writer down the partition walk: wrap it
        # for this encoder only
        if tw is not None and not isinstance(tw, _Capture):
            tw = _Capture(tw, coeffs, blocks)
        return walk(ctx, tw, r, c, bsl)

    fe._encode_partition = capture_walk
    fe.encode()
    levels = np.zeros((nby, nbx, n, n), np.int32)
    modes = np.zeros((nby, nbx), np.int32)
    deltas = np.zeros((nby, nbx), np.int32)
    va = np.zeros((nby, nbx), np.int8)
    ha = np.zeros((nby, nbx), np.int8)
    for (by, bx), (m, d) in blocks.items():
        modes[by, bx], deltas[by, bx] = m, d
    for (by, bx), (lv, v, h) in coeffs.items():
        levels[by, bx], va[by, bx], ha[by, bx] = lv, v, h
    return (levels, modes, deltas, va, ha, fe.dc_q, fe.ac_q,
            fe.planes[0].recon[:H, :W])


def random_frame(seed: int, P: int, H: int, W: int, n: int = 16):
    """(levels, modes, deltas, va, ha) with a leading plane axis: levels
    in [-4, 4] (P, nby, nbx, n, n) int32, modes 0-12, deltas in [-3, 3]
    on the directional modes 1-8, DCT/ADST variants per block."""
    rng = np.random.default_rng(seed)
    nby, nbx = H // n, W // n
    levels = rng.integers(-4, 5, (P, nby, nbx, n, n)).astype(np.int32)
    modes = rng.integers(0, 13, (P, nby, nbx)).astype(np.int32)
    deltas = np.where((modes >= 1) & (modes <= 8),
                      rng.integers(-3, 4, (P, nby, nbx)), 0).astype(np.int32)
    va = rng.integers(0, 2, (P, nby, nbx)).astype(np.int8)
    ha = rng.integers(0, 2, (P, nby, nbx)).astype(np.int8)
    return levels, modes, deltas, va, ha
