"""Decoder-bit-exact AV1 inverse transforms on torch tensors.

The encoder's reconstruction must equal the decoder's integer arithmetic
exactly (residuals are computed against the decoder's prediction state, so
any drift corrupts the decoded image through intra chains). The host paths
use int64 butterflies; this module evaluates the same networks in int32
via a hi/lo split: for the rounding half-butterfly
hbf(w0,x0,w1,x1) = (w0*x0 + w1*x1 + 2048) >> 12 with |w| <= 4096 and
|x| < 2^20, each product splits as w*(xh*4096 + xl) with xh = x >> 12,
xl = x & 4095 — every partial stays under 2^25 (int32-safe), and
(A*4096 + B) >> 12 == A + (B >> 12) exactly for arithmetic shifts.
Torch's `>>` on int32 is an arithmetic shift and `&` acts on the two's
complement, as in the JAX reference, so each step matches it value for
value (int64 would be exact too; the split keeps the steps comparable).

The 1-D networks are the generic recursion of av1/itx.py _idct_generic /
the native iidct_generic, vectorized over a leading batch axis; the
tests pin bit-exact equality with native.inv_txfm_exact and with the JAX
package's device_itx for every tx size (4..64, rects, DCT/ADST combos).

Reference: cavif_tpu/ops/device_itx.py (same functions, jitted XLA there;
no TPU kernel).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..av1 import tables
from .device_pass1 import resolve_device


def _brev(x: int, bits: int) -> int:
    out = 0
    for _ in range(bits):
        out = (out << 1) | (x & 1)
        x >>= 1
    return out


def _odd_order(n: int):
    half = n // 2
    bits = max(half - 1, 1).bit_length() if half > 1 else 0
    return [1 + 2 * _brev(i, bits) for i in range(half)]


def _reorder(n: int):
    if n == 1:
        return [0]
    return [2 * i for i in _reorder(n // 2)] + _odd_order(n)


def _hbf(w0: int, x0, w1: int, x1):
    """(w0*x0 + w1*x1 + 2048) >> 12, exact in int32 via hi/lo split."""
    xh0, xl0 = x0 >> 12, x0 & 4095
    xh1, xl1 = x1 >> 12, x1 & 4095
    hi = w0 * xh0 + w1 * xh1
    lo = w0 * xl0 + w1 * xl1 + 2048
    return hi + (lo >> 12)


def _idct_lanes(s, n: int, c):
    """Generic AV1 idct network on a list of n batch-shaped int32 lanes
    (reordered input). Mirrors av1/itx.py _idct_generic with the int32
    hbf; identical stage structure to the dav1d-validated butterflies."""
    if n == 4:
        b0 = _hbf(c[32], s[0], c[32], s[1])
        b1 = _hbf(c[32], s[0], -c[32], s[1])
        b2 = _hbf(c[48], s[2], -c[16], s[3])
        b3 = _hbf(c[16], s[2], c[48], s[3])
        return [b0 + b3, b1 + b2, b1 - b2, b0 - b3]
    m = n // 2
    t = _idct_lanes(s[:m], m, c)
    x = list(s[m:])
    oo = _odd_order(n)
    scale = 64 // n
    nx = [None] * m
    for p in range(m // 2):
        q = oo[p] * scale
        nx[p] = _hbf(c[64 - q], x[p], -c[q], x[m - 1 - p])
        nx[m - 1 - p] = _hbf(c[q], x[p], c[64 - q], x[m - 1 - p])
    x2 = [None] * m
    for k in range(m // 2):
        a0, a1 = nx[2 * k], nx[2 * k + 1]
        if k % 2 == 0:
            x2[2 * k], x2[2 * k + 1] = a0 + a1, a0 - a1
        else:
            x2[2 * k], x2[2 * k + 1] = a1 - a0, a1 + a0
    x = x2
    g = 2
    while g <= m // 2:
        G = 2 * g
        amul = 64 * g // m
        blocks = m // (2 * G)
        bbits = max(blocks - 1, 0).bit_length()
        nx = list(x)
        for p in range(m // 2):
            pm = p % G
            if not (G // 4 <= pm < 3 * G // 4):
                continue
            j = m - 1 - p
            a = amul * (1 + 4 * _brev(p // G, bbits))
            if pm < G // 2:
                nx[p] = _hbf(-c[a], x[p], c[64 - a], x[j])
                nx[j] = _hbf(c[64 - a], x[p], c[a], x[j])
            else:
                nx[p] = _hbf(-c[64 - a], x[p], -c[a], x[j])
                nx[j] = _hbf(-c[a], x[p], c[64 - a], x[j])
        x = nx
        if G < m:
            nx = [None] * m
            for base in range(0, m, G):
                odd = (base // G) % 2
                for i in range(G // 2):
                    lo, hi = x[base + i], x[base + G - 1 - i]
                    if not odd:
                        nx[base + i], nx[base + G - 1 - i] = lo + hi, lo - hi
                    else:
                        nx[base + i], nx[base + G - 1 - i] = hi - lo, hi + lo
            x = nx
        g *= 2
    return [t[i] + x[m - 1 - i] for i in range(m)] + [
        t[m - 1 - i] - x[i] for i in range(m)
    ]


def _iadst4_lanes(x, sp):
    # sinpi network with one rsh(.., 12) at the end. Plain int32 products
    # (sinpi <= 4096): exact while |input| < ~2^18 — comfortably above the
    # 4-pt dequant magnitudes of real encodes (the tests pin equality
    # with the native int64 path over the conformant range)
    s0 = sp[1] * x[0]
    s1 = sp[2] * x[0]
    s2 = sp[3] * x[1]
    s3 = sp[4] * x[2]
    s4 = sp[1] * x[2]
    s5 = sp[2] * x[3]
    s6 = sp[4] * x[3]
    s7 = (x[0] - x[2]) + x[3]
    s0 = s0 + s3
    s1 = s1 - s4
    s3 = s2
    s2 = sp[3] * s7
    s0 = s0 + s5
    s1 = s1 - s6

    def rsh12(v):
        return (v + 2048) >> 12

    return [rsh12(s0 + s3), rsh12(s1 + s3), rsh12(s2),
            rsh12((s0 + s1) - s3)]


def _iadst8_lanes(x, c):
    b = [x[7], x[0], x[5], x[2], x[3], x[4], x[1], x[6]]
    H = _hbf
    s = [
        H(c[4], b[0], c[60], b[1]), H(c[60], b[0], -c[4], b[1]),
        H(c[20], b[2], c[44], b[3]), H(c[44], b[2], -c[20], b[3]),
        H(c[36], b[4], c[28], b[5]), H(c[28], b[4], -c[36], b[5]),
        H(c[52], b[6], c[12], b[7]), H(c[12], b[6], -c[52], b[7]),
    ]
    t = [s[0] + s[4], s[1] + s[5], s[2] + s[6], s[3] + s[7],
         s[0] - s[4], s[1] - s[5], s[2] - s[6], s[3] - s[7]]
    u = [t[0], t[1], t[2], t[3],
         H(c[16], t[4], c[48], t[5]), H(c[48], t[4], -c[16], t[5]),
         H(-c[48], t[6], c[16], t[7]), H(c[16], t[6], c[48], t[7])]
    v = [u[0] + u[2], u[1] + u[3], u[0] - u[2], u[1] - u[3],
         u[4] + u[6], u[5] + u[7], u[4] - u[6], u[5] - u[7]]
    w = [v[0], v[1],
         H(c[32], v[2], c[32], v[3]), H(c[32], v[2], -c[32], v[3]),
         v[4], v[5],
         H(c[32], v[6], c[32], v[7]), H(c[32], v[6], -c[32], v[7])]
    return [w[0], -w[4], w[6], -w[2], w[3], -w[7], w[5], -w[1]]


def _iadst16_lanes(x, c):
    H = _hbf
    b = [x[15], x[0], x[13], x[2], x[11], x[4], x[9], x[6],
         x[7], x[8], x[5], x[10], x[3], x[12], x[1], x[14]]
    s = [
        H(c[2], b[0], c[62], b[1]), H(c[62], b[0], -c[2], b[1]),
        H(c[10], b[2], c[54], b[3]), H(c[54], b[2], -c[10], b[3]),
        H(c[18], b[4], c[46], b[5]), H(c[46], b[4], -c[18], b[5]),
        H(c[26], b[6], c[38], b[7]), H(c[38], b[6], -c[26], b[7]),
        H(c[34], b[8], c[30], b[9]), H(c[30], b[8], -c[34], b[9]),
        H(c[42], b[10], c[22], b[11]), H(c[22], b[10], -c[42], b[11]),
        H(c[50], b[12], c[14], b[13]), H(c[14], b[12], -c[50], b[13]),
        H(c[58], b[14], c[6], b[15]), H(c[6], b[14], -c[58], b[15]),
    ]
    t = [s[i] + s[i + 8] for i in range(8)] + [s[i] - s[i + 8]
                                               for i in range(8)]
    u = list(t[:8]) + [
        H(c[8], t[8], c[56], t[9]), H(c[56], t[8], -c[8], t[9]),
        H(c[40], t[10], c[24], t[11]), H(c[24], t[10], -c[40], t[11]),
        H(-c[56], t[12], c[8], t[13]), H(c[8], t[12], c[56], t[13]),
        H(-c[24], t[14], c[40], t[15]), H(c[40], t[14], c[24], t[15]),
    ]
    v = [u[i] + u[i + 4] for i in range(4)] + \
        [u[i] - u[i + 4] for i in range(4)] + \
        [u[8 + i] + u[12 + i] for i in range(4)] + \
        [u[8 + i] - u[12 + i] for i in range(4)]
    w = list(v)
    w[4] = H(c[16], v[4], c[48], v[5])
    w[5] = H(c[48], v[4], -c[16], v[5])
    w[6] = H(-c[48], v[6], c[16], v[7])
    w[7] = H(c[16], v[6], c[48], v[7])
    w[12] = H(c[16], v[12], c[48], v[13])
    w[13] = H(c[48], v[12], -c[16], v[13])
    w[14] = H(-c[48], v[14], c[16], v[15])
    w[15] = H(c[16], v[14], c[48], v[15])
    z = [w[0] + w[2], w[1] + w[3], w[0] - w[2], w[1] - w[3],
         w[4] + w[6], w[5] + w[7], w[4] - w[6], w[5] - w[7],
         w[8] + w[10], w[9] + w[11], w[8] - w[10], w[9] - w[11],
         w[12] + w[14], w[13] + w[15], w[12] - w[14], w[13] - w[15]]
    y = list(z)
    y[2] = H(c[32], z[2], c[32], z[3])
    y[3] = H(c[32], z[2], -c[32], z[3])
    y[6] = H(c[32], z[6], c[32], z[7])
    y[7] = H(c[32], z[6], -c[32], z[7])
    y[10] = H(c[32], z[10], c[32], z[11])
    y[11] = H(c[32], z[10], -c[32], z[11])
    y[14] = H(c[32], z[14], c[32], z[15])
    y[15] = H(c[32], z[14], -c[32], z[15])
    return [y[0], -y[8], y[12], -y[4], y[6], -y[14], y[10], -y[2],
            y[3], -y[11], y[15], -y[7], y[5], -y[13], y[9], -y[1]]


def _itx_1d(lanes, n: int, is_adst: bool, c, sp):
    if not is_adst:
        ro = _reorder(n)
        return _idct_lanes([lanes[i] for i in ro], n, c)
    if n == 4:
        return _iadst4_lanes(lanes, sp)
    if n == 8:
        return _iadst8_lanes(lanes, c)
    return _iadst16_lanes(lanes, c)


@lru_cache(maxsize=None)
def inv_body(txw: int, txh: int, bit_depth: int, v_adst: int,
             h_adst: int):
    """Batched inverse on tensors: run(levels, dc_q, ac_q) maps
    (B, ch, cw) int32 LEVELS on any device to (B, txh, txw) int32
    residuals there (dc_q, ac_q Python ints). Mirrors native
    inv_txfm_exact's dequant scaling, rect 1/sqrt2, row/col shifts —
    bit-exact. A plain function, so it composes inside larger device
    programs (the pass-2 wavefront)."""
    c = tuple(int(v) for v in tables.get("cospi")[2])
    sp = tuple(int(v) for v in tables.get("sinpi")[2])
    cw, ch = min(txw, 32), min(txh, 32)
    lw = txw.bit_length() - 1
    lh = txh.bit_length() - 1
    mxd = max(txw, txh)
    tx_scale = 2 if mxd >= 64 else (1 if mxd >= 32 else 0)
    cf_max = (1 << (bit_depth + 7)) - 1
    mn = max(txw, txh)
    if mn <= 4 or (txw, txh) in ((8, 4), (4, 8)):
        s0 = 0
    elif mn == 8:
        s0 = 1
    elif txw == txh and txw >= 16:
        s0 = 2
    elif (txw, txh) in ((32, 16), (16, 32), (16, 8), (8, 16)):
        s0 = 1
    elif (txw, txh) in ((32, 8), (8, 32)):
        s0 = 2
    else:
        s0 = 1
    s1 = 4
    rect = abs(lw - lh) == 1

    def run(levels, dc_q: int, ac_q: int):
        B = levels.shape[0]
        lv = levels.to(torch.int32)
        q = torch.full((ch, cw), int(ac_q), dtype=torch.int32,
                       device=lv.device)
        q[0, 0] = int(dc_q)
        a = lv.abs() * q
        a = a >> tx_scale
        a = a.clamp(max=cf_max)
        v = torch.where(lv < 0, -a, a)
        if rect:
            # v * 2896 can exceed int32: hi/lo split (values <= 2^17 here)
            v = (2896 * (v >> 12)) + (((2896 * (v & 4095)) + 2048) >> 12)
        buf = torch.zeros((B, txh, txw), dtype=torch.int32, device=lv.device)
        buf[:, :ch, :cw] = v
        # row pass (horizontal): lane i carries coefficient column i
        # across (B, txh) — the 1-D network runs element-wise per lane
        rows = [buf[:, :, i] for i in range(txw)]  # (B, txh) per x
        out = _itx_1d(rows, txw, bool(h_adst), c, sp)
        if s0:
            out = [(o + (1 << (s0 - 1))) >> s0 for o in out]
        # column pass: per-y lanes of the row-transformed data
        stacked = torch.stack(out, dim=-1)  # (B, txh, txw)
        cols = [stacked[:, i, :] for i in range(txh)]  # (B, txw) per y
        outc = _itx_1d(cols, txh, bool(v_adst), c, sp)
        outc = [(o + (1 << (s1 - 1))) >> s1 for o in outc]
        return torch.stack(outc, dim=1)  # (B, txh, txw)

    return run


def inv_txfm_batch(levels: np.ndarray, txw: int, txh: int, dc_q: int,
                   ac_q: int, bit_depth: int, v_adst: int = 0,
                   h_adst: int = 0, device=None) -> np.ndarray:
    """Batched decoder-bit-exact inverse transform. levels: (B, ch, cw)
    coded areas; returns (B, txh, txw) int32 residuals, bit-exact with
    native.inv_txfm_exact per batch entry. device=None runs on the card
    (raises without one); "cpu" runs the same code on the host."""
    dev = resolve_device(device)
    f = inv_body(txw, txh, bit_depth, int(bool(v_adst)), int(bool(h_adst)))
    lv = torch.from_numpy(np.ascontiguousarray(levels, np.int32)).to(dev)
    return f(lv, int(dc_q), int(ac_q)).cpu().numpy()
