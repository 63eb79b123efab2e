"""AV1 integer inverse-DCT basis matrices (exact 12-bit constants).

The decoder's inverse DCT uses cos constants quantized to 12 bits
(cospi[i] = round(cos(i*pi/64) * 4096)); the resulting linear map deviates
from the ideal orthonormal DCT by up to ~1e-3 relative. For big coefficients
(sharp edges) that deviation is several pixels — enough to drift the
encoder's reconstruction model away from the decoder and snowball through
intra prediction chains.

This module runs the AV1 idct butterflies (av1_inv_txfm1d.c structure) over
unit vectors *without* intermediate rounding, producing the exact linear
basis the decoder applies (intra-stage rounding then contributes only a
bounded +-1..2 LSB, magnitude-independent). Each matrix is validated against
the ideal DCT at build time (a structural error in a butterfly would show up
as a large deviation), and end-to-end against dav1d in tests.

Matrices are normalized to ~orthonormal scale so transforms.py can keep its
calibrated end-to-end gain model unchanged.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from . import tables


@lru_cache(maxsize=1)
def _cospi() -> np.ndarray:
    # cospi table rows are cos bits 10..16; AV1 uses cos_bit 12 for inverse
    arr = tables.get("cospi")
    row = arr[2].astype(np.float64)  # bit 12
    assert int(row[32]) == 2896, row[:4]
    return row / 4096.0


def _hb(w0, x0, w1, x1):
    return w0 * x0 + w1 * x1


def _idct4(s, c):
    b0 = _hb(c[32], s[0], c[32], s[1])
    b1 = _hb(c[32], s[0], -c[32], s[1])
    b2 = _hb(c[48], s[2], -c[16], s[3])
    b3 = _hb(c[16], s[2], c[48], s[3])
    return [b0 + b3, b1 + b2, b1 - b2, b0 - b3]


def _idct8(s, c):
    # s: reordered inputs [in0, in4, in2, in6, in1, in5, in3, in7]
    b4 = _hb(c[56], s[4], -c[8], s[7])
    b5 = _hb(c[24], s[5], -c[40], s[6])
    b6 = _hb(c[40], s[5], c[24], s[6])
    b7 = _hb(c[8], s[4], c[56], s[7])
    t = _idct4(s[:4], c)
    c4 = b4 + b5
    c5 = b4 - b5
    c6 = -b6 + b7
    c7 = b6 + b7
    d5 = _hb(-c[32], c5, c[32], c6)
    d6 = _hb(c[32], c5, c[32], c6)
    return [
        t[0] + c7, t[1] + d6, t[2] + d5, t[3] + c4,
        t[3] - c4, t[2] - d5, t[1] - d6, t[0] - c7,
    ]


def _idct16(s, c):
    # s: [in0,in8,in4,in12,in2,in10,in6,in14,in1,in9,in5,in13,in3,in11,in7,in15]
    b8 = _hb(c[60], s[8], -c[4], s[15])
    b9 = _hb(c[28], s[9], -c[36], s[14])
    b10 = _hb(c[44], s[10], -c[20], s[13])
    b11 = _hb(c[12], s[11], -c[52], s[12])
    b12 = _hb(c[52], s[11], c[12], s[12])
    b13 = _hb(c[20], s[10], c[44], s[13])
    b14 = _hb(c[36], s[9], c[28], s[14])
    b15 = _hb(c[4], s[8], c[60], s[15])
    t = _idct8(s[:8], c)
    c8 = b8 + b9
    c9 = b8 - b9
    c10 = -b10 + b11
    c11 = b10 + b11
    c12 = b12 + b13
    c13 = b12 - b13
    c14 = -b14 + b15
    c15 = b14 + b15
    d9 = _hb(-c[16], c9, c[48], c14)
    d14 = _hb(c[48], c9, c[16], c14)
    d10 = _hb(-c[48], c10, -c[16], c13)
    d13 = _hb(-c[16], c10, c[48], c13)
    e8 = c8 + c11
    e9 = d9 + d10
    e10 = d9 - d10
    e11 = c8 - c11
    e12 = c15 - c12
    e13 = d14 - d13
    e14 = d14 + d13
    e15 = c15 + c12
    f10 = _hb(-c[32], e10, c[32], e13)
    f13 = _hb(c[32], e10, c[32], e13)
    f11 = _hb(-c[32], e11, c[32], e12)
    f12 = _hb(c[32], e11, c[32], e12)
    g = [e8, e9, f10, f11, f12, f13, e14, e15]
    return [
        t[0] + g[7], t[1] + g[6], t[2] + g[5], t[3] + g[4],
        t[4] + g[3], t[5] + g[2], t[6] + g[1], t[7] + g[0],
        t[7] - g[0], t[6] - g[1], t[5] - g[2], t[4] - g[3],
        t[3] - g[4], t[2] - g[5], t[1] - g[6], t[0] - g[7],
    ]


def _idct32(s, c):
    # s: bit-reversed-ish reorder (see _reorder32)
    b16 = _hb(c[62], s[16], -c[2], s[31])
    b17 = _hb(c[30], s[17], -c[34], s[30])
    b18 = _hb(c[46], s[18], -c[18], s[29])
    b19 = _hb(c[14], s[19], -c[50], s[28])
    b20 = _hb(c[54], s[20], -c[10], s[27])
    b21 = _hb(c[22], s[21], -c[42], s[26])
    b22 = _hb(c[38], s[22], -c[26], s[25])
    b23 = _hb(c[6], s[23], -c[58], s[24])
    b24 = _hb(c[58], s[23], c[6], s[24])
    b25 = _hb(c[26], s[22], c[38], s[25])
    b26 = _hb(c[42], s[21], c[22], s[26])
    b27 = _hb(c[10], s[20], c[54], s[27])
    b28 = _hb(c[50], s[19], c[14], s[28])
    b29 = _hb(c[18], s[18], c[46], s[29])
    b30 = _hb(c[34], s[17], c[30], s[30])
    b31 = _hb(c[2], s[16], c[62], s[31])
    t = _idct16(s[:16], c)
    c16 = b16 + b17
    c17 = b16 - b17
    c18 = -b18 + b19
    c19 = b18 + b19
    c20 = b20 + b21
    c21 = b20 - b21
    c22 = -b22 + b23
    c23 = b22 + b23
    c24 = b24 + b25
    c25 = b24 - b25
    c26 = -b26 + b27
    c27 = b26 + b27
    c28 = b28 + b29
    c29 = b28 - b29
    c30 = -b30 + b31
    c31 = b30 + b31
    d17 = _hb(-c[8], c17, c[56], c30)
    d30 = _hb(c[56], c17, c[8], c30)
    d18 = _hb(-c[56], c18, -c[8], c29)
    d29 = _hb(-c[8], c18, c[56], c29)
    d21 = _hb(-c[40], c21, c[24], c26)
    d26 = _hb(c[24], c21, c[40], c26)
    d22 = _hb(-c[24], c22, -c[40], c25)
    d25 = _hb(-c[40], c22, c[24], c25)
    e16 = c16 + c19
    e17 = d17 + d18
    e18 = d17 - d18
    e19 = c16 - c19
    e20 = c23 - c20
    e21 = d22 - d21
    e22 = d22 + d21
    e23 = c23 + c20
    e24 = c24 + c27
    e25 = d25 + d26
    e26 = d25 - d26
    e27 = c24 - c27
    e28 = c31 - c28
    e29 = d30 - d29
    e30 = d30 + d29
    e31 = c31 + c28
    f18 = _hb(-c[16], e18, c[48], e29)
    f29 = _hb(c[48], e18, c[16], e29)
    f19 = _hb(-c[16], e19, c[48], e28)
    f28 = _hb(c[48], e19, c[16], e28)
    f20 = _hb(-c[48], e20, -c[16], e27)
    f27 = _hb(-c[16], e20, c[48], e27)
    f21 = _hb(-c[48], e21, -c[16], e26)
    f26 = _hb(-c[16], e21, c[48], e26)
    g16 = e16 + e23
    g17 = e17 + e22
    g18 = f18 + f21
    g19 = f19 + f20
    g20 = f19 - f20
    g21 = f18 - f21
    g22 = e17 - e22
    g23 = e16 - e23
    g24 = e31 - e24
    g25 = e30 - e25
    g26 = f29 - f26
    g27 = f28 - f27
    g28 = f28 + f27
    g29 = f29 + f26
    g30 = e30 + e25
    g31 = e31 + e24
    h20 = _hb(-c[32], g20, c[32], g27)
    h27 = _hb(c[32], g20, c[32], g27)
    h21 = _hb(-c[32], g21, c[32], g26)
    h26 = _hb(c[32], g21, c[32], g26)
    h22 = _hb(-c[32], g22, c[32], g25)
    h25 = _hb(c[32], g22, c[32], g25)
    h23 = _hb(-c[32], g23, c[32], g24)
    h24 = _hb(c[32], g23, c[32], g24)
    g = [g16, g17, g18, g19, h20, h21, h22, h23,
         h24, h25, h26, h27, g28, g29, g30, g31]
    out = []
    for i in range(16):
        out.append(t[i] + g[31 - 16 - (15 - i)] if False else None)
    # final butterfly: out[i] = t[i] + g[15-i]... using symmetric pattern
    res = [0.0] * 32
    for i in range(16):
        res[i] = t[i] + g[15 - i]
        res[31 - i] = t[i] - g[15 - i]
    return res


def _brev(x: int, bits: int) -> int:
    out = 0
    for _ in range(bits):
        out = (out << 1) | (x & 1)
        x >>= 1
    return out


def _odd_order(n):
    """AV1 idct odd-lane input order: bit-reversed within the odds."""
    half = n // 2
    bits = max(half - 1, 1).bit_length() if half > 1 else 0
    return [1 + 2 * _brev(i, bits) for i in range(half)]


def _reorder(n):
    """Input reorder for idctN stage 1: even/odd split applied recursively."""
    if n == 1:
        return [0]
    evens = [2 * i for i in _reorder(n // 2)]
    return evens + _odd_order(n)


def _idct_generic(s, n, c, hb=_hb):
    """AV1 idctN butterfly network, generic over n (4..64): the recursive
    stage structure extracted from (and exactly reproducing, test
    test_bitstream.py::test_idct_generic_matches_explicit) the explicit
    _idct8/16/32 above. `s` is the reordered input; `hb` is the rotation
    primitive — float _hb for the basis matrices, or a rounding
    half-butterfly for integer mirrors."""
    if n == 4:
        b0 = hb(c[32], s[0], c[32], s[1])
        b1 = hb(c[32], s[0], -c[32], s[1])
        b2 = hb(c[48], s[2], -c[16], s[3])
        b3 = hb(c[16], s[2], c[48], s[3])
        return [b0 + b3, b1 + b2, b1 - b2, b0 - b3]
    m = n // 2
    t = _idct_generic(s[:m], m, c, hb)
    x = list(s[m:])
    # stage b: cross-middle rotations, angles from the odd input order
    oo = _odd_order(n)
    scale = 64 // n
    b = [0.0] * m
    for p in range(m // 2):
        q = oo[p] * scale
        b[p] = hb(c[64 - q], x[p], -c[q], x[m - 1 - p])
        b[m - 1 - p] = hb(c[q], x[p], c[64 - q], x[m - 1 - p])
    # stage c: add/sub in pairs, sign pattern alternating by pair parity
    x = b
    nx = [0.0] * m
    for k in range(m // 2):
        a0, a1 = x[2 * k], x[2 * k + 1]
        if k % 2 == 0:
            nx[2 * k], nx[2 * k + 1] = a0 + a1, a0 - a1
        else:
            nx[2 * k], nx[2 * k + 1] = a1 - a0, a1 + a0
    x = nx
    # merge levels: rotation (cross-middle pairs, middle half of each
    # 2g-block) then add/sub within g-doubled groups
    g = 2
    while g <= m // 2:
        G = 2 * g
        amul = 64 * g // m
        nx = list(x)
        for p in range(m // 2):
            pm = p % G
            if not (G // 4 <= pm < 3 * G // 4):
                continue
            j = m - 1 - p
            a = amul * (1 + 4 * _brev(p // G, max((m // (2 * G)) - 1, 0).bit_length()))
            if pm < G // 2:
                nx[p] = hb(-c[a], x[p], c[64 - a], x[j])
                nx[j] = hb(c[64 - a], x[p], c[a], x[j])
            else:
                nx[p] = hb(-c[64 - a], x[p], -c[a], x[j])
                nx[j] = hb(-c[a], x[p], c[64 - a], x[j])
        x = nx
        if G < m:  # the final level's add/sub IS the cross-merge below
            nx = [0.0] * m
            for base in range(0, m, G):
                odd_grp = (base // G) % 2
                for i in range(G // 2):
                    lo, hi = x[base + i], x[base + G - 1 - i]
                    if odd_grp == 0:
                        nx[base + i], nx[base + G - 1 - i] = lo + hi, lo - hi
                    else:
                        nx[base + i], nx[base + G - 1 - i] = hi - lo, hi + lo
            x = nx
        g *= 2
    return [t[i] + x[m - 1 - i] for i in range(m)] + [
        t[m - 1 - i] - x[i] for i in range(m)
    ]


def _idct_1d(x, n):
    c = _cospi()
    s = [x[i] for i in _reorder(n)]
    if n == 4:
        return _idct4(s, c)
    if n == 8:
        return _idct8(s, c)
    if n == 16:
        return _idct16(s, c)
    if n == 32:
        return _idct32(s, c)
    if n == 64:
        return _idct_generic(s, 64, c)
    raise ValueError(n)


@lru_cache(maxsize=None)
def idct_basis(n: int) -> np.ndarray:
    """(n, n) float64: column j = AV1 idct of unit coefficient j, normalized
    to ~orthonormal scale (matches ideal DCT-III to the 12-bit constant
    quantization). Validated against the ideal DCT at build time."""
    cols = []
    for j in range(n):
        e = [0.0] * n
        e[j] = 1.0
        cols.append(_idct_1d(e, n))
    m = np.array(cols, dtype=np.float64).T  # (out, coef)
    # AV1 idct output scale: the DC column is constant cospi32^k ...;
    # normalize so that column norms ~ 1 (ideal DCT-III basis)
    scale = 1.0 / np.linalg.norm(m[:, 0]) * 1.0
    m = m * scale
    ideal = _ideal_idct(n)
    err = np.abs(m - ideal).max()
    assert err < 5e-3, (n, err)
    return m


@lru_cache(maxsize=1)
def _sinpi() -> np.ndarray:
    arr = tables.get("sinpi")
    row = arr[2].astype(np.float64)  # bit 12
    return row / 4096.0


def _iadst4(x, sp):
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
    o0 = s0 + s3
    o1 = s1 + s3
    o2 = s2
    o3 = (s0 + s1) - s3
    return [o0, o1, o2, o3]


def _iadst8(x, c):
    # stage 1 reorder (with implicit signs applied at the end)
    b = [x[7], x[0], x[5], x[2], x[3], x[4], x[1], x[6]]
    # stage 2
    s = [
        _hb(c[4], b[0], c[60], b[1]),
        _hb(c[60], b[0], -c[4], b[1]),
        _hb(c[20], b[2], c[44], b[3]),
        _hb(c[44], b[2], -c[20], b[3]),
        _hb(c[36], b[4], c[28], b[5]),
        _hb(c[28], b[4], -c[36], b[5]),
        _hb(c[52], b[6], c[12], b[7]),
        _hb(c[12], b[6], -c[52], b[7]),
    ]
    # stage 3
    t = [
        s[0] + s[4], s[1] + s[5], s[2] + s[6], s[3] + s[7],
        s[0] - s[4], s[1] - s[5], s[2] - s[6], s[3] - s[7],
    ]
    # stage 4
    u = list(t)
    u[4] = _hb(c[16], t[4], c[48], t[5])
    u[5] = _hb(c[48], t[4], -c[16], t[5])
    u[6] = _hb(-c[48], t[6], c[16], t[7])
    u[7] = _hb(c[16], t[6], c[48], t[7])
    # stage 5
    v = [
        u[0] + u[2], u[1] + u[3], u[0] - u[2], u[1] - u[3],
        u[4] + u[6], u[5] + u[7], u[4] - u[6], u[5] - u[7],
    ]
    # stage 6
    w = list(v)
    w[2] = _hb(c[32], v[2], c[32], v[3])
    w[3] = _hb(c[32], v[2], -c[32], v[3])
    w[6] = _hb(c[32], v[6], c[32], v[7])
    w[7] = _hb(c[32], v[6], -c[32], v[7])
    # stage 7
    return [w[0], -w[4], w[6], -w[2], w[3], -w[7], w[5], -w[1]]


def _iadst16(x, c):
    b = [x[15], x[0], x[13], x[2], x[11], x[4], x[9], x[6],
         x[7], x[8], x[5], x[10], x[3], x[12], x[1], x[14]]
    s = [
        _hb(c[2], b[0], c[62], b[1]),
        _hb(c[62], b[0], -c[2], b[1]),
        _hb(c[10], b[2], c[54], b[3]),
        _hb(c[54], b[2], -c[10], b[3]),
        _hb(c[18], b[4], c[46], b[5]),
        _hb(c[46], b[4], -c[18], b[5]),
        _hb(c[26], b[6], c[38], b[7]),
        _hb(c[38], b[6], -c[26], b[7]),
        _hb(c[34], b[8], c[30], b[9]),
        _hb(c[30], b[8], -c[34], b[9]),
        _hb(c[42], b[10], c[22], b[11]),
        _hb(c[22], b[10], -c[42], b[11]),
        _hb(c[50], b[12], c[14], b[13]),
        _hb(c[14], b[12], -c[50], b[13]),
        _hb(c[58], b[14], c[6], b[15]),
        _hb(c[6], b[14], -c[58], b[15]),
    ]
    t = [s[i] + s[i + 8] for i in range(8)] + [
        s[i] - s[i + 8] for i in range(8)
    ]
    u = list(t)
    u[8] = _hb(c[8], t[8], c[56], t[9])
    u[9] = _hb(c[56], t[8], -c[8], t[9])
    u[10] = _hb(c[40], t[10], c[24], t[11])
    u[11] = _hb(c[24], t[10], -c[40], t[11])
    u[12] = _hb(-c[56], t[12], c[8], t[13])
    u[13] = _hb(c[8], t[12], c[56], t[13])
    u[14] = _hb(-c[24], t[14], c[40], t[15])
    u[15] = _hb(c[40], t[14], c[24], t[15])
    v = [u[i] + u[i + 4] for i in range(4)] + [
        u[i] - u[i + 4] for i in range(4)
    ] + [u[8 + i] + u[12 + i] for i in range(4)] + [
        u[8 + i] - u[12 + i] for i in range(4)
    ]
    w = list(v)
    w[4] = _hb(c[16], v[4], c[48], v[5])
    w[5] = _hb(c[48], v[4], -c[16], v[5])
    w[6] = _hb(-c[48], v[6], c[16], v[7])
    w[7] = _hb(c[16], v[6], c[48], v[7])
    w[12] = _hb(c[16], v[12], c[48], v[13])
    w[13] = _hb(c[48], v[12], -c[16], v[13])
    w[14] = _hb(-c[48], v[14], c[16], v[15])
    w[15] = _hb(c[16], v[14], c[48], v[15])
    y = [w[i] + w[i + 2] for i in (0, 1)] + [
        w[i] - w[i + 2] for i in (0, 1)
    ] + [w[4 + i] + w[6 + i] for i in (0, 1)] + [
        w[4 + i] - w[6 + i] for i in (0, 1)
    ] + [w[8 + i] + w[10 + i] for i in (0, 1)] + [
        w[8 + i] - w[10 + i] for i in (0, 1)
    ] + [w[12 + i] + w[14 + i] for i in (0, 1)] + [
        w[12 + i] - w[14 + i] for i in (0, 1)
    ]
    z = list(y)
    for k in (2, 6, 10, 14):
        z[k] = _hb(c[32], y[k], c[32], y[k + 1])
        z[k + 1] = _hb(c[32], y[k], -c[32], y[k + 1])
    return [z[0], -z[8], z[12], -z[4], z[6], -z[14], z[10], -z[2],
            z[3], -z[11], z[15], -z[7], z[5], -z[13], z[9], -z[1]]


def _iadst_1d(x, n):
    if n == 4:
        return _iadst4(x, _sinpi())
    c = _cospi()
    if n == 8:
        return _iadst8(x, c)
    if n == 16:
        return _iadst16(x, c)
    raise ValueError(n)


@lru_cache(maxsize=None)
def iadst_basis(n: int) -> np.ndarray:
    """(n, n) float64 linear basis of the AV1 inverse ADST (column j = the
    response to unit coefficient j), normalized like idct_basis. Structural
    self-check: the basis must be near-orthonormal."""
    cols = []
    for j in range(n):
        e = [0.0] * n
        e[j] = 1.0
        cols.append(_iadst_1d(e, n))
    m = np.array(cols, dtype=np.float64).T
    scale = 1.0 / np.linalg.norm(m[:, 0])
    m = m * scale
    gram = m.T @ m
    err = np.abs(gram - np.eye(n)).max()
    assert err < 2e-2, (n, err)
    return m


@lru_cache(maxsize=None)
def _ideal_idct(n: int) -> np.ndarray:
    k = np.arange(n)
    d = np.cos(np.pi * (2 * k[:, None] + 1) * k[None, :] / (2 * n))
    d *= np.sqrt(2.0 / n)
    d[:, 0] /= np.sqrt(2.0)
    return d
