"""Self-guided (SGRPROJ) loop restoration: filter, solver, and search.

Implements the AV1 self-guided restoration filter (spec 7.17.3) with the
exact integer arithmetic the decoder uses, vectorized over whole units as
integral-image box sums. The parameter tables (per-set radii and the
precomputed s = (1<<20 + n^2 e / 2) / (n^2 e) values, the one_by_x
reciprocal table and the x_by_xplus1 division LUT) were extracted from the
system libaom binary (.rodata at 0x47b6e0 / 0x47b260 / 0x47b2e0) and
cross-check against the formulas in the spec.

Reference behavior: rav1e's SGR loop-restoration search, enabled by the
`lrf` preset toggle with search complexity picked by `sgr_complexity`
(/root/reference/ravif/src/av1encoder.rs:573,589,623,625 — SURVEY.md §2.2).

The encoder-side gain estimates apply the filter without the decoder's
64-row stripe boundary buffers (which swap in pre-CDEF pixels for two rows
per stripe): the signaled bitstream is unaffected, only the SSE estimate
near stripe boundaries is approximate.
"""

from __future__ import annotations

import numpy as np

SGRPROJ_RST_BITS = 4
SGRPROJ_PRJ_BITS = 7
SGRPROJ_SGR_BITS = 8
SGRPROJ_MTABLE_BITS = 20
SGRPROJ_RECIP_BITS = 12
SGRPROJ_PRJ_SUBEXP_K = 4
SGRPROJ_BORDER = 3

XQD_MIN = (-96, -32)
XQD_MAX = (31, 95)

# {r0, r1, s0, s1} per sgr set (libaom av1_sgr_params, validated against
# s = ((1 << 20) + n^2 e / 2) / (n^2 e) for the spec's e values)
SGR_PARAMS = (
    (2, 1, 140, 3236), (2, 1, 112, 2158), (2, 1, 93, 1618), (2, 1, 80, 1438),
    (2, 1, 70, 1295), (2, 1, 58, 1177), (2, 1, 47, 1079), (2, 1, 37, 996),
    (2, 1, 30, 925), (2, 1, 25, 863), (0, 1, -1, 2589), (0, 1, -1, 1618),
    (0, 1, -1, 1177), (0, 1, -1, 925), (2, 0, 56, -1), (2, 0, 22, -1),
)

# x_by_xplus1[z] = ((z << 8) + z/2) / (z + 1), with [0] = 1, [255] = 256
_X_BY_XPLUS1 = np.array(
    [1] + [((z << 8) + z // 2) // (z + 1) for z in range(1, 255)] + [256],
    dtype=np.int64,
)
# one_by_x[n-1] = ((1 << 12) + n/2) / n
_ONE_BY_X = np.array(
    [(4096 + n // 2) // n for n in range(1, 26)], dtype=np.int64
)


def _rpot(x, n):
    """ROUND_POWER_OF_TWO for nonnegative arrays."""
    if n == 0:
        return x
    return (x + (1 << (n - 1))) >> n


def _box(ii, r):
    """(2r+1)x(2r+1) window sums at every interior position of an integral
    image `ii` (computed over the padded grid)."""
    k = 2 * r + 1
    return (
        ii[k:, k:] - ii[:-k, k:] - ii[k:, :-k] + ii[:-k, :-k]
    )


def _ab_grid(ext, r, s, bit_depth):
    """A (a2) and B (b2) grids at every position of the (h+2, w+2) grid
    covering rows/cols -1..h of the unit. `ext` is the unit extended by
    SGRPROJ_BORDER on every side."""
    x = ext.astype(np.int64)
    ii1 = np.zeros((x.shape[0] + 1, x.shape[1] + 1), np.int64)
    ii2 = np.zeros_like(ii1)
    np.cumsum(np.cumsum(x, 0), 1, out=ii1[1:, 1:])
    np.cumsum(np.cumsum(x * x, 0), 1, out=ii2[1:, 1:])
    n = (2 * r + 1) ** 2
    # window sums centered at grid positions -1..h / -1..w: the extended
    # array has 3 border px, windows need r — offset the box view
    off = SGRPROJ_BORDER - 1 - r
    k = 2 * r + 1
    hh = ext.shape[0] - 2 * SGRPROJ_BORDER + 2
    ww = ext.shape[1] - 2 * SGRPROJ_BORDER + 2
    b = _box(ii1, r)[off : off + hh, off : off + ww]
    a = _box(ii2, r)[off : off + hh, off : off + ww]
    d = bit_depth - 8
    a = _rpot(a, 2 * d)
    bd = _rpot(b, d)
    p = np.maximum(0, a * n - bd * bd)
    z = _rpot(p * s, SGRPROJ_MTABLE_BITS)
    a2 = _X_BY_XPLUS1[np.minimum(z, 255)]
    one_over_n = _ONE_BY_X[n - 1]
    b2 = _rpot(((1 << SGRPROJ_SGR_BITS) - a2) * b * one_over_n,
               SGRPROJ_RECIP_BITS)
    return a2, b2


def _pad3(frame, y0, y1, x0, x1):
    """Unit [y0:y1, x0:x1] extended by 3 px using real frame pixels where
    available, edge replication at frame borders."""
    h, w = frame.shape
    ys = max(0, y0 - SGRPROJ_BORDER)
    ye = min(h, y1 + SGRPROJ_BORDER)
    xs = max(0, x0 - SGRPROJ_BORDER)
    xe = min(w, x1 + SGRPROJ_BORDER)
    core = frame[ys:ye, xs:xe]
    return np.pad(
        core,
        ((SGRPROJ_BORDER - (y0 - ys), SGRPROJ_BORDER - (ye - y1)),
         (SGRPROJ_BORDER - (x0 - xs), SGRPROJ_BORDER - (xe - x1))),
        mode="edge",
    )


def selfguided_filter(ext, r, s, bit_depth):
    """One box-filter pass over a unit: `ext` is the (h+6, w+6) extended
    unit; returns flt (h, w) int64 in the RST_BITS (x16) domain.
    r == 2 uses the subsampled fast path (A/B on odd rows only)."""
    h = ext.shape[0] - 2 * SGRPROJ_BORDER
    w = ext.shape[1] - 2 * SGRPROJ_BORDER
    a2, b2 = _ab_grid(ext, r, s, bit_depth)  # rows/cols -1..h
    dgd = ext[SGRPROJ_BORDER : SGRPROJ_BORDER + h,
              SGRPROJ_BORDER : SGRPROJ_BORDER + w].astype(np.int64)
    # index helpers into the (h+2, w+2) grid: grid[i+1, j+1] = pos (i, j)
    C = a2[1:-1, 1:-1]
    L = a2[1:-1, :-2]
    R = a2[1:-1, 2:]
    U = a2[:-2, 1:-1]
    D = a2[2:, 1:-1]
    UL = a2[:-2, :-2]
    UR = a2[:-2, 2:]
    DL = a2[2:, :-2]
    DR = a2[2:, 2:]
    Cb = b2[1:-1, 1:-1]
    Lb = b2[1:-1, :-2]
    Rb = b2[1:-1, 2:]
    Ub = b2[:-2, 1:-1]
    Db = b2[2:, 1:-1]
    ULb = b2[:-2, :-2]
    URb = b2[:-2, 2:]
    DLb = b2[2:, :-2]
    DRb = b2[2:, 2:]
    if r == 2:
        # fast path: A/B valid on odd unit rows (-1, 1, 3, ...); even
        # output rows read rows above+below, odd rows their own row
        a_even = 6 * (U + D) + 5 * (UL + UR + DL + DR)
        b_even = 6 * (Ub + Db) + 5 * (ULb + URb + DLb + DRb)
        a_odd = 6 * C + 5 * (L + R)
        b_odd = 6 * Cb + 5 * (Lb + Rb)
        even = _rpot(a_even * dgd + b_even,
                     SGRPROJ_SGR_BITS + 5 - SGRPROJ_RST_BITS)
        odd = _rpot(a_odd * dgd + b_odd,
                    SGRPROJ_SGR_BITS + 4 - SGRPROJ_RST_BITS)
        out = np.where((np.arange(h) & 1)[:, None] == 0, even, odd)
        return out
    a = 4 * (C + L + R + U + D) + 3 * (UL + UR + DL + DR)
    b = 4 * (Cb + Lb + Rb + Ub + Db) + 3 * (ULb + URb + DLb + DRb)
    return _rpot(a * dgd + b, SGRPROJ_SGR_BITS + 5 - SGRPROJ_RST_BITS)


def decode_xq(xqd, sgr_set):
    """libaom av1_decode_xq."""
    r0, r1 = SGR_PARAMS[sgr_set][0], SGR_PARAMS[sgr_set][1]
    if r0 == 0:
        xq0 = 0
        xq1 = (1 << SGRPROJ_PRJ_BITS) - xq0 - xqd[1]
    elif r1 == 0:
        xq0 = xqd[0]
        xq1 = 0
    else:
        xq0 = xqd[0]
        xq1 = (1 << SGRPROJ_PRJ_BITS) - xq0 - xqd[1]
    return xq0, xq1


def apply_sgr(frame, y0, y1, x0, x1, sgr_set, xqd, bit_depth):
    """Decoder-exact SGRPROJ output for one unit (no stripe boundaries):
    returns the restored (y1-y0, x1-x0) int32 pixels."""
    r0, r1, s0, s1 = SGR_PARAMS[sgr_set]
    ext = _pad3(frame, y0, y1, x0, x1)
    dgd = frame[y0:y1, x0:x1].astype(np.int64)
    u = dgd << SGRPROJ_RST_BITS
    v = u.astype(np.int64) << SGRPROJ_PRJ_BITS
    xq0, xq1 = decode_xq(xqd, sgr_set)
    if r0 > 0:
        flt0 = selfguided_filter(ext, 2, s0, bit_depth)
        v = v + xq0 * (flt0 - u)
    if r1 > 0:
        flt1 = selfguided_filter(ext, 1, s1, bit_depth)
        v = v + xq1 * (flt1 - u)
    # signed rounding shift (ROUND_POWER_OF_TWO on possibly negative v)
    sh = SGRPROJ_PRJ_BITS + SGRPROJ_RST_BITS
    w = (v + (1 << (sh - 1))) >> sh
    return np.clip(w, 0, (1 << bit_depth) - 1).astype(np.int32)


def _apply_from_flt(dgd, flt0, flt1, sgr_set, xqd, bit_depth):
    """Integer SGRPROJ output given precomputed filter passes."""
    u = dgd << SGRPROJ_RST_BITS
    v = u << SGRPROJ_PRJ_BITS
    xq0, xq1 = decode_xq(xqd, sgr_set)
    if flt0 is not None:
        v = v + xq0 * (flt0 - u)
    if flt1 is not None:
        v = v + xq1 * (flt1 - u)
    sh = SGRPROJ_PRJ_BITS + SGRPROJ_RST_BITS
    w = (v + (1 << (sh - 1))) >> sh
    return np.clip(w, 0, (1 << bit_depth) - 1)


def solve_unit(src, frame, y0, y1, x0, x1, sgr_set, bit_depth, ext=None):
    """Least-squares projection coefficients for one unit and set:
    returns (xqd0, xqd1, sse) with sse the exact integer output SSE."""
    r0, r1, s0, s1 = SGR_PARAMS[sgr_set]
    if ext is None:
        ext = _pad3(frame, y0, y1, x0, x1)
    dgd = frame[y0:y1, x0:x1].astype(np.int64)
    uq = dgd << SGRPROJ_RST_BITS
    u = uq.astype(np.float64)
    tgt = (src[y0:y1, x0:x1].astype(np.int64) << SGRPROJ_RST_BITS) - u
    flt0 = flt1 = None
    f0 = f1 = None
    if r0 > 0:
        flt0 = selfguided_filter(ext, 2, s0, bit_depth)
        f0 = flt0.astype(np.float64) - u
    if r1 > 0:
        flt1 = selfguided_filter(ext, 1, s1, bit_depth)
        f1 = flt1.astype(np.float64) - u
    scale = float(1 << SGRPROJ_PRJ_BITS)
    if f0 is not None and f1 is not None:
        h00 = (f0 * f0).sum()
        h11 = (f1 * f1).sum()
        h01 = (f0 * f1).sum()
        c0 = (f0 * tgt).sum()
        c1 = (f1 * tgt).sum()
        det = h00 * h11 - h01 * h01
        if det <= 0:
            b0 = b1 = 0.0
        else:
            b0 = scale * (h11 * c0 - h01 * c1) / det
            b1 = scale * (h00 * c1 - h01 * c0) / det
    elif f0 is not None:
        h00 = (f0 * f0).sum()
        b0 = scale * (f0 * tgt).sum() / h00 if h00 > 0 else 0.0
        b1 = 0.0
    else:
        h11 = (f1 * f1).sum()
        b1 = scale * (f1 * tgt).sum() / h11 if h11 > 0 else 0.0
        b0 = 0.0

    xq0 = int(np.clip(round(b0), XQD_MIN[0], XQD_MAX[0])) if r0 else 0
    if r1:
        xqd1 = int(
            np.clip((1 << SGRPROJ_PRJ_BITS) - xq0 - round(b1),
                    XQD_MIN[1], XQD_MAX[1])
        )
    else:
        xqd1 = int(
            np.clip((1 << SGRPROJ_PRJ_BITS) - xq0, XQD_MIN[1], XQD_MAX[1])
        )
    out = _apply_from_flt(dgd, flt0, flt1, sgr_set, (xq0, xqd1), bit_depth)
    d = out - src[y0:y1, x0:x1]
    return xq0, xqd1, float((d * d).sum())


# sets searched per complexity tier: `sgr_complexity_full` (preset s<=2)
# searches all 16; the reduced tier keeps a spread over both radii and the
# single-radius families (rav1e's reduced SGR complexity analog)
FULL_SETS = tuple(range(16))
REDUCED_SETS = (0, 3, 6, 9, 11, 14)


def search_unit(src, frame, y0, y1, x0, x1, bit_depth, full: bool):
    """Best (set, xqd, sse) over the searched sgr sets for one unit."""
    ext = _pad3(frame, y0, y1, x0, x1)
    best = None
    for s in (FULL_SETS if full else REDUCED_SETS):
        x0q, x1q, sse = solve_unit(
            src, frame, y0, y1, x0, x1, s, bit_depth, ext=ext
        )
        if best is None or sse < best[2]:
            best = (s, (x0q, x1q), sse)
    return best
