"""AV1 intra prediction (spec 7.11.2), bit-exact integer predictors.

Prediction must match the decoder exactly: the decoder reconstructs as
pred + residual, so any deviation in the encoder's predictor shifts decoded
pixels. Implemented: all 13 modes — DC, V, H, SMOOTH, SMOOTH_V, SMOOTH_H,
PAETH and the 8 directional modes (spec 7.11.2.4 zones 1-3) with angle
deltas. The sequence header disables intra edge filtering/upsampling, so
neighbor rows/cols are used unfiltered. Validated pixel-exact against
dav1d for every mode/delta/availability case.

All functions are vectorized numpy over a single block; the device path
batches the same arithmetic over many blocks (ops/ kernels).

Reference parity: rav1e's intra prediction stage, selected via
prediction_modes / fine_directional_intra speed knobs (SURVEY.md §2.2).
"""

from __future__ import annotations

import numpy as np

from . import tables
from .symbols import (
    D45,
    D67,
    D113,
    D135,
    D157,
    D203,
    DC_PRED,
    H_PRED,
    PAETH_PRED,
    SMOOTH_H,
    SMOOTH_PRED,
    SMOOTH_V,
    V_PRED,
)


def _sm_weights(n: int) -> np.ndarray:
    return tables.get(f"sm_weights_{n}").astype(np.int64)


# base prediction angles (spec Mode_Angle), indexed by mode - V_PRED
MODE_ANGLE = [90, 180, 45, 135, 113, 157, 203, 67]

DIRECTIONAL_MODES = [V_PRED, H_PRED, D45, D135, D113, D157, D203, D67]


def _dr(angle: int) -> int:
    return int(tables.get("dr_intra_derivative")[angle])


INTRA_EDGE_KERNELS = (
    (0, 4, 8, 4, 0), (0, 5, 6, 5, 0), (2, 4, 4, 4, 2),
)


def edge_filter_strength(w: int, h: int, filter_type: int, delta: int) -> int:
    """spec intra_edge_filter_strength (7.11.2.9)."""
    d = abs(delta)
    blk_wh = w + h
    if filter_type == 0:
        if blk_wh <= 8:
            if d >= 56:
                return 1
        elif blk_wh <= 12:
            if d >= 40:
                return 1
        elif blk_wh <= 16:
            if d >= 40:
                return 1
        elif blk_wh <= 24:
            if d >= 32:
                return 3
            if d >= 16:
                return 2
            if d >= 8:
                return 1
        elif blk_wh <= 32:
            if d >= 32:
                return 3
            if d >= 4:
                return 2
            return 1
        else:
            return 3
        return 0
    if blk_wh <= 8:
        if d >= 64:
            return 2
        if d >= 40:
            return 1
    elif blk_wh <= 16:
        if d >= 48:
            return 2
        if d >= 20:
            return 1
    elif blk_wh <= 24:
        if d >= 4:
            return 3
    else:
        return 3
    return 0


def use_edge_upsample(w: int, h: int, filter_type: int, delta: int) -> bool:
    """spec use_intra_edge_upsample (7.11.2.10)."""
    d = abs(delta)
    blk_wh = w + h
    if d <= 0 or d >= 40:
        return False
    return blk_wh <= 8 if filter_type else blk_wh <= 16


def _apply_edge_filter(edge: np.ndarray, sz: int, strength: int) -> None:
    """spec intra_edge_filter (7.11.2.12): edge[0] is the corner (index
    -1); smooths entries 1..sz-1 in place from a copy."""
    if strength == 0 or sz < 2:
        return
    k = INTRA_EDGE_KERNELS[strength - 1]
    orig = edge[:sz].copy()
    for i in range(1, sz):
        s = 0
        for j in range(5):
            idx = min(max(i - 2 + j, 0), sz - 1)
            s += k[j] * int(orig[idx])
        edge[i] = (s + 8) >> 4


def _upsample_edge(edge_vals: np.ndarray, sz: int, bit_depth: int):
    """spec intra_edge_upsample (7.11.2.11): edge_vals[0] is the corner
    (index -1), 1..sz the edge; returns the upsampled buffer indexed so
    ret[2 + k] == buf[k] for k in -2..2*sz-2 (buf in spec indexing)."""
    dup = np.empty(sz + 3, dtype=np.int64)
    dup[0] = edge_vals[0]
    dup[1 : sz + 2] = edge_vals[: sz + 1]
    dup[sz + 2] = edge_vals[sz]
    maxv = (1 << bit_depth) - 1
    out = np.empty(2 * sz + 2, dtype=np.int64)  # buf[-2 .. 2*sz-2] at +2
    out[0] = dup[0]  # buf[-2]
    for i in range(sz):
        s = -dup[i] + 9 * dup[i + 1] + 9 * dup[i + 2] - dup[i + 3]
        s = min(max((s + 8) >> 4, 0), maxv)
        out[2 + 2 * i - 1] = s        # buf[2i - 1]
        out[2 + 2 * i] = dup[i + 2]   # buf[2i]
    return out


def predict_directional(
    mode: int,
    angle_delta: int,
    above_ext: np.ndarray,  # (w + h,) int64, AboveRow[0..w+h-1]
    left_ext: np.ndarray,  # (w + h,) int64, LeftCol[0..w+h-1]
    above_left: int,  # AboveRow[-1] == LeftCol[-1]
    w: int,
    h: int,
    edge_filter: bool = False,
    filter_type: int = 0,
    have_above: bool = True,
    have_left: bool = True,
    n_top_px: int = 0,  # valid above pixels (min(w, maxX-x+1) etc)
    n_left_px: int = 0,
    bit_depth: int = 10,
) -> np.ndarray:
    """Spec 7.11.2.4 directional predictor. With `edge_filter` the spec's
    intra edge corner/edge smoothing and upsampling run first (7.11.2.9-12);
    n_top_px / n_left_px bound the smoothed spans like the decoder's maxX/
    maxY clamp. Returns (h, w) int32."""
    p_angle = MODE_ANGLE[mode - V_PRED] + angle_delta * 3
    up_a = up_l = 0
    if edge_filter and p_angle not in (90, 180):
        above_ext = above_ext.astype(np.int64).copy()
        left_ext = left_ext.astype(np.int64).copy()
        if (90 < p_angle < 180 and (w + h) >= 24
                and have_left and have_above):
            above_left = (
                int(left_ext[0]) * 5 + int(above_left) * 6
                + int(above_ext[0]) * 5 + 8
            ) >> 4
        if have_above:
            strength = edge_filter_strength(w, h, filter_type, p_angle - 90)
            n_px = min(w, max(n_top_px, 0)) + (h if p_angle < 90 else 0)
            buf = np.empty(1 + len(above_ext), dtype=np.int64)
            buf[0] = above_left
            buf[1:] = above_ext
            _apply_edge_filter(buf, n_px + 1, strength)
            above_left = int(buf[0])
            above_ext = buf[1:]
        if have_left:
            strength = edge_filter_strength(w, h, filter_type, p_angle - 180)
            n_px = min(h, max(n_left_px, 0)) + (w if p_angle > 180 else 0)
            buf = np.empty(1 + len(left_ext), dtype=np.int64)
            buf[0] = above_left
            buf[1:] = left_ext
            _apply_edge_filter(buf, n_px + 1, strength)
            left_ext = buf[1:]
        up_a = int(use_edge_upsample(w, h, filter_type, p_angle - 90))
        up_l = int(use_edge_upsample(w, h, filter_type, p_angle - 180))
    i = np.arange(h, dtype=np.int64)[:, None]
    j = np.arange(w, dtype=np.int64)[None, :]
    if p_angle == 90:
        return np.broadcast_to(above_ext[:w][None, :], (h, w)).astype(np.int32)
    if p_angle == 180:
        return np.broadcast_to(left_ext[:h][:, None], (h, w)).astype(np.int32)
    if up_a:
        n_px = w + (h if p_angle < 90 else 0)
        ab_up = _upsample_edge(
            np.concatenate(([above_left], above_ext)), n_px, bit_depth
        )
    if up_l:
        n_px = h + (w if p_angle > 180 else 0)
        lc_up = _upsample_edge(
            np.concatenate(([above_left], left_ext)), n_px, bit_depth
        )
    i = np.arange(h, dtype=np.int64)[:, None]
    j = np.arange(w, dtype=np.int64)[None, :]
    if p_angle == 90:
        return np.broadcast_to(above_ext[:w][None, :], (h, w)).astype(np.int32)
    if p_angle == 180:
        return np.broadcast_to(left_ext[:h][:, None], (h, w)).astype(np.int32)
    if p_angle < 90:
        dx = _dr(p_angle)
        idx = (i + 1) * dx
        if up_a:
            # upsampled AboveRow: buf[k] at ab_up[2 + k]
            base = (idx >> (6 - 1)) + (j << 1)
            shift = ((idx << 1) >> 1) & 0x1F
            max_base = ((w + h - 1) << 1)
            src = ab_up[2:]
            b = np.minimum(base, max_base)
            b1 = np.minimum(base + 1, max_base)
            val = (src[b] * (32 - shift) + src[b1] * shift + 16) >> 5
            return np.where(base < max_base, val, src[max_base]).astype(
                np.int32
            )
        base = (idx >> 6) + j
        shift = (idx >> 1) & 0x1F
        max_base = w + h - 1
        b = np.minimum(base, max_base)
        b1 = np.minimum(base + 1, max_base)
        val = (above_ext[b] * (32 - shift) + above_ext[b1] * shift + 16) >> 5
        return np.where(base < max_base, val, above_ext[max_base]).astype(
            np.int32
        )
    if p_angle < 180:
        dx = _dr(180 - p_angle)
        dy = _dr(p_angle - 90)
        if up_a:
            idx = (j << (6 + 1)) - (i + 1) * (dx << 1)
            base = idx >> 6
            shift = (idx >> 1) & 0x1F
            src_a = ab_up  # buf[k] at [2 + k]; valid k >= -2
            bidx = np.clip(base, -2, len(src_a) - 4)
            above_val = (
                src_a[bidx + 2] * (32 - shift) + src_a[bidx + 3] * shift + 16
            ) >> 5
        else:
            idx = (j << 6) - (i + 1) * dx
            base = idx >> 6
            shift = (idx >> 1) & 0x1F
            ab = np.concatenate(([above_left], above_ext))
            bidx = np.clip(base, -1, w + h - 2)
            above_val = (
                ab[bidx + 1] * (32 - shift) + ab[bidx + 2] * shift + 16
            ) >> 5
        if up_l:
            idx2 = (i << (6 + 1)) - (j + 1) * (dy << 1)
            base2 = idx2 >> 6
            shift2 = (idx2 >> 1) & 0x1F
            src_l = lc_up
            b2 = np.clip(base2, -2, len(src_l) - 4)
            left_val = (
                src_l[b2 + 2] * (32 - shift2) + src_l[b2 + 3] * shift2 + 16
            ) >> 5
        else:
            idx2 = (i << 6) - (j + 1) * dy
            base2 = idx2 >> 6
            shift2 = (idx2 >> 1) & 0x1F
            lc = np.concatenate(([above_left], left_ext))
            b2 = np.clip(base2, -1, w + h - 2)
            left_val = (
                lc[b2 + 1] * (32 - shift2) + lc[b2 + 2] * shift2 + 16
            ) >> 5
        return np.where(base >= -(1 << up_a), above_val,
                        left_val).astype(np.int32)
    # p_angle > 180
    dy = _dr(270 - p_angle)
    idx = (j + 1) * dy
    if up_l:
        base = (idx >> (6 - 1)) + (i << 1)
        shift = ((idx << 1) >> 1) & 0x1F
        max_base = ((w + h - 1) << 1)
        src = lc_up[2:]
        b = np.minimum(base, max_base)
        b1 = np.minimum(base + 1, max_base)
        val = (src[b] * (32 - shift) + src[b1] * shift + 16) >> 5
        return np.where(base < max_base, val, src[max_base]).astype(np.int32)
    base = (idx >> 6) + i
    shift = (idx >> 1) & 0x1F
    max_base = w + h - 1
    b = np.minimum(base, max_base)
    b1 = np.minimum(base + 1, max_base)
    val = (left_ext[b] * (32 - shift) + left_ext[b1] * shift + 16) >> 5
    return np.where(base < max_base, val, left_ext[max_base]).astype(np.int32)


def predict(
    mode: int,
    above: np.ndarray | None,
    left: np.ndarray | None,
    above_left: int | None,
    w: int,
    h: int,
    bit_depth: int,
) -> np.ndarray:
    """Neighbors: above (w,), left (h,) reconstructed pixels (int arrays) or
    None when unavailable; above_left scalar. Returns (h, w) int32."""
    base = 1 << (bit_depth - 1)
    maxv = (1 << bit_depth) - 1
    have_a = above is not None
    have_l = left is not None
    # spec: unavailable edges are synthesized for non-DC modes
    if not have_a and not have_l:
        above_arr = np.full(w, base - 1, dtype=np.int64)
        left_arr = np.full(h, base + 1, dtype=np.int64)
        al = base
    elif not have_a:
        above_arr = np.full(w, int(left[0]), dtype=np.int64)
        left_arr = left.astype(np.int64)
        al = int(left[0])
    elif not have_l:
        above_arr = above.astype(np.int64)
        left_arr = np.full(h, int(above[0]), dtype=np.int64)
        al = int(above[0])
    else:
        above_arr = above.astype(np.int64)
        left_arr = left.astype(np.int64)
        al = int(above_left) if above_left is not None else int(above[0])

    if mode == DC_PRED:
        if have_a and have_l:
            s = int(above_arr.sum() + left_arr.sum())
            avg = (s + ((w + h) >> 1)) // (w + h)
        elif have_a:
            avg = (int(above_arr.sum()) + (w >> 1)) >> (w.bit_length() - 1)
        elif have_l:
            avg = (int(left_arr.sum()) + (h >> 1)) >> (h.bit_length() - 1)
        else:
            avg = base
        return np.full((h, w), avg, dtype=np.int32)

    if mode == V_PRED:
        return np.broadcast_to(above_arr, (h, w)).astype(np.int32)

    if mode == H_PRED:
        return np.broadcast_to(left_arr[:, None], (h, w)).astype(np.int32)

    if mode == PAETH_PRED:
        b = left_arr[:, None] + above_arr[None, :] - al
        pl = np.abs(b - left_arr[:, None])
        pt = np.abs(b - above_arr[None, :])
        ptl = np.abs(b - al)
        out = np.where(
            (pl <= pt) & (pl <= ptl),
            left_arr[:, None],
            np.where(pt <= ptl, above_arr[None, :], al),
        )
        return out.astype(np.int32)

    if mode == SMOOTH_PRED:
        wh = _sm_weights(h)
        ww = _sm_weights(w)
        below = int(left_arr[h - 1])
        right = int(above_arr[w - 1])
        # spec smooth: pred = (w_h[y]*above[x] + (256-w_h[y])*below
        #                     + w_w[x]*left[y] + (256-w_w[x])*right + 256) >> 9
        t = (
            wh[:, None] * above_arr[None, :]
            + (256 - wh[:, None]) * below
            + ww[None, :] * left_arr[:, None]
            + (256 - ww[None, :]) * right
        )
        return ((t + 256) >> 9).astype(np.int32)

    if mode == SMOOTH_V:
        wh = _sm_weights(h)
        below = int(left_arr[h - 1])
        t = wh[:, None] * above_arr[None, :] + (256 - wh[:, None]) * below
        return ((t + 128) >> 8).astype(np.int32)

    if mode == SMOOTH_H:
        ww = _sm_weights(w)
        right = int(above_arr[w - 1])
        t = ww[None, :] * left_arr[:, None] + (256 - ww[None, :]) * right
        return ((t + 128) >> 8).astype(np.int32)

    raise NotImplementedError(f"mode {mode}")


NONDIRECTIONAL_MODES = [
    DC_PRED,
    V_PRED,
    H_PRED,
    SMOOTH_PRED,
    SMOOTH_V,
    SMOOTH_H,
    PAETH_PRED,
]


from functools import lru_cache


@lru_cache(maxsize=None)
def _dir_grids(mode: int, w: int, h: int, delta: int = 0):
    """Precomputed gather grids for one directional mode/delta:
    (kind, idx0, w0, idx1, w1, mask) with int32 grids; kind selects the
    gather source arrangement."""
    p_angle = MODE_ANGLE[mode - V_PRED] + 3 * delta
    i = np.arange(h, dtype=np.int64)[:, None]
    j = np.arange(w, dtype=np.int64)[None, :]
    max_base = w + h - 1
    if p_angle == 90 or p_angle == 180:
        return ("vh", p_angle, None, None, None, None)
    if p_angle < 90:
        dx = _dr(p_angle)
        idx = (i + 1) * dx
        base = (idx >> 6) + j
        shift = ((idx >> 1) & 0x1F).astype(np.int32)
        shift = np.broadcast_to(shift, (h, w)).copy()
        b = np.minimum(base, max_base).astype(np.int32)
        b1 = np.minimum(base + 1, max_base).astype(np.int32)
        return ("above", b, 32 - shift, b1, shift, base < max_base)
    if p_angle < 180:
        dx = _dr(180 - p_angle)
        dy = _dr(p_angle - 90)
        idx = (j << 6) - (i + 1) * dx
        base = idx >> 6
        shift = ((idx >> 1) & 0x1F).astype(np.int32)
        bidx = np.clip(base, -1, w + h - 2).astype(np.int32)
        idx2 = (i << 6) - (j + 1) * dy
        base2 = idx2 >> 6
        shift2 = ((idx2 >> 1) & 0x1F).astype(np.int32)
        b2 = np.clip(base2, -1, w + h - 2).astype(np.int32)
        return (
            "zone2",
            (bidx + 1, np.broadcast_to(32 - shift, (h, w)).copy(),
             np.broadcast_to(shift, (h, w)).copy()),
            (b2 + 1, np.broadcast_to(32 - shift2, (h, w)).copy(),
             np.broadcast_to(shift2, (h, w)).copy()),
            None, None, base >= -1,
        )
    dy = _dr(270 - p_angle)
    idx = (j + 1) * dy
    base = (idx >> 6) + i
    shift = ((idx >> 1) & 0x1F).astype(np.int32)
    b = np.minimum(base, max_base).astype(np.int32)
    b1 = np.minimum(base + 1, max_base).astype(np.int32)
    return ("left", b, np.broadcast_to(32 - shift, (h, w)).copy(),
            b1, np.broadcast_to(shift, (h, w)).copy(), base < max_base)


def predict_dir_batch(
    modes: list,
    above_ext: np.ndarray,  # (B, w + h) int, spec-extended AboveRow
    left_ext: np.ndarray,  # (B, w + h)
    al: np.ndarray,  # (B,)
    w: int,
    h: int,
) -> np.ndarray:
    """Batched directional predictors over B blocks: returns
    (B, len(modes), h, w) int32. `modes` entries are mode ids (delta 0) or
    (mode, delta) pairs. Same arithmetic as predict_directional."""
    B = above_ext.shape[0]
    above_ext = above_ext.astype(np.int32, copy=False)
    left_ext = left_ext.astype(np.int32, copy=False)
    al32 = al.astype(np.int32, copy=False)
    out = np.empty((B, len(modes), h, w), dtype=np.int32)
    for mi_, mode in enumerate(modes):
        delta = 0
        if isinstance(mode, tuple):
            mode, delta = mode
        kind, a1, a2, a3, a4, mask = _dir_grids(mode, w, h, delta)
        if kind == "vh":
            if a1 == 90:
                out[:, mi_] = np.broadcast_to(
                    above_ext[:, None, :w], (B, h, w)
                )
            else:
                out[:, mi_] = np.broadcast_to(
                    left_ext[:, :h, None], (B, h, w)
                )
        elif kind == "above":
            val = (above_ext[:, a1] * a2 + above_ext[:, a3] * a4 + 16) >> 5
            out[:, mi_] = np.where(
                mask, val, above_ext[:, w + h - 1][:, None, None]
            )
        elif kind == "left":
            val = (left_ext[:, a1] * a2 + left_ext[:, a3] * a4 + 16) >> 5
            out[:, mi_] = np.where(
                mask, val, left_ext[:, w + h - 1][:, None, None]
            )
        else:  # zone2
            bidx1, wa0, wa1 = a1
            b21, wl0, wl1 = a2
            ab = np.concatenate([al32[:, None], above_ext], axis=1)
            above_val = (ab[:, bidx1] * wa0 + ab[:, bidx1 + 1] * wa1 + 16) >> 5
            lc = np.concatenate([al32[:, None], left_ext], axis=1)
            left_val = (lc[:, b21] * wl0 + lc[:, b21 + 1] * wl1 + 16) >> 5
            out[:, mi_] = np.where(mask, above_val, left_val)
    return out


def predict_all_batch(
    above: np.ndarray,
    left: np.ndarray,
    al: np.ndarray,
    have_a: np.ndarray,
    have_l: np.ndarray,
    w: int,
    h: int,
    bit_depth: int,
) -> np.ndarray:
    """Batched non-directional predictors, (B, 7, h, w) int32 in
    NONDIRECTIONAL_MODES order. Same integer arithmetic as predict();
    availability synthesis is vectorized across the batch.

    above (B, w), left (B, h), al (B,): raw neighbor pixels (contents ignored
    where the corresponding have_* flag is False)."""
    B = above.shape[0]
    base = 1 << (bit_depth - 1)
    above = above.astype(np.int32, copy=False)
    left = left.astype(np.int32, copy=False)
    al = al.astype(np.int32, copy=False)
    ha = have_a[:, None]
    hl = have_l[:, None]
    a0 = above[:, 0:1]
    l0 = left[:, 0:1]
    # availability synthesis (mirrors predict())
    above_s = np.where(ha, above, np.where(hl, l0, base - 1))
    left_s = np.where(hl, left, np.where(ha, a0, base + 1))
    al_s = np.where(
        have_a & have_l,
        al,
        np.where(have_a, above[:, 0], np.where(have_l, left[:, 0], base)),
    )

    out = np.empty((B, 7, h, w), dtype=np.int32)

    # DC: per-availability averaging over the *real* sides
    sum_a = above.sum(axis=1, dtype=np.int64)
    sum_l = left.sum(axis=1, dtype=np.int64)
    avg_both = (sum_a + sum_l + ((w + h) >> 1)) // (w + h)
    avg_a = (sum_a + (w >> 1)) >> (w.bit_length() - 1)
    avg_l = (sum_l + (h >> 1)) >> (h.bit_length() - 1)
    avg = np.where(
        have_a & have_l,
        avg_both,
        np.where(have_a, avg_a, np.where(have_l, avg_l, base)),
    )
    out[:, 0] = avg[:, None, None]

    # V / H
    out[:, 1] = np.broadcast_to(above_s[:, None, :], (B, h, w))
    out[:, 2] = np.broadcast_to(left_s[:, :, None], (B, h, w))

    # SMOOTH family
    wh = _sm_weights(h)[None, :, None]  # (1, h, 1)
    ww = _sm_weights(w)[None, None, :]  # (1, 1, w)
    below = left_s[:, h - 1][:, None, None]
    right = above_s[:, w - 1][:, None, None]
    a2 = above_s[:, None, :]
    l2 = left_s[:, :, None]
    t = wh * a2 + (256 - wh) * below + ww * l2 + (256 - ww) * right
    out[:, 3] = (t + 256) >> 9
    out[:, 4] = (wh * a2 + (256 - wh) * below + 128) >> 8
    out[:, 5] = (ww * l2 + (256 - ww) * right + 128) >> 8

    # PAETH
    alb = al_s[:, None, None]
    b = l2 + a2 - alb
    pl = np.abs(b - l2)
    pt = np.abs(b - a2)
    ptl = np.abs(b - alb)
    out[:, 6] = np.where(
        (pl <= pt) & (pl <= ptl), l2, np.where(pt <= ptl, a2, alb)
    )
    return out
