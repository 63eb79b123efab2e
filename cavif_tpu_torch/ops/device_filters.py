"""Device in-loop output filters in PyTorch: deblock, CDEF, loop restoration.

The encoder simulates the decoder's output filter chain (deblock -> CDEF
-> LR, spec 7.14/7.15/7.17) on its reconstruction to search the signaled
parameters by real output error. On the host that chain is C++
(native/tilecoder.cpp of_deblock / of_cdef_* / lr_*_plane). These filters
are data-parallel stencils and per-unit least squares with NO wavefront
dependency, so they map onto plain tensor programs: upload recon+src
once, run every search/apply pass on the device, download only the
decisions.

Bit-exactness: every stage here is integer arithmetic (the AV1 filters
are integer by spec; the search metrics are integer SSE deltas; the int64
accumulations are exact), so the device results equal native/tilecoder.cpp
BIT-FOR-BIT. Where the arithmetic needs 64 bits the cast is written out:
an int32 tensor times a Python int, a numpy int64 scalar or a 0-dim int64
tensor stays int32 in torch. The one float product (the CDEF direction
bins) is exact in float32 (|x| <= 128, at most 8 terms), with TF32 off on
the card (device_pass1.resolve_device).

Write-independence note (why the parallel deblock equals the C++'s
sequential in-place pass): AV1's filter-size selection bounds an edge's
write reach strictly inside the next edge's read reach along the same
line; a size-S filter needs >= S-px transforms on both sides, so edges
S px apart write at most S/2-1 px toward each other while reading from
S/2+1 px away (e.g. two 4-px-spaced size-4 edges write x-2..x+1 and
read p1 at x+2). The C++ of_deblock already exploits this to thread row
bands; here it makes every edge of a pass independent.

On a CUDA device each deblock pass is one launch of the hand-written
kernel csrc/deblock.cu (`deblock_pass`), which computes what the plain
`_deblock_axis` computes, bit for bit; the plain pass runs on the CPU and
is the kernel's counterpart in the tests. The level pick stays on the
device, so the deblock search and apply never wait for the card.

Entry points take `device=None` (the card; raises without one) or "cpu"
(tests) and return host numpy arrays of the JAX package's dtypes.
Reference behavior: rav1e's in-loop filter toggles as configured by
cavif (ravif src/av1encoder.rs:589-590 cdef/lrf rows); the filter math
itself is the AV1 spec's.
"""

from __future__ import annotations

import ctypes
import os
import threading
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import trace
from . import cuda_build
from .device_pass1 import resolve_device

I32, I64 = torch.int32, torch.int64

# launches of the deblock kernel (csrc/deblock.cu) in this process; the
# plain path counts nothing
LAUNCHES = {"deblock": 0}
_lock = threading.Lock()


def reset_launches() -> None:
    with _lock:
        LAUNCHES["deblock"] = 0

# window offsets: vertical-edge pass reads px[x-8 .. x+7] around an edge
# at x (size-14 reads p6 = x-7 and q6 = x+6); writes cover x-6 .. x+5
_READ_LO, _READ_HI = -8, 8  # [lo, hi) exclusive
_WRITE_LO, _WRITE_HI = -6, 6


def _rnd2(v, n):
    return (v + (1 << (n - 1))) >> n


def _edge_windows(plane, n_edges):
    """W[k][..., y, mc] = plane[..., y, 4*(mc+1) + k] for k in [-8, 8),
    columns clamped to the plane (edge replication): the 16-px read
    window of every vertical edge (edge index mc counts edges at
    x = 4, 8, ...)."""
    wd = plane.shape[-1]
    x = 4 * (torch.arange(n_edges, device=plane.device) + 1)
    return {k: plane[..., (x + k).clamp(0, wd - 1)]
            for k in range(_READ_LO, _READ_HI)}


def _filter_edges(W, size, lctx):
    """Bit-exact mirror of tilecoder.cpp filter_line for every edge at
    once. W: dict k -> (..., R, E) int32 window values (q_i = W[i], p_i =
    W[-1-i]). size: (R, E) int32 in {4, 6, 8, 14} (luma 4/8/14, chroma
    4/6). Returns (vals, written): per write offset k in [-6, 6), the
    new value and whether the filter writes it."""
    limit, blimit, thresh, clampLo, clampHi, maxv, flatF = lctx
    a = torch.abs
    p0, p1, p2, p3 = W[-1], W[-2], W[-3], W[-4]
    q0, q1, q2, q3 = W[0], W[1], W[2], W[3]

    mask = (
        (a(p1 - p0) <= limit)
        & (a(q1 - q0) <= limit)
        & (2 * a(p0 - q0) + (a(p1 - q1) >> 1) <= blimit)
    )
    m8 = (
        (a(p2 - p1) <= limit) & (a(q2 - q1) <= limit)
        & (a(p3 - p2) <= limit) & (a(q3 - q2) <= limit)
    )
    m6 = (a(p2 - p1) <= limit) & (a(q2 - q1) <= limit)
    mask = mask & torch.where(
        size >= 8, m8, torch.where(size == 6, m6, torch.ones_like(m6))
    )

    flat_base = (
        (a(p1 - p0) <= flatF) & (a(q1 - q0) <= flatF)
        & (a(p2 - p0) <= flatF) & (a(q2 - q0) <= flatF)
    )
    flat8 = flat_base & (a(p3 - p0) <= flatF) & (a(q3 - q0) <= flatF)
    q4, q5, q6 = W[4], W[5], W[6]
    p4, p5, p6 = W[-5], W[-6], W[-7]
    flat2 = (
        (a(p6 - p0) <= flatF) & (a(q6 - q0) <= flatF)
        & (a(p5 - p0) <= flatF) & (a(q5 - q0) <= flatF)
        & (a(p4 - p0) <= flatF) & (a(q4 - q0) <= flatF)
    )

    # narrow (filter4)
    clip = lambda v: torch.clamp(v, clampLo, clampHi)
    hev = (a(p1 - p0) > thresh) | (a(q1 - q0) > thresh)
    f = torch.where(hev, clip(p1 - q1), 0)
    f = clip(f + 3 * (q0 - p0))
    f1 = clip(f + 4) >> 3
    f2 = clip(f + 3) >> 3
    f3 = (f1 + 1) >> 1
    pxc = lambda v: torch.clamp(v, 0, maxv)
    n_q0 = pxc(q0 - f1)
    n_p0 = pxc(p0 + f2)
    n_q1 = torch.where(hev, q1, pxc(q1 - f3))
    n_p1 = torch.where(hev, p1, pxc(p1 + f3))

    # flat6 (chroma wide): writes p1, p0, q0, q1
    s6 = {
        -2: _rnd2(p2 * 3 + p1 * 2 + p0 * 2 + q0, 3),
        -1: _rnd2(p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1, 3),
        0: _rnd2(p1 + p0 * 2 + q0 * 2 + q1 * 2 + q2, 3),
        1: _rnd2(p0 + q0 * 2 + q1 * 2 + q2 * 3, 3),
    }
    # flat8: writes p2 .. q2
    s8 = {
        -3: _rnd2(p3 * 3 + p2 * 2 + p1 + p0 + q0, 3),
        -2: _rnd2(p3 * 2 + p2 + p1 * 2 + p0 + q0 + q1, 3),
        -1: _rnd2(p3 + p2 + p1 + p0 * 2 + q0 + q1 + q2, 3),
        0: _rnd2(p2 + p1 + p0 + q0 * 2 + q1 + q2 + q3, 3),
        1: _rnd2(p1 + p0 + q0 + q1 * 2 + q2 + q3 * 2, 3),
        2: _rnd2(p0 + q0 + q1 + q2 * 2 + q3 * 3, 3),
    }
    # flat14: writes p5 .. q5
    s14 = {
        -6: _rnd2(p6 * 7 + p5 * 2 + p4 * 2 + p3 + p2 + p1 + p0 + q0, 4),
        -5: _rnd2(p6 * 5 + p5 * 2 + p4 * 2 + p3 * 2 + p2 + p1 + p0 + q0
                  + q1, 4),
        -4: _rnd2(p6 * 4 + p5 + p4 * 2 + p3 * 2 + p2 * 2 + p1 + p0 + q0
                  + q1 + q2, 4),
        -3: _rnd2(p6 * 3 + p5 + p4 + p3 * 2 + p2 * 2 + p1 * 2 + p0 + q0
                  + q1 + q2 + q3, 4),
        -2: _rnd2(p6 * 2 + p5 + p4 + p3 + p2 * 2 + p1 * 2 + p0 * 2 + q0
                  + q1 + q2 + q3 + q4, 4),
        -1: _rnd2(p6 + p5 + p4 + p3 + p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1
                  + q2 + q3 + q4 + q5, 4),
        0: _rnd2(p5 + p4 + p3 + p2 + p1 + p0 * 2 + q0 * 2 + q1 * 2 + q2
                 + q3 + q4 + q5 + q6, 4),
        1: _rnd2(p4 + p3 + p2 + p1 + p0 + q0 * 2 + q1 * 2 + q2 * 2 + q3
                 + q4 + q5 + q6 * 2, 4),
        2: _rnd2(p3 + p2 + p1 + p0 + q0 + q1 * 2 + q2 * 2 + q3 * 2 + q4
                 + q5 + q6 * 3, 4),
        3: _rnd2(p2 + p1 + p0 + q0 + q1 + q2 * 2 + q3 * 2 + q4 * 2 + q5
                 + q6 * 4, 4),
        4: _rnd2(p1 + p0 + q0 + q1 + q2 + q3 * 2 + q4 * 2 + q5 * 2
                 + q6 * 5, 4),
        5: _rnd2(p0 + q0 + q1 + q2 + q3 + q4 * 2 + q5 * 2 + q6 * 7, 4),
    }
    narrow = {-2: n_p1, -1: n_p0, 0: n_q0, 1: n_q1}
    # filter4 writes p0/q0 always, p1/q1 only without high edge variance
    nw = {-2: ~hev, -1: mask, 0: mask, 1: ~hev}

    use14 = mask & (size == 14) & flat8 & flat2
    use8 = mask & (size >= 8) & flat8 & ~use14
    use6 = mask & (size == 6) & flat_base
    use_n = mask & ~use14 & ~use8 & ~use6

    vals, written = {}, {}
    for k in range(_WRITE_LO, _WRITE_HI):
        v = W[k]
        w = torch.zeros_like(mask)
        if k in s14:
            v = torch.where(use14, s14[k], v)
            w = w | use14
        if k in s8:
            v = torch.where(use8, s8[k], v)
            w = w | use8
        if k in s6:
            v = torch.where(use6, s6[k], v)
            w = w | use6
        if k in narrow:
            m = use_n & nw[k]
            v = torch.where(m, narrow[k], v)
            w = w | m
        vals[k] = v
        written[k] = w
    return vals, written


def _lf_ctx(lvl, bit_depth: int):
    """make_ctx mirror (sharpness 0); lvl: int32 tensor of levels shaped
    to broadcast against the edge arrays."""
    limit = lvl.clamp_min(1)
    blimit = 2 * (lvl + 2) + limit
    thresh = lvl >> 4
    s = bit_depth - 8
    return (
        limit << s, blimit << s, thresh << s,
        -(1 << (bit_depth - 1)), (1 << (bit_depth - 1)) - 1,
        (1 << bit_depth) - 1, 1 << s,
    )


def _fit_rows(a, n):
    """a's first n rows, zero rows appended when it has fewer."""
    if a.shape[0] < n:
        return torch.cat([a, a.new_zeros((n - a.shape[0],) + a.shape[1:])])
    return a[:n]


def _shift_cols(a, lead, n):
    """out[..., j] = a[..., j - lead] where 0 <= j - lead < a.shape[-1],
    else 0, for j in [0, n)."""
    out = a.new_zeros(a.shape[:-1] + (n,))
    lo, src_lo = max(lead, 0), max(-lead, 0)
    m = min(n - lo, a.shape[-1] - src_lo)
    if m > 0:
        out[..., lo:lo + m] = a[..., src_lo:src_lo + m]
    return out


def _deblock_axis(plane, src, tx_l2, edge, lvl, bit_depth, mi_rows,
                  mi_cols, luma, vis, row_sub, *, horizontal):
    """One deblock pass (all vertical or all horizontal edges) over one
    plane at B levels at once; returns ((B, H, W) filtered planes, (B,)
    SSE deltas vs src over the visible crop). lvl: (B, 1, 1) int32;
    plane: (H, W) or (B, H, W). Bit-exact mirror of the of_deblock pass
    including the search mode's superblock-row subsample (`sampled`) and
    the level-0 no-op.

    For the horizontal pass the plane is transposed so both passes share
    the edge machinery; the vis/sample masks transpose with it.
    """
    vis_w, vis_h = vis
    B = lvl.shape[0]
    dev = plane.device
    if horizontal:
        plane = plane.transpose(-1, -2)
        src = src.T if src is not None else None
        tx_l2 = tx_l2.T
        edge = edge.T
        mi_rows, mi_cols = mi_cols, mi_rows
        vis_w, vis_h = vis_h, vis_w
    Hp = plane.shape[-2]
    n_edges = mi_cols - 1
    if n_edges <= 0:
        out = plane.expand(B, *plane.shape[-2:])
        delta = torch.zeros(B, dtype=I64, device=dev)
        return (out.transpose(-1, -2) if horizontal else out), delta

    W = _edge_windows(plane, n_edges)
    # per-edge params from the mi maps: edge mc+1 fires when
    # edge[mi_row, mc+1] and its size comes from min(tx_l2 left, right)
    tw_r = tx_l2[:, 1:]
    tw_l = tx_l2[:, :-1]
    l2 = torch.minimum(tw_l, tw_r)
    mw = torch.ones_like(l2) << l2
    four = torch.full_like(mw, 4)
    if luma:
        size = torch.where(mw >= 16, 14, torch.where(mw >= 8, 8, four))
    else:
        size = torch.where(mw >= 8, 6, four)
    fire = edge[:, 1:] != 0
    if row_sub > 1:
        # search-mode subsample: filter/score every row_sub'th 64px SB
        # row of EDGES. Vertical pass: the filtered pixel row's mi row
        # (C++ vworker's mr loop). Horizontal pass: the edge's mi row,
        # the edge-index axis after the transpose (C++ hworker's mr).
        if horizontal:
            samp = ((torch.arange(1, mi_cols, dtype=I32, device=dev) >> 4)
                    % row_sub) == 0
            fire = fire & samp[None, :]
        else:
            samp = ((torch.arange(mi_rows, dtype=I32, device=dev) >> 4)
                    % row_sub) == 0
            fire = fire & samp[:, None]

    # expand per-mi maps to pixel rows (4 px per mi); rows beyond the
    # coded area (mr >= mi_rows) never fire
    size_px = _fit_rows(torch.repeat_interleave(size, 4, dim=0), Hp)
    fire_px = _fit_rows(torch.repeat_interleave(fire, 4, dim=0), Hp)

    vals, written = _filter_edges(W, size_px, _lf_ctx(lvl, bit_depth))
    on = lvl > 0
    wr = {k: written[k] & fire_px & on for k in written}

    # SSE delta over the visible crop (written pixels only; unwritten
    # contribute 0 by construction)
    delta = torch.zeros(B, dtype=I64, device=dev)
    if src is not None:
        Wsrc = _edge_windows(src, n_edges)
        y = torch.arange(Hp, dtype=I32, device=dev)[:, None]
        x_edge = 4 * (torch.arange(n_edges, dtype=I32, device=dev) + 1)
        for k in range(_WRITE_LO, _WRITE_HI):
            xk = x_edge[None, :] + k
            w = wr[k] & (xk >= 0) & (xk < vis_w) & (y < vis_h)
            # per-edge deltas fit int32 (|d| < 2^21); widen at the sum
            dn = vals[k] - Wsrc[k]
            od = W[k] - Wsrc[k]
            delta = delta + torch.where(w, dn * dn - od * od, 0).sum(
                (-2, -1), dtype=I64)

    # compose the output plane: pixel x = 4*mc' + dx is written by edge
    # mc'-1 (k = dx), mc' (k = dx-4) or mc'+1 (k = dx-8, only dx >= 2);
    # AV1's size selection makes the writers mutually exclusive. Pure
    # gather/interleave, no scatter.
    Wp = plane.shape[-1]
    n4 = Wp // 4
    cols_out = []
    for dx in range(4):
        cur = plane[..., dx::4]
        if cur.shape[-1] < n4:
            cur = F.pad(cur, (0, n4 - cur.shape[-1]))
        out_dx = cur
        # writers of column 4*mc'+dx: k = dx - 4*shift for shift in
        # {-1, 0, 1, 2} intersected with the write window [-6, 6); shift
        # -1 is the edge TWO cells left reaching forward with its
        # k = +4/+5 size-14 writes. Edge e writes absolute column
        # 4*(e+1)+k, i.e. mc' = e + 1 - shift. Ascending-k application
        # order (exclusive on clean maps).
        for shift in (2, 1, 0, -1):
            k = dx - 4 * shift
            if not (_WRITE_LO <= k < _WRITE_HI):
                continue
            w_ = _shift_cols(wr[k], 1 - shift, n4)
            v_ = _shift_cols(vals[k], 1 - shift, n4)
            out_dx = torch.where(w_, v_, out_dx)
        cols_out.append(out_dx)
    out = torch.stack(cols_out, -1)
    out = out.reshape(*out.shape[:-2], n4 * 4)[..., :Wp]
    if horizontal:
        out = out.transpose(-1, -2)
    return out, delta


def deblock_pass(plane, src, tx_l2, edge, lvl, bit_depth, mi_rows,
                 mi_cols, luma, vis, row_sub, *, horizontal):
    """One deblock pass with `_deblock_axis`'s arguments and result: the
    plain `_deblock_axis` for tensors on the CPU, one launch of the CUDA
    kernel csrc/deblock.cu for tensors on a CUDA device (B = lvl.numel()
    from 1 to 4; plane (H, W) or (B, H, W); every tensor int32 and
    contiguous, or it raises). The launch goes on the current stream and
    nothing waits for it."""
    dev = plane.device
    if dev.type == "cpu":
        return _deblock_axis(plane, src, tx_l2, edge, lvl, bit_depth,
                             mi_rows, mi_cols, luma, vis, row_sub,
                             horizontal=horizontal)
    lvl = lvl.reshape(-1)
    B = lvl.shape[0]
    H, W = plane.shape[-2:]
    if not 1 <= B <= 4:
        raise ValueError(f"deblock_pass: {B} levels, the kernel takes 1-4")
    if plane.dim() != 2 and tuple(plane.shape[:-2]) != (B,):
        raise ValueError(f"deblock_pass: plane {tuple(plane.shape)} is "
                         f"neither (H, W) nor ({B}, H, W)")
    if row_sub < 1:
        raise ValueError(f"deblock_pass: row_sub {row_sub} < 1")
    cuda_build.check("plane", plane, plane.shape, I32, dev)
    if src is not None:
        cuda_build.check("src", src, (H, W), I32, dev)
    cuda_build.check("tx_l2", tx_l2, (mi_rows, mi_cols), I32, dev)
    cuda_build.check("edge", edge, (mi_rows, mi_cols), I32, dev)
    cuda_build.check("lvl", lvl, (B,), I32, dev)
    out = torch.empty((B, H, W), dtype=I32, device=dev)
    # scored, the blocks add into zeros; unscored, the kernel writes zeros
    delta = (torch.empty if src is None else torch.zeros)(
        B, dtype=I64, device=dev)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = cuda_build.function("deblock", "deblock_pass",
                             [p, i, p, p, p, p, p, p] + [i] * 11 + [p])
    with torch.cuda.device(dev):
        err = fn(plane.data_ptr(), 1 if plane.dim() == 2 else B,
                 None if src is None else src.data_ptr(), tx_l2.data_ptr(),
                 edge.data_ptr(), lvl.data_ptr(), out.data_ptr(),
                 delta.data_ptr(), B, H, W, mi_rows, mi_cols, int(luma),
                 int(horizontal), bit_depth, vis[0], vis[1], row_sub,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"deblock_pass launch failed: CUDA error {err}")
    with _lock:
        LAUNCHES["deblock"] += 1
    if src is None and luma and horizontal:
        # the luma apply's last pass: once per frame whose deblock the
        # kernel ran (kernel.deblock_engaged reads it over the F1 calls)
        trace.count("device_filters.deblock_kernel")
    return out, delta


def _deblock_plane(plane, src, txw, txh, ev, eh, lvl, bit_depth,
                   mi_rows, mi_cols, luma, vis, row_sub):
    """Full deblock of one plane at B levels (lvl: (B,) or 0-dim int32):
    all vertical edges, then all horizontal edges on the v-filtered plane
    (spec pass order). Returns ((B, H, W) filtered, (B,) SSE deltas)."""
    lvl = lvl.reshape(-1, 1, 1)
    p1, dv = deblock_pass(plane, src, txw, ev, lvl, bit_depth, mi_rows,
                          mi_cols, luma, vis, row_sub, horizontal=False)
    p2, dh = deblock_pass(p1, src, txh, eh, lvl, bit_depth, mi_rows,
                          mi_cols, luma, vis, row_sub, horizontal=True)
    # unscored (src None), both deltas are zero
    return p2, dv if src is None else dv + dh


def _pick_levels(deltas, y_cands, uv_cands):
    """(4,) int32 levels [y, y, u, v] from the (3, NC) SSE deltas of the y,
    u and v candidates: per plane the host rule (the first strict
    improvement in the sorted candidate order == the first argmin's
    candidate where its delta is < 0, else 0); u and v are only coded
    when y is nonzero. The indices stay (3, 1) tensors: a 0-d tensor as
    an index is read to the host."""
    cands = torch.stack([y_cands, uv_cands, uv_cands])
    i = torch.argmin(deltas, dim=1, keepdim=True)
    picks = torch.where(deltas.gather(1, i) < 0, cands.gather(1, i),
                        0)[:, 0].to(I32)
    return torch.cat([picks[:1], picks[:1], picks[1:] * (picks[:1] > 0)])


def _deblock_search_apply(rec, src, txw_l2, txh_l2, edge_v, edge_h,
                          y_cands, uv_cands, *, bit_depth, mi_rows,
                          mi_cols, vis, row_sub):
    """Device mirror of encoder._deblock_apply's level search + final
    apply: score each luma candidate (v+h SSE delta at search
    subsample), then chroma candidates, pick with the host's
    strict-< / delta<0 rule, and run the full decoder-exact apply at the
    winners. The candidates are one batch dimension. Returns (levels[4]
    int32, filtered stack, deltas (3, NC) int64)."""
    P = rec.shape[0]

    def plane_pass(pl, src_pl, lvl, sub):
        g = 0 if pl == 0 else 1
        return _deblock_plane(
            rec[pl], src_pl, txw_l2[g], txh_l2[g], edge_v[g], edge_h[g],
            lvl, bit_depth, mi_rows, mi_cols, pl == 0, vis, sub,
        )

    dy = plane_pass(0, src[0], y_cands, row_sub)[1]
    if P == 3:
        du = plane_pass(1, src[1], uv_cands, row_sub)[1]
        dv_ = plane_pass(2, src[2], uv_cands, row_sub)[1]
        deltas = torch.stack([dy, du, dv_])
    else:
        deltas = torch.stack([dy, dy * 0, dy * 0])
    levels = _pick_levels(deltas, y_cands, uv_cands)

    # final decoder-exact apply at the winning levels (full rows)
    planes = [plane_pass(pl, None, levels[pl + 1:pl + 2], 1)[0][0]
              for pl in range(P)]
    return levels, torch.stack(planes), deltas


def _filter_grids(a, mi_rows, mi_cols, device):
    """Filter maps come flat (nt * mi_rows * mi_cols); monochrome has only
    the luma grid, duplicated so the chroma slot exists (it is never
    selected when P == 1)."""
    a = np.asarray(a).reshape(-1, mi_rows, mi_cols)
    if a.shape[0] == 1:
        a = np.concatenate([a, a])
    return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)


def _deblock_cands(hint):
    cands = sorted(
        {max(1, hint // 2), max(1, hint), hint + 2, min(63, 2 * hint + 4)}
    )
    return cands + [cands[-1]] * (4 - len(cands))  # pad: dup last


def _upload(a, device):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)


def deblock_device(rec, src, maps, hint, *, bit_depth, mi_rows, mi_cols,
                   vis, row_sub, device=None):
    """Host entry: run the deblock level search + apply on the device.
    rec/src: (P, Hp, Wp) int32 stacks; maps = (skip, txw_l2, txh_l2,
    edge_v, edge_h) as built by native.build_filter_maps. Returns
    (levels tuple[4], filtered (P, Hp, Wp) np.int32, deltas np.int64
    (3, 4)). Bit-exact vs the native of_deblock search/apply path."""
    dev = resolve_device(device)
    _skip, txw_l2, txh_l2, edge_v, edge_h = maps
    cands = torch.tensor(_deblock_cands(hint), dtype=I32, device=dev)
    grids = [_filter_grids(a, mi_rows, mi_cols, dev)
             for a in (txw_l2, txh_l2, edge_v, edge_h)]
    with torch.inference_mode():
        levels, stack, deltas = _deblock_search_apply(
            _upload(rec, dev), _upload(src, dev), *grids, cands, cands,
            bit_depth=bit_depth, mi_rows=mi_rows, mi_cols=mi_cols,
            vis=tuple(vis), row_sub=row_sub,
        )
        return (
            tuple(int(x) for x in levels.tolist()),
            stack.cpu().numpy(),
            deltas.cpu().numpy(),
        )


# ---------------------------------------------------------------------------
# CDEF (spec 7.15): direction search, batched strength search, apply.
# Bit-exact mirror of tilecoder.cpp cdefns::{direction, filter8,
# search_plane_rows} / of_cdef_*.
# ---------------------------------------------------------------------------

# {dy, dx} at distances 1 and 2 for the 8 directions (spec Cdef_Directions)
_CDEF_DIRS = (
    ((-1, 1), (-2, 2)), ((0, 1), (-1, 2)), ((0, 1), (0, 2)),
    ((0, 1), (1, 2)), ((1, 1), (2, 2)), ((1, 0), (2, 1)),
    ((1, 0), (2, 0)), ((1, 0), (2, -1)),
)
_PRI_TAPS = ((4, 2), (3, 3))
_SEC_TAPS = (2, 1)
_SEC_ACT = (0, 1, 2, 4)
_DIV_TABLE = (0, 840, 420, 280, 210, 168, 140, 120, 105)


def _fl2(v):
    """floor(log2(v)) for v >= 1 (0 for v <= 0), branchless integers:
    exact mirror of the C++ floor_log2 loop."""
    r = torch.zeros_like(v)
    y = v
    for s in (16, 8, 4, 2, 1):
        m = y >= (1 << s)
        r = r + m.to(v.dtype) * s
        y = torch.where(m, y >> s, y)
    return r


@lru_cache(maxsize=None)
@trace.setup_phase("setup.programs")
def _dir_bin_matrices():
    """One-hot (64, 15) matrices mapping a flattened 8x8 to the 8
    direction partial-sum tables (spec 7.15.2)."""
    mats = np.zeros((8, 64, 15), np.float32)
    for i in range(8):
        for j in range(8):
            q = i * 8 + j
            mats[0, q, i + j] = 1
            mats[1, q, i + (j >> 1)] = 1
            mats[2, q, i] = 1
            mats[3, q, 3 + i - (j >> 1)] = 1
            mats[4, q, 7 + i - j] = 1
            mats[5, q, 3 - (i >> 1) + j] = 1
            mats[6, q, j] = 1
            mats[7, q, (i >> 1) + j] = 1
    return mats


@lru_cache(maxsize=None)
@trace.setup_phase("setup.programs")
def _cdef_consts(device: str):
    """Per-device constants: the direction bin matrices, and the tap
    offset tables (dy, dx) per direction: primary (4, 8, 2) in
    (distance, sign) order, secondary (8, 8, 2) in (dd, distance, sign)
    order for the "d" variant (direction d + dd) and the "z" variant
    (signaled primary zero: direction forced 0)."""
    prim, sec_d, sec_z = [], [], []
    for k in range(2):
        for s in (-1, 1):
            prim.append([(s * _CDEF_DIRS[d][k][0], s * _CDEF_DIRS[d][k][1])
                         for d in range(8)])
    for dd in (2, 6):
        for k in range(2):
            for s in (-1, 1):
                sec_d.append([(s * _CDEF_DIRS[(d + dd) & 7][k][0],
                               s * _CDEF_DIRS[(d + dd) & 7][k][1])
                              for d in range(8)])
                sec_z.append([(s * _CDEF_DIRS[dd & 7][k][0],
                               s * _CDEF_DIRS[dd & 7][k][1])] * 8)
    t = lambda a: torch.tensor(a, dtype=I64, device=device)
    return dict(mats=torch.from_numpy(_dir_bin_matrices()).to(device),
                p=t(prim), d=t(sec_d), z=t(sec_z),
                sec_act=torch.tensor(_SEC_ACT, dtype=I32, device=device))


def _cdef_dirs_dev(luma, sb8r, sb8c, bit_depth):
    """Per-8x8 direction + variance grids (bit-exact vs of_cdef_dirs)."""
    shift = bit_depth - 8
    x = (luma[: 8 * sb8r, : 8 * sb8c] >> shift) - 128
    xb = (
        x.reshape(sb8r, 8, sb8c, 8)
        .permute(0, 2, 1, 3)
        .reshape(sb8r * sb8c, 64)
        .to(torch.float32)
    )
    mats = _cdef_consts(str(luma.device))["mats"]  # (8, 64, 15)
    # |x| <= 128, 8 terms per bin: exact in f32
    parts = torch.einsum("nq,dqb->dnb", xb, mats).to(I64)
    sq = parts * parts  # (8, N, 15)
    div = _DIV_TABLE
    cost = []
    for d in range(8):
        p2 = sq[d]
        if d in (2, 6):
            c = 105 * p2[:, :8].sum(1)
        elif d in (0, 4):
            c = 105 * p2[:, 7]
            for i in range(7):
                c = c + div[i + 1] * (p2[:, i] + p2[:, 14 - i])
        else:
            c = torch.zeros(p2.shape[0], dtype=I64, device=p2.device)
            for i in range(11):
                count = min(2 * (i + 1), 2 * (11 - i), 8)
                c = c + div[count] * p2[:, i]
        cost.append(c)
    cost = torch.stack(cost)  # (8, N)
    best = torch.argmax(cost, dim=0)  # first max (C++ strict >)
    var = ((cost.gather(0, best[None]) - cost.gather(0, ((best + 4) & 7)[None]))
           [0] >> 10).to(I32)
    return best.to(I32).reshape(sb8r, sb8c), var.reshape(sb8r, sb8c)


def _cdef_taps(stack_pl, region, coded, dirs_px):
    """Per-pixel primary/secondary tap differences, availability masks
    and tap min/max for one plane. Returns dict with:
    p[k] (4 primary: diff, |diff|, valid, distance, value), pmn, pmx;
    sd (8 secondary, dir variant) + smnd/smxd; sz variants + smnz/smxz.
    dirs_px: per-pixel dir (int32). A tap is one gather from the
    zero-padded plane at the pixel's direction's offset."""
    Hc, Wc8 = region
    cw, ch = coded
    dev = stack_pl.device
    consts = _cdef_consts(str(dev))
    pad = F.pad(stack_pl[:Hc + 2, :Wc8 + 2], (2, 2, 2, 2))
    wpad = pad.shape[1]
    flat = pad.reshape(-1)
    y = torch.arange(Hc, dtype=I64, device=dev)[:, None]
    x = torch.arange(Wc8, dtype=I64, device=dev)[None, :]
    base = (y + 2) * wpad + (x + 2)
    px = pad[2:2 + Hc, 2:2 + Wc8]
    dirs_l = dirs_px.to(I64)

    def tap(table):
        # table: (8, 2) offsets by direction
        vy = table[:, 0][dirs_l]
        vx = table[:, 1][dirs_l]
        val = flat[base + vy * wpad + vx]
        valid = (
            (y + vy >= 0) & (y + vy < ch) & (x + vx >= 0) & (x + vx < cw)
        )
        return val, valid

    def group(tables, ks):
        taps = [tap(t) + (k,) for t, k in zip(tables, ks)]
        entries = [((v - px), torch.abs(v - px), ok, k, v)
                   for (v, ok, k) in taps]
        mn = px
        mx = px
        for (v, ok, k) in taps:
            mn = torch.where(ok, torch.minimum(mn, v), mn)
            mx = torch.where(ok, torch.maximum(mx, v), mx)
        return entries, mn, mx

    out = {"px": px}
    # 4 primary taps: k (distance) x sign
    out["p"], out["pmn"], out["pmx"] = group(consts["p"], (0, 0, 1, 1))
    for variant in ("d", "z"):
        out["s" + variant], out["smn" + variant], out["smx" + variant] = (
            group(consts[variant], (0, 0, 1, 1) * 2))
    return out


def _constrain(diff, adiff, valid, strength_px, adj_px):
    """constrain_pre mirror with availability masking; strength/adj are
    per-pixel int32 (strength 0 -> contribution 0 via the min)."""
    v = strength_px - (adiff >> adj_px)
    v = torch.clamp_min(v, 0)
    v = torch.minimum(adiff, v)
    v = torch.where(diff < 0, -v, v)
    return torch.where(valid, v, 0)


def _cdef_psum(taps, eff_px, adj_px, pt_px):
    """Primary filter sum for per-pixel effective strength (0 = off)."""
    s = None
    for (d, a, ok, k, _v) in taps["p"]:
        # tap set pt is 0 or 1: weight _PRI_TAPS[pt][k]
        w = _PRI_TAPS[0][k] + (_PRI_TAPS[1][k] - _PRI_TAPS[0][k]) * pt_px
        c = w * _constrain(d, a, ok, eff_px, adj_px)
        s = c if s is None else s + c
    return torch.where(eff_px > 0, s, 0)


def _cdef_ssum(taps, variant, st, adj):
    s = None
    for (d, a, ok, k, _v) in taps["s" + variant]:
        c = _SEC_TAPS[k] * _constrain(d, a, ok, st, adj)
        s = c if s is None else s + c
    return s


def _cdef_combine(pxv, sum_, mn, mx):
    v = pxv + ((8 + sum_ - (sum_ < 0).to(sum_.dtype)) >> 4)
    return torch.minimum(torch.maximum(v, mn), mx)


def _blk_to_px(a):
    """Expand a (sb8r, sb8c) block quantity to pixels."""
    return torch.repeat_interleave(torch.repeat_interleave(a, 8, 0), 8, 1)


def _cdef_eff(pri_scalar, var_blk, luma, cs, damping_eff):
    """Per-block effective primary strength / tap set / shift (mirrors
    the eff[]/pt[]/eff_adj[] block in search_plane_rows); pri_scalar is a
    Python int or a 0-dim int32 tensor."""
    p = pri_scalar << cs
    if luma:
        v6 = var_blk >> 6
        vs = torch.where(v6 > 0, torch.clamp_max(_fl2(v6), 12), 0)
        eff = torch.where(var_blk != 0, (p * (4 + vs) + 8) >> 4,
                          torch.zeros_like(var_blk))
    else:
        eff = torch.zeros_like(var_blk) + p
    pt = (eff >> cs) & 1
    adj = torch.clamp_min(damping_eff - _fl2(eff), 0)
    return eff, pt, adj


def _cdef_plane_filter(taps, var_blk, luma, pri, sec, cs, damping,
                       sig_pri=None):
    """filter8 output for one plane at (pri, sec), 0-dim int32 tensors.
    sig_pri: bool tensor for the signaled-primary-nonzero test (defaults
    to pri != 0); selects the secondary dir variant and the min/max sets
    exactly like the C++."""
    px = taps["px"]
    damping_eff = damping + cs - (0 if luma else 1)
    if sig_pri is None:
        sig_pri = pri != 0
    eff_b, pt_b, adj_b = _cdef_eff(pri, var_blk, luma, cs, damping_eff)
    eff = _blk_to_px(eff_b)
    psum = _cdef_psum(taps, eff, _blk_to_px(adj_b), _blk_to_px(pt_b))
    st = sec << cs
    sadj = torch.clamp_min(damping_eff - _fl2(st), 0)
    ssum_d = _cdef_ssum(taps, "d", st, sadj)
    ssum_z = _cdef_ssum(taps, "z", st, sadj)
    use_p = (eff > 0) & sig_pri
    use_s = sec > 0
    ss = torch.where(sig_pri, ssum_d, ssum_z)
    smn = torch.where(sig_pri, taps["smnd"], taps["smnz"])
    smx = torch.where(sig_pri, taps["smxd"], taps["smxz"])
    total = torch.where(use_p, psum, 0) + torch.where(use_s, ss, 0)
    mn = torch.where(use_p, torch.minimum(px, taps["pmn"]), px)
    mx = torch.where(use_p, torch.maximum(px, taps["pmx"]), px)
    mn = torch.where(use_s, torch.minimum(mn, smn), mn)
    mx = torch.where(use_s, torch.maximum(mx, smx), mx)
    return _cdef_combine(px, total, mn, mx)


def _cdef_search_apply(stack, src, skip_mi, damping, *, bit_depth,
                       mi_rows, mi_cols, vis, sub, fast_sec, cands):
    """Device mirror of encoder._cdef_apply: dirs -> batched strength
    search -> best_of selection -> apply. damping: Python int. Returns
    (strengths (4,) int32 [y_pri, y_sec, uv_pri, uv_sec], applied
    stack, acc_y, acc_uv (int64 (NC, 4)), dirs, vars)."""
    P = stack.shape[0]
    dev = stack.device
    cs = bit_depth - 8
    sb8r, sb8c = (mi_rows + 1) >> 1, (mi_cols + 1) >> 1
    region = (8 * sb8r, 8 * sb8c)
    cw, ch = mi_cols * 4, mi_rows * 4
    vis_w, vis_h = vis

    dirs, vars_ = _cdef_dirs_dev(stack[0], sb8r, sb8c, bit_depth)
    dirs_px = _blk_to_px(dirs)

    # block score/apply masks
    skip_pad = F.pad(skip_mi, (0, 2 * sb8c - mi_cols, 0, 2 * sb8r - mi_rows),
                     value=1)
    nonskip_blk = (
        skip_pad.reshape(sb8r, 2, sb8c, 2).permute(0, 2, 1, 3)
        .reshape(sb8r, sb8c, 4)
        == 0
    ).any(-1)
    br = torch.arange(sb8r, dtype=I32, device=dev)[:, None]
    bc = torch.arange(sb8c, dtype=I32, device=dev)[None, :]
    if sub == 2:
        sub_blk = ((br + bc) & 1) == 0
    elif sub >= 4:
        sub_blk = ((br | bc) & 1) == 0
    else:
        sub_blk = torch.ones((sb8r, sb8c), dtype=torch.bool, device=dev)
    score_blk = nonskip_blk & sub_blk
    y = torch.arange(region[0], dtype=I32, device=dev)[:, None]
    x = torch.arange(region[1], dtype=I32, device=dev)[None, :]
    coded_px = (y < ch) & (x < cw)
    vis_px = coded_px & (y < vis_h) & (x < vis_w)
    score_px = _blk_to_px(score_blk) & vis_px
    apply_px = _blk_to_px(nonskip_blk) & coded_px
    zero64 = torch.zeros((), dtype=I64, device=dev)

    def search_plane(pl, luma):
        # the C++ decomposition: psum depends only on the primary
        # candidate, ssum only on the secondary strength (x2 dir
        # variants); combos combine the precomputed sums
        taps = _cdef_taps(stack[pl], region, (cw, ch), dirs_px)
        px = taps["px"]
        s = src[pl][: region[0], : region[1]]
        base_e = (px - s) * (px - s)  # <= 2^20: int32
        damping_eff = damping + cs - (0 if luma else 1)
        psums, use_ps = {}, {}
        for cand in cands:
            if cand == 0 or cand in psums:
                continue
            eff_b, pt_b, adj_b = _cdef_eff(cand, vars_, luma, cs,
                                           damping_eff)
            eff = _blk_to_px(eff_b)
            psums[cand] = _cdef_psum(taps, eff, _blk_to_px(adj_b),
                                     _blk_to_px(pt_b))
            use_ps[cand] = eff > 0
        ssums = {}
        for j in (1, 2, 3):
            if fast_sec and j == 1:
                continue
            st = _SEC_ACT[j] << cs
            sadj = max(damping_eff - (_SEC_ACT[j] << cs).bit_length() + 1,
                       0)
            for variant in ("d", "z"):
                ssums[(variant, j)] = _cdef_ssum(taps, variant, st, sadj)
        acc = []
        for cand in cands:
            variant = "d" if cand != 0 else "z"
            smn = taps["smn" + variant]
            smx = taps["smx" + variant]
            row = []
            for j in range(4):
                if (cand == 0 and j == 0) or (fast_sec and j == 1):
                    row.append(zero64)
                    continue
                if cand != 0:
                    up = use_ps[cand]
                    total = torch.where(up, psums[cand], 0)
                    mn = torch.where(up, torch.minimum(px, taps["pmn"]), px)
                    mx = torch.where(up, torch.maximum(px, taps["pmx"]), px)
                else:
                    total, mn, mx = torch.zeros_like(px), px, px
                if j:
                    total = total + ssums[(variant, j)]
                    mn = torch.minimum(mn, smn)
                    mx = torch.maximum(mx, smx)
                v = _cdef_combine(px, total, mn, mx)
                nd = (v - s) * (v - s)
                row.append(torch.where(score_px, nd - base_e, 0).sum(
                    dtype=I64))
            acc.append(torch.stack(row))
        return torch.stack(acc), taps

    acc_y, taps_y = search_plane(0, True)
    if P == 3:
        acc_u, taps_u = search_plane(1, False)
        acc_v, taps_v = search_plane(2, False)
        acc_uv = acc_u + acc_v
    else:
        acc_uv = torch.zeros_like(acc_y)

    cands_arr = torch.tensor(cands, dtype=I32, device=dev)
    sec_act = _cdef_consts(str(dev))["sec_act"]

    def best_of(acc):
        # first minimum in the flat (candidate, secondary) order
        flat = acc.reshape(-1)
        im = torch.argmin(flat)
        ok = flat[im] < 0
        return (torch.where(ok, cands_arr[im // 4], 0),
                torch.where(ok, sec_act[im % 4], 0))

    y_pri, y_sec = best_of(acc_y)
    if P == 3:
        uv_pri, uv_sec = best_of(acc_uv)
    else:
        uv_pri = uv_sec = torch.zeros((), dtype=I32, device=dev)

    any_on = (y_pri > 0) | (y_sec > 0) | (uv_pri > 0) | (uv_sec > 0)

    def apply_plane(taps, luma, pri, sec):
        v = _cdef_plane_filter(taps, vars_, luma, pri, sec, cs, damping,
                               sig_pri=pri != 0)
        return torch.where(apply_px & any_on, v, taps["px"])

    planes = [apply_plane(taps_y, True, y_pri, y_sec)]
    if P == 3:
        planes.append(apply_plane(taps_u, False, uv_pri, uv_sec))
        planes.append(apply_plane(taps_v, False, uv_pri, uv_sec))
    # write the filtered region back into the full padded stack
    out = stack.clone()
    out[:, : region[0], : region[1]] = torch.stack(planes)

    strengths = torch.stack([y_pri, y_sec, uv_pri, uv_sec]).to(I32)
    return strengths, out, acc_y, acc_uv, dirs, vars_


def cdef_device(stack, src, skip_mi, damping, *, bit_depth, mi_rows,
                mi_cols, vis, sub, fast_sec, cands, device=None):
    """Host entry: CDEF dirs + strength search + apply on the device.
    Bit-exact vs the native of_cdef_dirs/of_cdef_search/of_cdef_apply
    chain under encoder._cdef_apply's selection rule. Returns
    (strengths tuple[4], applied np.int32 stack, acc_y, acc_uv (np.int64
    (NC, 4)), dirs, vars (np.int32 (sb8r, sb8c)))."""
    dev = resolve_device(device)
    skip = _upload(np.asarray(skip_mi).reshape(mi_rows, mi_cols), dev)
    with torch.inference_mode():
        strengths, out, acc_y, acc_uv, dirs, vars_ = _cdef_search_apply(
            _upload(stack, dev), _upload(src, dev), skip, int(damping),
            bit_depth=bit_depth, mi_rows=mi_rows, mi_cols=mi_cols,
            vis=tuple(vis), sub=int(sub), fast_sec=int(fast_sec),
            cands=tuple(int(c) for c in cands),
        )
        return (
            tuple(int(v) for v in strengths.tolist()),
            out.cpu().numpy(),
            acc_y.cpu().numpy(),
            acc_uv.cpu().numpy(),
            dirs.cpu().numpy(),
            vars_.cpu().numpy(),
        )


# ---------------------------------------------------------------------------
# Loop restoration: Wiener (Gram-matrix formulation).
#
# The C++ solve (tilecoder.cpp lr_wiener_plane) is a two-stage separable
# least squares with scalar double solves interleaved between image
# passes. The key identity: the final filtered image is BILINEAR in the
# (horizontal, vertical) taps over a fixed 18-image basis {1, rec,
# src-rec, Lh_k(rec), Lv_i(rec), Lv_i(Lh_k(rec))} with unit-local boundary
# clamps, so EVERY moment the C++ pipeline ever accumulates (stage-1/2
# normal equations, psy-gamma stats, final SSE/variance) is a small
# quadratic form over the per-unit Gram matrix of that basis. The device
# computes the exact int64 Gram in ONE pass (per-unit slice sums); the
# host reconstructs the C++ doubles from it with exact rational
# arithmetic (python ints scaled 2^14, single correctly-rounded float
# conversion) and replicates the scalar solve sequence
# operation-for-operation. Equality holds whenever the C++ double
# accumulations are themselves exact: true for all content within the
# documented magnitude bounds (Gram entries < 2^53-ish).
# ---------------------------------------------------------------------------

_WIENER_TAP_MIN = (-5, -23, -17)
_WIENER_TAP_MAX = (10, 8, 46)
_N_BASIS = 18
_SC = 1 << 14  # coefficient scale: all tap coefficients are k/2^14


@lru_cache(maxsize=None)
@trace.setup_phase("setup.programs")
def _unit_clamp_idx(n, u, m):
    """Per offset k in {1,2,3}: gather indices clamping x±k to the
    restoration unit containing x (last unit absorbs the tail: spec
    unit grid, mirrors the per-unit gradient clamps in
    wiener_axis_solve)."""
    xs = np.arange(n)
    uid = np.minimum(xs // u, m - 1)
    x0 = uid * u
    x1 = np.where(uid == m - 1, n, (uid + 1) * u)
    return {
        k: (np.clip(xs - k, x0, x1 - 1), np.clip(xs + k, x0, x1 - 1))
        for k in (1, 2, 3)
    }


@lru_cache(maxsize=None)
@trace.setup_phase("setup.programs")
def _unit_clamp_idx_dev(n, u, m, device: str):
    return {k: tuple(torch.from_numpy(a).to(device) for a in v)
            for k, v in _unit_clamp_idx(n, u, m).items()}


def _unit_bounds(h, w, u, rows, cols):
    """((y0, y1), (x0, x1)): the unit grid's row and column spans (the
    last unit absorbs the tail)."""
    y0 = [ur * u for ur in range(rows)]
    y1 = [h if ur == rows - 1 else (ur + 1) * u for ur in range(rows)]
    x0 = [uc * u for uc in range(cols)]
    x1 = [w if uc == cols - 1 else (uc + 1) * u for uc in range(cols)]
    return (y0, y1), (x0, x1)


def _wiener_basis(rec, src, h, w, u, rows, cols, ntaps=3):
    """The basis images (int32, (h, w)). Full (ntaps=3) order: 0 ones,
    1 rec, 2 t, 3..5 Lh_k(rec) k=(3,2,1), 6..8 Lv_i(rec),
    9..17 Lv_i(Lh_k(rec)) (i-major). ntaps=2 (chroma) drops the k=3
    offset images (11 images, 2.6x fewer Gram pairs)."""
    r = rec[:h, :w]
    t = src[:h, :w] - r
    dev = str(rec.device)
    ci = _unit_clamp_idx_dev(w, u, cols, dev)
    ri = _unit_clamp_idx_dev(h, u, rows, dev)
    offs = (3, 2, 1) if ntaps == 3 else (2, 1)

    def lh(img, k):
        xm, xp = ci[k]
        return img[:, xm] + img[:, xp] - 2 * img

    def lv(img, k):
        ym, yp = ri[k]
        return img[ym, :] + img[yp, :] - 2 * img

    G = [lh(r, k) for k in offs]
    B = [lv(r, k) for k in offs]
    C = [lv(g, i) for i in offs for g in G]
    return [torch.ones_like(r), r, t] + G + B + C


def _basis_logical_map(ntaps):
    """Physical index of each 18-basis logical index for the ntaps
    basis subset (identity for ntaps=3)."""
    if ntaps == 3:
        return {i: i for i in range(18)}
    # ntaps=2: logical G/B order (3,2,1) keeps only (2,1); C keeps the
    # (i, k) pairs with both offsets in {2, 1}
    m = {0: 0, 1: 1, 2: 2, 4: 3, 5: 4, 7: 5, 8: 6}
    # logical C index 9 + i*3 + k (i,k in 0..2 over offsets 3,2,1)
    p = 7
    for i in (1, 2):
        for k in (1, 2):
            m[9 + i * 3 + k] = p
            p += 1
    return m


def _unit_sums_batch(P, ys, xs):
    """Batched exact int64 per-unit sums: P is (C, h, w), any integer
    dtype (widened at the reduction). Slice-reductions per unit band."""
    (Y0, Y1), (X0, X1) = ys, xs
    bands = torch.stack(
        [P[:, y0:y1, :].sum(1, dtype=I64) for y0, y1 in zip(Y0, Y1)], 1,
    )  # (C, rows, w)
    return torch.stack(
        [bands[:, :, x0:x1].sum(2) for x0, x1 in zip(X0, X1)], 2,
    )  # (C, rows, cols)


def _unit_sums(P, ys, xs):
    """Exact int64 per-unit sums of one image."""
    return _unit_sums_batch(P[None], ys, xs)[0]


@lru_cache(maxsize=None)
@trace.setup_phase("setup.programs")
def _gram_pairs(nb, device: str):
    li = [i for i in range(nb) for j in range(i, nb)]
    rj = [j for i in range(nb) for j in range(i, nb)]
    t = lambda a: torch.tensor(a, dtype=I64, device=device)
    return t(li), t(rj)


def _wiener_gram(rec, src, *, h, w, u, rows, cols, ntaps=3):
    """Exact int64 Gram of the basis per unit: (nb*(nb+1)/2, rows, cols)
    in (i <= j) pair order."""
    imgs = _wiener_basis(rec, src, h, w, u, rows, cols, ntaps)
    nb = len(imgs)
    ys, xs = _unit_bounds(h, w, u, rows, cols)
    # basis magnitudes are <= 2^14, so pair products fit int32: the
    # multiplies run in int32 and only the band reduction widens
    X = torch.stack(imgs).to(I32)  # (nb, h, w)
    li, rj = _gram_pairs(nb, str(rec.device))
    # pair-chunked so the transient (C, h, w) product stack stays ~1 GB
    # even at 8K while keeping the op count ~C/chunk
    chunk = max(4, min(len(li), int(1e9 // (max(h * w, 1) * 4 * 3))))
    out = []
    for c0 in range(0, len(li), chunk):
        L = X[li[c0 : c0 + chunk]]
        R = X[rj[c0 : c0 + chunk]]
        out.append(_unit_sums_batch(L * R, ys, xs))
    return torch.cat(out)


@lru_cache(maxsize=None)
@trace.setup_phase("setup.programs")
def _pair_index(nb=_N_BASIS):
    idx = {}
    p = 0
    for i in range(nb):
        for j in range(i, nb):
            idx[(i, j)] = p
            idx[(j, i)] = p
            p += 1
    return idx


def _gauss_solve(A, b, ntaps):
    """Exact mirror of the C++ Gaussian elimination with partial
    pivoting (same op order -> same doubles)."""
    m = [[A[i][j] for j in range(ntaps)] + [b[i]] for i in range(ntaps)]
    ok = True
    for col in range(ntaps):
        piv = col
        for r_ in range(col + 1, ntaps):
            if abs(m[r_][col]) > abs(m[piv][col]):
                piv = r_
        if abs(m[piv][col]) < 1e-30:
            ok = False
            break
        if piv != col:
            m[piv], m[col] = m[col], m[piv]
        for r_ in range(ntaps):
            if r_ == col:
                continue
            f = m[r_][col] / m[col][col]
            for j in range(col, ntaps + 1):
                m[r_][j] -= f * m[col][j]
    t = [0.0, 0.0, 0.0]
    if ok:
        for i in range(ntaps):
            t[i] = m[i][ntaps] / m[i][i]
    return t


def _round_tap(v, idx):
    t = int(np.rint(v))
    return max(_WIENER_TAP_MIN[idx], min(_WIENER_TAP_MAX[idx], t))


def _wiener_unit_solve(q, n, ntaps, margin, mu, want_var):
    """Per-unit host algebra on the exact Gram: reproduces the doubles
    of the C++ lr_wiener_plane worker (stage solves, psy gamma path,
    use decision, variance stats). q(i, j) -> exact int Gram entry."""
    lo = 3 - ntaps

    def qv(U, V):
        # exact inner product of two sparse scaled coeff vectors over
        # the basis; python-int numerator, one correctly-rounded float
        num = 0
        for i, ui in U:
            for j, vj in V:
                num += ui * vj * q(i, j)
        return num / (_SC * _SC)

    one = ((0, _SC),)
    recv = ((1, _SC),)
    tv_ = ((2, _SC),)
    base = float(q(2, 2))
    nf = float(n)

    # stage 1 (horizontal): LS over the Lh gradients of rec
    A = [[float(q(3 + lo + i, 3 + lo + j)) for j in range(ntaps)]
         for i in range(ntaps)]
    b = [128.0 * float(q(3 + lo + i, 2)) for i in range(ntaps)]
    reg = 1e-4 * (A[0][0] if A[0][0] > 1.0 else 1.0)
    for i in range(ntaps):
        A[i][i] += reg
    sol = _gauss_solve(A, b, ntaps)
    th = [0, 0, 0]
    for i in range(ntaps):
        th[lo + i] = _round_tap(sol[i], lo + i)

    def g2_vec(th3):
        # stage-2 gradient images of mid = rec + sum th_k Lh_k /128
        out = []
        for i in range(ntaps):
            v = [(6 + lo + i, _SC)]
            for k in range(ntaps):
                if th3[lo + k]:
                    v.append((9 + (lo + i) * 3 + lo + k,
                              th3[lo + k] * (_SC >> 7)))
            out.append(tuple(v))
        return out

    def mid_delta(th3):
        # mid - rec as a sparse vector
        return tuple(
            (3 + lo + k, th3[lo + k] * (_SC >> 7))
            for k in range(ntaps) if th3[lo + k]
        )

    # stage 2 (vertical) on mid
    g2 = g2_vec(th)
    md = mid_delta(th)
    tmid = ((2, _SC),) + tuple((i, -c) for (i, c) in md)  # src - mid
    A2 = [[qv(g2[i], g2[j]) for j in range(ntaps)] for i in range(ntaps)]
    b2 = [128.0 * qv(g2[i], tmid) for i in range(ntaps)]
    reg2 = 1e-4 * (A2[0][0] if A2[0][0] > 1.0 else 1.0)
    for i in range(ntaps):
        A2[i][i] += reg2
    sol2 = _gauss_solve(A2, b2, ntaps)
    tvv = [0, 0, 0]
    for i in range(ntaps):
        tvv[lo + i] = _round_tap(sol2[i], lo + i)

    def fin_delta(th3, tv3):
        # fin - rec: sum th Lh/128 + sum tv Lv/128 + sum tv th Lv(Lh)/2^14
        v = list(mid_delta(th3))
        for i in range(ntaps):
            if tv3[lo + i]:
                v.append((6 + lo + i, tv3[lo + i] * (_SC >> 7)))
                for k in range(ntaps):
                    if th3[lo + k]:
                        v.append((9 + (lo + i) * 3 + lo + k,
                                  tv3[lo + i] * th3[lo + k]))
        return tuple(v)

    d = fin_delta(th, tvv)
    if mu > 0.0 and any(th) or mu > 0.0 and any(tvv):
        ed = qv(tv_, d)
        dd = qv(d, d)
        sd = qv(one, d)
        srd = qv(recv, d)
        rsum2 = float(q(0, 1))
        crd = srd - rsum2 * sd / nf
        vd = dd - sd * sd / nf
        den = dd - mu * vd
        gam = (ed + mu * crd) / den if den > 1e-9 else 1.0
        if gam < 0.0:
            gam = 0.0
        if gam > 1.0:
            gam = 1.0
        if gam < 0.97:
            for i in range(ntaps):
                th[lo + i] = _round_tap(gam * th[lo + i], lo + i)
                tvv[lo + i] = _round_tap(gam * tvv[lo + i], lo + i)
            d = fin_delta(th, tvv)

    # final SSE + output moments: src - fin = t - d
    smf = ((2, _SC),) + tuple((i, -c) for (i, c) in d)
    sse = qv(smf, smf)
    rsum = float(q(0, 1))
    rsq = float(q(1, 1))
    # output moments composed exactly like the C++: d-based sums plus
    # the integer rec moments (same op order -> same doubles)
    fsum = rsum + qv(one, d)
    fsq = rsq + 2.0 * qv(recv, d) + qv(d, d)
    zero = not (any(th) or any(tvv))
    if mu > 0.0:
        var_f = fsq - fsum * fsum / nf
        var_r = rsq - rsum * rsum / nf
        use = (sse - mu * var_f) < (base - mu * var_r) - margin and not zero
    else:
        use = sse < base - margin and not zero
    out_var = None
    if want_var:
        ssum = rsum + float(q(0, 2))
        ssq = rsq + 2.0 * float(q(1, 2)) + float(q(2, 2))
        vr = rsq - rsum * rsum / nf
        out_var = (
            ssq - ssum * ssum / nf,
            vr,
            (fsq - fsum * fsum / nf) if use else vr,
        )
    if use:
        taps6 = (tvv[0], tvv[1], tvv[2], th[0], th[1], th[2])
        return 1, taps6, sse, base, out_var
    return 0, (0, 0, 0, 0, 0, 0), base, base, out_var



def lr_wiener_plane_device(src, rec, h, w, unit, rows, cols, ntaps,
                           margin, want_var=False, mu=0.0, gram=None,
                           device=None):
    """Device/Gram twin of native.lr_wiener_plane: identical returns
    (use, taps, sse, base[, var]), decisions bit-equal to the C++
    within the documented exactness bounds. `gram` (host int64) lets the
    fused chain supply the Gram; otherwise it is computed on `device`."""
    if gram is None:
        dev = resolve_device(device)
        with torch.inference_mode():
            gram = _wiener_gram(
                _upload(rec, dev), _upload(src, dev), h=h, w=w, u=unit,
                rows=rows, cols=cols, ntaps=ntaps,
            ).cpu().numpy()
    nb = 18 if ntaps == 3 else 11
    ppidx = _pair_index(nb)
    lmap = _basis_logical_map(ntaps)
    pidx = {(i, j): ppidx[(pi, lmap[j])]
            for i, pi in lmap.items() for j in lmap}
    U = rows * cols
    use = np.zeros(U, np.int32)
    taps = np.zeros((U, 6), np.int32)
    sse = np.zeros(U, np.float64)
    base = np.zeros(U, np.float64)
    var = np.zeros((U, 3), np.float64) if want_var else None
    gi = gram.reshape(gram.shape[0], -1)
    y1 = [h if ur == rows - 1 else (ur + 1) * unit for ur in range(rows)]
    x1 = [w if uc == cols - 1 else (uc + 1) * unit for uc in range(cols)]
    for ur in range(rows):
        for uc in range(cols):
            ui = ur * cols + uc
            n = (y1[ur] - ur * unit) * (x1[uc] - uc * unit)
            col = gi[:, ui]
            q = lambda i, j: int(col[pidx[(i, j)]])
            u_, t6, s_, b_, v_ = _wiener_unit_solve(
                q, n, ntaps, margin, mu, want_var
            )
            use[ui] = u_
            taps[ui] = t6
            sse[ui] = s_
            base[ui] = b_
            if want_var:
                var[ui] = v_
    if want_var:
        return use, taps, sse, base, var
    return use, taps, sse, base


# ---------------------------------------------------------------------------
# Loop restoration: SGRPROJ (self-guided) search.
#
# Split mirroring the C++ data flow (tilecoder.cpp lr_sgr_plane):
#   moments (device): the decoder-exact integer guided-filter passes for
#     every distinct (radius, strength) of the tier, plus exact int64 LS
#     moments per (unit, set) and the per-unit base/variance moments;
#   host: per-set projection solve, weight quantization/decode_xq,
#     predicted-SSE top-2 pick (f64 from exact integer moments: same
#     doubles as the C++);
#   exact SSE (device): exact integer SSE/fsum/fsq of the two
#     best-predicted sets per unit at their quantized weights (the
#     per-pixel round/clip makes this a pixel pass, not a quadratic form);
#   host: final met comparison (raw SSE, or the mu-penalized J).
# ---------------------------------------------------------------------------

_SGR_SETS = (
    (2, 1, 140, 3236), (2, 1, 112, 2158), (2, 1, 93, 1618),
    (2, 1, 80, 1438), (2, 1, 70, 1295), (2, 1, 58, 1177),
    (2, 1, 47, 1079), (2, 1, 37, 996), (2, 1, 30, 925),
    (2, 1, 25, 863), (0, 1, -1, 2589), (0, 1, -1, 1618),
    (0, 1, -1, 1177), (0, 1, -1, 925), (2, 0, 56, -1),
    (2, 0, 22, -1),
)
_SGR_REDUCED = (0, 3, 6, 9, 11, 14)
_SGR_FAST = (6, 9, 14)


@lru_cache(maxsize=None)
@trace.setup_phase("setup.programs")
def _sgr_tables():
    # x_by_xplus1 is computed arithmetically in _sgr_pass; only one_by_x
    # remains a table (scalar per pass)
    oneby = np.array([(4096 + n // 2) // n for n in range(1, 26)],
                     np.int64)
    return (oneby,)


def _tier_sets(tier):
    if tier == 1:
        return tuple(range(16))
    if tier == 2:
        return _SGR_FAST
    return _SGR_REDUCED


def _rpot(x, n):
    # rounded power-of-two shift for x >= 0 (C++ rpot)
    return x if n == 0 else (x + (1 << (n - 1))) >> n


def _sgr_pass(rec, h, w, r, s, bit_depth):
    """One guided-filter pass (radius r, strength s) over the whole
    plane, x16 domain output: bit-exact global formulation of the C++
    per-unit pass (unit boundaries share identical grid values because
    the extension clamp is at PLANE borders)."""
    (oneby_t,) = _sgr_tables()
    d = bit_depth - 8
    k = 2 * r + 1
    nn = k * k
    p = rec[:h, :w].to(I32)
    # 3-px border replicated from the plane's edge
    dev = p.device
    ry = torch.arange(-3, h + 3, device=dev).clamp(0, h - 1)
    rx = torch.arange(-3, w + 3, device=dev).clamp(0, w - 1)
    ext = p[ry][:, rx]

    # A/B grids over global positions R in [-1, h], C in [-1, w]:
    # window rows/cols [R-r, R+r] with plane-border replication.
    # Separable shifted adds (2*(2r+1) slice-adds).
    def box(E):
        # rows: out[R+1, c] = sum_{dy} E[(R+3)+dy, c], R in -1..h
        rs = None
        for dy in range(-r, r + 1):
            sl = E[2 + dy : 2 + dy + (h + 2), :]
            rs = sl if rs is None else rs + sl
        out = None
        for dx in range(-r, r + 1):
            sl = rs[:, 2 + dx : 2 + dx + (w + 2)]
            out = sl if out is None else out + sl
        return out

    # int32 throughout (asum <= 25*2^20): only p*s and the b2 triple
    # product need 64 bits
    bsum = box(ext)
    asum = box(ext * ext)
    a_ = _rpot(asum, 2 * d)
    bd_ = _rpot(bsum, d)
    pvar = a_ * nn - bd_ * bd_
    pvar = torch.clamp_min(pvar, 0)
    z = torch.clamp_max(_rpot(pvar.to(I64) * s, 20), 255).to(I32)
    # x_by_xplus1 computed arithmetically (an integer divide, no table
    # gather)
    a2 = torch.where(
        z == 0, 1,
        torch.where(z == 255, 256, ((z << 8) + (z >> 1)) // (z + 1)),
    )
    b2 = _rpot((256 - a2).to(I64) * bsum * int(oneby_t[nn - 1]),
               12).to(I32)

    # filter application; grid row/col G maps to index G+1 in a2/b2
    gU = lambda A, dy, dx: A[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]
    dg = p
    if r == 2:
        yy = torch.arange(h, device=dev)[:, None]
        even = (yy & 1) == 0
        aE = (6 * (gU(a2, -1, 0) + gU(a2, 1, 0))
              + 5 * (gU(a2, -1, -1) + gU(a2, -1, 1)
                     + gU(a2, 1, -1) + gU(a2, 1, 1)))
        bE = (6 * (gU(b2, -1, 0) + gU(b2, 1, 0))
              + 5 * (gU(b2, -1, -1) + gU(b2, -1, 1)
                     + gU(b2, 1, -1) + gU(b2, 1, 1)))
        aO = 6 * gU(a2, 0, 0) + 5 * (gU(a2, 0, -1) + gU(a2, 0, 1))
        bO = 6 * gU(b2, 0, 0) + 5 * (gU(b2, 0, -1) + gU(b2, 0, 1))
        fE = _rpot(aE * dg + bE, 9)
        fO = _rpot(aO * dg + bO, 8)
        return torch.where(even, fE, fO)
    a_s = (4 * (gU(a2, 0, 0) + gU(a2, 0, -1) + gU(a2, 0, 1)
                + gU(a2, -1, 0) + gU(a2, 1, 0))
           + 3 * (gU(a2, -1, -1) + gU(a2, -1, 1)
                  + gU(a2, 1, -1) + gU(a2, 1, 1)))
    b_s = (4 * (gU(b2, 0, 0) + gU(b2, 0, -1) + gU(b2, 0, 1)
                + gU(b2, -1, 0) + gU(b2, 1, 0))
           + 3 * (gU(b2, -1, -1) + gU(b2, -1, 1)
                  + gU(b2, 1, -1) + gU(b2, 1, 1)))
    return _rpot(a_s * dg + b_s, 9)


def _sgr_pass_list(tier):
    """Static distinct (r, s) pass list + per-set pass indices."""
    passes = []
    refs = []
    for si in _tier_sets(tier):
        r0, r1, s0, s1 = _SGR_SETS[si]
        i0 = i1 = -1
        if r0 > 0:
            if (2, s0) not in passes:
                passes.append((2, s0))
            i0 = passes.index((2, s0))
        if r1 > 0:
            if (1, s1) not in passes:
                passes.append((1, s1))
            i1 = passes.index((1, s1))
        refs.append((si, i0, i1))
    return tuple(passes), tuple(refs)


def _sgr_moments(rec, src, *, h, w, u, rows, cols, bit_depth, tier):
    """Guided passes + exact int64 LS moments per (unit, set):
    [h00, h11, h01, c0, c1, tt, sg0, sg1, su, ug0, ug1] plus the
    per-unit [rsum, rsq, ssum, ssq]."""
    passes, refs = _sgr_pass_list(tier)
    flt = [_sgr_pass(rec, h, w, r, s, bit_depth) for (r, s) in passes]
    uu = rec[:h, :w].to(I32) << 4
    tt_img = (src[:h, :w].to(I32) << 4) - uu
    ys, xs = _unit_bounds(h, w, u, rows, cols)
    # build every product image once, reduce them with ONE batched
    # slice-sum pass (plus the shared tt/su and the unit moments)
    prods = [tt_img * tt_img, uu]
    slots = {}
    for (si, i0, i1) in refs:
        f0 = (flt[i0] - uu) if i0 >= 0 else None
        f1 = (flt[i1] - uu) if i1 >= 0 else None
        row = []
        for name, img in (
            ("h00", f0 * f0 if f0 is not None else None),
            ("h11", f1 * f1 if f1 is not None else None),
            ("h01", f0 * f1 if (f0 is not None and f1 is not None)
             else None),
            ("c0", f0 * tt_img if f0 is not None else None),
            ("c1", f1 * tt_img if f1 is not None else None),
            ("tt", None), ("sg0", f0), ("sg1", f1), ("su", None),
            ("ug0", uu * f0 if f0 is not None else None),
            ("ug1", uu * f1 if f1 is not None else None),
        ):
            if name == "tt":
                row.append(0)
            elif name == "su":
                row.append(1)
            elif img is None:
                row.append(-1)
            else:
                row.append(len(prods))
                prods.append(img)
        slots[si] = row
    r32 = rec[:h, :w].to(I32)
    s32 = src[:h, :w].to(I32)
    unit_base = len(prods)
    prods += [r32, r32 * r32, s32, s32 * s32]
    red = _unit_sums_batch(torch.stack(prods), ys, xs)
    zero_rc = torch.zeros((rows, cols), dtype=I64, device=rec.device)
    per_set = torch.stack([
        torch.stack([red[si] if si >= 0 else zero_rc
                     for si in slots[ref[0]]])
        for ref in refs
    ])
    unit_m = red[unit_base : unit_base + 4]
    return per_set, unit_m


def _sgr_exact_sse(rec, src, cand_idx, cand_dq, *, h, w, u, rows, cols,
                   bit_depth, tier):
    """Exact integer SSE/fsum/fsq for 2 candidate sets per unit.
    cand_idx: (2, rows, cols, 2) int32 pass indices (-1 = absent);
    cand_dq: (2, rows, cols, 2) int32 decoded weights. Returns
    (2, 3, rows, cols) int64."""
    passes, _refs = _sgr_pass_list(tier)
    flt = torch.stack(
        [_sgr_pass(rec, h, w, r, s, bit_depth) for (r, s) in passes]
    )
    uu = rec[:h, :w].to(I32) << 4
    sp = src[:h, :w].to(I32)
    maxv = (1 << bit_depth) - 1
    ys, xs = _unit_bounds(h, w, u, rows, cols)
    us = lambda P: _unit_sums(P, ys, xs)
    # per-pixel unit coordinates
    dev = rec.device
    uid_y = torch.arange(h, device=dev).div(u, rounding_mode="floor") \
        .clamp_max(rows - 1)
    uid_x = torch.arange(w, device=dev).div(u, rounding_mode="floor") \
        .clamp_max(cols - 1)
    out = []
    for c in range(2):
        idx_px = [cand_idx[c, :, :, j][uid_y][:, uid_x].to(I32)
                  for j in range(2)]
        dq_px = [cand_dq[c, :, :, j][uid_y][:, uid_x].to(I32)
                 for j in range(2)]
        v = uu << 7
        for j in range(2):
            sel = torch.zeros_like(uu)
            for pi in range(len(passes)):
                sel = torch.where(idx_px[j] == pi, flt[pi], sel)
            v = v + torch.where(idx_px[j] >= 0, dq_px[j] * (sel - uu), 0)
        wv = torch.clamp((v + (1 << 10)) >> 11, 0, maxv)
        dd = wv - sp
        out.append(torch.stack([us(dd * dd), us(wv), us(wv * wv)]))
    return torch.stack(out)


def lr_sgr_plane_device(src, rec, h, w, unit, rows, cols, bit_depth,
                        tier, want_var=False, mu=0.0, moments=None,
                        sse_eval=None, device=None):
    """Device twin of native.lr_sgr_plane: same returns (set, xqd,
    sse[, var]), decisions bit-equal to the C++. `moments`/`sse_eval`
    (host arrays) allow a fused pipeline to supply the device outputs
    directly."""
    tier = int(tier)
    kw = dict(h=h, w=w, u=unit, rows=rows, cols=cols, bit_depth=bit_depth,
              tier=tier)
    dev = None
    if moments is None or sse_eval is None:
        dev = resolve_device(device)
        rec_t, src_t = _upload(rec, dev), _upload(src, dev)
    if moments is None:
        with torch.inference_mode():
            per_set, unit_m = _sgr_moments(rec_t, src_t, **kw)
            per_set = per_set.cpu().numpy()
            unit_m = unit_m.cpu().numpy()
    else:
        per_set, unit_m = moments
    cands, ci, cd = _sgr_host_candidates(
        per_set, h, w, unit, rows, cols, mu, tier
    )
    if sse_eval is None:
        with torch.inference_mode():
            sse_eval = _sgr_exact_sse(
                rec_t, src_t, torch.from_numpy(ci).to(dev),
                torch.from_numpy(cd).to(dev), **kw,
            ).cpu().numpy()
    return _sgr_host_select(cands, sse_eval, unit_m, rows, cols,
                            want_var, mu)


def _clipi(v, lo, hi):
    # C++ clipi: nearbyint then clamp (as a double compare), cast int
    r_ = float(np.rint(v))
    return int(lo if r_ < lo else (hi if r_ > hi else r_))


def _sgr_unit_candidates(mrow, n, mu, tier):
    """Per-set solve + predicted SSE for one unit (f64 mirror of the
    C++ loop); mrow: (nsets, 11) int64 moments. Returns candidate list
    and the top-2 indices picked with the C++ tie rule."""
    _passes, refs = _sgr_pass_list(tier)
    nf = float(n)
    cl = []
    for li, (si, i0, i1) in enumerate(refs):
        (h00, h11, h01, c0, c1, tt, sg0, sg1, su, ug0, ug1) = (
            float(v) for v in mrow[li]
        )
        r0, r1 = _SGR_SETS[si][0], _SGR_SETS[si][1]
        flt0, flt1 = i0 >= 0, i1 >= 0
        e00, e11, e01, d0, d1 = h00, h11, h01, c0, c1
        if mu > 0.0:
            e00 = h00 - mu * (h00 - sg0 * sg0 / nf)
            e11 = h11 - mu * (h11 - sg1 * sg1 / nf)
            e01 = h01 - mu * (h01 - sg0 * sg1 / nf)
            d0 = c0 + mu * (ug0 - su * sg0 / nf)
            d1 = c1 + mu * (ug1 - su * sg1 / nf)
        scale = 128.0
        b0 = b1 = 0.0
        if flt0 and flt1:
            det = e00 * e11 - e01 * e01
            if det > 0:
                b0 = scale * (e11 * d0 - e01 * d1) / det
                b1 = scale * (e00 * d1 - e01 * d0) / det
        elif flt0:
            b0 = scale * d0 / e00 if e00 > 0 else 0.0
        else:
            b1 = scale * d1 / e11 if e11 > 0 else 0.0
        xq0 = _clipi(b0, -96, 31) if r0 else 0
        if r1:
            xqd1 = _clipi(128.0 - xq0 - float(np.rint(b1)), -32, 95)
        else:
            xqd1 = _clipi(128.0 - xq0, -32, 95)
        if r0 == 0:
            dq0 = 0
            dq1 = 128 - dq0 - xqd1
        elif r1 == 0:
            dq0 = xq0
            dq1 = 0
        else:
            dq0 = xq0
            dq1 = 128 - dq0 - xqd1
        w0, w1 = dq0 / 128.0, dq1 / 128.0
        pred = tt
        if flt0:
            pred += w0 * w0 * h00 - 2.0 * w0 * c0
        if flt1:
            pred += w1 * w1 * h11 - 2.0 * w1 * c1
        if flt0 and flt1:
            pred += 2.0 * w0 * w1 * h01
        if mu > 0.0:
            dvar = 0.0
            if flt0:
                dvar += (2.0 * w0 * (ug0 - su * sg0 / nf)
                         + w0 * w0 * (h00 - sg0 * sg0 / nf))
            if flt1:
                dvar += (2.0 * w1 * (ug1 - su * sg1 / nf)
                         + w1 * w1 * (h11 - sg1 * sg1 / nf))
            if flt0 and flt1:
                dvar += 2.0 * w0 * w1 * (h01 - sg0 * sg1 / nf)
            pred -= mu * dvar
        cl.append(dict(set=si, x0=xq0, x1=xqd1, dq0=dq0, dq1=dq1,
                       i0=i0, i1=i1, pred=pred))
    o1, o2 = 0, -1
    for li in range(1, len(cl)):
        if cl[li]["pred"] < cl[o1]["pred"]:
            o2, o1 = o1, li
        elif o2 < 0 or cl[li]["pred"] < cl[o2]["pred"]:
            o2 = li
    return cl, o1, o2


def _sgr_host_candidates(per_set, h, w, unit, rows, cols, mu, tier):
    """Host half 1: per-unit per-set solve + top-2 pick; returns the
    candidate records and the (2, rows, cols, 2) pass-index / weight
    arrays for the exact-SSE device pass."""
    cands = []
    ci = np.full((2, rows, cols, 2), -1, np.int32)
    cd = np.zeros((2, rows, cols, 2), np.int32)
    for ur in range(rows):
        for uc in range(cols):
            y1 = h if ur == rows - 1 else (ur + 1) * unit
            x1 = w if uc == cols - 1 else (uc + 1) * unit
            n = (y1 - ur * unit) * (x1 - uc * unit)
            mrow = per_set[:, :, ur, uc]
            cl, o1, o2 = _sgr_unit_candidates(mrow, n, mu, tier)
            cands.append((cl, o1, o2, n))
            for c, li in ((0, o1), (1, o2)):
                if li < 0:
                    continue
                C = cl[li]
                ci[c, ur, uc] = (C["i0"], C["i1"])
                cd[c, ur, uc] = (C["dq0"], C["dq1"])
    return cands, ci, cd


def _sgr_host_select(cands, sse_eval, unit_m, rows, cols, want_var, mu):
    """Host half 2: final best-of-two on the exact SSE (C++ met
    comparison mirror)."""
    U = rows * cols
    out_set = np.zeros(U, np.int32)
    out_xqd = np.zeros((U, 2), np.int32)
    out_sse = np.zeros(U, np.float64)
    out_var = np.zeros((U, 3), np.float64) if want_var else None
    for ui, (cl, o1, o2, n) in enumerate(cands):
        ur, uc = ui // cols, ui % cols
        nf = float(n)
        best = None  # (set, x0, x1, sse, fsum, fsq)
        for c, li in ((0, o1), (1, o2)):
            if li < 0:
                continue
            C = cl[li]
            sse_i, fsum_i, fsq_i = (
                float(v) for v in sse_eval[c, :, ur, uc]
            )
            met = sse_i
            if mu > 0.0:
                met -= mu * (fsq_i - fsum_i * fsum_i / nf)
            if best is None:
                best = (C, sse_i, fsum_i, fsq_i)
                continue
            best_met = best[1]
            if mu > 0.0:
                best_met = best[1] - mu * (
                    best[3] - best[2] * best[2] / nf)
            if met < best_met:
                best = (C, sse_i, fsum_i, fsq_i)
        C, bsse, bfsum, bfsq = best
        out_set[ui] = C["set"]
        out_xqd[ui] = (C["x0"], C["x1"])
        out_sse[ui] = bsse
        if want_var:
            rsum, rsq, ssum, ssq = (
                float(v) for v in unit_m[:, ur, uc]
            )
            out_var[ui] = (
                ssq - ssum * ssum / nf,
                rsq - rsum * rsum / nf,
                bfsq - bfsum * bfsum / nf,
            )
    if want_var:
        return out_set, out_xqd, out_sse, out_var
    return out_set, out_xqd, out_sse



# ---------------------------------------------------------------------------
# Per-frame filter chain: deblock -> CDEF -> LR statistics on the device
# (F1), plus the small exact-SSE follow-up (F2) once the host has solved
# the LR projections: two round trips per frame.
# ---------------------------------------------------------------------------


def _filter_chain(rec, src, tw, th, ev, eh, skip, y_cands, uv_cands,
                  damping, *, P, bit_depth, mi_rows, mi_cols, vis,
                  db_sub, cdef_on, cdef_sub, cdef_fast_sec, cdef_cands,
                  lr_h, lr_w, lr_u, lr_rows, lr_cols, lrf_on, sgr_tier,
                  sgr_planes):
    """F1: deblock search + apply, CDEF search + apply, and the LR
    statistics (Wiener Grams, SGR moments) of both branches: "a" the
    CDEF output, "b" the deblocked frame. Traced, CUDA events time its
    sub-stages (utils/trace.py `mark`: `gpu_device_filters.deblock`,
    `.cdef`, `.lr_stats`)."""
    trace.mark("device_filters.deblock", rec)
    levels, dstack, _deltas = _deblock_search_apply(
        rec, src, tw, th, ev, eh, y_cands, uv_cands,
        bit_depth=bit_depth, mi_rows=mi_rows, mi_cols=mi_cols, vis=vis,
        row_sub=db_sub,
    )
    trace.mark("device_filters.cdef", rec)
    if cdef_on:
        strengths, cstack, _ay, _auv, _dirs, _vars = _cdef_search_apply(
            dstack, src, skip, damping, bit_depth=bit_depth,
            mi_rows=mi_rows, mi_cols=mi_cols, vis=vis, sub=cdef_sub,
            fast_sec=cdef_fast_sec, cands=cdef_cands,
        )
    else:
        strengths = torch.zeros(4, dtype=I32, device=rec.device)
        cstack = dstack
    out = dict(levels=levels, strengths=strengths, dstack=dstack,
               cstack=cstack, src=src)
    trace.mark("device_filters.lr_stats", rec)
    if lrf_on:
        for bi, stack in (("a", cstack), ("b", dstack)):
            out["gram_" + bi + "_y"] = _wiener_gram(
                stack[0], src[0], h=lr_h, w=lr_w, u=lr_u, rows=lr_rows,
                cols=lr_cols, ntaps=3,
            )
            if P == 3:
                # chroma solves use 2 taps: the 11-image basis (66
                # pairs) costs 2.6x less than the full Gram
                out["gram_" + bi + "_uv"] = torch.stack([
                    _wiener_gram(stack[pl], src[pl], h=lr_h, w=lr_w,
                                 u=lr_u, rows=lr_rows, cols=lr_cols,
                                 ntaps=2)
                    for pl in (1, 2)
                ])
            if sgr_tier is not None:
                moms = []
                unitms = []
                for pl in sgr_planes:
                    ms, um = _sgr_moments(
                        stack[pl], src[pl], h=lr_h, w=lr_w, u=lr_u,
                        rows=lr_rows, cols=lr_cols,
                        bit_depth=bit_depth, tier=sgr_tier,
                    )
                    moms.append(ms)
                    unitms.append(um)
                out["sgr_" + bi] = torch.stack(moms)
                out["sgru_" + bi] = torch.stack(unitms)
    trace.mark(None, rec)
    return out


def _filter_sse_chain(dstack, cstack, src, use_a, ci, cd, *, bit_depth,
                      lr_h, lr_w, lr_u, lr_rows, lr_cols, sgr_tier,
                      sgr_planes):
    """F2: exact SGR SSE for the branch the host picked. ci/cd:
    (n_sgr_planes, 2, rows, cols, 2) int32."""
    stack = cstack if use_a else dstack
    return torch.stack([
        _sgr_exact_sse(
            stack[pl], src[pl], ci[i], cd[i], h=lr_h, w=lr_w, u=lr_u,
            rows=lr_rows, cols=lr_cols, bit_depth=bit_depth, tier=sgr_tier,
        )
        for i, pl in enumerate(sgr_planes)
    ])


def _names_card(dev) -> bool:
    return isinstance(dev, str) and dev.startswith("cuda")


def device_filters_enabled(fe) -> bool:
    """Device filter chain gate: CAVIF_TPU_DEVICE_FILTERS=1 forces on,
    =0 off; unset = auto: on when the frame's pass 1 already runs on
    the card (fe._device_search names "cuda") AND the recorded
    attachment probe says the card is direct-attached
    (ops/attachment.py). A CPU pass 1 ("cpu") or the host cascade
    (None) leaves it off. Requires the native library (replay op
    streams build the filter maps)."""
    v = os.environ.get("CAVIF_TPU_DEVICE_FILTERS")
    if v is not None:
        return v not in ("", "0", "off")
    if not _names_card(getattr(fe, "_device_search", None)):
        return False
    from .attachment import engage_device_filters

    return engage_device_filters()


def _chain_device(fe) -> str:
    """The frame's pass-1 device ("cuda..." or "cpu"); the card when pass
    1 ran elsewhere (host cascade, injected grids) and the chain was
    forced on. Raises when the card is asked for and there is none."""
    dev = getattr(fe, "_device_search", None)
    if dev == "cpu" or _names_card(dev):
        return resolve_device(dev)
    return resolve_device(None)


def run_filter_chain(fe):
    """Run the full post-recon filter chain (deblock level search +
    apply, CDEF search + apply, CDEF-vs-deblock arbitration, loop-
    restoration solves) with the pixel work on the device: F1 + one
    small F2 (exact SGR SSE), all decisions bit-equal to the host C++
    chain. Mutates `fe` exactly like the host path (_filter_maps,
    _lf_levels, _lr_wiener_cache/_lr_sgr_cache, _filtered_stack as a
    host int32 stack of the winning branch, fetched once) and finishes
    with the shared _lr_solve selection. Returns (lf_levels, cdef_y,
    cdef_uv, cdef_damping, lr_on), or None when the replay ops or the
    recon are unavailable (record overflow): a data condition, not a
    device failure. Device errors propagate.

    Traced, each round trip's span (`device_filters.f1`, `.f2`) holds two
    children: `.issue`, the uploads and the kernels' launch, and `.wait`,
    the host's wait for the card's answer."""
    from ..native import build_filter_maps
    from .device_pass1 import PASS1_HOOKS

    ops = fe._output_filter_ops()
    rec = fe._recon_full()
    if ops is None or rec is None:
        return None
    dev = _chain_device(fe)
    cfg = fe.cfg
    P = fe.num_planes
    h, w = cfg.height, cfg.width
    speed = cfg.tweaks.speed_preset
    maps = build_filter_maps(ops, fe.mi_rows, fe.mi_cols, P)
    fe._filter_maps = maps
    skip, txw_l2, txh_l2, edge_v, edge_h = maps

    # -- deblock params (mirror _deblock_apply)
    cands = _deblock_cands(fe._lf_hint())
    db_sub = 1 if speed <= 2 else (2 if speed <= 3 else 4)

    # -- cdef params (mirror _cdef_apply)
    minq = int(os.environ.get("CAVIF_TPU_CDEF_MINQ", "0"))
    cdef_on = bool(cfg.tweaks.cdef) and fe.base_q >= minq
    damping = min(6, 3 + (fe.base_q >> 6))
    pri = fe.CDEF_PRI if speed <= 3 else fe.CDEF_PRI_FAST
    cdef_cands = (0,) + tuple(pri)
    cdef_sub = 1 if speed <= 2 else (2 if speed <= 3 else 4)
    fast_sec = 1 if speed >= 4 else 0

    # -- LR params (mirror _lr_solve / _lr_wiener_stage)
    lrf_on = bool(cfg.tweaks.lrf)
    u = fe.LR_UNIT
    rows, cols = fe._lr_grid()
    sgr_full = bool(cfg.tweaks.sgr_complexity_full)
    tier = 1 if sgr_full else (2 if speed >= 4 else 0)
    sgr_planes = tuple(range(P)) if sgr_full else (0,)
    mu = fe._lr_psy_mu()
    want_var = fe._lr_var_guard() > 0.0 or mu > 0.0
    lam = fe._lambda()
    psy_px = float(os.environ.get("CAVIF_TPU_LR_MARGIN_PX", "0"))
    lr_geo = dict(lr_h=h, lr_w=w, lr_u=u, lr_rows=rows, lr_cols=cols)

    hooks = PASS1_HOOKS.get()
    if hooks is not None:
        hooks.start()
    try:
        with torch.inference_mode(), trace.span("device_filters.f1"):
            with trace.span("device_filters.f1.issue"):
                cand_t = torch.tensor(cands, dtype=I32, device=dev)
                res = _filter_chain(
                    _upload(rec, dev), _upload(fe._src_stack(), dev),
                    *(_filter_grids(a, fe.mi_rows, fe.mi_cols, dev)
                      for a in (txw_l2, txh_l2, edge_v, edge_h)),
                    _upload(np.asarray(skip).reshape(fe.mi_rows,
                                                     fe.mi_cols), dev),
                    cand_t, cand_t, damping,
                    P=P, bit_depth=fe.bit_depth, mi_rows=fe.mi_rows,
                    mi_cols=fe.mi_cols, vis=(w, h), db_sub=db_sub,
                    cdef_on=cdef_on, cdef_sub=cdef_sub,
                    cdef_fast_sec=fast_sec, cdef_cands=cdef_cands,
                    lrf_on=lrf_on, sgr_tier=tier if lrf_on else None,
                    sgr_planes=sgr_planes if lrf_on else (), **lr_geo,
                )
            with trace.span("device_filters.f1.wait"):
                levels = tuple(int(x) for x in res["levels"].tolist())
                strengths = tuple(int(x) for x in res["strengths"].tolist())
    finally:
        trace.read_marks()
        if hooks is not None:
            hooks.done()

    fe._lf_levels = levels
    y_pri, y_sec, uv_pri, uv_sec = strengths
    coded = lambda s: 3 if s == 4 else s
    cdef_applied = cdef_on and any(strengths)
    if cdef_applied:
        cdef_y = ((y_pri, coded(y_sec)),)
        cdef_uv = ((uv_pri, coded(uv_sec)),) if P == 3 else ()
    else:
        cdef_y, cdef_uv = (), ()
    damping_ret = damping if cdef_on else 3

    lr_on = False
    use_a = cdef_applied
    if lrf_on:
        margin_w = 2.0 * lam * 40.0 + psy_px * float(u * u)
        host = lambda key: res[key].cpu().numpy()
        gram_y = {"a": host("gram_a_y"), "b": host("gram_b_y")}
        gram_uv = ({"a": host("gram_a_uv"), "b": host("gram_b_uv")}
                   if P == 3 else None)
        arb = (cdef_applied
               and fe.base_q >= int(
                   os.environ.get("CAVIF_TPU_LR_MINQ", "0"))
               and os.environ.get("CAVIF_TPU_CDEF_ARB", "1") != "0")

        def wiener_stage_luma(gram_pl):
            # mirror of _lr_wiener_stage's luma-only branch metric
            r_ = lr_wiener_plane_device(
                None, None, h, w, u, rows, cols, 3, margin_w,
                want_var=want_var, mu=mu, gram=gram_pl,
            )
            wu, wsse, wbase = r_[0], r_[2], r_[3]
            if mu > 0.0:
                var = r_[4]
                j_f = wsse - mu * var[:, 2]
                j_b = wbase - mu * var[:, 1]
                fs = float(np.where(wu != 0, j_f, j_b).sum())
            else:
                fs = float(np.where(wu != 0, wsse, wbase).sum())
            return r_, fs

        win_cache = [None] * P
        if arb:
            ra, fa = wiener_stage_luma(gram_y["a"])
            rb, fb = wiener_stage_luma(gram_y["b"])
            if fb <= fa:
                use_a = False
                cdef_y, cdef_uv = (), ()
                win_cache[0] = rb
            else:
                win_cache[0] = ra
        br = "a" if use_a else "b"
        for pl in range(P):
            if win_cache[pl] is None:
                win_cache[pl] = lr_wiener_plane_device(
                    None, None, h, w, u, rows, cols,
                    2 if pl > 0 else 3, margin_w, want_var=want_var,
                    mu=mu,
                    gram=(gram_y[br] if pl == 0
                          else gram_uv[br][pl - 1]),
                )
        fe._lr_wiener_cache = win_cache

        # SGR: host candidate solve from F1 moments, one F2 exact-SSE
        # call on the winning branch, then the C++ final pick
        sgr_cache = {}
        moms = host("sgr_a" if use_a else "sgr_b")
        unitm = host("sgru_a" if use_a else "sgru_b")
        all_c = []
        ci = np.full((len(sgr_planes), 2, rows, cols, 2), -1, np.int32)
        cd = np.zeros((len(sgr_planes), 2, rows, cols, 2), np.int32)
        for i, pl in enumerate(sgr_planes):
            cands_i, ci_i, cd_i = _sgr_host_candidates(
                moms[i], h, w, u, rows, cols, mu, tier
            )
            all_c.append(cands_i)
            ci[i] = ci_i
            cd[i] = cd_i
        if hooks is not None:
            hooks.start()
        try:
            with torch.inference_mode(), trace.span("device_filters.f2"):
                with trace.span("device_filters.f2.issue"):
                    ci_t = torch.from_numpy(ci).to(dev)
                    cd_t = torch.from_numpy(cd).to(dev)
                    trace.mark("device_filters.f2", ci_t)
                    sse_t = _filter_sse_chain(
                        res["dstack"], res["cstack"], res["src"], use_a,
                        ci_t, cd_t, bit_depth=fe.bit_depth, sgr_tier=tier,
                        sgr_planes=sgr_planes, **lr_geo,
                    )
                    trace.mark(None, ci_t)
                with trace.span("device_filters.f2.wait"):
                    sse_eval = sse_t.cpu().numpy()
        finally:
            trace.read_marks()
            if hooks is not None:
                hooks.done()
        for i, pl in enumerate(sgr_planes):
            sgr_cache[pl] = _sgr_host_select(
                all_c[i], sse_eval[i], unitm[i], rows, cols, want_var,
                mu,
            )
        fe._lr_sgr_cache = sgr_cache
    # every reader of _filtered_stack (_lr_solve, _cdef_apply,
    # _lr_recon_stack) takes host arrays: fetch the winning branch once
    with trace.span("device_filters.fetch"):
        fe._filtered_stack = res["cstack" if use_a else "dstack"].cpu().numpy()
    if lrf_on:
        lr_on = fe._lr_solve()
    return levels, cdef_y, cdef_uv, damping_ret, lr_on
