"""Pass-2 reconstruction wavefront on torch tensors (uniform-grid executor).

The sequential heart of pass 2 — predict each block from LIVE
reconstruction, add the exact-integer inverse residual, update the
reconstruction — run as a walk over wavefront levels. Blocks are
scheduled into levels by the true read-dependency DAG (a block depends on
every block whose pixels its spec neighbor reads touch, including
above-right/below-left extensions when the BlockDecoded mask makes them
available), so the blocks of one level never read each other; each level
executes as a batch: one packed gather of the extended neighbors from the
live recon plane, the bit-exact predictors of each block's selected
candidate (ops/device_predict.pred_body_select), the residual, and one
scatter of the level's blocks into the plane.

This is the device form of FrameEncoder's pass-2 walk for a uniform
n x n NONE partition: given the skeleton's decisions and coded levels, it
reconstructs the planes bit-identically to the host walk
(tests/test_torch_pass2.py pins equality against a live FrameEncoder
encode and against the JAX package's executors). One executor serves the
three entry points:

- recon_wavefront_scan_frame: a (P, ...) plane axis, where every plane
  and every tile of a (tr, tc) grid is an independent stream and all
  streams walk their wavefronts together;
- recon_wavefront_scan and recon_wavefront_uniform: one plane, one tile
  (the frame executor with P = 1 and tile grid (1, 1)). The reference's
  two single-plane executors differ only in how XLA traces them; eager
  PyTorch has no trace, so both names run the same walk.

The lane tables are compact: level s owns lanes starts[s]:starts[s+1],
with no padding lanes. The inverse transforms depend only on the coded
levels, so they run before the walk, one batched call per DCT/ADST
variant over the lanes coded in it. Host preparation (the fixed-point
schedule, the per-block packing) is numpy; every index table goes up once
as int64 and each level reads a slice of it. Torch runs eagerly, so each
level issues its own CUDA kernels (chip_smoke.py's [pass2] lines count
them).

Reference: cavif_tpu/ops/device_pass2.py (jitted XLA there, lax.scan
over padded levels; no TPU kernel). There the unrolled executor was
cached on the whole schedule; here only constant tables are cached, per
shape and device (device_predict.pred_body_select, device_itx.inv_body).
"""

from __future__ import annotations

import numpy as np
import torch

from .device_itx import inv_body
from .device_pass1 import resolve_device
from .device_predict import _cand_index, pred_body_select

I32 = torch.int32


def _mask_flags(nby: int, nbx: int):
    """have_ar / have_bl per 16px block of 64px superblocks, walking the
    real coding order (z-order within each SB) against the spec
    BlockDecoded mask — mirrors FrameEncoder._reset_mask/_neighbors_ext
    for a uniform 16px grid."""
    have_ar = np.zeros((nby, nbx), bool)
    have_bl = np.zeros((nby, nbx), bool)
    zorder = []
    for qy in (0, 2):
        for qx in (0, 2):
            for sy in (0, 1):
                for sx in (0, 1):
                    zorder.append((qy + sy, qx + sx))
    sb_rows = (nby + 3) // 4
    sb_cols = (nbx + 3) // 4
    for sbr in range(sb_rows):
        for sbc in range(sb_cols):
            mask = np.zeros((18, 18), np.uint8)
            mask[0, :] = 1
            mask[1:17, 0] = 1
            for (zy, zx) in zorder:
                by, bx = sbr * 4 + zy, sbc * 4 + zx
                if by >= nby or bx >= nbx:
                    continue
                sy, sx = zy * 4, zx * 4  # mi units inside the SB (+1 off)
                ha = by > 0
                hl = bx > 0
                have_ar[by, bx] = ha and bool(mask[sy, sx + 4 + 1])
                have_bl[by, bx] = hl and bool(mask[sy + 4 + 1, sx])
                mask[sy + 1 : sy + 5, sx + 1 : sx + 5] = 1
    return have_ar, have_bl


def _schedule(nby: int, nbx: int, have_ar, have_bl):
    """Topological wavefront levels of the read-dependency DAG."""
    level = np.zeros((nby, nbx), np.int32)
    # below-left reads create forward references: iterate to a fixed point
    for _ in range(2 * (nby + nbx)):
        changed = False
        for by in range(nby):
            for bx in range(nbx):
                lv = 0
                if by > 0:
                    lv = max(lv, level[by - 1, bx] + 1)
                    if have_ar[by, bx] and bx + 1 < nbx:
                        lv = max(lv, level[by - 1, bx + 1] + 1)
                if bx > 0:
                    lv = max(lv, level[by, bx - 1] + 1)
                    if have_bl[by, bx] and by + 1 < nby:
                        lv = max(lv, level[by + 1, bx - 1] + 1)
                if lv > level[by, bx]:
                    level[by, bx] = lv
                    changed = True
        if not changed:
            break
    steps = []
    for s in range(int(level.max()) + 1):
        steps.append([tuple(p) for p in np.argwhere(level == s)])
    return steps


def _frame_inputs(levels, modes, deltas, va, ha, H: int, W: int, n: int,
                  tile_grid):
    """The compact lane tables of a whole frame (host numpy): (starts,
    pl, gy, gx, case, cand, txv, lvs, oy, ox), one lane per block. Level s
    of every (plane, tile) stream is packed into the frame's level s,
    lanes starts[s]:starts[s+1] (int64, S + 1 entries). gy/gx are the
    packed gather coordinates [above row (L) | left col (L) | al] per
    lane, (N, 2L+1); neighbor extensions clamp at the tile edge."""
    P = levels.shape[0]
    nby, nbx = H // n, W // n
    tr, tc = tile_grid
    idx = _cand_index(True)
    ar = np.arange(2 * n)
    # per-tile schedules (tile-local geometry: availability stops at the
    # tile edge, like the pass-1 _nbrs tile masking / pass-2 rr4, cc4)
    streams = []
    for pl in range(P):
        for ty in range(tr):
            for tx in range(tc):
                b0, b1 = ty * nby // tr, (ty + 1) * nby // tr
                c0, c1 = tx * nbx // tc, (tx + 1) * nbx // tc
                h_ar, h_bl = _mask_flags(b1 - b0, c1 - c0)
                st = _schedule(b1 - b0, c1 - c0, h_ar, h_bl)
                streams.append((pl, b0, c0, b1, c1, h_ar, h_bl, st))
    S = max(len(t[-1]) for t in streams)
    counts = np.zeros(S, np.int64)
    for t in streams:
        counts[: len(t[-1])] += [len(b) for b in t[-1]]
    starts = np.concatenate([[0], np.cumsum(counts)])
    N = int(starts[-1])
    L = 2 * n
    pl_a = np.zeros(N, np.int32)
    gy = np.zeros((N, 2 * L + 1), np.int32)
    gx = np.zeros((N, 2 * L + 1), np.int32)
    case = np.zeros(N, np.int32)
    cand = np.zeros(N, np.int32)
    txv = np.zeros(N, np.int32)
    lvs = np.zeros((N, n, n), np.int32)
    oy = np.zeros(N, np.int32)
    ox = np.zeros(N, np.int32)
    fill = starts[:-1].copy()
    for (pl, b0, c0, b1, c1, h_ar, h_bl, st) in streams:
        for s, blocks in enumerate(st):
            for (lby, lbx) in blocks:
                k = fill[s]
                fill[s] += 1
                by, bx = b0 + lby, c0 + lbx
                y0, x0 = by * n, bx * n
                have_a = lby > 0
                have_l = lbx > 0
                case[k] = (2 if have_a else 0) | (1 if have_l else 0)
                # neighbor extensions clamp at the TILE edge (host pass-2
                # reads clamp at ctx.end, the tile mi bounds)
                n_av = n + (n if h_ar[lby, lbx] else 0)
                gx[k, :L] = np.minimum(x0 + np.minimum(ar, n_av - 1),
                                       c1 * n - 1)
                gy[k, :L] = max(y0 - 1, 0)
                n_lv = n + (n if h_bl[lby, lbx] else 0)
                gy[k, L : 2 * L] = np.minimum(y0 + np.minimum(ar, n_lv - 1),
                                              b1 * n - 1)
                gx[k, L : 2 * L] = max(x0 - 1, 0)
                gy[k, 2 * L] = max(y0 - 1, 0)
                gx[k, 2 * L] = max(x0 - 1, 0)
                pl_a[k] = pl
                cand[k] = idx[(int(modes[pl, by, bx]),
                               int(deltas[pl, by, bx]))]
                txv[k] = int(va[pl, by, bx]) * 2 + int(ha[pl, by, bx])
                lvs[k] = levels[pl, by, bx]
                oy[k] = y0
                ox[k] = x0
    return starts, pl_a, gy, gx, case, cand, txv, lvs, oy, ox


class _Lanes:
    """The lane tables on the device, uploaded once: flat int64 gather
    and scatter offsets into the (P, H, W) recon stack, case masks,
    candidate indices, the coded levels."""

    def __init__(self, dev, H, W, n, pl, gy, gx, case, cand, lvs, oy, ox):
        r = np.arange(n, dtype=np.int64)
        pl64 = pl.astype(np.int64)
        glin = pl64[:, None] * (H * W) + gy.astype(np.int64) * W + gx
        wlin = ((pl64 * (H * W) + oy.astype(np.int64) * W + ox)[:, None, None]
                + r[:, None] * W + r[None, :])

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        self.glin, self.wlin = up(glin), up(wlin)
        self.cand = up(cand.astype(np.int64))
        self.lvs = up(lvs)
        case = up(case)
        self.c0, self.c1, self.c2 = case == 0, case == 1, case == 2
        self.have_a, self.have_l = case >= 2, (case & 1) == 1


def _neighbors(flat, lanes, sl, L, base):
    """Spec-extended (above_ext, left_ext, al, have_a, have_l) of the
    lanes `sl` of one level: ONE packed gather from the live recon, then
    the availability fallbacks (case 0: none, 1: left only, 2: above
    only)."""
    g = flat[lanes.glin[sl]]  # (k, 2L+1)
    c0 = lanes.c0[sl]
    c1 = lanes.c1[sl]
    c2 = lanes.c2[sl]
    ae_g = g[:, :L]
    le_g = g[:, L : 2 * L]
    ae = torch.where(c0[:, None], base - 1,
                     torch.where(c1[:, None], le_g[:, 0:1], ae_g))
    le = torch.where(c0[:, None], base + 1,
                     torch.where(c2[:, None], ae_g[:, 0:1], le_g))
    al = torch.where(c0, base, torch.where(
        c1, le_g[:, 0], torch.where(c2, ae_g[:, 0], g[:, 2 * L])))
    return ae, le, al, lanes.have_a[sl], lanes.have_l[sl]


def _walk(dev, P, H, W, n, bit_depth, dc_q, ac_q, tabs):
    """The executor over compact level tables (see _frame_inputs);
    returns the (P, H, W) int32 recon on the device."""
    starts, pl, gy, gx, case, cand, txv, lvs, oy, ox = tabs
    lanes = _Lanes(dev, H, W, n, pl, gy, gx, case, cand, lvs, oy, ox)
    base = 1 << (bit_depth - 1)
    maxv = (1 << bit_depth) - 1
    L = 2 * n
    # the inverse transforms depend only on the coded levels: each lane's
    # residual up front, one batched call per DCT/ADST variant over the
    # lanes coded in it, so the walk is gather -> predict -> add -> scatter
    resid = torch.empty((len(txv), n, n), dtype=I32, device=dev)
    for v in range(4):
        sel = np.flatnonzero(txv == v)
        if sel.size:
            i = torch.from_numpy(sel).to(dev)
            resid[i] = inv_body(n, n, bit_depth, v >> 1, v & 1)(
                lanes.lvs[i], dc_q, ac_q)
    pred = pred_body_select(n, n, bit_depth, True, dev)
    recon = torch.zeros((P, H, W), dtype=I32, device=dev)
    flat = recon.view(-1)
    for a, b in zip(starts[:-1].tolist(), starts[1:].tolist()):
        sl = slice(a, b)
        p = pred(*_neighbors(flat, lanes, sl, L, base), lanes.cand[sl])
        # the blocks of one level are distinct, so the scatter is unique
        flat[lanes.wlin[sl]] = (p + resid[sl]).clamp_(0, maxv)
    return recon


def recon_wavefront_scan_frame(
    levels: np.ndarray,
    modes: np.ndarray,
    deltas: np.ndarray,
    va: np.ndarray,
    ha: np.ndarray,
    H: int,
    W: int,
    dc_q: int,
    ac_q: int,
    bit_depth: int = 10,
    n: int = 16,
    tile_grid: tuple = (1, 1),
    device=None,
) -> np.ndarray:
    """Whole-FRAME wavefront: levels/modes/deltas/va/ha carry a leading
    plane axis (P, nby, nbx[, n, n]); tiles of the (tr, tc) grid are
    prediction-independent streams whose wavefronts run concurrently.
    Returns the (P, H, W) int32 recon, bit-exact with the host walk of
    each plane and tile. device=None runs on the card (raises without
    one); "cpu" runs on the host."""
    dev = resolve_device(device)
    tabs = _frame_inputs(levels, modes, deltas, va, ha, H, W, n, tile_grid)
    out = _walk(dev, levels.shape[0], H, W, n, bit_depth, int(dc_q),
                int(ac_q), tabs)
    return out.cpu().numpy()


def recon_wavefront_scan(
    levels: np.ndarray,
    modes: np.ndarray,
    deltas: np.ndarray,
    va: np.ndarray,
    ha: np.ndarray,
    H: int,
    W: int,
    dc_q: int,
    ac_q: int,
    bit_depth: int = 10,
    n: int = 16,
    device=None,
) -> np.ndarray:
    """Device wavefront reconstruction of one plane under a uniform
    n x n NONE partition (single tile): levels (nby, nbx, n, n) int32,
    modes/deltas/va/ha (nby, nbx). Returns the (H, W) int32 recon,
    bit-exact with the host sequential walk. device=None runs on the card
    (raises without one); "cpu" runs on the host."""
    planes = [a[None] for a in (levels, modes, deltas, va, ha)]
    return recon_wavefront_scan_frame(*planes, H, W, dc_q, ac_q, bit_depth,
                                      n, (1, 1), device)[0]


def recon_wavefront_uniform(
    levels: np.ndarray,
    modes: np.ndarray,
    deltas: np.ndarray,
    va: np.ndarray,
    ha: np.ndarray,
    H: int,
    W: int,
    dc_q: int,
    ac_q: int,
    bit_depth: int = 10,
    n: int = 16,
    device=None,
) -> np.ndarray:
    """The reference's unrolled single-plane executor: the same inputs,
    output and walk as recon_wavefront_scan."""
    return recon_wavefront_scan(levels, modes, deltas, va, ha, H, W, dc_q,
                                ac_q, bit_depth, n, device)
