"""Bit-exact batched intra predictors on torch tensors.

Pass 2's prediction must match the decoder integer-for-integer (the coded
residual is src minus the DECODER's prediction). This module evaluates all
13 intra modes (+ angle deltas) for a batch of same-shaped blocks from
explicit neighbor vectors, exactly:

- the non-directional family (DC/V/H/SMOOTH/SMOOTH_V/SMOOTH_H/PAETH) as
  elementwise int32 ops (shifts and integer divides, spec formulas);
- the directional family as ONE constant-matrix product against the
  [al, above_ext, left_ext] vector — every output is a 2-tap integer
  interpolation (weights <= 32, neighbors < 2^10), followed by the spec
  (x + 16) >> 5. The product runs in float64, which is exact whatever
  the global TF32 settings (CUDA has no int32 matmul);
- per-block mode selection by gather over the candidate axis.

Semantics mirror av1/predict.py predict()/predict_directional() WITHOUT
the intra edge filter (the build's default; the host pass 2 takes the
same branch). The tests pin bit-exactness against the scalar host
predictors and against the JAX package's device_predict.

Reference: cavif_tpu/ops/device_predict.py (jitted XLA there; no TPU
kernel). Constant tables are built once per (shape, device).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..av1 import tables
from .device_pass1 import _dir_cands, _dir_matrix, resolve_device

# candidate order: the 5 non-directional modes computed elementwise, then
# the full directional fan (V/H/diagonals x deltas) from the matrix
NONDIR5 = (0, 9, 10, 11, 12)  # DC, SMOOTH, SMOOTH_V, SMOOTH_H, PAETH

I32 = torch.int32


@lru_cache(maxsize=None)
def _cand_index(use_deltas: bool):
    """(mode, delta) -> candidate index in the stacked prediction tensor."""
    idx = {}
    for i, m in enumerate(NONDIR5):
        idx[(m, 0)] = i
    for j, (m, d) in enumerate(_dir_cands(use_deltas)):
        idx[(m, d)] = len(NONDIR5) + j
    return idx


@lru_cache(maxsize=None)
def _tap_table(bw: int, bh: int, use_deltas: bool) -> np.ndarray:
    """Packed (C, 4*n2) int32 tap table [b0 | b1 | w0 | w1]: every
    directional output pixel of candidate c is the <= 2-tap integer
    interpolation (w0*ext[b0] + w1*ext[b1] + 16) >> 5 of the ext vector,
    extracted from the constant matrix (_dir_matrix)."""
    dirs = _dir_cands(use_deltas)
    mdir = _dir_matrix(dirs, bw, bh)  # (E, C_dir*bh*bw)
    E = mdir.shape[0]
    n2 = bh * bw
    C = len(dirs)
    m3i = mdir.reshape(E, C, n2).transpose(1, 0, 2)  # (C, E, n2)
    tb = np.zeros((2, C, n2), np.int32)
    tw = np.zeros((2, C, n2), np.int32)
    for c in range(C):
        col = m3i[c]  # (E, n2)
        for p in range(n2):
            nz = np.nonzero(col[:, p])[0]
            if len(nz) > 2:
                raise ValueError(f"candidate {c} pixel {p}: {len(nz)} taps")
            for t, e in enumerate(nz):
                tb[t, c, p] = e
                tw[t, c, p] = int(col[e, p])
    return np.concatenate([tb[0], tb[1], tw[0], tw[1]], axis=1)


def _nondir(bw: int, bh: int, bit_depth: int, sm_h, sm_w):
    """The five non-directional predictions, stacked (B, 5, bh, bw), from
    spec-extended neighbors; sm_h (1, bh, 1) and sm_w (1, 1, bw) are the
    SMOOTH weights on the device."""
    base = 1 << (bit_depth - 1)
    L = bw + bh

    def run(above_ext, left_ext, al, have_a, have_l):
        B = above_ext.shape[0]
        ha = have_a[:, None]
        hl = have_l[:, None]
        above = above_ext[:, :bw]
        left = left_ext[:, :bh]
        a0 = above[:, 0:1]
        l0 = left[:, 0:1]
        above_s = torch.where(ha, above, torch.where(hl, l0, base - 1))
        left_s = torch.where(hl, left, torch.where(ha, a0, base + 1))
        al_s = torch.where(
            have_a & have_l, al,
            torch.where(have_a, above[:, 0],
                        torch.where(have_l, left[:, 0], base)),
        )
        sum_a = above.sum(dim=1, dtype=I32)
        sum_l = left.sum(dim=1, dtype=I32)
        avg_both = (sum_a + sum_l + (L >> 1)) // L
        avg_a = (sum_a + (bw >> 1)) >> (bw.bit_length() - 1)
        avg_l = (sum_l + (bh >> 1)) >> (bh.bit_length() - 1)
        dcv = torch.where(
            have_a & have_l, avg_both,
            torch.where(have_a, avg_a, torch.where(have_l, avg_l, base)),
        )
        shape = (B, bh, bw)
        a2 = above_s[:, None, :]
        l2 = left_s[:, :, None]
        dc = dcv[:, None, None].expand(shape)
        below = left_s[:, bh - 1][:, None, None]
        right = above_s[:, bw - 1][:, None, None]
        t = (sm_h * a2 + (256 - sm_h) * below + sm_w * l2
             + (256 - sm_w) * right)
        smooth = (t + 256) >> 9
        smooth_v = (sm_h * a2 + (256 - sm_h) * below + 128) >> 8
        smooth_h = (sm_w * l2 + (256 - sm_w) * right + 128) >> 8
        alb = al_s[:, None, None]
        b = l2 + a2 - alb
        pl_ = (b - l2).abs()
        pt = (b - a2).abs()
        ptl = (b - alb).abs()
        paeth = torch.where(
            (pl_ <= pt) & (pl_ <= ptl), l2,
            torch.where(pt <= ptl, a2, alb),
        )
        return torch.stack(
            [dc, smooth.expand(shape), smooth_v.expand(shape),
             smooth_h.expand(shape), paeth.expand(shape)], dim=1
        )  # (B, 5, bh, bw)

    return run


def _smooth_weights(bw: int, bh: int, device):
    sm_h = torch.as_tensor(
        np.asarray(tables.get(f"sm_weights_{bh}"), np.int32), device=device)
    sm_w = torch.as_tensor(
        np.asarray(tables.get(f"sm_weights_{bw}"), np.int32), device=device)
    return sm_h[None, :, None], sm_w[None, None, :]


@lru_cache(maxsize=None)
def pred_body(bw: int, bh: int, bit_depth: int, use_deltas: bool,
              device: str):
    """Batched predictor over the full candidate fan, constants on
    `device`: run(above_ext, left_ext, al, have_a, have_l, cand) with
    above_ext/left_ext (B, L) int32 spec-extended neighbors, al (B,)
    int32, have_a/have_l (B,) bool, cand (B,) int64 candidate index (see
    _cand_index). Returns (B, bh, bw) int32."""
    dirs = _dir_cands(use_deltas)
    mdir = torch.as_tensor(
        _dir_matrix(dirs, bw, bh).astype(np.float64), device=device)
    nondir = _nondir(bw, bh, bit_depth, *_smooth_weights(bw, bh, device))

    def run(above_ext, left_ext, al, have_a, have_l, cand):
        B = above_ext.shape[0]
        nond = nondir(above_ext, left_ext, al, have_a, have_l)
        # directional fan: exact float64 product (2-tap integer
        # interpolations); the matrix's availability fallbacks are baked
        # into ext already (callers pass spec-resolved neighbors)
        ext = torch.cat([al[:, None], above_ext, left_ext], dim=1)
        d = ext.to(torch.float64) @ mdir
        d = ((d.to(I32) + 16) >> 5).reshape(B, len(dirs), bh, bw)
        preds = torch.cat([nond, d], dim=1)
        idx = cand[:, None, None, None].expand(B, 1, bh, bw)
        return preds.gather(1, idx)[:, 0]

    return run


@lru_cache(maxsize=None)
def pred_body_select(bw: int, bh: int, bit_depth: int, use_deltas: bool,
                     device: str):
    """Selected-candidate twin of pred_body (same arguments and output):
    the directional part computes ONLY each lane's chosen prediction from
    the packed tap table (_tap_table), two small gathers instead of the
    whole fan's product. Bit-exact with pred_body (identical integer ops
    on the selected lane); built for the pass-2 wavefront."""
    tpack = _tap_table(bw, bh, use_deltas)
    n2 = bh * bw
    # the tap indices as int64 (gather's index type), the weights as int32
    taps = torch.as_tensor(tpack[:, : 2 * n2].astype(np.int64),
                           device=device)
    wts = torch.as_tensor(np.ascontiguousarray(tpack[:, 2 * n2 :]),
                          device=device)
    nondir = _nondir(bw, bh, bit_depth, *_smooth_weights(bw, bh, device))
    ND = len(NONDIR5)

    def run(above_ext, left_ext, al, have_a, have_l, cand):
        B = above_ext.shape[0]
        nond = nondir(above_ext, left_ext, al, have_a, have_l)
        idx = cand.clamp(0, ND - 1)[:, None, None, None].expand(B, 1, bh, bw)
        nond_sel = nond.gather(1, idx)[:, 0]
        ext = torch.cat([al[:, None], above_ext, left_ext], dim=1)
        cd = (cand - ND).clamp_min(0)
        v01 = ext.gather(1, taps.index_select(0, cd))  # (B, 2*n2)
        w01 = wts.index_select(0, cd)
        d = ((w01[:, :n2] * v01[:, :n2] + w01[:, n2:] * v01[:, n2:] + 16)
             >> 5).reshape(B, bh, bw)
        return torch.where((cand >= ND)[:, None, None], d, nond_sel)

    return run


def predict_batch_exact(
    modes: np.ndarray,
    deltas: np.ndarray,
    above_ext: np.ndarray,
    left_ext: np.ndarray,
    al: np.ndarray,
    have_a: np.ndarray,
    have_l: np.ndarray,
    bw: int,
    bh: int,
    bit_depth: int,
    device=None,
) -> np.ndarray:
    """Batched bit-exact intra prediction. Neighbors follow the host
    search's spec-resolution: above_ext/left_ext length bw+bh with the
    availability fallbacks already applied (base+-1 synthesis when a
    side is missing). Returns (B, bh, bw) int32 predictions. device=None
    runs on the card (raises without one); "cpu" runs on the host."""
    dev = resolve_device(device)
    use_deltas = bool(np.any(np.asarray(deltas) != 0))
    idx = _cand_index(use_deltas)
    cand = np.asarray(
        [idx[(int(m), int(d))] for m, d in zip(modes, deltas)], np.int64
    )
    f = pred_body(bw, bh, bit_depth, use_deltas, dev)

    def up(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

    out = f(up(above_ext, np.int32), up(left_ext, np.int32),
            up(al, np.int32), up(have_a, bool), up(have_l, bool),
            up(cand, np.int64))
    return out.cpu().numpy()
