"""Whole-frame device pass 1 in PyTorch: the encoder's partition + intra-mode
search over one frame (run_pass1) or a batch of same-shaped frames
(run_pass1_batch), run on the card (or, for tests, on the CPU).

The frame goes up once as uint8 (color conversion runs on the device);
every search the host cascade performs (square tiers 4..32 px, plus 64 at
speeds 0-1, both rectangular halves of every square, the full angle-delta
fan of all eight directional modes, joint U+V chroma) runs brute-force;
the bottom-up NONE/SPLIT/HORZ/VERT partition DP folds the costs on the
device, and the decisions come back as one packed int8 buffer.

Per block shape, `ShapeCost` prices every intra candidate. Where
max(bw, bh) <= 32 it calls the two hand-written kernels of
ops/pass1_kernels.py (nondirectional and directional families, both fused
through quantization and the per-candidate sum); the TX_64 family keeps
the materialized residual path in plain torch, as the reference did.

Reference: cavif_tpu/ops/device_pass1.py (`_program`, `_program_batch`,
`_cost_body`, `_nbrs`, `_convert`, `run_pass1_batch`, `PASS1_HOOKS`):
same candidate order, cost model, partition DP and packed layout, so the
encoder's unpacking (`_DevModes`, `_dev_part_dict`) reads this output
unchanged. Search policy: rav1e's intra partition/mode RDO as configured
by cavif (ravif src/av1encoder.rs:649-708).

Numerics. `matmul="bf16"` rounds both inputs of every default-precision
product of the shapes up to 32 px to bfloat16 (round to nearest even) and
accumulates in f32, as the TPU did; `matmul="f32"` keeps f32 inputs, as the
reference computes on the CPU. The card runs bf16; the CPU tests compare
f32 with the reference. The TX_64 family's products are f32 in both modes:
in bf16 its tail term (residual energy minus coded-area energy) drowns in
rounding, and the 64 px tier then wins blocks it should not (the TPU's
default precision did the same).
"""

from __future__ import annotations

import contextvars
import os
import threading
from functools import lru_cache

import numpy as np
import torch

from ..av1.transforms import AC_BIAS, dct2_matrix, get_gain
from ..parallel import mesh as shard
from . import colorspace
from .pass1_kernels import (_mm, dir_cost, nd_cost, nd_preds, pack_kt,
                            pack_mk)

# candidate order: 5 non-directional (elementwise predictors), then the
# directional family (one MXU matmul): V, H, 6 diagonals at delta 0, then
# every (mode, delta != 0) pair when use_deltas
NONDIR5 = (0, 9, 10, 11, 12)  # DC, SMOOTH, SMOOTH_V, SMOOTH_H, PAETH
DIR_MODES = (1, 2, 3, 4, 5, 6, 7, 8)  # V, H, D45, D135, D113, D157, D203, D67
DELTAS = (-3, -2, -1, 1, 2, 3)

SQ_TIERS = (4, 8, 16, 32)  # px; the 64 tier joins when max_px >= 64
SB = 64  # superblock px: a mesh's band and halo unit
RECT_SHAPES = ((8, 4), (4, 8), (16, 8), (8, 16), (32, 16), (16, 32))

MATMUL_MODES = ("f32", "bf16")


def _dir_cands(use_deltas: bool):
    c = [(m, 0) for m in DIR_MODES]
    if use_deltas:
        c += [(m, d) for m in DIR_MODES for d in DELTAS]
    return tuple(c)


def _cand_tables(use_deltas: bool, lam_unit_diag=7.0, lam_unit_delta=6.0):
    """Static per-candidate (mode_id, delta, rate-penalty-in-lambda-units)
    arrays in the concatenated cost order. Penalties mirror the host
    search: +7*lam for the diagonal modes (angle+mode rate proxy,
    encoder.py _batch_search) and +6*lam for a nonzero delta (the host
    refine's acceptance margin, encoder.py _refine_deltas)."""
    dirs = _dir_cands(use_deltas)
    modes = list(NONDIR5) + [m for (m, _) in dirs]
    deltas = [0] * len(NONDIR5) + [d for (_, d) in dirs]
    pen = [0.0] * len(NONDIR5)
    for m, d in dirs:
        p = 0.0
        if m >= 3:  # diagonal family
            p += lam_unit_diag
        if d != 0:
            p += lam_unit_delta
        pen.append(p)
    return (
        np.asarray(modes, np.int8),
        np.asarray(deltas, np.int8),
        np.asarray(pen, np.float32),
    )


@lru_cache(maxsize=None)
def _dir_matrix(cands, bw: int, bh: int) -> np.ndarray:
    """Constant matrix mapping the per-block extended-neighbor vector
    ext = [al, above_ext(bw+bh), left_ext(bw+bh)] (length E = 2(bw+bh)+1)
    to all directional predictors at once:
    preds_flat = floor((ext @ M + 16) / 32), exact in f32 (integer weights
    <= 32, neighbors < 2^10). Pure V/H enter with weight 32.
    Generalizes ops/pallas_search._dir_matrix to rect shapes and deltas."""
    from ..av1.predict import _dir_grids

    L = bw + bh
    E = 2 * L + 1
    out = np.zeros((E, len(cands) * bh * bw), dtype=np.float64)

    def pa(k):  # above_ext[k]
        return 1 + k

    def plft(k):  # left_ext[k]
        return 1 + L + k

    for ci, (mode, delta) in enumerate(cands):
        M = out[:, ci * bh * bw : (ci + 1) * bh * bw].reshape(E, bh, bw)
        kind, a1, a2, a3, a4, mask = _dir_grids(mode, bw, bh, delta)
        if kind == "vh":
            if a1 == 90:  # V: pred[i, j] = above_ext[j]
                for j in range(bw):
                    M[pa(j), :, j] += 32
            else:  # H: pred[i, j] = left_ext[i]
                for i in range(bh):
                    M[plft(i), i, :] += 32
        elif kind == "above":
            b, w0, b1, w1 = a1, a2, a3, a4
            for i in range(bh):
                for j in range(bw):
                    if mask[i, j]:
                        M[pa(b[i, j]), i, j] += w0[i, j]
                        M[pa(b1[i, j]), i, j] += w1[i, j]
                    else:
                        M[pa(L - 1), i, j] += 32
        elif kind == "left":
            b, w0, b1, w1 = a1, a2, a3, a4
            for i in range(bh):
                for j in range(bw):
                    if mask[i, j]:
                        M[plft(b[i, j]), i, j] += w0[i, j]
                        M[plft(b1[i, j]), i, j] += w1[i, j]
                    else:
                        M[plft(L - 1), i, j] += 32
        else:  # zone2: ab = [al] + above_ext, lc = [al] + left_ext
            (b1g, wa0, wa1), (b2g, wl0, wl1) = a1, a2

            def p_ab(k):
                return k  # k == 0 is al; k >= 1 is above_ext[k-1] at index k

            def p_lc(k):
                return 0 if k == 0 else 1 + L + (k - 1)

            for i in range(bh):
                for j in range(bw):
                    if mask[i, j]:
                        M[p_ab(b1g[i, j]), i, j] += wa0[i, j]
                        M[p_ab(b1g[i, j] + 1), i, j] += wa1[i, j]
                    else:
                        M[p_lc(b2g[i, j]), i, j] += wl0[i, j]
                        M[p_lc(b2g[i, j] + 1), i, j] += wl1[i, j]
    return np.ascontiguousarray(out.astype(np.float32))


@lru_cache(maxsize=None)
def shape_consts(bw: int, bh: int, use_deltas: bool) -> dict:
    """The constant tables of one block shape, as numpy arrays (the
    system's "weights"; cavif_tpu's _cost_body builds the same values):

    mdir (E, cdir*n2) f32   directional predictor matrix (_dir_matrix)
    kt   (n2, ncoded) f32   Kronecker DCT, coded columns only
    mk   (E, cdir*n2) f32   mdir folded into kt (only when ncoded == n2)
    cc   (n2,) f32          0.5 * colsum(kt), the dropped predictor floor
    whv, wwv (n2,) f32      SMOOTH weights per pixel (row-major y*bw + x)
    pen  (C,) f32           candidate rate penalties in lambda units
    gain, ac_bias () f32    forward-transform gain and AC deadzone bias
    """
    from ..av1 import tables

    dirs = _dir_cands(use_deltas)
    mdir = _dir_matrix(dirs, bw, bh)
    _, _, pen = _cand_tables(use_deltas)
    n2 = bh * bw
    dh = dct2_matrix(bh, np.float64)
    dw = dct2_matrix(bw, np.float64)
    # TX_64-family blocks code only the top-left 32x32 coefficient area;
    # the Kronecker transform keeps the coded columns (index 0 stays DC)
    cw_c, ch_c = min(bw, 32), min(bh, 32)
    ncoded = cw_c * ch_c
    coded_idx = np.asarray(
        [r * bw + c for r in range(ch_c) for c in range(cw_c)], np.int64
    )
    kron_f64 = np.kron(dh, dw).T[:, coded_idx]  # (n2, ncoded)
    sm_h = np.asarray(tables.get(f"sm_weights_{bh}"), np.int32)
    sm_w = np.asarray(tables.get(f"sm_weights_{bw}"), np.int32)
    out = dict(
        mdir=mdir,
        kt=np.ascontiguousarray(kron_f64.astype(np.float32)),
        whv=np.asarray([float(sm_h[y]) for y in range(bh) for _ in range(bw)],
                       np.float32),
        wwv=np.asarray([float(sm_w[x]) for _ in range(bh) for x in range(bw)],
                       np.float32),
        pen=pen,
        gain=np.asarray(get_gain(cw_c, ch_c), np.float32),
        ac_bias=np.asarray(AC_BIAS, np.float32),
    )
    if ncoded == n2:
        # coefficient-domain directional path: prediction and DCT fold into
        # MK_c = M_c @ KT, so coef_c = blocks@KT - (ext @ MK_c)/32 - cc
        # (the predictor floor dropped: a < 1 px perturbation; pass 2
        # recomputes the chosen predictor exactly on the host)
        E, cdir = mdir.shape[0], len(dirs)
        m3 = mdir.astype(np.float64).reshape(E, cdir, n2)
        mk3 = np.einsum("ecj,jk->eck", m3, kron_f64)
        out["mk"] = np.ascontiguousarray(
            mk3.reshape(E, cdir * ncoded).astype(np.float32))
        out["cc"] = (0.5 * kron_f64.sum(axis=0)).astype(np.float32)
    return out


def _nbrs(planes, bw: int, bh: int, bit_depth: int, tile_px, row0: int = 0):
    """Per-block neighbor tensors over the whole (P, H, W) int32 plane stack
    for the aligned (bh, bw) block grid, with spec availability fallbacks
    AND tile-boundary masking (tiles are prediction-independent; a block
    whose above/left row belongs to another tile treats it as unavailable,
    which is exactly the pass-2 walk's availability). `row0` is the global
    row of planes' first row: a mesh rank passes its halo'd band
    (parallel/mesh.py), so the tile-boundary test stays global.

    Returns dict with above_s/left_s (resolved (P, nby, nbx, n)), al_s, dc,
    ext (P, nby, nbx, E) f32 — the [al, above_ext, left_ext] vector for the
    directional matmul."""
    P, H, W = planes.shape
    nby, nbx = H // bh, W // bw
    th, tw = tile_px
    base = 1 << (bit_depth - 1)
    L = bw + bh
    dev = planes.device

    rows = planes[:, bh - 1 :: bh, :]  # (P, nby, W): last row of each brow
    rows_sh = torch.cat(
        [torch.zeros_like(rows[:, :1]), rows[:, :-1]], 1
    )  # row above each block row
    above = rows_sh.reshape(P, nby, nbx, bw)
    cols = planes[:, :, bw - 1 :: bw]  # (P, H, nbx)
    cols_sh = torch.cat(
        [torch.zeros_like(cols[:, :, :1]), cols[:, :, :-1]], 2
    )
    left = cols_sh.reshape(P, nby, bh, nbx).permute(0, 1, 3, 2)
    corn = rows_sh[:, :, bw - 1 :: bw]  # (P, nby, nbx): px above-right-corner
    al = torch.cat([torch.zeros_like(corn[:, :, :1]), corn[:, :, :-1]], 2)

    by = torch.arange(nby, device=dev)
    bx = torch.arange(nbx, device=dev)
    have_a = (((row0 + by * bh) % th) != 0)[None, :, None].expand(
        P, nby, nbx)
    have_l = (((bx * bw) % tw) != 0)[None, None, :].expand(P, nby, nbx)
    ha = have_a[..., None]
    hl = have_l[..., None]
    a0 = above[..., 0:1]
    l0 = left[..., 0:1]
    above_s = torch.where(ha, above, torch.where(hl, l0, base - 1))
    left_s = torch.where(hl, left, torch.where(ha, a0, base + 1))
    al_s = torch.where(
        have_a & have_l,
        al,
        torch.where(
            have_a, above[..., 0],
            torch.where(have_l, left[..., 0], base)),
    )
    # DC per availability (host predict_all_batch semantics, incl. rect)
    sum_a = above.sum(-1)
    sum_l = left.sum(-1)
    avg_both = (sum_a + sum_l + (L >> 1)) // L
    avg_a = (sum_a + (bw >> 1)) >> (bw.bit_length() - 1)
    avg_l = (sum_l + (bh >> 1)) >> (bh.bit_length() - 1)
    dc = torch.where(
        have_a & have_l,
        avg_both,
        torch.where(have_a, avg_a, torch.where(have_l, avg_l, base)),
    )

    # extended neighbors (length L each side): real pixels along the row
    # above / column left, clamped at the plane edge (host pass-1 reads the
    # same padded source rows, replicating past the end)
    ar = torch.arange(L, device=dev)
    xi = torch.clamp(bx[:, None] * bw + ar[None, :], max=W - 1)
    above_ext = rows_sh[:, :, xi]  # (P, nby, nbx, L)
    yi = torch.clamp(by[:, None] * bh + ar[None, :], max=H - 1)
    left_ext = cols_sh[:, yi, :].permute(0, 1, 3, 2)  # (P, nby, nbx, L)

    both_missing = ~have_a & ~have_l
    only_a = have_a & ~have_l
    only_l = ~have_a & have_l
    above_ext = torch.where(
        both_missing[..., None],
        base - 1,
        torch.where(only_l[..., None], left_ext[..., 0:1], above_ext),
    )
    left_ext = torch.where(
        both_missing[..., None],
        base + 1,
        torch.where(only_a[..., None], above_ext[..., 0:1], left_ext),
    )
    al_ext = torch.where(
        both_missing,
        base,
        torch.where(
            only_a,
            above_ext[..., 0],
            torch.where(only_l, left_ext[..., 0], al),
        ),
    )
    ext = torch.cat(
        [al_ext[..., None], above_ext, left_ext], -1
    ).to(torch.float32)
    return dict(
        above_s=above_s, left_s=left_s, al_s=al_s, dc=dc, ext=ext,
        nby=nby, nbx=nbx,
    )


def _lane_quant(ncoded: int, dc_q, ac_q, gain, ac_bias):
    """Per-lane (inv_scale, scale, bias) rows, f32, the DC lane (index 0)
    with its own quantizer and round-to-nearest bias, the AC lanes with the
    deadzone bias. Same f32 operations as the reference's
    (1 - m) * x + m * y forms, which are exact selections."""
    g = np.float32(gain)
    acf = np.float32(ac_q) * g
    dcf = np.float32(dc_q) * g
    q = np.empty((3, ncoded), np.float32)
    q[0] = np.float32(1.0) / acf
    q[1] = acf
    q[2] = np.float32(ac_bias)
    q[0, 0] = np.float32(1.0) / dcf
    q[1, 0] = dcf
    q[2, 0] = np.float32(0.5)
    return q


class ShapeCost(torch.nn.Module):
    """Whole-plane RD cost of one block shape: forward(planes, dc_q, ac_q,
    lam, tile_px, row0=0) -> (P, nby, nbx, C) f32 costs in the candidate
    order of _cand_tables(use_deltas), planes' first row being global row
    row0. Port of cavif_tpu's `_cost_body`.

    Shapes with max(bw, bh) <= 32 run the two kernels (nondirectional
    family, then the directional family in the coefficient domain), with
    their bf16 constants also laid out as the kernels' tiles (`kt_tiles`,
    `mk_tiles`; None in f32 mode); the
    TX_64 family prices materialized residuals (its tail distortion term
    needs the full-area residual energy) in plain torch."""

    def __init__(self, bw: int, bh: int, depth: int, use_deltas: bool,
                 matmul: str = "f32", consts: dict | None = None):
        super().__init__()
        if matmul not in MATMUL_MODES:
            raise ValueError(f"matmul must be one of {MATMUL_MODES}")
        c = shape_consts(bw, bh, use_deltas) if consts is None else consts
        self.bw, self.bh, self.depth = bw, bh, depth
        self.n2 = bw * bh
        self.ncoded = c["kt"].shape[1]
        self.cdir = len(_dir_cands(use_deltas))
        self.E = 2 * (bw + bh) + 1
        self.fused = "mk" in c
        self.gain = float(c["gain"])
        self.ac_bias = float(c["ac_bias"])
        # the TX_64 family's products stay f32 (module docstring)
        mm = (torch.bfloat16 if matmul == "bf16" and self.fused
              else torch.float32)

        def buf(name, arr, dtype=torch.float32):
            self.register_buffer(
                name, torch.from_numpy(np.ascontiguousarray(arr)).to(dtype))

        buf("kt", c["kt"], mm)
        buf("pen", c["pen"])
        buf("whv", c["whv"])
        buf("wwv", c["wwv"])
        if self.fused:
            buf("mk", c["mk"], mm)
            buf("cc", c["cc"])
        else:
            buf("mdir", c["mdir"], mm)
        # the kernels' bf16 constants, laid out once in the order of their
        # ring stages (ops/pass1_kernels.pack_kt, pack_mk)
        tiles = self.fused and mm == torch.bfloat16
        self.register_buffer("kt_tiles", pack_kt(self.kt) if tiles else None)
        self.register_buffer(
            "mk_tiles", pack_mk(self.mk, self.n2) if tiles else None)

    @classmethod
    def from_numpy(cls, consts: dict, *, bw: int, bh: int, depth: int,
                   use_deltas: bool, matmul: str = "f32") -> "ShapeCost":
        """Build from a dict of constant tables (the keys of
        shape_consts), e.g. one made by the reference package."""
        return cls(bw, bh, depth, use_deltas, matmul, consts=consts)

    def kernel_inputs(self, planes, dc_q, ac_q, lam, tile_px, row0: int = 0):
        """Neighbors and the two kernels' keyword arguments for one frame
        whose first row is global row `row0`: (nbrs dict, nd_cost kwargs,
        dir_cost kwargs); the last is None for the TX_64 family, which has
        no directional kernel."""
        P = planes.shape[0]
        bw, bh, n2 = self.bw, self.bh, self.n2
        nb = _nbrs(planes, bw, bh, self.depth, tile_px, row0)
        R = P * nb["nby"] * nb["nbx"]
        blocks = (
            planes.reshape(P, nb["nby"], bh, nb["nbx"], bw)
            .permute(0, 1, 3, 2, 4)
            .reshape(R, n2)
            .to(torch.float32)
            .contiguous()
        )
        q = torch.from_numpy(
            _lane_quant(self.ncoded, dc_q, ac_q, self.gain, self.ac_bias)
        ).to(planes.device)
        quant = dict(inv=q[0], scale=q[1], bias=q[2], lam=lam)
        sc = torch.stack([nb["al_s"].reshape(R), nb["dc"].reshape(R)], -1)
        nd = dict(
            above=nb["above_s"].reshape(R, bw).to(torch.float32).contiguous(),
            left=nb["left_s"].reshape(R, bh).to(torch.float32).contiguous(),
            sc=sc.to(torch.float32).contiguous(),
            blocks=blocks, kt=self.kt, whv=self.whv, wwv=self.wwv, **quant,
        )
        dr = None
        if self.fused:
            # candidate-independent block coefficients (default-precision
            # dot)
            dr = dict(
                ext=nb["ext"].reshape(R, self.E).contiguous(),
                bkt=_mm(blocks, self.kt).contiguous(),
                mk=self.mk, cc=self.cc, **quant,
            )
        return nb, nd, dr

    def forward(self, planes, dc_q, ac_q, lam: float, tile_px, row0: int = 0):
        P = planes.shape[0]
        nb, nd, dr = self.kernel_inputs(planes, dc_q, ac_q, lam, tile_px,
                                        row0)
        if self.fused:
            costs = [nd_cost(**nd, kt_tiles=self.kt_tiles),
                     dir_cost(**dr, mk_tiles=self.mk_tiles)]
        else:
            costs = self._materialized(nb["ext"], nd)
        cost = torch.cat(costs, -1).reshape(P, nb["nby"], nb["nbx"], -1)
        return cost + lam * self.pen

    def _materialized(self, ext, nd):
        """TX_64 family: the reference's materialized residual path
        (predictors -> residual -> coded-area DCT -> quantizer chain plus
        the discarded-area tail), candidates in ~1 GB chunks."""
        blocks, n2 = nd["blocks"], self.n2
        R = blocks.shape[0]
        inv, scale, bias, lam = nd["inv"], nd["scale"], nd["bias"], nd["lam"]

        def rd(preds):  # (R, CH, n2) -> (R, CH)
            res = blocks[:, None, :] - preds
            coef = _mm(res, self.kt)
            t = coef * inv
            lv = torch.sign(t) * torch.floor(t.abs() + bias)
            errc = coef - lv * scale
            rate = lv.abs().sum(-1) + 2.0 * (lv != 0.0).sum(-1)
            cost = (errc * errc).sum(-1) + lam * rate
            # coefficients beyond the 32x32 coded area are discarded by the
            # decoder: pure distortion (Parseval: residual energy minus the
            # coded-area energy)
            return cost + ((res * res).sum(-1) - (coef * coef).sum(-1))

        preds = nd_preds(nd["above"], nd["left"], nd["sc"][:, 0],
                         nd["sc"][:, 1], self.whv, self.wwv)
        costs = [rd(preds)]
        ext = ext.reshape(R, self.E)
        chunk = max(1, min(self.cdir, (1 << 30) // max(R * n2 * 4, 1)))
        for c0 in range(0, self.cdir, chunk):
            c1 = min(self.cdir, c0 + chunk)
            d = _mm(ext, self.mdir[:, c0 * n2 : c1 * n2])
            d = torch.floor((d + 16.0) * (1.0 / 32.0))
            costs.append(rd(d.reshape(R, c1 - c0, n2)))
        return costs


def _convert_batch(src, model: str, depth: int):
    """On-device plane derivation from a batch of compact uploads (B uint8
    images or B int16 plane stacks) — exactly the host conversion formulas
    (ops/colorspace.py; reference av1encoder.rs:483-524). src is
    (B, H, W, 3) for ycbcr/gbr, (B, H, W) for mono, (B, P, H, W) for
    planes. Returns (B * P, H, W) int32, image-major."""
    if model == "ycbcr":
        x = colorspace.rgb_to_ycbcr(src, depth=depth).permute(0, 3, 1, 2)
    elif model == "gbr":
        x = colorspace.rgb_to_gbr(src, depth=depth).permute(0, 3, 1, 2)
    elif model == "mono":
        x = src.to(torch.int32)
        if depth == 10:
            x = (x << 2) | (x >> 6)
    else:  # "planes"
        x = src.to(torch.int32)
    H, W = x.shape[-2:]
    return x.reshape(-1, H, W).contiguous()


def _convert(src, model: str, depth: int):
    """_convert_batch of one upload: (P, H, W) int32."""
    return _convert_batch(src[None], model, depth)


def _f32(v) -> float:
    """v rounded to f32, as an exact Python float."""
    return float(np.float32(v))


@lru_cache(maxsize=None)
def _shape_cost(bw, bh, depth, use_deltas, matmul, device) -> ShapeCost:
    return ShapeCost(bw, bh, depth, use_deltas, matmul).to(device)


def _sq_tiers(max_px: int) -> tuple:
    """The square tiers pass 1 prices: 4-32 px, and 64 when max_px
    reaches it."""
    return SQ_TIERS + ((64,) if max_px >= 64 else ())


def _shapes(max_px: int) -> list:
    """Every block shape pass 1 prices: the square tiers, then the
    rectangles."""
    return [(s, s) for s in _sq_tiers(max_px)] + list(RECT_SHAPES)


def _dp_tiers(min_px: int, max_px: int) -> list:
    """The square tiers of the partition DP."""
    return [s for s in _sq_tiers(max_px) if s >= min_px]


def _has_uv(P: int, bw: int, bh: int) -> bool:
    """Whether shape (bw, bh) prices chroma: chroma below 8 px inherits
    the 8 px square parent's uv choice."""
    return P > 1 and min(bw, bh) >= 8


def program_spec(H: int, W: int, P: int, min_px: int, max_px: int) -> list:
    """The packed row's layout of a Pass1Program over (H, W) frames:
    [((bw, bh), name, (nby, nbx)), ...] in the order of the packed row."""
    spec = []
    for (bw, bh) in _shapes(max_px):
        if (bw, bh) == (4, 4):
            # 4px modes are not fetched; the host re-searches the few
            # 4px leaves the DP actually picks
            continue
        for nm in ["y_md"] + (["uv_md"] if _has_uv(P, bw, bh) else []):
            spec.append(((bw, bh), nm, (H // bh, W // bw)))
    for s in _dp_tiers(min_px, max_px)[1:]:
        spec.append(((s, s), "code", (H // s, W // s)))
    return spec


class Pass1Program(torch.nn.Module):
    """The whole-frame pass-1 for one static config, over a batch of B
    same-shaped frames (port of the reference's `_program` and
    `_program_batch`: K1 and K2 see all B * P planes' rows at once).

    key = (H, W, depth, model, P, min_px, max_px, use_deltas,
           ovh_block, ovh_split, rect_ovh)
    forward(src, dc_q, ac_q, lam, th, tw, row0=0) with src a batch of B
    uploads (see _convert_batch) whose first row is global row row0 (a
    mesh rank's halo'd band; 0 for a whole frame) -> packed (B, total)
    int8 tensor, each row laid out by `self.spec` =
    program_spec(H, W, P, min_px, max_px)."""

    def __init__(self, key, matmul: str, device):
        super().__init__()
        (H, W, depth, model, P, min_px, max_px, use_deltas,
         ovh_block, ovh_split, rect_ovh) = key
        self.H, self.W, self.depth, self.model, self.P = H, W, depth, model, P
        self.ovh = (ovh_block, ovh_split, rect_ovh)
        self.dp_tiers = _dp_tiers(min_px, max_px)
        self.shapes = _shapes(max_px)
        self.costs = torch.nn.ModuleDict()
        self.flags = {}
        for (bw, bh) in self.shapes:
            # angle deltas are codeable only for blocks >= 8x8, and the 64
            # tier skips them (its leaves are overwhelmingly smooth)
            ud = bool(use_deltas) and min(bw, bh) >= 8 and max(bw, bh) < 64
            uv = _has_uv(P, bw, bh)
            self.costs[f"{bw}x{bh}"] = _shape_cost(
                bw, bh, depth, ud, matmul, device)
            mi, dv, _ = _cand_tables(ud)
            # mode and delta+3 nibble-packed into one int8 per block
            md = mi.astype(np.int32) | ((dv.astype(np.int32) + 3) << 4)
            self.register_buffer(
                f"md_{bw}x{bh}", torch.from_numpy(md).to(device))
            self.flags[(bw, bh)] = (ud, uv)
        self.spec = program_spec(H, W, P, min_px, max_px)

    def forward(self, src, dc_q, ac_q, lam: float, th: int, tw: int,
                row0: int = 0):
        B = src.shape[0]
        planes = _convert_batch(src, self.model, self.depth)
        P = self.P
        out8 = []
        totals = {}  # (bw, bh) -> (y_min [+ uv_min] cost grid, has_uv)
        uv_min8 = None
        for (bw, bh) in self.shapes:
            uv = self.flags[(bw, bh)][1]
            md = getattr(self, f"md_{bw}x{bh}")
            emit = (bw, bh) != (4, 4)
            costs = self.costs[f"{bw}x{bh}"](planes, dc_q, ac_q, lam,
                                             (th, tw), row0)
            costs = costs.view(B, P, *costs.shape[1:])
            y = costs[:, 0]
            if emit:
                out8.append(md[torch.argmin(y, -1)])
            tot = torch.amin(y, -1)
            if uv:
                uvc = costs[:, 1] + costs[:, 2]  # joint U+V (shared uv mode)
                if emit:
                    out8.append(md[torch.argmin(uvc, -1)])
                uvm = torch.amin(uvc, -1)
                tot = tot + uvm
                if (bw, bh) == (8, 8):
                    uv_min8 = uvm
            totals[(bw, bh)] = (tot, uv)

        # bottom-up partition DP (host _rdo_partition merge semantics:
        # candidate order NONE, SPLIT, HORZ, VERT; ties to the earlier, as
        # torch.argmin returns the first minimum). At the 8px merge the
        # sub-8px children/halves carry luma-only costs: the 8px parent's
        # own chroma cost rides the SPLIT/HORZ/VERT sides.
        ovh_block, ovh_split, rect_ovh = self.ovh
        lam32 = np.float32(lam)
        ovb = _f32(lam32 * np.float32(ovh_block))
        ovs = _f32(lam32 * np.float32(ovh_split))
        rovh = _f32(lam32 * np.float32(ovh_split + rect_ovh * ovh_block))
        d0 = self.dp_tiers[0]
        bc = totals[(d0, d0)][0] + ovb
        codes = []
        for s in self.dp_tiers[1:]:
            q = bc[:, 0::2, 0::2] + bc[:, 0::2, 1::2] + bc[:, 1::2, 0::2] \
                + bc[:, 1::2, 1::2]
            none_c = totals[(s, s)][0] + ovb
            split_c = ovs + q
            if s >= 64:
                # no rect candidates at 64 (TX_64X64 NONE vs SPLIT only);
                # its 32px children already carry chroma
                cand = torch.stack([none_c, split_c])
            else:
                h2 = s // 2
                htot = totals[(s, h2)][0]
                vtot = totals[(h2, s)][0]
                horz_c = rovh + htot[:, 0::2] + htot[:, 1::2]
                vert_c = rovh + vtot[:, :, 0::2] + vtot[:, :, 1::2]
                if P > 1 and not totals[(h2, h2)][1]:
                    split_c = split_c + uv_min8
                    horz_c = horz_c + uv_min8
                    vert_c = vert_c + uv_min8
                cand = torch.stack([none_c, split_c, horz_c, vert_c])
            codes.append(torch.argmin(cand, 0))
            bc = torch.amin(cand, 0)
        out8.extend(codes)
        return torch.cat([g.reshape(B, -1).to(torch.int8) for g in out8], 1)


_program_lock = threading.Lock()


@lru_cache(maxsize=None)
def _program_cached(key, matmul: str, device: str) -> Pass1Program:
    return Pass1Program(key, matmul, torch.device(device))


def _program(key, matmul: str, device: str) -> Pass1Program:
    with _program_lock:  # color and alpha streams may ask concurrently
        return _program_cached(key, matmul, device)


def resolve_device(device) -> str:
    """'cuda' (the card; raises when there is none) or 'cpu'."""
    dev = "cuda" if device is None else str(device)
    if dev.startswith("cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device pass 1 asked for the card ('cuda'), but "
                "torch.cuda.is_available() is false")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return dev
    if dev == "cpu":
        return dev
    raise ValueError(f"unknown pass-1 device {device!r}")


# Optional per-call hooks around the per-frame device round trip (upload,
# program, packed fetch). The hybrid batch scheduler (parallel/batch.py)
# installs an object whose start() acquires a device slot and done()
# releases it, so a slot bounds in-flight device calls only, not the
# encode's host phase. Scoped through a ContextVar, not a module global, so
# two concurrent encode_batch calls in one process each see only their own
# hooks, and pipeline._encode_streams copies the context into its colour
# and alpha threads so both of an RGBA encode's device calls stay under the
# installing call's bound. done() fires on success or failure.
PASS1_HOOKS: "contextvars.ContextVar" = contextvars.ContextVar(
    "cavif_tpu_torch_pass1_hooks", default=None
)


# The last single-frame program key and runtime arguments run_pass1 used,
# for diagnostics: the bench's roofline (tools/bench.py) times the exact
# program of the last encode with its own quantizers, lambda and tile split
# rather than a guessed configuration. Port of the reference's LAST_KEY /
# LAST_ARGS; the key is Pass1Program's, which has no trailing Pallas gate.
LAST_KEY = None
LAST_ARGS = None  # (dc_q, ac_q, lam, tile_px)


def _fused_shapes(key, batch: int) -> list:
    """[(bw, bh, R, cdir, E, n2)] of the shapes whose costs K1 and K2 price
    for a Pass1Program key over `batch` frames (max(bw, bh) <= 32; the 64
    tier keeps the materialized path)."""
    H, W, _, _, P, _, max_px, use_deltas = key[:8]
    out = []
    for (bw, bh) in _shapes(max_px):
        if max(bw, bh) > 32:
            continue
        ud = bool(use_deltas) and min(bw, bh) >= 8
        out.append((bw, bh, batch * P * (H // bh) * (W // bw),
                    len(_dir_cands(ud)), 2 * (bw + bh) + 1, bw * bh))
    return out


def kernel_flops(key, batch: int = 1) -> float:
    """Useful (logical, unpadded) flops of K1 and K2 for one Pass1Program
    key over `batch` frames. Port of the reference's `pallas_flops`, with
    the same count: per shape <= 32 px, the directional product and
    segment sum 2·R·E·C·n² + R·C·n² (K1), and five DCT products plus the
    two replication products 5·2·R·n²·n² + 2·R·(bw + bh)·n² (K2). The
    reference added it to XLA's cost analysis of the whole program; the
    port has no such analysis, so this covers the two kernels only."""
    return sum(2.0 * R * E * cdir * n2 + R * cdir * n2
               + 5 * 2.0 * R * n2 * n2 + 2.0 * R * (bw + bh) * n2
               for bw, bh, R, cdir, E, n2 in _fused_shapes(key, batch))


def kernel_bytes(key, batch: int = 1) -> float:
    """Bytes K1 and K2 read and write for one Pass1Program key over `batch`
    frames, each input read once and each output written once: K1 ext
    (R, E), bkt (R, n²) and its (R, C) costs in f32, MK in bf16 and the
    lane constants; K2 above, left, sc, blocks and its (R, 5) costs in
    f32, KT in bf16 and the lane constants."""
    return sum(4.0 * R * (E + n2 + cdir) + 2.0 * E * cdir * n2 + 16.0 * n2
               + 4.0 * R * (bw + bh + 2 + n2 + 5) + 2.0 * n2 * n2
               + 20.0 * n2
               for bw, bh, R, cdir, E, n2 in _fused_shapes(key, batch))


def _unpack(spec, packed: np.ndarray) -> dict:
    """{((bw, bh), name): int8 grid} of one frame's packed row."""
    out = {}
    off = 0
    for (shape, name, (nby, nbx)) in spec:
        n = nby * nbx
        out[(shape, name)] = packed[off : off + n].reshape(nby, nbx)
        off += n
    assert off == packed.size, (off, packed.size)
    return out


def run_pass1(
    src: np.ndarray,
    *,
    depth: int,
    model: str,
    num_planes: int,
    tile_px: tuple,
    min_px: int,
    max_px: int = 32,
    use_deltas: bool,
    dc_q: int,
    ac_q: int,
    lam: float,
    ovh_block: float = 15.0,
    ovh_split: float = 2.0,
    rect_ovh: float = 4.0,
    device: str = "cuda",
    matmul: str | None = None,
) -> dict:
    """Run the fused pass-1 for one frame. src: (H, W, 3) uint8 for
    ycbcr/gbr, (H, W) uint8 for mono, or (P, H, W) int16/int32 planes for
    model="planes"; H, W must be multiples of 64 (the encoder's padded
    dims). `device` is "cuda" (the card; the default) or "cpu"; `matmul`
    is "bf16" or "f32" (default: bf16 on the card, f32 on the CPU).
    Returns {((bw, bh), name): int8 grid} host arrays; grids for the DP
    codes exist for tiers above min_px ("code": 0 NONE, 1 SPLIT, 2 HORZ,
    3 VERT). The grid layout indexes [by, bx] of the aligned block grid over
    the padded plane."""
    device = resolve_device(device)
    if matmul is None:
        matmul = "f32" if device == "cpu" else "bf16"
    if model == "planes":
        P, H, W = src.shape
    else:
        H, W = src.shape[:2]
        P = num_planes
    key = (
        H, W, depth, model, P,
        int(min_px), int(max_px), bool(use_deltas),
        float(ovh_block), float(ovh_split), float(rect_ovh),
    )
    global LAST_KEY, LAST_ARGS
    LAST_KEY = key
    LAST_ARGS = (float(dc_q), float(ac_q), float(lam),
                 (int(tile_px[0]), int(tile_px[1])))
    prog = _program(key, matmul, device)
    hooks = PASS1_HOOKS.get()
    if hooks is not None:
        hooks.start()
    try:
        with torch.inference_mode():
            x = torch.from_numpy(np.ascontiguousarray(src)).to(device)
            packed = prog(
                x[None], _f32(dc_q), _f32(ac_q), _f32(lam),
                int(tile_px[0]), int(tile_px[1]),
            )[0].cpu().numpy()
    finally:
        if hooks is not None:
            hooks.done()
    return _unpack(prog.spec, packed)


def run_pass1_batch(
    srcs: np.ndarray,
    *,
    depth: int,
    tile_px: tuple,
    min_px: int,
    max_px: int = 32,
    use_deltas: bool,
    dc_q: int,
    ac_q: int,
    lam: float,
    ovh_block: float = 23.0,
    ovh_split: float = 2.0,
    rect_ovh: float = 4.0,
    model: str = "ycbcr",
    mesh=None,
    device: str = "cuda",
) -> list:
    """Whole-batch device pass 1 over same-shaped images. srcs:
    (B, H, W, 3) uint8 RGB (model "ycbcr") or (B, H, W) uint8 alpha planes
    (model "mono"), H and W multiples of 64 (padded). One Pass1Program
    call per sub-batch, so each kernel launches once per block shape for
    the whole sub-batch. Returns a list of B per-image grid dicts in
    run_pass1's format. `device` as in run_pass1 (bf16 matmul inputs on
    the card, f32 on the CPU).

    With a mesh (a DeviceMesh over "data" and/or "tile",
    parallel/mesh.py), every rank passes the whole batch; the sub-batch
    size is rounded to the data axis, and each rank runs the program, K1
    and K2 included, on its images over its band of 64 px superblock rows
    with one superblock row of halo, crops the grids to the band and
    gathers: every rank returns all B grid dicts. H must be divisible by
    the tile axis (ValueError), as the reference's sharding requires."""
    if model not in ("ycbcr", "mono"):
        raise ValueError(f"run_pass1_batch: model {model!r}")
    device = resolve_device(device)
    ax = None if mesh is None else shard.axes(mesh)
    kw = dict(depth=depth, tile_px=tile_px, min_px=min_px, max_px=max_px,
              use_deltas=use_deltas, dc_q=dc_q, ac_q=ac_q, lam=lam,
              ovh_block=ovh_block, ovh_split=ovh_split, rect_ovh=rect_ovh,
              model=model, mesh=mesh, device=device)
    B, H, W = srcs.shape[:3]
    # the reference's pixel budget per program call: larger batches run
    # as sub-batches of at most max_b images (a multiple of the data axis)
    budget = int(os.environ.get("CAVIF_TPU_BATCH_PX", 4_200_000))
    max_b = max(1, budget // (H * W))
    if ax is not None:
        max_b = max(ax.data, max_b // ax.data * ax.data)
    if B > max_b:
        out = []
        for i in range(0, B, max_b):
            out.extend(run_pass1_batch(srcs[i : i + max_b], **kw))
        return out
    P = 1 if model == "mono" else 3
    mm = "f32" if device == "cpu" else "bf16"
    args = (_f32(dc_q), _f32(ac_q), _f32(lam), int(tile_px[0]),
            int(tile_px[1]))
    key = (
        H, W, depth, model, P,
        int(min_px), int(max_px), bool(use_deltas),
        float(ovh_block), float(ovh_split), float(rect_ovh),
    )
    if ax is None:
        prog = _program(key, mm, device)
        with torch.inference_mode():
            x = torch.from_numpy(np.ascontiguousarray(srcs)).to(device)
            packed = prog(x, *args).cpu().numpy()
        return [_unpack(prog.spec, packed[b]) for b in range(B)]

    if H % SB or W % SB:
        raise ValueError(f"run_pass1_batch: {H}x{W} frames are not padded "
                         f"to {SB} px")
    shard.check_divisible("H", H, ax.tile, "tile")
    spec = program_spec(H, W, P, min_px, max_px)

    def band(b0, b1, h0, h1):
        prog = _program((h1 - h0, W) + key[2:], mm, device)
        x = torch.from_numpy(np.ascontiguousarray(srcs[b0:b1, h0:h1]))
        packed = prog(x.to(device), *args, row0=h0)
        grids, off = [], 0
        for (_, _, (nby, nbx)) in prog.spec:
            grids.append(packed[:, off : off + nby * nbx]
                         .reshape(b1 - b0, nby, nbx))
            off += nby * nbx
        return grids

    with torch.inference_mode():
        grids = shard.run_sharded(
            ax, B, H, SB, [(bh, (nbx,), np.int8)
                           for ((_, bh), _, (_, nbx)) in spec], band)
    return [{(shape, name): g[b] for g, (shape, name, _) in zip(grids, spec)}
            for b in range(B)]
