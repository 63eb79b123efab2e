"""AV1 tile symbolization: partition / mode / coefficient syntax.

Mirrors the spec's decode_partition / intra_frame_mode_info / residual /
coeffs processes on the encode side, maintaining the same context state the
decoder derives (partition context bytes, per-plane entropy contexts with
culLevel + DC sign category, mode/skip maps) so every symbol is coded with
the CDF the decoder will select. CDFs adapt per symbol (update_cdf) unless
disable_cdf_update is set.

This is the host-side serialization stage of the TPU design: the device
computes modes/levels for batches of blocks; this layer walks them in spec
order and drives the range coder. Tiles are entropy-independent, so tiles
serialize in parallel (thread pool / C++ port later).

Reference parity: rav1e's tile encode loop under Context::receive_packet
(/root/reference/ravif/src/av1encoder.rs:748-771); speed knobs in SURVEY.md
§2.2 select partition depth / tx behavior above this layer.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from . import tables
from .ec import RangeEncoder, update_cdf

# intra mode indices (spec order)
DC_PRED, V_PRED, H_PRED = 0, 1, 2
D45, D135, D113, D157, D203, D67 = 3, 4, 5, 6, 7, 8
SMOOTH_PRED, SMOOTH_V, SMOOTH_H, PAETH_PRED = 9, 10, 11, 12
UV_CFL_PRED = 13

INTRA_MODE_CONTEXT = [0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0]

PARTITION_NONE, PARTITION_HORZ, PARTITION_VERT, PARTITION_SPLIT = 0, 1, 2, 3


def _prob(icdf, s, nsym):
    """P(symbol s)*32768 from an inverted cdf row."""
    hi = 32768 if s == 0 else icdf[s - 1]
    lo = 0 if s == nsym - 1 else icdf[s]
    return hi - lo


def gather_split_binary(icdf, nsym, horz: bool, bsl: int):
    """Derived 2-symbol cdf for split_or_horz / split_or_vert.

    split_or_horz (bottom half missing; HORZ vs SPLIT) uses libaom's
    partition_gather_horz_alike: P(SPLIT) = sum of probabilities of
    partitions whose top half splits vertically {VERT, SPLIT, HORZ_A,
    VERT_A, VERT_B, VERT_4}. split_or_vert mirrors with vert_alike
    {HORZ, SPLIT, HORZ_A, HORZ_B, VERT_A, HORZ_4}."""
    if horz:  # split_or_horz
        subtract = [2, 3, 4, 6, 7] + ([9] if bsl != 5 else [])
    else:  # split_or_vert
        subtract = [1, 3, 4, 5, 6] + ([8] if bsl != 5 else [])
    p = 32768
    for s in subtract:
        if s < nsym:
            p -= _prob(icdf, s, nsym)
    return (32768 - p, 0)


def q_ctx(base_q: int) -> int:
    if base_q <= 20:
        return 0
    if base_q <= 60:
        return 1
    if base_q <= 120:
        return 2
    return 3


def txsize_ctx(w: int, h: int) -> int:
    """get_txsize_entropy_ctx: (log2(sqr) + log2(sqr_up) + 1) >> 1 over 4."""
    sqr = min(w, h)
    sqr_up = max(w, h)
    a = sqr.bit_length() - 3  # 4->0, 8->1, ...
    b = sqr_up.bit_length() - 3
    return min((a + b + 1) >> 1, 4)


_SKIP_CONTEXTS = [
    [1, 2, 2, 2, 3],
    [1, 4, 4, 4, 5],
    [1, 4, 4, 4, 5],
    [1, 4, 4, 4, 5],
    [1, 4, 4, 4, 6],
]


class Cdfs:
    """Mutable adaptive CDF set for one tile (lazily copied from defaults)."""

    def __init__(self, update: bool = True):
        self._store: Dict[tuple, list] = {}
        self.update = update

    def get(self, key: tuple, default_row) -> list:
        row = self._store.get(key)
        if row is None:
            row = list(default_row) + [0]  # + adaptation counter
            self._store[key] = row
        return row


@dataclass
class TileParams:
    mi_col_start: int  # in 4x4 units
    mi_col_end: int
    mi_row_start: int
    mi_row_end: int
    base_q: int
    bit_depth: int
    num_planes: int
    disable_cdf_update: bool = False
    reduced_tx_set: bool = False


class TileWriter:
    """Serializes one tile; caller supplies per-block decisions."""

    def __init__(self, p: TileParams):
        self.p = p
        self.enc = RangeEncoder()
        self.cdfs = Cdfs(update=not p.disable_cdf_update)
        # loop-restoration tap references, reset per tile (spec decode_tile)
        self.ref_wiener = [
            [list(self.WIENER_MID) for _ in range(2)] for _ in range(3)
        ]
        self.ref_sgr = [list(self.SGR_XQD_MID) for _ in range(3)]
        self.qctx = q_ctx(p.base_q)
        # per-SB adaptive quantization (spec read_delta_qindex)
        self.cur_qindex = p.base_q
        self.pending_qindex = None
        # +32 slack: edge blocks may legally overhang the mi grid
        w4 = p.mi_col_end - p.mi_col_start + 32
        h4 = p.mi_row_end - p.mi_row_start + 32
        self.w4, self.h4 = w4, h4
        # partition context bytes (5-bit masks)
        self.above_part = np.zeros(w4, dtype=np.uint8)
        self.left_part = np.zeros(h4, dtype=np.uint8)
        # mode / skip maps over the tile's mi grid
        self.y_modes = np.full((h4, w4), -1, dtype=np.int16)
        self.skips = np.zeros((h4, w4), dtype=np.uint8)
        # per-plane entropy context: culLevel | dcCat<<6
        self.above_ctx = [np.zeros(w4, dtype=np.uint8) for _ in range(3)]
        self.left_ctx = [np.zeros(h4, dtype=np.uint8) for _ in range(3)]

    # ---- low-level symbol helpers -----------------------------------------

    def code(self, sym: int, key: tuple, default_row) -> None:
        row = self.cdfs.get(key, default_row)
        n = len(row) - 1
        self.enc.encode_symbol(sym, row[:n])
        if self.cdfs.update:
            update_cdf(row, sym, n)

    def literal(self, value: int, bits: int) -> None:
        self.enc.encode_literal(value, bits)

    # ---- partition --------------------------------------------------------

    # -- loop restoration (read_lr_unit mirror, spec 5.11.58) -------------

    WIENER_MIN = (-5, -23, -17)
    WIENER_MAX = (10, 8, 46)
    WIENER_K = (1, 2, 3)
    WIENER_MID = (3, -7, 15)
    SGR_XQD_MIN = (-96, -32)
    SGR_XQD_MAX = (31, 95)
    SGR_XQD_MID = (-32, 31)  # Sgrproj_Xqd_Mid (per-tile ref reset)

    def _ns_bool(self, v: int, n: int) -> None:
        """Encode v in [0, n) with the spec's ns_bool (literal bits)."""
        w = n.bit_length()
        m = (1 << w) - n
        if v < m:
            self.literal(v, w - 1)
        else:
            x = v + m
            self.literal(x >> 1, w - 1)
            self.literal(x & 1, 1)

    def _subexp_bool(self, v: int, num_syms: int, k: int) -> None:
        i = 0
        mk = 0
        while True:
            b2 = k + i - 1 if i else k
            a = 1 << b2
            if num_syms <= mk + 3 * a:
                self._ns_bool(v - mk, num_syms - mk)
                return
            if v >= mk + a:
                self.literal(1, 1)  # subexp_more_bools
                i += 1
                mk += a
            else:
                self.literal(0, 1)
                self.literal(v - mk, b2)
                return

    @staticmethod
    def _recenter(r: int, v: int) -> int:
        """Inverse of inverse_recenter: nonneg code for v given ref r."""
        if v > 2 * r:
            return v
        if v >= r:
            return (v - r) * 2
        return (r - v) * 2 - 1

    def _signed_subexp_ref(self, v, low, high, k, ref) -> None:
        """encode_signed_subexp_with_ref_bool mirror (v in [low, high))."""
        x = v - low
        r = ref - low
        mx = high - low
        if (r << 1) <= mx:
            self._subexp_bool(self._recenter(r, x), mx, k)
        else:
            self._subexp_bool(self._recenter(mx - 1 - r, mx - 1 - x), mx, k)

    def _wiener_taps(self, plane: int, taps) -> None:
        for pass_ in range(2):
            first = 1 if plane else 0
            for j in range(first, 3):
                v = int(taps[pass_ * 3 + j])
                self._signed_subexp_ref(
                    v, self.WIENER_MIN[j], self.WIENER_MAX[j] + 1,
                    self.WIENER_K[j], self.ref_wiener[plane][pass_][j],
                )
                self.ref_wiener[plane][pass_][j] = v

    def _sgr_params(self, plane: int, sgr_set: int, xqd) -> None:
        """read_sgrproj_filter mirror (after the restore decision): 4-bit
        set + projection deltas vs the running per-tile reference. For a
        zero-radius pass the decoder derives the reference update itself;
        the caller must pass those derived values in xqd (sgr.py
        solve_unit does)."""
        self.literal(sgr_set, 4)
        r0 = 0 if 10 <= sgr_set <= 13 else 2
        r1 = 0 if sgr_set >= 14 else 1
        for i, r in enumerate((r0, r1)):
            v = int(xqd[i])
            if r:
                self._signed_subexp_ref(
                    v, self.SGR_XQD_MIN[i], self.SGR_XQD_MAX[i] + 1,
                    4, self.ref_sgr[plane][i],  # SGRPROJ_PRJ_SUBEXP_K
                )
            self.ref_sgr[plane][i] = v

    def write_lr_unit(
        self, plane: int, use: int, taps,
        frame_type: int = 2, sgr_set: int = 0, xqd=(0, 0),
    ) -> None:
        """One loop-restoration unit (read_lr_unit mirror). frame_type is
        the plane's FrameRestorationType code (1 switchable / 2 wiener /
        3 sgrproj); `use` is the unit RestorationType (0 none, 1 wiener,
        2 sgrproj). Wiener payload in `taps` (t0v..t2v, t0h..t2h), sgr
        payload in (sgr_set, xqd)."""
        if frame_type == 2:
            self.code(
                1 if use == 1 else 0,
                ("wiener_restore",),
                tables.wiener_restore_cdf(),
            )
        elif frame_type == 3:
            self.code(
                1 if use == 2 else 0,
                ("sgrproj_restore",),
                tables.sgrproj_restore_cdf(),
            )
        else:
            self.code(
                int(use),
                ("switchable_restore",),
                tables.switchable_restore_cdf(),
            )
        if use == 1:
            self._wiener_taps(plane, taps)
        elif use == 2:
            self._sgr_params(plane, sgr_set, xqd)

    def clear_left(self) -> None:
        """Called at the start of every superblock row."""
        self.left_part[:] = 0
        for pl in range(3):
            self.left_ctx[pl][:] = 0

    def write_partition(self, r: int, c: int, bsl: int, partition: int) -> None:
        """r, c: mi coords relative to tile. bsl: Mi_Width_Log2 of the block
        (1=8x8 .. 4=64x64). Caller guarantees hasRows && hasCols.

        Context shift is 8x8-relative (bsl-1): an equal-size neighbor reads 0
        (libaom partition_plane_context)."""
        above = (int(self.above_part[c]) >> (bsl - 1)) & 1
        left = (int(self.left_part[r]) >> (bsl - 1)) & 1
        ctx = left * 2 + above
        self.code(
            partition,
            ("part", bsl, ctx),
            tables.partition_cdf(bsl - 1, ctx),
        )

    def write_split_binary(self, r: int, c: int, bsl: int, horz: bool, split: bool) -> None:
        """split_or_horz / split_or_vert at partial superblocks: a derived
        2-symbol cdf from the current adapted partition row; no adaptation."""
        above = (int(self.above_part[c]) >> (bsl - 1)) & 1
        left = (int(self.left_part[r]) >> (bsl - 1)) & 1
        ctx = left * 2 + above
        row = self.cdfs.get(
            ("part", bsl, ctx), tables.partition_cdf(bsl - 1, ctx)
        )
        nsym = 4 if bsl == 1 else (8 if bsl == 5 else 10)
        icdf = gather_split_binary(row[:nsym], nsym, horz, bsl)
        self.enc.encode_symbol(1 if split else 0, icdf)

    def update_partition_ctx(self, r: int, c: int, w4: int, h4: int) -> None:
        """After coding a leaf block of w4 x h4 mi units."""
        wl = w4.bit_length() - 1
        hl = h4.bit_length() - 1
        self.above_part[c : c + w4] = (0x1F << wl) & 0x1F
        self.left_part[r : r + h4] = (0x1F << hl) & 0x1F

    # ---- block modes ------------------------------------------------------

    def write_skip(self, r: int, c: int, skip: int) -> None:
        above = int(self.skips[r - 1, c]) if r > 0 else 0
        left = int(self.skips[r, c - 1]) if c > 0 else 0
        ctx = above + left
        self.code(skip, ("skip", ctx), tables.skip_cdf(ctx))

    # default_delta_q_cdf AOM_CDF4(28160, 32120, 32677), inverted layout
    DELTA_Q_CDF = (32768 - 28160, 32768 - 32120, 32768 - 32677, 0)
    DQ_RES_LOG2 = 2

    def maybe_write_delta_q(self, w4: int, h4: int, skip: int) -> None:
        """read_delta_qindex mirror: the first block of each superblock
        codes the delta toward the SB's pending target quantizer, except
        a superblock-sized skip block (q then stays at CurrentQIndex)."""
        if self.pending_qindex is None:
            return
        if not (w4 == 16 and h4 == 16 and skip):
            delta = (self.pending_qindex - self.cur_qindex) >> self.DQ_RES_LOG2
            a = abs(delta)
            self.code(min(a, 3), ("delta_q",), self.DELTA_Q_CDF)
            if a >= 3:
                v = a - 1  # >= 2
                rem = v.bit_length() - 1
                self.literal(rem - 1, 3)
                self.literal(v - (1 << rem), rem)
            if a:
                self.literal(1 if delta < 0 else 0, 1)
            q = self.cur_qindex + (delta << self.DQ_RES_LOG2)
            self.cur_qindex = min(255, max(1, q))
        self.pending_qindex = None

    UV_CFL_PRED = 13

    def write_intra_modes(
        self, r: int, c: int, w4: int, h4: int, y_mode: int, uv_mode: int,
        cfl_allowed: bool, y_delta: int = 0, uv_delta: int = 0,
        cfl_signs: int = 0, cfl_au: int = 0, cfl_av: int = 0,
    ) -> None:
        above_mode = int(self.y_modes[r - 1, c]) if r > 0 else DC_PRED
        left_mode = int(self.y_modes[r, c - 1]) if c > 0 else DC_PRED
        if above_mode < 0:
            above_mode = DC_PRED
        if left_mode < 0:
            left_mode = DC_PRED
        actx = INTRA_MODE_CONTEXT[above_mode]
        lctx = INTRA_MODE_CONTEXT[left_mode]
        self.code(y_mode, ("kf_y", actx, lctx), tables.kf_y_mode_cdf(actx, lctx))
        # V_PRED..D67 are directional: angle_delta coded as delta + 3
        if V_PRED <= y_mode <= D67 and min(w4, h4) >= 2:
            self.code(y_delta + 3, ("angle", y_mode - V_PRED),
                      tables.angle_delta_cdf(y_mode - V_PRED))
        if self.p.num_planes > 1:
            self.code(
                uv_mode,
                ("uv", int(cfl_allowed), y_mode),
                tables.uv_mode_cdf(cfl_allowed, y_mode),
            )
            if uv_mode == self.UV_CFL_PRED:
                # read_cfl_alphas (spec 5.11.43): joint sign symbol, then
                # one 16-ary alpha symbol per nonzero-sign plane with the
                # libaom context mapping
                self.code(cfl_signs, ("cfl_sign",), tables.cfl_sign_cdf())
                sign_u = (cfl_signs + 1) // 3
                sign_v = (cfl_signs + 1) % 3
                if sign_u != 0:
                    ctx_u = cfl_signs - 2
                    self.code(cfl_au, ("cfl_alpha", ctx_u),
                              tables.cfl_alpha_cdf(ctx_u))
                if sign_v != 0:
                    ctx_v = sign_v * 3 + sign_u - 3
                    self.code(cfl_av, ("cfl_alpha", ctx_v),
                              tables.cfl_alpha_cdf(ctx_v))
            if V_PRED <= uv_mode <= D67 and min(w4, h4) >= 2:
                self.code(uv_delta + 3, ("angle", uv_mode - V_PRED),
                          tables.angle_delta_cdf(uv_mode - V_PRED))

    def record_block(self, r: int, c: int, w4: int, h4: int, y_mode: int, skip: int) -> None:
        self.y_modes[r : r + h4, c : c + w4] = y_mode
        self.skips[r : r + h4, c : c + w4] = skip

    def reset_block_ctx(self, r: int, c: int, w4: int, h4: int) -> None:
        """skip=1 blocks: entropy contexts over the block become zero."""
        for pl in range(self.p.num_planes):
            self.above_ctx[pl][c : c + w4] = 0
            self.left_ctx[pl][r : r + h4] = 0

    # ---- coefficients -----------------------------------------------------

    def write_coeffs(
        self,
        plane: int,
        r4: int,
        c4: int,
        txw: int,
        txh: int,
        levels: np.ndarray,
        tx_block_eq_block: bool = True,
        y_mode: int = 0,
        v_adst: int = 0,
        h_adst: int = 0,
    ) -> int:
        """levels: (coded_h, coded_w) signed int array in raster order
        (already restricted to the coded area: min(32, tx dims)).
        r4, c4: txb position in mi units relative to tile (for this plane,
        4:4:4 or mono so plane coords == luma coords).
        Returns culLevel."""
        p = self.p
        ptype = 1 if plane > 0 else 0
        ch, cw = levels.shape
        w4 = txw >> 2
        h4 = txh >> 2
        # decoders clamp context *writes* to the frame/tile mi bounds for
        # blocks overhanging the bottom/right edge (dav1d: imin(txh, bh-by)
        # memsets); reads then see zeros beyond the edge. Mirror exactly.
        w4w = min(w4, (p.mi_col_end - p.mi_col_start) - c4)
        h4w = min(h4, (p.mi_row_end - p.mi_row_start) - r4)
        tctx = txsize_ctx(txw, txh)
        scan = tables.scan(cw, ch)
        flat = levels.reshape(-1)
        sc = flat[scan]
        nz = np.nonzero(sc)[0]
        eob = int(nz[-1]) + 1 if len(nz) else 0

        # all_zero (txb_skip)
        if plane == 0:
            if tx_block_eq_block:
                sctx = 0
            else:
                above = 0
                left = 0
                for i in range(w4):
                    above = max(above, int(self.above_ctx[0][c4 + i]) & 63)
                for i in range(h4):
                    left = max(left, int(self.left_ctx[0][r4 + i]) & 63)
                sctx = _SKIP_CONTEXTS[min(above, 4)][min(left, 4)]
        else:
            above_nz = any(self.above_ctx[plane][c4 + i] for i in range(w4))
            left_nz = any(self.left_ctx[plane][r4 + i] for i in range(h4))
            # chroma base offset is 10 when the plane block is larger than
            # the tx (libaom get_txb_skip_ctx ctx_offset) — only 64px
            # blocks with 32x32 chroma txbs hit this
            sctx = (7 if tx_block_eq_block else 10) + int(above_nz) + int(
                left_nz
            )
        self.code(
            1 if eob == 0 else 0,
            ("txb_skip", tctx, sctx),
            tables.txb_skip_cdf(self.qctx, tctx, sctx),
        )
        if eob == 0:
            self.above_ctx[plane][c4 : c4 + w4w] = 0
            self.left_ctx[plane][r4 : r4 + h4w] = 0
            return 0

        # transform_type(): luma only, when the tx set is non-trivial
        # (sqr_up <= 16; 32/64 use EXT_TX_SET_DCTONLY). Symbol orders per
        # spec Tx_Type_Intra_Inv_Set1/2:
        #  set1: {IDTX, DCT_DCT, V_DCT, H_DCT, ADST_ADST, ADST_DCT, DCT_ADST}
        #  set2: {IDTX, DCT_DCT, ADST_ADST, ADST_DCT, DCT_ADST}
        if plane == 0 and max(txw, txh) <= 16:
            sqr = min(txw, txh)
            tx_sqr = sqr.bit_length() - 3  # 4->0 .. 32->3
            if self.p.reduced_tx_set or min(txw, txh) == 16:
                set_idx = 2
            else:
                set_idx = 1
            if not v_adst and not h_adst:
                sym = 1
            elif v_adst and h_adst:
                sym = 2 if set_idx == 2 else 4
            elif v_adst:
                sym = 3 if set_idx == 2 else 5
            else:
                sym = 4 if set_idx == 2 else 6
            self.code(
                sym,
                ("ext_tx", set_idx, tx_sqr, y_mode),
                tables.intra_ext_tx_cdf(set_idx, tx_sqr, y_mode),
            )

        # eob position class: 1->1, 2->2, else bitlength(eob-1)+1
        area = cw * ch
        if eob == 1:
            eob_pt = 1
        elif eob == 2:
            eob_pt = 2
        else:
            eob_pt = (eob - 1).bit_length() + 1
        self.code(
            eob_pt - 1,
            ("eob_pt", area, ptype),
            tables.eob_pt_cdf(area, self.qctx, ptype, 0),
        )
        if eob_pt >= 3:
            base = (1 << (eob_pt - 2)) + 1
            offset = eob - base
            msb = (offset >> (eob_pt - 3)) & 1
            self.code(
                msb,
                ("eob_extra", tctx, ptype, eob_pt - 3),
                tables.eob_extra_cdf(self.qctx, tctx, ptype, eob_pt - 3),
            )
            for i in range(eob_pt - 4, -1, -1):
                self.literal((offset >> i) & 1, 1)

        # level coding, reverse scan
        absl = np.abs(levels).astype(np.int32)
        pad = np.zeros((ch + 2, cw + 2), dtype=np.int32)  # padded abs levels
        nzoff = tables.nz_off(cw, ch)
        golombs: List[int] = []
        for si in range(eob - 1, -1, -1):
            pos = int(scan[si])
            row, col = pos // cw, pos % cw
            lv = int(absl[row, col])
            if si == eob - 1:
                if si == 0:
                    ectx = 0
                elif si <= area // 8:
                    ectx = 1
                elif si <= area // 4:
                    ectx = 2
                else:
                    ectx = 3
                sym = min(lv, 3) - 1
                self.code(
                    sym,
                    ("base_eob", tctx, ptype, ectx),
                    tables.base_eob_cdf(self.qctx, tctx, ptype, ectx),
                )
            else:
                mag = (
                    min(pad[row, col + 1], 3)
                    + min(pad[row + 1, col], 3)
                    + min(pad[row + 1, col + 1], 3)
                    + min(pad[row, col + 2], 3)
                    + min(pad[row + 2, col], 3)
                )
                mctx = min((mag + 1) >> 1, 4)
                bctx = 0 if pos == 0 else mctx + int(nzoff[row, col])
                self.code(
                    min(lv, 3),
                    ("base", tctx, ptype, bctx),
                    tables.base_cdf(self.qctx, tctx, ptype, bctx),
                )
            if lv > 2:
                # coeff_br rounds
                magb = (
                    min(pad[row, col + 1], 15)
                    + min(pad[row + 1, col], 15)
                    + min(pad[row + 1, col + 1], 15)
                )
                bmag = min((magb + 1) >> 1, 6)
                if pos == 0:
                    brctx = bmag
                elif row < 2 and col < 2:
                    brctx = bmag + 7
                else:
                    brctx = bmag + 14
                rem = min(lv, 15) - 3
                brt = min(tctx, 3)  # coeff_br cdf clamps the tx-size ctx at 32x32
                for _ in range(4):
                    sym = min(rem, 3)
                    self.code(
                        sym,
                        ("br", brt, ptype, brctx),
                        tables.br_cdf(self.qctx, brt, ptype, brctx),
                    )
                    rem -= sym
                    if sym < 3:
                        break
            pad[row, col] = min(lv, 127)

        # signs, golomb
        cul = 0
        dc_cat = 0
        for si in range(eob):
            pos = int(scan[si])
            row, col = pos // cw, pos % cw
            lv = int(absl[row, col])
            sign = 1 if levels[row, col] < 0 else 0
            if lv != 0:
                if si == 0:
                    dctx = self._dc_sign_ctx(plane, c4, w4, r4, h4)
                    self.code(
                        sign,
                        ("dc_sign", ptype, dctx),
                        tables.dc_sign_cdf(self.qctx, ptype, dctx),
                    )
                    dc_cat = 1 if sign else 2
                else:
                    self.literal(sign, 1)
            if lv > 14:
                x = lv - 14
                n = x.bit_length()
                for _ in range(n - 1):
                    self.literal(0, 1)
                self.literal(1, 1)
                for i in range(n - 2, -1, -1):
                    self.literal((x >> i) & 1, 1)
            cul += lv
        cul = min(63, cul)
        packed = cul | (dc_cat << 6)
        self.above_ctx[plane][c4 : c4 + w4w] = packed
        self.left_ctx[plane][r4 : r4 + h4w] = packed
        return cul

    def _dc_sign_ctx(self, plane: int, c4: int, w4: int, r4: int, h4: int) -> int:
        s = 0
        for i in range(w4):
            cat = int(self.above_ctx[plane][c4 + i]) >> 6
            s += 1 if cat == 2 else (-1 if cat == 1 else 0)
        for i in range(h4):
            cat = int(self.left_ctx[plane][r4 + i]) >> 6
            s += 1 if cat == 2 else (-1 if cat == 1 else 0)
        if s > 0:
            return 2
        if s < 0:
            return 1
        return 0

    def finish(self) -> bytes:
        return self.enc.done()
