"""Native (C++) runtime components: the tile entropy serializer.

Built on demand with g++ into _tilecoder.so next to the sources; spec tables
are installed from the same npz that feeds av1/tables.py, so Python and C++
share one source of truth. encode_tile_native() is byte-identical to the
Python reference serializer (tests/test_native_tilecoder.py).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
_SRC = _DIR / "tilecoder.cpp"
_SO = _DIR / "_tilecoder.so"

_lock = threading.Lock()
_lib = None

_CDF_TABLE_IDS = {
    "partition_cdf": 0,
    "kf_y_mode_cdf": 1,
    "uv_mode_cdf": 2,
    "skip_cdf": 3,
    "angle_delta_cdf": 4,
    "txb_skip_cdf": 5,
    "eob_pt_16_cdf": 6,
    "eob_pt_32_cdf": 7,
    "eob_pt_64_cdf": 8,
    "eob_pt_128_cdf": 9,
    "eob_pt_256_cdf": 10,
    "eob_pt_512_cdf": 11,
    "eob_pt_1024_cdf": 12,
    "eob_extra_cdf": 13,
    "base_cdf": 14,
    "base_eob_cdf": 15,
    "br_cdf": 16,
    "dc_sign_cdf": 17,
    "intra_ext_tx_cdf": 18,
    "cfl_sign_cdf": 19,
    "cfl_alpha_cdf": 20,
}

_SCAN_SIZES = [
    (4, 4), (4, 8), (8, 4), (8, 8), (4, 16), (16, 4), (8, 16), (16, 8),
    (16, 16), (8, 32), (32, 8), (16, 32), (32, 16), (32, 32),
]


def _build() -> None:
    # colorconv.cpp is a separate object ONLY for -ffp-contract=off: its
    # f32 pipeline must round exactly like numpy (no FMA contraction)
    cc = _DIR / "colorconv.cpp"
    obj = _DIR / "_colorconv.o"
    subprocess.run(
        ["g++", "-O3", "-march=native", "-ffp-contract=off", "-c",
         "-fPIC", "-std=c++17", str(cc), "-o", str(obj)],
        check=True, capture_output=True,
    )
    cmd = [
        "g++", "-O3", "-march=native", "-funroll-loops",
        "-shared", "-fPIC", "-std=c++17",
    ]
    if os.environ.get("CAVIF_TPU_BP_PROF"):
        # stage-profiling build (block-pipeline timers; ~6% slower)
        cmd.append("-DCAVIF_BP_PROF")
    cmd += [str(_SRC), str(obj), "-o", str(_SO), "-lpthread"]
    subprocess.run(cmd, check=True, capture_output=True)


def _load():
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        _cc = _DIR / "colorconv.cpp"
        _hdr = _DIR / "op_contract.h"
        if (not _SO.exists()
                or _SO.stat().st_mtime < _SRC.stat().st_mtime
                or _SO.stat().st_mtime < _cc.stat().st_mtime
                or _SO.stat().st_mtime < _hdr.stat().st_mtime):
            _build()
        lib = ctypes.CDLL(str(_SO))
        lib.tc_set_cdf_table.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_uint16), ctypes.c_int,
        ]
        lib.tc_set_cdf_table.restype = ctypes.c_int
        lib.tc_set_scan.argtypes = [
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.tc_set_scan.restype = ctypes.c_int
        lib.tc_encode_tile.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ]
        lib.tc_encode_tile.restype = ctypes.c_int
        lib.tc_op_arity.argtypes = [ctypes.c_int]
        lib.tc_op_arity.restype = ctypes.c_int
        lib.tc_cand_mode.argtypes = [ctypes.c_int]
        lib.tc_cand_mode.restype = ctypes.c_int
        lib.tc_set_sm_weights.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.tc_set_sm_weights.restype = ctypes.c_int
        lib.tc_set_dr.argtypes = [ctypes.POINTER(ctypes.c_int32)]
        lib.tc_set_dr.restype = ctypes.c_int
        lib.tc_set_cospi.argtypes = [ctypes.POINTER(ctypes.c_int32)]
        lib.tc_set_cospi.restype = ctypes.c_int
        lib.tc_set_sinpi.argtypes = [ctypes.POINTER(ctypes.c_int32)]
        lib.tc_set_sinpi.restype = ctypes.c_int
        lib.tc_set_fwd_adst.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_double),
        ]
        lib.tc_set_fwd_adst.restype = ctypes.c_int
        lib.tc_inv_txfm.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.tc_inv_txfm.restype = ctypes.c_int
        lib.tc_itx_clamp_violations.argtypes = [ctypes.c_int]
        lib.tc_itx_clamp_violations.restype = ctypes.c_longlong
        lib.bp_encode_tile.argtypes = [
            ctypes.POINTER(ctypes.c_int32),  # src planes
            ctypes.c_int, ctypes.c_int,      # Hp, Wp
            ctypes.c_int, ctypes.c_int,      # mi_rows, mi_cols
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # tile
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # q/bd/planes/dcu
            ctypes.c_int,                    # reduced_tx_set
            ctypes.c_int, ctypes.c_int,      # dc_q, ac_q
            ctypes.c_double, ctypes.c_double,  # gain, lam
            ctypes.c_int,                    # cfl_search
            ctypes.c_int,                    # edge_filter
            ctypes.c_int,                    # tx_exhaustive
            ctypes.c_double,                 # eob_adapt (tune-dep scale)
            ctypes.POINTER(ctypes.c_double), ctypes.c_int,  # psy map, cols
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32),  # recon out (nullable)
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,  # rec ops (nullable)
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,  # rec levels
            ctypes.POINTER(ctypes.c_int32),  # rec sizes[2]
            ctypes.c_int,                    # ec_off (deferred EC)
        ]
        lib.bp_encode_tile.restype = ctypes.c_int
        lib.bs_search.argtypes = [
            ctypes.POINTER(ctypes.c_int32),  # src
            ctypes.POINTER(ctypes.c_int32),  # above_ext
            ctypes.POINTER(ctypes.c_int32),  # left_ext
            ctypes.POINTER(ctypes.c_int32),  # al
            ctypes.POINTER(ctypes.c_uint8),  # have_a
            ctypes.POINTER(ctypes.c_uint8),  # have_l
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, bw, bh
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # dc_q, ac_q, bd
            ctypes.c_double, ctypes.c_double,          # lam, gain
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # K, refine, force_skip
            ctypes.c_int,                              # n_threads
            ctypes.POINTER(ctypes.c_int32),            # out mode idx
            ctypes.POINTER(ctypes.c_int32),            # out delta
            ctypes.POINTER(ctypes.c_double),           # out cost
        ]
        lib.bs_search.restype = ctypes.c_int
        lib.bs_search2.argtypes = [
            ctypes.POINTER(ctypes.c_int32),  # planes (P, Hp, Wp)
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # P, Hp, Wp
            ctypes.POINTER(ctypes.c_int32),  # items (B, 3): pl, py, px
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, bw, bh
            ctypes.c_int, ctypes.c_int,                # py0, px0
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # dc_q, ac_q, bd
            ctypes.c_double, ctypes.c_double,          # lam, gain
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # K, refine, force_skip
            ctypes.c_int, ctypes.c_int,                # joint_uv, n_threads
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.bs_search2.restype = ctypes.c_int
        lib.bs_partition_tile.argtypes = [
            ctypes.POINTER(ctypes.c_int32),  # planes (P, Hp, Wp)
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # P, Hp, Wp
            ctypes.c_int, ctypes.c_int,      # mi_rows, mi_cols
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # tile
            ctypes.c_int, ctypes.c_int,      # min/max leaf mi
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,  # partials, n
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # dc_q, ac_q, bd
            ctypes.c_double,                 # lam
            ctypes.POINTER(ctypes.c_double),  # gain_tab 4x4
            ctypes.c_int, ctypes.c_int,      # K_luma, K_chroma
            ctypes.c_int, ctypes.c_int,      # fine_dir, chroma_refine
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # n_planes, joint, exh
            ctypes.c_double, ctypes.c_double,  # ovh_block, ovh_split
            ctypes.c_double, ctypes.c_double,  # kappa, rect_ovh_blocks
            ctypes.POINTER(ctypes.c_int32),   # qmap (dc,ac)/SB (nullable)
            ctypes.POINTER(ctypes.c_double),  # lammap (nullable)
            ctypes.c_int,                    # sb_cols
            ctypes.c_int,                    # n_threads
            ctypes.POINTER(ctypes.c_int32),  # out_blocks (cap, 8)
            ctypes.POINTER(ctypes.c_double),  # out_costs (cap, 2)
            ctypes.c_int, ctypes.POINTER(ctypes.c_int32),  # cap, n_blocks
            ctypes.POINTER(ctypes.c_int32),  # out_parts (cap, 4)
            ctypes.c_int, ctypes.POINTER(ctypes.c_int32),  # cap, n_parts
        ]
        lib.bs_partition_tile.restype = ctypes.c_int
        lib.lr_wiener_plane.argtypes = [
            ctypes.POINTER(ctypes.c_int32),  # src plane
            ctypes.POINTER(ctypes.c_int32),  # rec plane
            ctypes.c_int, ctypes.c_int,      # h, w
            ctypes.c_int, ctypes.c_int,      # sstride, rstride
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # unit, rows, cols
            ctypes.c_int, ctypes.c_double,   # ntaps, margin
            ctypes.c_int,                    # n_threads
            ctypes.POINTER(ctypes.c_int32),  # out use
            ctypes.POINTER(ctypes.c_int32),  # out taps (U, 6)
            ctypes.POINTER(ctypes.c_double),  # out sse
            ctypes.POINTER(ctypes.c_double),  # out base sse
            ctypes.POINTER(ctypes.c_double),  # out var (U, 3), nullable
            ctypes.c_double,                  # mu (psy variance penalty)
        ]
        lib.lr_wiener_plane.restype = ctypes.c_int
        lib.lr_sgr_plane.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),  # out var (U, 3), nullable
            ctypes.c_double,                  # mu (psy variance penalty)
        ]
        lib.lr_sgr_plane.restype = ctypes.c_int
        lib.cs_rgb_to_ycbcr.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),  # rgb (N, 3) uint8
            ctypes.c_longlong, ctypes.c_int,  # n_px, depth
            ctypes.c_double, ctypes.c_double,  # kr, kb
            ctypes.c_int,                    # n_threads
            ctypes.POINTER(ctypes.c_int32),  # out (N, 3)
        ]
        lib.cs_rgb_to_ycbcr.restype = ctypes.c_int
        _u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.of_build_maps.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,  # ops
            ctypes.c_int, ctypes.c_int,      # tile origin r0, c0
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # mi_rows, mi_cols, nt
            _u8p, _u8p, _u8p, _u8p, _u8p,    # skip, txw, txh, edge_v, edge_h
        ]
        lib.of_build_maps.restype = ctypes.c_int
        lib.of_deblock.argtypes = [
            ctypes.POINTER(ctypes.c_int32),  # planes (P, Hp, Wp), in place
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # P, Hp, Wp
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # mi_rows, mi_cols, bd
            ctypes.POINTER(ctypes.c_int32),  # levels[4]
            _u8p, _u8p, _u8p, _u8p,          # txw, txh, edge_v, edge_h
            ctypes.POINTER(ctypes.c_int32),  # src (nullable)
            ctypes.c_int, ctypes.c_int,      # vis_w, vis_h
            ctypes.POINTER(ctypes.c_double),  # sse_out[P] (nullable)
            ctypes.c_int,                    # n_threads
            ctypes.c_int,                    # row_sub (search subsample)
        ]
        lib.of_deblock.restype = ctypes.c_int
        lib.of_cdef_dirs.argtypes = [
            ctypes.POINTER(ctypes.c_int32),  # deblocked luma (Hp, Wp)
            ctypes.c_int, ctypes.c_int,      # Hp, Wp
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # mi_rows, mi_cols, bd
            _u8p, ctypes.POINTER(ctypes.c_int32),  # dirs, vars (sb8 grids)
            ctypes.c_int,                    # n_threads
        ]
        lib.of_cdef_dirs.restype = ctypes.c_int
        lib.of_cdef_search.argtypes = [
            ctypes.POINTER(ctypes.c_int32),  # in (deblocked)
            ctypes.POINTER(ctypes.c_int32),  # src
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # P, Hp, Wp
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # mi/bd/damp
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,  # pri_cands, n_pri
            _u8p, _u8p, ctypes.POINTER(ctypes.c_int32),  # skip, dirs, vars
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # vis_w, vis_h, threads
            ctypes.c_int,  # sub (block subsampling 1/2/4)
            ctypes.c_int,  # fast_sec (search secondary {0, 2} only)
            ctypes.c_int,  # per_sb (per-64x64 accumulators)
            ctypes.POINTER(ctypes.c_double),  # out_y[n_pri*4]
            ctypes.POINTER(ctypes.c_double),  # out_uv (nullable)
        ]
        lib.of_cdef_search.restype = ctypes.c_int
        lib.of_cdef_apply.argtypes = [
            ctypes.POINTER(ctypes.c_int32),  # in (deblocked)
            ctypes.POINTER(ctypes.c_int32),  # out (nullable)
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # P, Hp, Wp
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # mi/bd/damp
            ctypes.POINTER(ctypes.c_int32),  # strengths[4]
            _u8p, _u8p, ctypes.POINTER(ctypes.c_int32),  # skip, dirs, vars
            ctypes.POINTER(ctypes.c_int32),  # src (nullable)
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # vis_w, vis_h, threads
            ctypes.POINTER(ctypes.c_double),  # sse_out[P] (nullable)
        ]
        lib.of_cdef_apply.restype = ctypes.c_int
        _install_tables(lib)
        _lib = lib
        return _lib


def _install_tables(lib) -> None:
    from ..av1 import tables

    for name, tid in _CDF_TABLE_IDS.items():
        arr = np.ascontiguousarray(tables.get(name), dtype=np.uint16)
        rc = lib.tc_set_cdf_table(
            tid, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), arr.size
        )
        if rc != 0:
            raise RuntimeError(f"tc_set_cdf_table({name}) failed")
    # context-aware trellis cost tables (1/128-bit units, derived in
    # tables.trellis_cost from the same default CDFs — uploaded rather
    # than recomputed so both backends price bit-identically)
    for name, tid in (
        ("base_cdf", 21), ("base_eob_cdf", 22), ("br_cdf", 23),
    ):
        arr = np.ascontiguousarray(tables.trellis_cost(name), dtype=np.uint16)
        rc = lib.tc_set_cdf_table(
            tid, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), arr.size
        )
        if rc != 0:
            raise RuntimeError(f"tc_set_cdf_table(trellis:{name}) failed")
    for w, h in _SCAN_SIZES:
        scan = np.ascontiguousarray(tables.scan(w, h), dtype=np.int32)
        nz = np.ascontiguousarray(tables.nz_off(w, h), dtype=np.uint8)
        rc = lib.tc_set_scan(
            w, h,
            scan.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            nz.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        if rc != 0:
            raise RuntimeError(f"tc_set_scan({w}x{h}) failed")
    for n in (4, 8, 16, 32, 64):
        w = np.ascontiguousarray(tables.get(f"sm_weights_{n}"), dtype=np.uint8)
        rc = lib.tc_set_sm_weights(
            n, w.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        )
        if rc != 0:
            raise RuntimeError(f"tc_set_sm_weights({n}) failed")
    dr = np.ascontiguousarray(tables.get("dr_intra_derivative"), dtype=np.int32)
    if lib.tc_set_dr(dr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))) != 0:
        raise RuntimeError("tc_set_dr failed")
    cp = np.ascontiguousarray(tables.get("cospi")[2], dtype=np.int32)  # bit 12
    if lib.tc_set_cospi(cp.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))) != 0:
        raise RuntimeError("tc_set_cospi failed")
    sp = np.ascontiguousarray(tables.get("sinpi")[2], dtype=np.int32)  # bit 12
    if lib.tc_set_sinpi(sp.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))) != 0:
        raise RuntimeError("tc_set_sinpi failed")
    from ..av1.itx import iadst_basis

    for n in (4, 8, 16):
        fwd = np.ascontiguousarray(iadst_basis(n).T, dtype=np.float64)
        if lib.tc_set_fwd_adst(
            n, fwd.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
        ) != 0:
            raise RuntimeError("tc_set_fwd_adst failed")


def encode_tile_bp(
    p,
    src_planes: np.ndarray,
    mi_rows: int,
    mi_cols: int,
    dc_q: int,
    ac_q: int,
    gain: float,
    ops: np.ndarray,
    lam: float = 0.0,
    recon_out: np.ndarray = None,
    record: bool = False,
    cfl_search: bool = False,
    edge_filter: bool = False,
    tx_exhaustive: bool = False,
    psy_map: np.ndarray = None,
    ec_skip: bool = False,
    eob_adapt: float = 1.0,
):
    """Native pass-2 tile encode: skeleton ops (partition walk + block modes)
    drive intra predict + DCT + quantize + reconstruct + entropy coding in
    C++. src_planes: (P, Hp, Wp) contiguous int32 padded source. recon_out:
    optional (P, Hp, Wp) int32 buffer receiving this tile's decoder-exact
    reconstruction (for output-filter parameter search).

    With record=True returns (bytes, replay_ops, replay_levels) — the
    expanded concrete op stream of this encode, re-serializable via
    encode_tile_native (so output-filter passes re-run only the entropy
    coder); (bytes, None, None) if recording overflowed.

    ec_skip=True runs decisions/recon/capture WITHOUT entropy coding (the
    returned bytes are empty): the caller produces the bitstream once via
    the replay coder after the loop-restoration decision, instead of
    coding every symbol twice."""
    lib = _load()
    ops = np.ascontiguousarray(ops, dtype=np.int32)
    src_planes = np.ascontiguousarray(src_planes, dtype=np.int32)
    P, Hp, Wp = src_planes.shape
    assert P == p.num_planes
    mi_h = min(p.mi_row_end, mi_rows) - p.mi_row_start
    mi_w = min(p.mi_col_end, mi_cols) - p.mi_col_start
    rops = rlvl = rsz = None
    if record:
        # worst case per 4x4 mi: OP_BLOCK(11) + 3 OP_COEFFS(13); levels
        # bounded by the coded area (<= pixels) per plane
        rops = np.empty(int(ops.size + mi_h * mi_w * 50 + 4096), np.int32)
        rlvl = np.empty(int(P * (mi_h * 4 + 64) * (mi_w * 4 + 64) + 64),
                        np.int32)
        rsz = np.zeros(2, np.int32)
    cap = 65536 + src_planes.size * 4
    while True:
        out = np.empty(cap, dtype=np.uint8)
        n = lib.bp_encode_tile(
            src_planes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            Hp, Wp, mi_rows, mi_cols,
            p.mi_row_start, p.mi_row_end, p.mi_col_start, p.mi_col_end,
            p.base_q, p.bit_depth, p.num_planes, int(p.disable_cdf_update),
            int(p.reduced_tx_set), dc_q, ac_q, gain, lam,
            int(cfl_search), int(edge_filter), int(tx_exhaustive),
            float(eob_adapt),
            psy_map.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
            if psy_map is not None else None,
            psy_map.shape[1] if psy_map is not None else 0,
            ops.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), ops.size,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap,
            recon_out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
            if recon_out is not None
            else None,
            rops.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
            if rops is not None else None,
            rops.size if rops is not None else 0,
            rlvl.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
            if rlvl is not None else None,
            rlvl.size if rlvl is not None else 0,
            rsz.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
            if rsz is not None else None,
            int(ec_skip),
        )
        if n >= 0:
            data = out[:n].tobytes()
            if not record:
                return data
            if rsz[0] < 0:
                return data, None, None
            return data, rops[: rsz[0]].copy(), rlvl[: rsz[1]].copy()
        if n == -2 or cap > (1 << 28):
            raise RuntimeError("bp tile encode failed")
        cap *= 4


def mode_search(
    src: np.ndarray,
    above_ext: np.ndarray,
    left_ext: np.ndarray,
    al: np.ndarray,
    have_a: np.ndarray,
    have_l: np.ndarray,
    dc_q: int,
    ac_q: int,
    bit_depth: int,
    lam: float,
    gain: float,
    K: int,
    refine: bool,
    force_skip: bool,
    n_threads: int = 1,
):
    """Native batched intra mode search (pass 1). Mirrors the numpy
    reference in av1/encoder.py _batch_search (SAD prefilter with DC kept,
    transform-domain RD on top-K, angle-delta refinement) over B same-sized
    blocks. Returns (mode_idx, delta, cost) int32/int32/float64 arrays; the
    mode index is into CAND_MODES = nondirectional(7) + diagonals(6)."""
    lib = _load()
    B, bh, bw = src.shape
    src = np.ascontiguousarray(src, dtype=np.int32)
    above_ext = np.ascontiguousarray(above_ext, dtype=np.int32)
    left_ext = np.ascontiguousarray(left_ext, dtype=np.int32)
    al = np.ascontiguousarray(al, dtype=np.int32)
    have_a = np.ascontiguousarray(have_a, dtype=np.uint8)
    have_l = np.ascontiguousarray(have_l, dtype=np.uint8)
    out_mode = np.empty(B, dtype=np.int32)
    out_delta = np.empty(B, dtype=np.int32)
    out_cost = np.empty(B, dtype=np.float64)
    i32 = ctypes.POINTER(ctypes.c_int32)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    rc = lib.bs_search(
        src.ctypes.data_as(i32),
        above_ext.ctypes.data_as(i32),
        left_ext.ctypes.data_as(i32),
        al.ctypes.data_as(i32),
        have_a.ctypes.data_as(u8),
        have_l.ctypes.data_as(u8),
        B, bw, bh, dc_q, ac_q, bit_depth, lam, gain,
        K, int(refine), int(force_skip), n_threads,
        out_mode.ctypes.data_as(i32),
        out_delta.ctypes.data_as(i32),
        out_cost.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    if rc != 0:
        raise RuntimeError("bs_search failed")
    return out_mode, out_delta, out_cost


def mode_search_planes(
    planes: np.ndarray,
    items: np.ndarray,
    bw: int,
    bh: int,
    origin_px: tuple,
    dc_q: int,
    ac_q: int,
    bit_depth: int,
    lam: float,
    gain: float,
    K: int,
    refine: bool,
    force_skip: bool,
    n_threads: int = 1,
    joint_uv: bool = False,
):
    """bs_search2: like mode_search but the neighbor gather happens in the
    C++ worker threads. planes: (P, Hp, Wp) contiguous int32 padded source;
    items: (B, 3) int32 rows (plane, py, px) in pixels; origin_px: tile
    origin (py0, px0) for the availability rules. With joint_uv, plane-1
    items co-decide the same block of plane 2 (one shared uv mode, summed
    RD costs — the cost out is U+V)."""
    lib = _load()
    planes = np.ascontiguousarray(planes, dtype=np.int32)
    items = np.ascontiguousarray(items, dtype=np.int32)
    P, Hp, Wp = planes.shape
    B = items.shape[0]
    out_mode = np.empty(B, dtype=np.int32)
    out_delta = np.empty(B, dtype=np.int32)
    out_cost = np.empty(B, dtype=np.float64)
    i32 = ctypes.POINTER(ctypes.c_int32)
    rc = lib.bs_search2(
        planes.ctypes.data_as(i32), P, Hp, Wp,
        items.ctypes.data_as(i32), B, bw, bh,
        int(origin_px[0]), int(origin_px[1]),
        dc_q, ac_q, bit_depth, lam, gain,
        K, int(refine), int(force_skip), int(joint_uv), n_threads,
        out_mode.ctypes.data_as(i32),
        out_delta.ctypes.data_as(i32),
        out_cost.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    if rc != 0:
        raise RuntimeError("bs_search2 failed")
    return out_mode, out_delta, out_cost


def partition_tile(
    planes: np.ndarray,
    mi_rows: int,
    mi_cols: int,
    tile: tuple,
    min_leaf_mi: int,
    max_leaf_mi: int,
    partials: np.ndarray,
    dc_q: int,
    ac_q: int,
    bit_depth: int,
    lam: float,
    gain_tab: np.ndarray,
    K_luma: int,
    K_chroma: int,
    fine_dir: bool,
    chroma_refine: bool,
    num_planes: int,
    joint_uv: bool,
    exhaustive: bool,
    ovh_block: float,
    ovh_split: float,
    kappa: float,
    rect_ovh_blocks: float,
    n_threads: int = 1,
    qmap=None,
    lammap=None,
):
    """Whole-tile pass-1 (bs_partition_tile): the tier cascade, chroma-cost
    spreading, rect-half candidates, and the bottom-up partition DP all run
    natively; returns (blocks, costs, parts) arrays. Decision-identical to
    the python cascade (FrameEncoder._rdo_partition); pinned by
    tests/test_native_search.py byte-equality."""
    lib = _load()
    planes = np.ascontiguousarray(planes, dtype=np.int32)
    partials = np.ascontiguousarray(
        partials.reshape(-1, 4), dtype=np.int32
    )
    gain_tab = np.ascontiguousarray(gain_tab, dtype=np.float64)
    P, Hp, Wp = planes.shape
    mi_r0, mi_r1, mi_c0, mi_c1 = tile
    # capacity: every full square of every tier + 4 rect halves per parent
    # cell of the tiers above min + the edge partials
    cap = len(partials) + 16
    parts_cap = 16
    s4 = min_leaf_mi
    while s4 <= max_leaf_mi:
        nr = -(-(mi_r1 - mi_r0) // s4)
        nc = -(-(mi_c1 - mi_c0) // s4)
        # +1 per cell covers the narrowed-K refine re-search rows
        cap += nr * nc * (2 if s4 == min_leaf_mi else 6)
        if s4 != min_leaf_mi:
            parts_cap += nr * nc
        s4 *= 2
    out_blocks = np.empty((cap, 8), dtype=np.int32)
    out_costs = np.empty((cap, 2), dtype=np.float64)
    out_parts = np.empty((parts_cap, 4), dtype=np.int32)
    nb = np.zeros(1, dtype=np.int32)
    npt = np.zeros(1, dtype=np.int32)
    i32 = ctypes.POINTER(ctypes.c_int32)
    f64 = ctypes.POINTER(ctypes.c_double)
    rc = lib.bs_partition_tile(
        planes.ctypes.data_as(i32), P, Hp, Wp, mi_rows, mi_cols,
        mi_r0, mi_r1, mi_c0, mi_c1, min_leaf_mi, max_leaf_mi,
        partials.ctypes.data_as(i32), len(partials),
        dc_q, ac_q, bit_depth, lam, gain_tab.ctypes.data_as(f64),
        K_luma, K_chroma, int(fine_dir), int(chroma_refine),
        num_planes, int(joint_uv), int(exhaustive),
        ovh_block, ovh_split, kappa, rect_ovh_blocks,
        qmap.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        if qmap is not None else None,
        lammap.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
        if lammap is not None else None,
        lammap.shape[1] if lammap is not None else 0,
        n_threads,
        out_blocks.ctypes.data_as(i32), out_costs.ctypes.data_as(f64),
        cap, nb.ctypes.data_as(i32),
        out_parts.ctypes.data_as(i32), parts_cap, npt.ctypes.data_as(i32),
    )
    if rc != 0:
        raise RuntimeError(f"bs_partition_tile failed (rc={rc})")
    n, p = int(nb[0]), int(npt[0])
    return out_blocks[:n], out_costs[:n], out_parts[:p]


def encode_tile_native(p, ops: np.ndarray, levels: np.ndarray) -> bytes:
    """Serialize one tile from its op stream; byte-identical to the Python
    reference (opstream.replay_python)."""
    lib = _load()
    ops = np.ascontiguousarray(ops, dtype=np.int32)
    levels = np.ascontiguousarray(levels, dtype=np.int32)
    cap = 4096 + levels.size * 4 + ops.size * 4
    while True:
        out = np.empty(cap, dtype=np.uint8)
        n = lib.tc_encode_tile(
            p.mi_col_start, p.mi_col_end, p.mi_row_start, p.mi_row_end,
            p.base_q, p.num_planes, int(p.disable_cdf_update),
            int(p.reduced_tx_set),
            ops.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), ops.size,
            levels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap,
        )
        if n >= 0:
            return out[:n].tobytes()
        if cap > (1 << 28):
            raise RuntimeError("tile encode failed")
        cap *= 4


def build_filter_maps(tile_ops, mi_rows: int, mi_cols: int, num_planes: int):
    """Derive the loop-filter maps from concrete (replayable) tile op
    streams: per-mi tx dims (log2 px) and txb start-edge flags on the
    {luma, chroma} grids, plus the skip map. tile_ops: iterable of
    (mi_r0, mi_c0, ops) with OP_BLOCK rows tile-relative."""
    lib = _load()
    nt = 2 if num_planes == 3 else 1
    grid = mi_rows * mi_cols
    skip = np.zeros(grid, np.uint8)
    txw = np.zeros(nt * grid, np.uint8)
    txh = np.zeros(nt * grid, np.uint8)
    edge_v = np.zeros(nt * grid, np.uint8)
    edge_h = np.zeros(nt * grid, np.uint8)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    for r0, c0, ops in tile_ops:
        ops = np.ascontiguousarray(ops, dtype=np.int32)
        rc = lib.of_build_maps(
            ops.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), ops.size,
            int(r0), int(c0), mi_rows, mi_cols, nt,
            skip.ctypes.data_as(u8), txw.ctypes.data_as(u8),
            txh.ctypes.data_as(u8), edge_v.ctypes.data_as(u8),
            edge_h.ctypes.data_as(u8),
        )
        if rc != 0:
            raise RuntimeError("of_build_maps failed")
    return skip, txw, txh, edge_v, edge_h


def deblock_frame(planes: np.ndarray, mi_rows: int, mi_cols: int,
                  bit_depth: int, levels, maps, src: np.ndarray = None,
                  vis: tuple = (0, 0), n_threads: int = 1,
                  row_sub: int = 1):
    """Decoder-exact deblocking in place on the padded (P, Hp, Wp) int32
    reconstruction. levels: (y_vert, y_horz, u, v); maps from
    build_filter_maps. With src (same shape) set, returns the per-plane
    SSE delta (filtered minus unfiltered, against src) over the visible
    vis=(w, h) crop — the filter-level search metric. row_sub > 1
    filters/scores only every row_sub'th superblock row (search mode;
    the final apply must pass 1 for the decoder-exact full pass)."""
    lib = _load()
    _skip, txw, txh, edge_v, edge_h = maps
    P, Hp, Wp = planes.shape
    assert planes.dtype == np.int32 and planes.flags["C_CONTIGUOUS"]
    lv = np.asarray(list(levels) + [0] * (4 - len(levels)), dtype=np.int32)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    i32 = ctypes.POINTER(ctypes.c_int32)
    sse = np.zeros(P, np.float64) if src is not None else None
    rc = lib.of_deblock(
        planes.ctypes.data_as(i32),
        P, Hp, Wp, mi_rows, mi_cols, bit_depth,
        lv.ctypes.data_as(i32),
        txw.ctypes.data_as(u8), txh.ctypes.data_as(u8),
        edge_v.ctypes.data_as(u8), edge_h.ctypes.data_as(u8),
        src.ctypes.data_as(i32) if src is not None else None,
        int(vis[0]), int(vis[1]),
        sse.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
        if sse is not None else None,
        int(n_threads),
        int(row_sub),
    )
    if rc != 0:
        raise RuntimeError("of_deblock failed")
    return sse


def cdef_dirs(deblocked_luma: np.ndarray, mi_rows: int, mi_cols: int,
              bit_depth: int, n_threads: int = 1):
    """Per-8x8 CDEF direction + variance grids from the deblocked luma
    (padded (Hp, Wp) int32)."""
    lib = _load()
    Hp, Wp = deblocked_luma.shape
    assert deblocked_luma.dtype == np.int32
    assert deblocked_luma.flags["C_CONTIGUOUS"]
    sb8r, sb8c = (mi_rows + 1) >> 1, (mi_cols + 1) >> 1
    dirs = np.zeros((sb8r, sb8c), np.uint8)
    vars_ = np.zeros((sb8r, sb8c), np.int32)
    i32 = ctypes.POINTER(ctypes.c_int32)
    rc = lib.of_cdef_dirs(
        deblocked_luma.ctypes.data_as(i32), Hp, Wp, mi_rows, mi_cols,
        bit_depth,
        dirs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        vars_.ctypes.data_as(i32),
        int(n_threads),
    )
    if rc != 0:
        raise RuntimeError("of_cdef_dirs failed")
    return dirs, vars_


def cdef_apply(inp: np.ndarray, out, mi_rows: int, mi_cols: int,
               bit_depth: int, damping: int, strengths, skip: np.ndarray,
               dirs: np.ndarray, vars_: np.ndarray, src: np.ndarray = None,
               vis: tuple = (0, 0), n_threads: int = 1):
    """Apply CDEF reading the deblocked (P, Hp, Wp) int32 `inp`, writing
    `out` (None: search mode, no writes). strengths: (y_pri, y_sec,
    uv_pri, uv_sec) actual values. With src set, returns per-plane SSE
    delta over the visible vis=(w, h) crop."""
    lib = _load()
    P, Hp, Wp = inp.shape
    assert inp.dtype == np.int32 and inp.flags["C_CONTIGUOUS"]
    st = np.asarray(strengths, dtype=np.int32)
    i32 = ctypes.POINTER(ctypes.c_int32)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    sse = np.zeros(P, np.float64) if src is not None else None
    rc = lib.of_cdef_apply(
        inp.ctypes.data_as(i32),
        out.ctypes.data_as(i32) if out is not None else None,
        P, Hp, Wp, mi_rows, mi_cols, bit_depth, damping,
        st.ctypes.data_as(i32),
        skip.ctypes.data_as(u8),
        dirs.ctypes.data_as(u8),
        vars_.ctypes.data_as(i32),
        src.ctypes.data_as(i32) if src is not None else None,
        int(vis[0]), int(vis[1]), int(n_threads),
        sse.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
        if sse is not None else None,
    )
    if rc != 0:
        raise RuntimeError("of_cdef_apply failed")
    return sse


def lr_wiener_plane(
    src: np.ndarray,
    rec: np.ndarray,
    h: int,
    w: int,
    unit: int,
    rows: int,
    cols: int,
    ntaps: int,
    margin: float,
    n_threads: int = 1,
    want_var: bool = False,
    mu: float = 0.0,
):
    """Per-unit separable Wiener LS solve over one plane's restoration
    grid (C++ mirror of encoder._wiener_unit). Returns (use, taps, sse,
    base) arrays of shape (rows*cols,) / (rows*cols, 6); with
    want_var=True appends a (rows*cols, 3) array of per-unit central
    second moments [source, pre-filter recon, filtered output] for the
    SSIM-contrast variance guard."""
    lib = _load()
    src = np.ascontiguousarray(src, dtype=np.int32)
    rec = np.ascontiguousarray(rec, dtype=np.int32)
    U = rows * cols
    use = np.empty(U, dtype=np.int32)
    taps = np.empty((U, 6), dtype=np.int32)
    sse = np.empty(U, dtype=np.float64)
    base = np.empty(U, dtype=np.float64)
    var = np.empty((U, 3), dtype=np.float64) if want_var else None
    i32 = ctypes.POINTER(ctypes.c_int32)
    f64 = ctypes.POINTER(ctypes.c_double)
    rc = lib.lr_wiener_plane(
        src.ctypes.data_as(i32), rec.ctypes.data_as(i32),
        h, w, src.shape[1], rec.shape[1], unit, rows, cols,
        ntaps, float(margin), n_threads,
        use.ctypes.data_as(i32), taps.ctypes.data_as(i32),
        sse.ctypes.data_as(f64), base.ctypes.data_as(f64),
        var.ctypes.data_as(f64) if var is not None else None,
        float(mu),
    )
    if rc != 0:
        raise RuntimeError("lr_wiener_plane failed")
    if want_var:
        return use, taps, sse, base, var
    return use, taps, sse, base


def lr_sgr_plane(
    src: np.ndarray,
    rec: np.ndarray,
    h: int,
    w: int,
    unit: int,
    rows: int,
    cols: int,
    bit_depth: int,
    full,
    n_threads: int = 1,
    want_var: bool = False,
    mu: float = 0.0,
):
    """Per-unit self-guided (SGRPROJ) restoration search over one plane's
    grid (C++ mirror of av1/sgr.search_unit: decoder-exact integer filter,
    LS projection solve, exact integer SSE). Returns (set (U,), xqd (U, 2),
    sse (U,)) for the best searched set per unit. `full` is the tier:
    True/1 = full 16-set, False/0 = reduced 6-set, 2 = fast 3-set
    {6, 9, 14} (the sets chosen in 95% of units across the BD corpus;
    speed >= 4). want_var=True appends a (U, 3) per-unit
    central-second-moment array [source, pre-filter recon, best-set
    filtered output] for the SSIM-contrast variance guard."""
    lib = _load()
    src = np.ascontiguousarray(src, dtype=np.int32)
    rec = np.ascontiguousarray(rec, dtype=np.int32)
    U = rows * cols
    sets = np.empty(U, dtype=np.int32)
    xqd = np.empty((U, 2), dtype=np.int32)
    sse = np.empty(U, dtype=np.float64)
    var = np.empty((U, 3), dtype=np.float64) if want_var else None
    i32 = ctypes.POINTER(ctypes.c_int32)
    f64 = ctypes.POINTER(ctypes.c_double)
    rc = lib.lr_sgr_plane(
        src.ctypes.data_as(i32), rec.ctypes.data_as(i32),
        h, w, src.shape[1], rec.shape[1], unit, rows, cols,
        bit_depth, int(full), n_threads,
        sets.ctypes.data_as(i32), xqd.ctypes.data_as(i32),
        sse.ctypes.data_as(f64),
        var.ctypes.data_as(f64) if var is not None else None,
        float(mu),
    )
    if rc != 0:
        raise RuntimeError("lr_sgr_plane failed")
    if want_var:
        return sets, xqd, sse, var
    return sets, xqd, sse


def rgb_to_ycbcr(rgb: np.ndarray, depth: int, kr: float, kb: float,
                  n_threads: int = 1) -> np.ndarray:
    """Threaded RGB->YCbCr, bit-identical to the numpy host path
    (colorspace.rgb_to_ycbcr_host; f32 op-order preserved, contraction
    off)."""
    lib = _load()
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    out = np.empty(rgb.shape, dtype=np.int32)
    n = rgb.size // 3
    rc = lib.cs_rgb_to_ycbcr(
        rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n, depth, float(kr), float(kb), int(n_threads),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc != 0:
        raise RuntimeError("cs_rgb_to_ycbcr failed")
    return out


def cdef_search(inp: np.ndarray, src: np.ndarray, mi_rows: int,
                mi_cols: int, bit_depth: int, damping: int,
                pri_cands: np.ndarray, skip: np.ndarray, dirs: np.ndarray,
                vars_: np.ndarray, vis: tuple, n_threads: int = 1,
                sub: int = 1, fast_sec: int = 0, per_sb: int = 0):
    """SSE deltas (filter vs passthrough, visible crop) for every
    (pri_cands[i], sec[j]) combo with sec in {0, 1, 2, 4}, one threaded
    pass. `sub` subsamples the scored 8x8 blocks (2: checkerboard, 4:
    quarter grid) and `fast_sec` restricts the secondary strengths to
    {0, 2} (skipped combos report delta 0) for fast presets. Returns
    (acc_y, acc_uv) as (n_pri, 4) float64; acc_uv is None for
    monochrome."""
    lib = _load()
    P, Hp, Wp = inp.shape
    assert inp.dtype == np.int32 and inp.flags["C_CONTIGUOUS"]
    pc = np.ascontiguousarray(pri_cands, dtype=np.int32)
    nsb = (((mi_rows + 15) >> 4) * ((mi_cols + 15) >> 4)) if per_sb else 1
    shape = (nsb, len(pc), 4) if per_sb else (len(pc), 4)
    acc_y = np.zeros(shape, np.float64)
    acc_uv = np.zeros(shape, np.float64) if P == 3 else None
    i32 = ctypes.POINTER(ctypes.c_int32)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    f64 = ctypes.POINTER(ctypes.c_double)
    rc = lib.of_cdef_search(
        inp.ctypes.data_as(i32), src.ctypes.data_as(i32),
        P, Hp, Wp, mi_rows, mi_cols, bit_depth, damping,
        pc.ctypes.data_as(i32), len(pc),
        skip.ctypes.data_as(u8), dirs.ctypes.data_as(u8),
        vars_.ctypes.data_as(i32),
        int(vis[0]), int(vis[1]), int(n_threads), int(sub),
        int(fast_sec), int(per_sb),
        acc_y.ctypes.data_as(f64),
        acc_uv.ctypes.data_as(f64) if acc_uv is not None else None,
    )
    if rc != 0:
        raise RuntimeError("of_cdef_search failed")
    return acc_y, acc_uv


def inv_txfm_exact(levels: np.ndarray, txw: int, txh: int, dc_q: int,
                   ac_q: int, bit_depth: int, v_adst: int = 0,
                   h_adst: int = 0) -> np.ndarray:
    """Decoder-bit-exact inverse transform (dequant + integer inverse
    DCT/ADST). levels: (ch, cw) coded area; returns (txh, txw) residual."""
    lib = _load()
    levels = np.ascontiguousarray(levels, dtype=np.int32)
    ch, cw = levels.shape
    out = np.empty((txh, txw), dtype=np.int32)
    rc = lib.tc_inv_txfm(
        levels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), ch, cw,
        txw, txh, dc_q, ac_q, bit_depth, v_adst, h_adst,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc != 0:
        raise RuntimeError("tc_inv_txfm failed")
    return out


def itx_clamp_violations(reset: bool = True) -> int:
    """7.13.3 clamp-tripwire counter (see tilecoder.cpp inv_txfm_exact):
    with CAVIF_TPU_ITX_CLAMP_CHECK set, counts intermediates that left
    the signed (BitDepth+8)-bit window the decoders clip to — any
    nonzero value means the unclamped inverse would silently diverge
    from real decoders. reset also re-reads the env gate."""
    return int(_load().tc_itx_clamp_violations(1 if reset else 0))


def op_arity_native(op: int) -> int:
    """The compiled library's stride for an opcode (contract check)."""
    return int(_load().tc_op_arity(op))


def cand_modes_native() -> tuple:
    """The compiled library's pass-1 candidate order (contract check)."""
    lib = _load()
    out = []
    i = 0
    while True:
        v = int(lib.tc_cand_mode(i))
        if v < 0:
            return tuple(out)
        out.append(v)
        i += 1
