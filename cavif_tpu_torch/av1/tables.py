"""AV1 spec constant tables: default CDFs, quant lookups, scans, cos/sin.

Loaded from data/tables.npz (produced by tools/extract_tables.py, which
recovers the spec constants from the system libaom by structural signature
and validates them). CDFs are in inverted (icdf) layout: row[i] =
32768 - cdf(i), strictly decreasing, row[N-1] == 0; trailing entries are
padding/adaptation counters and are sliced off by the accessors here.

Reference parity: these are the tables rav1e bakes in (the reference uses
them through rav1e's EC; /root/reference/ravif/src/av1encoder.rs:748-771).
"""

from __future__ import annotations

from functools import lru_cache
from pathlib import Path

import numpy as np

_DATA = Path(__file__).resolve().parent / "data" / "tables.npz"


@lru_cache(maxsize=1)
def _npz():
    # every member read once, up front: an NpzFile reads its zip archive
    # on each access, which is not safe from several threads at once (the
    # colour/alpha stream threads and the batch workers build FrameEncoders
    # concurrently)
    with np.load(_DATA) as f:
        return {k: f[k] for k in f.files}


@lru_cache(maxsize=None)
def _as_lists(key: str, nsym: int):
    """Table rows as tuples of the first nsym icdf entries (for the EC)."""
    arr = _npz()[key]
    flat = arr.reshape(-1, arr.shape[-1])
    rows = [tuple(int(x) for x in row[:nsym]) for row in flat]
    shape = arr.shape[:-1]
    out = np.empty(shape, dtype=object)
    out.reshape(-1)[:] = rows
    return out


@lru_cache(maxsize=None)
def get(key: str) -> np.ndarray:
    """Cached: npz member access decompresses on every read otherwise."""
    return _npz()[key]


# -- coefficient coding ------------------------------------------------------

def base_cdf(qctx, txs_ctx, plane, ctx):
    return _as_lists("base_cdf", 4)[qctx, txs_ctx, plane, ctx]


def base_eob_cdf(qctx, txs_ctx, plane, ctx):
    return _as_lists("base_eob_cdf", 3)[qctx, txs_ctx, plane, ctx]


def br_cdf(qctx, txs_ctx, plane, ctx):
    return _as_lists("br_cdf", 4)[qctx, txs_ctx, plane, ctx]


def eob_pt_cdf(eob_max, qctx, plane, ctx):
    nsym = {16: 5, 32: 6, 64: 7, 128: 8, 256: 9, 512: 10, 1024: 11}[eob_max]
    return _as_lists(f"eob_pt_{eob_max}_cdf", nsym)[qctx, plane, ctx]


def eob_extra_cdf(qctx, txs_ctx, plane, ctx):
    return _as_lists("eob_extra_cdf", 2)[qctx, txs_ctx, plane, ctx]


def txb_skip_cdf(qctx, txs_ctx, ctx):
    return _as_lists("txb_skip_cdf", 2)[qctx, txs_ctx, ctx]


def dc_sign_cdf(qctx, plane, ctx):
    return _as_lists("dc_sign_cdf", 2)[qctx, plane, ctx]


# -- modes / partition -------------------------------------------------------

def partition_cdf(bsl_idx, ctx):
    """bsl_idx: 0..4 for block sizes 8,16,32,64,128."""
    nsym = 4 if bsl_idx == 0 else (8 if bsl_idx == 4 else 10)
    return _as_lists("partition_cdf", nsym)[bsl_idx * 4 + ctx]


_WIENER_RESTORE_CDF = None
_SGRPROJ_RESTORE_CDF = None
_SWITCHABLE_RESTORE_CDF = None


def wiener_restore_cdf():
    """use_wiener binary CDF; libaom default_wiener_restore_cdf
    AOM_CDF2(11570), inverted layout like the other accessors ([icdf0, 0];
    the Cdfs store appends its own adaptation counter)."""
    global _WIENER_RESTORE_CDF
    if _WIENER_RESTORE_CDF is None:
        _WIENER_RESTORE_CDF = [32768 - 11570, 0]
    return _WIENER_RESTORE_CDF


def sgrproj_restore_cdf():
    """use_sgrproj binary CDF; libaom default_sgrproj_restore_cdf
    AOM_CDF2(16855) (value present in the binary .rodata; validated
    end-to-end against dav1d in tests/test_sgr.py)."""
    global _SGRPROJ_RESTORE_CDF
    if _SGRPROJ_RESTORE_CDF is None:
        _SGRPROJ_RESTORE_CDF = [32768 - 16855, 0]
    return _SGRPROJ_RESTORE_CDF


def switchable_restore_cdf():
    """restoration_type 3-symbol CDF; libaom default_switchable_restore_cdf
    AOM_CDF3(9413, 22581) (validated end-to-end against dav1d)."""
    global _SWITCHABLE_RESTORE_CDF
    if _SWITCHABLE_RESTORE_CDF is None:
        _SWITCHABLE_RESTORE_CDF = [32768 - 9413, 32768 - 22581, 0]
    return _SWITCHABLE_RESTORE_CDF


def kf_y_mode_cdf(above_ctx, left_ctx):
    return _as_lists("kf_y_mode_cdf", 13)[above_ctx, left_ctx]


def uv_mode_cdf(cfl_allowed, y_mode):
    return _as_lists("uv_mode_cdf", 14 if cfl_allowed else 13)[
        1 if cfl_allowed else 0, y_mode
    ]


def skip_cdf(ctx):
    return _as_lists("skip_cdf", 2)[ctx]


def cfl_sign_cdf():
    """cfl_alpha_signs joint symbol (8 = 3x3 sign pairs minus both-zero)."""
    return tuple(int(x) for x in get("cfl_sign_cdf")[:8])


def cfl_alpha_cdf(ctx):
    """cfl_alpha magnitude symbol (16-ary, coded alpha-1), 6 contexts."""
    return tuple(int(x) for x in get("cfl_alpha_cdf")[ctx][:16])


def angle_delta_cdf(dir_mode_idx):
    return _as_lists("angle_delta_cdf", 7)[dir_mode_idx]


def tx_size_cdf(cat, ctx):
    return _as_lists("tx_size_cdf", 2 if cat == 0 else 3)[cat, ctx]


def intra_ext_tx_cdf(set_idx, tx_sqr, intra_mode):
    """set_idx 1 (DTT4_IDTX_1DDCT, 7 syms) or 2 (DTT4_IDTX, 5 syms);
    tx_sqr = Tx_Size_Sqr index 0..3; intra_mode = luma mode."""
    nsym = 7 if set_idx == 1 else 5
    return _as_lists("intra_ext_tx_cdf", nsym)[set_idx - 1, tx_sqr, intra_mode]


# -- quant -------------------------------------------------------------------

def dc_q(qindex: int, bit_depth: int) -> int:
    return int(_npz()[f"dc_q_{bit_depth}"][qindex])


def ac_q(qindex: int, bit_depth: int) -> int:
    return int(_npz()[f"ac_q_{bit_depth}"][qindex])


@lru_cache(maxsize=None)
def trellis_cost(which: str) -> np.ndarray:
    """uint16 symbol-cost tables in 1/128-bit units derived from the
    default (frame-initial) coefficient CDFs — the rate model of the
    context-aware trellis quantization pass. Computed once here and
    uploaded to the native tilecoder verbatim so both backends price
    identically (no cross-language log2 rounding drift).

    which: "base_cdf" (4 syms), "base_eob_cdf" (3), "br_cdf" (4);
    output shape = the CDF table's shape with the last axis trimmed to
    nsym. cost[sym] = round((15 - log2(P(sym)*32768)) * 128)."""
    nsym = {"base_cdf": 4, "base_eob_cdf": 3, "br_cdf": 4}[which]
    raw = get(which)
    icdf = raw.reshape(-1, raw.shape[-1])[:, :nsym].astype(np.int64)
    lo = icdf.copy()
    lo[:, -1] = 0
    hi = np.empty_like(icdf)
    hi[:, 0] = 32768
    hi[:, 1:] = icdf[:, :-1]
    p = np.maximum(hi - lo, 1)
    cost = np.rint((15.0 - np.log2(p)) * 128.0).astype(np.uint16)
    return np.ascontiguousarray(cost.reshape(raw.shape[:-1] + (nsym,)))


# -- scans / context offsets -------------------------------------------------

@lru_cache(maxsize=None)
def scan(w: int, h: int) -> np.ndarray:
    """Forward diagonal (default) scan for a w x h coded coefficient area."""
    return _npz()[f"scan_{w}x{h}"]


@lru_cache(maxsize=None)
def nz_off(w: int, h: int) -> np.ndarray:
    """Coeff-base 2D context offsets, raster (h, w) for the coded area."""
    return _npz()[f"nz_off_{w}x{h}"]


def cospi(bit: int) -> np.ndarray:
    return _npz()["cospi"][bit - 10]


def sinpi(bit: int) -> np.ndarray:
    return _npz()["sinpi"][bit - 10]
