"""The port's device deblock and CDEF (cavif_tpu_torch.ops.device_filters)
on the CPU, held EXACTLY against two things on the same inputs: the
port's own native C++ filters (its copy of native/tilecoder.cpp, through
the host encoder path), and the JAX package's device functions
(cavif_tpu.ops.device_filters, run on the JAX CPU backend as its own tests
run them).

Every stage is integer arithmetic on all three sides, so equality is
exact: any mismatch is a bug, not noise. The cases are those of
tests/test_device_filters.py."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from cavif_tpu.ops import device_filters as ref_df
from cavif_tpu_torch import native
from cavif_tpu_torch.av1.config import AV1Config
from cavif_tpu_torch.av1.encoder import FrameEncoder
from cavif_tpu_torch.av1.speed import SpeedTweaks
from cavif_tpu_torch.ops import device_filters as df


def _img(H, W, seed, amp=40.0):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:H, 0:W].astype(np.float64)
    lum = np.clip(
        300 + 330 * np.sin(x / 17.0) * np.cos(y / 23.0)
        + rng.normal(0, amp, (H, W)),
        0, 1023,
    )
    return np.stack(
        [lum, np.clip(lum * 0.9 + 30, 0, 1023),
         np.clip(lum * 1.1 - 20, 0, 1023)], -1
    ).astype(np.int32)


def _cfg(H, W, q, speed, mono):
    tw = dataclasses.replace(
        SpeedTweaks.from_preset(speed, q),
        fast_deblock=False, cdef=False, lrf=False,
    )
    return tw, AV1Config(
        width=W, height=H, bit_depth=10, quantizer=q, tweaks=tw,
        chroma_sampling="400" if mono else "444", full_range=True,
        matrix_coefficients=None, threads=1, device="off",
    )


def _encoded_frame(H, W, q, seed, speed=4, mono=False):
    """Host-path encode with the deblock simulation on (cdef/lrf off so
    _filtered_stack is exactly the deblocked frame)."""
    _tw, cfg = _cfg(H, W, q, speed, mono)
    img = _img(H, W, seed)
    if mono:
        img = img[..., 0]
    fe = FrameEncoder(img, cfg)
    fe.encode()
    return fe


def _sub(speed):
    return 1 if speed <= 2 else (2 if speed <= 3 else 4)


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype,
                                                       b.dtype)
    assert np.array_equal(a, b), what


# q180 forces high levels; 101x129 exercises partial-SB overhang; the
# speed-2 case runs the denser search grid (row_sub 2)
DEBLOCK_CASES = [
    ((192, 256), 140, 1, 4, False),
    ((101, 129), 180, 2, 4, False),
    ((96, 96), 100, 3, 2, False),
    ((128, 64), 150, 4, 4, True),
]


@pytest.mark.parametrize("dims,q,seed,speed,mono", DEBLOCK_CASES)
def test_deblock_matches_native_and_reference(dims, q, seed, speed, mono):
    H, W = dims
    fe = _encoded_frame(H, W, q, seed, speed=speed, mono=mono)
    assert fe._filtered_stack is not None, "host deblock did not run"
    rec, src = fe._recon_full(), fe._src_stack()
    kw = dict(bit_depth=fe.bit_depth, mi_rows=fe.mi_rows,
              mi_cols=fe.mi_cols, vis=(W, H), row_sub=_sub(speed))
    levels, stack, deltas = df.deblock_device(
        rec, src, fe._filter_maps, fe._lf_hint(), device="cpu", **kw)
    assert levels == tuple(fe._lf_levels), (levels, fe._lf_levels)
    _same(stack, fe._filtered_stack, "stack vs native")
    r_levels, r_stack, r_deltas = ref_df.deblock_device(
        rec, src, fe._filter_maps, fe._lf_hint(), **kw)
    assert levels == r_levels
    _same(stack, r_stack, "stack vs jax")
    _same(deltas, r_deltas, "deltas vs jax")


def test_deblock_zero_levels():
    """With src == rec no candidate can strictly improve (every filter
    change has delta >= 0), so the search must pick level 0 everywhere
    and the apply must return the frame untouched."""
    fe = _encoded_frame(96, 96, 140, 7)
    rec = fe._recon_full()
    kw = dict(bit_depth=fe.bit_depth, mi_rows=fe.mi_rows,
              mi_cols=fe.mi_cols, vis=(96, 96), row_sub=4)
    levels, stack, deltas = df.deblock_device(
        rec, rec, fe._filter_maps, fe._lf_hint(), device="cpu", **kw)
    assert levels == (0, 0, 0, 0)
    assert (deltas >= 0).all()
    assert np.array_equal(stack, rec)
    _same(deltas, ref_df.deblock_device(
        rec, rec, fe._filter_maps, fe._lf_hint(), **kw)[2], "deltas")


def _cdef_three_ways(dims, q, seed, speed=4, mono=False):
    """Run the host CDEF chain (encoder._cdef_apply), the port on the CPU
    and the JAX function on identical inputs; return all three."""
    H, W = dims
    tw, cfg = _cfg(H, W, q, speed, mono)
    img = _img(H, W, seed)
    if mono:
        img = img[..., 0]
    fe = FrameEncoder(img, cfg)
    fe.encode()
    pre = (fe._filtered_stack if fe._filtered_stack is not None
           else fe._recon_full()).copy()
    fe.cfg = dataclasses.replace(cfg, tweaks=dataclasses.replace(
        tw, cdef=True))
    host_y, host_uv, damping = fe._cdef_apply()
    host_stack = fe._filtered_stack
    pri = (FrameEncoder.CDEF_PRI if speed <= 3
           else FrameEncoder.CDEF_PRI_FAST)
    args = (pre, fe._src_stack(), fe._filter_maps[0], damping)
    kw = dict(bit_depth=fe.bit_depth, mi_rows=fe.mi_rows,
              mi_cols=fe.mi_cols, vis=(W, H), sub=_sub(speed),
              fast_sec=1 if speed >= 4 else 0, cands=(0,) + pri)
    dev = df.cdef_device(*args, device="cpu", **kw)
    ref = ref_df.cdef_device(*args, **kw)
    return fe, pre, (host_y, host_uv, host_stack), dev, ref


CDEF_CASES = [
    ((192, 256), 140, 1, 4, False),
    ((101, 129), 180, 2, 4, False),
    ((96, 96), 170, 3, 2, False),
    ((128, 64), 160, 4, 4, True),
]


@pytest.mark.parametrize("dims,q,seed,speed,mono", CDEF_CASES)
def test_cdef_matches_native_and_reference(dims, q, seed, speed, mono):
    _fe, _pre, host, dev, ref = _cdef_three_ways(dims, q, seed, speed,
                                                 mono)
    host_y, host_uv, host_stack = host
    strengths, out = dev[0], dev[1]
    uncode = lambda s: 4 if s == 3 else s
    hy = (host_y[0][0], uncode(host_y[0][1])) if host_y else (0, 0)
    huv = (host_uv[0][0], uncode(host_uv[0][1])) if host_uv else (0, 0)
    assert (strengths[0], strengths[1]) == hy, (strengths, host_y)
    assert (strengths[2], strengths[3]) == huv, (strengths, host_uv)
    _same(out, host_stack, "stack vs native")
    assert strengths == ref[0]
    for name, a, b in zip(("out", "acc_y", "acc_uv", "dirs", "vars"),
                          dev[1:], ref[1:]):
        _same(a, b, name + " vs jax")


def test_cdef_acc_matches_native_search():
    """The per-combo SSE-delta tables and the direction/variance grids
    must equal the C++ search's (exact integers on both sides)."""
    fe, pre, _host, dev, ref = _cdef_three_ways((160, 160), 150, 9)
    _strengths, _out, acc_y, acc_uv, dirs, vars_ = dev
    damping = min(6, 3 + (fe.base_q >> 6))
    cands = np.array((0,) + FrameEncoder.CDEF_PRI_FAST, np.int32)
    hd, hv = native.cdef_dirs(
        np.ascontiguousarray(pre[0]), fe.mi_rows, fe.mi_cols,
        fe.bit_depth, n_threads=2,
    )
    assert np.array_equal(dirs, np.asarray(hd).reshape(dirs.shape))
    assert np.array_equal(vars_, np.asarray(hv).reshape(vars_.shape))
    acc_y_h, acc_uv_h = native.cdef_search(
        pre, fe._src_stack(), fe.mi_rows, fe.mi_cols, fe.bit_depth,
        damping, cands, fe._filter_maps[0], hd, hv,
        (fe.cfg.width, fe.cfg.height), 2, 4, 1,
    )
    assert np.array_equal(acc_y.astype(np.float64), acc_y_h)
    assert np.array_equal(acc_uv.astype(np.float64), acc_uv_h)
    _same(acc_y, ref[2], "acc_y vs jax")


def _dir_costs(block):
    """The eight CDEF direction costs of one 8x8 block (spec 7.15.2),
    straight from the definition."""
    div = (0, 840, 420, 280, 210, 168, 140, 120, 105)
    parts = np.zeros((8, 15), np.int64)
    for i in range(8):
        for j in range(8):
            x = int(block[i, j])
            for d, b in enumerate((i + j, i + (j >> 1), i,
                                   3 + i - (j >> 1), 7 + i - j,
                                   3 - (i >> 1) + j, j, (i >> 1) + j)):
                parts[d, b] += x
    sq = parts * parts
    cost = []
    for d in range(8):
        if d in (2, 6):
            c = 105 * sq[d, :8].sum()
        elif d in (0, 4):
            c = 105 * sq[d, 7] + sum(div[i + 1] * (sq[d, i] + sq[d, 14 - i])
                                     for i in range(7))
        else:
            c = sum(div[min(2 * (i + 1), 2 * (11 - i), 8)] * sq[d, i]
                    for i in range(11))
        cost.append(int(c))
    return cost


def test_cdef_direction_ties_take_the_first_maximum():
    """Flat blocks (all eight costs 0) and transpose-symmetric blocks
    (rows and columns sum alike, so directions 2 and 6 tie) must pick the
    first maximal direction, as the C++ strict > does: the port's argmax
    equals native.cdef_dirs and the JAX function on such a plane."""
    rng = np.random.default_rng(5)
    blocks = []
    for b in range(16):
        if b % 4 == 0:
            blk = np.full((8, 8), 512)
        else:
            a = rng.integers(-60, 60, 8)
            blk = 512 + 4 * (a[:, None] + a[None, :])
        blocks.append(blk)
    plane = np.block([blocks[r * 4:(r + 1) * 4] for r in range(4)]).astype(
        np.int32)
    ties = 0
    for blk in blocks:
        x = (blk >> 2) - 128
        c = _dir_costs(x)
        ties += c.count(max(c)) > 1
    assert ties >= 8, ties  # the plane really holds tied maxima
    mi = 32 // 4
    dirs, vars_ = df._cdef_dirs_dev(torch.from_numpy(plane), 4, 4, 10)
    hd, hv = native.cdef_dirs(plane, mi, mi, 10, n_threads=1)
    assert np.array_equal(dirs.numpy(), np.asarray(hd).reshape(4, 4))
    assert np.array_equal(vars_.numpy(), np.asarray(hv).reshape(4, 4))
    with jax.enable_x64():
        rd, _rv = ref_df._cdef_dirs_dev(plane, 4, 4, 10)
    assert np.array_equal(dirs.numpy(), np.asarray(rd))
    for blk, d in zip(blocks, dirs.numpy().reshape(-1)):
        c = _dir_costs((blk >> 2) - 128)
        assert d == c.index(max(c))


def test_entry_points_raise_without_the_card():
    """device=None names the card: without CUDA the entry points raise
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    fe = _encoded_frame(64, 64, 140, 3)
    rec = fe._recon_full()
    with pytest.raises(RuntimeError, match="cuda"):
        df.deblock_device(rec, rec, fe._filter_maps, 4,
                          bit_depth=10, mi_rows=fe.mi_rows,
                          mi_cols=fe.mi_cols, vis=(64, 64), row_sub=4)
