"""The port's device deblock and CDEF (cavif_tpu_torch.ops.device_filters)
on the test device (cavif_tpu_torch.testing: the CPU, or the card), held
EXACTLY against the port's own native C++ filters (its copy of
native/tilecoder.cpp, through the host encoder path) and, on the CPU,
against the JAX package's device functions (cavif_tpu.ops.device_filters,
run on the JAX CPU backend as its own tests run them; marker
jax_reference), on the same inputs.

Every stage is integer arithmetic on all three sides, so equality is
exact: any mismatch is a bug, not noise. The cases are those of
tests/test_device_filters.py."""

import contextlib
import dataclasses
from functools import lru_cache

import numpy as np
import pytest
import torch

from cavif_tpu_torch import native
from cavif_tpu_torch.av1.config import AV1Config
from cavif_tpu_torch.av1.encoder import FrameEncoder
from cavif_tpu_torch.av1.speed import SpeedTweaks
from cavif_tpu_torch.ops import device_filters as df
from cavif_tpu_torch.testing import device_under_test
from cavif_tpu_torch.utils import trace


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Torch on one thread: the suite runs several test files at once, and
    each file's OpenMP teams would oversubscribe the cores many times
    over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# what the port's output is held against: the C++, or the JAX package
REFS = ["native", pytest.param("jax", marks=pytest.mark.jax_reference)]


def _ref_df():
    from cavif_tpu.ops import device_filters as ref_df

    return ref_df


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


@lru_cache(maxsize=None)
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


@lru_cache(maxsize=None)
def _port_deblock(dims, q, seed, speed, mono, device):
    """The port's deblock_device of a DEBLOCK_CASES frame on `device` (both
    of a case's references read one run)."""
    H, W = dims
    fe = _encoded_frame(H, W, q, seed, speed=speed, mono=mono)
    kw = dict(bit_depth=fe.bit_depth, mi_rows=fe.mi_rows,
              mi_cols=fe.mi_cols, vis=(W, H), row_sub=_sub(speed))
    return df.deblock_device(fe._recon_full(), fe._src_stack(),
                             fe._filter_maps, fe._lf_hint(), device=device,
                             **kw)


@pytest.mark.parametrize("ref", REFS)
@pytest.mark.parametrize("dims,q,seed,speed,mono", DEBLOCK_CASES)
def test_deblock_matches_native_and_reference(dims, q, seed, speed, mono,
                                              ref):
    H, W = dims
    fe = _encoded_frame(H, W, q, seed, speed=speed, mono=mono)
    assert fe._filtered_stack is not None, "host deblock did not run"
    rec, src = fe._recon_full(), fe._src_stack()
    kw = dict(bit_depth=fe.bit_depth, mi_rows=fe.mi_rows,
              mi_cols=fe.mi_cols, vis=(W, H), row_sub=_sub(speed))
    dev = "cpu" if ref == "jax" else device_under_test()
    levels, stack, deltas = _port_deblock(dims, q, seed, speed, mono, dev)
    if ref == "native":
        assert levels == tuple(fe._lf_levels), (levels, fe._lf_levels)
        _same(stack, fe._filtered_stack, "stack vs native")
        return
    r_levels, r_stack, r_deltas = _ref_df().deblock_device(
        rec, src, fe._filter_maps, fe._lf_hint(), **kw)
    assert levels == r_levels
    _same(stack, r_stack, "stack vs jax")
    _same(deltas, r_deltas, "deltas vs jax")


@pytest.mark.parametrize("ref", REFS)
def test_deblock_zero_levels(ref):
    """With src == rec no candidate can strictly improve (every filter
    change has delta >= 0), so the search must pick level 0 everywhere
    and the apply must return the frame untouched; the deltas equal the
    JAX function's."""
    fe = _encoded_frame(96, 96, 140, 7)
    rec = fe._recon_full()
    kw = dict(bit_depth=fe.bit_depth, mi_rows=fe.mi_rows,
              mi_cols=fe.mi_cols, vis=(96, 96), row_sub=4)
    dev = "cpu" if ref == "jax" else device_under_test()
    levels, stack, deltas = df.deblock_device(
        rec, rec, fe._filter_maps, fe._lf_hint(), device=dev, **kw)
    if ref == "jax":
        _same(deltas, _ref_df().deblock_device(
            rec, rec, fe._filter_maps, fe._lf_hint(), **kw)[2], "deltas")
        return
    assert levels == (0, 0, 0, 0)
    assert (deltas >= 0).all()
    assert np.array_equal(stack, rec)


@lru_cache(maxsize=None)
def _cdef_host(dims, q, seed, speed=4, mono=False):
    """The host CDEF chain (encoder._cdef_apply) on a host encode: (fe,
    pre-CDEF stack, (host_y, host_uv, host_stack), cdef_device's
    arguments and keywords)."""
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
    return fe, pre, (host_y, host_uv, host_stack), args, kw


def _cdef_three_ways(dims, q, seed, speed=4, mono=False, ref="native"):
    """The host CDEF chain, the port (on the test device, or on the CPU
    for ref="jax") and for ref="jax" the JAX function on identical inputs;
    returns all three (the JAX result None for ref="native")."""
    fe, pre, host, args, kw = _cdef_host(dims, q, seed, speed, mono)
    if ref == "jax":
        return (fe, pre, host, _port_cdef(dims, q, seed, speed, mono, "cpu"),
                _ref_df().cdef_device(*args, **kw))
    return fe, pre, host, _port_cdef(dims, q, seed, speed, mono,
                                     device_under_test()), None


@lru_cache(maxsize=None)
def _port_cdef(dims, q, seed, speed, mono, device):
    """The port's cdef_device on _cdef_host's inputs on `device`."""
    _fe, _pre, _host, args, kw = _cdef_host(dims, q, seed, speed, mono)
    return df.cdef_device(*args, device=device, **kw)


CDEF_CASES = [
    ((192, 256), 140, 1, 4, False),
    ((101, 129), 180, 2, 4, False),
    ((96, 96), 170, 3, 2, False),
    ((128, 64), 160, 4, 4, True),
]


@pytest.mark.parametrize("ref", REFS)
@pytest.mark.parametrize("dims,q,seed,speed,mono", CDEF_CASES)
def test_cdef_matches_native_and_reference(dims, q, seed, speed, mono, ref):
    _fe, _pre, host, dev, jx = _cdef_three_ways(dims, q, seed, speed,
                                                mono, ref)
    strengths = dev[0]
    if ref == "jax":
        assert strengths == jx[0]
        for name, a, b in zip(("out", "acc_y", "acc_uv", "dirs", "vars"),
                              dev[1:], jx[1:]):
            _same(a, b, name + " vs jax")
        return
    host_y, host_uv, host_stack = host
    out = dev[1]
    uncode = lambda s: 4 if s == 3 else s
    hy = (host_y[0][0], uncode(host_y[0][1])) if host_y else (0, 0)
    huv = (host_uv[0][0], uncode(host_uv[0][1])) if host_uv else (0, 0)
    assert (strengths[0], strengths[1]) == hy, (strengths, host_y)
    assert (strengths[2], strengths[3]) == huv, (strengths, host_uv)
    _same(out, host_stack, "stack vs native")


@pytest.mark.parametrize("ref", REFS)
def test_cdef_acc_matches_native_search(ref):
    """The per-combo SSE-delta tables and the direction/variance grids
    must equal the C++ search's (exact integers on both sides), and the
    luma table the JAX function's."""
    fe, pre, _host, dev, jx = _cdef_three_ways((160, 160), 150, 9, ref=ref)
    _strengths, _out, acc_y, acc_uv, dirs, vars_ = dev
    if ref == "jax":
        _same(acc_y, jx[2], "acc_y vs jax")
        return
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


@pytest.mark.parametrize("ref", REFS)
def test_cdef_direction_ties_take_the_first_maximum(ref):
    """Flat blocks (all eight costs 0) and transpose-symmetric blocks
    (rows and columns sum alike, so directions 2 and 6 tie) must pick the
    first maximal direction, as the C++ strict > does: the port's argmax
    equals native.cdef_dirs and the definition on such a plane (on the
    test device), and the JAX function's (on the CPU)."""
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
    if ref == "jax":
        import jax

        dirs, _ = df._cdef_dirs_dev(torch.from_numpy(plane), 4, 4, 10)
        with jax.enable_x64():
            rd, _rv = _ref_df()._cdef_dirs_dev(plane, 4, 4, 10)
        assert np.array_equal(dirs.numpy(), np.asarray(rd))
        return
    dirs, vars_ = (t.cpu() for t in df._cdef_dirs_dev(
        torch.from_numpy(plane).to(device_under_test()), 4, 4, 10))
    hd, hv = native.cdef_dirs(plane, mi, mi, 10, n_threads=1)
    assert np.array_equal(dirs.numpy(), np.asarray(hd).reshape(4, 4))
    assert np.array_equal(vars_.numpy(), np.asarray(hv).reshape(4, 4))
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


# ---------------------------------------------------------------------------
# The deblock kernel (csrc/deblock.cu through df.deblock_pass) against the
# plain pass (df._deblock_axis) on the card, bit for bit; on the CPU the
# wrapper takes the plain pass, and the level pick runs on either.
# ---------------------------------------------------------------------------


def _blocky_plane(rng, H, W, bit_depth):
    """A plane of 4x4 blocks on a random walk, each flat, smooth or noisy,
    with small steps between them, so that every filter of every size
    fires somewhere at some level."""
    s, maxv = bit_depth - 8, (1 << bit_depth) - 1
    bh, bw = -(-H // 4), -(-W // 4)
    walk = (rng.integers(-3, 4, (bh, bw)).cumsum(1)
            + rng.integers(-3, 4, (bh, 1)).cumsum(0))
    amp = rng.choice([0, 0, 1, 3, 20], (bh, bw))
    up = lambda a: np.repeat(np.repeat(a, 4, 0), 4, 1)[:H, :W]
    noise = np.rint(rng.standard_normal((H, W)) * up(amp))
    v = maxv // 2 + ((up(walk) + noise) * (1 << s))
    return np.clip(v, 0, maxv).astype(np.int32)


def _edge_pad(a, axis, n):
    """a extended to n along `axis` by repeating its last index: what the
    kernel's clamped window reads past the plane."""
    idx = np.minimum(np.arange(n), a.shape[axis] - 1)
    return np.take(a, idx, axis=axis)


@contextlib.contextmanager
def _traced():
    """Tracing on, its counters started afresh, for the block; off after."""
    trace.set_enabled(True)
    trace.set_accumulate(True)
    try:
        yield
    finally:
        trace.set_accumulate(False)
        trace.set_enabled(False)


def _kernel_vs_plain(plane, src, tx, edge, levels, bit_depth, luma, vis,
                     row_sub, horizontal):
    """deblock_pass (the kernel) and _deblock_axis (plain) on the card on
    the same inputs: equal planes and deltas. Where the edge axis is not a
    multiple of 4 (the plain composition's unit) the plain pass runs on
    the plane extended by edge repetition, cut back after."""
    dev = "cuda"
    mi_rows, mi_cols = tx.shape
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    lvl = t(np.asarray(levels, np.int32))
    before = df.LAUNCHES["deblock"]
    out, delta = df.deblock_pass(
        t(plane), None if src is None else t(src), t(tx), t(edge),
        lvl.reshape(-1, 1, 1), bit_depth, mi_rows, mi_cols, luma, vis,
        row_sub, horizontal=horizontal)
    assert df.LAUNCHES["deblock"] == before + 1
    axis = -2 if horizontal else -1
    n = plane.shape[axis]
    n4 = -(-n // 4) * 4
    pp = _edge_pad(plane, axis, n4)
    ps = None if src is None else _edge_pad(src, axis, n4)
    ref, ref_delta = df._deblock_axis(
        t(pp), None if ps is None else t(ps), t(tx), t(edge),
        lvl.reshape(-1, 1, 1), bit_depth, mi_rows, mi_cols, luma, vis,
        row_sub, horizontal=horizontal)
    ref = ref[..., :n, :] if horizontal else ref[..., :n]
    torch.cuda.synchronize()
    assert out.shape == ref.shape, (out.shape, ref.shape)
    bad = (out != ref).nonzero()
    assert bad.shape[0] == 0, ("planes differ", bad[:8].tolist())
    assert torch.equal(delta, ref_delta), (delta.tolist(),
                                           ref_delta.tolist())
    return ref, ref_delta


# (H, W, mi_rows, mi_cols, bit_depth, levels, row_sub, luma, horizontal,
#  batched input, crop): random maps, every level count 1-4, both axes,
# both plane kinds, widths not a multiple of 8 (36, 44) or of 4 (22, 38
# along the edge axis), a single mi column or row (no edge), maps smaller
# than the plane and a visible crop
RANDOM_KERNEL_CASES = [
    (64, 96, 16, 24, 10, (4, 8, 10, 63), 4, True, False, False, 0),
    (64, 96, 16, 24, 10, (4, 8, 10, 63), 4, True, True, True, 0),
    (64, 96, 16, 24, 8, (0, 63, 7, 30), 2, False, False, False, 0),
    (64, 96, 16, 24, 8, (0, 63, 7, 30), 2, False, True, True, 0),
    (64, 96, 16, 24, 12, (63,), 1, False, True, False, 0),
    (64, 96, 16, 24, 12, (63,), 1, True, False, True, 0),
    (64, 96, 16, 24, 10, (0,), 1, True, True, False, 0),
    (40, 36, 10, 9, 12, (1, 20, 40, 62), 1, True, False, False, 3),
    (40, 36, 10, 9, 10, (1, 20, 40, 62), 4, False, True, True, 3),
    (38, 44, 10, 11, 10, (40,), 1, True, True, False, 5),
    (38, 44, 10, 11, 10, (12, 50), 2, True, False, True, 5),
    (16, 22, 4, 6, 8, (9, 33, 63), 1, True, False, False, 1),
    (16, 22, 4, 6, 8, (9, 33, 63), 1, False, True, True, 1),
    (32, 4, 8, 1, 10, (10, 20, 30, 63), 4, True, False, False, 0),
    (4, 32, 1, 8, 10, (63,), 1, False, True, False, 0),
    (128, 192, 26, 34, 10, (6, 12, 14, 28), 4, True, False, False, 0),
    (128, 192, 26, 34, 10, (6, 12, 14, 28), 4, True, True, True, 0),
    (128, 192, 26, 34, 10, (9,), 1, False, True, True, 0),
]


@pytest.mark.card
@pytest.mark.parametrize("case", RANDOM_KERNEL_CASES,
                         ids=lambda c: "x".join(map(str, c[:2])) + "-"
                         + "-".join(map(str, c[4:10])))
def test_deblock_kernel_equals_the_plain_pass_on_random_maps(case):
    if device_under_test() != "cuda":
        pytest.skip("the kernel runs on the card (CAVIF_TORCH_TEST_DEVICE="
                    "cuda)")
    (H, W, mi_rows, mi_cols, bd, levels, row_sub, luma, horizontal,
     batched, crop) = case
    rng = np.random.default_rng(H * 1000 + W + bd)
    B = len(levels)
    plane = (np.stack([_blocky_plane(rng, H, W, bd) for _ in range(B)])
             if batched else _blocky_plane(rng, H, W, bd))
    src = _blocky_plane(rng, H, W, bd)
    tx = rng.integers(0, 7, (mi_rows, mi_cols)).astype(np.int32)
    edge = rng.integers(0, 2, (mi_rows, mi_cols)).astype(np.int32)
    vis = (min(W, 4 * mi_cols) - crop, min(H, 4 * mi_rows) - crop)
    for s in (src, None):
        ref, _ = _kernel_vs_plain(plane, s, tx, edge, levels, bd, luma, vis,
                                  row_sub, horizontal)
    n_edges = (mi_rows if horizontal else mi_cols) - 1
    if n_edges > 0 and any(levels):
        # the case filters something
        base = torch.from_numpy(plane).expand(ref.shape)
        assert (ref.cpu() != base).any()


@pytest.mark.card
@pytest.mark.parametrize("dims,q,seed,speed,mono", DEBLOCK_CASES)
def test_deblock_kernel_equals_the_plain_pass_on_encoder_maps(dims, q, seed,
                                                              speed, mono):
    """Every pass of the level search (four candidates at the speed's
    subsample) and of the apply, on the maps build_filter_maps made for a
    host encode, its reconstruction and source."""
    if device_under_test() != "cuda":
        pytest.skip("the kernel runs on the card (CAVIF_TORCH_TEST_DEVICE="
                    "cuda)")
    H, W = dims
    fe = _encoded_frame(H, W, q, seed, speed=speed, mono=mono)
    rec, src = fe._recon_full(), fe._src_stack()
    _skip, txw, txh, ev, eh = (df._filter_grids(a, fe.mi_rows, fe.mi_cols,
                                                "cpu").numpy()
                               for a in fe._filter_maps)
    cands = df._deblock_cands(fe._lf_hint())
    for pl in range(rec.shape[0]):
        g = min(pl, 1)
        for levels, sub in ((cands, _sub(speed)), (cands[2:3], 1)):
            v, _ = _kernel_vs_plain(rec[pl], src[pl], txw[g], ev[g], levels,
                                    fe.bit_depth, pl == 0, (W, H), sub,
                                    False)
            _kernel_vs_plain(v.cpu().numpy(), src[pl], txh[g], eh[g],
                             levels, fe.bit_depth, pl == 0, (W, H), sub,
                             True)


@pytest.mark.card
def test_a_chain_call_launches_the_deblock_kernel_twelve_times():
    """Three planes x (search + apply) x (vertical + horizontal); and the
    search and pick between the uploads and the fetch make no
    synchronising call."""
    if device_under_test() != "cuda":
        pytest.skip("the kernel runs on the card (CAVIF_TORCH_TEST_DEVICE="
                    "cuda)")
    fe = _encoded_frame.__wrapped__(64, 64, 140, 3)
    df.reset_launches()
    with _traced():
        assert df.run_filter_chain(fe) is not None
        assert trace.ACCUM["device_filters.deblock_kernel"] == 1
    assert df.LAUNCHES["deblock"] == 12
    assert tuple(fe._lf_levels) == tuple(_encoded_frame(64, 64, 140,
                                                        3)._lf_levels)
    dev = "cuda"
    grids = [df._filter_grids(a, fe.mi_rows, fe.mi_cols, dev)
             for a in fe._filter_maps[1:]]
    cands = torch.tensor(df._deblock_cands(fe._lf_hint()), dtype=torch.int32,
                         device=dev)
    rec, src = df._upload(fe._recon_full(), dev), df._upload(fe._src_stack(),
                                                             dev)
    kw = dict(bit_depth=fe.bit_depth, mi_rows=fe.mi_rows,
              mi_cols=fe.mi_cols, vis=(64, 64), row_sub=4)
    with torch.inference_mode():
        df._deblock_search_apply(rec, src, *grids, cands, cands, **kw)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            levels, _stack, _deltas = df._deblock_search_apply(
                rec, src, *grids, cands, cands, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert tuple(levels.tolist()) == tuple(fe._lf_levels)


def test_cpu_tensors_take_the_plain_pass():
    fe = _encoded_frame(64, 64, 140, 3)
    before = df.LAUNCHES["deblock"]
    with _traced():
        levels, stack, _deltas = df.deblock_device(
            fe._recon_full(), fe._src_stack(), fe._filter_maps,
            fe._lf_hint(), bit_depth=fe.bit_depth, mi_rows=fe.mi_rows,
            mi_cols=fe.mi_cols, vis=(64, 64), row_sub=4, device="cpu")
        assert "device_filters.deblock_kernel" not in trace.ACCUM
    assert df.LAUNCHES["deblock"] == before
    if device_under_test() == "cpu":
        assert before == 0
    assert levels == tuple(fe._lf_levels)
    _same(stack, fe._filtered_stack, "stack vs native")


def _indexed_levels(dy, du, dv, y_cands, uv_cands):
    """The level pick as it was written with 0-d indices (each read to
    the host on a card): the oracle of _pick_levels."""
    iy = torch.argmin(dy)
    y = torch.where(dy[iy] < 0, y_cands[iy], 0).to(torch.int32)
    if du is None:
        u = v = torch.zeros((), dtype=torch.int32)
    else:
        iu, iv = torch.argmin(du), torch.argmin(dv)
        u = torch.where((y > 0) & (du[iu] < 0), uv_cands[iu], 0)
        v = torch.where((y > 0) & (dv[iv] < 0), uv_cands[iv], 0)
    return torch.stack([y, y, u, v]).to(torch.int32)


@pytest.mark.parametrize("dy,du,dv,hint", [
    ((-5, -9, -9, -2), (-1, -1, 0, 3), (4, -7, -7, -7), 20),  # ties
    ((0, 3, 0, 7), (-4, -2, 0, 0), (-1, 0, 0, 0), 20),  # all dy >= 0
    ((1, 2, 3, 4), (-5, -1, 0, 0), (-2, -9, 0, 0), 40),  # y 0, u/v < 0
    ((-3, -1, 5, -3), None, None, 0),  # one plane; candidates 1, 2, 4, 4
    ((-3, -8, -8, -1), (2, -6, -6, -6), (0, 0, 0, 0), 0),  # padded dup
])
def test_the_level_pick_equals_the_indexed_rule(dy, du, dv, hint):
    t = lambda d: None if d is None else torch.tensor(d, dtype=torch.int64)
    cands = torch.tensor(df._deblock_cands(hint), dtype=torch.int32)
    # as the search stacks them: zero chroma rows for one plane
    zero = (0,) * len(dy)
    deltas = t((dy, du or zero, dv or zero))
    got = df._pick_levels(deltas, cands, cands)
    want = _indexed_levels(t(dy), t(du), t(dv), cands, cands)
    assert got.dtype == torch.int32 and got.shape == (4,)
    assert got.tolist() == want.tolist()


@pytest.mark.parametrize("what", ["levels", "plane", "contiguous", "dtype",
                                  "row_sub"])
def test_the_kernel_wrapper_refuses_what_the_kernel_does_not_take(what):
    """Checked before any launch (meta tensors stand in for the card's)."""
    dev, i32 = "meta", torch.int32
    plane = torch.empty((16, 32), dtype=i32, device=dev)
    maps = torch.empty((4, 8), dtype=i32, device=dev)
    tx = maps
    lvl = torch.empty((4,), dtype=i32, device=dev)
    row_sub = 1
    if what == "levels":
        lvl = torch.empty((5,), dtype=i32, device=dev)
    elif what == "plane":
        plane = torch.empty((3, 16, 32), dtype=i32, device=dev)
    elif what == "contiguous":
        plane = torch.empty((32, 16), dtype=i32, device=dev).T
    elif what == "dtype":
        tx = torch.empty((4, 8), dtype=torch.int64, device=dev)
    else:
        row_sub = 0
    with pytest.raises(ValueError):
        df.deblock_pass(plane, None, tx, maps, lvl, 10, 4, 8, True,
                        (32, 16), row_sub, horizontal=False)
