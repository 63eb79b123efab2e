"""The tile layouts, wrappers and build rule of the two tensor-core pass-1
kernels (K1 csrc/pass1_dir_cost.cu, K2 csrc/pass1_nd_cost.cu).

The kernels read their bf16 constants as ring-stage tiles that ShapeCost
lays out once (pass1_kernels.pack_kt / pack_mk). On the CPU these tests
hold the layouts against the matrices they come from, bit for bit, at
every block shape the kernels serve; ShapeCost built from the reference's
own constant tables must carry the same tiles; the wrappers keep taking
their plain versions on CPU tensors (tiles given or not) and raise on
inputs of the wrong shape or dtype. The kernels themselves are held
against the plain versions on the card by chip_smoke.py."""

import os
import time

import numpy as np
import pytest
import torch

from cavif_tpu_torch.ops import cuda_build
from cavif_tpu_torch.ops import device_pass1 as dp
from cavif_tpu_torch.ops import pass1_kernels as pk
from test_torch_kernels import _bf16_bits, _ref_consts

FUSED_SHAPES = [(s, s) for s in dp.SQ_TIERS] + list(dp.RECT_SHAPES)


@pytest.fixture(scope="module", autouse=True)
def _close_reference_tables():
    """As in test_torch_kernels.py: close the reference's table archive
    when the module is done, so a process pool forked later in this worker
    does not share its file offset."""
    yield
    from cavif_tpu.av1 import tables

    if tables._npz.cache_info().currsize:
        tables._npz().close()
        tables._npz.cache_clear()


def unpack_kt(tiles):
    """The (n2, n2) KT that pack_kt laid out."""
    nch, nk, LT, w = tiles.shape
    KC = w - pk.PAD
    return tiles[..., :KC].permute(1, 3, 0, 2).reshape(nk * KC, nch * LT)


def unpack_mk(tiles, E):
    """The (E, cdir * n2) MK that pack_mk laid out."""
    nch, cdir, LT, _ = tiles.shape
    return tiles[..., :E].permute(3, 1, 0, 2).reshape(E, cdir * nch * LT)


def _ud(bw, bh, use_deltas):
    return use_deltas and min(bw, bh) >= 8


@pytest.mark.parametrize("use_deltas", [False, True])
@pytest.mark.parametrize("bw,bh", FUSED_SHAPES)
def test_tiles_unpack_to_constants(bw, bh, use_deltas):
    sc = dp.ShapeCost(bw, bh, 10, _ud(bw, bh, use_deltas), "bf16")
    n2, E, cdir = sc.n2, sc.E, sc.cdir
    LT, KC = pk.nd_tile(n2)
    assert sc.kt_tiles.shape == (n2 // LT, n2 // KC, LT, KC + pk.PAD)
    assert np.array_equal(_bf16_bits(unpack_kt(sc.kt_tiles)),
                          _bf16_bits(sc.kt))
    assert not bool(sc.kt_tiles[..., KC:].any())
    LT, Ep = pk.dir_tile(n2, E)
    assert sc.mk_tiles.shape == (n2 // LT, cdir, LT, Ep + pk.PAD)
    assert np.array_equal(_bf16_bits(unpack_mk(sc.mk_tiles, E)),
                          _bf16_bits(sc.mk))
    assert not bool(sc.mk_tiles[..., E:].any())
    for t in (sc.kt_tiles, sc.mk_tiles):
        assert t.dtype == torch.bfloat16 and t.is_contiguous()
        # a tile row is an odd number of 16-byte units: the eight rows of
        # one ldmatrix phase fall into distinct bank groups
        assert (t.shape[-1] * 2) % 16 == 0 and (t.shape[-1] * 2 // 16) % 2
    # a tile is one ring stage of whole 16-byte copies
    assert sc.kt_tiles[0, 0].numel() * 2 % 16 == 0
    assert sc.mk_tiles[0, 0].numel() * 2 % 16 == 0


@pytest.mark.parametrize("bw,bh", [(4, 4), (8, 8), (16, 8), (8, 16)])
def test_tile_element_order(bw, bh):
    """Single elements land where the kernels look for them: KT[k, n] at
    tile [n // LT, k // KC, n % LT, k % KC], MK[e, c * n2 + n] at
    [n // LT, c, n % LT, e]."""
    n2, E = bw * bh, 2 * (bw + bh) + 1
    rng = np.random.default_rng(5)
    kt = torch.from_numpy(rng.standard_normal((n2, n2)).astype(np.float32))
    mk = torch.from_numpy(rng.standard_normal((E, 3 * n2)).astype(np.float32))
    kt16, mk16 = kt.bfloat16(), mk.bfloat16()
    ktt, mkt = pk.pack_kt(kt), pk.pack_mk(mk, n2)
    LT, KC = pk.nd_tile(n2)
    for k, n in rng.integers(0, n2, (20, 2)):
        assert ktt[n // LT, k // KC, n % LT, k % KC] == kt16[k, n]
    LT, _ = pk.dir_tile(n2, E)
    for e, c, n in zip(rng.integers(0, E, 20), rng.integers(0, 3, 20),
                       rng.integers(0, n2, 20)):
        assert mkt[n // LT, c, n % LT, e] == mk16[e, c * n2 + n]


@pytest.mark.parametrize("bw,bh", [(4, 4), (8, 8), (16, 8), (32, 32)])
def test_pack_mk_lanes_per_chunk(bw, bh):
    """K4/K5's chunks of lt = 16 lanes: MK[e, c * n2 + n] at
    [n // 16, c, n % 16, e]; the default lt stays K1's 32."""
    n2, E = bw * bh, 2 * (bw + bh) + 1
    rng = np.random.default_rng(bw * bh)
    mk = torch.from_numpy(rng.standard_normal((E, 3 * n2)).astype(np.float32))
    t16 = pk.pack_mk(mk, n2, lt=16)
    assert t16.shape == (n2 // 16, 3, 16, -(-E // 16) * 16 + pk.PAD)
    mk16 = mk.bfloat16()
    for e, c, n in zip(rng.integers(0, E, 20), rng.integers(0, 3, 20),
                       rng.integers(0, n2, 20)):
        assert t16[n // 16, c, n % 16, e] == mk16[e, c * n2 + n]
    assert torch.equal(pk.pack_mk(mk, n2), pk.pack_mk(mk, n2, lt=32))
    assert pk.dir_tile(n2, E) == pk.dir_tile(n2, E, 32)


@pytest.mark.parametrize("use_deltas", [False, True])
@pytest.mark.parametrize("bw,bh", [(4, 4), (8, 4), (8, 8), (16, 8),
                                   (16, 16)])
def test_from_numpy_gives_the_same_tiles(bw, bh, use_deltas):
    ud = _ud(bw, bh, use_deltas)
    a = dp.ShapeCost.from_numpy(_ref_consts(bw, bh, ud), bw=bw, bh=bh,
                                depth=10, use_deltas=ud, matmul="bf16")
    b = dp.ShapeCost(bw, bh, 10, ud, "bf16")
    for name in ("kt_tiles", "mk_tiles"):
        ta, tb = getattr(a, name), getattr(b, name)
        assert ta.shape == tb.shape
        assert np.array_equal(_bf16_bits(ta), _bf16_bits(tb)), name


def test_f32_shape_cost_has_no_tiles():
    """The kernels take bf16 constants only; the f32 CPU path carries no
    tiles, and the TX_64 family (plain torch) none either."""
    assert dp.ShapeCost(8, 8, 10, True, "f32").mk_tiles is None
    assert dp.ShapeCost(8, 8, 10, True, "f32").kt_tiles is None
    assert dp.ShapeCost(64, 64, 10, False, "bf16").kt_tiles is None


def _args(bw, bh, R=29, seed=2):
    rng = np.random.default_rng(seed)
    sc = dp.ShapeCost(bw, bh, 10, min(bw, bh) >= 8, "bf16")
    n2, E = sc.n2, sc.E
    f = lambda *s: torch.from_numpy(
        rng.integers(0, 1024, s).astype(np.float32))
    q = torch.from_numpy(dp._lane_quant(n2, 90, 110, sc.gain, sc.ac_bias))
    quant = dict(inv=q[0], scale=q[1], bias=q[2], lam=31.0)
    blocks = f(R, n2)
    nd = dict(above=f(R, bw), left=f(R, bh), sc=f(R, 2), blocks=blocks,
              kt=sc.kt, whv=sc.whv, wwv=sc.wwv, **quant)
    dr = dict(ext=f(R, E), bkt=pk._mm(blocks, sc.kt), mk=sc.mk, cc=sc.cc,
              **quant)
    return sc, nd, dr


@pytest.mark.parametrize("bw,bh", [(4, 4), (8, 4), (16, 16), (32, 16)])
def test_wrappers_with_tiles_take_plain_version_on_cpu(bw, bh):
    sc, nd, dr = _args(bw, bh)
    pk.reset_launches()
    got_nd = pk.nd_cost(**nd, kt_tiles=sc.kt_tiles)
    got_dr = pk.dir_cost(**dr, mk_tiles=sc.mk_tiles)
    assert pk.LAUNCHES == {"dir_cost": 0, "nd_cost": 0}
    assert torch.equal(got_nd, pk.nd_cost_ref(**nd))
    assert torch.equal(got_dr, pk.dir_cost_ref(**dr))
    assert torch.equal(got_nd, pk.nd_cost(**nd))
    assert torch.equal(got_dr, pk.dir_cost(**dr))


def _bad(case):
    sc, nd, dr = _args(8, 8)
    if case == "dir: bkt rows":
        return pk.dir_cost, {**dr, "bkt": dr["bkt"][:-1]}
    if case == "dir: ext float64":
        return pk.dir_cost, {**dr, "ext": dr["ext"].double()}
    if case == "dir: cc length":
        return pk.dir_cost, {**dr, "cc": dr["cc"][:-1]}
    if case == "dir: mk int":
        return pk.dir_cost, {**dr, "mk": dr["mk"].to(torch.int32)}
    if case == "dir: mk height":
        return pk.dir_cost, {**dr, "mk": dr["mk"][:-1]}
    if case == "dir: tiles shape":
        return pk.dir_cost, {**dr, "mk_tiles": sc.mk_tiles[:, :-1]}
    if case == "dir: tiles float32":
        return pk.dir_cost, {**dr, "mk_tiles": sc.mk_tiles.float()}
    if case == "nd: blocks float64":
        return pk.nd_cost, {**nd, "blocks": nd["blocks"].double()}
    if case == "nd: sc width":
        return pk.nd_cost, {**nd, "sc": nd["sc"][:, :1]}
    if case == "nd: kt shape":
        return pk.nd_cost, {**nd, "kt": nd["kt"][:, :-1]}
    if case == "nd: tiles shape":
        return pk.nd_cost, {**nd, "kt_tiles": sc.kt_tiles[..., :-8]}
    if case == "nd: tiles float32":
        return pk.nd_cost, {**nd, "kt_tiles": sc.kt_tiles.float()}
    raise KeyError(case)


@pytest.mark.parametrize("case", [
    "dir: bkt rows", "dir: ext float64", "dir: cc length", "dir: mk int",
    "dir: mk height", "dir: tiles shape", "dir: tiles float32",
    "nd: blocks float64", "nd: sc width", "nd: kt shape", "nd: tiles shape",
    "nd: tiles float32"])
def test_wrappers_raise_on_bad_inputs(case):
    fn, kw = _bad(case)
    pk.reset_launches()
    with pytest.raises(ValueError):
        fn(**kw)
    assert pk.LAUNCHES == {"dir_cost": 0, "nd_cost": 0}


def test_shape_cost_forward_passes_its_tiles(monkeypatch):
    """ShapeCost.forward hands the kernels the tiles it built (what
    chip_smoke.py times is this call)."""
    seen = {}

    def spy(name, fn):
        def call(*a, **k):
            seen[name] = k.get(name)
            return fn(*a, **k)
        return call

    monkeypatch.setattr(dp, "nd_cost", spy("kt_tiles", pk.nd_cost))
    monkeypatch.setattr(dp, "dir_cost", spy("mk_tiles", pk.dir_cost))
    sc = dp.ShapeCost(8, 8, 10, True, "bf16")
    planes = torch.from_numpy(
        np.random.default_rng(1).integers(0, 1024, (1, 64, 64))
        .astype(np.int32))
    out = sc(planes, 99.0, 120.0, 40.0, (64, 64))
    assert out.shape == (1, 8, 8, 5 + sc.cdir)
    assert seen["kt_tiles"] is sc.kt_tiles
    assert seen["mk_tiles"] is sc.mk_tiles


def test_build_inputs_follow_quoted_includes():
    """K2's source depends on the shared header; K1's and K4/K5's on their
    kernel template, which includes it; K3's on nothing else of csrc/."""
    csrc = cuda_build._CSRC
    got = cuda_build.inputs(csrc / cuda_build.SOURCES["nd_cost"])
    assert got == [csrc / "pass1_nd_cost.cu", csrc / "pass1_tc.cuh"]
    for name in ("dir_cost", "dir_cost_tc"):
        src = csrc / cuda_build.SOURCES[name]
        assert cuda_build.inputs(src) == [src, csrc / "dir_tc.cuh",
                                          csrc / "pass1_tc.cuh"]
    src = csrc / cuda_build.SOURCES["mode_cost"]
    assert cuda_build.inputs(src) == [src]


def test_stale_when_an_included_header_is_newer(tmp_path, monkeypatch):
    csrc, build = tmp_path / "csrc", tmp_path / "_build"
    csrc.mkdir()
    build.mkdir()
    (csrc / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (csrc / "b.cuh").write_text("#pragma once\n")
    (csrc / "k.cu").write_text('#include "a.cuh"\n#include <cuda.h>\n')
    monkeypatch.setattr(cuda_build, "_CSRC", csrc)
    monkeypatch.setattr(cuda_build, "_BUILD", build)
    monkeypatch.setitem(cuda_build.SOURCES, "k", "k.cu")
    assert cuda_build.stale("k")  # no library yet
    so = build / "libk.so"
    so.write_bytes(b"")
    now = time.time()
    for f in ("k.cu", "a.cuh", "b.cuh"):
        os.utime(csrc / f, (now - 100, now - 100))
    os.utime(so, (now - 50, now - 50))
    assert not cuda_build.stale("k")
    os.utime(csrc / "b.cuh", (now, now))  # a header two levels down
    assert cuda_build.stale("k")
    os.utime(so, (now + 10, now + 10))
    assert not cuda_build.stale("k")
