"""K4 and K5 of the port (ops/proto_kernels.py and the harnesses
cavif_tpu_torch/tools/dir_proto.py, dir_ablation.py) against the JAX
harnesses tools/pallas_proto.py and tools/pallas_proto2.py, whose Pallas
kernels run here in the Pallas interpreter.

On the CPU the wrappers run their plain versions and launch nothing; the
CUDA kernel itself is held against those plain versions on the card by
chip_smoke.py. What surrounds the kernel is held here: MK's ring-stage
tiles at every tile, the wrappers' checks of `mk_tiles` and of the E the
kernel is built for, and the harness closures packing the tiles once.

Tolerances. The directional coefficient is the difference of two large
products (ROADMAP C, coefficient cancellation), so summation order can move
a level across a quantizer boundary: the costs agree within rtol 2e-4 and
the picks must agree exactly. mm_only and red_bf16 round each lane value to
bfloat16 before the sum, as the TPU's default-precision reduce did, while
the interpreter keeps f32: there each cost agrees within bf16's relative
rounding, 2^-8 of the sum of its lane values' magnitudes, and a pick may
differ only between candidates that close."""

import functools
import sys
from pathlib import Path

import jax.experimental.pallas as jpl
import numpy as np
import pytest
import torch

from cavif_tpu_torch.ops import pass1_kernels
from cavif_tpu_torch.ops import proto_kernels as pk
from cavif_tpu_torch.tools import dir_ablation, dir_proto

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
import pallas_proto as ref  # noqa: E402
import pallas_proto2 as ref2  # noqa: E402

R = 192
TR = 64
TC = {4: 32, 8: 8, 16: 2}  # pallas_proto.main's candidates per tile
TIERS = (4, 8, 16)
RTOL = 2e-4
BF16_REL = 2.0 ** -8


@pytest.fixture(scope="module", autouse=True)
def _close_reference_tables():
    """Reading the reference's tables leaves its .npz archive open in this
    process. A later test in the same worker that forks a process pool
    (tests/test_parallel.py) would hand that one file offset to every
    child, and their concurrent reads fail (BadZipFile). Close it when the
    module is done; the next reader reopens it."""
    yield
    from cavif_tpu.av1 import tables

    if tables._npz.cache_info().currsize:
        tables._npz().close()
        tables._npz.cache_clear()


@pytest.fixture
def interpret(monkeypatch):
    """Both JAX harnesses look pl.pallas_call up at call time."""
    monkeypatch.setattr(jpl, "pallas_call",
                        functools.partial(jpl.pallas_call, interpret=True))


@functools.lru_cache(maxsize=None)
def _ref_build(b):
    return ref.build(b, R, TR, TC[b])


def _kwargs(d, mk_dtype=torch.bfloat16):
    kw = dir_proto.from_numpy(d, "cpu")
    kw["mk"] = kw["mk"].to(mk_dtype)
    return kw


def _bf16_np(x):
    """float32 -> bfloat16 (round to nearest even), as float32."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16
    return u.astype(np.uint32).view(np.float32)


def _close(got, want):
    """Every cost within rtol RTOL, and the same pick on every row."""
    diff = np.abs(got - want)
    assert (diff <= RTOL * np.maximum(np.abs(want), 1.0)).all(), diff.max()
    assert (got.argmin(1) == want.argmin(1)).all()


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("b", TIERS)
def test_build_bit_equal(b, seed):
    want = ref.build(b, R, TR, TC[b], seed=seed)
    got = dir_proto.build(b, R, seed=seed)
    assert sorted(got) == sorted(want)
    for k in want:
        a, c = np.asarray(want[k]), np.asarray(got[k])
        assert a.dtype == c.dtype and a.shape == c.shape, k
        assert a.tobytes() == c.tobytes(), k


def test_from_numpy_takes_reference_dict():
    d = _ref_build(8)
    kw = dir_proto.from_numpy(d, "cpu")
    for k, src in (("ext", "ext"), ("bkt", "bkt"), ("mk", "MK"), ("cc", "cc"),
                   ("inv", "inv_scale"), ("scale", "scale"),
                   ("bias", "bias")):
        assert kw[k].dtype == torch.float32
        assert np.array_equal(kw[k].numpy(), d[src]), k
    assert kw["lam"] == float(d["lam"])
    mine = dir_proto.build(8, R)
    args = (kw["ext"], kw["bkt"])
    assert torch.equal(dir_proto.plain(d, "cpu")(*args),
                       dir_proto.plain(mine, "cpu")(*args))


@pytest.mark.parametrize("b", TIERS)
def test_plain_matches_xla_ref(b):
    """The harnesses' accuracy yardsticks: f32 products on both sides."""
    d = _ref_build(b)
    want = np.asarray(ref.xla_ref(d)(d["ext"], d["bkt"]))
    kw = dir_proto.from_numpy(d, "cpu")
    got = dir_proto.plain(d, "cpu")(kw["ext"], kw["bkt"]).numpy()
    _close(got, want)


@pytest.mark.parametrize("reduce", pk.REDUCE_MODES)
@pytest.mark.parametrize("b", TIERS)
def test_k4_matches_interpreter(b, reduce, interpret):
    d = _ref_build(b)
    want = np.asarray(ref.pallas_fused(d, TR, TC[b], reduce)(d["ext"],
                                                             d["bkt"]))
    got = pk.fused_dir_cost(**_kwargs(d), reduce=reduce).numpy()
    assert got.shape == want.shape == (R, d["C"])
    _close(got, want)


@pytest.mark.parametrize("variant", pk.VARIANTS)
@pytest.mark.parametrize("b", TIERS)
def test_k5_matches_interpreter(b, variant, interpret):
    d = _ref_build(b)
    f, extp, bktp = ref2.make(d, TR, TC[b], variant)
    raw = np.asarray(f(extp, bktp))  # (nC, TC, Rp)
    Cp = raw.shape[0] * raw.shape[1]
    want = raw.reshape(Cp, -1)[:d["C"], :R].T
    kw = _kwargs(d)
    got = pk.dir_ablation(**kw, variant=variant).numpy()
    assert got.shape == want.shape == (R, d["C"])
    if variant not in pk.BF16_REDUCE:
        _close(got, want)
        return
    lanes = pk.ablation_lanes(**kw, variant=variant).numpy()
    # exact: round each lane value to bf16, then add in f32 in lane order
    v = _bf16_np(lanes)
    summed = v[..., 0].copy()
    for k in range(1, v.shape[-1]):
        summed += v[..., k]
    assert np.array_equal(got, summed)
    # against the interpreter's f32 sum: within bf16's relative rounding
    bound = BF16_REL * np.abs(lanes).sum(-1)
    assert (np.abs(got - want) <= bound).all()
    # a pick differs only between candidates within that rounding
    rows = np.arange(R)
    mine, theirs = got.argmin(1), want.argmin(1)
    gap = want[rows, mine] - want[rows, theirs]
    assert (gap <= bound[rows, mine] + bound[rows, theirs]).all()


def test_ablation_full_is_k4():
    kw = _kwargs(_ref_build(16))
    assert torch.equal(pk.dir_ablation(**kw, variant="full"),
                       pk.fused_dir_cost(**kw))
    assert torch.equal(pk.fused_dir_cost(**kw),
                       pass1_kernels.dir_cost_ref(**kw))


def test_no_sign_keeps_the_sign_of_coef():
    """no_sign prices coef - floor(|t| + bias) * scale, which differs from
    the |coef| form wherever a coefficient is negative and quantized."""
    kw = _kwargs(_ref_build(4))
    lanes = pk.ablation_lanes(**kw, variant="no_sign")
    full = pk.ablation_lanes(**kw, variant="full")
    R_, n2 = kw["bkt"].shape
    cp = pass1_kernels._mm(kw["ext"], kw["mk"]).view(R_, -1, n2)
    coef = kw["bkt"][:, None, :] - (cp * (1.0 / 32.0) + kw["cc"])
    level = torch.floor((coef * kw["inv"]).abs() + kw["bias"])
    pos = (coef >= 0) | (level == 0)
    assert torch.equal(lanes[pos], full[pos])
    assert bool((lanes[~pos] > full[~pos]).all()) and int((~pos).sum()) > 0


@pytest.mark.parametrize("case", [("fused", "matmul"), ("fused", "loop")]
                         + [("ablation", v) for v in pk.VARIANTS])
def test_wrappers_take_plain_version_on_cpu(case):
    kind, arg = case
    kw = _kwargs(_ref_build(8))
    pk.reset_launches()
    if kind == "fused":
        got = pk.fused_dir_cost(**kw, reduce=arg, tile=(64, 32))
        want = pk.fused_dir_cost_ref(**kw)
    else:
        got = pk.dir_ablation(**kw, variant=arg, tile=[128, 16])
        want = pk.dir_ablation_ref(**kw, variant=arg)
    assert pk.LAUNCHES == {"fused_dir_cost": 0, "dir_ablation": 0}
    assert torch.equal(got, want)
    assert got.shape == (R, 56) and got.dtype == torch.float32


@pytest.mark.parametrize("bad", [dict(reduce="segsum"), dict(variant="nope"),
                                 dict(tile=(32, 32)), dict(tile=64),
                                 dict(tile=(64, 64, 1))])
def test_bad_arguments_raise(bad):
    kw = _kwargs(_ref_build(4))
    if "variant" in bad:
        fn = pk.dir_ablation
    elif "reduce" in bad:
        fn = pk.fused_dir_cost
    else:
        for fn, extra in ((pk.fused_dir_cost, {}),
                          (pk.dir_ablation, {"variant": "full"})):
            with pytest.raises(ValueError):
                fn(**kw, **bad, **extra)
        return
    with pytest.raises(ValueError):
        fn(**kw, **bad)


def test_bad_variant_raises_in_harness():
    f, ext, bkt = dir_ablation.make(_ref_build(4), "mm_first", device="cpu")
    with pytest.raises(ValueError):
        f(ext, bkt)


@pytest.mark.parametrize("mod", [dir_proto, dir_ablation])
def test_harness_needs_cuda_unless_asked_for_cpu(mod):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the harness runs on it")
    with pytest.raises(RuntimeError, match="cuda"):
        mod.main(["4", "--rows", "16"])


@pytest.mark.parametrize("mod", [dir_proto, dir_ablation])
def test_harness_main_on_cpu(mod, capsys):
    assert mod.main(["4", "--device", "cpu", "--rows", "32"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("tier 4: R=32")
    assert len(out.strip().splitlines()) == 1 + (
        len(pk.TILES) * len(pk.REDUCE_MODES) + 1 if mod is dir_proto
        else len(pk.TILES) * len(pk.VARIANTS))
    if mod is dir_proto:
        # on the CPU the kernel is its plain version: bf16 against f32
        # products, no pick differs at this size
        assert "argmin flips 0.0000%" in out


def _unpack(tiles, E):
    """The (E, C * n2) MK that pack_tiles laid out."""
    nch, C, LT, _ = tiles.shape
    return tiles[..., :E].permute(3, 1, 0, 2).reshape(E, C * nch * LT)


@pytest.mark.parametrize("tile", pk.TILES)
@pytest.mark.parametrize("b", TIERS)
def test_tiles_unpack_to_mk(b, tile):
    """The ring-stage tiles at every tile and tier hold MK bit for bit:
    (n2 / LT, C, LT, Ep + 8), LT = min(n2, lanes), the padding zero."""
    kw = _kwargs(_ref_build(b))
    mk, n2 = kw["mk"], kw["bkt"].shape[1]
    E = mk.shape[0]
    tiles = pk.pack_tiles(mk, n2, tile)
    LT = min(n2, tile[1])
    Ep = -(-E // 16) * 16
    assert tiles.shape == (n2 // LT, 56, LT, Ep + 8)
    assert tiles.dtype == torch.bfloat16 and tiles.is_contiguous()
    assert torch.equal(_unpack(tiles, E).view(torch.int16),
                       mk.view(torch.int16))
    assert not bool(tiles[..., E:].any())
    if tile[1] == 32:  # K1's lanes: K1's own layout
        assert torch.equal(tiles, pass1_kernels.pack_mk(mk, n2))


def _call(kind, kw, **extra):
    if kind == "fused":
        return pk.fused_dir_cost(**kw, **extra)
    return pk.dir_ablation(**kw, variant="no_sign", **extra)


@pytest.mark.parametrize("bad", ["shape", "dtype", "other tile"])
@pytest.mark.parametrize("kind", ["fused", "ablation"])
def test_bad_tiles_raise_on_cpu(kind, bad):
    kw = _kwargs(_ref_build(8))
    tiles = pk.pack_tiles(kw["mk"], 64)
    tiles = {"shape": tiles[:, :-1], "dtype": tiles.float(),
             "other tile": pk.pack_tiles(kw["mk"], 64, (128, 16))}[bad]
    pk.reset_launches()
    with pytest.raises(ValueError):
        _call(kind, kw, mk_tiles=tiles)
    assert pk.LAUNCHES == {"fused_dir_cost": 0, "dir_ablation": 0}


@pytest.mark.parametrize("tile", pk.TILES)
@pytest.mark.parametrize("kind", ["fused", "ablation"])
def test_good_tiles_leave_plain_result(kind, tile):
    kw = _kwargs(_ref_build(8))
    tiles = pk.pack_tiles(kw["mk"], 64, tile)
    pk.reset_launches()
    got = _call(kind, kw, tile=tile, mk_tiles=tiles)
    assert pk.LAUNCHES == {"fused_dir_cost": 0, "dir_ablation": 0}
    assert torch.equal(got, _call(kind, kw, tile=tile))


@pytest.mark.parametrize("harness", ["fused", "make"])
def test_harness_packs_once(harness, monkeypatch):
    """The closures pack MK's tiles once, outside the calls they time."""
    packs = []
    real = pass1_kernels.pack_mk

    def counted(*a, **k):
        packs.append(k.get("lt"))
        return real(*a, **k)

    monkeypatch.setattr(pass1_kernels, "pack_mk", counted)
    d = _ref_build(8)
    kw = dir_proto.from_numpy(d, "cpu")
    if harness == "fused":
        f = dir_proto.fused(d, "loop", (64, 32), device="cpu")
    else:
        f = dir_ablation.make(d, "full", (128, 16), device="cpu")[0]
    first = f(kw["ext"], kw["bkt"])
    assert torch.equal(f(kw["ext"], kw["bkt"]), first)
    assert packs == [32 if harness == "fused" else 16]


@pytest.mark.parametrize("E", [16, 49, 64, 81, 128, 145, 256])
@pytest.mark.parametrize("kind", ["fused", "ablation"])
def test_unsupported_e_raises(kind, E):
    """The kernel is built for k-steps ceil(E / 16) in {2, 3, 5, 9} only:
    any other E raises before a launch, on the CPU too."""
    rng = np.random.default_rng(E)
    n2, C = 16, 3
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    kw = dict(ext=f(8, E), bkt=f(8, n2), mk=f(E, C * n2).bfloat16(),
              cc=f(n2), inv=f(n2), scale=f(n2), bias=f(n2), lam=1.0)
    pk.reset_launches()
    with pytest.raises(ValueError, match="E"):
        _call(kind, kw)
    assert pk.LAUNCHES == {"fused_dir_cost": 0, "dir_ablation": 0}
    kw.update(ext=f(8, 33), mk=f(33, C * n2).bfloat16())
    assert _call(kind, kw).shape == (8, C)
