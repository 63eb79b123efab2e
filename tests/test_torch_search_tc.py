"""The split-f16 numerics of kernel K3 (csrc/mode_search_cost.cu, the block
search's 13-candidate costs on the tensor cores), held on the CPU.

The kernel cannot run here, so these tests hold what it is built from: the
split constants that ops/search_kernels.pack_split lays out (D, or D (x) D
in mma fragment order, as hi + 2^-12 lo in f16), the exactness of the
residuals in f16 at bit depths 8 and 10, and a plain PyTorch emulation of
its products (f16-rounded operands, f32 sums, the separable form's
intermediate split as the constants are), priced by the plain version's
own quantizer and sums (mode_cost_ref with its DCT swapped for the
emulation).

Tolerances: the card's. The emulation is held to mode_cost_ref by the rule
chip_smoke.py applies to the kernel: argmin differences beyond the float64
oracle's near-ties (search_kernels.near_ties, rtol 1e-5) on fewer than 1e-3
of the blocks, and fewer than 1e-3 of the costs beyond rtol 2e-4. Raw
differences exist (exact ties broken by rounding noise); the tests pin
that they do and that none lies beyond a near-tie, and that single f16
products, without the split, fail the cost rule. Against the JAX
reference's XLA search the emulation meets the block-search policy of
tests/test_torch_block_search.py."""

import numpy as np
import pytest
import torch

from cavif_tpu_torch.ops import block_search as bs
from cavif_tpu_torch.ops import search_kernels as sk
from test_torch_block_search import LAM as BS_LAM
from test_torch_block_search import _hold, _planes, _ref_costs

# the quantizers and lambda of the 1024x1024 Q80 10-bit encode
DC_Q, AC_Q, LAM = 499, 616, 296.45
COST_RTOL = 2e-4
LIMIT = 1e-3


def _test_image(h, w, seed=42):
    """The repository benchmark's synthetic photo (chip_smoke.py)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    base = (110 + 80 * np.sin(x / 97.0) * np.cos(y / 61.0)
            + 40 * np.sin((x + 2 * y) / 31.0))
    lum = np.clip(base + rng.normal(0.0, 6.0, size=(h, w))
                  + 18.0 * ((x // 128 + y // 128) % 2), 0, 255)
    r = np.clip(lum + 18 * np.sin(y / 83.0), 0, 255)
    b = np.clip(lum - 22 * np.cos(x / 71.0), 0, 255)
    return np.stack([r, lum, b], axis=-1).astype(np.uint8)


def _photo_planes(size):
    from cavif_tpu_torch.ops import colorspace

    img = _test_image(size, size)
    return np.ascontiguousarray(
        colorspace.rgb_to_ycbcr_host(img, depth=10).transpose(2, 0, 1)
        .astype(np.int32))


def _dct(n):
    return torch.from_numpy(sk.search_consts(n)["dct"])


def _split_np(x):
    hi = x.astype(np.float16)
    return hi, ((x - hi.astype(np.float64)) * 4096.0).astype(np.float16)


def emulated_dct2(form, split=True):
    """coef = D R D^T as the kernel computes it in `form` (split=False: one
    f16 product per pass, no lo halves)."""
    s = sk.LO_SCALE

    def dct2(res, dct):
        n = dct.shape[0]
        f32 = torch.float32
        if form == "kron":
            hi, lo = sk.split_f16(torch.kron(dct, dct))
            r = res.reshape(*res.shape[:-2], n * n)
            coef = r @ hi.to(f32).T
            if split:
                coef = coef + s * (r @ lo.to(f32).T)
            return coef.reshape(res.shape)
        dh, dl = (x.to(f32) for x in sk.split_f16(dct))
        if not split:
            t = (dh @ res).to(torch.float16).to(f32)
            return t @ dh.T
        t = dh @ res + s * (dl @ res)
        th = t.to(torch.float16).to(f32)
        tl = ((t - th) * 4096.0).to(torch.float16).to(f32)
        return th @ dh.T + s * (tl @ dh.T + th @ dl.T)

    return dct2


def _emulated_costs(monkeypatch, kw, form, split=True):
    with monkeypatch.context() as m:
        m.setattr(sk, "dct2", emulated_dct2(form, split))
        return sk.mode_cost_ref(**kw)


def _card_rule(got, ref, kw, label):
    """(raw differences, exact ties, beyond near-ties, share of costs
    beyond COST_RTOL), printed (pytest -s shows them)."""
    NB = ref.shape[0]
    diff, ties, beyond = sk.near_ties(got.argmin(1), ref.argmin(1), kw)
    over = float(((got - ref).abs()
                  > COST_RTOL * ref.abs().clamp_min(1.0)).float().mean())
    print(f"\n{label}: NB {NB}, argmin differs on {diff} ({ties} exact "
          f"ties, {beyond} beyond near-ties), costs beyond rtol "
          f"{COST_RTOL}: {over:.3e}")
    return diff, ties, beyond, over


@pytest.mark.parametrize("n", sk.SIZES)
def test_split_reconstructs_d(n):
    d = _dct(n).to(torch.float64)
    hi, lo = sk.split_f16(d)
    assert hi.dtype == lo.dtype == torch.float16
    back = hi.to(torch.float64) + sk.LO_SCALE * lo.to(torch.float64)
    assert bool(((back - d).abs() <= 2.0 ** -21 * d.abs()).all())
    # the lo half carries what hi rounded away; hi alone is 11 bits
    assert float(((hi.to(torch.float64) - d).abs() / d.abs()).max()) > 2e-5
    if sk.FORMS[n] == "kron":
        k = torch.kron(d, d)
        khi, klo = sk.split_f16(k)
        kb = khi.to(torch.float64) + sk.LO_SCALE * klo.to(torch.float64)
        assert bool(((kb - k).abs() <= 2.0 ** -21 * k.abs()).all())


@pytest.mark.parametrize("n", [n for n in sk.SIZES if sk.FORMS[n] == "sep"])
def test_separable_tiles(n):
    d = sk.search_consts(n)["dct"].astype(np.float64)
    hi, lo = _split_np(d)
    t = sk.pack_split(_dct(n)).numpy()
    assert t.shape == sk.tiles_shape(n) == (2, n, n + sk.PAD)
    assert t.dtype == np.float16
    assert np.array_equal(t[0, :, :n].view(np.uint16), hi.view(np.uint16))
    assert np.array_equal(t[1, :, :n].view(np.uint16), lo.view(np.uint16))
    assert not t[:, :, n:].any()


@pytest.mark.parametrize("n", [n for n in sk.SIZES if sk.FORMS[n] == "kron"])
def test_kron_tiles_in_fragment_order(n):
    """Lane 4 g + t of (k-step ks, coefficient tile nt) holds the B
    fragment of mma.m16n8k16 for coefficient c = 8 nt + g and pixels
    k = 16 ks + 2 t, +1, +8, +9: the split of np.kron(D, D)[c, k], hi
    then lo."""
    d = sk.search_consts(n)["dct"].astype(np.float64)
    hi, lo = _split_np(np.kron(d, d))
    n2 = n * n
    t = sk.pack_split(_dct(n)).numpy()
    assert t.shape == sk.tiles_shape(n) == (n2 // 16, n2 // 8, 32, 8)
    ks, nt, lane = np.meshgrid(np.arange(n2 // 16), np.arange(n2 // 8),
                               np.arange(32), indexing="ij")
    c = 8 * nt + lane // 4
    k = 16 * ks + 2 * (lane % 4)
    for slot, (half, dk) in enumerate(
            [(hi, 0), (hi, 1), (hi, 8), (hi, 9),
             (lo, 0), (lo, 1), (lo, 8), (lo, 9)]):
        assert np.array_equal(t[..., slot].view(np.uint16),
                              half[c, k + dk].view(np.uint16)), slot


@pytest.mark.parametrize("n", [2, 12, 64])
def test_pack_split_refuses_other_sizes(n):
    with pytest.raises(ValueError):
        sk.pack_split(torch.eye(n))


@pytest.mark.parametrize("n", sk.SIZES)
def test_search_inputs_pass_the_packed_constants(n):
    """search_consts packs the split D once per n; search_inputs passes
    that copy to the kernel as `tiles`, in the shape mode_cost checks."""
    c = sk.search_consts(n)
    assert c["tiles"].dtype == np.float16
    assert c["tiles"].shape == sk.tiles_shape(n)
    assert np.array_equal(c["tiles"].view(np.uint16),
                          sk.pack_split(_dct(n)).numpy().view(np.uint16))
    assert sk.search_consts(n) is c
    planes = _planes(64, 64, n, count=1)
    kw = bs.search_inputs(torch.from_numpy(planes), n, 10, DC_Q, AC_Q, LAM)
    assert torch.equal(kw["tiles"], torch.from_numpy(c["tiles"]))


@pytest.mark.parametrize("entry", ["search_inputs", "plane_partition_search",
                                   "plane_mode_search",
                                   "plane_mode_search_costs"])
def test_search_refuses_planes_deeper_than_10_bits(entry):
    """K3 takes pixels in [0, 1023] (bit depths 8 and 10): the block
    search refuses 12-bit planes on every backend and device rather than
    price them wrongly on the card, and takes 8-bit ones."""
    planes = _planes(64, 64, 6, count=1)
    if entry == "search_inputs":
        def call(depth):
            return bs.search_inputs(torch.from_numpy(planes), 8, depth,
                                    DC_Q, AC_Q, LAM)
    else:
        def call(depth):
            return getattr(bs, entry)(planes >> 2, DC_Q, AC_Q, LAM, depth,
                                      device="cpu", backend="plain")
    with pytest.raises(ValueError, match="bit_depth 12"):
        call(12)
    call(8)


@pytest.mark.parametrize("depth", [8, 10])
@pytest.mark.parametrize("n", sk.SIZES)
def test_residuals_exact_in_f16(n, depth):
    """On planes that span the whole range (noise, and a checkerboard of 0
    and the maximum) every pixel and prediction lies in [0, 1023], the
    kernel's precondition, and every residual is exact in f16, also as the
    kernel forms it: the difference of the f16 values 1024 + v, whose bit
    patterns are 0x6400 | v."""
    rng = np.random.default_rng(n * depth)
    top = (1 << depth) - 1
    y, x = np.mgrid[0 : 4 * n, 0 : 4 * n]
    planes = np.stack([
        rng.integers(0, top + 1, (4 * n, 4 * n)),
        np.where((x // 2 + y // 3) % 2 == 0, 0, top),
    ]).astype(np.int32)
    kw = bs.search_inputs(torch.from_numpy(planes), n, depth, DC_Q, AC_Q,
                          LAM)
    NB = kw["blocks"].shape[0]
    preds = torch.cat([
        sk.nondir_preds(kw["above"], kw["left"], kw["scal"], kw["smw"]),
        sk.dir_preds(kw["ext"], kw["taps"]).view(NB, 6, n, n)], 1)
    for v in (kw["blocks"], preds):
        assert 0 <= int(v.min()) and int(v.max()) <= top <= 1023
    res = (kw["blocks"][:, None] - preds).to(torch.float32)
    assert torch.equal(res.to(torch.float16).to(torch.float32), res)
    assert int(res.abs().max()) > top // 2  # the planes reach far

    def offset_f16(v):
        bits = (v.numpy().astype(np.uint16) | np.uint16(0x6400))
        return torch.from_numpy(bits.view(np.float16))

    assert torch.equal(offset_f16(kw["blocks"]).to(torch.float32),
                       kw["blocks"].to(torch.float32) + 1024)
    got = offset_f16(kw["blocks"])[:, None] - offset_f16(preds)
    assert torch.equal(got.to(torch.float32), res)


def _test_planes(kind, n):
    if kind == "photo":
        return _photo_planes(256)
    return _planes(128, 128, 5 + n, count=4)


@pytest.mark.parametrize("kind", ["ramps", "photo"])
@pytest.mark.parametrize("n", sk.SIZES)
def test_split_emulation_holds_the_card_rule(monkeypatch, n, kind):
    form = sk.FORMS[n]
    planes = _test_planes(kind, n)
    kw = bs.search_inputs(torch.from_numpy(planes), n, 10, DC_Q, AC_Q, LAM)
    ref = sk.mode_cost_ref(**kw)
    got = _emulated_costs(monkeypatch, kw, form)
    NB = ref.shape[0]
    diff, ties, beyond, over = _card_rule(got, ref, kw,
                                          f"{kind} n={n} {form}")
    assert beyond < LIMIT * NB, (beyond, diff, NB)
    assert over < LIMIT, over
    assert bool(torch.isfinite(got).all())


def test_raw_differences_at_n4_are_near_ties(monkeypatch):
    """The 4x4 tier of a photo: the emulated kernel picks another
    candidate than the plain version on some blocks, and every such block
    is a near-tie under the float64 oracle, most of them exact."""
    kw = bs.search_inputs(torch.from_numpy(_photo_planes(256)), 4, 10, DC_Q,
                          AC_Q, LAM)
    ref = sk.mode_cost_ref(**kw)
    got = _emulated_costs(monkeypatch, kw, "kron")
    diff, ties, beyond, over = _card_rule(got, ref, kw, "photo n=4 kron")
    assert diff > 0 and ties > 0
    assert beyond == 0
    assert over < LIMIT


@pytest.mark.parametrize("n", [n for n in sk.SIZES if n >= 8])
def test_single_f16_fails_the_cost_rule(monkeypatch, n):
    """Without the lo halves, f16 products move more than 1e-3 of the
    photo's costs beyond rtol 2e-4 at n >= 8: the split is what the
    kernel's agreement rests on there. (At n = 4 one rounding of D (x) D
    alone stays inside the rule on this frame, 3.0e-4; the kernel splits
    there too, for one code path and the margin.)"""
    kw = bs.search_inputs(torch.from_numpy(_photo_planes(256)), n, 10,
                          DC_Q, AC_Q, LAM)
    ref = sk.mode_cost_ref(**kw)
    got = _emulated_costs(monkeypatch, kw, sk.FORMS[n], split=False)
    over = _card_rule(got, ref, kw, f"single f16 n={n}")[3]
    assert over > LIMIT, over


@pytest.mark.parametrize("n", sk.SIZES)
def test_split_emulation_matches_reference_search(monkeypatch, n):
    """The emulated kernel (the form of n) against the JAX reference's XLA
    search, with the policy and lambda of
    test_torch_block_search.py::test_mode_cost_ref_matches_search_body, on
    256 x 256 planes of its generator: the policy's 1e-3 share of costs
    needs more than the 832 costs that 128 x 128 planes give at n = 32,
    where one level flip (a cost moved by lambda) is expected."""
    planes = _planes(256, 256, n, count=4)
    ref = _ref_costs(planes, n)[0]
    kw = bs.search_inputs(torch.from_numpy(planes), n, 10, DC_Q, AC_Q,
                          BS_LAM)
    N, H, W = planes.shape
    got = _emulated_costs(monkeypatch, kw, sk.FORMS[n])
    _hold(ref, got.view(N, H // n, W // n, -1).numpy(), f"n={n} vs XLA")


def test_near_ties_counts():
    planes = _planes(64, 64, 3, count=2)
    kw = bs.search_inputs(torch.from_numpy(planes), 8, 10, DC_Q, AC_Q, LAM)
    ref = sk.mode_cost_ref(**kw)
    pick = ref.argmin(1)
    assert sk.near_ties(pick, pick, kw) == (0, 0, 0)
    # the worst candidate of every block is a real disagreement
    worst = ref.argmax(1)
    NB = ref.shape[0]
    assert sk.near_ties(worst, pick, kw) == (NB, 0, NB)
    # DC and V share their residual on a block whose above row is flat
    kw2 = dict(kw, above=kw["scal"][:, 1:2].expand(-1, 8).contiguous())
    ref2 = sk.mode_cost_ref(**kw2)
    assert torch.equal(ref2[:, 0], ref2[:, 1])
    dc, v = torch.zeros(NB, dtype=torch.long), torch.ones(NB, dtype=torch.long)
    assert sk.near_ties(v, dc, kw2) == (NB, NB, 0)


def test_mode_cost_on_cpu_ignores_tiles():
    """On the CPU the wrapper and the plain version price from dct; the
    kernel's split copy is not read."""
    planes = _planes(64, 64, 4, count=2)
    kw = bs.search_inputs(torch.from_numpy(planes), 16, 10, DC_Q, AC_Q, LAM)
    want = sk.mode_cost_ref(**kw)
    zeros = dict(kw, tiles=torch.zeros_like(kw["tiles"]))
    assert torch.equal(sk.mode_cost(**zeros), want)
    assert torch.equal(sk.mode_cost_ref(**zeros), want)
