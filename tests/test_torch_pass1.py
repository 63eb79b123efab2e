"""Device pass 1 of the PyTorch/CUDA port (cavif_tpu_torch.ops.device_pass1)
held against the JAX reference (cavif_tpu.ops.device_pass1) on the CPU.

The same seeded numpy inputs go through both. The port runs on the CPU with
"f32" matmul inputs, which is what JAX computes on the CPU; its kernels
therefore take their plain PyTorch versions here. The reference runs its
XLA formulation (its Pallas kernels never run on the CPU; see
tests/test_pass1_pallas.py).

Tolerances. The colour conversion and the neighbour tensors are integer or
exactly-representable values and must be equal. The cost tensors pass
through floor() at every quantizer level: two summation orders that differ
in the last bit can move a value across a level boundary and change the
cost of that (block, candidate) by about lambda. And the directional
family's coefficients are the difference of two products (blocks @ KT and
ext @ MK / 32), each far larger than the coefficient on flat blocks, so
their f32 rounding leaves an absolute error of a few units in a flat
block's summed squared error, well under lambda (296 here). So per shape
fewer than 1e-3 of the (block, candidate) costs may differ by more than
rtol 1e-4 plus atol 8, and the argmin over candidates may differ on fewer than 1e-3 of the blocks,
where a block whose two picks the reference itself prices within rtol 1e-5
(a near-tie, often an exact one: two predictors that give the same block)
does not count: summation order alone decides those, and they occur on
more than 1e-3 of the 4x4, 8x4 and 4x8 blocks (run with -s to see the
counts). The whole program's packed
decisions may differ on fewer than 1e-3 of the entries (the reference's own
Pallas-vs-XLA bound) and the layout (spec) must be identical."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cavif_tpu.ops import device_pass1 as ref_dp
from cavif_tpu_torch.ops import device_pass1 as dp

SHAPES = [(s, s) for s in dp.SQ_TIERS] + list(dp.RECT_SHAPES)
# quantizers and lambda of a Q80 10-bit frame (the encoder's own values)
DC_Q, AC_Q, LAM = 499, 616, 296.45


def _image(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:n, 0:n].astype(np.float64)
    img = np.clip(
        128 + 90 * np.sin(x / 13.0) * np.cos(y / 29.0)
        + rng.normal(0, 18, (n, n)), 0, 255)
    img = np.stack([img, img * 0.9 + 10, img * 1.1 - 10], -1)
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def img128():
    return _image(128, 5)


@pytest.fixture(scope="module")
def planes128(img128):
    """(3, 128, 128) int32 10-bit YCbCr planes (the reference's conversion)."""
    return np.array(ref_dp._convert(jnp.asarray(img128), "ycbcr", 10))


def _src(img, model, depth):
    if model in ("ycbcr", "gbr"):
        return img
    if model == "mono":
        return np.ascontiguousarray(img[..., 0])
    planes = img.transpose(2, 0, 1).astype(np.int16)
    return planes * 4 if depth == 10 else planes


@pytest.mark.parametrize("depth", [8, 10])
@pytest.mark.parametrize("model", ["ycbcr", "gbr", "mono", "planes"])
def test_convert_exact(img128, model, depth):
    src = _src(img128, model, depth)
    ref = np.asarray(ref_dp._convert(jnp.asarray(src), model, depth))
    got = dp._convert(torch.from_numpy(src), model, depth)
    assert got.dtype == torch.int32
    assert got.shape == ref.shape
    assert np.array_equal(got.numpy(), ref)


_ref_nbrs = jax.jit(ref_dp._nbrs, static_argnums=(1, 2, 3, 4))


@pytest.mark.parametrize("tile_px", [(128, 128), (64, 32)])
@pytest.mark.parametrize("depth", [8, 10])
@pytest.mark.parametrize("bw,bh", SHAPES + [(64, 64)])
def test_nbrs_exact(img128, bw, bh, depth, tile_px):
    """Neighbours, availability fallbacks and tile-boundary masking; the
    (64, 32) tile split cuts the 128x128 frame both ways."""
    planes = np.array(ref_dp._convert(jnp.asarray(img128), "ycbcr", depth))
    ref = _ref_nbrs(jnp.asarray(planes), bw, bh, depth, tile_px)
    got = dp._nbrs(torch.from_numpy(planes), bw, bh, depth, tile_px)
    assert (got["nby"], got["nbx"]) == (int(ref["nby"]), int(ref["nbx"]))
    for k in ("above_s", "left_s", "al_s", "dc", "ext"):
        r = np.asarray(ref[k])
        g = got[k].numpy()
        assert g.shape == r.shape, k
        assert np.array_equal(g.astype(r.dtype), r), k


def _ref_shape_costs(bw, bh, use_deltas, planes, tile_px):
    body = ref_dp._cost_body(bw, bh, 10, use_deltas, False)
    fn = jax.jit(lambda p, d, a, l, th, tw: body(p, d, a, l, (th, tw)))
    return np.asarray(fn(jnp.asarray(planes), jnp.float32(DC_Q),
                         jnp.float32(AC_Q), jnp.float32(LAM),
                         jnp.int32(tile_px[0]), jnp.int32(tile_px[1])))


@pytest.mark.parametrize("bw,bh", SHAPES + [(64, 64)])
def test_shape_cost_matches_reference(planes128, bw, bh):
    """ShapeCost (the plain K1 + K2 path; the materialized path at 64)
    against the reference's _cost_body, per block shape."""
    ud = min(bw, bh) >= 8 and max(bw, bh) < 64
    tile_px = (64, 128)
    ref = _ref_shape_costs(bw, bh, ud, planes128, tile_px)
    sc = dp.ShapeCost(bw, bh, 10, ud, "f32")
    with torch.inference_mode():
        got = sc(torch.from_numpy(planes128), float(DC_Q), float(AC_Q),
                 dp._f32(LAM), tile_px).numpy()
    assert got.shape == ref.shape
    assert sc.fused == (max(bw, bh) <= 32)
    blocks = ref.shape[0] * ref.shape[1] * ref.shape[2]
    pick = got.argmin(-1)
    ref_min = ref.min(-1)
    ref_at_pick = np.take_along_axis(ref, pick[..., None], -1)[..., 0]
    flips = pick != ref.argmin(-1)
    gap = (ref_at_pick - ref_min) / ref_min
    real = int((flips & (gap > 1e-5)).sum())
    d = np.abs(got - ref)
    off = int((d > 1e-4 * np.abs(ref) + 8.0).sum())
    # the measured agreement (shown with pytest -s)
    print(f"\n{bw}x{bh}: argmin flips {int(flips.sum())} of {blocks} blocks "
          f"({real} beyond near-ties; largest tie gap "
          f"{float(gap[flips].max(initial=0.0)):.2e}); costs beyond rtol 1e-4 "
          f"{int((d > 1e-4 * np.abs(ref)).sum())}, beyond rtol 1e-4 + atol 8 "
          f"{off}, of {ref.size}; max |d| {float(d.max()):.4g}")
    assert real < 1e-3 * blocks, (real, int(flips.sum()), blocks)
    assert off < 1e-3 * ref.size, (off, ref.size)


@pytest.mark.parametrize(
    "model,min_px,use_deltas",
    [("ycbcr", 4, True), ("mono", 8, False)],
)
def test_run_pass1_matches_reference(model, min_px, use_deltas):
    img = _image(256, 7)
    P = 3 if model == "ycbcr" else 1
    src = img if model == "ycbcr" else np.ascontiguousarray(img[..., 0])
    tile_px = (256, 128)
    key = (256, 256, 10, model, P, min_px, 32, use_deltas, 15.0, 2.0, 4.0)
    prog, spec = ref_dp._program(key + (False,))
    ref = np.asarray(prog(
        jnp.asarray(src), jnp.float32(DC_Q), jnp.float32(AC_Q),
        jnp.float32(LAM), jnp.int32(tile_px[0]), jnp.int32(tile_px[1])))
    out = dp.run_pass1(
        src, depth=10, model=model, num_planes=P, tile_px=tile_px,
        min_px=min_px, max_px=32, use_deltas=use_deltas, dc_q=DC_Q,
        ac_q=AC_Q, lam=LAM, device="cpu")
    mine = dp._program(key, "f32", "cpu")
    assert mine.spec == spec
    assert list(out) == [(s, n) for (s, n, _) in spec]
    packed = np.concatenate([out[(s, n)].reshape(-1) for (s, n, _) in spec])
    assert packed.dtype == np.int8 and packed.shape == ref.shape
    diff = int((packed != ref).sum())
    print(f"\n{model}: packed entries differ {diff} of {ref.size}")
    assert diff < 1e-3 * ref.size, (diff, ref.size)


def test_run_pass1_rejects_unknown_modes():
    img = _image(64, 1)
    kw = dict(depth=8, model="ycbcr", num_planes=3, tile_px=(64, 64),
              min_px=8, use_deltas=False, dc_q=20, ac_q=25, lam=210.0)
    with pytest.raises(ValueError):
        dp.run_pass1(img, device="cpu", matmul="tf32", **kw)
    with pytest.raises(ValueError):
        dp.run_pass1(img, device="xla", **kw)


def test_bf16_mode_rounds_matmul_inputs():
    """"bf16" rounds both operands to bfloat16 before an f32 product, as
    the TPU's default-precision dots did; "f32" keeps them."""
    rng = np.random.default_rng(2)
    planes = torch.from_numpy(
        rng.integers(0, 1024, (1, 64, 64)).astype(np.int32))
    f32 = dp.ShapeCost(8, 8, 10, True, "f32")
    b16 = dp.ShapeCost(8, 8, 10, True, "bf16")
    assert f32.mk.dtype == torch.float32 and b16.mk.dtype == torch.bfloat16
    assert torch.equal(b16.mk.float(), f32.mk.to(torch.bfloat16).float())
    args = (planes, 120.0, 150.0, 40.0, (64, 64))
    a, b = f32(*args), b16(*args)
    assert a.shape == b.shape and not torch.equal(a, b)
    # bf16 rounding perturbs costs slightly, never the scale of them
    assert float(((a - b).abs() / a.abs()).median()) < 1e-2
