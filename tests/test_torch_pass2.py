"""The port's pass-2 reconstruction wavefront (cavif_tpu_torch.ops.
device_pass2) on the CPU, held EXACTLY against a live host walk and the
JAX package's executors.

A real FrameEncoder encode of the port (host cascade, python entropy
coder) with a forced uniform 16px NONE partition provides the skeleton
decisions and coded levels (tools/pass2_cases.host_walk_case); the
port's executors must reproduce the host's reconstruction plane bit for
bit. On seeded random decisions the
scan and frame executors must equal the JAX functions (run on the JAX CPU
backend), and the host preparation (BlockDecoded flags, the wavefront
schedule) must equal the reference's."""

import numpy as np
import pytest
import torch

from cavif_tpu.ops import device_pass2 as ref_p2
from cavif_tpu_torch.ops import device_pass2 as p2
from cavif_tpu_torch.tools.pass2_cases import host_walk_case, random_frame

DQ, AQ = 499, 616


def test_wavefront_recon_matches_host():
    levels, modes, deltas, va, ha, dq, aq, ref = host_walk_case()
    # the walk's decisions exercise ADST variants and coded residuals
    assert np.any(va != 0) and np.any(ha != 0) and np.any(levels != 0)
    for f in (p2.recon_wavefront_uniform, p2.recon_wavefront_scan):
        got = f(levels, modes, deltas, va, ha, 128, 128, dq, aq, 10, 16,
                device="cpu")
        assert got.dtype == np.int32
        assert np.array_equal(got, ref), (
            f.__name__, int(np.abs(got - ref).max()), int((got != ref).sum()))


@pytest.mark.parametrize("grid", [(1, 1), (2, 2)])
def test_frame_executor_matches_per_plane(grid):
    """(1, 1): the frame equals the per-plane scans; (2, 2): each tile
    equals an independent per-tile scan (tiles are prediction-independent;
    neighbor extensions clamp at the tile edge like the host pass 2)."""
    H = W = 128
    n, P = 16, 3
    nby = nbx = H // n
    levels, modes, deltas, va, ha = random_frame(1, P, H, W)
    got = p2.recon_wavefront_scan_frame(
        levels, modes, deltas, va, ha, H, W, DQ, AQ, 10, n, tile_grid=grid,
        device="cpu")
    tr, tc = grid
    for p in range(P):
        for ty in range(tr):
            for tx in range(tc):
                b0, b1 = ty * nby // tr, (ty + 1) * nby // tr
                c0, c1 = tx * nbx // tc, (tx + 1) * nbx // tc
                sub = p2.recon_wavefront_scan(
                    levels[p, b0:b1, c0:c1], modes[p, b0:b1, c0:c1],
                    deltas[p, b0:b1, c0:c1], va[p, b0:b1, c0:c1],
                    ha[p, b0:b1, c0:c1], (b1 - b0) * n, (c1 - c0) * n,
                    DQ, AQ, 10, n, device="cpu")
                assert np.array_equal(
                    got[p, b0 * n:b1 * n, c0 * n:c1 * n], sub), (p, ty, tx)


def test_frame_tiles_clamp_at_the_tile_edge():
    """Tiles of two superblock rows (128 px), where a block on a tile's
    right edge may read above-right: the extension must stop at the tile
    edge, as an independent per-tile scan's plane edge does."""
    H = W = 256
    n = 16
    levels, _modes, _deltas, va, ha = random_frame(2, 1, H, W)
    # D45 everywhere: every block reads its above-right extension
    modes = np.full_like(_modes, 3)
    deltas = np.zeros_like(_deltas)
    have_ar, _ = p2._mask_flags(8, 8)
    assert have_ar[:, -1].any()  # the case this test is for occurs
    got = p2.recon_wavefront_scan_frame(
        levels, modes, deltas, va, ha, H, W, DQ, AQ, 10, n,
        tile_grid=(2, 2), device="cpu")
    for ty in range(2):
        for tx in range(2):
            b, c = slice(ty * 8, ty * 8 + 8), slice(tx * 8, tx * 8 + 8)
            sub = p2.recon_wavefront_scan(
                levels[0, b, c], modes[0, b, c], deltas[0, b, c],
                va[0, b, c], ha[0, b, c], 128, 128, DQ, AQ, 10, n,
                device="cpu")
            assert np.array_equal(
                got[0, ty * 128:(ty + 1) * 128, tx * 128:(tx + 1) * 128],
                sub), (ty, tx)


def test_executors_match_jax():
    H, W = 128, 96
    levels, modes, deltas, va, ha = random_frame(3, 2, H, W)
    args = (H, W, DQ, AQ, 10, 16)
    one = [a[0] for a in (levels, modes, deltas, va, ha)]
    scan = p2.recon_wavefront_scan(*one, *args, device="cpu")
    assert np.array_equal(scan, np.asarray(ref_p2.recon_wavefront_scan(
        *one, *args)))
    assert np.array_equal(
        p2.recon_wavefront_uniform(*one, *args, device="cpu"), scan)
    frame = p2.recon_wavefront_scan_frame(
        levels, modes, deltas, va, ha, *args, tile_grid=(2, 3),
        device="cpu")
    assert np.array_equal(frame, np.asarray(
        ref_p2.recon_wavefront_scan_frame(
            levels, modes, deltas, va, ha, *args, tile_grid=(2, 3))))


@pytest.mark.parametrize("nby,nbx", [(8, 8), (5, 7), (4, 12), (9, 3)])
def test_host_preparation_matches_reference(nby, nbx):
    flags = p2._mask_flags(nby, nbx)
    ref_flags = ref_p2._mask_flags(nby, nbx)
    assert all(np.array_equal(a, b) for a, b in zip(flags, ref_flags))
    assert p2._schedule(nby, nbx, *flags) == ref_p2._schedule(
        nby, nbx, *ref_flags)


@pytest.mark.parametrize("grid", [None, (1, 1), (2, 3)])
def test_every_block_written_by_one_lane(grid):
    """Every pixel of every plane is written by exactly one lane, so each
    level's scatter is unique; the compact tables hold one lane per block
    and no padding. None is the single-plane form of the scan entry
    point."""
    H, W, n = 80, 112, 16
    levels, modes, deltas, va, ha = random_frame(5, 2, H, W)
    if grid is None:
        P = 1
        tabs = p2._frame_inputs(levels[:1], modes[:1], deltas[:1], va[:1],
                                ha[:1], H, W, n, (1, 1))
    else:
        P = 2
        tabs = p2._frame_inputs(levels, modes, deltas, va, ha, H, W, n,
                                grid)
    starts, pl, oy, ox = tabs[0], tabs[1], tabs[-2], tabs[-1]
    assert starts[0] == 0 and np.all(np.diff(starts) > 0)
    assert starts[-1] == len(pl) == P * (H // n) * (W // n)
    count = np.zeros((P, H, W), np.int32)
    for p, y0, x0 in zip(pl, oy, ox):
        count[p, y0:y0 + n, x0:x0 + n] += 1
    assert np.all(count == 1)


@pytest.mark.parametrize("entry", ["uniform", "scan", "frame"])
def test_default_device_raises_without_a_card(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    levels, modes, deltas, va, ha = random_frame(0, 1, 32, 32)
    args = (32, 32, DQ, AQ, 10, 16)
    calls = {
        "uniform": lambda: p2.recon_wavefront_uniform(
            levels[0], modes[0], deltas[0], va[0], ha[0], *args),
        "scan": lambda: p2.recon_wavefront_scan(
            levels[0], modes[0], deltas[0], va[0], ha[0], *args),
        "frame": lambda: p2.recon_wavefront_scan_frame(
            levels, modes, deltas, va, ha, *args),
    }
    with pytest.raises(RuntimeError, match="cuda"):
        calls[entry]()
