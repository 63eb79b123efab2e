"""The port's inverse transforms (cavif_tpu_torch.ops.device_itx) on the
CPU, held EXACTLY against the port's native.inv_txfm_exact (int64 C++)
and against the JAX package's device_itx.inv_txfm_batch (run on the JAX
CPU backend) on the same seeded levels: every transform size and the
DCT/ADST combinations of tests/test_device_itx.py."""

import numpy as np
import pytest
import torch

from cavif_tpu.ops import device_itx as ref_itx
from cavif_tpu_torch.native import inv_txfm_exact
from cavif_tpu_torch.ops.device_itx import inv_txfm_batch

SIZES = [
    (4, 4), (8, 8), (16, 16), (32, 32), (64, 64),
    (8, 4), (4, 8), (16, 8), (8, 16), (32, 16), (16, 32),
]
DC_Q, AC_Q, BD = 499, 616, 10


def _check(levels, txw, txh, va=0, ha=0):
    got = inv_txfm_batch(levels, txw, txh, DC_Q, AC_Q, BD, va, ha,
                         device="cpu")
    assert got.dtype == np.int32 and got.shape == (len(levels), txh, txw)
    jx = ref_itx.inv_txfm_batch(levels, txw, txh, DC_Q, AC_Q, BD, va, ha)
    assert np.array_equal(got, jx), (txw, txh, va, ha, "jax")
    for b in range(len(levels)):
        ref = inv_txfm_exact(levels[b], txw, txh, DC_Q, AC_Q, BD, va, ha)
        assert np.array_equal(got[b], ref), (
            txw, txh, va, ha, b, int(np.abs(got[b] - ref).max()))


@pytest.mark.parametrize("txw,txh", SIZES)
def test_inv_txfm_matches_native_and_jax(txw, txh):
    rng = np.random.default_rng(txw * 100 + txh)
    cw, ch = min(txw, 32), min(txh, 32)
    cf_max = (1 << (BD + 7)) - 1
    B = 8
    levels = np.zeros((B, ch, cw), np.int32)
    for b in range(B):
        nnz = rng.integers(1, 12)
        ys = rng.integers(0, ch, nnz)
        xs = rng.integers(0, cw, nnz)
        mx = max(1, min(cf_max // AC_Q, 300))
        levels[b, ys, xs] = rng.integers(-mx, mx + 1, nnz)
    # one dense block: every lane of both passes carries data
    levels[0] = rng.integers(-40, 41, (ch, cw))
    _check(levels, txw, txh)


@pytest.mark.parametrize("va,ha", [(1, 0), (0, 1), (1, 1)])
def test_inv_txfm_adst_matches_native_and_jax(va, ha):
    rng = np.random.default_rng(7 + va * 2 + ha)
    for (txw, txh) in ((4, 4), (8, 8), (16, 16), (8, 16), (16, 8)):
        levels = rng.integers(-120, 121, (6, txh, txw)).astype(np.int32)
        _check(levels, txw, txh, va, ha)


def test_inv_txfm_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        inv_txfm_batch(np.zeros((1, 4, 4), np.int32), 4, 4, DC_Q, AC_Q, BD)
