"""The port's batched intra predictors (cavif_tpu_torch.ops.device_predict)
on the CPU, held EXACTLY against the port's scalar host predictors
(av1/predict.py) and against the JAX package's device_predict (run on the
JAX CPU backend) on the same seeded neighbors: the non-directional and
directional cases of tests/test_device_predict.py, the full-fan body
against the selected-lane body on every candidate, and the constant
tables against the reference's."""

import inspect

import numpy as np
import pytest
import torch

from cavif_tpu.ops import device_predict as ref_dp
from cavif_tpu_torch.av1.predict import predict_all_batch, predict_dir_batch
from cavif_tpu_torch.ops import device_predict as dp

NONDIR_IDS = [0, 9, 10, 11, 12]
ND_ROW = {0: 0, 9: 3, 10: 4, 11: 5, 12: 6}  # id -> predict_all_batch row


def _neighbors(rng, B, bw, bh, bit_depth=10):
    base = 1 << (bit_depth - 1)
    L = bw + bh
    above = rng.integers(0, 1 << bit_depth, (B, L)).astype(np.int32)
    left = rng.integers(0, 1 << bit_depth, (B, L)).astype(np.int32)
    al = rng.integers(0, 1 << bit_depth, B).astype(np.int32)
    have_a = rng.random(B) < 0.8
    have_l = rng.random(B) < 0.8
    # apply the host search's availability synthesis to the ext arrays
    for i in range(B):
        if not have_a[i] and not have_l[i]:
            above[i] = base - 1
            left[i] = base + 1
            al[i] = base
        elif not have_a[i]:
            above[i] = left[i, 0]
            al[i] = left[i, 0]
        elif not have_l[i]:
            left[i] = above[i, 0]
            al[i] = above[i, 0]
    return above, left, al, have_a, have_l


def _both(modes, deltas, nb, bw, bh):
    got = dp.predict_batch_exact(modes, deltas, *nb, bw, bh, 10,
                                 device="cpu")
    jx = ref_dp.predict_batch_exact(modes, deltas, *nb, bw, bh, 10)
    assert got.dtype == np.int32 and np.array_equal(got, np.asarray(jx))
    return got


@pytest.mark.parametrize("bw,bh", [(8, 8), (16, 16), (32, 32), (16, 8)])
def test_nondirectional_exact(bw, bh):
    rng = np.random.default_rng(bw + bh)
    B = 64
    nb = _neighbors(rng, B, bw, bh)
    above, left, al, have_a, have_l = nb
    ref7 = predict_all_batch(
        above[:, :bw], left[:, :bh], al, have_a, have_l, bw, bh, 10
    )
    for mid in NONDIR_IDS:
        got = _both(np.full(B, mid), np.zeros(B, np.int32), nb, bw, bh)
        assert np.array_equal(got, ref7[:, ND_ROW[mid]]), (bw, bh, mid)


@pytest.mark.parametrize("bw,bh", [(8, 8), (16, 16), (16, 8), (8, 16)])
def test_directional_exact(bw, bh):
    rng = np.random.default_rng(100 + bw + bh)
    B = 48
    nb = _neighbors(rng, B, bw, bh)
    above, left, al, _, _ = nb
    cands = [(m, d) for m in range(1, 9) for d in (-3, -1, 0, 2, 3)]
    modes = np.asarray([cands[i % len(cands)][0] for i in range(B)])
    deltas = np.asarray([cands[i % len(cands)][1] for i in range(B)])
    got = _both(modes, deltas, nb, bw, bh)
    for i in range(B):
        exp = predict_dir_batch(
            [(int(modes[i]), int(deltas[i]))],
            above[i : i + 1], left[i : i + 1], al[i : i + 1], bw, bh,
        )[0, 0]
        assert np.array_equal(got[i], exp), (bw, bh, int(modes[i]),
                                             int(deltas[i]), i)


@pytest.mark.parametrize("use_deltas", [True, False])
@pytest.mark.parametrize("n", [8, 16])
def test_select_body_equals_full_fan_on_every_candidate(n, use_deltas):
    C = len(dp._cand_index(use_deltas))
    rng = np.random.default_rng(n + 2 * use_deltas)
    B = 3 * C
    nb = [torch.from_numpy(np.ascontiguousarray(a))
          for a in _neighbors(rng, B, n, n)]
    cand = torch.arange(B, dtype=torch.int64) % C
    full = dp.pred_body(n, n, 10, use_deltas, "cpu")(*nb, cand)
    sel = dp.pred_body_select(n, n, 10, use_deltas, "cpu")(*nb, cand)
    assert full.dtype == sel.dtype == torch.int32
    assert torch.equal(full, sel)


@pytest.mark.parametrize("use_deltas", [True, False])
def test_tables_equal_the_reference(use_deltas):
    assert dp._cand_index(use_deltas) == ref_dp._cand_index(use_deltas)
    for n in (8, 16):
        run = ref_dp.pred_body_select(n, n, 10, use_deltas)
        ref_tpack = inspect.getclosurevars(run).nonlocals["tpack"]
        assert np.array_equal(dp._tap_table(n, n, use_deltas), ref_tpack)


def test_predict_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    nb = _neighbors(np.random.default_rng(0), 2, 8, 8)
    with pytest.raises(RuntimeError, match="cuda"):
        dp.predict_batch_exact(np.zeros(2), np.zeros(2), *nb, 8, 8, 10)
