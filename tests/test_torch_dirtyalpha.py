"""The port's dirty-alpha cleaner on its torch backend
(cavif_tpu_torch.ops.dirtyalpha, backend="torch", on the CPU), held
EXACTLY against the port's numpy backend and the JAX package's jax
backend on the images of tests/test_dirtyalpha.py, including the images
that have nothing to clean (None)."""

import numpy as np
import pytest
import torch

from cavif_tpu.ops.dirtyalpha import blurred_dirty_alpha as ref_clean
from cavif_tpu_torch.ops.dirtyalpha import blurred_dirty_alpha


def _opaque():
    img = np.full((8, 8, 4), 200, np.uint8)
    img[..., 3] = 255
    return img


def _no_semitransparent_edge():
    img = np.zeros((8, 8, 4), np.uint8)
    img[:4, :, 3] = 255
    return img


def _mixed(seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, size=(11, 13, 4), dtype=np.uint8)
    img[..., 3] = rng.choice([0, 30, 128, 255], size=(11, 13),
                             p=[0.3, 0.2, 0.2, 0.3])
    return img


def _three_alphas():
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, size=(9, 9, 4), dtype=np.uint8)
    img[..., 3] = rng.choice([0, 60, 255], size=(9, 9))
    return img


CASES = {
    "opaque": _opaque,
    "no_semitransparent_edge": _no_semitransparent_edge,
    "mixed0": lambda: _mixed(0),
    "mixed1": lambda: _mixed(1),
    "mixed2": lambda: _mixed(2),
    "mixed3": lambda: _mixed(3),
    "three_alphas": _three_alphas,
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_torch_backend_matches_numpy_and_jax(name):
    img = CASES[name]()
    got = blurred_dirty_alpha(img, backend="torch", device="cpu")
    want = blurred_dirty_alpha(img)
    jx = ref_clean(img, backend="jax")
    if name in ("opaque", "no_semitransparent_edge"):
        assert got is None and want is None and jx is None
        return
    assert got is not None and want is not None
    assert got.dtype == np.uint8 and got.shape == img.shape
    assert np.array_equal(got, want), np.argwhere(got != want)[:5]
    assert np.array_equal(got, np.asarray(jx))
    assert np.array_equal(got[..., 3], img[..., 3])


def test_torch_backend_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        blurred_dirty_alpha(_mixed(0), backend="torch")
