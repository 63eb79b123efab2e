"""AV1 transform layer: forward DCT + decoder-matched inverse model.

Split of responsibilities:
- The *bitstream* carries quantized levels; legality never depends on the
  encoder's transform arithmetic.
- The *decoder* reconstructs with the normative integer butterflies. The
  encoder's reconstruction path uses the exact integer mirror
  (native/tilecoder.cpp inv_txfm_exact, exposed to Python via
  native.inv_txfm_exact) — bit-exact with dav1d. This module's float
  orthonormal model with a calibrated per-size gain serves the *search*
  (cost estimation), where +-1 LSB does not matter.
- The forward transform is encoder-private: orthonormal DCT-II, quantizer
  folded in via the same calibrated gain so level*ac_q maps back to the
  intended residual amplitude.

All functions are vectorized over a leading batch axis (blocks), mapping
directly onto the MXU as batched matmuls when jitted (the device path uses
the same matrices in bf16/f32 via ops/ kernels).

Reference parity: rav1e tx pipeline (forward 7.13-equivalent), exercised by
/root/reference/ravif/src/av1encoder.rs:748-771.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np


@lru_cache(maxsize=None)
def dct2_matrix(n: int, dtype=np.float64) -> np.ndarray:
    """Orthonormal DCT-II matrix D (rows = frequencies): X = D @ x."""
    k = np.arange(n)
    d = np.cos(np.pi * (2 * k[None, :] + 1) * k[:, None] / (2 * n))
    d *= np.sqrt(2.0 / n)
    d[0] /= np.sqrt(2.0)
    return d.astype(dtype)


# Measured end-to-end decoder gain: pixel = gain * orthonormal_idct2d(level*q).
# Calibrated against dav1d via tools/calibrate_gain.py; analytic prior:
# the AV1 integer inverse is sqrt(w/2)*sqrt(h/2) * 2^-(rowshift+colshift)
# relative to orthonormal, with the 1/sqrt(2) rect factor when
# log2(w)+log2(h) is odd, and dequant >> tx_scale folded in.
_GAIN: dict[tuple[int, int], float] = {}


def set_gain(w: int, h: int, gain: float) -> None:
    _GAIN[(w, h)] = gain


def get_gain(w: int, h: int) -> float:
    """Measured against dav1d: the AV1 dequant + integer-inverse-transform
    chain has linear gain exactly 1/8 relative to the orthonormal idct for
    EVERY tx size, including TX_8X4/TX_4X8 (roundtrip through the
    dav1d-exact integer inverse in tests/test_recon_exact.py::
    test_gain_roundtrip_all_sizes). An earlier calibration wrongly special-
    cased 8x4/4x8 at 1/4, silently halving every coded 8x4 residual."""
    return _GAIN.get((w, h), 0.125)


def forward_dct2d(res: np.ndarray) -> np.ndarray:
    """res: (..., h, w) float -> orthonormal 2D DCT-II coefficients."""
    h, w = res.shape[-2], res.shape[-1]
    dt = res.dtype if res.dtype in (np.float32, np.float64) else np.float64
    dh, dw = dct2_matrix(h, dt), dct2_matrix(w, dt)
    return dh @ res @ dw.T


def inverse_dct2d(coef: np.ndarray) -> np.ndarray:
    h, w = coef.shape[-2], coef.shape[-1]
    dt = coef.dtype if coef.dtype in (np.float32, np.float64) else np.float64
    dh, dw = dct2_matrix(h, dt), dct2_matrix(w, dt)
    return dh.T @ coef @ dw


def level_limits(dc_q: int, ac_q: int, bit_depth: int) -> tuple:
    """Conformance bound: the dequantized coefficient |level * q| must stay
    below 1 << (7 + BitDepth) (spec 7.13.3 dequantization; dav1d/libaom
    reject streams exceeding it). Returns (max_dc_level, max_ac_level)."""
    coeff_max = (1 << (7 + bit_depth)) - 1
    return min(32767, coeff_max // dc_q), min(32767, coeff_max // ac_q)


# Quantizer rounding biases: DC rounds to nearest; AC uses a deadzone
# (the standard rate/distortion asymmetry of zeroing marginal
# coefficients). 0.42 re-measured best on the BD corpus: vs the old 0.35
# it gains +0.018 dB BD-PSNR AND +0.0007 BD-SSIM at matched rate — the
# EOB-optimize/RD trims marginal coefficients better than a harder
# pre-deadzone does. Env override is A/B tooling.
DC_BIAS = 0.5
import os as _os

AC_BIAS = float(_os.environ.get("CAVIF_TPU_AC_BIAS", "0.42"))


def quantize_block(
    coef: np.ndarray,
    dc_q: int,
    ac_q: int,
    w: int,
    h: int,
    bias: float = None,
    bit_depth: int = 10,
) -> np.ndarray:
    """Map orthonormal forward coefficients to AV1 levels.

    Decoder applies pixel = gain * idct(level * q), so the target level is
    coef / (gain * q). AC bias < 0.5 gives a deadzone (rate-cheaper zeros).
    Levels are clamped to the spec's dequant conformance bound.
    """
    g = get_gain(w, h)
    ft = coef.dtype.type if coef.dtype in (np.float32, np.float64) else np.float64
    t = coef * ft(1.0 / (float(ac_q) * g))
    t[..., 0, 0] = coef[..., 0, 0] * ft(1.0 / (float(dc_q) * g))
    ac_bias = ft(AC_BIAS if bias is None else bias)
    dc_bias = ft(DC_BIAS if bias is None else bias)
    lv = (np.sign(t) * np.floor(np.abs(t) + ac_bias)).astype(np.int32)
    tdc = t[..., 0, 0]
    lv[..., 0, 0] = (np.sign(tdc) * np.floor(np.abs(tdc) + dc_bias)).astype(
        np.int32
    )
    max_dc, max_ac = level_limits(dc_q, ac_q, bit_depth)
    dc = np.clip(lv[..., 0, 0], -max_dc, max_dc)
    np.clip(lv, -max_ac, max_ac, out=lv)
    lv[..., 0, 0] = dc
    return lv


def dequant_reconstruct(
    levels: np.ndarray, dc_q: int, ac_q: int, dtype=np.float64
) -> np.ndarray:
    """Model of decoder reconstruction: residual pixels (float, unrounded)."""
    h, w = levels.shape[-2], levels.shape[-1]
    g = get_gain(w, h)
    x = levels.astype(dtype) * dtype(float(ac_q) * g)
    x[..., 0, 0] = levels[..., 0, 0] * dtype(float(dc_q) * g)
    return inverse_dct2d(x)


# Mode -> (vertical_adst, horizontal_adst) for the derived chroma transform
# (Mode_To_Txfm_Type; IDTX/flip types never arise here)
MODE_V_ADST = [0, 1, 0, 0, 1, 1, 0, 0, 1, 1, 1, 0, 1]
MODE_H_ADST = [0, 0, 1, 0, 1, 0, 1, 1, 0, 1, 0, 1, 1]


def forward_tx2d(res: np.ndarray, v_adst: int = 0, h_adst: int = 0) -> np.ndarray:
    """Forward transform with per-axis DCT/ADST basis (float, encoder-side;
    the ADST basis is the normalized exact linear inverse from itx.py)."""
    if not v_adst and not h_adst:
        return forward_dct2d(res)
    from .itx import iadst_basis

    h, w = res.shape[-2], res.shape[-1]
    dt = res.dtype if res.dtype in (np.float32, np.float64) else np.float64
    dv = iadst_basis(h).T.astype(dt) if v_adst else dct2_matrix(h, dt)
    dh_ = iadst_basis(w).T.astype(dt) if h_adst else dct2_matrix(w, dt)
    return dv @ res @ dh_.T
