"""Color conversion ops: torch device versions + exact numpy host mirrors.

Reference semantics: ravif src/av1encoder.rs:483-524 --
BT.601 RGB->YCbCr at 8/10-bit with round-half-away-from-zero, the GBR identity
("RGB") model storing planes in (G, B, R) order, and the 8->10-bit expansion
to_ten(x) = (x << 2) | (x >> 6) so that 255 -> 1023.

The reference computes per pixel in f32 with fused multiply-adds and a final
`round()`; we compute the same formula vectorized in f32. The fused vs
unfused distinction can only matter when the pre-round value lands within
1 ulp of a .5 boundary, which the unit tests pin down against a NumPy f32
model of the exact reference expression.

The torch versions (to_ten / rgb_to_ycbcr / rgb_to_gbr / alpha_plane) run on
whatever device their input tensor lives on (the device pass 1 converts the
uploaded uint8 image on the card). Every product and sum is a separate f32
op, and the per-channel coefficients are the same f32 values the host
mirrors use, so both sides round identically. The *_host mirrors serve the
latency path.
"""

from __future__ import annotations

import numpy as np

# BT.601 luma coefficients (av1encoder.rs:501).
BT601 = (0.2990, 0.5870, 0.1140)
# BT.709 kept for completeness (the reference defines but does not use it).
REC709 = (0.2126, 0.7152, 0.0722)


def _ycbcr_consts(depth: int, matrix):
    """f32 coefficients of the conversion, as exact Python floats:
    (max_value, shift, scale*kr, scale*kg, scale*kb, scale,
    0.5/(1-kb), 0.5/(1-kr))."""
    kr, kg, kb = matrix
    max_value = np.float32((1 << depth) - 1)
    scale = np.float32(max_value / np.float32(255.0))
    shift = np.float32(np.round(max_value * np.float32(0.5)))
    return tuple(float(v) for v in (
        max_value, shift,
        np.float32(scale * kr), np.float32(scale * kg),
        np.float32(scale * kb), scale,
        np.float32(0.5 / (1.0 - kb)), np.float32(0.5 / (1.0 - kr)),
    ))


def to_ten(x):
    """8-bit -> 10-bit expansion: (x << 2) | (x >> 6); maps 255 -> 1023."""
    import torch

    x = x.to(torch.int32)
    return (x << 2) | (x >> 6)


def rgb_to_ycbcr(rgb, depth: int = 10, matrix=BT601):
    """Convert (..., 3) uint8 RGB to (..., 3) int32 YCbCr at `depth` bits.

    Full-range: scale = (2^d - 1)/255, shift = round((2^d - 1) * 0.5);
    cb = (B*scale - y) * 0.5/(1-Kb) + shift, cr analogous; every channel
    rounded half-away-from-zero and saturated like Rust's `as u16`.
    """
    import torch

    (max_value, shift, skr, skg, skb, scale, cbf, crf) = _ycbcr_consts(
        depth, matrix)
    r = rgb[..., 0].to(torch.float32)
    g = rgb[..., 1].to(torch.float32)
    b = rgb[..., 2].to(torch.float32)
    y = r * skr + g * skg + b * skb
    cb = (b * scale - y) * cbf + shift
    cr = (r * scale - y) * crf + shift

    def round_cast(v):
        return torch.clamp(
            torch.floor(v + 0.5), 0.0, max_value
        ).to(torch.int32)

    return torch.stack(
        [round_cast(y), round_cast(cb), round_cast(cr)], dim=-1
    )


def rgb_to_gbr(rgb, depth: int = 10):
    """Identity-matrix ("RGB") model: planes in (G, B, R) order; at
    10-bit each channel goes through to_ten (av1encoder.rs:491-498)."""
    import torch

    gbr = torch.stack(
        [rgb[..., 1], rgb[..., 2], rgb[..., 0]], dim=-1
    ).to(torch.int32)
    if depth == 10:
        gbr = to_ten(gbr)
    return gbr


def alpha_plane(alpha, depth: int = 10):
    """Alpha plane at target depth (to_ten at 10-bit, av1encoder.rs:271)."""
    import torch

    a = alpha.to(torch.int32)
    return to_ten(a) if depth == 10 else a


# ---------------------------------------------------------------------------
# Host (numpy) mirrors — identical f32 arithmetic, equality-tested.
# ---------------------------------------------------------------------------


def rgb_to_ycbcr_host(rgb, depth: int = 10, matrix=BT601, threads: int = 0):
    """Exact-f32 conversion. Dispatches to the threaded C++ mirror when
    the native runtime is available (bit-identical; pinned in
    tests/test_colorspace.py), else the numpy pipeline below."""
    kr, kg, kb = matrix
    if rgb.dtype == np.uint8:
        try:
            from ..native import rgb_to_ycbcr as native_convert
            import os as _os

            return native_convert(
                rgb, depth, kr, kb,
                n_threads=threads or (_os.cpu_count() or 1),
            )
        except Exception:
            pass
    max_value = np.float32((1 << depth) - 1)
    scale = np.float32(max_value / np.float32(255.0))
    shift = np.float32(np.round(max_value * np.float32(0.5)))
    r = rgb[..., 0].astype(np.float32)
    g = rgb[..., 1].astype(np.float32)
    b = rgb[..., 2].astype(np.float32)
    y = (
        np.float32(scale * kr) * r
        + np.float32(scale * kg) * g
        + np.float32(scale * kb) * b
    )
    cb = (b * scale - y) * np.float32(0.5 / (1.0 - kb)) + shift
    cr = (r * scale - y) * np.float32(0.5 / (1.0 - kr)) + shift

    def round_cast(v):
        return np.clip(
            np.floor(v + np.float32(0.5)), 0, max_value
        ).astype(np.int32)

    return np.stack([round_cast(y), round_cast(cb), round_cast(cr)], axis=-1)


def rgb_to_gbr_host(rgb, depth: int = 10):
    gbr = np.stack(
        [rgb[..., 1], rgb[..., 2], rgb[..., 0]], axis=-1
    ).astype(np.int32)
    if depth == 10:
        gbr = (gbr << 2) | (gbr >> 6)
    return gbr


def alpha_plane_host(alpha, depth: int = 10):
    a = alpha.astype(np.int32)
    return ((a << 2) | (a >> 6)) if depth == 10 else a
