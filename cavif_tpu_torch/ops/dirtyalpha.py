"""Dirty-alpha cleaner: rewrite RGB of transparent pixels so AV1 spends no
bits on invisible data.

Exact integer semantics of ravif src/dirtyalpha.rs:1-135,
re-expressed as vectorized windowed ops (the reference iterates a 3x3
neighborhood per pixel with edge *replication* via the loop9 crate; here each
pass is one pad-and-shift window sum):

  pass 1  dominant edge color: weighted average (weight = 256 - a) of
          semi-transparent pixels that touch a fully-transparent pixel in
          their 3x3 neighborhood; returns None if no such pixel exists.
  pass 2  bleed_opaque_color: replace every non-opaque pixel with the
          weighted 3x3 average (fallback: the pass-1 color), semi-transparent
          pixels clamped to the premultiply-rounding-safe range.
  pass 3  blur_transparent_pixels: plain 3x3 box blur (sum/9) on non-opaque
          pixels of the pass-2 output, same clamp.

premultiplied_minmax(px, a) = (min((r+16)/a, px), max((r+239)/a, px)) with
r = (px*a/255)*255 (dirtyalpha.rs:115-124).

The implementation is written once against an array namespace.
`blurred_dirty_alpha` runs it with numpy by default: that is the
reference's host path, and the encoder's UnassociatedClean alpha mode calls
it so. `backend="torch"` runs it on the card, bit-equal to numpy, and is
the faster of the two: on a 1024x1024 RGBA image with an NVIDIA H100 80GB
HBM3 (700.00 W) the torch backend took 3.4-3.7 ms with upload and fetch,
numpy 368-397 ms on that machine's host (chip_smoke.py's [dirtyalpha]
line). Torch tensors have no `.astype` and no edge padding, so the casts go
through `_cast` and `_TorchXP.pad` replicates the edge by clamped index
gathers.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _cast(x, dtype):
    """x.astype(dtype) on a numpy array, x.to(dtype) on a torch tensor."""
    return x.to(dtype) if isinstance(x, torch.Tensor) else x.astype(dtype)


class _TorchXP:
    """The numpy names that the passes use, on torch tensors."""

    int32, uint8 = torch.int32, torch.uint8
    where = staticmethod(torch.where)
    zeros_like = staticmethod(torch.zeros_like)
    minimum = staticmethod(torch.minimum)
    clip = staticmethod(torch.clamp)

    @staticmethod
    def pad(x, widths, mode):
        """Edge padding of the two leading axes (the only mode used)."""
        for ax, (lo, hi) in enumerate(widths[:2]):
            n = x.shape[ax]
            idx = torch.arange(-lo, n + hi, device=x.device).clamp(0, n - 1)
            x = x.index_select(ax, idx)
        return x

    @staticmethod
    def maximum(x, y: int):
        return x.clamp(min=y)

    @staticmethod
    def sum(x, axis):
        return torch.sum(x, dim=axis)

    @staticmethod
    def concatenate(xs, axis):
        return torch.cat(xs, dim=axis)


def _window9(xp, x):
    """Sum over the 3x3 neighborhood with edge replication. x: (H, W, C)."""
    p = xp.pad(x, ((1, 1), (1, 1)) + ((0, 0),) * (x.ndim - 2), mode="edge")
    h, w = x.shape[0], x.shape[1]
    total = xp.zeros_like(x)
    for dy in range(3):
        for dx in range(3):
            total = total + p[dy : dy + h, dx : dx + w]
    return total


def _weights(xp, a):
    """weighed_pixel weight: 0 if a == 0 else 256 - a (dirtyalpha.rs:5-14)."""
    return xp.where(a == 0, 0, 256 - a)


def _premultiplied_minmax(xp, px, a):
    """Safe color-change range for a semi-transparent pixel. a must be >= 1."""
    a_safe = xp.maximum(a, 1)
    rounded = (px * a_safe) // 255 * 255
    # the reference casts through u8 (mod-256) before min/max
    low = ((rounded + 16) // a_safe) & 0xFF
    hi = ((rounded + 239) // a_safe) & 0xFF
    return xp.minimum(low, px), xp.maximum(hi, px)


def _pass1_rowsums(xp, rgba):
    """Per-row weight/color sums of edge-adjacent semi-transparent pixels."""
    rgba = _cast(rgba, xp.int32)
    rgb, a = rgba[..., :3], rgba[..., 3]
    w = _weights(xp, a)
    semi = (a != 0) & (a != 255)
    clear = _cast(a == 0, xp.int32)[..., None]
    touches_clear = _window9(xp, clear)[..., 0] > 0
    m = semi & touches_clear
    wm = xp.where(m, w, 0)
    # Row sums stay in int32 (per-pixel max 255*255 = 65025; safe to ~32K
    # wide), final int64 accumulation happens after.
    wsum = xp.sum(wm, axis=1)
    csum = xp.sum(wm[..., None] * rgb, axis=1)
    return wsum, csum


def _pass23(xp, rgba, neutral):
    rgba = _cast(rgba, xp.int32)
    rgb, a = rgba[..., :3], rgba[..., 3]
    opaque = a == 255
    clear = a == 0

    # pass 2: bleed opaque color into transparent neighborhoods
    w = _weights(xp, a)
    w9 = _window9(xp, w[..., None])[..., 0]
    wc9 = _window9(xp, w[..., None] * rgb)
    avg = xp.where(
        (w9 > 0)[..., None],
        wc9 // xp.maximum(w9, 1)[..., None],
        neutral[None, None, :],
    )
    lo, hi = _premultiplied_minmax(xp, rgb, a[..., None])
    clamped = xp.clip(avg, lo, hi)
    bled = xp.where(
        opaque[..., None], rgb, xp.where(clear[..., None], avg, clamped)
    )

    # pass 3: 3x3 box blur over the pass-2 output
    s9 = _window9(xp, bled)
    blur = s9 // 9
    lo2, hi2 = _premultiplied_minmax(xp, bled, a[..., None])
    blur_clamped = xp.clip(blur, lo2, hi2)
    out_rgb = xp.where(
        opaque[..., None], bled, xp.where(clear[..., None], blur, blur_clamped)
    )
    return _cast(xp.concatenate([out_rgb, a[..., None]], axis=-1),
                 xp.uint8)


def blurred_dirty_alpha(
    rgba: np.ndarray, backend: str = "numpy", device=None
) -> Optional[np.ndarray]:
    """Clean invisible RGB data under transparency. rgba: (H, W, 4) uint8.

    Returns the cleaned image, or None when there is nothing to clean (no
    semi-transparent pixel adjacent to a fully-transparent one), matching
    dirtyalpha.rs:34-36. backend="torch" runs the passes on `device`
    (None: the card, raising without one; "cpu" for tests); the sums
    over rows go to int64 on the host, as the numpy backend's do.
    """
    if backend == "torch":
        from .device_pass1 import resolve_device

        x = torch.from_numpy(np.ascontiguousarray(rgba)).to(
            resolve_device(device))
        wsum_rows, csum_rows = _pass1_rowsums(_TorchXP, x)
        weights = int(wsum_rows.cpu().numpy().astype(np.int64).sum())
        if weights == 0:
            return None
        csum = csum_rows.cpu().numpy().astype(np.int64).sum(axis=0)
        neutral = torch.from_numpy((csum // weights).astype(np.int32))
        return _pass23(_TorchXP, x, neutral.to(x.device)).cpu().numpy()
    if backend != "numpy":
        raise ValueError(f"unknown dirty-alpha backend {backend!r}")
    x = np.asarray(rgba)
    wsum_rows, csum_rows = _pass1_rowsums(np, x)
    weights = int(wsum_rows.astype(np.int64).sum())
    if weights == 0:
        return None
    csum = csum_rows.astype(np.int64).sum(axis=0)
    neutral = (csum // weights).astype(np.int32)
    return _pass23(np, x, neutral)
