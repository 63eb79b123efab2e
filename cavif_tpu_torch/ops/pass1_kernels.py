"""The two hand-written Hopper kernels of the device pass 1, with their
plain PyTorch versions.

- `dir_cost` (csrc/pass1_dir_cost.cu) replaces the TPU kernel
  `_fused_dir_cost` of cavif_tpu/ops/device_pass1.py: the directional
  candidate fan priced in the coefficient domain,
  coef = bkt - (ext @ MK) / 32 - cc, quantized, and summed per candidate.
- `nd_cost` (csrc/pass1_nd_cost.cu) replaces `_fused_nd_cost`: the five
  nondirectional predictors (DC, SMOOTH, SMOOTH_V, SMOOTH_H, PAETH) built
  exactly, their residuals through the Kronecker DCT, quantized, and summed
  per predictor.

Both kernels share one per-lane cost, in the |coef| domain:
  l = floor(|coef| * inv + bias),  e = |coef| - l * scale,
  u = e * e + lam * (l + 2 * [l != 0]),  cost = sum over lanes of u.

A wrapper takes the plain version for tensors on the CPU and launches its
kernel for tensors on a CUDA device (or raises). The matmul inputs' rounding
follows the dtype of the constant matrix: a bfloat16 `mk` / `kt` rounds the
other operand to bfloat16 too (round to nearest even, as the TPU's default
precision did) and accumulates in f32; a float32 matrix keeps full f32
inputs. The kernels take bfloat16 matrices only.

The CUDA sources are compiled with nvcc into plain-C shared libraries under
cavif_tpu_torch/_build/ on the first CUDA call, and loaded with ctypes
(ops/cuda_build.py). Importing this module needs neither nvcc nor a GPU.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import cuda_build
from .cuda_build import check as _check

# launches of each kernel in this process (the plain versions count nothing)
LAUNCHES = {"dir_cost": 0, "nd_cost": 0}

_lock = threading.Lock()
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def reset_launches() -> None:
    with _lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _count(name: str) -> None:
    with _lock:
        LAUNCHES[name] += 1


def _mm(x, w):
    """x @ w with the input rounding that w's dtype names (see module
    docstring); f32 result."""
    if w.dtype == torch.bfloat16:
        return x.to(torch.bfloat16).float() @ w.float()
    return x @ w


def lane_cost(a, inv, scale, bias, lam):
    """Per-lane quantizer cost of |coef| values `a` (see module docstring)."""
    l = torch.floor(a * inv + bias)
    e = a - l * scale
    return e * e + lam * (l + 2.0 * (l != 0.0))


# ---------------------------------------------------------------------------
# K1: directional candidate costs
# ---------------------------------------------------------------------------


def dir_cost_ref(ext, bkt, mk, cc, inv, scale, bias, lam):
    """Plain version of `dir_cost`. ext (R, E) f32, bkt (R, n2) f32,
    mk (E, cdir*n2) f32 or bf16, cc/inv/scale/bias (n2,) f32, lam a float.
    Returns (R, cdir) f32."""
    R, n2 = bkt.shape
    cdir = mk.shape[1] // n2
    cp = _mm(ext, mk).view(R, cdir, n2)
    a = (bkt[:, None, :] - (cp * (1.0 / 32.0) + cc)).abs()
    return lane_cost(a, inv, scale, bias, lam).sum(-1)


def dir_cost(ext, bkt, mk, cc, inv, scale, bias, lam):
    """Directional-family costs (R, cdir): the plain version on the CPU,
    the CUDA kernel on a CUDA device."""
    if ext.device.type == "cpu":
        return dir_cost_ref(ext, bkt, mk, cc, inv, scale, bias, lam)
    R, E = ext.shape
    n2 = bkt.shape[1]
    if mk.shape[1] % n2:
        raise ValueError("dir_cost: mk width is not a multiple of n2")
    cdir = mk.shape[1] // n2
    if n2 < 16 or n2 & (n2 - 1):
        raise ValueError(f"dir_cost: n2 {n2} is not a power of two >= 16")
    dev, f32 = ext.device, torch.float32
    _check("ext", ext, (R, E), f32, dev)
    _check("bkt", bkt, (R, n2), f32, dev)
    _check("mk", mk, (E, cdir * n2), torch.bfloat16, dev)
    for nm, t in (("cc", cc), ("inv", inv), ("scale", scale),
                  ("bias", bias)):
        _check(nm, t, (n2,), f32, dev)
    out = torch.empty((R, cdir), dtype=f32, device=dev)
    if R == 0:
        return out
    fn = cuda_build.function(
        "dir_cost", "pass1_dir_cost",
        [_P, _P, _P, _P, _P, _P, _P, _F, _P, _I, _I, _I, _I, _P])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(ext.data_ptr(), bkt.data_ptr(), mk.data_ptr(),
                 cc.data_ptr(), inv.data_ptr(), scale.data_ptr(),
                 bias.data_ptr(), float(lam), out.data_ptr(),
                 R, E, n2, cdir, stream)
    if err != 0:
        raise RuntimeError(f"pass1_dir_cost launch failed: CUDA error {err}")
    _count("dir_cost")
    return out


# ---------------------------------------------------------------------------
# K2: nondirectional predictor costs
# ---------------------------------------------------------------------------


def nd_preds(above, left, al, dc, whv, wwv):
    """The five nondirectional predictors (DC, SMOOTH, SMOOTH_V, SMOOTH_H,
    PAETH) over the row-major (y * bw + x) pixel order, exactly as the
    reference's integer-valued f32 expressions. above (R, bw), left (R, bh),
    al/dc (R,), whv/wwv (n2,) f32. Returns (R, 5, n2) f32."""
    R, bw = above.shape
    bh = left.shape[1]
    n2 = bw * bh
    a2 = above[:, None, :].expand(R, bh, bw).reshape(R, n2)
    l2 = left[:, :, None].expand(R, bh, bw).reshape(R, n2)
    below = left[:, bh - 1 : bh]
    right = above[:, bw - 1 : bw]
    alb = al[:, None]
    tsm = (whv * a2 + (256.0 - whv) * below + wwv * l2
           + (256.0 - wwv) * right)
    smooth = torch.floor((tsm + 256.0) * (1.0 / 512.0))
    smooth_v = torch.floor((whv * a2 + (256.0 - whv) * below + 128.0) / 256.0)
    smooth_h = torch.floor((wwv * l2 + (256.0 - wwv) * right + 128.0) / 256.0)
    b = l2 + a2 - alb
    pl_ = (b - l2).abs()
    pt = (b - a2).abs()
    ptl = (b - alb).abs()
    paeth = torch.where(
        (pl_ <= pt) & (pl_ <= ptl), l2,
        torch.where(pt <= ptl, a2, alb.expand(R, n2)))
    return torch.stack(
        [dc[:, None].expand(R, n2), smooth, smooth_v, smooth_h, paeth], 1)


def nd_cost_ref(above, left, sc, blocks, kt, whv, wwv, inv, scale, bias,
                lam):
    """Plain version of `nd_cost`. above (R, bw), left (R, bh), sc (R, 2) =
    [al, dc], blocks (R, n2), kt (n2, n2) f32 or bf16, whv/wwv/inv/scale/
    bias (n2,) f32, lam a float. Returns (R, 5) f32."""
    preds = nd_preds(above, left, sc[:, 0], sc[:, 1], whv, wwv)
    res = blocks[:, None, :] - preds
    a = _mm(res, kt).abs()
    return lane_cost(a, inv, scale, bias, lam).sum(-1)


def nd_cost(above, left, sc, blocks, kt, whv, wwv, inv, scale, bias, lam):
    """Nondirectional-family costs (R, 5): the plain version on the CPU,
    the CUDA kernel on a CUDA device."""
    if above.device.type == "cpu":
        return nd_cost_ref(above, left, sc, blocks, kt, whv, wwv, inv,
                           scale, bias, lam)
    R, bw = above.shape
    bh = left.shape[1]
    n2 = bw * bh
    for v in (bw, bh):
        if v < 4 or v > 32 or v & (v - 1):
            raise ValueError(f"nd_cost: block side {v} not in 4..32")
    dev, f32 = above.device, torch.float32
    _check("above", above, (R, bw), f32, dev)
    _check("left", left, (R, bh), f32, dev)
    _check("sc", sc, (R, 2), f32, dev)
    _check("blocks", blocks, (R, n2), f32, dev)
    _check("kt", kt, (n2, n2), torch.bfloat16, dev)
    for nm, t in (("whv", whv), ("wwv", wwv), ("inv", inv),
                  ("scale", scale), ("bias", bias)):
        _check(nm, t, (n2,), f32, dev)
    out = torch.empty((R, 5), dtype=f32, device=dev)
    if R == 0:
        return out
    fn = cuda_build.function(
        "nd_cost", "pass1_nd_cost",
        [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _F, _P, _I, _I, _I, _P])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(above.data_ptr(), left.data_ptr(), sc.data_ptr(),
                 blocks.data_ptr(), kt.data_ptr(), whv.data_ptr(),
                 wwv.data_ptr(), inv.data_ptr(), scale.data_ptr(),
                 bias.data_ptr(), float(lam), out.data_ptr(), R, bw, bh,
                 stream)
    if err != 0:
        raise RuntimeError(f"pass1_nd_cost launch failed: CUDA error {err}")
    _count("nd_cost")
    return out
