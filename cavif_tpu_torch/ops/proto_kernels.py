"""The tensor-core directional-cost kernels of the pass-1 prototype
harnesses (K4, K5), with their plain PyTorch versions.

- `fused_dir_cost` (csrc/dir_cost_tc.cu, entry dir_cost_tc) replaces the
  TPU kernel `pallas_fused` of tools/pallas_proto.py: K1's function
  (ops/pass1_kernels.dir_cost) as one fused tile, the bf16 product on the
  tensor cores (mma.sync), the quantizer epilogue on its fragments, and the
  per-candidate lane sum in one of two reduce modes, "matmul" (u staged in
  shared memory and summed per segment, the counterpart of the TPU's 0/1
  segment matmul at HIGHEST precision) or "loop" (from registers). The two
  differ only in summation order.
- `dir_ablation` (entry dir_ablation_tc) replaces `make` of
  tools/pallas_proto2.py: the same kernel with the lane value u changed by
  `variant`:
    full      u = (coef - lv scale)^2 + lam (|lv| + 2 [lv != 0])   (K4)
    mm_only   u = cp = ext @ MK (no /32, no cc, no bkt)
    no_quant  u = coef^2
    no_sign   as full with lv = floor(|t| + bias), t = coef inv, no sign
    red_bf16  as full
  where coef = bkt - (cp / 32 + cc); mm_only and red_bf16 round u to
  bfloat16 before the sum, as the TPU's default-precision reduce did.

Both return (R, C) f32 for ext (R, E) f32, bkt (R, n2) f32, mk (E, C*n2)
and cc/inv/scale/bias (n2,) f32. The kernels take a bfloat16 `mk` and
round ext to bfloat16 (round to nearest even); the plain versions follow
the dtype of `mk` (ops/pass1_kernels._mm). `tile` is (rows, columns of MK)
per thread block, one of TILES.

A wrapper takes the plain version for tensors on the CPU and launches its
kernel for tensors on a CUDA device (or raises). The source is compiled
with nvcc on the first CUDA call (ops/cuda_build.py). Importing this module
needs neither nvcc nor a GPU.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import cuda_build
from .cuda_build import check as _check
from .pass1_kernels import _mm, dir_cost_ref, lane_cost

REDUCE_MODES = ("matmul", "loop")
VARIANTS = ("full", "mm_only", "no_quant", "no_sign", "red_bf16")
BF16_REDUCE = ("mm_only", "red_bf16")  # lane values rounded before the sum
TILES = ((64, 64), (128, 64), (64, 128))
DEFAULT_TILE = TILES[0]
MAX_E = 256

# launches of each kernel in this process (the plain versions count nothing)
LAUNCHES = {"fused_dir_cost": 0, "dir_ablation": 0}

_lock = threading.Lock()
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGS = [_P, _P, _P, _P, _P, _P, _P, _F, _P, _I, _I, _I, _I]


def reset_launches() -> None:
    with _lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _count(name: str) -> None:
    with _lock:
        LAUNCHES[name] += 1


def _tile(tile) -> tuple:
    t = tuple(tile) if isinstance(tile, (tuple, list)) else tile
    if t not in TILES:
        raise ValueError(f"tile {tile!r} is not one of {TILES}")
    return t


# plain version of `fused_dir_cost`, whatever the reduce mode: K1's function
fused_dir_cost_ref = dir_cost_ref


def ablation_lanes(ext, bkt, mk, cc, inv, scale, bias, lam, variant):
    """The per-lane values u of `variant` before its rounding and sum,
    (R, C, n2) f32."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} is not one of {VARIANTS}")
    R, n2 = bkt.shape
    cp = _mm(ext, mk).view(R, -1, n2)
    if variant == "mm_only":
        return cp
    coef = bkt[:, None, :] - (cp * (1.0 / 32.0) + cc)
    if variant == "no_quant":
        return coef * coef
    if variant == "no_sign":
        l = torch.floor((coef * inv).abs() + bias)
        e = coef - l * scale
        return e * e + lam * (l + 2.0 * (l != 0.0))
    return lane_cost(coef.abs(), inv, scale, bias, lam)


def dir_ablation_ref(ext, bkt, mk, cc, inv, scale, bias, lam, variant):
    """Plain version of `dir_ablation`. mm_only and red_bf16 round each lane
    value to bfloat16 and add them in f32 in lane order, a sum whose every
    rounding is fixed (the TPU left the order to its matrix unit)."""
    u = ablation_lanes(ext, bkt, mk, cc, inv, scale, bias, lam, variant)
    if variant not in BF16_REDUCE:
        return u.sum(-1)
    v = u.to(torch.bfloat16).float()
    s = v[..., 0].clone()
    for k in range(1, v.shape[-1]):
        s += v[..., k]
    return s


def _launch(name, symbol, extra, ext, bkt, mk, cc, inv, scale, bias, lam):
    R, E = ext.shape
    n2 = bkt.shape[1]
    if mk.shape[1] % n2:
        raise ValueError(f"{name}: mk width is not a multiple of n2")
    C = mk.shape[1] // n2
    if n2 < 16 or n2 & (n2 - 1):
        raise ValueError(f"{name}: n2 {n2} is not a power of two >= 16")
    if E > MAX_E:
        raise ValueError(f"{name}: E {E} > {MAX_E}")
    dev, f32 = ext.device, torch.float32
    _check("ext", ext, (R, E), f32, dev)
    _check("bkt", bkt, (R, n2), f32, dev)
    _check("mk", mk, (E, C * n2), torch.bfloat16, dev)
    for nm, t in (("cc", cc), ("inv", inv), ("scale", scale),
                  ("bias", bias)):
        _check(nm, t, (n2,), f32, dev)
    out = torch.empty((R, C), dtype=f32, device=dev)
    if R == 0:
        return out
    fn = cuda_build.function("dir_cost_tc", symbol, _ARGS + [_I] * 3 + [_P])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(ext.data_ptr(), bkt.data_ptr(), mk.data_ptr(),
                 cc.data_ptr(), inv.data_ptr(), scale.data_ptr(),
                 bias.data_ptr(), float(lam), out.data_ptr(), R, E, n2, C,
                 *extra, stream)
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {err}")
    _count(name)
    return out


def fused_dir_cost(ext, bkt, mk, cc, inv, scale, bias, lam, *,
                   reduce="matmul", tile=DEFAULT_TILE):
    """K4: directional costs (R, C), the plain version on the CPU, the
    tensor-core kernel on a CUDA device."""
    if reduce not in REDUCE_MODES:
        raise ValueError(f"reduce {reduce!r} is not one of {REDUCE_MODES}")
    tm, tn = _tile(tile)
    if ext.device.type == "cpu":
        return fused_dir_cost_ref(ext, bkt, mk, cc, inv, scale, bias, lam)
    return _launch("fused_dir_cost", "dir_cost_tc",
                   (tm, tn, REDUCE_MODES.index(reduce)),
                   ext, bkt, mk, cc, inv, scale, bias, lam)


def dir_ablation(ext, bkt, mk, cc, inv, scale, bias, lam, *, variant,
                 tile=DEFAULT_TILE):
    """K5: the costs (R, C) of one ablation `variant`, the plain version on
    the CPU, the tensor-core kernel on a CUDA device."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} is not one of {VARIANTS}")
    tm, tn = _tile(tile)
    if ext.device.type == "cpu":
        return dir_ablation_ref(ext, bkt, mk, cc, inv, scale, bias, lam,
                                variant)
    return _launch("dir_ablation", "dir_ablation_tc",
                   (VARIANTS.index(variant), tm, tn),
                   ext, bkt, mk, cc, inv, scale, bias, lam)
