"""The tensor-core directional-cost kernels of the pass-1 prototype
harnesses (K4, K5), with their plain PyTorch versions.

- `fused_dir_cost` (csrc/dir_cost_tc.cu) replaces the TPU kernel
  `pallas_fused` of tools/pallas_proto.py: K1's function
  (ops/pass1_kernels.dir_cost) as one fused kernel, the bf16 product on
  the tensor cores (mma.sync), the quantizer epilogue on its fragments,
  and the per-candidate lane sum in one of two reduce modes, "matmul" (u
  staged in shared memory and summed per segment, the counterpart of the
  TPU's 0/1 segment matmul at HIGHEST precision) or "loop" (from
  registers, K1's own reduce). The two differ only in summation order.
- `dir_ablation` (same source) replaces `make` of tools/pallas_proto2.py:
  the same kernel, reduce "matmul", with the lane value u changed by
  `variant`:
    full      u = (coef - lv scale)^2 + lam (|lv| + 2 [lv != 0])   (K4)
    mm_only   u = cp = ext @ MK (no /32, no cc, no bkt)
    no_quant  u = coef^2
    no_sign   as full with lv = floor(|t| + bias), t = coef inv, no sign
    red_bf16  as full
  where coef = bkt - (cp / 32 + cc); mm_only and red_bf16 round u to
  bfloat16 before the sum, as the TPU's default-precision reduce did.

Both return (R, C) f32 for ext (R, E) f32, bkt (R, n2) f32, mk (E, C*n2)
and cc/inv/scale/bias (n2,) f32. The kernel takes a bfloat16 `mk` and
rounds ext to bfloat16 (round to nearest even); the plain versions follow
the dtype of `mk` (ops/pass1_kernels._mm).

The kernel is K1's design (csrc/dir_tc.cuh, one template for K1, K4 and
K5). `tile` is (rows per thread block, lanes per chunk), one of TILES: a
block of 2 * rows threads (16 rows per warp) owns its rows and one chunk of
min(n2, lanes) lanes and loops over every candidate. K1's tile (128, 32) is
the default, and there K4 "loop" gives K1's costs bit for bit. The kernel
reads MK as ring-stage tiles, `pack_tiles(mk, n2, tile)`
(pass1_kernels.pack_mk with the tile's lanes), passed as `mk_tiles` or
packed inside the call when not given; the harnesses pack once outside
their timed calls. It is built for E in 17-48, 65-80 and 129-144 (k-steps
ceil(E / 16) in KSTEPS: E = 4b + 1 at every tier b): any other E raises
ValueError on either device, as do inputs of the wrong shape or dtype and
tiles that do not match `tile`.

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
from . import pass1_kernels
from .pass1_kernels import (PAD, _check_inputs, _mm, dir_cost_ref, dir_tile,
                            lane_cost)

REDUCE_MODES = ("matmul", "loop")
VARIANTS = ("full", "mm_only", "no_quant", "no_sign", "red_bf16")
BF16_REDUCE = ("mm_only", "red_bf16")  # lane values rounded before the sum
TILES = ((128, 32), (64, 32), (128, 16))
DEFAULT_TILE = TILES[0]
KSTEPS = (2, 3, 5, 9)  # ceil(E / 16) the kernel is instantiated for

# launches of each kernel in this process (the plain versions count nothing)
LAUNCHES = {"fused_dir_cost": 0, "dir_ablation": 0}

_lock = threading.Lock()
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


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


def pack_tiles(mk, n2: int, tile=DEFAULT_TILE):
    """MK (E, C * n2) as the kernel's ring-stage tiles at `tile`:
    (n2 / LT, C, LT, Ep + PAD) bf16, LT = min(n2, tile[1])."""
    return pass1_kernels.pack_mk(mk, n2, lt=_tile(tile)[1])


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


def _geometry(name, ext, bkt, mk, tile) -> tuple:
    """(R, E, n2, C, tm, LT, Ep) of a call, or ValueError for what the
    kernel does not take."""
    tm, lt = _tile(tile)
    R, E = ext.shape
    n2 = bkt.shape[1]
    if n2 < 16 or n2 & (n2 - 1):
        raise ValueError(f"{name}: n2 {n2} is not a power of two >= 16")
    if mk.shape[1] % n2:
        raise ValueError(f"{name}: mk width is not a multiple of n2")
    if -(-E // 16) not in KSTEPS:
        raise ValueError(f"{name}: E {E} is not in 17-48, 65-80 or 129-144 "
                         f"(k-steps {KSTEPS})")
    LT, Ep = dir_tile(n2, E, lt)
    return R, E, n2, mk.shape[1] // n2, tm, LT, Ep


def _run(name, kw, tile, mk_tiles, variant, reduce, plain):
    """Check the inputs, then the plain version on the CPU or one counted
    launch of dir_cost_tc on a CUDA device."""
    ext, bkt, mk = kw["ext"], kw["bkt"], kw["mk"]
    R, E, n2, C, tm, LT, Ep = _geometry(name, ext, bkt, mk, tile)
    dev, f32, bf16 = ext.device, torch.float32, torch.bfloat16
    cpu = dev.type == "cpu"
    _check_inputs((
        ("ext", ext, (R, E), f32), ("bkt", bkt, (R, n2), f32),
        ("mk", mk, (E, C * n2), (f32, bf16) if cpu else bf16),
        *((nm, kw[nm], (n2,), f32) for nm in ("cc", "inv", "scale", "bias")),
        ("mk_tiles", mk_tiles, (n2 // LT, C, LT, Ep + PAD), bf16),
    ), dev)
    if cpu:
        return plain()
    out = torch.empty((R, C), dtype=f32, device=dev)
    if R == 0:
        return out
    if mk_tiles is None:
        mk_tiles = pack_tiles(mk, n2, tile)
    nch = n2 // LT
    part = (torch.empty((nch * C * R,), dtype=f32, device=dev)
            if nch > 1 else None)
    fn = cuda_build.function("dir_cost_tc", "dir_cost_tc",
                             [_P] * 7 + [_F, _P, _P] + [_I] * 8 + [_P])
    with torch.cuda.device(dev):
        err = fn(ext.data_ptr(), bkt.data_ptr(), mk_tiles.data_ptr(),
                 kw["cc"].data_ptr(), kw["inv"].data_ptr(),
                 kw["scale"].data_ptr(), kw["bias"].data_ptr(),
                 float(kw["lam"]), out.data_ptr(),
                 None if part is None else part.data_ptr(), R, E, n2, C, tm,
                 LT, VARIANTS.index(variant), REDUCE_MODES.index(reduce),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"dir_cost_tc launch failed: CUDA error {err}")
    _count(name)
    return out


def fused_dir_cost(ext, bkt, mk, cc, inv, scale, bias, lam, *,
                   reduce="matmul", tile=DEFAULT_TILE, mk_tiles=None):
    """K4: directional costs (R, C), the plain version on the CPU, the
    tensor-core kernel on a CUDA device. `mk_tiles` is
    `pack_tiles(mk, n2, tile)` (packed inside the call when not given; the
    plain version ignores it)."""
    if reduce not in REDUCE_MODES:
        raise ValueError(f"reduce {reduce!r} is not one of {REDUCE_MODES}")
    kw = dict(ext=ext, bkt=bkt, mk=mk, cc=cc, inv=inv, scale=scale,
              bias=bias, lam=lam)
    return _run("fused_dir_cost", kw, tile, mk_tiles, "full", reduce,
                lambda: fused_dir_cost_ref(**kw))


def dir_ablation(ext, bkt, mk, cc, inv, scale, bias, lam, *, variant,
                 tile=DEFAULT_TILE, mk_tiles=None):
    """K5: the costs (R, C) of one ablation `variant`, the plain version on
    the CPU, the tensor-core kernel on a CUDA device (`mk_tiles` as for
    `fused_dir_cost`)."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} is not one of {VARIANTS}")
    kw = dict(ext=ext, bkt=bkt, mk=mk, cc=cc, inv=inv, scale=scale,
              bias=bias, lam=lam)
    return _run("dir_ablation", kw, tile, mk_tiles, variant, "matmul",
                lambda: dir_ablation_ref(**kw, variant=variant))


def kernel_info(R: int, E: int, n2: int, C: int, tile=DEFAULT_TILE,
                variant: str = "full", reduce: str = "matmul") -> dict:
    """Launch geometry of one dir_cost_tc call: main-grid blocks, registers
    per thread, dynamic shared memory per block, blocks of the chunk-sum
    pass. Builds and loads the kernel; needs a CUDA device."""
    tm, lt = _tile(tile)
    info = (ctypes.c_int * 4)()
    fn = cuda_build.function("dir_cost_tc", "dir_cost_tc_info",
                             [_I] * 8 + [_P])
    err = fn(R, E, n2, C, tm, lt, VARIANTS.index(variant),
             REDUCE_MODES.index(reduce), info)
    if err != 0:
        raise RuntimeError(f"dir_cost_tc info failed: CUDA error {err}")
    return dict(zip(("blocks", "registers", "smem_bytes", "sum_blocks"),
                    info))
