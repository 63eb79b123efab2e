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
kernel for tensors on a CUDA device (or raises); on either it raises on
inputs of the wrong shape or dtype. The matmul inputs' rounding follows the
dtype of the constant matrix: a bfloat16 `mk` / `kt` rounds the other
operand to bfloat16 too (round to nearest even, as the TPU's default
precision did) and accumulates in f32; a float32 matrix keeps full f32
inputs. The kernels take bfloat16 matrices only, and read them as tiles in
the order of their shared-memory ring stages (`pack_kt`, `pack_mk`):
ShapeCost builds the tiles once with its constants and passes them as
`kt_tiles` / `mk_tiles`; a caller that passes none has them packed inside
the call.

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


# bf16 elements of zero padding per tile row (csrc/pass1_tc.cuh PAD)
PAD = 8


def nd_tile(n2: int) -> tuple:
    """(LT, KC) of K2 for n2 lanes: output lanes per block and contraction
    pixels per ring stage (csrc/pass1_nd_cost.cu config)."""
    return min(n2, 256), min(n2, 32)


def dir_tile(n2: int, E: int, lt: int = 32) -> tuple:
    """(LT, Ep) of K1 (or, with another `lt`, of K4/K5): lanes per block,
    min(n2, lt), and E rounded up to the 16-deep k-step (csrc/dir_tc.cuh
    dir_config)."""
    return min(n2, lt), -(-E // 16) * 16


def pack_kt(kt):
    """KT (n2, n2) as K2's ring stages: (n2 / LT, n2 / KC, LT, KC + PAD)
    bf16, tile [c, k, n, i] = KT[k * KC + i, c * LT + n], the PAD
    columns zero."""
    n2 = kt.shape[0]
    LT, KC = nd_tile(n2)
    t = kt.to(torch.bfloat16).reshape(n2 // KC, KC, n2 // LT, LT)
    t = t.permute(2, 0, 3, 1)
    return torch.nn.functional.pad(t, (0, PAD)).contiguous()


def pack_mk(mk, n2: int, lt: int = 32):
    """MK (E, cdir * n2) as K1's ring stages (K4/K5's at lt lanes per
    chunk): (n2 / LT, cdir, LT, Ep + PAD) bf16, tile [c, d, n, e] =
    MK[e, d * n2 + c * LT + n], the rows past E zero."""
    E, ncols = mk.shape
    LT, Ep = dir_tile(n2, E, lt)
    t = mk.to(torch.bfloat16).reshape(E, ncols // n2, n2 // LT, LT)
    t = t.permute(2, 1, 3, 0)
    return torch.nn.functional.pad(t, (0, Ep + PAD - E)).contiguous()


_MM_CPU = (torch.float32, torch.bfloat16)  # the plain versions take either


def _check_inputs(specs, device) -> None:
    """cuda_build.check on each (name, tensor, shape, dtype) of `specs`;
    a tensor given as None is skipped."""
    for nm, t, shape, dtype in specs:
        if t is not None:
            _check(nm, t, shape, dtype, device)


def _launch(kernel, symbol, argtypes, device, *args) -> None:
    """Call the C entry point `symbol` of `kernel` on the current stream of
    `device` (its last argument), raise on a launch error, count one
    launch."""
    fn = cuda_build.function(kernel, symbol, argtypes)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {err}")
    _count(kernel)


def kernel_info(name: str, R: int, bw: int, bh: int, cdir: int = 0) -> dict:
    """Launch geometry of kernel `name` ("dir_cost" or "nd_cost") on R rows
    of a bw x bh block shape: main-grid blocks, registers per thread,
    dynamic shared memory per block, blocks of the chunk-sum pass. Builds
    and loads the kernel; needs a CUDA device."""
    info = (ctypes.c_int * 4)()
    if name == "nd_cost":
        fn = cuda_build.function("nd_cost", "pass1_nd_cost_info",
                                 [_I, _I, _I, _P])
        err = fn(R, bw, bh, info)
    else:
        fn = cuda_build.function("dir_cost", "pass1_dir_cost_info",
                                 [_I, _I, _I, _I, _P])
        err = fn(R, 2 * (bw + bh) + 1, bw * bh, cdir, info)
    if err != 0:
        raise RuntimeError(f"{name} info failed: CUDA error {err}")
    return dict(zip(("blocks", "registers", "smem_bytes", "sum_blocks"),
                    info))


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


def dir_cost(ext, bkt, mk, cc, inv, scale, bias, lam, mk_tiles=None):
    """Directional-family costs (R, cdir): the plain version on the CPU,
    the CUDA kernel on a CUDA device. `mk_tiles` is `pack_mk(mk, n2)`
    (packed inside the call when not given; the plain version ignores
    it)."""
    R, E = ext.shape
    n2 = bkt.shape[1]
    if n2 < 16 or n2 & (n2 - 1):
        raise ValueError(f"dir_cost: n2 {n2} is not a power of two >= 16")
    if mk.shape[1] % n2:
        raise ValueError("dir_cost: mk width is not a multiple of n2")
    cdir = mk.shape[1] // n2
    LT, Ep = dir_tile(n2, E)
    dev, f32, bf16 = ext.device, torch.float32, torch.bfloat16
    cpu = dev.type == "cpu"
    _check_inputs((
        ("ext", ext, (R, E), f32), ("bkt", bkt, (R, n2), f32),
        ("mk", mk, (E, cdir * n2), _MM_CPU if cpu else bf16),
        ("cc", cc, (n2,), f32), ("inv", inv, (n2,), f32),
        ("scale", scale, (n2,), f32), ("bias", bias, (n2,), f32),
        ("mk_tiles", mk_tiles, (n2 // LT, cdir, LT, Ep + PAD), bf16),
    ), dev)
    if cpu:
        return dir_cost_ref(ext, bkt, mk, cc, inv, scale, bias, lam)
    out = torch.empty((R, cdir), dtype=f32, device=dev)
    if R == 0:
        return out
    if mk_tiles is None:
        mk_tiles = pack_mk(mk, n2)
    nch = n2 // LT
    part = (torch.empty((nch * cdir * R,), dtype=f32, device=dev)
            if nch > 1 else None)
    _launch("dir_cost", "pass1_dir_cost",
            [_P, _P, _P, _P, _P, _P, _P, _F, _P, _P, _I, _I, _I, _I, _P],
            dev, ext.data_ptr(), bkt.data_ptr(), mk_tiles.data_ptr(),
            cc.data_ptr(), inv.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            float(lam), out.data_ptr(),
            None if part is None else part.data_ptr(), R, E, n2, cdir)
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


def nd_cost(above, left, sc, blocks, kt, whv, wwv, inv, scale, bias, lam,
            kt_tiles=None):
    """Nondirectional-family costs (R, 5): the plain version on the CPU,
    the CUDA kernel on a CUDA device. `kt_tiles` is `pack_kt(kt)` (packed
    inside the call when not given; the plain version ignores it)."""
    R, bw = above.shape
    bh = left.shape[1]
    n2 = bw * bh
    for v in (bw, bh):
        if v < 4 or v > 32 or v & (v - 1):
            raise ValueError(f"nd_cost: block side {v} not in 4..32")
    LT, KC = nd_tile(n2)
    dev, f32, bf16 = above.device, torch.float32, torch.bfloat16
    cpu = dev.type == "cpu"
    _check_inputs((
        ("above", above, (R, bw), f32), ("left", left, (R, bh), f32),
        ("sc", sc, (R, 2), f32), ("blocks", blocks, (R, n2), f32),
        ("kt", kt, (n2, n2), _MM_CPU if cpu else bf16),
        ("whv", whv, (n2,), f32), ("wwv", wwv, (n2,), f32),
        ("inv", inv, (n2,), f32), ("scale", scale, (n2,), f32),
        ("bias", bias, (n2,), f32),
        ("kt_tiles", kt_tiles, (n2 // LT, n2 // KC, LT, KC + PAD), bf16),
    ), dev)
    if cpu:
        return nd_cost_ref(above, left, sc, blocks, kt, whv, wwv, inv,
                           scale, bias, lam)
    out = torch.empty((R, 5), dtype=f32, device=dev)
    if R == 0:
        return out
    if kt_tiles is None:
        kt_tiles = pack_kt(kt)
    nch = n2 // LT
    part = (torch.empty((nch * R * 5,), dtype=f32, device=dev)
            if nch > 1 else None)
    _launch("nd_cost", "pass1_nd_cost",
            [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _F, _P, _P, _I, _I, _I,
             _P],
            dev, above.data_ptr(), left.data_ptr(), sc.data_ptr(),
            blocks.data_ptr(), kt_tiles.data_ptr(), whv.data_ptr(),
            wwv.data_ptr(), inv.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            float(lam), out.data_ptr(),
            None if part is None else part.data_ptr(), R, bw, bh)
    return out
