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
cavif_tpu_torch/_build/ on the first CUDA call, and loaded with ctypes.
Importing this module needs neither nvcc nor a GPU.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
_SOURCES = {"dir_cost": "pass1_dir_cost.cu", "nd_cost": "pass1_nd_cost.cu"}
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# launches of each kernel in this process (the plain versions count nothing)
LAUNCHES = {"dir_cost": 0, "nd_cost": 0}

_lock = threading.Lock()
_libs: dict = {}


def reset_launches() -> None:
    with _lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _count(name: str) -> None:
    with _lock:
        LAUNCHES[name] += 1


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    found = shutil.which("nvcc") or str(Path(cuda_home) / "bin" / "nvcc")
    if not Path(found).exists():
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    return found


def build(names=tuple(_SOURCES)) -> dict:
    """Compile the named kernels' sources (one nvcc process each, all
    started together) into _build/lib<name>.so unless an up-to-date library
    is there. Returns {name: (seconds, nvcc output)}; the output carries
    ptxas's register / shared-memory / spill report."""
    import time

    _BUILD.mkdir(exist_ok=True)
    procs, done = {}, {}
    t0 = time.perf_counter()
    for name in names:
        src = _CSRC / _SOURCES[name]
        so = _BUILD / f"lib{name}.so"
        if so.exists() and so.stat().st_mtime >= src.stat().st_mtime:
            done[name] = (0.0, "")
            continue
        tmp = so.with_suffix(f".so.{os.getpid()}")
        procs[name] = (subprocess.Popen(
            [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        ), tmp, so)
    for name, (p, tmp, so) in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {_SOURCES[name]}:\n{out.decode()}")
        os.replace(tmp, so)
        done[name] = (time.perf_counter() - t0, out.decode())
    return done


def _lib(name: str):
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        build((name,))
        lib = ctypes.CDLL(str(_BUILD / f"lib{name}.so"))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        if name == "dir_cost":
            fn = lib.pass1_dir_cost
            fn.argtypes = [p, p, p, p, p, p, p, f, p, i, i, i, i, p]
        else:
            fn = lib.pass1_nd_cost
            fn.argtypes = [p, p, p, p, p, p, p, p, p, p, f, p, i, i, i, p]
        fn.restype = ctypes.c_int
        _libs[name] = lib
        return lib


def _check(name, t, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


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
    fn = _lib("dir_cost").pass1_dir_cost
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
    fn = _lib("nd_cost").pass1_nd_cost
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
