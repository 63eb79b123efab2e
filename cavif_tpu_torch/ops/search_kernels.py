"""The hand-written Hopper kernel of the whole-plane block search (K3), with
its plain PyTorch version.

`mode_cost` (csrc/mode_search_cost.cu) replaces the TPU kernel
`_pallas_kernel` of cavif_tpu/ops/pallas_search.py: for every aligned n x n
block of a plane batch it prices the 13 intra candidates (CAND_MODES order:
DC, V, H, SMOOTH, SMOOTH_V, SMOOTH_H, PAETH, then D45, D135, D113, D157,
D203, D67 at delta 0):

  pred     exact integer predictor (the diagonals are two-tap gathers from
           ext = [al, above_ext(2n), left_ext(2n)], the `taps` table)
  coef     = D (blk - pred) D^T               (D = dct2_matrix(n))
  level    = sign(t) floor(|t| + bias), t = coef * inv
  cost     = sum (coef - level * scale)^2 + lam (sum |level| + 2 #nonzero)
             + 7 lam for the six diagonals

with the DC coefficient [0, 0] at dc_q * gain and bias 0.5 and every other
coefficient at ac_q * gain and AC_BIAS (gain = get_gain(n, n)). Costs come
back as (NB, 13) f32; argmin and min run in torch.

The plain version `mode_cost_ref` computes the DCT in f32 (or float64, as
an oracle). The kernel runs it on the f16 tensor cores in split precision:
the residuals are exact in f16, D (or D (x) D) is split as hi + 2^-12 lo,
both f16 (`pack_split`, once per n in `search_consts`), in the form
`FORMS` names per n (Kronecker or separable). The two agree within a tie-aware rule, not bit for bit:
`near_ties` counts an argmin difference only where a float64 oracle prices
the two picks more than rtol 1e-5 apart (exact ties between candidates,
common on flat 4x4 blocks, are broken by rounding noise in either).

A wrapper takes the plain version for tensors on the CPU and launches its
kernel for tensors on a CUDA device (or raises). The kernel is compiled
with nvcc on the first CUDA call (ops/cuda_build.py). Importing this module
needs neither nvcc nor a GPU.
"""

from __future__ import annotations

import ctypes
import threading
from functools import lru_cache

import numpy as np
import torch

from ..av1.transforms import dct2_matrix, get_gain
from ..native.contract import CAND_MODES
from . import cuda_build
from .cuda_build import check as _check

NONDIRECTIONAL = CAND_MODES[:7]
DIAG_MODES = CAND_MODES[7:]
NCAND = len(CAND_MODES)
SIZES = (4, 8, 16, 32)
# the kernel's DCT form per block size: "kron" vec(C) = vec(R) (D (x) D)^T,
# "sep" C = (D R) D^T
FORMS = {4: "kron", 8: "kron", 16: "sep", 32: "sep"}
PAD = 8  # f16 elements of padding per row of the separable D tiles
LO_SCALE = 2.0 ** -12  # the lo halves' weight
# per-block inputs of mode_cost (the others are per-call constants)
PER_BLOCK = ("blocks", "above", "left", "scal", "ext")

# launches of the kernel in this process (the plain version counts nothing)
LAUNCHES = {"mode_cost": 0}

_lock = threading.Lock()


def reset_launches() -> None:
    with _lock:
        LAUNCHES["mode_cost"] = 0


@lru_cache(maxsize=None)
def dir_taps(n: int) -> np.ndarray:
    """(6, n*n) int32 two-tap table of the six diagonal predictors at delta
    0, row-major pixels: entry = e0 | w0 << 8 | e1 << 16 | w1 << 24 with
    pred = (ext[e0] * w0 + ext[e1] * w1 + 16) >> 5 over
    ext = [al, above_ext(2n), left_ext(2n)]. Where the spec's mask is 0
    the pixel replicates the extended edge (ext index 2n or 4n, weight
    32); zone 2 reads [al] + above_ext or [al] + left_ext. Built from
    av1/predict._dir_grids, as ops/pallas_search._dir_matrix is."""
    from ..av1.predict import _dir_grids

    L = 2 * n
    e0 = np.zeros((6, n, n), np.int64)
    w0 = np.zeros_like(e0)
    e1 = np.zeros_like(e0)
    w1 = np.zeros_like(e0)
    for mi, mode in enumerate(DIAG_MODES):
        kind, a1, a2, a3, a4, mask = _dir_grids(mode, n, n)
        if kind in ("above", "left"):
            off = 1 if kind == "above" else 1 + L
            e0[mi] = np.where(mask, off + a1, off + L - 1)
            w0[mi] = np.where(mask, a2, 32)
            e1[mi] = np.where(mask, off + a3, 0)
            w1[mi] = np.where(mask, a4, 0)
        else:  # zone2: [al] + above_ext is ext[k]; [al] + left_ext[k-1]
            (b1, wa0, wa1), (b2, wl0, wl1) = a1, a2

            def lc(k):
                return np.where(k == 0, 0, L + k)

            e0[mi] = np.where(mask, b1, lc(b2))
            w0[mi] = np.where(mask, wa0, wl0)
            e1[mi] = np.where(mask, b1 + 1, lc(b2 + 1))
            w1[mi] = np.where(mask, wa1, wl1)
    for t in (e0, e1):
        assert t.min() >= 0 and t.max() <= 2 * L, (n, t.min(), t.max())
    assert w0.min() >= 0 and w0.max() <= 32 and w1.max() <= 32
    packed = e0 | (w0 << 8) | (e1 << 16) | (w1 << 24)
    return np.ascontiguousarray(packed.reshape(6, n * n).astype(np.int32))


@lru_cache(maxsize=None)
def search_consts(n: int) -> dict:
    """The constant tables of one block size, as numpy arrays: taps
    (6, n*n) int32, smw (n,) int32 SMOOTH weights, dct (n, n) f32, tiles
    (the kernel's split f16 D, pack_split(dct)), gain."""
    from ..av1 import tables

    dct = np.ascontiguousarray(dct2_matrix(n, np.float32))
    return dict(
        taps=dir_taps(n),
        smw=np.asarray(tables.get(f"sm_weights_{n}"), np.int32),
        dct=dct,
        tiles=pack_split(torch.from_numpy(dct)).numpy(),
        gain=float(np.float32(get_gain(n, n))),
    )


def _unpack_taps(taps):
    t = taps.to(torch.int64)
    return t & 255, (t >> 8) & 255, (t >> 16) & 255, (t >> 24) & 255


def dir_preds(ext, taps):
    """The six diagonal predictors (NB, 6, n*n) int32 from ext (NB, 4n+1)
    int32 and the packed tap table (6, n*n)."""
    e0, w0, e1, w1 = _unpack_taps(taps)
    x = ext.to(torch.int32)
    a = x[:, e0] * w0.to(torch.int32) + x[:, e1] * w1.to(torch.int32)
    return (a + 16) >> 5


def nondir_preds(above, left, scal, smw):
    """The seven nondirectional predictors (NB, 7, n, n) int32 in
    NONDIRECTIONAL order: DC, V, H, SMOOTH, SMOOTH_V, SMOOTH_H, PAETH, with
    the reference's integer rounding. above/left (NB, n) are the resolved
    neighbours, scal (NB, 2) = [al, dc]."""
    NB, n = above.shape
    a2 = above[:, None, :]
    l2 = left[:, :, None]
    al = scal[:, 0][:, None, None]
    wh = smw[None, :, None]
    ww = smw[None, None, :]
    below = left[:, n - 1][:, None, None]
    right = above[:, n - 1][:, None, None]
    t = wh * a2 + (256 - wh) * below + ww * l2 + (256 - ww) * right
    b = l2 + a2 - al
    pl_ = (b - l2).abs()
    pt = (b - a2).abs()
    ptl = (b - al).abs()
    paeth = torch.where((pl_ <= pt) & (pl_ <= ptl), l2,
                        torch.where(pt <= ptl, a2, al))
    shape = (NB, n, n)
    return torch.stack([
        scal[:, 1][:, None, None].expand(shape),
        a2.expand(shape),
        l2.expand(shape),
        (t + 256) >> 9,
        (wh * a2 + (256 - wh) * below + 128) >> 8,
        (ww * l2 + (256 - ww) * right + 128) >> 8,
        paeth.expand(shape),
    ], 1).to(torch.int32)


def dct2(res, dct):
    """coef = D res D^T over the last two axes in res's dtype: each output
    a sequential sum from index 0, one rounded multiply and one rounded add
    per term (no fused multiply-add)."""
    n = dct.shape[0]
    t = torch.zeros_like(res)
    for i in range(n):  # T[u, j] = sum_i D[u, i] R[i, j]
        t = t + dct[:, i, None] * res[..., i, None, :]
    c = torch.zeros_like(res)
    for j in range(n):  # C[u, v] = sum_j T[u, j] D[v, j]
        c = c + t[..., :, j, None] * dct[None, :, j]
    return c


def block_sum(e2):
    """Sum of (NB, C, n, n) [u, v] values per (block, candidate) in a fixed
    order: column v of row group ug adds rows 4 ug .. 4 ug + 3 in order,
    then a butterfly over groups of min(n^2 / 4, 32) (ug, v) partials,
    then those groups in order."""
    NB, C, n, _ = e2.shape
    x = e2.view(NB, C, n // 4, 4, n)
    s = ((x[:, :, :, 0] + x[:, :, :, 1]) + x[:, :, :, 2]) + x[:, :, :, 3]
    tpb = n * n // 4  # threads per block, index ug * n + v
    width = min(tpb, 32)
    s = s.reshape(NB, C, tpb // width, width)
    off = width // 2
    while off >= 1:
        s = s[..., :off] + s[..., off : 2 * off]
        off //= 2
    s = s[..., 0]
    out = s[..., 0]
    for w in range(1, s.shape[-1]):
        out = out + s[..., w]
    return out


def mode_cost_ref(blocks, above, left, scal, ext, taps, smw, dct, ac, dc,
                  lam, tiles=None):
    """Plain version of `mode_cost`, the DCT in dct's dtype (the kernel's
    split-f16 products agree with it in f32 under `near_ties`' rule, not
    bit for bit). blocks (NB, n, n), above/left (NB, n), scal
    (NB, 2) = [al_s, dc], ext (NB, 4n+1), all int32; taps (6, n*n) int32,
    smw (n,) int32, dct (n, n) (f32, or f64 for an oracle); ac/dc =
    (inv, scale, bias); lam an f32 value; tiles, the kernel's split form
    of dct, is not read. Returns (NB, 13) costs in dct's dtype."""
    NB, n, _ = blocks.shape
    preds = torch.cat([
        nondir_preds(above, left, scal, smw),
        dir_preds(ext, taps).view(NB, 6, n, n),
    ], 1)
    res = (blocks[:, None] - preds).to(dct.dtype)
    coef = dct2(res, dct)
    inv = torch.full((n, n), ac[0], dtype=dct.dtype, device=dct.device)
    scale = torch.full_like(inv, ac[1])
    bias = torch.full_like(inv, ac[2])
    inv[0, 0], scale[0, 0], bias[0, 0] = dc
    t = coef * inv
    lv = torch.sign(t) * torch.floor(t.abs() + bias)
    errc = coef - lv * scale
    rate = (lv.abs().sum((-2, -1)) + 2.0 * (lv != 0).sum((-2, -1))).to(
        dct.dtype)
    cost = block_sum(errc * errc) + lam * rate
    # diagonal rate proxy: + 7 lam, rounded as one f32 product
    cost[:, len(NONDIRECTIONAL):] += float(np.float32(lam) * np.float32(7))
    return cost


def split_f16(x):
    """(hi, lo) f16 with x = hi + 2^-12 lo to about 22 bits: hi = f16(x),
    lo = f16((x - hi) 2^12), computed from x in float64."""
    x = x.to(torch.float64)
    hi = x.to(torch.float16)
    lo = ((x - hi.to(torch.float64)) * 4096.0).to(torch.float16)
    return hi, lo


def tiles_shape(n: int) -> tuple:
    """Shape of pack_split's f16 tiles at block size n: (n^2/16, n^2/8,
    32, 8) in the "kron" form, (2, n, n + PAD) in the "sep" form."""
    if FORMS[n] == "kron":
        return (n * n // 16, n * n // 8, 32, 8)
    return (2, n, n + PAD)


def pack_split(dct):
    """The kernel's split constant for D = dct (n, n), in the form
    FORMS[n], f16 on dct's device.

    "sep": D_hi, D_lo as (2, n, n + PAD), rows padded by PAD zeros (read by
    ldmatrix as pass 1's A operand and pass 2's B operand).
    "kron": K = D (x) D (rows: coefficient u n + v, columns: pixel i n + j)
    split, in mma.m16n8k16 B-fragment order (n^2/16, n^2/8, 32, 8):
    [ks, nt, lane] = K_hi[c, k], K_hi[c, k + 1], K_hi[c, k + 8],
    K_hi[c, k + 9], then the same of K_lo, with c = 8 nt + lane // 4 and
    k = 16 ks + 2 (lane % 4)."""
    n = dct.shape[0]
    if n not in FORMS:
        raise ValueError(f"pack_split: block size {n} not in {SIZES}")
    d = dct.to(torch.float64)
    if FORMS[n] == "sep":
        return torch.nn.functional.pad(torch.stack(split_f16(d)),
                                       (0, PAD)).contiguous()
    n2 = n * n

    def frag(m):  # (coefficient c, pixel k) -> [ks, nt, g, t, h, pair]
        x = m.reshape(n2 // 8, 8, n2 // 16, 2, 4, 2)  # nt g ks h t pair
        return x.permute(2, 0, 1, 4, 3, 5).reshape(n2 // 16, n2 // 8, 32, 4)

    hi, lo = split_f16(torch.kron(d, d))
    return torch.cat([frag(hi), frag(lo)], -1).contiguous()


def near_ties(pick, ref_pick, kw, rtol: float = 1e-5):
    """Argmin differences between two picks over the same blocks, judged
    by a float64 oracle (mode_cost_ref with dct in float64, run on the
    differing rows only). pick, ref_pick: (NB,) candidate indices; kw:
    mode_cost's inputs. Returns (differing, exact ties, beyond rtol):
    counts of rows where the picks differ, where the oracle prices both
    picks equally, and where it prices them more than rtol apart (relative
    to ref_pick's oracle cost). Only the last is a disagreement."""
    rows = (pick != ref_pick).nonzero()[:, 0]
    if rows.numel() == 0:
        return 0, 0, 0
    sub = {k: (v[rows] if k in PER_BLOCK else v) for k, v in kw.items()}
    sub["dct"] = kw["dct"].to(torch.float64)
    oracle = mode_cost_ref(**sub)
    a = oracle.gather(1, pick[rows, None].long())[:, 0]
    b = oracle.gather(1, ref_pick[rows, None].long())[:, 0]
    d = (a - b).abs()
    return (int(rows.numel()), int((d == 0).sum()),
            int((d > rtol * b.abs()).sum()))


def kernel_info(NB: int, n: int) -> dict:
    """Launch geometry of the kernel over NB blocks of size n: grid blocks,
    registers per thread, dynamic shared memory per block, blocks resident
    per SM. Builds and loads the kernel; needs a CUDA device."""
    info = (ctypes.c_int * 4)()
    fn = cuda_build.function("mode_cost", "mode_search_cost_info",
                             [ctypes.c_int] * 2 + [ctypes.c_void_p])
    err = fn(NB, n, info)
    if err != 0:
        raise RuntimeError(f"mode_search_cost_info failed: CUDA error {err}")
    return dict(zip(("blocks", "registers", "smem_bytes", "per_sm"), info))


def mode_cost(blocks, above, left, scal, ext, taps, smw, dct, ac, dc, lam,
              tiles):
    """13-candidate RD costs (NB, 13) f32: the plain version on the CPU,
    the CUDA kernel on a CUDA device. `lam` must be an f32 value.

    The kernel reads D as `tiles` = pack_split(dct) (search_inputs passes
    search_consts' copy, packed once per n); the plain version reads dct.
    The kernel relies on pixels and neighbours in [0, 1023], which bit
    depths 8 and 10 guarantee (search_inputs refuses deeper planes); the
    values themselves are not checked on the device."""
    if blocks.device.type == "cpu":
        return mode_cost_ref(blocks, above, left, scal, ext, taps, smw, dct,
                             ac, dc, lam)
    NB, n = blocks.shape[0], blocks.shape[1]
    if n not in SIZES:
        raise ValueError(f"mode_cost: block size {n} not in {SIZES}")
    dev, i32 = blocks.device, torch.int32
    _check("blocks", blocks, (NB, n, n), i32, dev)
    _check("above", above, (NB, n), i32, dev)
    _check("left", left, (NB, n), i32, dev)
    _check("scal", scal, (NB, 2), i32, dev)
    _check("ext", ext, (NB, 4 * n + 1), i32, dev)
    _check("taps", taps, (6, n * n), i32, dev)
    _check("smw", smw, (n,), i32, dev)
    _check("dct", dct, (n, n), torch.float32, dev)
    _check("tiles", tiles, tiles_shape(n), torch.float16, dev)
    out = torch.empty((NB, NCAND), dtype=torch.float32, device=dev)
    if NB == 0:
        return out
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = cuda_build.function(
        "mode_cost", "mode_search_cost",
        [p, p, p, p, p, p, p, p, f, f, f, f, f, f, f, p, i, i, p])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(blocks.data_ptr(), above.data_ptr(), left.data_ptr(),
                 scal.data_ptr(), ext.data_ptr(), taps.data_ptr(),
                 smw.data_ptr(), tiles.data_ptr(), *map(float, ac),
                 *map(float, dc), float(lam), out.data_ptr(), NB, n, stream)
    if err != 0:
        raise RuntimeError(f"mode_search_cost launch failed: CUDA error {err}")
    with _lock:
        LAUNCHES["mode_cost"] += 1
    return out
