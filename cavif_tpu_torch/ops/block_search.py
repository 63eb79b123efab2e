"""Whole-plane intra mode search in PyTorch: for every aligned n x n block of
a plane batch, the 13 intra candidates priced by transform-domain RD, and
the multi-tier NONE/SPLIT partition DP over them.

The plane batch lives on the device; block extraction is a reshape, the
neighbour rows and columns are strided slices, and the costs of all 13
candidates come from kernel K3 (ops/search_kernels.mode_cost,
csrc/mode_search_cost.cu) on a CUDA device, or from its plain PyTorch
version on the CPU. argmin over the candidates returns one int8 per block.

Counterpart of cavif_tpu/ops/block_search.py (and of the search half of
ops/pallas_search.py): the same neighbour resolution, candidate set, cost
model, DP and return formats, numpy in and numpy out, plus `device=`.
`backend` is "auto" (K3 on a CUDA device, the plain version on the CPU)
or "plain" (the plain version on any device, for comparisons). The TPU's
n <= 16 limit on its Pallas backend was a VMEM fact and is not carried
over: on the card every tier runs K3. With a mesh (parallel/mesh.py) each
rank searches its planes over its band of whole max_n rows, with max_n
rows of halo, and every rank returns the whole result: `_neighbors`
needs no band offset, since a band's first block row has the halo above
it (its local `by > 0` is then right) and the halo below holds the n rows
that `left_ext` reaches. Planes are 8 or 10 bits deep at most (K3 takes
pixels in [0, 1023]); the entry points refuse deeper ones on every
backend.
"""

from __future__ import annotations

import numpy as np
import torch

from ..av1.transforms import AC_BIAS
from ..native.contract import CAND_MODES  # noqa: F401  (the candidate order)
from ..parallel import mesh as shard
from .device_pass1 import _f32, _lane_quant, resolve_device
from .search_kernels import (  # noqa: F401
    DIAG_MODES, NONDIRECTIONAL, mode_cost, mode_cost_ref, search_consts,
)

BACKENDS = ("auto", "plain")
MAX_BIT_DEPTH = 10  # K3's residuals are exact in f16 for pixels <= 1023
OVH_BLOCK, OVH_SPLIT = 15.0, 2.0  # DP rate proxies, in lambda units


def _shift(x, dim: int):
    """x moved one step along `dim`, zeros coming in at index 0."""
    head = torch.zeros_like(x.narrow(dim, 0, 1))
    return torch.cat([head, x.narrow(dim, 0, x.shape[dim] - 1)], dim)


def _neighbors(planes, n: int, bit_depth: int) -> dict:
    """Per-block neighbour tensors with the availability fallbacks
    resolved, over planes (N, H, W) int32. Returns the reference's dict of
    (N, nby, nbx, ...) int32 / bool tensors: above, left (raw, zeros where
    unavailable), have_a, have_l, above_s, left_s, al_s, dc, above_ext and
    left_ext ((..., 2n), replicating the plane edge) and al (resolved
    above-left of the extended vectors)."""
    N, H, W = planes.shape
    nby, nbx = H // n, W // n
    base = 1 << (bit_depth - 1)
    dev = planes.device
    i32 = torch.int32
    rows = planes[:, n - 1 :: n, :].reshape(N, nby, nbx, n)
    above = _shift(rows, 1)
    cols = planes[:, :, n - 1 :: n]  # (N, H, nbx)
    colsb = cols.reshape(N, nby, n, nbx).permute(0, 1, 3, 2)
    left = _shift(colsb, 2)
    corn = _shift(rows[..., n - 1], 1)  # bottom-right px of the block above
    al = _shift(corn, 2)
    have_a = (torch.arange(nby, device=dev) > 0)[None, :, None].expand(
        N, nby, nbx)
    have_l = (torch.arange(nbx, device=dev) > 0)[None, None, :].expand(
        N, nby, nbx)

    ha = have_a[..., None]
    hl = have_l[..., None]
    above_s = torch.where(ha, above, torch.where(hl, left[..., 0:1], base - 1))
    left_s = torch.where(hl, left, torch.where(ha, above[..., 0:1], base + 1))
    al_s = torch.where(
        have_a & have_l, al,
        torch.where(have_a, above[..., 0],
                    torch.where(have_l, left[..., 0], base)))
    sum_a = above.sum(-1)
    sum_l = left.sum(-1)
    log2n = n.bit_length() - 1
    dc = torch.where(
        have_a & have_l, (sum_a + sum_l + n) // (2 * n),
        torch.where(have_a, (sum_a + (n >> 1)) >> log2n,
                    torch.where(have_l, (sum_l + (n >> 1)) >> log2n, base)))

    # extended neighbours for the diagonal modes (the host search's
    # approximation: no above-right / below-left, the edge replicated)
    r = planes[:, n - 1 :: n, :]
    rows2 = torch.cat([r, r[..., -1:].expand(N, nby, n)], -1)
    above_ext = _shift(rows2.unfold(2, 2 * n, n), 1)  # (N, nby, nbx, 2n)
    cols2 = torch.cat([cols, cols[:, -1:].expand(N, n, nbx)], 1)
    left_ext = _shift(cols2.unfold(1, 2 * n, n), 2)  # (N, nby, nbx, 2n)
    both_missing = ~have_a & ~have_l
    only_a = have_a & ~have_l
    only_l = ~have_a & have_l
    above_ext = torch.where(
        both_missing[..., None], base - 1,
        torch.where(only_l[..., None], left_ext[..., 0:1], above_ext))
    left_ext = torch.where(
        both_missing[..., None], base + 1,
        torch.where(only_a[..., None], above_ext[..., 0:1], left_ext))
    al_ext = torch.where(
        both_missing, base,
        torch.where(only_a, above_ext[..., 0],
                    torch.where(only_l, left_ext[..., 0], al)))
    return dict(
        above=above.to(i32), left=left.to(i32), al=al_ext.to(i32),
        have_a=have_a, have_l=have_l, above_s=above_s.to(i32),
        left_s=left_s.to(i32), al_s=al_s.to(i32), dc=dc.to(i32),
        above_ext=above_ext.to(i32), left_ext=left_ext.to(i32),
    )


def _check_depth(bit_depth: int) -> None:
    if bit_depth > MAX_BIT_DEPTH:
        raise ValueError(f"bit_depth {bit_depth}: the block search takes "
                         f"planes of at most {MAX_BIT_DEPTH} bits")


def _check_shape(H: int, W: int, n: int) -> None:
    if H % n or W % n:
        raise ValueError(f"plane {H}x{W} is not a multiple of {n}")


def search_inputs(planes, n: int, bit_depth: int, dc_q, ac_q, lam) -> dict:
    """K3's keyword arguments for every aligned n x n block of planes
    (N, H, W) int32 on one device: the per-block tensors of
    pallas_search._prep, flattened to NB = N * nby * nbx rows, the block
    size's constant tables (with K3's split D, `tiles`), and the quantizer
    of dc_q / ac_q at lam. Raises ValueError above MAX_BIT_DEPTH."""
    _check_depth(bit_depth)
    N, H, W = planes.shape
    nby, nbx = H // n, W // n
    NB = N * nby * nbx
    dev = planes.device
    nb = _neighbors(planes, n, bit_depth)
    blocks = (planes.reshape(N, nby, n, nbx, n).permute(0, 1, 3, 2, 4)
              .reshape(NB, n, n).to(torch.int32).contiguous())
    ext = torch.cat([nb["al"][..., None], nb["above_ext"], nb["left_ext"]],
                    -1)
    c = search_consts(n)
    # (inv, scale, bias) of the DC coefficient (lane 0) and of the others
    q = _lane_quant(2, dc_q, ac_q, c["gain"], AC_BIAS)
    dc, ac = (tuple(float(v) for v in q[:, i]) for i in (0, 1))
    return dict(
        blocks=blocks,
        above=nb["above_s"].reshape(NB, n).contiguous(),
        left=nb["left_s"].reshape(NB, n).contiguous(),
        scal=torch.stack([nb["al_s"], nb["dc"]], -1).reshape(NB, 2)
        .contiguous(),
        ext=ext.reshape(NB, 4 * n + 1).contiguous(),
        taps=torch.from_numpy(c["taps"]).to(dev),
        smw=torch.from_numpy(c["smw"]).to(dev),
        dct=torch.from_numpy(c["dct"]).to(dev),
        tiles=torch.from_numpy(c["tiles"]).to(dev),
        ac=ac, dc=dc, lam=_f32(lam),
    )


def _search(planes, n: int, bit_depth: int, dc_q, ac_q, lam, backend: str):
    """(modes int8, min costs f32), each (N, H/n, W/n), for planes
    (N, H, W) int32 on one device."""
    N, H, W = planes.shape
    _check_shape(H, W, n)
    kw = search_inputs(planes, n, bit_depth, dc_q, ac_q, lam)
    cost = (mode_cost if backend == "auto" else mode_cost_ref)(**kw)
    cost = cost.view(N, H // n, W // n, -1)
    best, idx = torch.min(cost, -1)
    return idx.to(torch.int8), best


def _run(planes, n: int, bit_depth: int, backend: str, device, mesh,
         specs, body) -> list:
    """body(x) -> a list of (N', H'/u, W/u) tensors on planes x, run on
    the whole (N, H, W) stack, or with a mesh on this rank's halo'd band
    of whole n-row superblocks and gathered; numpy arrays out. specs: one
    (u, dtype) per output. Every argument is checked before any rank
    computes, so that all ranks raise together."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, not {backend!r}")
    _check_depth(bit_depth)
    dev = resolve_device(device)
    ax = None if mesh is None else shard.axes(mesh)
    planes = np.asarray(planes)
    N, H, W = planes.shape
    _check_shape(H, W, n)

    def upload(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    with torch.inference_mode():
        if ax is None:
            return [t.cpu().numpy() for t in body(upload(planes))]
        shard.check_divisible("H", H, ax.tile, "tile")
        return shard.run_sharded(
            ax, N, H, n, [(u, (W // u,), dt) for u, dt in specs],
            lambda b0, b1, h0, h1: body(upload(planes[b0:b1, h0:h1])))


def _sizes(min_n: int, max_n: int) -> list:
    """The partition search's tiers: min_n, 2 min_n, ... up to max_n."""
    return [min_n << k for k in range((max_n // min_n).bit_length())]


def _partition_body(planes, dc_q, ac_q, lam, bit_depth: int, min_n: int,
                    max_n: int, backend: str):
    """The multi-tier search plus the bottom-up NONE/SPLIT DP on torch
    tensors (the reference's _partition_body): one K3 call per tier n in
    [min_n, max_n]. Returns ({n: (modes, costs)}, {n: codes}) with codes
    0 = NONE, 1 = SPLIT per aligned square of each tier above min_n."""
    sizes = _sizes(min_n, max_n)
    tiers = {n: _search(planes, n, bit_depth, dc_q, ac_q, lam, backend)
             for n in sizes}
    lam32 = np.float32(lam)
    ovb = _f32(lam32 * np.float32(OVH_BLOCK))
    ovs = _f32(lam32 * np.float32(OVH_SPLIT))
    codes = {}
    bc = tiers[sizes[0]][1] + ovb
    for n in sizes[1:]:
        N, nby, nbx = tiers[n][1].shape
        q = bc.reshape(N, nby, 2, nbx, 2).sum((2, 4))
        split_c = ovs + q
        none_c = tiers[n][1] + ovb
        codes[n] = (split_c < none_c).to(torch.int8)
        bc = torch.minimum(none_c, split_c)
    return tiers, codes


def plane_partition_search(
    planes: np.ndarray,
    dc_q: int,
    ac_q: int,
    lam: float,
    bit_depth: int,
    min_n: int = 8,
    max_n: int = 32,
    mesh=None,
    device: str = "cuda",
    backend: str = "auto",
):
    """Run the whole-plane multi-tier search + partition DP. planes:
    (N, H, W) int32 with H, W multiples of max_n, bit_depth at most 10
    (ValueError above). With a mesh, each rank runs K3 on its planes over
    its band of max_n rows and every rank returns the whole result; H must
    be divisible by the tile axis (ValueError), as the reference's
    sharding requires, while N need not be divisible by the data axis
    (the ranks' shares differ by at most one plane). Returns
    ({n: (modes, costs)}, {n: codes}) as host numpy arrays."""
    sizes = _sizes(min_n, max_n)

    def body(x):
        tiers, codes = _partition_body(x, dc_q, ac_q, lam, bit_depth, min_n,
                                       max_n, backend)
        return [t for n in sizes for t in tiers[n]] \
            + [codes[n] for n in sizes[1:]]

    specs = [(n, dt) for n in sizes for dt in (np.int8, np.float32)] \
        + [(n, np.int8) for n in sizes[1:]]
    out = _run(planes, max_n, bit_depth, backend, device, mesh, specs, body)
    tiers = {n: (out[2 * i], out[2 * i + 1]) for i, n in enumerate(sizes)}
    return tiers, dict(zip(sizes[1:], out[2 * len(sizes):]))


def plane_mode_search_costs(
    planes: np.ndarray,
    dc_q: int,
    ac_q: int,
    lam: float,
    bit_depth: int,
    n: int = 32,
    backend: str = "auto",
    device: str = "cuda",
    mesh=None,
):
    """Best intra mode (13 candidates) and its RD cost for every aligned
    n x n block of a batch of planes: (modes int8 (N, H/n, W/n), costs f32
    (N, H/n, W/n)). planes: (N, H, W) with H, W multiples of n, bit_depth
    at most 10 (ValueError above). A mesh shards as in
    plane_partition_search, over bands of n rows."""
    modes, costs = _run(
        planes, n, bit_depth, backend, device, mesh,
        [(n, np.int8), (n, np.float32)],
        lambda x: _search(x, n, bit_depth, dc_q, ac_q, lam, backend))
    return modes, costs


def plane_mode_search(
    planes: np.ndarray,
    dc_q: int,
    ac_q: int,
    lam: float,
    bit_depth: int,
    n: int = 32,
    backend: str = "auto",
    device: str = "cuda",
    mesh=None,
):
    """Best intra mode (13 candidates) for every aligned n x n block of a
    batch of planes. planes: (N, H, W) with H, W multiples of n, bit_depth
    at most 10 (ValueError above); a mesh as in plane_mode_search_costs.
    Returns (N, H/n, W/n) int8 indices into CAND_MODES."""
    return plane_mode_search_costs(planes, dc_q, ac_q, lam, bit_depth, n,
                                   backend, device, mesh)[0]
