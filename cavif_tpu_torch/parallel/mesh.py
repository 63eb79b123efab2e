"""Sharding over a (data = images, tile = block rows) mesh on
torch.distributed: the port's counterpart of the reference's GSPMD
shardings (cavif_tpu/ops/device_pass1.py `run_pass1_batch`,
ops/block_search.py `plane_partition_search`, parallel/batch.py), as plain
functions.

A mesh is a `torch.distributed.device_mesh.DeviceMesh` whose dimension
names are "data" and/or "tile"; a missing name counts as size 1, as the
reference's `mesh.shape.get("data", 1)` does. Every process of the mesh
calls the entry point with the whole input, as each process of the
reference does. A rank computes the images of its `data` index over the
band of whole superblock rows of its `tile` index, plus one superblock row
of halo above and one below (clipped only at the plane's own edges), cut
from the host array, so the input needs no collective. It crops its result
to its band, and an all_gather over the mesh's process groups makes the
output replicated on every rank (the reference's out_shardings=P()). The
bands and image shares need not be equal: each rank's payload is padded to
the largest and cropped again, and a rank whose share is empty still joins
every collective. The collectives run on the mesh's `device_type` ("cpu"
for gloo, "cuda" for NCCL, on the current CUDA device); the kernels run on
the entry point's device.

Why one superblock row of halo is enough: a block reads one pixel row
above it and, for the directional predictors' extended left column, at
most a superblock row below its bottom; the partition DP merges only
inside a superblock. So every block of a band sees in the halo'd band what
it sees in the whole plane, once the tile-boundary test reads the band's
global first row (device_pass1._nbrs's `row0`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

AXES = ("data", "tile")


@dataclass(frozen=True)
class MeshAxes:
    """A DeviceMesh read as (data, tile): the axis sizes and this rank's
    coordinates."""

    mesh: object  # torch.distributed.device_mesh.DeviceMesh
    data: int
    tile: int
    di: int
    ti: int

    def _coord(self, rank: int, name: str) -> int:
        """The coordinate along `name` of global rank `rank`."""
        dim = self.mesh.mesh_dim_names.index(name)
        return int((self.mesh.mesh == rank).nonzero()[0][dim])


def axes(mesh) -> MeshAxes:
    """The (data, tile) axes of `mesh`. Raises TypeError for anything but a
    DeviceMesh, ValueError for dimension names other than "data" and
    "tile" or a process outside the mesh."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError("mesh must be a torch.distributed DeviceMesh, not "
                        f"{type(mesh).__name__}")
    names = tuple(mesh.mesh_dim_names or ())
    if not names or len(set(names)) != len(names) or set(names) - set(AXES):
        raise ValueError(f"mesh dimensions {names}: the mesh names 'data' "
                         "and/or 'tile', once each")
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this process is not a rank of the mesh")
    size = dict(zip(names, mesh.shape))
    at = dict(zip(names, coord))
    return MeshAxes(mesh, size.get("data", 1), size.get("tile", 1),
                    at.get("data", 0), at.get("tile", 0))


def check_divisible(what: str, n: int, parts: int, axis: str) -> None:
    """The reference places its input with a NamedSharding, which refuses a
    dimension that the mesh axis does not divide (ValueError)."""
    if n % parts:
        raise ValueError(f"{what} = {n} is not divisible by the mesh's "
                         f"{axis!r} axis of size {parts}")


def split(n: int, parts: int) -> list:
    """n items as `parts` contiguous runs [(start, stop)], the first
    n % parts runs one longer."""
    q, r = divmod(n, parts)
    out, a = [], 0
    for i in range(parts):
        b = a + q + (i < r)
        out.append((a, b))
        a = b
    return out


def bands(H: int, unit: int, tile: int) -> list:
    """The rows [(y0, y1)] of each tile index: whole `unit`-row superblock
    rows, split as evenly as they go."""
    return [(a * unit, b * unit) for a, b in split(H // unit, tile)]


def halo(band: tuple, H: int, unit: int) -> tuple:
    """The rows (h0, h1) a band is computed over: one `unit` row above and
    one below, clipped at the plane's edges."""
    y0, y1 = band
    return max(0, y0 - unit), min(H, y1 + unit)


def _nbytes(spec, nb: int, rows: int) -> int:
    unit, rest, dtype = spec
    return nb * (rows // unit) * math.prod(rest) * np.dtype(dtype).itemsize


def run_sharded(ax: MeshAxes, B: int, H: int, unit: int, specs, body):
    """This rank's share of a (B, H, ...) computation, gathered so that
    every rank returns the whole output.

    specs: one (row unit px, trailing shape, numpy dtype) per output.
    body(b0, b1, h0, h1) computes images b0:b1 over the halo'd rows h0:h1
    and returns one tensor per spec, (b1 - b0, (h1 - h0) // unit_k,
    *trailing_k), on any device; it runs only on a rank whose share is not
    empty. Returns one numpy array per spec, (B, H // unit_k,
    *trailing_k)."""
    imgs = split(B, ax.data)
    bnds = bands(H, unit, ax.tile)
    (b0, b1), (y0, y1) = imgs[ax.di], bnds[ax.ti]
    local = None
    if b1 > b0 and y1 > y0:
        h0, h1 = halo((y0, y1), H, unit)
        outs = body(b0, b1, h0, h1)
        local = [t[:, (y0 - h0) // u : (y1 - h0) // u]
                 for t, (u, _, _) in zip(outs, specs)]
    return _gather(ax, specs, local, imgs, bnds, B, H)


def _gather(ax: MeshAxes, specs, local, imgs, bnds, B: int, H: int):
    sizes = [[sum(_nbytes(s, b1 - b0, y1 - y0) for s in specs)
              for (y0, y1) in bnds] for (b0, b1) in imgs]
    width = max(max(row) for row in sizes)
    dev = torch.device(ax.mesh.device_type)
    buf = torch.zeros(width, dtype=torch.uint8, device=dev)
    if local is not None:
        flat = torch.cat([t.contiguous().reshape(-1).view(torch.uint8)
                          for t in local])
        if flat.numel() != sizes[ax.di][ax.ti]:
            raise RuntimeError(f"rank share of {flat.numel()} bytes, "
                               f"expected {sizes[ax.di][ax.ti]}")
        buf[: flat.numel()] = flat.to(dev)
    allb = _all_gather(ax, "data", _all_gather(ax, "tile", buf))
    allb = allb.cpu().numpy()  # (data, tile, width)
    outs = [np.empty((B, H // u, *rest), dtype) for (u, rest, dtype) in specs]
    for di, (b0, b1) in enumerate(imgs):
        for ti, (y0, y1) in enumerate(bnds):
            if b1 == b0 or y1 == y0:
                continue
            off = 0
            for out, s in zip(outs, specs):
                u, rest, _ = s
                n = _nbytes(s, b1 - b0, y1 - y0)
                out[b0:b1, y0 // u : y1 // u] = np.frombuffer(
                    allb[di, ti], out.dtype, n // out.itemsize, off,
                ).reshape(b1 - b0, (y1 - y0) // u, *rest)
                off += n
    return outs


def _all_gather(ax: MeshAxes, name: str, t):
    """t from every rank along mesh axis `name`, stacked in the order of
    that axis' coordinate: (size, *t.shape). An axis the mesh does not
    name has size 1 and no group."""
    if name not in ax.mesh.mesh_dim_names:
        return t[None]
    import torch.distributed as dist

    group = ax.mesh.get_group(name)
    n = dist.get_world_size(group)
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    at = {ax._coord(dist.get_global_rank(group, i), name): p
          for i, p in enumerate(parts)}
    return torch.stack([at[c] for c in range(n)])
