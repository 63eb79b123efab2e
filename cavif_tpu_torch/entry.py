"""Entry points of the port for a multi-device dry run: its counterpart
of the repository's __graft_entry__.py.

    python -m cavif_tpu_torch.entry                # on the card(s)
    python -m cavif_tpu_torch.entry --device cpu --n 2

entry() returns the flagship device program and example arguments;
dryrun_multichip(n) runs the batched program over a (data, tile) mesh of n
ranks on torch.distributed and asserts the packed output's shape.

Flagship device pipeline: the encoder's whole pass 1 as one program
(ops/device_pass1.Pass1Program, the card's compute path of every encode):
uint8 RGB batch -> on-device BT.601 conversion -> per-shape whole-plane
intra mode searches (square tiers 4..32 px plus both rect halves of each
square; the nondirectional predictors in kernel K2 and the directional
family with angle deltas in kernel K1) -> bottom-up NONE/SPLIT/HORZ/VERT
partition DP -> packed int8 decision grids. Under a (data = images,
tile = block rows) mesh each rank computes its images over its band of
superblock rows plus a halo (parallel/mesh.py), and an all_gather
replicates the result.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

H = W = 128  # two superblock rows/cols per image
ARGS = (499.0, 616.0, 30.0, 64, 64)  # dc_q, ac_q, lambda, tile rows, cols
KW = dict(depth=10, tile_px=(64, 64), min_px=4, max_px=32, use_deltas=True,
          dc_q=499, ac_q=616, lam=30.0, ovh_block=23.0, ovh_split=2.0,
          rect_ovh=4.0, model="ycbcr")
RANK_TIMEOUT = 600.0  # seconds for all ranks of a dry run together


def _key() -> tuple:
    """The reference's program key (batch, 128, 128, 10, "ycbcr", 4, 32,
    True, 23.0, 2.0, 4.0) as a Pass1Program key (no batch; the plane count
    P)."""
    return (H, W, KW["depth"], KW["model"], 3, KW["min_px"], KW["max_px"],
            KW["use_deltas"], KW["ovh_block"], KW["ovh_split"],
            KW["rect_ovh"])


def batch(b: int) -> np.ndarray:
    """The example batch of b images: (b, H, W, 3) uint8 from seed 0."""
    return np.random.default_rng(0).integers(0, 256, size=(b, H, W, 3),
                                             dtype=np.uint8)


def entry(device: str = "cuda"):
    """(program, example arguments): the port's Pass1Program of the
    reference's key (ops/device_pass1._program, shared with
    run_pass1_batch: bf16 products on the card, f32 on the CPU) and
    (src, dc_q, ac_q, lam, th, tw) with src the seeded 2-image batch on
    `device`. program(*args) is the packed (2, total) int8 tensor. Raises
    without a card when `device` is "cuda"."""
    import torch

    from .ops import device_pass1 as dp

    device = dp.resolve_device(device)
    prog = dp._program(_key(), "f32" if device == "cpu" else "bf16", device)
    src = torch.from_numpy(batch(2)).to(device)
    return prog, (src, *(dp._f32(a) for a in ARGS[:3]), *ARGS[3:])


def width() -> int:
    """The packed row's length: the sum of nby * nbx over the program's
    grids (device_pass1.program_spec)."""
    from .ops import device_pass1 as dp

    return sum(nby * nbx for (_, _, (nby, nbx))
               in dp.program_spec(H, W, 3, KW["min_px"], KW["max_px"]))


def pack(grids: list) -> np.ndarray:
    """run_pass1_batch's grid dicts as the program's packed (B, total) int8
    rows, laid out by device_pass1.program_spec."""
    from .ops import device_pass1 as dp

    spec = dp.program_spec(H, W, 3, KW["min_px"], KW["max_px"])
    return np.stack([np.concatenate([g[(shape, name)].reshape(-1)
                                     for shape, name, _ in spec])
                     for g in grids])


def mesh_shape(n: int) -> tuple:
    """(data, tile) of n ranks, as the reference lays out n devices."""
    return (n // 2, 2) if n % 2 == 0 else (n, 1)


def dryrun_multichip(n_devices: int, device: str = "cuda") -> np.ndarray:
    """Run the batched program over a (data, tile) mesh of n_devices ranks
    and return rank 0's packed (b, total) output, b = 2 x data.

    It SPAWNS its ranks: n_devices processes of this module on localhost
    (parallel/ranks.py), each joining a fresh torch.distributed group
    (NCCL where each rank has a card of its own, else gloo, whose
    collectives run on the CPU while the kernels run on `device`), forming
    the mesh and calling run_pass1_batch on the whole batch; each rank
    asserts the packed shape (b, sum of nby * nbx), and the ranks' outputs
    must agree. The caller needs no process group of its own."""
    import tempfile

    from .ops import device_pass1 as dp
    from .parallel import ranks

    device = dp.resolve_device(device)
    backend = ranks.backend_for(device, n_devices)
    with tempfile.TemporaryDirectory() as tmp:
        ranks.run_ranks([sys.executable, "-m", "cavif_tpu_torch.entry",
                         "--device", device, "--backend", backend,
                         "--out", tmp], n_devices, RANK_TIMEOUT)
        outs = [np.load(f"{tmp}/rank{r}.npy") for r in range(n_devices)]
    for r, o in enumerate(outs[1:], 1):
        if not np.array_equal(o, outs[0]):
            raise AssertionError(f"dryrun_multichip: rank {r} differs from "
                                 "rank 0")
    return outs[0]


def _rank(a) -> int:
    """One rank of dryrun_multichip."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from .ops import device_pass1 as dp
    from .parallel import ranks

    device = a.device
    if device.startswith("cuda"):
        torch.cuda.set_device(a.rank % torch.cuda.device_count())
        device = f"cuda:{torch.cuda.current_device()}"
    ranks.init_rank(a.rank, a.world, a.port, a.backend)
    try:
        shape = mesh_shape(a.world)
        mesh = init_device_mesh("cuda" if a.backend == "nccl" else "cpu",
                                shape, mesh_dim_names=("data", "tile"))
        b = shape[0] * 2
        packed = pack(dp.run_pass1_batch(batch(b), mesh=mesh, device=device,
                                         **KW))
        if packed.shape != (b, width()):
            raise AssertionError(f"packed {packed.shape}, expected "
                                 f"{(b, width())}")
        np.save(f"{a.out}/rank{a.rank}.npy", packed)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m cavif_tpu_torch.entry")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--n", type=int, default=None,
                    help="ranks of the dry run (default: the card count, "
                         "1 on the CPU)")
    # a rank of dryrun_multichip
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--world", type=int)
    ap.add_argument("--port", type=int)
    ap.add_argument("--backend")
    ap.add_argument("--out")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    import torch

    a = parse_args(argv)
    if a.rank is not None:
        return _rank(a)
    fn, args = entry(a.device)
    with torch.inference_mode():
        print("entry ok:", tuple(fn(*args).shape))
    n = a.n or (torch.cuda.device_count() if a.device.startswith("cuda")
                else 1)
    dryrun_multichip(n, a.device)
    print("dryrun_multichip ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
