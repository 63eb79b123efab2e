"""Multi-process scaling benchmark for the sharded whole-batch pass 1.

    python -m cavif_tpu_torch.tools.scale_bench [--n 4] [--size 512]
    python -m cavif_tpu_torch.tools.scale_bench --device cpu --n 2 --size 128

Port of the repository's tools/scale_bench.py. The FULL batched device
pass 1 (ops/device_pass1.run_pass1_batch: every tier/rect/delta search
plus the partition DP, the program behind every card encode) runs over a
(data, tile) mesh of torch.distributed ranks, one process each, at 1 and
2 ranks; the mesh is (world, 1): the ranks split the images. Prints one
JSON line with the reference's keys: {"mp_s_1proc": ..., "mp_s_2proc":
..., "scaling": ..., "note": ...}, MP/s of input per warm call (mean of
3 after one warm-up) on rank 0's host clock.

The ranks use gloo: on the CPU its collectives carry everything; on the
card the kernels run on CUDA tensors while gloo moves the gathered result
through the host, because two NCCL ranks cannot share one card. With one
card the two ranks contend for it, so the 2-rank figure measures
contention, not scaling; across cards the same script is the scaling
measurement.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

REPS = 3
RANK_TIMEOUT = 600.0


def _worker(a) -> int:
    """One rank: the group, the mesh, one warm call and REPS timed calls;
    rank 0 prints "RESULT <MP/s>"."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from ..ops import device_pass1 as dp
    from ..parallel import ranks

    device = dp.resolve_device(a.device)
    if device == "cpu":
        torch.set_num_threads(max(1, torch.get_num_threads() // a.world))
    else:  # a card per rank where there are enough, else they share
        torch.cuda.set_device(a.rank % torch.cuda.device_count())
        device = f"cuda:{torch.cuda.current_device()}"
    ranks.init_rank(a.rank, a.world, a.port, "gloo", RANK_TIMEOUT)
    try:
        mesh = init_device_mesh("cpu", (a.world, 1),
                                mesh_dim_names=("data", "tile"))
        rng = np.random.default_rng(0)
        srcs = rng.integers(0, 256, (a.n, a.size, a.size, 3), dtype=np.uint8)
        kw = dict(depth=10, tile_px=(a.size, a.size), min_px=4,
                  use_deltas=True, dc_q=499, ac_q=616, lam=30.0, mesh=mesh,
                  device=device)
        dp.run_pass1_batch(srcs, **kw)  # warm: kernels built and loaded
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(REPS):
            dp.run_pass1_batch(srcs, **kw)  # ends in a host fetch
        dt = (time.perf_counter() - t0) / REPS
        if a.rank == 0:
            print("RESULT %.6f" % (a.n * a.size * a.size / 1e6 / dt),
                  flush=True)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def run_config(n_proc: int, n_img: int, size: int, device: str) -> float:
    """MP/s of `n_img` images of size x size over `n_proc` ranks."""
    from ..parallel import ranks

    outs = ranks.run_ranks([sys.executable, "-m",
                            "cavif_tpu_torch.tools.scale_bench", "--n", n_img,
                            "--size", size, "--device", device],
                           n_proc, RANK_TIMEOUT)
    found = [float(line.split()[1]) for line in outs[0].splitlines()
             if line.startswith("RESULT ")]
    if len(found) != 1:
        raise RuntimeError(f"rank 0 printed no result: {outs[0][-500:]}")
    return found[0]


def _retry_gloo(fn):
    """One retry on a gloo rendezvous timeout (a rank that reaches the
    group late on a loaded host), as the reference does."""
    try:
        return fn()
    except RuntimeError as e:
        if "timed out" not in str(e).lower() \
                and "DEADLINE_EXCEEDED" not in str(e):
            raise
        return fn()


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m cavif_tpu_torch.tools.scale_bench")
    ap.add_argument("--n", type=int, default=8, help="images per batch")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    # a rank of run_config
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--world", type=int)
    ap.add_argument("--port", type=int)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    import torch

    from ..ops import device_pass1 as dp

    a = parse_args(argv)
    if a.rank is not None:
        return _worker(a)
    device = dp.resolve_device(a.device)
    r1 = _retry_gloo(lambda: run_config(1, a.n, a.size, device))
    r2 = _retry_gloo(lambda: run_config(2, a.n, a.size, device))
    if device == "cpu":
        where = "the CPU"
    elif torch.cuda.device_count() < 2:
        where = "one card shared by both ranks (contention, not scaling)"
    else:
        where = "a card per rank"
    print(json.dumps({
        "mp_s_1proc": r1,
        "mp_s_2proc": r2,
        "scaling": r2 / r1,
        "note": f"whole-batch device pass-1 MP/s of {a.n} images of "
                f"{a.size}x{a.size}, (world, 1) mesh of 1 and 2 "
                f"torch.distributed ranks over gloo on {where}",
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
