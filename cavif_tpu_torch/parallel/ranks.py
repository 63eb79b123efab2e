"""Processes as torch.distributed ranks on localhost: the launcher behind the
entry point's multi-rank dry run (cavif_tpu_torch/entry.py), the scaling
bench (tools/scale_bench.py) and chip_smoke.py's [mesh] phase.

`run_ranks` starts `world` processes of one command, each given its rank,
the world size and one free TCP port, waits for all of them and returns
their standard outputs; a rank that fails or outlives the deadline fails
the call, and every process is stopped. `init_rank` is the rank's side:
the process group on that port. Nothing here reads a cluster's
environment: the address, world size and rank are passed explicitly.
"""

from __future__ import annotations

import os
import socket
import subprocess
import tempfile
import time
from datetime import timedelta

from .._child import with_root


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def backend_for(device: str, world: int) -> str:
    """"nccl" where every rank has a card of its own, else "gloo" (the CPU,
    or several ranks sharing a card: NCCL refuses two ranks on one
    device)."""
    import torch

    if device.startswith("cuda") and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def run_ranks(cmd: list, world: int, timeout: float,
              log_dir: str | None = None) -> list:
    """Run `*cmd --rank r --world world --port p` for r < world, all
    started together with the repository on PYTHONPATH; returns their
    standard outputs in rank order.

    Each rank writes its standard output and error to files (rank<r>.out,
    rank<r>.err in `log_dir`, kept there, else in a temporary directory),
    so that no rank blocks on a full pipe while the others wait for it in
    a collective. Raises RuntimeError, with the error output of every
    failing rank, when a rank exits non-zero or is still running after
    `timeout` seconds in all; every process is stopped before it returns
    or raises."""
    port = free_port()
    env = with_root(dict(os.environ))
    with tempfile.TemporaryDirectory() as tmp:
        d = log_dir or tmp
        os.makedirs(d, exist_ok=True)
        files = [(open(os.path.join(d, f"rank{r}.out"), "w+"),
                  open(os.path.join(d, f"rank{r}.err"), "w+"))
                 for r in range(world)]
        procs, late = [], []
        try:
            for r, (out, err) in enumerate(files):
                procs.append(subprocess.Popen(
                    [*map(str, cmd), "--rank", str(r), "--world", str(world),
                     "--port", str(port)],
                    env=env, stdout=out, stderr=err, text=True))
            deadline = time.time() + timeout
            for r, p in enumerate(procs):
                try:
                    p.wait(timeout=max(1.0, deadline - time.time()))
                except subprocess.TimeoutExpired:
                    late.append(r)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            texts = []
            for out, err in files:
                out.seek(0)
                err.seek(0)
                texts.append((out.read(), err.read()))
                out.close()
                err.close()
    bad = [r for r, p in enumerate(procs) if r in late or p.returncode != 0]
    if bad:
        what = " ".join(map(str, cmd[1:3]))[:80]
        raise RuntimeError("\n".join(
            f"{what}: rank {r} of {world} "
            + (f"still running after {timeout:.0f} s" if r in late
               else f"exited {procs[r].returncode}")
            + f": {texts[r][1][-2000:]}" for r in bad))
    return [out for out, _ in texts]


def init_rank(rank: int, world: int, port: int, backend: str,
              timeout: float = 300.0) -> None:
    """This process's membership of the group on localhost:`port`."""
    import torch.distributed as dist

    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=timeout))
