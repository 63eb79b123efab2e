"""Shared pieces of the benchmark's CPU tests: a cell cut to a tiny image
for a run on the CPU."""

import argparse

from harness import spec


def tiny(name: str, size: int = 64, pool: int = 3, length: int = 2):
    """Cell `name` with its image cut to size x size and its pool, lists
    and profile shortened, for a run on the CPU."""
    cell = spec.cell(name)
    cell.config["image"].update(height=size, width=size)
    cell.spec.update(pool=pool, warmup=[1])
    if cell.spec.get("list_length", 1) > 1:
        cell.spec["list_length"] = length
    cell.spec["profile"] = {"start_s": 0.2, "seconds": 1.0}
    return cell


def args(name: str, seed: int = 2_147_483_999, seconds: float = 1.0,
         trace: int = 0):
    return argparse.Namespace(workload=name, seed=seed, seconds=seconds,
                              trace=trace)
