"""What the host gives a run, read beside the window, and the one step the
harness takes to keep it the same from run to run.

Readings (each result's `host`): this process's CPU seconds beside the
wall time, and Python's garbage collections by generation over the
window with their pauses. The steadying step acts on this process alone.
"""

from __future__ import annotations

import gc
import os
import resource
import time


def now() -> dict:
    """This process's CPU seconds (every thread's) and the host clock."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"t": time.perf_counter(), "cpu_s": ru.ru_utime + ru.ru_stime}


class GcClock:
    """Python's garbage collections between start() and stop(): each one's
    generation and pause."""

    def __init__(self):
        self.events = []  # (generation, seconds)
        self._t = None

    def _callback(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.events.append((info["generation"],
                                time.perf_counter() - self._t))
            self._t = None

    def start(self) -> None:
        gc.callbacks.append(self._callback)

    def stop(self) -> None:
        if self._callback in gc.callbacks:
            gc.callbacks.remove(self._callback)

    def reading(self) -> dict:
        out = {}
        for g in range(3):
            got = [s for gen, s in self.events if gen == g]
            out[f"gc_count_{g}"] = len(got)
            out[f"gc_pause_s_{g}"] = sum(got)
        out["gc_frozen"] = gc.get_freeze_count()
        return out


def state(before: dict, after: dict) -> dict:
    """What the host gave the run over a window: this process's CPU
    seconds beside the wall time, its cores and its torch threads, so that
    fast runs can be told from slow ones by more than their times."""
    import torch

    return {"cpus": len(os.sched_getaffinity(0)),
            "torch_threads": torch.get_num_threads(),
            "torch_interop_threads": torch.get_num_interop_threads(),
            "omp_num_threads": os.environ.get("OMP_NUM_THREADS"),
            "process_cpu_s": after["cpu_s"] - before["cpu_s"],
            "wall_s": after["t"] - before["t"]}


def settle() -> None:
    """After set-up, before the window: collect what set-up left behind
    once, and move every object that survives into the permanent
    generation, so that the window's collections walk only the objects
    the window makes, and each run's pauses are alike."""
    gc.collect()
    gc.freeze()
