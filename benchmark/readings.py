"""Readings that the limits of `correct` are set from, on the card.

    python3 benchmark/readings.py --workload <name> --seconds <s> \
        --plan sound:12,depth8:3,stale:3,flip:3 [--seed-base <n>]

For each step of the plan, one set-up in this process (the program as
the cell runs it, the control `depth8`, or a fault of harness/faults.py
planted under the entry) and then one window of `--seconds` at the cell's
own load on each of that many seeds (`seed-base` + a step's offset + i),
judged as a run judges it. Prints one JSON line per window with the
numbers compared. The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
if str(BENCH.parent) not in sys.path:
    sys.path.insert(1, str(BENCH.parent))

from harness import spec  # noqa: E402
from harness.faults import CONTROLS, FAULTS  # noqa: E402
from harness.session import Session  # noqa: E402


def readings(cell, mode: str, seeds: list, seconds: float,
             device: str = "cuda"):
    """[(seed, numbers compared)] of one plan step."""
    settings = wrap = None
    if mode in CONTROLS:
        settings = {**cell.config["encoder"], **CONTROLS[mode]}
    elif mode in FAULTS:
        wrap = FAULTS[mode]
    elif mode != "sound":
        raise KeyError(f"no mode {mode!r}")
    sess = Session(cell, seeds[0], device, settings=settings, wrap=wrap)
    out = []
    for i, seed in enumerate(seeds):
        if i:
            sess.reseed(seed)
        win = sess.window(seconds)
        check, notes = sess.check(win)
        nums = {k: c["value"] for k, c in check.items()}
        out.append((seed, nums, len(win.answers), notes))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 benchmark/readings.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--plan", default="sound:12,depth8:3,stale:3,flip:3")
    ap.add_argument("--seed-base", type=int, default=3_000_000_000)
    a = ap.parse_args(argv)
    cell = spec.cell(a.workload)
    for k, step in enumerate(a.plan.split(",")):
        mode, n = step.split(":")
        seeds = [a.seed_base + 1000 * k + i for i in range(int(n))]
        t0 = time.perf_counter()
        for seed, nums, answers, notes in readings(cell, mode, seeds,
                                                   a.seconds):
            print(json.dumps({"workload": a.workload, "mode": mode,
                              "seed": seed, "answers": answers,
                              "numbers": nums, "notes": notes}), flush=True)
        print(f"# {mode}: {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
