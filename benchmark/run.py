"""Run one cell of the benchmark of cavif_tpu_torch once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout on a machine with an NVIDIA card. Set-up
generates the cell's image pool from the seed on the card, builds the
encoder from the cell's configuration and warms up the cell's shapes
(the first run in a checkout also builds the port's kernels into
`cavif_tpu_torch/_build/` and its tile coder beside its sources). The
window then drives the cell's entry in a closed loop for `--seconds`,
and the plain reference judges every answer. The last line of standard
output is one JSON object; the numbers compared, each beside its limit,
are the last lines of standard error and the result's last key.

With `--trace 0` the result carries the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics, read from the port's spans over the
window and from `torch.profiler` over the sub-window the cell's file
sets. Without a card, or with fewer than the cell asks for, it exits 2
and prints no result; where the program ran in another mode than the
cell's file states (its filter chain off), it exits 4 and prints none.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# every cache in a fixed directory inside the checkout
os.environ["TRITON_CACHE_DIR"] = str(BENCH / ".cache" / "triton")
if str(ROOT) not in sys.path:
    sys.path.insert(1, str(ROOT))

from harness import spec  # noqa: E402
from harness import devtrace  # noqa: E402
from harness.session import Session  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "cavif_tpu"}


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="python3 benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def card_check(chips: int) -> str | None:
    """Why this machine cannot run the cell, or None."""
    import torch

    if not torch.cuda.is_available():
        return "no CUDA device (torch.cuda.is_available() is false)"
    if torch.cuda.device_count() < chips:
        return (f"the cell asks for {chips} cards, "
                f"{torch.cuda.device_count()} present")
    return None


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def metrics(entries: list, win, cell) -> dict:
    out = {}
    for m in entries:
        v = spec.reader(m["name"])(win, cell)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def run(args, cell, device: str = "cuda", wrap=None, settings=None):
    """One run: (result dict, check dict). `device`, `wrap` (a planted
    fault around the entry) and `settings` (a control's encoder) exist
    for the benchmark's own tests; a run from the command line takes the
    card and the cell as they are."""
    sess = Session(cell, args.seed, device, settings=settings, wrap=wrap)
    if args.trace:
        devtrace.warm(device == "cuda")
    setup_s = time.perf_counter() - T0
    win = sess.window(args.seconds, trace=bool(args.trace))
    win.setup_s = setup_s
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": None, "count": int(cell.entry["chips"]),
           "memory_peak_bytes": 0}
    if device == "cuda":
        import torch

        dev["kind"] = torch.cuda.get_device_name(0)
        dev["memory_peak_bytes"] = max(
            torch.cuda.max_memory_allocated(i)
            for i in range(dev["count"]))
        torch.cuda.empty_cache()
    check, notes = sess.check(win)
    picked = cell.per_layer if args.trace else cell.end_to_end
    result = {"metrics": metrics(picked, win, cell)}
    if args.trace and win.device is not None:
        dev["busy_s"] = win.device.busy_s
        dev["window_s"] = win.device.window_s
        result["breakdown"] = devtrace.breakdown(win.device)
    result["device"] = dev
    fails = [k for k, c in check.items()
             if c["value"] is None or c["value"] > c["limit"]]
    result.update(correct=not fails and bool(win.answers),
                  attempted=len(win.answers),
                  failed=sum(a.avif is None for a in win.answers))
    result["notes"] = notes
    result["mode"] = sess.mode()
    result["mode_faults"] = sess.mode_faults()
    result["host"] = win.host
    return result, check


def main(argv=None) -> int:
    args = parse_args(argv)
    cell = spec.cell(args.workload)
    why = card_check(int(cell.entry["chips"]))
    if why:
        print(f"benchmark: {why}; no result", file=sys.stderr)
        return 2
    result, check = run(args, cell)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: loaded {', '.join(bad)} in the measuring process;"
              " no result", file=sys.stderr)
        return 3
    if result["mode_faults"]:
        # another program mode is another measurement, not this cell's
        print(f"benchmark: the program ran in another mode than the cell "
              f"states ({'; '.join(result['mode_faults'])}); "
              f"mode {result['mode']}; no result", file=sys.stderr)
        return 4
    for name, c in check.items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    line = {k: result[k] for k in ("correct", "attempted", "failed",
                                    "metrics", "device")}
    if "breakdown" in result:
        line["breakdown"] = result["breakdown"]
    for k in ("notes", "mode", "host"):
        line[k] = result[k]
    line["check"] = check
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
