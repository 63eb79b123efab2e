"""Child processes of the package: `python -m cavif_tpu_torch...` started
from any working directory.

`with_root` puts the repository first on a child's module path; the rank
launcher (parallel/ranks.py) starts its ranks through it. `run_json` runs
one child of a tool (tools/ssim_probe.py, tools/trellis_sweep.py: each
env-knob setting in a fresh process, because the native tile coder reads
the knobs once, at load) and returns the JSON object of its last line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def with_root(env: dict) -> dict:
    """`env` with the repository first on PYTHONPATH, so that a child
    started as `python -m cavif_tpu_torch...` finds the package."""
    path = env.get("PYTHONPATH")
    return {**env, "PYTHONPATH": ROOT if not path
            else ROOT + os.pathsep + path}


def run_json(module: str, argv: list, env: dict):
    """`python -m module *argv` under `env` (with the repository on its
    path); returns the JSON value of its last line of standard output.
    Raises RuntimeError with the end of its error output when it exits
    non-zero."""
    r = subprocess.run([sys.executable, "-m", module, *argv],
                       capture_output=True, text=True, env=with_root(env))
    if r.returncode != 0:
        raise RuntimeError(f"{module} exited {r.returncode}: "
                           f"{r.stderr[-2000:]}")
    return json.loads(r.stdout.splitlines()[-1])
