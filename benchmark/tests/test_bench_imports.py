"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module name; the reference loads nothing of the port."""

import json
import subprocess
import sys

from harness import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "cavif_tpu"}

PROBE = """
import json, sys
sys.path[:0] = [{bench!r}, {root!r}]
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _loaded(body: str) -> set:
    code = PROBE.format(bench=str(spec.BENCH), root=str(spec.ROOT), body=body)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True,
                         env={"PATH": "/usr/bin:/bin", "HOME": "/tmp"})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_reference_loads_nothing_of_the_program():
    got = _loaded("""
import numpy as np
from reference import avif
img = np.zeros((16, 16, 3), np.uint8)
avif.judge(b"not a file", img, {})
""")
    assert not got & (FORBIDDEN | {"cavif_tpu_torch", "torch"})


def test_a_cpu_run_loads_no_jax():
    got = _loaded("""
import run as R
from harness import spec
cell = spec.cell("defaults1mp-single")
cell.config["image"].update(height=64, width=64)
cell.spec.update(pool=2, warmup=[1])
cell.spec["profile"] = {"start_s": 0.1, "seconds": 0.5}
import argparse
a = argparse.Namespace(workload=cell.name, seed=5, seconds=0.5, trace=1)
res, chk = R.run(a, cell, device="cpu")
assert res["correct"], (res, chk)
for m in R.spec.manifest()["per_layer"] + R.spec.manifest()["end_to_end"]:
    R.spec.reader(m["name"])
import readings, harness.faults
assert R.forbidden_modules() == []
""")
    assert "cavif_tpu_torch" in got
    assert not got & FORBIDDEN
