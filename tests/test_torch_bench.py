"""The port's measurement drivers and their pass-1 hooks, on the CPU.

`kernel_flops` gives the reference's `pallas_flops` count for the same
single-frame and batch keys; `LAST_KEY` / `LAST_ARGS` record what the
reference's record after the same `run_pass1` call (the port's key has no
trailing Pallas gate); `tools/bench` prints exactly one JSON line with the
reference bench.py's keys and a roofline at the H100's peaks;
`tools/bench8k` and `tools/batch512_bench` run small with --device cpu, on
the reference drivers' images."""

import ast
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cavif_tpu.ops import device_pass1 as ref_dp
from cavif_tpu_torch.ops import device_pass1 as dp
from cavif_tpu_torch.tools import batch512_bench, bench, bench8k

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Torch on one thread, here and in the drivers' subprocesses: the
    suite runs several test files at once, and the OpenMP teams of the
    drivers' encode threads would oversubscribe the cores many times
    over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# Pass1Program keys (H, W, depth, model, P, min_px, max_px, use_deltas,
# ovh_block, ovh_split, rect_ovh) and batch lengths: the 64 tier absent
# (max_px 32) and present (64), every model
KEYS = [
    ((1024, 1024, 10, "ycbcr", 3, 4, 32, True, 15.0, 2.0, 4.0), 1),
    ((512, 768, 8, "gbr", 3, 4, 64, True, 23.0, 2.0, 4.0), 1),
    ((256, 512, 10, "mono", 1, 8, 32, False, 15.0, 2.0, 4.0), 1),
    ((4352, 7680, 10, "ycbcr", 3, 4, 32, True, 23.0, 2.0, 4.0), 1),
    ((512, 512, 10, "ycbcr", 3, 4, 32, True, 23.0, 2.0, 4.0), 8),
    ((512, 768, 10, "mono", 1, 4, 64, True, 23.0, 2.0, 4.0), 4),
]


def _ref_key(key, batch):
    """The reference's key for the same program, its Pallas gate True:
    single-frame (..., gate), batch (B, H, W, depth, model, min_px, ...,
    gate)."""
    if batch == 1:
        return key + (True,)
    H, W, depth, model, _P = key[:5]
    return (batch, H, W, depth, model) + key[5:] + (True,)


@pytest.mark.parametrize("key,batch", KEYS)
def test_kernel_flops_equals_pallas_flops(key, batch):
    assert dp.kernel_flops(key, batch) == ref_dp.pallas_flops(
        _ref_key(key, batch))


@pytest.mark.parametrize("key,batch", KEYS)
def test_kernel_bytes_counts_each_input_and_output_once(key, batch):
    """K1 reads ext (R, E) and bkt (R, n2) and writes (R, C), K2 reads
    above, left, sc, blocks and writes (R, 5), all f32, each kernel also
    its bf16 constant and lane vectors; over the shapes up to 32 px."""
    H, W, _, _, P, _, max_px, ud = key[:8]
    want = 0.0
    sq = (4, 8, 16, 32) + ((64,) if max_px >= 64 else ())
    for bw, bh in [(s, s) for s in sq] + list(dp.RECT_SHAPES):
        if max(bw, bh) > 32:
            continue
        R = batch * P * (H // bh) * (W // bw)
        n2, E = bw * bh, 2 * (bw + bh) + 1
        c = len(dp._dir_cands(ud and min(bw, bh) >= 8))
        want += 4.0 * R * (E + n2 + c) + 2.0 * E * c * n2 + 16.0 * n2
        want += 4.0 * R * (bw + bh + 2 + n2 + 5) + 2.0 * n2 * n2 + 20.0 * n2
    assert dp.kernel_bytes(key, batch) == want


@pytest.mark.parametrize("model", ["ycbcr", "mono"])
def test_last_key_and_args_match_reference(model):
    rng = np.random.default_rng(3)
    shape = (64, 128, 3) if model == "ycbcr" else (64, 128)
    src = rng.integers(0, 256, shape, dtype=np.uint8)
    kw = dict(depth=10, model=model, num_planes=3 if model == "ycbcr" else 1,
              tile_px=(64, 64), min_px=4, max_px=32, use_deltas=True,
              dc_q=118, ac_q=143, lam=301.75, ovh_block=23.0)
    dp.LAST_KEY = dp.LAST_ARGS = None
    dp.run_pass1(src, device="cpu", **kw)
    ref_dp.run_pass1(src, **kw)
    assert ref_dp.LAST_KEY[-1] in (True, False)  # the Pallas gate
    assert dp.LAST_KEY == ref_dp.LAST_KEY[:-1]
    assert dp.LAST_ARGS == ref_dp.LAST_ARGS


def _reference_bench_keys():
    """(top-level keys, {branch: measured keys}, detail keys) of the JSON
    line that the reference's bench.py prints, read from its source."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    measured = [
        [k.value for k in n.value.keys]
        for n in ast.walk(main)
        if isinstance(n, ast.Assign) and isinstance(n.value, ast.Dict)
        and any(getattr(t, "id", None) == "measured" for t in n.targets)
    ]
    line = next(n for n in ast.walk(main) if isinstance(n, ast.Call)
                and getattr(n.func, "attr", None) == "dumps")
    top = line.args[0]
    keys = [k.value for k in top.keys if k is not None]
    detail = next(v for k, v in zip(top.keys, top.values)
                  if k is not None and k.value == "detail")
    return keys, measured, [k.value for k in detail.keys]


def test_bench_prints_one_json_line_with_the_reference_keys():
    r = subprocess.run(
        [sys.executable, "-m", "cavif_tpu_torch.tools.bench", "--device",
         "cpu", "--size", "64", "--images", "3"],
        cwd=ROOT, env=dict(os.environ, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    assert len(lines) == 1, r.stdout
    out = json.loads(lines[0])
    keys, measured, detail = _reference_bench_keys()
    branch = next(m for m in measured if set(m) <= set(out))
    assert set(out) == set(keys) | set(branch)
    assert set(out["detail"]) == set(detail)
    assert out["metric"] == "encode_mps_q80_s4" and out["value"] > 0
    assert out["detail"]["batch_size"] == 3
    assert out["detail"]["device_pass1"] is True
    roof = out["detail"]["device_pass1_mfu"]
    assert "error" not in roof, roof
    # the encode's program: the 64x64 image padded to 256x256, speed 4
    # (tiers 4-32, angle deltas); the overheads do not enter the count
    assert roof["kernel_flops"] == dp.kernel_flops(
        (256, 256, 10, "ycbcr", 3, 4, 32, True, 0.0, 0.0, 0.0))
    assert roof["exec_s"] > 0 and roof["mfu_exec"] > 0
    assert "989 TFLOP/s dense bf16" in roof["peaks"]
    assert "3.35 TB/s" in roof["peaks"]
    assert roof["peaks"].startswith(bench.card_name())
    assert "v5e" not in r.stdout and "197" not in roof["peaks"]


def test_bench_image_is_the_reference_image():
    spec = importlib.util.spec_from_file_location("ref_bench",
                                                  ROOT / "bench.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    assert np.array_equal(bench.test_image(96, 160), ref._test_image(96, 160))
    assert (bench8k.HEIGHT, bench8k.WIDTH) == (4320, 7680)
    assert np.array_equal(bench8k.img8k(64, 96), ref._test_image(64, 96))


def test_bench8k_runs_on_the_cpu(capsys):
    assert bench8k.main(["--device", "cpu", "--size", "96x64", "--reps",
                         "2", "--trace"]) == 0
    out = capsys.readouterr().out
    for head in ("cold:", "rep 0:", "rep 1:", "median", "traced rep:"):
        assert head in out, out
    assert "device_pass1" in out


def test_batch512_images_are_the_reference_images():
    spec = importlib.util.spec_from_file_location(
        "ref_batch512", ROOT / "tools" / "batch512_bench.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    got, mp = batch512_bench.make_images(16)
    want, want_mp = ref.make_images(16)
    assert mp == want_mp
    assert len(got) == len(want)
    assert all(a.shape == b.shape and np.array_equal(a, b)
               for a, b in zip(got, want))
    assert [x.shape[2] for x in got].count(4) == 2  # images 3 and 11


def test_batch512_runs_both_paths_on_the_cpu(capsys):
    assert batch512_bench.main(["--device", "cpu", "--n", "8", "--scale",
                                "4", "--reps", "1"]) == 0
    out = capsys.readouterr().out
    assert "8 images" in out
    for path in ("hybrid", "sharded"):
        assert f"{path} rep0:" in out and f"{path}: warm" in out, out
        assert f"{path} stage totals" in out
