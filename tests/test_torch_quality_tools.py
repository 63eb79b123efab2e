"""The port's quality tools (cavif_tpu_torch/tools/ab_quality.py, bdrate.py,
ssim_probe.py, trellis_sweep.py) against the repository's tools/ on the CPU.

The corpus and the metric code are the reference's numpy: they must be
EXACTLY equal (no tolerance) on the same inputs, including BD's
degenerate sweeps, where the reference returns None. A three-point sweep
(Q40, 68, 95) of 128x128 crops of the two BD-gap images runs through the
port with its pass 1 on the CPU and through the JAX package's Encoder
with its XLA pass 1 on the CPU (device "xla"); per point the AVIF bytes
are equal wherever the pass-1 grids are, and otherwise the grids differ
beyond near-ties on fewer than 1e-3 of their entries (the rule of
tests/test_torch_configs.py) and the point lies inside the host envelope
of the reference's encode (bytes at most 1.05x, PSNR at least the
reference's minus 0.1 dB); the (bytes, PSNR, SSIM) triple of the
port's _metrics equals the reference's on the same file. The host-cascade
CLIs print what the reference CLIs print, and the parents of the two
child-process tools print the reference parents' lines on the same child
results."""

import contextlib
import io
import json
import os
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from cavif_tpu import Encoder as RefEncoder
from cavif_tpu.ops import device_pass1 as ref_dp
from cavif_tpu_torch.ops import device_pass1 as dp
from cavif_tpu_torch.tools import ab_quality as ab
from cavif_tpu_torch.tools import bdrate as bd
from cavif_tpu_torch.tools import ssim_probe as sp
from cavif_tpu_torch.tools import trellis_sweep as ts
from test_torch_configs import _beyond_ties

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
import ab_quality as ref_ab  # noqa: E402
import bdrate as ref_bd  # noqa: E402
import ssim_probe as ref_sp  # noqa: E402
import trellis_sweep as ref_ts  # noqa: E402

CROP = 128
SWEEP_Q = (40, 68, 95)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Torch on one thread: the suite runs several test files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus():
    return ab.images()


def _crops(corpus, size):
    return [(n, np.ascontiguousarray(x[:size, :size])) for n, x in corpus]


def test_images_equal_reference(corpus):
    ref = ref_ab.images()
    assert [n for n, _ in corpus] == [n for n, _ in ref] == [
        "photo", "edges", "gradient", "texture", "bench1024"]
    for (name, x), (_, y) in zip(corpus, ref):
        assert x.dtype == y.dtype == np.uint8, name
        assert np.array_equal(x, y), name
    assert corpus[-1][1].shape == (1024, 1024, 3)


def test_gray_and_ssim_equal_reference():
    rng = np.random.default_rng(7)
    a = rng.integers(0, 256, (40, 56, 3)).astype(np.float64)
    b = np.clip(a + rng.normal(0, 9, a.shape), 0, 255)
    assert np.array_equal(ab.gray(a), ref_ab.gray(a))
    assert ab.ssim(ab.gray(a), ab.gray(b)) == ref_ab.ssim(ref_ab.gray(a),
                                                          ref_ab.gray(b))
    assert ab.ssim(ab.gray(a), ab.gray(a)) == pytest.approx(1.0, abs=1e-12)


def _sweep(rng, n, r0, slope):
    r = np.sort(rng.uniform(r0, 8 * r0, n)).round()
    return r, 30 + slope * np.log10(r) + rng.normal(0, 0.05, n)


BD_CASES = {
    "regular": lambda rng: (*_sweep(rng, 14, 800, 9), *_sweep(rng, 14, 700, 8)),
    # a sweep that plateaus in bytes (the edges image): _mono keeps 2 points
    "plateau": lambda rng: (np.geomspace(800, 6400, 14).round(),
                            np.linspace(30, 40, 14),
                            np.array([900.0] * 7 + [950.0] * 7),
                            np.linspace(30, 40, 14)),
    # rates that barely overlap: the log-rate overlap is below 0.1
    "thin_rate_overlap": lambda rng: (np.array([100.0, 110, 120, 130]),
                                      np.array([30.0, 31, 32, 33]),
                                      np.array([125.0, 140, 160, 180]),
                                      np.array([32.5, 33, 34, 35])),
    # qualities that barely overlap: below 0.5 dB
    "thin_quality_overlap": lambda rng: (np.array([100.0, 200, 300, 400]),
                                         np.array([30.0, 31, 32, 33]),
                                         np.array([100.0, 200, 300, 400]),
                                         np.array([32.8, 34, 35, 36])),
    "short": lambda rng: (np.array([100.0, 200]), np.array([30.0, 31]),
                          np.array([100.0, 200, 300]),
                          np.array([30.0, 31, 32])),
}


@pytest.mark.parametrize("case", list(BD_CASES))
def test_bd_functions_equal_reference(case):
    r1, q1, r2, q2 = BD_CASES[case](np.random.default_rng(3))
    for port_fn, ref_fn in ((bd._bd_quality, ref_bd._bd_quality),
                            (bd._bd_rate, ref_bd._bd_rate)):
        got, want = port_fn(r1, q1, r2, q2), ref_fn(r1, q1, r2, q2)
        assert got == want, (port_fn.__name__, got, want)
    for r, q in ((r1, q1), (r2, q2)):
        for x, y in zip(bd._mono(r, q), ref_bd._mono(r, q)):
            assert np.array_equal(x, y)
    if case == "regular":
        assert bd._bd_quality(r1, q1, r2, q2) is not None
        assert bd._bd_rate(r1, q1, r2, q2) is not None
    else:
        assert bd._bd_quality(r1, q1, r2, q2) is None or case.startswith(
            "thin_quality")


def test_bd_skips_rate_with_a_degenerate_quality():
    """bd() keeps the reference main's rule: no BD-rate where BD-PSNR is
    None (an edges-style plateau), never a 0 in its place."""
    r1, q1, r2, q2 = BD_CASES["plateau"](np.random.default_rng(3))
    pts = lambda r, q: [(b, p, p / 40) for b, p in zip(r, q)]  # noqa: E731
    bdp, bds, bdr = bd.bd(pts(r1, q1), pts(r2, q2))
    assert bdp is None and bds is None and bdr is None
    assert ref_bd._bd_rate(r1, q1, r2, q2) is not None  # skipped, not absent


def test_metrics_equal_reference(corpus):
    img = _crops(corpus, 64)[0][1]
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="AVIF", quality=60, speed=8)
    assert ab._metrics(img, buf.getvalue()) == ref_bd._metrics(
        img, buf.getvalue())
    assert bd._metrics is ab._metrics


def _recording(monkeypatch, module, calls):
    real = module.run_pass1

    def run(src, **kw):
        out = real(src, **kw)
        calls.append((src, kw, out))
        return out

    monkeypatch.setattr(module, "run_pass1", run)


@pytest.mark.parametrize("name", ["photo", "bench1024"])
def test_crop_sweep_matches_reference(name, corpus, monkeypatch, capsys):
    crop = dict(_crops(corpus, CROP))[name]
    calls_p, calls_r = [], []
    _recording(monkeypatch, dp, calls_p)
    _recording(monkeypatch, ref_dp, calls_r)
    pts = bd.sweep([(name, crop)], "cpu", qualities=SWEEP_Q)[name]
    assert len(calls_p) == len(SWEEP_Q)
    sweep_calls = list(calls_p)
    for i, q in enumerate(SWEEP_Q):
        calls_p.clear()
        calls_r.clear()
        data_p = ab.encoder(q, 4, "cpu").encode_rgb(crop).avif_file
        data_r = replace(RefEncoder.new().with_quality(q).with_speed(4)
                         .with_tune("psnr"), device="xla").encode_rgb(
                             crop).avif_file
        assert len(calls_p) == len(calls_r) == 1, (q, len(calls_r))
        (src, kw, grids_p), (_, _, grids_r) = calls_p[0], calls_r[0]
        assert sorted(grids_p) == sorted(grids_r)
        for k in grids_p:  # the sweep's pass 1 is this encode's
            assert np.array_equal(sweep_calls[i][2][k], grids_p[k])
        n = sum(g.size for g in grids_r.values())
        diff = sum(int((grids_p[k] != grids_r[k]).sum()) for k in grids_r)
        for data in (data_p, data_r):
            assert ab._metrics(crop, data) == ref_bd._metrics(crop, data)
        (psnr_p, _), (psnr_r, _) = (ab._metrics(crop, d)
                                    for d in (data_p, data_r))
        if diff:
            beyond = _beyond_ties((src, kw), grids_p, grids_r)
            with capsys.disabled():
                print(f"\n{name} Q{q}: grids differ on {diff} of {n} "
                      f"entries, {beyond} beyond near-ties; {len(data_p)} B "
                      f"{psnr_p:.4f} dB against {len(data_r)} B "
                      f"{psnr_r:.4f} dB")
            assert beyond < 1e-3 * n, (q, diff, beyond, n)
            # the sweep point itself, held to the reference's encode of the
            # same crop by the host envelope: bytes at most 1.05x, PSNR at
            # least the reference's minus 0.1 dB
            assert len(data_p) <= 1.05 * len(data_r), (q, len(data_p),
                                                        len(data_r))
            assert psnr_p >= psnr_r - 0.1, (q, psnr_p, psnr_r)
        else:
            assert data_p == data_r, q
        assert pts[i] == (len(data_p),) + ab._metrics(crop, data_p)


def _stdout(fn, *args) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return buf.getvalue()


def test_bdrate_cli_matches_reference_on_the_host_cascade(corpus,
                                                           monkeypatch):
    """Both CLIs on 64x64 crops, this encoder on the host cascade (the
    reference's default on the CPU), print the same BD lines."""
    crops = _crops(corpus, 64)
    monkeypatch.setattr(bd, "images", lambda: crops)
    monkeypatch.setattr(ref_bd, "images", lambda: crops)
    monkeypatch.setattr(sys, "argv", ["bdrate.py"])
    want = _stdout(ref_bd.main)
    got = _stdout(bd.main, ["--device", "off"])
    assert got == want
    assert got.count("BD-PSNR") == 6  # five images and the mean


def test_ab_quality_cli_matches_reference_on_the_host_cascade(corpus,
                                                               monkeypatch):
    crops = _crops(corpus, 64)
    monkeypatch.setattr(ab, "images", lambda: crops)
    monkeypatch.setattr(ref_ab, "images", lambda: crops)
    monkeypatch.setattr(sys, "argv", ["ab_quality.py", "--json", "--aom"])
    want = json.loads(_stdout(ref_ab.main))
    got = json.loads(_stdout(ab.main, ["--json", "--aom", "--device", "off"]))
    for r in want["rows"] + got["rows"]:
        r.pop("sec", None)  # wall seconds
    assert got == want
    assert len(got["rows"]) == 2 * 5 + 2 * 5 * 3


def _child_points(corpus, qualities, names=None):
    """Real sweep points of 64x64 crops (the port's host cascade), as a child
    would print them."""
    crops = [(n, x) for n, x in _crops(corpus, 64)
             if names is None or n in names]
    return json.loads(json.dumps(bd.sweep(crops, "off", qualities)))


def test_ssim_probe_parent_matches_reference(corpus, monkeypatch):
    base = _child_points(corpus, sp.QUALITIES, sp.PROBE_IMAGES)
    fake = {}
    for k, (name, _) in enumerate(sp.CONFIGS):
        fake[name] = {img: [[b + 7 * k, p + 0.01 * k, s - 1e-4 * k]
                            for b, p, s in pts] for img, pts in base.items()}
    seen = []

    def run_config(env, device="reference"):
        seen.append((env, device))
        name = [n for n, e in sp.CONFIGS if e == env][0]
        return fake[name]

    monkeypatch.setattr(sp, "run_config", run_config)
    monkeypatch.setattr(ref_sp, "run_config", run_config)
    want = _stdout(ref_sp.main)
    got = _stdout(sp.main, [])
    assert got == want and got.count("---") == 2 * len(base)
    # the port's children run pass 1 on the card unless asked otherwise
    assert seen == [(e, "reference") for _, e in sp.CONFIGS] + \
        [(e, "cuda") for _, e in sp.CONFIGS]
    seen.clear()
    assert _stdout(sp.main, ["--device", "off"]) == want
    assert seen == [(e, "off") for _, e in sp.CONFIGS]
    assert sp.CONFIGS == ref_sp.CONFIGS and sp.QUALITIES == ref_sp.QUALITIES


def test_trellis_parent_matches_reference(corpus, monkeypatch):
    crops = _crops(corpus, 64)
    points = _child_points(corpus, ts.OUR_QUALITIES)
    envs = []

    def fake_run(cmd, **kw):
        envs.append(kw["env"])
        return subprocess.CompletedProcess(cmd, 0, json.dumps(points) + "\n",
                                           "")

    monkeypatch.setattr(ab, "images", lambda: crops)
    monkeypatch.setattr(ref_ab, "images", lambda: crops)
    monkeypatch.setattr(ref_ts.subprocess, "run", fake_run)
    monkeypatch.setattr(sys, "argv", ["trellis_sweep.py", "0.6",
                                      "CAVIF_TPU_EOB_BITS=0.8"])
    want = _stdout(ref_ts.main)
    ref_envs = envs[:]
    envs.clear()
    monkeypatch.setattr(ts, "run_child", lambda env: (envs.append(env),
                                                       points)[1])
    got = _stdout(ts.main, ["0.6", "CAVIF_TPU_EOB_BITS=0.8"])
    assert got == want and got.count("MEAN") == 2
    knobs = ("CAVIF_TPU_TUNE", "CAVIF_TPU_TRELLIS_CTX", "CAVIF_TPU_EOB_BITS")
    assert [{k: e.get(k) for k in knobs} for e in envs] == \
        [{k: e.get(k) for k in knobs} for e in ref_envs]


@pytest.mark.parametrize("tool", ["ssim_probe", "trellis_sweep"])
def test_children_run_the_port_module(tool, monkeypatch):
    """The children are `python -m cavif_tpu_torch.tools.<tool> --child`
    with the repository on their path (no code held in strings) and the
    config's knobs; the probe's children run pass 1 on the device the
    caller gives (the card by default), and the caller's placement knob
    reaches them unchanged."""
    seen = []

    def fake_run(cmd, **kw):
        seen.append((cmd, kw["env"]))
        return subprocess.CompletedProcess(cmd, 0, '{"photo": []}\n', "")

    monkeypatch.setattr(subprocess, "run", fake_run)
    monkeypatch.delenv("CAVIF_TPU_DEVICE_SEARCH", raising=False)
    env = {"CAVIF_TPU_TRELLIS_CTX": "0"}
    if tool == "ssim_probe":
        assert sp.run_config(env) == {"photo": []}
        assert sp.run_config(env, "off") == {"photo": []}
    else:
        assert ts.run_child({**os.environ, **env}) == {"photo": []}
    cmd, child_env = seen[0]
    tail = ["--device", "cuda"] if tool == "ssim_probe" else []
    assert cmd[1:] == ["-m", f"cavif_tpu_torch.tools.{tool}", "--child",
                       *tail]
    assert child_env["PYTHONPATH"].split(os.pathsep)[0] == str(ROOT)
    assert child_env["CAVIF_TPU_TRELLIS_CTX"] == "0"
    assert "CAVIF_TPU_DEVICE_SEARCH" not in child_env
    if tool == "ssim_probe":
        assert seen[1][0][-2:] == ["--device", "off"]
