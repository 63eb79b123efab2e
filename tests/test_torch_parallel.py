"""Batch encoding of the PyTorch/CUDA port (cavif_tpu_torch.parallel and
ops/device_pass1.run_pass1_batch) on the CPU, held against the JAX
reference (cavif_tpu.parallel, cavif_tpu.ops.device_pass1).

The port runs with device="cpu" (its kernels take their plain PyTorch
versions); the reference runs its XLA formulation on the CPU.

Tolerances. The batched pass 1 is a decision module: fewer than 1e-3 of its
packed entries may differ from the reference's (the reference's own
Pallas-vs-XLA bound; 0 measured), and it must equal the port's per-image
run_pass1 the same way (the batch only stacks the planes, so 0 is
expected). Encodes must decode in Pillow, and where the port's grids equal
the reference's the two write the same bytes, since everything after pass 1
is a verbatim copy."""

import io
import subprocess
import sys
import threading
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import cavif_tpu
import cavif_tpu_torch
from cavif_tpu.ops import device_pass1 as ref_dp
from cavif_tpu.parallel.batch import encode_batch_sharded as ref_sharded
from cavif_tpu_torch import pipeline
from cavif_tpu_torch.av1 import encoder as enc_mod
from cavif_tpu_torch.container.parse import read_avif
from cavif_tpu_torch.ops import block_search as bs
from cavif_tpu_torch.ops import device_pass1 as dp
from cavif_tpu_torch.parallel import encode_batch, plane_mode_search_batch
from cavif_tpu_torch.parallel import batch as pbatch

DC_Q, AC_Q, LAM = 499, 616, 296.45


def _image(h, w, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    lum = np.clip(120 + 70 * np.sin(x / 23.0) * np.cos(y / 17.0)
                  + rng.normal(0, 6, x.shape), 0, 255)
    return np.dstack([lum, np.clip(lum + 15, 0, 255),
                      np.clip(lum - 20, 0, 255)]).astype(np.uint8)


def test_encode_batch_order_and_isolation():
    rng = np.random.default_rng(0)
    good = (rng.integers(0, 256, (40, 48, 3)) // 4 + 90).astype(np.uint8)
    bad = np.zeros((0, 0, 3), dtype=np.uint8)  # TooFewPixels
    enc = replace(cavif_tpu_torch.Encoder.new().with_speed(10),
                  device="cpu")
    res = encode_batch([good, bad, good], enc)
    assert [r.index for r in res] == [0, 1, 2]
    assert res[0].encoded is not None and res[0].error is None
    assert res[1].error is not None and res[1].encoded is None
    assert res[2].encoded is not None
    assert res[0].encoded.avif_file[4:12] == b"ftypavif"


class _FakeProgram:
    """Stands in for a Pass1Program: one 1x1 grid per frame."""

    spec = [((8, 8), "y_md", (1, 1))]

    def __call__(self, x, *args):
        return torch.zeros((x.shape[0], 1), dtype=torch.int8)


def test_pass1_hooks_scoped_per_context(monkeypatch):
    """The hybrid scheduler's device-slot hooks are per-call contextvar
    state: two threads (standing in for two concurrent encode_batch
    calls) each install their own hooks and must see exactly their own
    start/done pair — never the other call's — on success and on
    failure."""
    monkeypatch.setattr(dp, "_program", lambda *a: _FakeProgram())

    class Rec:
        def __init__(self):
            self.ev = []

        def start(self):
            self.ev.append("start")

        def done(self):
            self.ev.append("done")

    def run_with(rec, src):
        tok = dp.PASS1_HOOKS.set(rec)
        try:
            dp.run_pass1(
                src, depth=8, model="mono", num_planes=1, tile_px=(64, 64),
                min_px=8, use_deltas=False, dc_q=8, ac_q=8, lam=1.0,
                device="cpu",
            )
        except TypeError:
            rec.ev.append("raised")
        finally:
            dp.PASS1_HOOKS.reset(tok)

    a, b, c = Rec(), Rec(), Rec()
    good = np.zeros((64, 64), np.uint8)
    bad = np.zeros((64, 64), object)  # torch cannot take it: a failure
    ts = [threading.Thread(target=run_with, args=(r, s))
          for r, s in ((a, good), (b, good), (c, bad))]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert a.ev == ["start", "done"]
    assert b.ev == ["start", "done"]
    assert c.ev == ["start", "done", "raised"]
    # and the installing thread's own context is clean again
    assert dp.PASS1_HOOKS.get() is None


def test_stream_threads_inherit_pass1_hooks(monkeypatch):
    """pipeline._encode_streams runs colour and alpha on an inner executor;
    both stream threads must inherit the caller's PASS1_HOOKS so an RGBA
    encode's two device round trips stay under the hybrid scheduler's
    slot bound."""
    seen = []

    def fake_encode_planes(planes, cfg, src8=None):
        seen.append(dp.PASS1_HOOKS.get())
        return b"x"

    monkeypatch.setattr(enc_mod, "encode_planes", fake_encode_planes)
    hooks = object()
    tok = dp.PASS1_HOOKS.set(hooks)
    try:
        pipeline._encode_streams(
            cavif_tpu_torch.Encoder.new(), np.zeros((32, 32, 3), np.int32),
            np.zeros((32, 32), np.int32), 8,
        )
    finally:
        dp.PASS1_HOOKS.reset(tok)
    assert seen == [hooks, hooks]


@pytest.mark.parametrize("model", ["ycbcr", "mono"])
def test_run_pass1_batch_matches_reference_and_single(model):
    imgs = np.stack([_image(128, 128, 1), _image(128, 128, 2)])
    srcs = imgs if model == "ycbcr" else np.ascontiguousarray(imgs[..., 0])
    P = 3 if model == "ycbcr" else 1
    kw = dict(depth=10, tile_px=(128, 64), min_px=8 if P == 3 else 4,
              max_px=32, use_deltas=False, dc_q=DC_Q, ac_q=AC_Q, lam=LAM)
    ref = ref_dp.run_pass1_batch(srcs, model=model, **kw)
    got = dp.run_pass1_batch(srcs, model=model, device="cpu", **kw)
    assert len(got) == len(ref) == 2
    for b in range(2):
        single = dp.run_pass1(srcs[b], model=model, num_planes=P,
                              ovh_block=23.0, device="cpu", **kw)
        assert list(got[b]) == list(ref[b]) == list(single)
        tot = sum(v.size for v in ref[b].values())
        d_ref = sum(int((got[b][k] != v).sum()) for k, v in ref[b].items())
        d_one = sum(int((got[b][k] != v).sum()) for k, v in single.items())
        for k, v in ref[b].items():
            assert got[b][k].dtype == v.dtype and got[b][k].shape == v.shape
        print(f"\n{model} image {b}: differ from the reference on {d_ref}, "
              f"from per-image run_pass1 on {d_one}, of {tot}")
        assert d_ref < 1e-3 * tot and d_one < 1e-3 * tot


def test_run_pass1_batch_sub_batches(monkeypatch):
    """The pixel budget splits a batch into sub-batches; the list that
    comes back has one grid dict per input, in order."""
    monkeypatch.setenv("CAVIF_TPU_BATCH_PX", str(2 * 64 * 64))
    imgs = np.stack([_image(64, 64, s) for s in range(3)])
    kw = dict(depth=8, tile_px=(64, 64), min_px=8, use_deltas=False,
              dc_q=20, ac_q=25, lam=210.0, model="mono")
    srcs = np.ascontiguousarray(imgs[..., 1])
    got = dp.run_pass1_batch(srcs, device="cpu", **kw)
    assert len(got) == 3
    for b in range(3):
        one = dp.run_pass1(srcs[b], num_planes=1, ovh_block=23.0,
                           device="cpu", **kw)
        assert all(np.array_equal(got[b][k], v) for k, v in one.items())
    with pytest.raises(TypeError):
        dp.run_pass1_batch(srcs, device="cpu", mesh=object(), **kw)


def _sharded_inputs():
    """Mixed shapes and one RGBA image (tests/test_sharded_device.py)."""
    rng = np.random.default_rng(3)
    imgs = [_image(128, 192, 1), _image(96, 128, 2)]
    rgba = np.dstack([_image(128, 192, 3), np.full((128, 192), 255,
                                                    np.uint8)])
    rgba[30:90, 40:150, 3] = rng.integers(0, 255, (60, 110), np.uint8)
    imgs.append(rgba)
    return imgs


@pytest.fixture(scope="module")
def sharded_out():
    enc = replace(cavif_tpu_torch.Encoder.new().with_quality(70)
                  .with_speed(8), device="cpu")
    mp = pytest.MonkeyPatch()
    mp.setenv("CAVIF_TPU_SHARDED_STEAL", "0")
    try:
        return pbatch.encode_batch_sharded(_sharded_inputs(), enc)
    finally:
        mp.undo()


def test_encode_batch_sharded_mixed_alpha(sharded_out):
    imgs = _sharded_inputs()
    assert len(sharded_out) == 3
    for data, img in zip(sharded_out, imgs):
        assert data[4:12] == b"ftypavif", data[:16]
        dec = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        assert dec.shape[:2] == img.shape[:2]
    assert read_avif(sharded_out[2]).alpha_item, "alpha stream missing"
    assert read_avif(sharded_out[1]).width == 128


def test_encode_batch_sharded_bytes_match_reference(sharded_out,
                                                    monkeypatch):
    """Same decisions as the reference's XLA pass 1 on these images, so
    the same bytes."""
    monkeypatch.setenv("CAVIF_TPU_SHARDED_STEAL", "0")
    ref = ref_sharded(_sharded_inputs(), cavif_tpu.Encoder.new()
                      .with_quality(70).with_speed(8))
    assert [len(r) for r in ref] == [len(g) for g in sharded_out]
    assert all(r == g for r, g in zip(ref, sharded_out))


def test_encode_batch_sharded_refuses_mesh_and_missing_card():
    imgs = _sharded_inputs()[:1]
    with pytest.raises(TypeError):
        pbatch.encode_batch_sharded(imgs, replace(
            cavif_tpu_torch.Encoder.new(), device="cpu"), mesh=object())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            pbatch.encode_batch_sharded(imgs, cavif_tpu_torch.Encoder.new())


def test_plane_mode_search_batch_equals_per_image():
    rng = np.random.default_rng(1)
    planes = rng.integers(0, 1024, (3, 64, 96)).astype(np.int32)
    out = plane_mode_search_batch(planes, DC_Q, AC_Q, 30.0, 10,
                                  device="cpu")
    assert out.shape == (3, 2, 3) and out.dtype == np.int8
    for i in range(3):
        one = bs.plane_mode_search(planes[i : i + 1], DC_Q, AC_Q, 30.0, 10,
                                   n=32, device="cpu")
        assert np.array_equal(out[i : i + 1], one)
    with pytest.raises(TypeError):
        plane_mode_search_batch(planes, DC_Q, AC_Q, 30.0, 10, mesh=object(),
                                device="cpu")


def test_device_engaged_reads_only_the_environment(monkeypatch):
    monkeypatch.delenv("CAVIF_TPU_DEVICE_SEARCH", raising=False)
    assert pbatch._device_engaged() is True
    monkeypatch.setenv("CAVIF_TPU_DEVICE_SEARCH", "off")
    assert pbatch._device_engaged() is False


@pytest.mark.parametrize("device", ["cuda", None])
def test_encode_batch_processes_refuse_the_card(monkeypatch, device):
    """Forked workers cannot use CUDA: an encoder that names the card
    (None is the card by default) is refused rather than quietly moved to
    the host."""
    monkeypatch.delenv("CAVIF_TPU_DEVICE_SEARCH", raising=False)
    img = _image(32, 32, 0)
    enc = replace(cavif_tpu_torch.Encoder.new(), device=device)
    with pytest.raises(ValueError, match="CUDA"):
        encode_batch([img, img, img], enc, processes=True)


def test_encode_batch_processes_after_a_parallel_torch_op():
    """A forked pool started after the parent ran a parallel torch op
    still encodes: the parent's OpenMP thread team does not survive fork,
    so each child runs torch on one thread. Run in its own process, so
    that a hang fails by timeout instead of stalling the suite."""
    root = Path(__file__).resolve().parent.parent
    code = f"""
import sys
sys.path.insert(0, {str(root)!r})
from dataclasses import replace
import numpy as np
import torch
import cavif_tpu_torch
from cavif_tpu_torch.parallel import encode_batch
torch.set_num_threads(4)
x = torch.ones(1 << 22)
for _ in range(5):
    (x * 2.0).sum()
rng = np.random.default_rng(0)
img = (rng.integers(0, 256, (40, 48, 3)) // 4 + 90).astype(np.uint8)
enc = replace(cavif_tpu_torch.Encoder.new().with_speed(10), device="cpu")
res = encode_batch([img, img, img], enc, processes=True)
assert all(r.encoded is not None for r in res), [r.error for r in res]
print("ok")
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]
