"""The cavif-mixed-thumbs deployment
(benchmark/configs/cavif-mixed-thumbs.json, the benchmark's cell
thumbs-batch) at an eighth of its image sizes on the CPU: a list of mixed
thumbnails, every 8th RGBA with a live alpha mask, through
`parallel.encode_batch` under the configuration's encoder settings. Every
file is judged by the benchmark's plain reference
(benchmark/reference/avif.py) under the properties the configuration
states, each equals the single-image encode of its input, and the alpha
stream runs once per image with live alpha."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

from cavif_tpu_torch.parallel import encode_batch
from cavif_tpu_torch.utils import trace

BENCH = Path(__file__).resolve().parent.parent / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.append(str(BENCH))

from harness.session import make_encoder  # noqa: E402
from reference import avif  # noqa: E402
from traffic import generate  # noqa: E402

CONFIG = json.loads((BENCH / "configs" / "cavif-mixed-thumbs.json")
                    .read_text())
LIMITS = json.loads((BENCH / "workloads" / "thumbs-batch.json")
                    .read_text())["limits"]
# the generator's four published sizes, each divided by 8
SHAPES = [[48, 64], [64, 64], [32, 48], [64, 96]]
SEED = 2_718_281_829


def _encoder():
    return make_encoder(CONFIG["encoder"], "cpu")


def _images(count):
    spec = {**CONFIG["image"], "shapes": SHAPES, "alpha_every": 8}
    return generate(spec, SEED, count, "cpu")


def _traced_batch(images):
    """encode_batch's files and the port's span totals over the call. The
    list runs on threads, as encode_batch runs it on the card: the CPU
    default forks workers, whose spans stay in the workers."""
    trace.set_enabled(True)
    trace.set_accumulate(True)
    try:
        out = encode_batch(images, _encoder(), max_workers=4,
                           processes=False)
        spans = dict(trace.ACCUM)
    finally:
        trace.set_accumulate(False)
        trace.set_enabled(False)
    assert all(r.error is None for r in out), [r.error for r in out]
    return [r.encoded.avif_file for r in out], spans


@pytest.fixture(scope="module")
def batch():
    images = _images(16)
    files, spans = _traced_batch(images)
    return images, files, spans


def test_the_list_holds_every_size_and_alpha_on_images_3_and_11(batch):
    images, _, _ = batch
    assert [im.shape[:2] for im in images[:4]] == [tuple(s) for s in SHAPES]
    assert [i for i, im in enumerate(images) if im.shape[2] == 4] == [3, 11]
    assert all((images[i][..., 3] != 255).any() for i in (3, 11))


def test_every_file_is_judged_right(batch):
    images, files, _ = batch
    for i, (img, f) in enumerate(zip(images, files)):
        got = avif.judge(f, img, CONFIG["states"])
        assert got["faults"] == [] and got["decoded"], (i, got)
        assert got["rmse"] < LIMITS["rmse_worst"], (i, got)
        has_alpha = [k for k, _, _ in avif.parse(f)["refs"]] == ["auxl"]
        assert has_alpha == (i in (3, 11)), i
        if img.shape[2] == 4:
            alpha = got["rmse_alpha"]
            assert 0 < alpha < LIMITS["alpha_rmse_worst"], (i, got)


def test_each_file_equals_the_single_image_encode(batch):
    """The batch gives each encode one tile thread; the tile split and the
    coded bytes do not depend on the thread count, so the default
    encoder's single-image files are the batch's, byte for byte."""
    images, files, _ = batch
    enc = _encoder()
    for i, (img, f) in enumerate(zip(images, files)):
        one = (enc.encode_rgba if img.shape[2] == 4 else enc.encode_rgb)(img)
        assert one.avif_file == f, i


def test_the_alpha_stream_runs_once_per_live_alpha_image(batch):
    images, _, spans = batch
    assert spans["n_alpha.prep"] == 2
    assert spans["n_alpha.stream"] == 2
    assert spans["n_dirty_alpha"] == 2
    # a colour frame per image and a mono frame per alpha stream, all
    # through the device pass 1 (here on the CPU)
    assert spans["device_pass1.mono"] == 2
    assert spans["n_device_pass1"] == len(images) + 2


def test_an_opaque_rgba_input_gives_no_alpha_stream():
    images = _images(4)
    rgb, live = images[0], images[3]
    opaque = np.dstack([rgb, np.full(rgb.shape[:2], 255, np.uint8)])
    listed = [rgb, opaque, live]
    files, spans = _traced_batch(listed)
    assert spans["n_alpha.prep"] == 2
    assert spans["n_alpha.stream"] == 1
    assert spans["device_pass1.mono"] == 1
    info = avif.parse(files[1])
    assert info["refs"] == [] and list(info["types"].values()) == ["av01"]
    assert files[1] == files[0]  # ravif codes an opaque image as its colour
    for img, f in zip(listed, files):
        got = avif.judge(f, img, CONFIG["states"])
        assert got["faults"] == [] and got["rmse"] < LIMITS["rmse_worst"]
