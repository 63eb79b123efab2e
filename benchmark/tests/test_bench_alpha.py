"""The plain reference on RGBA inputs, against the port's CPU encodes of the
mixed-thumbs generator at 64x96, and at 64x64 with every image RGBA: the
port's files are judged right, files that break the alpha rule are judged
wrong, whole runs through `encode_batch` and `encode_rgba` are correct,
and each planted fault an RGBA cell can have, and alpha coded at a lower
quality, makes them incorrect. RGB files are judged as before."""

import copy
import dataclasses
import hashlib
import struct

import numpy as np
import pytest
import run as R
from harness import faults, session
from reference import avif
from traffic import generate

from helpers import args, tiny

STATES = tiny("defaults1mp-single").config["states"]
LIMIT = tiny("defaults1mp-single").spec["limits"]["rmse_worst"]
THUMBS = {"generator": "mixed_thumbs", "shapes": [[64, 96]]}
# the test cells' alpha limit: their files read 0.87 at cavif's alpha
# quality 90 for Q80 and 1.93 at 80 (seed 11, 64x96)
ALPHA_LIMIT = 1.5


def _encoder(alpha_quality: float = 90):
    from cavif_tpu_torch import Encoder

    return dataclasses.replace(
        Encoder.new().with_quality(80).with_speed(4)
        .with_alpha_quality(alpha_quality), device="cpu")


@pytest.fixture(scope="module")
def rgba():
    """(an RGBA image of the generator with live alpha, its file)."""
    img = generate(THUMBS, 11, 4, "cpu")[3]
    assert img.shape == (64, 96, 4) and (img[..., 3] != 255).any()
    return img, _encoder().encode_rgba(img).avif_file


def _correct(got):
    return (not got["faults"] and got["decoded"] and got["rmse"] is not None
            and got["rmse"] <= LIMIT)


def test_the_ports_rgba_file_is_judged_right(rgba):
    img, f = rgba
    info = avif.parse(f)
    assert sorted(info["types"].values()) == ["av01", "av01"]
    assert [k for k, _, _ in info["refs"]] == ["auxl"]
    got = avif.judge(f, img, STATES)
    assert got["faults"] == [] and got["decoded"]
    assert 1.0 < got["rmse"] < LIMIT
    assert _correct(got)


def test_an_opaque_rgba_input_expects_no_alpha_item(rgba):
    img, f = rgba
    opaque = img.copy()
    opaque[..., 3] = 255
    fo = _encoder().encode_rgba(opaque).avif_file
    assert avif.parse(fo)["refs"] == []  # the port drops the alpha
    got = avif.judge(fo, opaque, STATES)
    assert got["faults"] == [] and _correct(got)
    # an alpha item where none belongs, and none where one belongs
    assert "alpha item" in avif.judge(f, opaque, STATES)["faults"]
    got = avif.judge(fo, img, STATES)
    assert got["faults"] == ["alpha item", "decoded mode RGB"]


def test_the_rgba_rmse_compares_premultiplied_colour(rgba):
    img, _ = rgba
    # colour under a fully transparent pixel does not count
    other = img.copy()
    clear = other[..., 3] == 0
    assert clear.any()
    other[clear, :3] = 255 - other[clear, :3]
    assert avif._rmse_rgba(other, img) == 0.0
    # alpha counts as it is, over all four samples
    other = img.copy()
    other[..., 3] = 255 - img[..., 3]
    d = (img[..., 3].astype(float) - other[..., 3]) ** 2
    c = ((img[..., :3].astype(float) * (other[..., 3:].astype(float)
                                        - img[..., 3:])) / 255.0) ** 2
    want = np.sqrt((d.sum() + c.sum()) / img.size)
    assert avif._rmse_rgba(other, img) == pytest.approx(want, rel=1e-12)


def _patched(buf: bytes, old: bytes, new: bytes, nth: int = 0) -> bytes:
    at = -1
    for _ in range(nth + 1):
        at = buf.index(old, at + 1)
    return buf[:at] + new + buf[at + len(old):]


def test_a_broken_alpha_item_is_judged_wrong(rgba):
    img, f = rgba
    urn = b"auxiliary:alpha"
    got = avif.judge(_patched(f, urn, b"auxiliary:alphX"), img, STATES)
    assert "alpha auxC" in got["faults"]
    # the alpha item's pixi (the second) at 8 bits under a 10-bit state
    pixi = f.index(b"pixi", f.index(b"pixi") + 1)
    assert f[pixi + 8] == 1 and f[pixi + 9] == 10
    bad = f[:pixi + 9] + bytes([8]) + f[pixi + 10:]
    assert "alpha pixi" in avif.judge(bad, img, STATES)["faults"]
    # the alpha item's av1C without its monochrome bit
    av1c = f.index(b"av1C", f.index(b"av1C") + 1)
    b2 = f[av1c + 6]
    assert b2 & 0x10
    bad = f[:av1c + 6] + bytes([b2 & ~0x10]) + f[av1c + 7:]
    assert "alpha av1C monochrome" in avif.judge(bad, img, STATES)["faults"]


def test_a_prem_reference_is_a_fault_under_unassociated_alpha(rgba):
    img, f = rgba
    info = avif.parse(f)
    h, w = img.shape[:2]
    assert avif._alpha_faults(info, len(f), STATES, h, w, True) == []
    info["refs"].append(("prem", info["primary"], [2]))
    assert avif._alpha_faults(info, len(f), STATES, h, w, True) == [
        "alpha prem"]


def test_premultiplied_alpha_is_refused_at_set_up():
    cell = tiny("defaults1mp-single")
    settings = {**cell.config["encoder"], "alpha_color_mode": "Premultiplied"}
    with pytest.raises(ValueError, match="Premultiplied"):
        session.Session(cell, 5, "cpu", settings=settings)


def test_rgb_judging_is_unchanged():
    """test_bench_reference.py's 64x64 file: its bytes and its judgement as
    the reference judged it before it judged alpha."""
    a = generate({"generator": "photo", "height": 64, "width": 64}, 11, 2,
                 "cpu")[0]
    f = _encoder().encode_rgb(a).avif_file
    assert hashlib.sha256(f).hexdigest() == (
        "4fd8aa745db10497d099ebe344af4ac3e29fec59eb02cd10ff6f5db5d4a57e16")
    assert avif.judge(f, a, STATES) == {"faults": [], "decoded": True,
                                        "rmse": 5.231109055747643}


def test_the_encode_rgba_entry_passes_each_image_as_it_is(rgba):
    img, f = rgba
    rgb = generate(THUMBS, 11, 1, "cpu")[0]
    assert rgb.shape[2] == 3
    (got, err), (none, why) = session.make_entry(
        "encode_rgba", _encoder())([img, rgb])
    assert err is None and got == f
    assert none is None and why  # encode_rgba takes 4 channels only


def test_the_alpha_reading_is_the_alpha_alone(rgba):
    img, f = rgba
    got = avif.judge(f, img, STATES)
    assert 0.0 < got["rmse_alpha"] < ALPHA_LIMIT
    # alpha off by 20 levels on every pixel reads 20, where the pooled
    # reading over four samples reads less
    other = img.copy()
    other[..., 3] = np.where(img[..., 3] < 128, img[..., 3] + 20,
                             img[..., 3] - 20)
    assert avif._rmse_alpha(other, img) == pytest.approx(20.0)
    assert avif._rmse_rgba(other, img) < 16.0


def _limits(cell):
    cell.spec["limits"] = {**cell.spec["limits"],
                           "alpha_rmse_worst": ALPHA_LIMIT}
    return cell


def thumbs_cell():
    """thumbs-batch as a later cell would run it, cut to 64x96: lists of 4
    through encode_batch, the 4th image RGBA."""
    cell = copy.deepcopy(tiny("defaults1mp-batch"))
    cell.config["image"] = dict(THUMBS)
    cell.config["encoder"]["alpha_quality"] = 90
    cell.spec.update(entry="encode_batch", list_length=4, pool=4, warmup=[1])
    return _limits(cell)


def rgba_cell():
    """rgba1mp-single cut to 64x64: one stream of encode_rgba over images
    that are each RGBA under the mixed-thumbs generator's alpha rule."""
    cell = copy.deepcopy(tiny("defaults1mp-single", pool=2))
    cell.config["image"] = {"generator": "mixed_thumbs",
                            "shapes": [[64, 64]], "alpha_every": 1}
    cell.config["encoder"]["alpha_quality"] = 90
    cell.spec.update(entry="encode_rgba")
    return _limits(cell)


def test_every_image_is_rgba_at_alpha_every_1():
    got = generate(rgba_cell().config["image"], 5, 3, "cpu")
    assert [im.shape for im in got] == [(64, 64, 4)] * 3
    assert all((im[..., 3] != 255).any() for im in got)
    # the cadence of 8 is the frozen copy's: images 3, 11, 19, ...
    got = generate(THUMBS, 5, 12, "cpu")
    assert [i for i, im in enumerate(got) if im.shape[2] == 4] == [3, 11]


def test_rgba_inputs_without_an_alpha_limit_are_refused_at_set_up():
    cell = rgba_cell()
    del cell.spec["limits"]["alpha_rmse_worst"]
    with pytest.raises(ValueError, match="alpha_rmse_worst"):
        session.Session(cell, 5, "cpu")


def test_an_rgb_cell_reports_no_alpha_number():
    cell = tiny("defaults1mp-single", pool=1)
    res, check = R.run(args(cell.name, seconds=0.5), cell, device="cpu")
    assert res["correct"]
    assert sorted(check) == ["decode_failed", "property_faults",
                             "rmse_worst", "unanswered"]


CELLS = {"thumbs": thumbs_cell, "rgba": rgba_cell}


@pytest.mark.parametrize("name", list(CELLS))
def test_a_sound_rgba_run_is_correct(name):
    cell = CELLS[name]()
    res, check = R.run(args(cell.name, seconds=1.0), cell, device="cpu")
    assert res["correct"], (res, check)
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert 0.0 < check["alpha_rmse_worst"]["value"] < ALPHA_LIMIT


@pytest.mark.parametrize("name,control", [
    ("thumbs", "alpha_q80"), ("thumbs", "alpha_q60"), ("rgba", "alpha_q80")])
def test_alpha_at_a_lower_quality_makes_an_rgba_run_incorrect(name, control):
    cell = CELLS[name]()
    settings = {**cell.config["encoder"], **faults.CONTROLS[control]}
    res, check = R.run(args(cell.name, seconds=1.0), cell, device="cpu",
                       settings=settings)
    assert not res["correct"], (control, check)
    assert check["alpha_rmse_worst"]["value"] > ALPHA_LIMIT
    assert check["rmse_worst"]["value"] <= LIMIT  # the pooled one passes


@pytest.mark.parametrize("name,fault", [
    ("thumbs", "alpha_drop"), ("thumbs", "alpha_invert"), ("thumbs", "stale"),
    ("thumbs", "flip"), ("rgba", "alpha_drop"), ("rgba", "alpha_invert")])
def test_a_planted_fault_makes_an_rgba_run_incorrect(name, fault):
    cell = CELLS[name]()
    res, check = R.run(args(cell.name, seconds=1.0), cell, device="cpu",
                       wrap=faults.FAULTS[fault])
    assert not res["correct"], (fault, check)
    if fault.startswith("alpha"):  # answered, and judged wrong
        assert check["unanswered"]["value"] == 0
        assert check["alpha_rmse_worst"]["value"] > ALPHA_LIMIT


def test_the_alpha_faults_change_only_rgba_images():
    rgb = np.zeros((4, 6, 3), np.uint8)
    rgba = np.dstack([rgb, np.full((4, 6), 7, np.uint8)])
    seen = []
    for fault in ("alpha_drop", "alpha_invert"):
        faults.FAULTS[fault](lambda imgs: seen.append(imgs) or [])([rgb, rgba])
    (a, b), (c, d) = seen
    assert a is rgb and c is rgb
    assert b.shape == (4, 6, 4) and (b[..., 3] == 255).all()
    assert (b[..., :3] == rgb).all()
    assert d.shape == (4, 6, 4) and (d[..., 3] == 248).all()


def test_parse_keeps_every_items_properties(rgba):
    _, f = rgba
    info = avif.parse(f)
    assert "ispe" in info["item_props"][info["primary"]]
    alpha = [p for p in info["item_props"] if p != info["primary"]]
    assert len(alpha) == 1
    ispe = info["item_props"][alpha[0]]["ispe"][0]
    assert struct.unpack_from(">II", ispe, 4) == (96, 64)
