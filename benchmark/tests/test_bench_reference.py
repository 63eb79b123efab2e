"""The plain reference against the port's encode of a 64x64 image on the
CPU: the file is judged right, and a copy with its payload altered and the
file of another seed's image are judged wrong."""

import dataclasses

import numpy as np
import pytest
from harness import faults, spec
from reference import avif
from traffic import generate

STATES = spec.cell("defaults1mp-single").config["states"]
LIMITS = spec.cell("defaults1mp-single").spec["limits"]
SPEC = {"generator": "photo", "height": 64, "width": 64}


@pytest.fixture(scope="module")
def encoded():
    from cavif_tpu_torch import Encoder

    enc = dataclasses.replace(Encoder.new().with_quality(80).with_speed(4),
                              device="cpu")
    a = generate(SPEC, 11, 2, "cpu")[0]
    # another seed's image, of the other phase of the pool
    b = max(generate(SPEC, 12, 2, "cpu"),
            key=lambda im: np.abs(im.astype(int) - a).mean())
    return a, b, enc.encode_rgb(a).avif_file, enc.encode_rgb(b).avif_file


def _correct(got):
    return (not got["faults"] and got["decoded"]
            and got["rmse"] is not None
            and got["rmse"] <= LIMITS["rmse_worst"])


def test_the_ports_file_is_judged_right(encoded):
    a, _, fa, _ = encoded
    got = avif.judge(fa, a, STATES)
    assert got["faults"] == [] and got["decoded"]
    assert 1.0 < got["rmse"] < LIMITS["rmse_worst"]
    assert _correct(got)


def test_flipped_payload_bytes_are_judged_wrong(encoded):
    a, _, fa, _ = encoded
    (bad, _), = faults.flip(lambda imgs: [(fa, None)])([a])
    assert bad != fa and len(bad) == len(fa)
    assert not _correct(avif.judge(bad, a, STATES))


def test_another_seeds_file_is_judged_wrong(encoded):
    a, b, _, fb = encoded
    got = avif.judge(fb, a, STATES)
    assert got["faults"] == []  # a sound file, of the wrong picture
    assert got["rmse"] > 2 * LIMITS["rmse_worst"]
    assert not _correct(got)


def test_an_8_bit_file_breaks_the_stated_depth(encoded):
    from cavif_tpu_torch import Encoder

    a = encoded[0]
    enc = dataclasses.replace(
        Encoder.new().with_quality(80).with_speed(4).with_bit_depth(8),
        device="cpu")
    got = avif.judge(enc.encode_rgb(a).avif_file, a, STATES)
    assert sorted(got["faults"]) == ["av1C depth", "pixi depth 0",
                                     "pixi depth 1", "pixi depth 2"]
    assert not _correct(got)


def test_a_truncated_or_foreign_file_is_judged_wrong(encoded):
    a, _, fa, _ = encoded
    got = avif.judge(fa[: len(fa) // 2], a, STATES)
    assert not _correct(got)
    got = avif.judge(b"\0\0\0\x10ftypheic\0\0\0\0", a, STATES)
    assert got["faults"] and not got["decoded"]
