"""The PyTorch/CUDA port keeps its own copies of the JAX package's host code.

Every verbatim copy must equal its original byte for byte, and every file
of the port that has a counterpart in cavif_tpu/ is either such a copy or
one of the files edited on purpose (listed below), so drift between the two
packages is caught here."""

from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
REF = ROOT / "cavif_tpu"
PORT = ROOT / "cavif_tpu_torch"

VERBATIM = (
    "errors.py",
    "cli.py",
    "__main__.py",
    "av1/__init__.py",
    "av1/config.py",
    "av1/speed.py",
    "av1/transforms.py",
    "av1/predict.py",
    "av1/itx.py",
    "av1/symbols.py",
    "av1/opstream.py",
    "av1/ec.py",
    "av1/frame.py",
    "av1/obu.py",
    "av1/sgr.py",
    "av1/data/tables.npz",
    "native/__init__.py",
    "native/contract.py",
    "native/op_contract.h",
    "native/tilecoder.cpp",
    "native/colorconv.cpp",
    "container/__init__.py",
    "container/boxes.py",
    "container/mux.py",
    "container/parse.py",
    "ops/__init__.py",
    "ops/quality.py",
    "ops/ingest.py",
    "utils/__init__.py",
    "utils/trace.py",
)

# copied, then changed on purpose (see CHANGES.md)
EDITED = (
    "__init__.py",
    "pipeline.py",
    # two seams: the device default (the card, raising without one) and
    # no host fall back in _device_grids; the device filter-chain branch
    # of encode() is the reference's, on the port's ops/device_filters
    "av1/encoder.py",
    "av1/tables.py",
    "ops/colorspace.py",
    "ops/dirtyalpha.py",
    "ops/device_pass1.py",
    "ops/block_search.py",
    "ops/attachment.py",
    "ops/device_filters.py",
    # torch on tensors, the device argument, int64 index tables
    "ops/device_itx.py",
    "ops/device_predict.py",
    "ops/device_pass2.py",
    "parallel/__init__.py",
    "parallel/batch.py",
)


@pytest.mark.parametrize("rel", VERBATIM)
def test_verbatim_copy(rel):
    assert (PORT / rel).read_bytes() == (REF / rel).read_bytes(), rel


@pytest.mark.parametrize("rel", EDITED)
def test_edited_copy_differs(rel):
    assert (PORT / rel).exists() and (REF / rel).exists()
    assert (PORT / rel).read_bytes() != (REF / rel).read_bytes(), (
        f"{rel} equals its original: move it to VERBATIM")


def test_every_counterpart_is_listed():
    """A port file with a namesake in cavif_tpu/ must be a listed copy."""
    listed = set(VERBATIM) | set(EDITED)
    unlisted = []
    for p in PORT.rglob("*"):
        if not p.is_file() or "__pycache__" in p.parts:
            continue
        if p.suffix in (".so", ".o", ".pyc") or "_build" in p.parts:
            continue
        rel = p.relative_to(PORT).as_posix()
        if (REF / rel).exists() and rel not in listed:
            unlisted.append(rel)
    assert not unlisted, unlisted
