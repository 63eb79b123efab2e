"""End-to-end encodes of the PyTorch/CUDA port (cavif_tpu_torch) on the CPU.

The port's device pass 1 runs here with device="cpu" (its kernels take their
plain PyTorch versions). The encode must decode in Pillow and stay inside
the envelope of tests/test_device_search.py against the port's own host
C++ cascade (device="off"): PSNR at least the host's minus 0.1 dB and bytes
at most 1.05x the host's, on the Pillow-decoded image and on the
decoder-exact pre-filter reconstruction. Where the port's pass-1 decisions
equal the JAX package's (its XLA formulation on the CPU), the two encoders
write the same bytes, since everything after pass 1 is a verbatim copy."""

import ast
import io
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import cavif_tpu_torch
from cavif_tpu.av1.config import AV1Config as RefAV1Config
from cavif_tpu.av1.encoder import FrameEncoder as RefFrameEncoder
from cavif_tpu.av1.speed import SpeedTweaks as RefSpeedTweaks
from cavif_tpu_torch.av1.config import AV1Config
from cavif_tpu_torch.av1.encoder import FrameEncoder
from cavif_tpu_torch.av1.speed import SpeedTweaks
from cavif_tpu_torch.container.parse import read_avif
from cavif_tpu_torch.ops import colorspace
from cavif_tpu_torch.ops.quality import quality_to_quantizer

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "cavif_tpu_torch"


@pytest.fixture(scope="module")
def img():
    """The 256x256 image of tests/test_device_search.py."""
    rng = np.random.default_rng(7)
    y, x = np.mgrid[0:256, 0:256].astype(np.float64)
    lum = np.clip(
        120 + 70 * np.sin(x / 53.0) * np.cos(y / 37.0)
        + rng.normal(0, 6, x.shape), 0, 255
    )
    return np.dstack(
        [lum, np.clip(lum + 15, 0, 255), np.clip(lum - 20, 0, 255)]
    ).astype(np.uint8)


def _enc(device):
    return replace(
        cavif_tpu_torch.Encoder.new().with_quality(70).with_speed(4)
        .with_num_threads(1), device=device)


def _psnr_rgb(avif: bytes, img) -> float:
    d = np.asarray(Image.open(io.BytesIO(avif)).convert("RGB"))
    err = ((d.astype(np.float64) - img) ** 2).mean()
    return 10 * np.log10(255 ** 2 / err)


@pytest.fixture(scope="module")
def host_avif(img):
    return _enc("off").encode_rgb(img).avif_file


def test_encode_within_host_envelope(img, host_avif):
    dev = _enc("cpu").encode_rgb(img).avif_file
    info = read_avif(dev)
    assert (info.width, info.height, info.bit_depth) == (256, 256, 10)
    ph, pd = _psnr_rgb(host_avif, img), _psnr_rgb(dev, img)
    assert pd > ph - 0.1, (ph, pd)
    assert len(dev) < len(host_avif) * 1.05, (len(host_avif), len(dev))


def _colour_frame(pkg_frame_encoder, img, device):
    """The colour stream's FrameEncoder, built as the pipeline builds it;
    returns (frame bytes, decoder-exact recon stack, encoder, planes)."""
    q = quality_to_quantizer(70.0)
    cfg = AV1Config(
        width=img.shape[1], height=img.shape[0], bit_depth=10, quantizer=q,
        tweaks=SpeedTweaks.from_preset(4, q), chroma_sampling="444",
        full_range=True, matrix_coefficients=6, threads=1, tune="psnr",
        device=device,
    )
    planes = colorspace.rgb_to_ycbcr_host(img, depth=10)
    fe = pkg_frame_encoder(planes, cfg, src8=img)
    data = fe.encode()
    return data, fe._recon_full(), fe, planes


def test_recon_within_host_envelope(img):
    """The measure chip_smoke.py uses on the card: PSNR of the
    reconstruction before the output-only loop filters."""
    h, w = img.shape[:2]
    out = {}
    for device in ("cpu", "off"):
        data, recon, _, planes = _colour_frame(FrameEncoder, img, device)
        err = np.mean([
            ((recon[p, :h, :w].astype(np.float64) - planes[..., p]) ** 2)
            .mean() for p in range(3)])
        out[device] = (len(data), 10 * np.log10(1023.0 ** 2 / err))
    (db, dp_), (hb, hp) = out["cpu"], out["off"]
    assert dp_ > hp - 0.1, (hp, dp_)
    assert db < hb * 1.05, (hb, db)


def test_rgba_encode_decodes(img):
    h, w = img.shape[:2]
    yy, xx = np.mgrid[0:h, 0:w]
    alpha = np.clip((xx + yy) * 255 // (w + h - 2), 0, 255).astype(np.uint8)
    rgba = np.dstack([img, alpha])
    res = _enc("cpu").encode_rgba(rgba)
    assert res.alpha_byte_size > 0
    assert read_avif(res.avif_file).alpha_item is not None
    dec = np.asarray(Image.open(io.BytesIO(res.avif_file)).convert("RGBA"))
    assert dec.shape == (h, w, 4)
    assert np.abs(dec[..., 3].astype(int) - alpha).mean() < 2.0


def test_bytes_match_reference_where_grids_match(img):
    """The JAX package with its XLA pass 1 on the CPU and the port with its
    plain pass 1 on the CPU reach the same decisions on this image (f32 on
    both sides), and then write byte-identical frames."""
    data_p, _, fe_p, _ = _colour_frame(FrameEncoder, img, "cpu")
    q = quality_to_quantizer(70.0)
    cfg = RefAV1Config(
        width=256, height=256, bit_depth=10, quantizer=q,
        tweaks=RefSpeedTweaks.from_preset(4, q),
        chroma_sampling="444", full_range=True, matrix_coefficients=6,
        threads=1, tune="psnr", device="xla",
    )
    planes = colorspace.rgb_to_ycbcr_host(img, depth=10)
    ref = RefFrameEncoder(planes, cfg, src8=img)
    data_r = ref.encode()
    grids_r, grids_p = ref._dev_state[0], fe_p._dev_state[0]
    assert sorted(grids_r) == sorted(grids_p)
    same = all(np.array_equal(grids_r[k], grids_p[k]) for k in grids_r)
    assert same, [k for k in grids_r
                  if not np.array_equal(grids_r[k], grids_p[k])]
    assert data_p == data_r


def test_port_imports_no_jax_in_process():
    code = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
from dataclasses import replace
import numpy as np
import cavif_tpu_torch
img = (np.arange(64 * 64 * 3) % 251).astype(np.uint8).reshape(64, 64, 3)
enc = replace(cavif_tpu_torch.Encoder.new().with_speed(8), device="cpu")
res = enc.encode_rgb(img)
assert res.avif_file[4:8] == b"ftyp"
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "cavif_tpu")]
assert not bad, bad
print("ok")
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]


REFUSED = ("jax", "jaxlib", "cavif_tpu", "bench", "tools", "pallas_proto",
           "pallas_proto2")


def _tree_roots(tree):
    """The top-level modules that `tree` imports, and those imported by
    code held in its string constants: a string with "import" in it that
    parses as Python (a child process's `-c` program, say) is walked the
    same way."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]
        elif (isinstance(node, ast.Constant) and isinstance(node.value, str)
              and "import" in node.value):
            try:
                inner = ast.parse(node.value)
            except SyntaxError:
                continue  # prose, not code
            yield from _tree_roots(inner)


def _imported_roots(path: Path):
    yield from _tree_roots(ast.parse(path.read_text(), filename=str(path)))


def test_port_sources_import_no_jax():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = [(f.relative_to(ROOT).as_posix(), m) for f in files
           for m in _imported_roots(f) if m in REFUSED]
    assert not bad, bad


CHILD_SOURCE = '''"""Starts a child; this docstring says that it does not import jax."""
import subprocess
import sys

CODE = "import jax\\nprint(jax.devices())"
OTHER = """
import numpy
from cavif_tpu import Encoder
"""
subprocess.run([sys.executable, "-c", CODE])
'''


def test_import_guard_reads_code_in_strings(tmp_path):
    """The guard refuses an import that only a child process's program,
    held in a string, makes; prose that mentions an import is not code."""
    child = tmp_path / "child.py"
    child.write_text(CHILD_SOURCE)
    roots = list(_imported_roots(child))
    assert [m for m in roots if m in REFUSED] == ["jax", "cavif_tpu"], roots
    assert {"numpy", "subprocess", "sys"} <= set(roots), roots


def test_default_encoder_raises_without_cuda(img):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    with pytest.raises(RuntimeError, match="cuda"):
        cavif_tpu_torch.Encoder.new().encode_rgb(img[:64, :64])


@pytest.mark.parametrize("device", ["cuda", None])
def test_run_pass1_never_drops_to_cpu(device):
    from cavif_tpu_torch.ops import device_pass1 as dp

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        dp.resolve_device(device)
