"""cavif_tpu_torch: the PyTorch/CUDA port of the cavif-tpu AVIF encoder.

Public API mirrors the `ravif` crate (reference: ravif src/
lib.rs:14-30 and av1encoder.rs:67-275): an `Encoder` builder with
`with_*` methods, `encode_rgba` / `encode_rgb` entry points returning
`EncodedImage`, plus the `ColorModel` / `AlphaColorMode` / `BitDepth` enums.

The device pass 1 (color conversion, the partition + intra-mode search)
runs on an NVIDIA GPU through PyTorch and two hand-written CUDA kernels.
Whenever pass 1 runs on the card, the in-loop filter chain (deblock, CDEF,
loop restoration) runs there too (ops/device_filters.py, engaged by the
attachment probe of ops/attachment.py); the host C++ runs the filters only
with the chain off (CAVIF_TPU_DEVICE_FILTERS=0 or a probe that does not
engage it) or on the host cascade (device "off"). Pass 2, the
entropy-coding tail and ISOBMFF packaging run on the host in C++.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field, replace
from typing import Optional

import numpy as np


def _tune_allocator() -> None:
    """Keep multi-MB numpy temporaries on the heap and recycled: the batch
    pipelines allocate hundreds of MB per image, and glibc's default
    mmap/munmap behavior re-page-faults every encode (10x slowdowns in VM
    environments). No-op where unavailable."""
    import ctypes

    try:
        libc = ctypes.CDLL("libc.so.6")
        libc.mallopt(-3, 1 << 28)  # M_MMAP_THRESHOLD
        libc.mallopt(-1, 1 << 30)  # M_TRIM_THRESHOLD
    except Exception:
        pass


_tune_allocator()

from .errors import CavifError, EncodingError, TooFewPixelsError, UnsupportedError
from .ops.quality import alpha_quality_for, quality_to_quantizer

__version__ = "0.1.0"

__all__ = [
    "Encoder",
    "EncodedImage",
    "ColorModel",
    "MatrixCoefficients",
    "PixelRange",
    "AlphaColorMode",
    "BitDepth",
    "CavifError",
    "EncodingError",
    "TooFewPixelsError",
    "UnsupportedError",
    "quality_to_quantizer",
    "alpha_quality_for",
]


class ColorModel(enum.Enum):
    """Internal AVIF color model (av1encoder.rs:11-22). Always 4:4:4."""

    YCbCr = "ycbcr"
    RGB = "rgb"


class MatrixCoefficients(enum.IntEnum):
    """CICP matrix-coefficient code points accepted by the raw-planes API —
    exactly the set the reference's serializer maps (av1encoder.rs:459-468);
    anything else raises UnsupportedError("matrix coefficients")."""

    Identity = 0  # the reference's Rgb: G,B,R planes coded identity
    Bt709 = 1
    Unspecified = 2
    Bt601 = 6
    YCgCo = 8
    Bt2020Ncl = 9
    Bt2020Cl = 10


class PixelRange(enum.Enum):
    """Color-stream sample range (rav1e PixelRange; av1encoder.rs:375, 443).
    Alpha is always coded full-range regardless."""

    Limited = "limited"
    Full = "full"


class AlphaColorMode(enum.Enum):
    """Handling of color channels in transparent images (av1encoder.rs:24-40)."""

    UnassociatedDirty = "dirty"
    UnassociatedClean = "clean"
    Premultiplied = "premultiplied"


class BitDepth(enum.Enum):
    """Internal encode depth (av1encoder.rs:42-49). Auto means Ten."""

    Eight = 8
    Ten = 10
    Auto = 0

    @property
    def bits(self) -> int:
        return 10 if self is BitDepth.Auto else self.value


@dataclass(frozen=True)
class EncodedImage:
    """AVIF file plus payload-size breakdown (av1encoder.rs:51-61)."""

    avif_file: bytes
    color_byte_size: int
    alpha_byte_size: int


@dataclass(frozen=True)
class Encoder:
    """Encoder config builder. Defaults match the reference
    (av1encoder.rs:88-102): quality 80, speed 5, YCbCr, UnassociatedClean,
    BitDepth Auto (= 10-bit)."""

    quantizer: int = field(default_factory=lambda: quality_to_quantizer(80.0))
    alpha_quantizer: int = field(default_factory=lambda: quality_to_quantizer(80.0))
    speed: int = 5
    premultiplied_alpha: bool = False
    color_model: ColorModel = ColorModel.YCbCr
    threads: Optional[int] = None
    alpha_color_mode: AlphaColorMode = AlphaColorMode.UnassociatedClean
    output_depth: BitDepth = BitDepth.Auto
    exif: Optional[bytes] = None
    # extension beyond the reference API: "ssim" enables per-superblock
    # adaptive quantization (the analog of rav1e's tune: Psychovisual,
    # av1encoder.rs:694). Measured on mixed content it trades PSNR for
    # SSIM at matched bitrate (BASELINE.md), so the default stays the
    # flat-quantizer "psnr" objective that the headline anchors use.
    tune: str = "psnr"
    # pass-1 compute placement for this encoder instance: None or "cuda"
    # = the card (raises when there is none), "cpu" = the same program on
    # the CPU (tests), "off" = the host C++ cascade.
    device: Optional[str] = None

    @staticmethod
    def new() -> "Encoder":
        return Encoder()

    def with_quality(self, quality: float) -> "Encoder":
        assert 1.0 <= quality <= 100.0
        return replace(self, quantizer=quality_to_quantizer(quality))

    def with_alpha_quality(self, quality: float) -> "Encoder":
        assert 1.0 <= quality <= 100.0
        return replace(self, alpha_quantizer=quality_to_quantizer(quality))

    def with_speed(self, speed: int) -> "Encoder":
        assert 1 <= speed <= 10
        return replace(self, speed=speed)

    def with_bit_depth(self, depth) -> "Encoder":
        """Accepts a BitDepth, its name, or a plain 8/10 int."""
        if isinstance(depth, int) and not isinstance(depth, BitDepth):
            depth = BitDepth(depth if depth in (8, 10) else 0)
        elif isinstance(depth, str):
            depth = BitDepth[depth]
        return replace(self, output_depth=depth)

    def with_internal_color_model(self, model) -> "Encoder":
        if isinstance(model, str):
            model = ColorModel[model]
        return replace(self, color_model=model)

    def with_num_threads(self, threads: Optional[int]) -> "Encoder":
        assert threads is None or threads > 0
        return replace(self, threads=threads)

    def with_alpha_color_mode(self, mode: AlphaColorMode) -> "Encoder":
        return replace(
            self,
            alpha_color_mode=mode,
            premultiplied_alpha=mode is AlphaColorMode.Premultiplied,
        )

    def with_exif(self, exif: bytes) -> "Encoder":
        return replace(self, exif=bytes(exif))

    def with_tune(self, tune: str) -> "Encoder":
        assert tune in ("ssim", "psnr")
        return replace(self, tune=tune)

    # ---- encode entry points (av1encoder.rs:243-350) ----

    def encode_rgba(self, rgba: np.ndarray) -> EncodedImage:
        """Encode an (H, W, 4) uint8 RGBA image to AVIF.

        Alpha preprocessing per `alpha_color_mode`; if every pixel is opaque
        the alpha stream is omitted entirely (av1encoder.rs:246-248).
        """
        rgba = _check_image(rgba, 4)
        converted = self._convert_alpha_8bit(rgba)
        buf = converted if converted is not None else rgba
        if not bool((buf[..., 3] != 255).any()):
            return self._encode_rgb_internal(buf[..., :3])
        from .pipeline import encode_rgba_pipeline

        return encode_rgba_pipeline(self, buf)

    def encode_rgb(self, rgb: np.ndarray) -> EncodedImage:
        """Encode an (H, W, 3) uint8 RGB image to AVIF (no alpha stream)."""
        return self._encode_rgb_internal(_check_image(rgb, 3))

    def _encode_rgb_internal(self, rgb: np.ndarray) -> EncodedImage:
        from .pipeline import encode_rgb_pipeline

        return encode_rgb_pipeline(self, rgb)

    def encode_raw_planes_8bit(
        self,
        planes: np.ndarray,
        alpha: Optional[np.ndarray] = None,
        *,
        color_pixel_range: PixelRange = PixelRange.Full,
        matrix_coefficients=MatrixCoefficients.Bt601,
    ) -> EncodedImage:
        """Encode already-converted 8-bit planes to AVIF.

        `planes` is an (H, W, 3) uint8 array of per-pixel plane triples in
        coding order (Y,U,V — or G,B,R for MatrixCoefficients.Identity);
        `alpha` an optional (H, W) uint8 plane, coded as a separate
        monochrome full-range AV1 stream with the encoder's alpha quantizer.
        No color conversion, alpha preprocessing, or opaque auto-drop is
        applied — the caller owns the samples, exactly like the reference's
        `encode_raw_planes_8_bit` (av1encoder.rs:366-388).
        """
        return self._encode_raw_planes(
            planes, alpha, 8, color_pixel_range, matrix_coefficients
        )

    def encode_raw_planes_10bit(
        self,
        planes: np.ndarray,
        alpha: Optional[np.ndarray] = None,
        *,
        color_pixel_range: PixelRange = PixelRange.Full,
        matrix_coefficients=MatrixCoefficients.Bt601,
    ) -> EncodedImage:
        """10-bit variant of encode_raw_planes_8bit: uint16 arrays with
        every sample < 1024 (av1encoder.rs:390-412)."""
        return self._encode_raw_planes(
            planes, alpha, 10, color_pixel_range, matrix_coefficients
        )

    def _encode_raw_planes(
        self, planes, alpha, depth, color_pixel_range, matrix_coefficients
    ) -> EncodedImage:
        try:
            mc = MatrixCoefficients(matrix_coefficients)
        except ValueError:
            # the reference's serializer match arm (av1encoder.rs:459-468)
            raise UnsupportedError("matrix coefficients")
        if isinstance(color_pixel_range, str):
            color_pixel_range = PixelRange(color_pixel_range)
        want = np.uint8 if depth == 8 else np.uint16
        planes = np.asarray(planes)
        if planes.ndim != 3 or planes.shape[2] != 3 or planes.dtype != want:
            raise TooFewPixelsError()
        if planes.shape[0] == 0 or planes.shape[1] == 0:
            raise TooFewPixelsError()
        if alpha is not None:
            alpha = np.asarray(alpha)
            if alpha.shape != planes.shape[:2] or alpha.dtype != want:
                raise TooFewPixelsError()
        if depth == 10:
            if planes.max(initial=0) > 1023 or (
                alpha is not None and alpha.max(initial=0) > 1023
            ):
                raise UnsupportedError("10-bit samples out of range")
        from .pipeline import encode_raw_planes_pipeline

        return encode_raw_planes_pipeline(
            self,
            planes,
            alpha,
            depth=depth,
            full_range=color_pixel_range is PixelRange.Full,
            matrix_coefficients=int(mc),
        )

    def _convert_alpha_8bit(self, rgba: np.ndarray) -> Optional[np.ndarray]:
        """Alpha-mode preprocessing dispatch (av1encoder.rs:277-299)."""
        if self.alpha_color_mode is AlphaColorMode.UnassociatedDirty:
            return None
        if self.alpha_color_mode is AlphaColorMode.UnassociatedClean:
            from .ops.dirtyalpha import blurred_dirty_alpha
            from .utils import trace

            with trace.span("dirty_alpha"):
                return blurred_dirty_alpha(rgba)
        # Premultiplied: c*255/a pass; a in {0, 255} zeroes the whole pixel,
        # alpha included -- replicated literally from av1encoder.rs:283-294.
        a = rgba[..., 3].astype(np.uint16)
        out = np.zeros_like(rgba)
        keep = (a != 0) & (a != 255)
        a_safe = np.maximum(a, 1)
        for c in range(3):
            ch = rgba[..., c].astype(np.uint16) * 255 // a_safe
            out[..., c] = np.where(keep, ch, 0).astype(np.uint8)
        out[..., 3] = np.where(keep, rgba[..., 3], 0).astype(np.uint8)
        return out


def _check_image(img: np.ndarray, channels: int) -> np.ndarray:
    img = np.asarray(img)
    if img.ndim != 3 or img.shape[2] != channels or img.dtype != np.uint8:
        raise TooFewPixelsError()
    if img.shape[0] == 0 or img.shape[1] == 0:
        raise TooFewPixelsError()
    return img
