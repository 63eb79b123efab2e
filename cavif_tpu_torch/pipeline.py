"""Encode pipeline: plane conversion -> color/alpha AV1 encodes -> AVIF mux.

Mirrors ravif src/av1encoder.rs:243-481: the color stream is
4:4:4 at the chosen quantizer; alpha (when present) is a *separate* AV1
stream, monochrome (Cs400), full range, with its own quantizer and its own
speed tweaks; both are muxed by the ISOBMFF serializer. The reference forks
color/alpha onto rayon; here the two encodes run on two threads, each with
its own device pass 1 on the card (Encoder.device) and its own host tail.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .av1.config import AV1Config
from .av1.speed import SpeedTweaks
from .container.mux import serialize_avif
from .ops import colorspace
from .utils import trace


def _matrix_coefficients(color_model) -> int:
    # colr nclx code points: BT601 = 6, Identity/RGB = 0 (av1encoder.rs:459-468)
    from . import ColorModel

    return 6 if color_model is ColorModel.YCbCr else 0


def _convert_planes(enc, rgb: np.ndarray, depth: int) -> np.ndarray:
    from . import ColorModel

    if enc.color_model is ColorModel.YCbCr:
        return colorspace.rgb_to_ycbcr_host(rgb, depth=depth)
    return colorspace.rgb_to_gbr_host(rgb, depth=depth)


def _encode_streams(enc, planes: np.ndarray, alpha: Optional[np.ndarray],
                    depth: int, rgb8=None, alpha8=None,
                    full_range: bool = True,
                    matrix_coefficients: Optional[int] = None):
    from .av1.encoder import encode_planes

    if matrix_coefficients is None:
        matrix_coefficients = _matrix_coefficients(enc.color_model)
    h, w = planes.shape[:2]
    color_cfg = AV1Config(
        width=w,
        height=h,
        bit_depth=depth,
        quantizer=enc.quantizer,
        tweaks=SpeedTweaks.from_preset(enc.speed, enc.quantizer),
        chroma_sampling="444",
        full_range=full_range,
        matrix_coefficients=matrix_coefficients,
        threads=enc.threads,
        tune=enc.tune,
        device=enc.device,
    )
    if alpha is None:
        return encode_planes(planes, color_cfg, src8=rgb8), None
    alpha_cfg = AV1Config(
        width=w,
        height=h,
        bit_depth=depth,
        quantizer=enc.alpha_quantizer,
        tweaks=SpeedTweaks.from_preset(enc.speed, enc.alpha_quantizer),
        chroma_sampling="400",
        full_range=True,
        matrix_coefficients=None,
        threads=enc.threads,
        tune=enc.tune,
        device=enc.device,
    )
    # the reference forks color || alpha onto rayon (av1encoder.rs:454);
    # here the two independent AV1 encodes overlap on two threads (the
    # native serializer/search calls release the GIL). Each submit runs
    # under a copy of the caller's context so per-call state — the
    # hybrid scheduler's PASS1_HOOKS device-slot bound — reaches both
    # streams' device round trips (plain executor threads start with an
    # empty context and would silently escape the slot bound).
    import contextvars
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=2) as ex:
        fc = ex.submit(contextvars.copy_context().run,
                       encode_planes, planes, color_cfg, rgb8)
        fa = ex.submit(contextvars.copy_context().run,
                       encode_planes, alpha, alpha_cfg, alpha8)
        return fc.result(), fa.result()


def _finish(enc, color: bytes, alpha: Optional[bytes], w: int, h: int, depth: int,
            full_range: bool = True,
            matrix_coefficients: Optional[int] = None):
    from . import EncodedImage

    if matrix_coefficients is None:
        matrix_coefficients = _matrix_coefficients(enc.color_model)
    avif = serialize_avif(
        color=color,
        alpha=alpha,
        width=w,
        height=h,
        depth=depth,
        matrix_coefficients=matrix_coefficients,
        premultiplied_alpha=enc.premultiplied_alpha,
        exif=enc.exif,
        full_range=full_range,
    )
    return EncodedImage(
        avif_file=avif,
        color_byte_size=len(color),
        alpha_byte_size=len(alpha) if alpha is not None else 0,
    )


def encode_rgba_pipeline(enc, rgba: np.ndarray):
    depth = enc.output_depth.bits
    h, w = rgba.shape[:2]
    trace.reset()
    with trace.span("convert"):
        planes = _convert_planes(enc, rgba[..., :3], depth)
        alpha = colorspace.alpha_plane_host(rgba[..., 3], depth=depth)
    color, alpha_payload = _encode_streams(
        enc, planes, alpha, depth,
        rgb8=np.ascontiguousarray(rgba[..., :3]),
        alpha8=np.ascontiguousarray(rgba[..., 3]),
    )
    with trace.span("mux"):
        out = _finish(enc, color, alpha_payload, w, h, depth)
    trace.report(f"rgba {w}x{h}")
    return out


def encode_raw_planes_pipeline(enc, planes: np.ndarray,
                               alpha: Optional[np.ndarray], depth: int,
                               full_range: bool, matrix_coefficients: int):
    """Caller-owned plane triples straight into the two AV1 streams + mux —
    the reference's encode_raw_planes_{8,10}_bit core (av1encoder.rs:366-481):
    no conversion, no alpha preprocessing, no opaque drop; the color stream
    carries the caller's pixel range and matrix, alpha stays Cs400 full-range
    with its own quantizer/speed tweaks."""
    h, w = planes.shape[:2]
    trace.reset()
    # the encoder core works on int32 plane stacks (rgb_to_ycbcr_host dtype)
    planes = np.ascontiguousarray(planes.astype(np.int32))
    if alpha is not None:
        alpha = np.ascontiguousarray(alpha.astype(np.int32))
    color, alpha_payload = _encode_streams(
        enc, planes, alpha, depth,
        full_range=full_range, matrix_coefficients=matrix_coefficients,
    )
    with trace.span("mux"):
        out = _finish(
            enc, color, alpha_payload, w, h, depth,
            full_range=full_range, matrix_coefficients=matrix_coefficients,
        )
    trace.report(f"raw-planes {w}x{h}")
    return out


def encode_rgb_pipeline(enc, rgb: np.ndarray):
    depth = enc.output_depth.bits
    h, w = rgb.shape[:2]
    trace.reset()
    with trace.span("convert"):
        planes = _convert_planes(enc, rgb, depth)
    color, _ = _encode_streams(
        enc, planes, None, depth, rgb8=np.ascontiguousarray(rgb)
    )
    with trace.span("mux"):
        out = _finish(enc, color, None, w, h, depth)
    trace.report(f"rgb {w}x{h}")
    return out
