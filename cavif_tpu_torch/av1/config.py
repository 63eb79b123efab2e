"""Frozen per-stream AV1 encode configuration.

Equivalent of the reference's Av1EncodeConfig + the EncoderConfig fields it
pins (av1encoder.rs:649-708): still_picture, fixed quantizer (no rate
control), 4:4:4 or monochrome sampling, full/limited range, tile heuristic.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Literal, Optional

from .speed import SpeedTweaks


@dataclass(frozen=True)
class AV1Config:
    width: int
    height: int
    bit_depth: int  # 8 or 10
    quantizer: int  # 0..255, fixed (quantizer == min_quantizer, bitrate 0)
    tweaks: SpeedTweaks
    chroma_sampling: Literal["444", "400"]
    full_range: bool = True
    # colr/sequence-header code point; None = no color description (alpha)
    matrix_coefficients: Optional[int] = None
    threads: Optional[int] = None
    # entropy-serializer backend: None = native if built, else python
    ec_backend: Optional[Literal["native", "python"]] = None
    # spec intra edge filtering/upsampling (7.11.2.9-12): smooths the
    # directional predictors' neighbor edges like rav1e does; requires
    # decoder-exact support in the active pass-2 backend
    intra_edge_filter: bool = False
    # "ssim" (the reference's tune: Psychovisual analog, av1encoder.rs:694):
    # per-superblock adaptive quantization steered by local activity —
    # bits flow from textured to smooth regions. "psnr" (default) = flat
    # quantizer, the pure-SSE RD objective of the headline anchors.
    tune: Literal["ssim", "psnr"] = "psnr"
    # per-stream pass-1 compute placement: None = auto (device when a TPU
    # backend is attached, CAVIF_TPU_DEVICE_SEARCH env override), "off" =
    # force the host cascade, "xla"/"pallas" = force the device program.
    # The hybrid batch scheduler (parallel/batch.py) uses this to run the
    # chip and the host cores on different images concurrently.
    device: Optional[str] = None

    @property
    def monochrome(self) -> bool:
        return self.chroma_sampling == "400"

    @property
    def seq_profile(self) -> int:
        # AV1 profiles: 0 = main (4:2:0/mono, 8/10-bit), 1 = high (4:4:4,
        # 8/10-bit), 2 = professional. Color is always 4:4:4 here -> 1;
        # monochrome requires profile 0.
        return 0 if self.monochrome else 1
