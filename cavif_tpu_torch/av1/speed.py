"""Speed presets: the RDO/tooling policy matrix.

Exact replication of /root/reference/ravif/src/av1encoder.rs:532-647
(SpeedTweaks::from_my_preset) including the intentionally inverted quality
flags (quality->quantizer is a decreasing map, the comparisons are on the
quantizer): low_quality = quantizer < q2q(55) = 153 (i.e. quality > ~55),
high_quality = quantizer > q2q(80) = 121 (i.e. quality < 80).

Each knob maps onto a stage of the TPU encoder (SURVEY.md section 2.2):
partition_range bounds the partition-RDO search, cdef/lrf gate the loop-filter
stages, reduced_tx_set prunes the transform-type candidate batch, etc.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..ops.quality import quality_to_quantizer


@dataclass(frozen=True)
class SpeedTweaks:
    speed_preset: int
    partition_range: tuple[int, int]
    complex_prediction_modes: bool
    sgr_complexity_full: bool
    encode_bottomup: bool
    rdo_tx_decision: bool
    reduced_tx_set: bool
    fine_directional_intra: bool
    fast_deblock: bool
    lrf: bool
    cdef: bool
    # -- carried for parity with the reference matrix, no-ops here --------
    # inter_tx_split (av1encoder.rs:592, enable_inter_tx_split) splits
    # INTER-block transforms; this encoder is still_picture intra-only, so
    # there is nothing to split (N/A-for-intra, like rav1e at speed>=9 on
    # a still image).
    inter_tx_split: bool
    # tx_domain_rate (av1encoder.rs:593) switches rav1e's RDO rate estimate
    # from entropy-coder lookahead to a transform-domain proxy at s>=10.
    # This build's search rate model is ALREADY transform-domain at every
    # speed (CDF-priced |level| bits on the quantized coefficients —
    # block_search / device_pass1 / tilecoder rd_cost), so the toggle has
    # no distinct slow path to switch away from; carried as documentation.
    tx_domain_rate: bool
    tx_domain_distortion: None  # never overridden in the reference
    # use_satd_subpel (av1encoder.rs:596) tunes subpel MOTION search; no
    # motion vectors exist in a still-picture intra encode (N/A-for-intra).
    # The reference also pins it false unconditionally.
    use_satd_subpel: bool
    min_tile_size: int

    @staticmethod
    def from_preset(speed: int, quantizer: int) -> "SpeedTweaks":
        low_quality = quantizer < quality_to_quantizer(55.0)  # 153
        high_quality = quantizer > quality_to_quantizer(80.0)  # 121
        max_block_size = 16 if high_quality else 64

        if speed == 0:
            partition_range = (4, min(64, max_block_size))
        elif speed == 1 and low_quality:
            partition_range = (4, min(64, max_block_size))
        elif speed == 2 and low_quality:
            partition_range = (4, min(32, max_block_size))
        elif 1 <= speed <= 4:
            partition_range = (4, 16)
        elif 5 <= speed <= 8:
            partition_range = (8, 16)
        else:
            partition_range = (16, 16)

        min_tile_size = {0: 4096, 1: 2048, 2: 1024, 3: 512, 4: 256}.get(speed, 128)
        if high_quality:
            min_tile_size *= 2

        return SpeedTweaks(
            speed_preset=speed,
            partition_range=partition_range,
            complex_prediction_modes=speed <= 1,
            sgr_complexity_full=speed <= 2,
            encode_bottomup=speed <= 2,
            rdo_tx_decision=speed <= 4 and not high_quality,
            reduced_tx_set=speed == 4 or speed >= 9,
            fine_directional_intra=speed <= 6,
            fast_deblock=speed >= 7 and not high_quality,
            lrf=low_quality and speed <= 8,
            cdef=low_quality and speed <= 9,
            inter_tx_split=speed >= 9,
            tx_domain_rate=speed >= 10,
            tx_domain_distortion=None,
            use_satd_subpel=False,
            min_tile_size=min_tile_size,
        )


def tile_count(width: int, height: int, threads: int, min_tile_size: int) -> int:
    """Reference tile heuristic: min(threads, W*H / min_tile_size^2)
    (av1encoder.rs:665-668). In the TPU build this sizes the tile axis of the
    device mesh rather than a threadpool."""
    return min(threads, (width * height) // (min_tile_size * min_tile_size))
