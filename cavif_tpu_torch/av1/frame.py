"""AV1 frame header (uncompressed header) and frame/tile-group OBU assembly.

Implements the spec's uncompressed_header() for the still-picture
configuration this encoder emits: reduced_still_picture_header sequence, KEY
frame, no superres, no CDEF/LRF (toggled via sequence header), no
segmentation, no delta-q, fixed quantizer, loop filter off (levels 0) until
the deblocking stage lands.

Reference parity: rav1e writes the same headers for cavif's configuration
(still_picture: true, single KEY frame; /root/reference/ravif/src/
av1encoder.rs:684,760-764).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

from .obu import (
    OBU_FRAME,
    OBU_SEQUENCE_HEADER,
    OBU_TEMPORAL_DELIMITER,
    BitWriter,
    wrap_obu,
    write_sequence_header,
)


@dataclass
class FrameParams:
    width: int
    height: int
    bit_depth: int
    monochrome: bool
    base_q_idx: int
    disable_cdf_update: bool = False
    tx_mode_select: bool = False  # False -> TX_MODE_LARGEST
    reduced_tx_set: bool = False
    allow_screen_content_tools: bool = False
    # loop filter levels [Y vert, Y horz, U, V]
    filter_level: tuple = (0, 0, 0, 0)
    filter_sharpness: int = 0
    # CDEF (requires enable_cdef in the sequence header); strengths are
    # (primary, secondary) pairs; one entry => cdef_bits = 0
    cdef_damping: int = 3
    cdef_y_strengths: tuple = ()
    cdef_uv_strengths: tuple = ()
    # loop restoration: per-plane frame restoration types in the CODED
    # 2-bit remap index (0 NONE, 1 SWITCHABLE, 2 WIENER, 3 SGRPROJ); empty
    # tuple means the sequence header did not set enable_restoration.
    # lr_unit_shift 2 -> 256px luma units.
    lr_types: tuple = ()
    lr_unit_shift: int = 2
    # uniform tile spacing log2 counts
    tile_cols_log2: int = 0
    tile_rows_log2: int = 0
    # delta-q offsets (all 0 for the reference's fixed-quantizer config)
    delta_q_y_dc: int = 0
    delta_q_u_dc: int = 0
    delta_q_u_ac: int = 0
    # per-superblock adaptive quantization (delta_q_params)
    delta_q_present: bool = False
    delta_q_res_log2: int = 2

    @property
    def sb_cols(self) -> int:
        return (self.width + 63) >> 6

    @property
    def sb_rows(self) -> int:
        return (self.height + 63) >> 6

    @property
    def coded_lossless(self) -> bool:
        return (
            self.base_q_idx == 0
            and self.delta_q_y_dc == 0
            and self.delta_q_u_dc == 0
            and self.delta_q_u_ac == 0
        )


def _tile_log2(blk_size: int, target: int) -> int:
    k = 0
    while (blk_size << k) < target:
        k += 1
    return k


def write_delta_q(w: BitWriter, value: int) -> None:
    """read_delta_q mirror: delta_coded flag + su(1+6) when non-zero."""
    if value:
        assert -64 <= value < 64
        w.f(1, 1)
        w.f(value & 0x7F, 7)  # su(7): 7-bit two's complement (MSB = sign)
    else:
        w.f(0, 1)


def write_frame_header_bits(p: FrameParams, w: BitWriter) -> None:
    """uncompressed_header() under reduced_still_picture_header=1.

    The sequence header must have been written with matching toggles:
    enable_superres=0, enable_cdef=0, enable_restoration=0,
    enable_filter_intra=0, film_grain=0.
    """
    w.f(1 if p.disable_cdf_update else 0, 1)
    # reduced_still_picture_header => seq_force_screen_content_tools = SELECT
    w.f(1 if p.allow_screen_content_tools else 0, 1)
    if p.allow_screen_content_tools:
        raise NotImplementedError("screen content tools")
    # frame_size()/superres: reduced header uses max frame size; superres off.
    # render_size():
    w.f(0, 1)  # render_and_frame_size_different
    # disable_frame_end_update_cdf = 1 (reduced header), no bit.
    # tile_info()
    sb_cols, sb_rows = p.sb_cols, p.sb_rows
    sb_shift = 6  # 64x64 superblocks
    sb_size_log2 = sb_shift - 2  # in mi units: 4
    max_tile_width_sb = 4096 >> sb_shift
    max_tile_area_sb = (4096 * 2304) >> (2 * sb_shift)
    min_log2_tile_cols = _tile_log2(max_tile_width_sb, sb_cols)
    max_log2_tile_cols = _tile_log2(1, min(sb_cols, 64))
    max_log2_tile_rows = _tile_log2(1, min(sb_rows, 64))
    min_log2_tiles = max(
        min_log2_tile_cols,
        _tile_log2(max_tile_area_sb, sb_rows * sb_cols),
    )
    w.f(1, 1)  # uniform_tile_spacing_flag
    assert p.tile_cols_log2 >= min_log2_tile_cols
    tcl = p.tile_cols_log2
    for _ in range(min_log2_tile_cols, tcl):
        w.f(1, 1)
    if tcl < max_log2_tile_cols:
        w.f(0, 1)
    min_log2_tile_rows = max(min_log2_tiles - tcl, 0)
    trl = p.tile_rows_log2
    assert trl >= min_log2_tile_rows
    for _ in range(min_log2_tile_rows, trl):
        w.f(1, 1)
    if trl < max_log2_tile_rows:
        w.f(0, 1)
    if tcl > 0 or trl > 0:
        w.f(0, tcl + trl)  # context_update_tile_id = 0
        w.f(3, 2)  # tile_size_bytes_minus_1 = 3 (4-byte tile sizes)
    # quantization_params()
    w.f(p.base_q_idx, 8)
    write_delta_q(w, p.delta_q_y_dc)  # DeltaQYDc
    if not p.monochrome:
        # separate_uv_delta_q = 0 in our sequence header -> no diff_uv_delta
        write_delta_q(w, p.delta_q_u_dc)
        write_delta_q(w, p.delta_q_u_ac)
    w.f(0, 1)  # using_qmatrix
    # segmentation_params()
    w.f(0, 1)  # segmentation_enabled
    # delta_q_params()
    if p.base_q_idx > 0:
        w.f(1 if p.delta_q_present else 0, 1)
        if p.delta_q_present:
            w.f(p.delta_q_res_log2, 2)
            # delta_lf_params(): delta_lf_present = 0 (no intrabc)
            w.f(0, 1)
    # delta_lf_params(): only if delta_q_present
    # loop_filter_params()
    if not p.coded_lossless:
        lv = p.filter_level
        w.f(lv[0], 6)
        w.f(lv[1], 6)
        if not p.monochrome and (lv[0] or lv[1]):
            w.f(lv[2], 6)
            w.f(lv[3], 6)
        w.f(p.filter_sharpness, 3)
        w.f(0, 1)  # loop_filter_delta_enabled
    # cdef_params() — present iff the sequence header set enable_cdef
    if p.cdef_y_strengths:
        n = len(p.cdef_y_strengths)
        bits = max(0, (n - 1).bit_length())
        w.f(p.cdef_damping - 3, 2)
        w.f(bits, 2)
        for i in range(1 << bits):
            yp, ys = p.cdef_y_strengths[min(i, n - 1)]
            w.f(yp, 4)
            w.f(ys, 2)
            if not p.monochrome:
                up, us = p.cdef_uv_strengths[min(i, n - 1)]
                w.f(up, 4)
                w.f(us, 2)
    # lr_params() — present iff the sequence header set enable_restoration
    if p.lr_types:
        uses_lr = any(p.lr_types)
        uses_chroma_lr = any(p.lr_types[1:])
        for t in p.lr_types:
            w.f(t, 2)
        if uses_lr:
            # 64 << lr_unit_shift luma units (sb 64: two incremental bits)
            w.f(1 if p.lr_unit_shift >= 1 else 0, 1)
            if p.lr_unit_shift >= 1:
                w.f(1 if p.lr_unit_shift >= 2 else 0, 1)
            # 4:4:4 / monochrome: no lr_uv_shift bit (needs subX and subY)
    # read_tx_mode()
    if not p.coded_lossless:
        w.f(1 if p.tx_mode_select else 0, 1)
    # frame_reference_mode / skip_mode_params / warped motion: intra, no bits
    w.f(1 if p.reduced_tx_set else 0, 1)
    # global_motion_params / film_grain: none for intra / disabled


def assemble_frame_obu(p: FrameParams, tiles: List[bytes]) -> bytes:
    """OBU_FRAME: frame header bits, byte alignment, tile group."""
    w = BitWriter()
    write_frame_header_bits(p, w)
    w.byte_align()
    n_tiles = (1 << p.tile_cols_log2) * (1 << p.tile_rows_log2)
    assert len(tiles) == n_tiles
    if n_tiles > 1:
        # tile_group_obu(): the flag is the first bit after the frame-header
        # alignment, then the tile group aligns again before tile data
        w.f(0, 1)  # tile_start_and_end_present_flag
        w.byte_align()
    payload = bytearray(w.to_bytes())
    for i, t in enumerate(tiles):
        if i != n_tiles - 1:
            payload += (len(t) - 1).to_bytes(4, "little")  # tile_size_minus_1
        payload += t
    return wrap_obu(OBU_FRAME, bytes(payload))


def assemble_temporal_unit(
    seq_payload: bytes, frame_obu: bytes
) -> bytes:
    return (
        wrap_obu(OBU_TEMPORAL_DELIMITER, b"")
        + wrap_obu(OBU_SEQUENCE_HEADER, seq_payload)
        + frame_obu
    )
