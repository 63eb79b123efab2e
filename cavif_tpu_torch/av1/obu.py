"""AV1 OBU layer: bit I/O, leb128, OBU framing, sequence-header read/write.

Implements the AV1 bitstream spec's open_bitstream_unit / sequence_header_obu
syntax (intra/still-picture subset on the write side; general parse on the
read side so foreign streams -- e.g. libaom-encoded AVIF items used as test
fixtures -- can be inspected).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

# OBU types
OBU_SEQUENCE_HEADER = 1
OBU_TEMPORAL_DELIMITER = 2
OBU_FRAME_HEADER = 3
OBU_TILE_GROUP = 4
OBU_METADATA = 5
OBU_FRAME = 6
OBU_REDUNDANT_FRAME_HEADER = 7
OBU_PADDING = 15


class BitReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0  # bit position

    def f(self, n: int) -> int:
        """Read n bits, MSB first."""
        v = 0
        for _ in range(n):
            byte = self.data[self.pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def uvlc(self) -> int:
        leading = 0
        while self.f(1) == 0:
            leading += 1
            if leading > 32:
                raise ValueError("invalid uvlc")
        if leading == 32:
            return (1 << 32) - 1
        return (1 << leading) - 1 + (self.f(leading) if leading else 0)


class BitWriter:
    def __init__(self):
        self.bits: list[int] = []

    def f(self, v: int, n: int) -> "BitWriter":
        assert 0 <= v < (1 << n), (v, n)
        for i in range(n - 1, -1, -1):
            self.bits.append((v >> i) & 1)
        return self

    def byte_align(self) -> "BitWriter":
        while len(self.bits) % 8:
            self.bits.append(0)
        return self

    def trailing_bits(self) -> "BitWriter":
        """trailing_bits(): a 1 then zeros to byte alignment."""
        self.bits.append(1)
        return self.byte_align()

    def to_bytes(self) -> bytes:
        assert len(self.bits) % 8 == 0
        out = bytearray(len(self.bits) // 8)
        for i, b in enumerate(self.bits):
            if b:
                out[i >> 3] |= 0x80 >> (i & 7)
        return bytes(out)


def leb128_encode(value: int) -> bytes:
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def leb128_decode(data: bytes, pos: int) -> Tuple[int, int]:
    value = 0
    for i in range(8):
        b = data[pos + i]
        value |= (b & 0x7F) << (7 * i)
        if not (b & 0x80):
            return value, pos + i + 1
    raise ValueError("leb128 too long")


def wrap_obu(obu_type: int, payload: bytes) -> bytes:
    """OBU header (no extension, has_size_field=1) + leb128 size + payload."""
    header = (obu_type << 3) | 0x02
    return bytes([header]) + leb128_encode(len(payload)) + payload


def iter_obus(data: bytes) -> Iterator[Tuple[int, bytes]]:
    """Yield (obu_type, payload) for each OBU in a temporal unit."""
    pos = 0
    while pos < len(data):
        header = data[pos]
        if header & 0x80:
            raise ValueError("forbidden bit set in OBU header")
        obu_type = (header >> 3) & 0xF
        has_ext = (header >> 2) & 1
        has_size = (header >> 1) & 1
        pos += 1
        if has_ext:
            pos += 1
        if not has_size:
            yield obu_type, data[pos:]
            return
        size, pos = leb128_decode(data, pos)
        yield obu_type, data[pos : pos + size]
        pos += size


@dataclass
class SequenceHeaderInfo:
    seq_profile: int
    still_picture: bool
    reduced_still_picture_header: bool
    seq_level_idx: int
    seq_tier: int
    max_width: int
    max_height: int
    use_128x128_superblock: bool
    enable_filter_intra: bool
    enable_intra_edge_filter: bool
    enable_superres: bool
    enable_cdef: bool
    enable_restoration: bool
    bit_depth: int
    monochrome: bool
    color_description_present: bool
    color_primaries: int
    transfer_characteristics: int
    matrix_coefficients: int
    color_range_full: bool
    subsampling_x: int
    subsampling_y: int
    chroma_sample_position: int
    separate_uv_delta_q: bool
    film_grain_params_present: bool


def parse_sequence_header(payload: bytes) -> SequenceHeaderInfo:
    r = BitReader(payload)
    seq_profile = r.f(3)
    still_picture = bool(r.f(1))
    reduced = bool(r.f(1))
    if reduced:
        seq_level_idx = r.f(5)
        seq_tier = 0
        decoder_model_info_present = False
    else:
        timing_info_present = r.f(1)
        decoder_model_info_present = False
        buffer_delay_length = 0
        if timing_info_present:
            # timing_info(): num_units_in_display_tick, time_scale (32 each),
            # equal_picture_interval (+uvlc)
            r.f(32)
            r.f(32)
            if r.f(1):
                r.uvlc()
            decoder_model_info_present = bool(r.f(1))
            if decoder_model_info_present:
                buffer_delay_length = r.f(5) + 1
                r.f(32)  # num_units_in_decoding_tick
                r.f(5)  # buffer_removal_time_length_minus_1
                r.f(5)  # frame_presentation_time_length_minus_1
        initial_display_delay_present = bool(r.f(1))
        operating_points_cnt = r.f(5) + 1
        seq_level_idx = 0
        seq_tier = 0
        for i in range(operating_points_cnt):
            r.f(12)  # operating_point_idc
            level = r.f(5)
            tier = r.f(1) if level > 7 else 0
            if i == 0:
                seq_level_idx, seq_tier = level, tier
            if decoder_model_info_present:
                if r.f(1):  # decoder_model_present_for_this_op
                    r.f(buffer_delay_length)  # decoder_buffer_delay
                    r.f(buffer_delay_length)  # encoder_buffer_delay
                    r.f(1)  # low_delay_mode_flag
            if initial_display_delay_present:
                if r.f(1):
                    r.f(4)
    wbits = r.f(4) + 1
    hbits = r.f(4) + 1
    max_width = r.f(wbits) + 1
    max_height = r.f(hbits) + 1
    if not reduced:
        if r.f(1):  # frame_id_numbers_present_flag
            r.f(4)  # delta_frame_id_length_minus_2
            r.f(3)  # additional_frame_id_length_minus_1
    use_128 = bool(r.f(1))
    enable_filter_intra = bool(r.f(1))
    enable_intra_edge_filter = bool(r.f(1))
    if not reduced:
        r.f(1)  # enable_interintra_compound
        r.f(1)  # enable_masked_compound
        r.f(1)  # enable_warped_motion
        r.f(1)  # enable_dual_filter
        enable_order_hint = bool(r.f(1))
        if enable_order_hint:
            r.f(1)  # enable_jnt_comp
            r.f(1)  # enable_ref_frame_mvs
        if r.f(1):  # seq_choose_screen_content_tools
            seq_force_sct = 2  # SELECT_SCREEN_CONTENT_TOOLS
        else:
            seq_force_sct = r.f(1)
        if seq_force_sct > 0:
            if not r.f(1):  # seq_choose_integer_mv
                r.f(1)  # seq_force_integer_mv
        if enable_order_hint:
            r.f(3)  # order_hint_bits_minus_1
    enable_superres = bool(r.f(1))
    enable_cdef = bool(r.f(1))
    enable_restoration = bool(r.f(1))
    # color_config()
    high_bitdepth = r.f(1)
    if seq_profile == 2 and high_bitdepth:
        twelve_bit = r.f(1)
        bit_depth = 12 if twelve_bit else 10
    else:
        bit_depth = 10 if high_bitdepth else 8
    if seq_profile == 1:
        monochrome = False
    else:
        monochrome = bool(r.f(1))
    color_description_present = bool(r.f(1))
    if color_description_present:
        color_primaries = r.f(8)
        transfer_characteristics = r.f(8)
        matrix_coefficients = r.f(8)
    else:
        color_primaries, transfer_characteristics, matrix_coefficients = 2, 2, 2
    subsampling_x = subsampling_y = 0
    chroma_sample_position = 0
    separate_uv_delta_q = False
    if monochrome:
        color_range_full = bool(r.f(1))
        subsampling_x = subsampling_y = 1
    elif color_primaries == 1 and transfer_characteristics == 13 and matrix_coefficients == 0:
        color_range_full = True
    else:
        color_range_full = bool(r.f(1))
        if seq_profile == 0:
            subsampling_x = subsampling_y = 1
        elif seq_profile == 1:
            subsampling_x = subsampling_y = 0
        else:
            if bit_depth == 12:
                subsampling_x = r.f(1)
                subsampling_y = r.f(1) if subsampling_x else 0
            else:
                subsampling_x, subsampling_y = 1, 0
        if subsampling_x and subsampling_y:
            chroma_sample_position = r.f(2)
    if not monochrome:
        separate_uv_delta_q = bool(r.f(1))
    film_grain = bool(r.f(1))
    return SequenceHeaderInfo(
        seq_profile=seq_profile,
        still_picture=still_picture,
        reduced_still_picture_header=reduced,
        seq_level_idx=seq_level_idx,
        seq_tier=seq_tier,
        max_width=max_width,
        max_height=max_height,
        use_128x128_superblock=use_128,
        enable_filter_intra=enable_filter_intra,
        enable_intra_edge_filter=enable_intra_edge_filter,
        enable_superres=enable_superres,
        enable_cdef=enable_cdef,
        enable_restoration=enable_restoration,
        bit_depth=bit_depth,
        monochrome=monochrome,
        color_description_present=color_description_present,
        color_primaries=color_primaries,
        transfer_characteristics=transfer_characteristics,
        matrix_coefficients=matrix_coefficients,
        color_range_full=color_range_full,
        subsampling_x=subsampling_x,
        subsampling_y=subsampling_y,
        chroma_sample_position=chroma_sample_position,
        separate_uv_delta_q=separate_uv_delta_q,
        film_grain_params_present=film_grain,
    )


# (MaxPicSize, MaxHSize, MaxVSize) per seq_level_idx; 31 = LEVEL_MAX (no
# constraint), used when dimensions exceed every defined level.
_LEVELS = [
    (0, 147456, 2048, 1152),
    (1, 278784, 2816, 1584),
    (4, 665856, 4352, 2448),
    (5, 1065024, 5504, 3096),
    (8, 2359296, 6144, 3456),
    (12, 8912896, 8192, 4352),
    (16, 35651584, 16384, 8704),
]


def choose_level(width: int, height: int) -> int:
    for idx, max_pic, max_w, max_h in _LEVELS:
        if width * height <= max_pic and width <= max_w and height <= max_h:
            return idx
    return 31


def write_sequence_header(
    width: int,
    height: int,
    seq_profile: int,
    bit_depth: int,
    monochrome: bool,
    full_range: bool = True,
    color_primaries: Optional[int] = None,
    transfer_characteristics: Optional[int] = None,
    matrix_coefficients: Optional[int] = None,
    enable_filter_intra: bool = False,
    enable_intra_edge_filter: bool = False,
    enable_cdef: bool = False,
    enable_restoration: bool = False,
    use_128x128_superblock: bool = False,
) -> bytes:
    """Sequence header OBU payload for a still picture with
    reduced_still_picture_header = 1 (single operating point, KEY frame
    implied). Spec: sequence_header_obu() / color_config()."""
    w = BitWriter()
    w.f(seq_profile, 3)
    w.f(1, 1)  # still_picture
    w.f(1, 1)  # reduced_still_picture_header
    w.f(choose_level(width, height), 5)  # seq_level_idx[0]
    w.f(15, 4)  # frame_width_bits_minus_1
    w.f(15, 4)  # frame_height_bits_minus_1
    w.f(width - 1, 16)
    w.f(height - 1, 16)
    w.f(1 if use_128x128_superblock else 0, 1)
    w.f(1 if enable_filter_intra else 0, 1)
    w.f(1 if enable_intra_edge_filter else 0, 1)
    w.f(0, 1)  # enable_superres
    w.f(1 if enable_cdef else 0, 1)
    w.f(1 if enable_restoration else 0, 1)
    # color_config()
    assert bit_depth in (8, 10)
    w.f(1 if bit_depth == 10 else 0, 1)  # high_bitdepth
    if seq_profile != 1:
        w.f(1 if monochrome else 0, 1)
    else:
        assert not monochrome
    describe = color_primaries is not None
    w.f(1 if describe else 0, 1)  # color_description_present_flag
    if describe:
        w.f(color_primaries, 8)
        w.f(transfer_characteristics, 8)
        w.f(matrix_coefficients, 8)
    if monochrome:
        w.f(1 if full_range else 0, 1)
    elif describe and color_primaries == 1 and transfer_characteristics == 13 and matrix_coefficients == 0:
        assert full_range  # sRGB-identity branch implies full range, 4:4:4
    else:
        w.f(1 if full_range else 0, 1)
        # seq_profile 1 fixes 4:4:4 (no subsampling bits);
        # (subsampling_x && subsampling_y) is false, so no sample position.
        assert seq_profile == 1
    if not monochrome:
        w.f(0, 1)  # separate_uv_delta_q
    w.f(0, 1)  # film_grain_params_present
    w.trailing_bits()
    return w.to_bytes()


def parse_sequence_header_info(temporal_unit: bytes) -> SequenceHeaderInfo:
    """Find and parse the sequence header OBU inside an AV1 temporal unit."""
    for obu_type, payload in iter_obus(temporal_unit):
        if obu_type == OBU_SEQUENCE_HEADER:
            return parse_sequence_header(payload)
    raise ValueError("no sequence header OBU found")
