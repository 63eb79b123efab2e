"""AVIF (ISOBMFF/HEIF) muxer -- the avif-serialize equivalent.

Writes ftyp + meta(hdlr, pitm, iloc, iinf, iref, iprp) + mdat with the color
AV1 item as the primary item, an optional monochrome alpha AV1 item linked via
an `auxl` reference and `auxC` property, an optional Exif item (`cdsc` ref),
colr nclx (sRGB transfer / BT.709 primaries / caller-chosen matrix), and the
`prem` reference for premultiplied alpha.

Behavioral reference: the avif-serialize crate as exercised by
/root/reference/ravif/src/av1encoder.rs:457-473; byte layout follows the
ISOBMFF/HEIF/MIAF specs, not that crate.
"""

from __future__ import annotations

from typing import Optional

from .boxes import box, full_box, u8, u16, u32
from ..av1.obu import parse_sequence_header_info

AUX_TYPE_ALPHA = b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha\x00"

COLOR_ID = 1
ALPHA_ID = 2
EXIF_ID = 3


def _av1c(payload: bytes, depth: int, monochrome: bool) -> bytes:
    """AV1CodecConfigurationRecord. Fields mirror the stream's sequence
    header; configOBUs left empty (the item payload carries the full TU)."""
    info = parse_sequence_header_info(payload)
    b0 = 0x80 | 1  # marker | version
    b1 = (info.seq_profile << 5) | info.seq_level_idx
    b2 = (
        (info.seq_tier << 7)
        | ((1 if depth >= 10 else 0) << 6)
        | (0 << 5)  # twelve_bit
        | ((1 if monochrome else 0) << 4)
        | (info.subsampling_x << 3)
        | (info.subsampling_y << 2)
        | info.chroma_sample_position
    )
    b3 = 0  # no initial_presentation_delay
    return box("av1C", bytes([b0, b1, b2, b3]))


def _ispe(width: int, height: int) -> bytes:
    return full_box("ispe", 0, 0, u32(width) + u32(height))


def _pixi(channels: int, depth: int) -> bytes:
    return full_box("pixi", 0, 0, u8(channels) + bytes([depth] * channels))


def _colr_nclx(matrix_coefficients: int, full_range: bool) -> bytes:
    # colour_primaries BT.709 (1), transfer sRGB (13) -- av1encoder.rs:407-411
    return box(
        "colr",
        b"nclx" + u16(1) + u16(13) + u16(matrix_coefficients) + u8(0x80 if full_range else 0),
    )


def _auxc() -> bytes:
    return full_box("auxC", 0, 0, AUX_TYPE_ALPHA)


def _infe(item_id: int, item_type: str, name: str = "") -> bytes:
    return full_box(
        "infe",
        2,
        0,
        u16(item_id) + u16(0) + item_type.encode("ascii") + name.encode("utf-8") + b"\x00",
    )


def serialize_avif(
    color: bytes,
    alpha: Optional[bytes],
    width: int,
    height: int,
    depth: int,
    matrix_coefficients: int = 6,
    premultiplied_alpha: bool = False,
    exif: Optional[bytes] = None,
    full_range: bool = True,
) -> bytes:
    """Assemble the AVIF file from encoded AV1 item payloads."""
    ftyp = box("ftyp", b"avif" + u32(0) + b"avif" + b"mif1" + b"miaf" + b"MA1B")

    items = [(COLOR_ID, color)]
    if alpha is not None:
        items.append((ALPHA_ID, alpha))
    if exif is not None:
        # Exif item payload: 4-byte offset to the TIFF header, then the data.
        items.append((EXIF_ID, u32(0) + exif))

    hdlr = full_box("hdlr", 0, 0, u32(0) + b"pict" + u32(0) * 3 + b"\x00")
    pitm = full_box("pitm", 0, 0, u16(COLOR_ID))

    # iinf
    infes = [_infe(COLOR_ID, "av01")]
    if alpha is not None:
        infes.append(_infe(ALPHA_ID, "av01"))
    if exif is not None:
        infes.append(_infe(EXIF_ID, "Exif"))
    iinf = full_box("iinf", 0, 0, u16(len(infes)) + b"".join(infes))

    # iref
    refs = b""
    if alpha is not None:
        refs += box("auxl", u16(ALPHA_ID) + u16(1) + u16(COLOR_ID))
        if premultiplied_alpha:
            refs += box("prem", u16(COLOR_ID) + u16(1) + u16(ALPHA_ID))
    if exif is not None:
        refs += box("cdsc", u16(EXIF_ID) + u16(1) + u16(COLOR_ID))
    iref = full_box("iref", 0, 0, refs) if refs else b""

    # iprp: property container + associations
    props = [
        _ispe(width, height),  # 1
        _colr_nclx(matrix_coefficients, full_range),  # 2
        _av1c(color, depth, monochrome=False),  # 3
        _pixi(3, depth),  # 4
    ]
    assoc = [(COLOR_ID, [(1, False), (2, False), (3, True), (4, False)])]
    if alpha is not None:
        props += [
            _av1c(alpha, depth, monochrome=True),  # 5
            _auxc(),  # 6
            _pixi(1, depth),  # 7
        ]
        assoc.append((ALPHA_ID, [(1, False), (5, True), (6, True), (7, False)]))
    ipco = box("ipco", b"".join(props))
    ipma_entries = b""
    for item_id, assocs in assoc:
        ipma_entries += u16(item_id) + u8(len(assocs))
        for prop_idx, essential in assocs:
            ipma_entries += u8((0x80 if essential else 0) | prop_idx)
    ipma = full_box("ipma", 0, 0, u32(len(assoc)) + ipma_entries)
    iprp = box("iprp", ipco + ipma)

    # iloc with 4-byte absolute offsets; meta size does not depend on the
    # offset values, so compute layout in one pass with placeholders.
    def build_iloc(offsets):
        body = u8(0x44) + u8(0x00) + u16(len(items))  # offset/length 4B, base 0
        for (item_id, payload), off in zip(items, offsets):
            body += u16(item_id) + u16(0) + u16(1) + u32(off) + u32(len(payload))
        return full_box("iloc", 0, 0, body)

    def build_meta(offsets):
        return full_box(
            "meta", 0, 0, hdlr + pitm + build_iloc(offsets) + iinf + iref + iprp
        )

    meta_size = len(build_meta([0] * len(items)))
    mdat_data_start = len(ftyp) + meta_size + 8
    offsets = []
    pos = mdat_data_start
    for _, payload in items:
        offsets.append(pos)
        pos += len(payload)

    mdat = box("mdat", b"".join(p for _, p in items))
    return ftyp + build_meta(offsets) + mdat
