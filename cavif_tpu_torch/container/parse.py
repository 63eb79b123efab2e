"""AVIF reader/validator -- the test-oracle counterpart of the muxer
(equivalent role to the reference's avif-parse dev-dependency).

Parses the ISOBMFF box tree, resolves the primary and auxiliary-alpha items,
and exposes geometry/depth via the contained sequence headers.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..av1.obu import parse_sequence_header_info


@dataclass
class Box:
    fourcc: str
    offset: int  # offset of the payload within the file
    payload: bytes
    children: List["Box"] = field(default_factory=list)


_CONTAINERS = {"meta", "iprp", "ipco", "moov", "trak"}
_FULLBOX_CONTAINERS = {"meta"}  # containers with a version/flags prefix


def parse_boxes(data: bytes, start: int = 0, end: Optional[int] = None) -> List[Box]:
    end = len(data) if end is None else end
    out = []
    pos = start
    while pos + 8 <= end:
        size = struct.unpack(">I", data[pos : pos + 4])[0]
        fourcc = data[pos + 4 : pos + 8].decode("latin-1")
        header = 8
        if size == 1:
            size = struct.unpack(">Q", data[pos + 8 : pos + 16])[0]
            header = 16
        elif size == 0:
            size = end - pos
        payload_off = pos + header
        payload = data[payload_off : pos + size]
        b = Box(fourcc, payload_off, payload)
        if fourcc in _CONTAINERS:
            skip = 4 if fourcc in _FULLBOX_CONTAINERS else 0
            b.children = parse_boxes(data, payload_off + skip, pos + size)
        out.append(b)
        pos += size
    return out


def _find(boxes: List[Box], fourcc: str) -> Optional[Box]:
    for b in boxes:
        if b.fourcc == fourcc:
            return b
    return None


@dataclass
class AvifInfo:
    primary_item: bytes
    alpha_item: Optional[bytes]
    width: int
    height: int
    bit_depth: int
    still_picture: bool
    matrix_coefficients: Optional[int]
    premultiplied_alpha: bool
    exif: Optional[bytes]
    major_brand: str
    full_range: Optional[bool] = None


def read_avif(data: bytes) -> AvifInfo:
    boxes = parse_boxes(data)
    ftyp = _find(boxes, "ftyp")
    if ftyp is None:
        raise ValueError("not an ISOBMFF file: missing ftyp")
    major = ftyp.payload[:4].decode("latin-1")
    meta = _find(boxes, "meta")
    if meta is None:
        raise ValueError("missing meta box")

    pitm = _find(meta.children, "pitm")
    if pitm is None:
        raise ValueError("missing pitm")
    pitm_version = pitm.payload[0]
    if pitm_version == 0:
        primary_id = struct.unpack(">H", pitm.payload[4:6])[0]
    else:
        primary_id = struct.unpack(">I", pitm.payload[4:8])[0]

    # iinf: item_id -> item_type
    item_types: Dict[int, str] = {}
    iinf = _find(meta.children, "iinf")
    if iinf is not None:
        p = iinf.payload
        version = p[0]
        pos = 4
        count = struct.unpack(">H", p[pos : pos + 2])[0] if version == 0 else struct.unpack(">I", p[pos : pos + 4])[0]
        pos += 2 if version == 0 else 4
        while pos + 8 <= len(p) and len(item_types) < count:
            size = struct.unpack(">I", p[pos : pos + 4])[0]
            fourcc = p[pos + 4 : pos + 8].decode("latin-1")
            body = p[pos + 8 : pos + size]
            if fourcc == "infe":
                ver = body[0]
                if ver >= 2:
                    iid = struct.unpack(">H", body[4:6])[0] if ver == 2 else struct.unpack(">I", body[4:8])[0]
                    t_off = 8 if ver == 2 else 10
                    item_types[iid] = body[t_off : t_off + 4].decode("latin-1")
            pos += size

    # iloc: item_id -> [(offset, length)]
    extents: Dict[int, List[Tuple[int, int]]] = {}
    iloc = _find(meta.children, "iloc")
    if iloc is None:
        raise ValueError("missing iloc")
    p = iloc.payload
    version = p[0]
    pos = 4
    offset_size = p[pos] >> 4
    length_size = p[pos] & 0xF
    base_offset_size = p[pos + 1] >> 4
    index_size = (p[pos + 1] & 0xF) if version in (1, 2) else 0
    pos += 2
    if version < 2:
        item_count = struct.unpack(">H", p[pos : pos + 2])[0]
        pos += 2
    else:
        item_count = struct.unpack(">I", p[pos : pos + 4])[0]
        pos += 4

    def read_int(n: int, pos: int) -> Tuple[int, int]:
        v = int.from_bytes(p[pos : pos + n], "big") if n else 0
        return v, pos + n

    for _ in range(item_count):
        if version < 2:
            iid = struct.unpack(">H", p[pos : pos + 2])[0]
            pos += 2
        else:
            iid = struct.unpack(">I", p[pos : pos + 4])[0]
            pos += 4
        construction_method = 0
        if version in (1, 2):
            construction_method = struct.unpack(">H", p[pos : pos + 2])[0] & 0xF
            pos += 2
        pos += 2  # data_reference_index
        base_offset, pos = read_int(base_offset_size, pos)
        extent_count = struct.unpack(">H", p[pos : pos + 2])[0]
        pos += 2
        items = []
        for _ in range(extent_count):
            if index_size:
                _, pos = read_int(index_size, pos)
            off, pos = read_int(offset_size, pos)
            ln, pos = read_int(length_size, pos)
            items.append((base_offset + off, ln))
        if construction_method == 0:
            extents[iid] = items

    # iref: find auxl (alpha -> primary) and prem references
    alpha_id = None
    premultiplied = False
    iref = _find(meta.children, "iref")
    if iref is not None:
        p = iref.payload
        version = p[0]
        idw = 2 if version == 0 else 4
        pos = 4
        while pos + 8 <= len(p):
            size = struct.unpack(">I", p[pos : pos + 4])[0]
            fourcc = p[pos + 4 : pos + 8].decode("latin-1")
            body = p[pos + 8 : pos + size]
            from_id = int.from_bytes(body[:idw], "big")
            ref_count = struct.unpack(">H", body[idw : idw + 2])[0]
            to_ids = [
                int.from_bytes(body[idw + 2 + i * idw : idw + 2 + (i + 1) * idw], "big")
                for i in range(ref_count)
            ]
            if fourcc == "auxl" and primary_id in to_ids:
                alpha_id = from_id
            if fourcc == "prem" and from_id == primary_id:
                premultiplied = True
            pos += size

    def item_bytes(iid: int) -> Optional[bytes]:
        if iid not in extents:
            return None
        return b"".join(data[off : off + ln] for off, ln in extents[iid])

    primary = item_bytes(primary_id)
    if primary is None:
        raise ValueError("primary item has no data")
    alpha = item_bytes(alpha_id) if alpha_id is not None else None
    exif = None
    for iid, t in item_types.items():
        if t == "Exif":
            raw = item_bytes(iid)
            if raw is not None and len(raw) >= 4:
                exif = raw[4:]

    seq = parse_sequence_header_info(primary)
    # colr (from the primary item's associated properties; simplest: first colr)
    matrix = None
    full_range = None
    iprp = _find(meta.children, "iprp")
    if iprp is not None:
        ipco = _find(iprp.children, "ipco")
        if ipco is not None:
            colr = _find(ipco.children, "colr")
            if colr is not None and colr.payload[:4] == b"nclx":
                matrix = struct.unpack(">H", colr.payload[8:10])[0]
                full_range = bool(colr.payload[10] & 0x80)

    return AvifInfo(
        primary_item=primary,
        alpha_item=alpha,
        width=seq.max_width,
        height=seq.max_height,
        bit_depth=seq.bit_depth,
        still_picture=seq.still_picture,
        matrix_coefficients=matrix,
        premultiplied_alpha=premultiplied,
        exif=exif,
        major_brand=major,
        full_range=full_range,
    )
