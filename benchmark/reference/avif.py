"""Judge one AVIF file against the input image it was encoded from.

Three readings per file:

- `faults`: how many of the properties that the configuration states the
  file gets wrong. The container is read by the plain ISOBMFF parser
  below (ISO/IEC 14496-12 boxes, the HEIF item boxes of ISO/IEC 23008-12
  and the AV1 codec configuration box of the AV1-ISOBMFF binding): brand,
  handler, one primary `av01` item with its data inside the file, its
  size (`ispe`), its channels and bits (`pixi`), its AV1 profile, depth
  and chroma sampling (`av1C`), its colour signalling (`colr` nclx), no
  alpha item, and the decoded picture's mode and size.
- `decoded`: whether an independent AV1 decoder (dav1d, through
  Pillow's libavif) decodes it. No AV1 decoder in plain NumPy exists
  here; dav1d is code of its own, not the program's.
- `rmse`: the root mean square difference, in 8-bit levels over the R,
  G and B samples, between the decoded picture and the input.
"""

from __future__ import annotations

import io
import struct

import numpy as np

ROWS = 512  # rows per block of the difference, to bound host memory


class Malformed(ValueError):
    pass


def _boxes(buf: bytes, start: int, end: int):
    """(type, payload start, box end) of each box in buf[start:end]."""
    pos = start
    while pos < end:
        if pos + 8 > end:
            raise Malformed(f"truncated box header at {pos}")
        size, kind = struct.unpack_from(">I4s", buf, pos)
        head = 8
        if size == 1:
            if pos + 16 > end:
                raise Malformed(f"truncated large box at {pos}")
            size = struct.unpack_from(">Q", buf, pos + 8)[0]
            head = 16
        elif size == 0:
            size = end - pos
        if size < head or pos + size > end:
            raise Malformed(f"box {kind!r} at {pos} runs past its parent")
        yield kind.decode("latin-1"), pos + head, pos + size
        pos += size


def _children(buf, start, end) -> dict:
    out: dict = {}
    for kind, s, e in _boxes(buf, start, end):
        out.setdefault(kind, []).append((s, e))
    return out


def _one(tab: dict, kind: str):
    got = tab.get(kind, [])
    if len(got) != 1:
        raise Malformed(f"{len(got)} '{kind}' boxes where one belongs")
    return got[0]


def _uint(buf, pos, nbytes):
    return int.from_bytes(buf[pos: pos + nbytes], "big") if nbytes else 0


def parse(buf: bytes) -> dict:
    """The parts of an AVIF file that `judge` reads."""
    top = _children(buf, 0, len(buf))
    s, e = _one(top, "ftyp")
    major = buf[s: s + 4].decode("latin-1")
    brands = [buf[p: p + 4].decode("latin-1") for p in range(s + 8, e, 4)]
    s, e = _one(top, "meta")
    meta = _children(buf, s + 4, e)  # a FullBox: skip version and flags
    hs, _ = _one(meta, "hdlr")
    handler = buf[hs + 8: hs + 12].decode("latin-1")
    ps, _ = _one(meta, "pitm")
    primary = _uint(buf, ps + 4, 2 if buf[ps] == 0 else 4)

    types = {}
    s, e = _one(meta, "iinf")
    v = buf[s]
    first = s + 4 + (2 if v == 0 else 4)
    for kind, bs, be in _boxes(buf, first, e):
        if kind != "infe":
            continue
        iv = buf[bs]
        if iv < 2:
            raise Malformed(f"infe version {iv}")
        idn = 2 if iv == 2 else 4
        item = _uint(buf, bs + 4, idn)
        types[item] = buf[bs + 4 + idn + 2: bs + 4 + idn + 6].decode(
            "latin-1")

    refs = []
    for s, e in meta.get("iref", []):
        idn = 2 if buf[s] == 0 else 4
        for kind, bs, be in _boxes(buf, s + 4, e):
            src = _uint(buf, bs, idn)
            n = _uint(buf, bs + idn, 2)
            dst = [_uint(buf, bs + idn + 2 + k * idn, idn) for k in range(n)]
            refs.append((kind, src, dst))

    s, e = _one(meta, "iloc")
    v = buf[s]
    off_sz, len_sz = buf[s + 4] >> 4, buf[s + 4] & 15
    base_sz, idx_sz = buf[s + 5] >> 4, (buf[s + 5] & 15 if v in (1, 2)
                                        else 0)
    pos = s + 6
    count = _uint(buf, pos, 2 if v < 2 else 4)
    pos += 2 if v < 2 else 4
    extents = {}
    for _ in range(count):
        idn = 2 if v < 2 else 4
        item = _uint(buf, pos, idn)
        pos += idn
        method = 0
        if v in (1, 2):
            method = _uint(buf, pos, 2) & 15
            pos += 2
        pos += 2  # data_reference_index
        base = _uint(buf, pos, base_sz)
        pos += base_sz
        n = _uint(buf, pos, 2)
        pos += 2
        ext = []
        for _ in range(n):
            pos += idx_sz
            off = _uint(buf, pos, off_sz)
            pos += off_sz
            ln = _uint(buf, pos, len_sz)
            pos += len_sz
            ext.append((method, base + off, ln))
        extents[item] = ext

    s, e = _one(meta, "iprp")
    iprp = _children(buf, s, e)
    cs, ce = _one(iprp, "ipco")
    props = [(kind, bs, be) for kind, bs, be in _boxes(buf, cs, ce)]
    assoc = {}
    for ms, me in iprp.get("ipma", []):
        v, flags = buf[ms], _uint(buf, ms + 1, 3)
        pos = ms + 4
        n = _uint(buf, pos, 4)
        pos += 4
        for _ in range(n):
            idn = 2 if v < 1 else 4
            item = _uint(buf, pos, idn)
            pos += idn
            k = buf[pos]
            pos += 1
            got = []
            for _ in range(k):
                if flags & 1:
                    got.append(_uint(buf, pos, 2) & 0x7FFF)
                    pos += 2
                else:
                    got.append(buf[pos] & 0x7F)
                    pos += 1
            assoc.setdefault(item, []).extend(got)

    item_props: dict = {}
    for idx in assoc.get(primary, []):
        if not 1 <= idx <= len(props):
            raise Malformed(f"property index {idx} of {len(props)}")
        kind, bs, be = props[idx - 1]
        item_props.setdefault(kind, []).append(buf[bs:be])
    return {"major": major, "brands": brands, "handler": handler,
            "primary": primary, "types": types, "refs": refs,
            "extents": extents, "props": item_props}


def _property_faults(info: dict, size: int, want: dict, h: int, w: int):
    """[name of each stated property the file gets wrong]."""
    bad = []
    if info["major"] != "avif":
        bad.append("brand")
    if info["handler"] != "pict":
        bad.append("handler")
    p = info["primary"]
    if info["types"].get(p) != "av01":
        bad.append("primary item type")
    ext = info["extents"].get(p) or []
    if (not ext or any(m != 0 or ln <= 0 or off + ln > size
                       for m, off, ln in ext)):
        bad.append("primary item data")
    alpha = [src for kind, src, dst in info["refs"]
             if kind == "auxl" and p in dst]
    if alpha != [] or sum(t == "av01" for t in info["types"].values()) != 1:
        bad.append("alpha item")
    props = info["props"]

    def prop(kind):
        got = props.get(kind, [])
        return got[0] if len(got) == 1 else None

    ispe = prop("ispe")
    if ispe is None or struct.unpack_from(">II", ispe, 4) != (w, h):
        bad.append("ispe size")
    pixi = prop("pixi")
    depth = want["depth_bits"]
    if pixi is None or pixi[4] != 3:
        bad.append("pixi channels")
    else:
        bad += [f"pixi depth {c}" for c in range(3) if pixi[5 + c] != depth]
    av1c = prop("av1C")
    if av1c is None or len(av1c) < 4 or av1c[0] != 0x81:
        bad.append("av1C")
    else:
        b1, b2 = av1c[1], av1c[2]
        if b1 >> 5 != want["av1_profile"]:
            bad.append("av1C profile")
        if (b2 >> 6) & 1 != int(depth > 8) or (b2 >> 5) & 1 != int(depth > 10):
            bad.append("av1C depth")
        if (b2 >> 4) & 1:
            bad.append("av1C monochrome")
        if ((b2 >> 3) & 1, (b2 >> 2) & 1) != tuple(want["chroma_subsampling"]):
            bad.append("av1C chroma subsampling")
    nclx = [c for c in props.get("colr", []) if c[:4] == b"nclx"]
    if len(nclx) != 1:
        bad.append("colr nclx")
    else:
        prim, trc, mc = struct.unpack_from(">HHH", nclx[0], 4)
        full = nclx[0][10] >> 7
        for name, got in (("colour_primaries", prim),
                          ("transfer_characteristics", trc),
                          ("matrix_coefficients", mc), ("full_range", full)):
            if got != want[name]:
                bad.append(f"colr {name}")
    return bad


def _rmse(decoded: np.ndarray, image: np.ndarray) -> float:
    total = 0.0
    for r in range(0, image.shape[0], ROWS):
        d = (decoded[r: r + ROWS].astype(np.float64)
             - image[r: r + ROWS].astype(np.float64))
        total += float(np.einsum("ijk,ijk->", d, d))
    return float(np.sqrt(total / image.size))


def judge(avif: bytes, image: np.ndarray, want: dict) -> dict:
    """{"faults": [...], "decoded": bool, "rmse": float or None} of one
    file against the (H, W, 3) uint8 `image` it was encoded from, under
    the properties `want` (a configuration's `states`)."""
    from PIL import Image

    h, w = image.shape[:2]
    try:
        faults = _property_faults(parse(avif), len(avif), want, h, w)
    except (Malformed, IndexError, struct.error, UnicodeDecodeError) as e:
        faults = [f"container: {e}"]
    try:
        with Image.open(io.BytesIO(avif)) as im:
            im.load()
            mode, size = im.mode, im.size
            decoded = np.asarray(im.convert("RGB"))
    except Exception as e:  # any refusal of the decoder is the reading
        return {"faults": faults, "decoded": False, "rmse": None,
                "error": f"{type(e).__name__}: {e}"}
    if mode != "RGB":
        faults.append(f"decoded mode {mode}")
    if size != (w, h):
        faults.append(f"decoded size {size}")
        return {"faults": faults, "decoded": True, "rmse": None}
    return {"faults": faults, "decoded": True,
            "rmse": _rmse(decoded, image)}
