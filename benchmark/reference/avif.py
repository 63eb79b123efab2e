"""Judge one AVIF file against the input image it was encoded from.

Three readings per file, and a fourth of an RGBA input:

- `faults`: how many of the properties that the configuration states the
  file gets wrong. The container is read by the plain ISOBMFF parser
  below (ISO/IEC 14496-12 boxes, the HEIF item boxes of ISO/IEC 23008-12
  and the AV1 codec configuration box of the AV1-ISOBMFF binding): brand,
  handler, one primary `av01` item with its data inside the file, its
  size (`ispe`), its channels and bits (`pixi`), its AV1 profile, depth
  and chroma sampling (`av1C`), its colour signalling (`colr` nclx), the
  alpha item where one belongs and none elsewhere, and the decoded
  picture's mode and size.
- `decoded`: whether an independent AV1 decoder (dav1d, through
  Pillow's libavif) decodes it. No AV1 decoder in plain NumPy exists
  here; dav1d is code of its own, not the program's.
- `rmse`: the root mean square difference, in 8-bit levels, between the
  decoded picture and the input: over the R, G and B samples of an RGB
  input; over all four samples of an RGBA one, its colour premultiplied
  by its alpha on both sides (what a viewer shows).
- `rmse_alpha` (RGBA inputs only): the same difference over the alpha
  samples alone, so that an alpha plane coded too coarsely shows at its
  own size and not diluted by the colour.

The alpha rule follows ravif (`av1encoder.rs`: an RGBA input whose every
pixel is opaque is coded without alpha) and HEIF's auxiliary images: a
file needs an alpha item exactly when its input has 4 channels and some
alpha below 255. That item is one `av01` item with an `auxl` reference to
the primary and its data inside the file, an `auxC` of the alpha URN, a
monochrome `av1C` at the stated depth, the primary's `ispe`, and a
1-channel `pixi` at the stated depth. The `prem` reference marks
premultiplied colour; only the unassociated alpha modes are judged, so it
must be absent (`judged_settings` refuses the premultiplied mode).
"""

from __future__ import annotations

import io
import struct

import numpy as np

ROWS = 512  # rows per block of the difference, to bound host memory
AUX_ALPHA = b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha"


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
    for item, idxs in assoc.items():
        got = item_props.setdefault(item, {})
        for idx in idxs:
            if not 1 <= idx <= len(props):
                raise Malformed(f"property index {idx} of {len(props)}")
            kind, bs, be = props[idx - 1]
            got.setdefault(kind, []).append(buf[bs:be])
    return {"major": major, "brands": brands, "handler": handler,
            "primary": primary, "types": types, "refs": refs,
            "extents": extents, "item_props": item_props}


def judged_settings(settings: dict) -> None:
    """Refuse, before any run, encoder settings whose files the judge
    cannot judge: premultiplied alpha, whose colour Pillow would have to
    un-premultiply in a way of its own."""
    if settings.get("alpha_color_mode") == "Premultiplied":
        raise ValueError("the reference judges the unassociated alpha modes "
                         "only, not alpha_color_mode Premultiplied")


def _one_prop(props: dict, kind: str):
    got = props.get(kind, [])
    return got[0] if len(got) == 1 else None


def _data_inside(info: dict, item: int, size: int) -> bool:
    ext = info["extents"].get(item) or []
    return bool(ext) and all(m == 0 and ln > 0 and off + ln <= size
                             for m, off, ln in ext)


def _alpha_faults(info: dict, size: int, want: dict, h: int, w: int,
                  alpha: bool):
    """[what the file gets wrong of the alpha rule]: an alpha item where
    `alpha` says one belongs, none where it says none."""
    p = info["primary"]
    aux = [src for kind, src, dst in info["refs"]
           if kind == "auxl" and p in dst]
    n_av01 = sum(t == "av01" for t in info["types"].values())
    if not alpha:
        return [] if aux == [] and n_av01 == 1 else ["alpha item"]
    if len(aux) != 1 or n_av01 != 2 or info["types"].get(aux[0]) != "av01":
        return ["alpha item"]
    a = aux[0]
    bad = [] if _data_inside(info, a, size) else ["alpha item data"]
    if any(kind == "prem" for kind, _, _ in info["refs"]):
        bad.append("alpha prem")
    props = info["item_props"].get(a, {})
    auxc = _one_prop(props, "auxC")
    if auxc is None or auxc[4:].rstrip(b"\0") != AUX_ALPHA:
        bad.append("alpha auxC")
    depth = want["depth_bits"]
    av1c = _one_prop(props, "av1C")
    if av1c is None or len(av1c) < 4 or av1c[0] != 0x81:
        bad.append("alpha av1C")
    else:
        b2 = av1c[2]
        if not (b2 >> 4) & 1:
            bad.append("alpha av1C monochrome")
        if (b2 >> 6) & 1 != int(depth > 8) or (b2 >> 5) & 1 != int(depth > 10):
            bad.append("alpha av1C depth")
    ispe = _one_prop(props, "ispe")
    if ispe is None or struct.unpack_from(">II", ispe, 4) != (w, h):
        bad.append("alpha ispe size")
    pixi = _one_prop(props, "pixi")
    if pixi is None or len(pixi) != 6 or pixi[4] != 1 or pixi[5] != depth:
        bad.append("alpha pixi")
    return bad


def _property_faults(info: dict, size: int, want: dict, h: int, w: int,
                     alpha: bool = False):
    """[name of each stated property the file gets wrong]; `alpha`: the
    input calls for an alpha item."""
    bad = []
    if info["major"] != "avif":
        bad.append("brand")
    if info["handler"] != "pict":
        bad.append("handler")
    p = info["primary"]
    if info["types"].get(p) != "av01":
        bad.append("primary item type")
    if not _data_inside(info, p, size):
        bad.append("primary item data")
    bad += _alpha_faults(info, size, want, h, w, alpha)
    props = info["item_props"].get(p, {})

    def prop(kind):
        return _one_prop(props, kind)

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


def _rmse_rgba(decoded: np.ndarray, image: np.ndarray) -> float:
    """Over all four samples of each pixel: the colour premultiplied by
    its alpha on each side, the alpha as it is."""
    total = 0.0
    for r in range(0, image.shape[0], ROWS):
        d = decoded[r: r + ROWS].astype(np.float64)
        i = image[r: r + ROWS].astype(np.float64)
        dc = (d[..., :3] * d[..., 3:] - i[..., :3] * i[..., 3:]) / 255.0
        da = d[..., 3] - i[..., 3]
        total += (float(np.einsum("ijk,ijk->", dc, dc))
                  + float(np.einsum("ij,ij->", da, da)))
    return float(np.sqrt(total / image.size))


def _rmse_alpha(decoded: np.ndarray, image: np.ndarray) -> float:
    """Over the alpha samples alone."""
    total = 0.0
    for r in range(0, image.shape[0], ROWS):
        d = (decoded[r: r + ROWS, :, 3].astype(np.float64)
             - image[r: r + ROWS, :, 3].astype(np.float64))
        total += float(np.einsum("ij,ij->", d, d))
    return float(np.sqrt(total / (image.shape[0] * image.shape[1])))


def judge(avif: bytes, image: np.ndarray, want: dict) -> dict:
    """{"faults": [...], "decoded": bool, "rmse": float or None} of one
    file against the (H, W, 3) or (H, W, 4) uint8 `image` it was encoded
    from, under the properties `want` (a configuration's `states`); of an
    RGBA input also "rmse_alpha", where the file decoded."""
    from PIL import Image

    h, w, c = image.shape
    alpha = c == 4 and bool((image[..., 3] != 255).any())
    try:
        faults = _property_faults(parse(avif), len(avif), want, h, w, alpha)
    except (Malformed, IndexError, struct.error, UnicodeDecodeError) as e:
        faults = [f"container: {e}"]
    as_mode = "RGBA" if c == 4 else "RGB"
    try:
        with Image.open(io.BytesIO(avif)) as im:
            im.load()
            mode, size = im.mode, im.size
            decoded = np.asarray(im.convert(as_mode))
    except Exception as e:  # any refusal of the decoder is the reading
        return {"faults": faults, "decoded": False, "rmse": None,
                "error": f"{type(e).__name__}: {e}"}
    if mode != ("RGBA" if alpha else "RGB"):
        faults.append(f"decoded mode {mode}")
    if size != (w, h):
        faults.append(f"decoded size {size}")
        got = {"faults": faults, "decoded": True, "rmse": None}
        return {**got, "rmse_alpha": None} if c == 4 else got
    if c == 3:
        return {"faults": faults, "decoded": True,
                "rmse": _rmse(decoded, image)}
    return {"faults": faults, "decoded": True,
            "rmse": _rmse_rgba(decoded, image),
            "rmse_alpha": _rmse_alpha(decoded, image)}
