"""Image ingest: decode PNG/JPEG bytes and normalize to RGBA8.

Mirrors /root/reference/src/main.rs:254-278 (load_rgba): every input layout
(RGB8/RGBA8/RGB16/RGBA16/GRAY8/GRAY16/GRAYA8/GRAYA16, palette) normalizes to
RGBA8 -- 16-bit channels via `>> 8`, gray replicated to RGB, missing alpha
set to 255, optional premultiply pass (c = c*a/255, integer).

Host-side decode (PIL) is acceptable here, as in the reference (the load_image
crate); this is not a performance path -- the encode pipeline is.
"""

from __future__ import annotations

import io

import numpy as np


def load_rgba(data: bytes, premultiplied_alpha: bool = False) -> np.ndarray:
    """Decode image bytes to an (H, W, 4) uint8 RGBA array."""
    from PIL import Image

    img = Image.open(io.BytesIO(data))
    img.load()

    mode = img.mode
    if mode in ("I;16", "I;16B", "I;16L", "I"):
        # 16-/32-bit grayscale: take the high byte, fan out to RGB, opaque.
        arr = np.asarray(img)
        g = (arr >> 8).astype(np.uint8) if arr.dtype != np.uint8 else arr
        h, w = g.shape
        out = np.empty((h, w, 4), np.uint8)
        out[..., 0] = out[..., 1] = out[..., 2] = g
        out[..., 3] = 255
    else:
        # Embedded ICC profiles: the reference's load_image converts to
        # sRGB through lcms2 (Cargo.toml lcms2-static, README.md:3);
        # mirror with PIL's lcms2 bindings. Profile errors fall back to
        # ignoring the profile (load_image's lenient mode).
        icc = img.info.get("icc_profile")
        if icc and img.mode in ("RGB", "RGBA", "L", "LA", "P", "CMYK"):
            try:
                from PIL import ImageCms

                src = ImageCms.ImageCmsProfile(io.BytesIO(icc))
                if img.mode == "P":
                    img = img.convert("RGBA")
                # transform FROM the original mode (a gray profile can't
                # transform an already-RGB-converted image); alpha rides
                # along separately for LA
                alpha = None
                work = img
                if img.mode == "LA":
                    alpha = img.getchannel("A")
                    work = img.convert("L")
                out_mode = "RGBA" if work.mode == "RGBA" else "RGB"
                work = ImageCms.profileToProfile(
                    work, src, ImageCms.createProfile("sRGB"),
                    outputMode=out_mode,
                )
                if alpha is not None:
                    work.putalpha(alpha)
                img = work
            except Exception:
                pass
        # PIL handles palette/transparency/LA/CMYK expansion; 16-bit RGB(A)
        # PNGs are decoded by PIL with the high byte already taken, matching
        # the reference's `>> 8` normalization.
        rgba = img.convert("RGBA")
        out = np.asarray(rgba, dtype=np.uint8).copy()

    if premultiplied_alpha:
        a = out[..., 3].astype(np.uint16)
        for c in range(3):
            out[..., c] = (out[..., c].astype(np.uint16) * a // 255).astype(np.uint8)
    return out
