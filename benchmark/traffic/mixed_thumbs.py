"""Mixed thumbnails: four sizes from 256x384 to 512x768, every 8th image
RGBA with a live alpha region.

A frozen copy of the port's `tools/batch512_bench.py` `make_images`, with
its generator seeded from the run's seed instead of 11. No cell of the
benchmark uses it yet: it is here so that a later cell on this traffic
(listed in PERF.md) can be added as data files alone; the reference
judges its RGBA images' alpha items.

The spec may set `shapes` ([[H, W], ...], taken in turn) and
`alpha_every` (8 unless it says; 0 for none): image i is RGBA where
i % alpha_every == 3 % alpha_every, so 8 gives the copy's images 3, 11,
19, ... and 1 makes every image RGBA with the same live-alpha rule.
"""

from __future__ import annotations

import numpy as np

SHAPES = ((384, 512), (512, 512), (256, 384), (512, 768))


def images(spec: dict, seed: int, count: int, device: str) -> list:
    shapes = [tuple(s) for s in spec.get("shapes", SHAPES)]
    every = int(spec.get("alpha_every", 8))
    rng = np.random.default_rng(int(seed))
    out = []
    for i in range(count):
        h, w = shapes[i % len(shapes)]
        y, x = np.mgrid[0:h, 0:w].astype(np.float64)
        base = (120 + 70 * np.sin(x / (37 + 13 * (i % 7)))
                * np.cos(y / (53 + 7 * (i % 5))))
        lum = np.clip(base + rng.normal(0, 5, (h, w)), 0, 255)
        img = np.stack([np.clip(lum + 12, 0, 255), lum,
                        np.clip(lum - 15, 0, 255)], axis=-1).astype(np.uint8)
        if every and i % every == 3 % every:
            a = np.full((h, w), 255, np.uint8)
            a[h // 4: h // 2, w // 4: 3 * w // 4] = rng.integers(
                0, 255, (h // 4, w // 2), np.uint8)
            img = np.dstack([img, a])
        out.append(np.ascontiguousarray(img))
    return out
