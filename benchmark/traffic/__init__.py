"""The benchmark's frozen image generators, found by the name a
configuration's `image.generator` gives (see `generate`)."""

from __future__ import annotations

import importlib


def generate(spec: dict, seed: int, count: int, device: str) -> list:
    """`count` images of the configuration's `image` spec from `seed`: a
    list of (H, W, C) uint8 numpy arrays, the same for the same seed on
    the same device. The generator is the module of this package named by
    `spec["generator"]`."""
    mod = importlib.import_module(f"{__name__}.{spec['generator']}")
    return mod.images(spec, seed, count, device)
