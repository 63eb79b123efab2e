"""Faults planted under the timed path, for the benchmark's own tests and
readings: each wraps a cell's entry (a callable from a list of images to
[(avif bytes or None, error)]) and breaks what it returns as a faulty
program would. The check has to find every one of them. No run from the
command line plants any."""

from __future__ import annotations

import numpy as np


def stale(entry):
    """A step that returns its state unchanged: every call does its work
    and then answers with the first call's files."""
    first = []

    def call(images):
        got = entry(images)
        if not first:
            first.append(got)
        got = first[0]
        return [got[i % len(got)] for i in range(len(images))]
    return call


def half(entry):
    """Half of the batch left out: only the first half of each list is
    encoded, and its files stand in for the rest."""
    def call(images):
        k = max(1, len(images) // 2)
        got = entry(images[:k])
        return [got[i % k] for i in range(len(images))]
    return call


def flip(entry):
    """An answer altered where it is produced: 64 bytes in the middle of
    each file's coded payload inverted."""
    def call(images):
        out = []
        for b, err in entry(images):
            if b is not None:
                buf = bytearray(b)
                mid = len(buf) - max(64, (len(buf) // 4))
                for i in range(mid, min(len(buf), mid + 64)):
                    buf[i] ^= 0xFF
                b = bytes(buf)
            out.append((b, err))
        return out
    return call


def _alpha(entry, change):
    """The entry with each RGBA image of a list changed by `change` first."""
    def call(images):
        return entry([change(im) if im.shape[2] == 4 else im
                      for im in images])
    return call


def alpha_drop(entry):
    """The alpha left out: each RGBA image answered with the file of its
    colour alone, by making it opaque first (ravif codes an opaque image
    without alpha), so that an entry of 4-channel images takes it too."""
    return _alpha(entry, lambda im: np.dstack(
        [im[..., :3], np.full(im.shape[:2], 255, np.uint8)]))


def alpha_invert(entry):
    """The alpha turned over: each RGBA image encoded with alpha 255 - a."""
    return _alpha(entry, lambda im: np.dstack([im[..., :3], 255 - im[..., 3]]))


FAULTS = {"stale": stale, "half": half, "flip": flip,
          "alpha_drop": alpha_drop, "alpha_invert": alpha_invert}

# The controls: the program's own path one precision below what the
# configuration states (8-bit samples for its 10-bit depth), and, for
# RGBA inputs, the alpha plane coded at lower qualities than cavif's 90
# for Q80 (80 is the library's default, the colour's quality).
CONTROLS = {"depth8": {"depth": "Eight"},
            "alpha_q80": {"alpha_quality": 80},
            "alpha_q60": {"alpha_quality": 60}}
