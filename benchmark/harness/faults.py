"""Faults planted under the timed path, for the benchmark's own tests and
readings: each wraps a cell's entry (a callable from a list of images to
[(avif bytes or None, error)]) and breaks what it returns as a faulty
program would. The check has to find every one of them. No run from the
command line plants any."""

from __future__ import annotations


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


FAULTS = {"stale": stale, "half": half, "flip": flip}

# The control: the program's own path one precision below what the
# configuration states (8-bit samples for its 10-bit depth).
CONTROLS = {"depth8": {"depth": "Eight"}}
