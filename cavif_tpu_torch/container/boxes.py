"""Minimal ISOBMFF box writer primitives."""

from __future__ import annotations

import struct


def box(fourcc: str, payload: bytes) -> bytes:
    """A plain box: u32 size (including header) + fourcc + payload."""
    assert len(fourcc) == 4
    return struct.pack(">I", 8 + len(payload)) + fourcc.encode("ascii") + payload


def full_box(fourcc: str, version: int, flags: int, payload: bytes) -> bytes:
    """A full box: version byte + 24-bit flags before the payload."""
    return box(fourcc, struct.pack(">B", version) + struct.pack(">I", flags)[1:] + payload)


def u8(v: int) -> bytes:
    return struct.pack(">B", v)


def u16(v: int) -> bytes:
    return struct.pack(">H", v)


def u32(v: int) -> bytes:
    return struct.pack(">I", v)


def fourcc(s: str) -> bytes:
    assert len(s) == 4
    return s.encode("ascii")
