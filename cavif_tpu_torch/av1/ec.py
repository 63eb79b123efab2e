"""AV1 multi-symbol entropy coder (daala EC / bool coder of the AV1 spec).

This is the host-side reference implementation: an encoder producing bits the
AV1 spec's symbol decoder (spec 8.2.2-8.2.6) accepts, and a mirror decoder
used for round-trip tests. CDFs use libaom's "inverted" layout: an N-symbol
CDF is an array of N uint16 where icdf[s] = 32768 - P(X <= s)*32768, strictly
decreasing with icdf[N-1] == 0. An optional extra slot icdf[N] is the
adaptation counter.

The reference delegates this to rav1e's EC; in the TPU-native design the
device emits (cdf_id, symbol) streams per tile and this coder (Python here, a
C++ port for the production path) serializes each tile independently — AV1
tiles are entropy-independent, so tile-level parallelism is exact.
Ref parity: rav1e's od_ec, exercised via /root/reference/ravif/src/
av1encoder.rs:748-771 (Context::receive_packet).
"""

from __future__ import annotations

from typing import Sequence

EC_PROB_SHIFT = 6
EC_MIN_PROB = 4
PROB_TOP = 1 << 15


def _interval(rng: int, icdf_s: int, n_minus_1_minus_s: int) -> int:
    """The spec's subinterval endpoint: ((rng>>8)*(icdf>>6)>>1) + 4*(N-1-s)."""
    return (((rng >> 8) * (icdf_s >> EC_PROB_SHIFT)) >> (7 - EC_PROB_SHIFT)) + (
        EC_MIN_PROB * n_minus_1_minus_s
    )


class RangeEncoder:
    """Arithmetic encoder, an exact mirror of libaom's od_ec_enc.

    State: a 32-bit `low` window aligned with `rng` (15-16 bits), a bit
    counter `cnt` (starts at -9; the daala convention reserving one
    terminating bit), and a precarry buffer of 9-bit entries flushed one or
    two bytes at a time during renormalization. done() emits the canonical
    termination (round the window up to a 2^14 multiple with bit 14 set) —
    libaom's decoder is strict about this exact form, so byte-for-byte
    parity with od_ec_enc is required (verified differentially against the
    system libaom in tests/test_ec.py).
    """

    def __init__(self) -> None:
        self.precarry: list[int] = []
        self.low = 0
        self.rng = PROB_TOP
        self.cnt = -9

    def _normalize(self, low: int, rng: int) -> None:
        d = 16 - rng.bit_length()
        s = self.cnt + d
        if s >= 0:
            c = self.cnt
            m = (1 << (c + 16)) - 1
            if s > 7:
                self.precarry.append((low >> (c + 16)) & 0xFFFF)
                low &= m
                c -= 8
                m >>= 8
            self.precarry.append((low >> (c + 16)) & 0xFFFF)
            low &= m
            s = c + d - 8
        self.low = (low << d) & 0xFFFFFFFF
        self.rng = rng << d
        self.cnt = s

    def encode_symbol(self, s: int, icdf: Sequence[int]) -> None:
        n = len(icdf)
        r = self.rng
        low = self.low
        v = _interval(r, icdf[s], n - 1 - s)
        if s > 0:
            u = _interval(r, icdf[s - 1], n - s)
            low += r - u
            r = u - v
        else:
            r -= v
        self._normalize(low, r)

    def encode_literal(self, value: int, bits: int) -> None:
        """Equiprobable bits, MSB first (spec L(n): bool with p=1/2)."""
        for i in range(bits - 1, -1, -1):
            self.encode_symbol((value >> i) & 1, _LITERAL_ICDF)

    # -- finalization --------------------------------------------------------

    def done(self) -> bytes:
        c = self.cnt
        s = c + 10
        out = list(self.precarry)
        if s > 0:
            m = (1 << (c + 16)) - 1
            e = ((self.low + 0x3FFF) & ~0x3FFF) | 0x4000
            while s > 0:
                out.append((e >> (c + 16)) & 0xFFFF)
                e &= m
                s -= 8
                c -= 8
                m >>= 8
        # propagate precarry from the last entry upward
        data = bytearray(len(out))
        carry = 0
        for i in range(len(out) - 1, -1, -1):
            v = out[i] + carry
            data[i] = v & 0xFF
            carry = v >> 8
        assert carry == 0 or len(out) == 0
        return bytes(data) if data else b"\x00"

    def tell_bits(self) -> int:
        return len(self.precarry) * 8 + self.cnt + 10


_LITERAL_ICDF = (PROB_TOP >> 1, 0)


class RangeDecoder:
    """Mirror of the spec's symbol decoder (8.2.2-8.2.6), bitwise renorm."""

    def __init__(self, data: bytes) -> None:
        self.data = data
        self.bitpos = 0
        self.rng = PROB_TOP
        val = 0
        for _ in range(15):
            val = (val << 1) | self._read_bit()
        self.val = ((1 << 15) - 1) ^ val  # complement domain

    def _read_bit(self) -> int:
        p = self.bitpos
        self.bitpos += 1
        if (p >> 3) >= len(self.data):
            return 0
        return (self.data[p >> 3] >> (7 - (p & 7))) & 1

    def decode_symbol(self, icdf: Sequence[int]) -> int:
        n = len(icdf)
        s = -1
        cur = self.rng
        prev = cur
        while True:
            s += 1
            prev = cur
            cur = _interval(self.rng, icdf[s], n - 1 - s)
            if self.val >= cur:
                break
        self.rng = prev - cur
        self.val -= cur
        while self.rng < PROB_TOP:
            self.rng <<= 1
            self.val = (self.val << 1) | (1 - self._read_bit())
        return s

    def decode_literal(self, bits: int) -> int:
        v = 0
        for _ in range(bits):
            v = (v << 1) | self.decode_symbol(_LITERAL_ICDF)
        return v


def update_cdf(cdf: list[int], val: int, nsymbs: int) -> None:
    """In-place adaptive CDF update (spec 8.2.6 update_cdf), icdf domain.

    `cdf` has nsymbs+1 entries; the last is the adaptation counter.
    """
    count = cdf[nsymbs]
    rate = 3 + (count > 15) + (count > 31) + min(nsymbs.bit_length() - 1, 2)
    tmp = PROB_TOP
    for i in range(nsymbs - 1):
        if i == val:
            tmp = 0
        if tmp < cdf[i]:
            cdf[i] -= (cdf[i] - tmp) >> rate
        else:
            cdf[i] += (tmp - cdf[i]) >> rate
    cdf[nsymbs] = count + (count < 32)
