"""Copy of ``selkies_tpu/utils/bits.py``, kept so the port imports nothing of the JAX package.

Bit-exact bitstream writer/reader for video codec syntax.

Used by the host-side header writers (SPS/PPS/slice headers) and the pure
Python CAVLC packer (the C++ packer in native/ mirrors this byte-for-byte).
MSB-first bit order as required by H.264/HEVC/VP9 bitstream syntax.
"""

from __future__ import annotations

__all__ = ["BitWriter", "BitReader", "emulation_prevent", "annexb_nal"]


class BitWriter:
    """MSB-first bit accumulator with Exp-Golomb helpers."""

    def __init__(self) -> None:
        self._buf = bytearray()
        self._acc = 0  # bits accumulated, MSB-aligned within _nbits
        self._nbits = 0

    def write_bits(self, value: int, nbits: int) -> None:
        if nbits < 0 or value < 0 or value >> nbits:
            raise ValueError(f"value {value} does not fit in {nbits} bits")
        self._acc = (self._acc << nbits) | (value & ((1 << nbits) - 1))
        self._nbits += nbits
        while self._nbits >= 8:
            self._nbits -= 8
            self._buf.append((self._acc >> self._nbits) & 0xFF)
        self._acc &= (1 << self._nbits) - 1

    def write_bit(self, bit: int) -> None:
        self.write_bits(bit & 1, 1)

    def write_ue(self, value: int) -> None:
        """Unsigned Exp-Golomb (ue(v))."""
        if value < 0:
            raise ValueError("ue(v) requires non-negative value")
        code = value + 1
        nbits = code.bit_length()
        self.write_bits(0, nbits - 1)
        self.write_bits(code, nbits)

    def write_se(self, value: int) -> None:
        """Signed Exp-Golomb (se(v)): 1→1, -1→2, 2→3, -2→4 ..."""
        self.write_ue(2 * value - 1 if value > 0 else -2 * value)

    @property
    def bit_position(self) -> int:
        return len(self._buf) * 8 + self._nbits

    def byte_align(self, bit: int = 0) -> None:
        while self._nbits % 8:
            self.write_bit(bit)

    def rbsp_trailing_bits(self) -> None:
        self.write_bit(1)
        self.byte_align(0)

    def get_bytes(self) -> bytes:
        if self._nbits:
            raise ValueError(f"bitstream not byte aligned ({self._nbits} bits pending)")
        return bytes(self._buf)

    def get_partial(self) -> tuple[bytes, int]:
        """(buffer including a zero-padded partial last byte, total bit count).

        Used to hand an unaligned prefix (e.g. a slice header) to the C++
        packer, which continues appending at the exact bit position.
        """
        total_bits = self.bit_position
        if self._nbits:
            last = (self._acc << (8 - self._nbits)) & 0xFF
            return bytes(self._buf) + bytes([last]), total_bits
        return bytes(self._buf), total_bits


class BitReader:
    """MSB-first reader, for tests and the conformance mini-decoder."""

    def __init__(self, data: bytes) -> None:
        self._data = data
        self.pos = 0  # bit position

    def read_bits(self, nbits: int) -> int:
        value = 0
        for _ in range(nbits):
            byte = self._data[self.pos >> 3]
            value = (value << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return value

    def read_bit(self) -> int:
        return self.read_bits(1)

    def read_ue(self) -> int:
        zeros = 0
        while self.read_bit() == 0:
            zeros += 1
            if zeros > 63:
                raise ValueError("malformed ue(v)")
        return (1 << zeros) - 1 + (self.read_bits(zeros) if zeros else 0)

    def read_se(self) -> int:
        k = self.read_ue()
        return (k + 1) // 2 if k % 2 else -(k // 2)

    @property
    def bits_left(self) -> int:
        return len(self._data) * 8 - self.pos


def emulation_prevent(rbsp: bytes) -> bytes:
    """Insert 0x03 after any 0x0000 followed by a byte <= 0x03 (H.264 7.4.1.1)."""
    out = bytearray()
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 0x03:
            out.append(0x03)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def annexb_nal(nal_ref_idc: int, nal_unit_type: int, rbsp: bytes, long_start: bool = True) -> bytes:
    """Wrap an RBSP payload as an Annex-B NAL unit with start code."""
    header = bytes([(nal_ref_idc << 5) | nal_unit_type])
    start = b"\x00\x00\x00\x01" if long_start else b"\x00\x00\x01"
    return start + header + emulation_prevent(rbsp)
