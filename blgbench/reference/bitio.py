# Frozen copy of brotlig_tpu_torch/format/bitio.py at commit 5a3fdcdf7cdd; unchanged.
"""LSB-first bit I/O used throughout the Brotli-G container.

Semantics match the reference writers/readers (inc/common/BrotligBitWriter.h,
inc/common/BrotligBitReader.h): bits fill each byte starting at bit 0, values
are written least-significant-bit first.

The port's copy of brotlig_tpu/format/bitio.py (without align_to_byte,
which the port does not call).
"""
from __future__ import annotations


class BitWriterLSB:
    """Append-only LSB-first bit writer over a growable bytearray."""

    def __init__(self):
        self.buf = bytearray()
        self.bitpos = 0  # total bits written

    def write(self, n_bits: int, value: int) -> None:
        if n_bits == 0:
            return
        value &= (1 << n_bits) - 1
        end_bit = self.bitpos + n_bits
        need = (end_bit + 7) // 8
        if need > len(self.buf):
            self.buf.extend(b"\x00" * (need - len(self.buf)))
        pos = self.bitpos
        # merge into existing bytes, LSB first
        acc = value << (pos & 7)
        idx = pos >> 3
        nbytes = ((pos & 7) + n_bits + 7) // 8
        for k in range(nbytes):
            self.buf[idx + k] |= (acc >> (8 * k)) & 0xFF
        self.bitpos = end_bit

    def align_to_dword(self) -> None:
        rem = self.bitpos % 32
        if rem:
            self.write(32 - rem, 0)

    def nbytes(self) -> int:
        return (self.bitpos + 7) // 8

    def getvalue(self) -> bytes:
        return bytes(self.buf[: self.nbytes()])


class BitReaderLSB:
    """LSB-first bit reader over a bytes-like object.

    Reads past the end of the buffer return zero bits (the reference relies on
    allocation slack for the same effect).
    """

    def __init__(self, data, bitpos: int = 0):
        self.data = data
        self.bitpos = bitpos

    def peek(self, n_bits: int) -> int:
        if n_bits == 0:
            return 0
        pos = self.bitpos
        idx = pos >> 3
        shift = pos & 7
        nbytes = (shift + n_bits + 7) // 8
        chunk = self.data[idx: idx + nbytes]
        acc = int.from_bytes(chunk, "little")
        return (acc >> shift) & ((1 << n_bits) - 1)

    def consume(self, n_bits: int) -> None:
        self.bitpos += n_bits

    def read(self, n_bits: int) -> int:
        v = self.peek(n_bits)
        self.bitpos += n_bits
        return v
