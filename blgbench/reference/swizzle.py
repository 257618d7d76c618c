# Frozen copy of brotlig_tpu_torch/format/swizzle.py at commit 5a3fdcdf7cdd; unchanged.
"""32-way sub-bitstream serialization (the "swizzle" of Brotli-G).

Encoder side (Swizzler): 32 independent LSB bit writers plus a header
writer; symbols are appended round-robin. Finalization computes the
self-describing size table whose field widths depend on the total compressed
size — a fixed-point iteration (ref: BrotligSwizzler.cpp:68-142) — then
emits header DWORDs followed by the streams concatenated byte-aligned and
padded to a DWORD boundary (ref: BrotligSwizzler.cpp:144-189).

Decoder side (Deswizzler): 32 bit readers over the concatenated streams with
the same round-robin schedule (ref: inc/common/BrotligDeswizzler.h).

The port's copy of brotlig_tpu/format/swizzle.py, unchanged in behaviour.
"""
from __future__ import annotations

from . import constants as C
from .bitio import BitReaderLSB, BitWriterLSB


class Swizzler:
    def __init__(self, num_bitstreams: int = C.NUM_BITSTREAMS):
        self.num_bitstreams = num_bitstreams
        self.writers = [BitWriterLSB() for _ in range(num_bitstreams)]
        self.header = BitWriterLSB()
        self.cur = 0

    # --- round-robin appends ---
    def append(self, n_bits: int, value: int, bs_switch: bool = False):
        self.writers[self.cur].write(n_bits, value)
        if bs_switch:
            self.bs_switch()

    def bs_switch(self):
        self.cur += 1
        if self.cur == self.num_bitstreams:
            self.cur = 0

    def bs_reset(self):
        self.cur = 0

    def append_to_header(self, n_bits: int, value: int):
        self.header.write(n_bits, value)

    # --- finalization ---
    def append_bitstream_sizes(self):
        """Write the size table into the header (fixed-point field widths)."""
        nbs = self.num_bitstreams
        lens = [w.nbytes() for w in self.writers]
        tot = sum(lens)
        min_size = min(lens)
        offsets = [ln - min_size for ln in lens]

        delta_size_bits = 1
        for off in offsets:
            width = off.bit_length() if off else 1
            delta_size_bits = max(delta_size_bits, width)

        header_bits = self.header.bitpos
        est = ((header_bits + 7) // 8 + 3) // 4 * 4 + tot
        while True:
            r_avg = (est + nbs - 1) // nbs
            base_size_bits = r_avg.bit_length()
            log_size = (est - 1).bit_length()
            delta_bits_size_bits = log_size.bit_length()
            new_header_bits = (header_bits + base_size_bits
                               + delta_bits_size_bits + nbs * delta_size_bits)
            new_est = ((new_header_bits + 7) // 8 + 3) // 4 * 4 + tot
            new_r_avg = (new_est + nbs - 1) // nbs
            stable = ((new_est - 1).bit_length() == (est - 1).bit_length()
                      and new_r_avg.bit_length() == base_size_bits)
            if stable:
                break
            est = new_est

        self.header.write(base_size_bits, min_size)
        self.header.write(delta_bits_size_bits, delta_size_bits)
        for off in offsets:
            self.header.write(delta_size_bits, off)
        self.header.align_to_dword()

    def serialize(self) -> bytes:
        """Header DWORDs + concatenated streams, padded to DWORD size."""
        out = bytearray(self.header.getvalue())
        assert len(out) % 4 == 0
        for w in self.writers:
            out.extend(w.getvalue())
        while len(out) % 4:
            out.append(0)
        return bytes(out)


class Deswizzler:
    """Round-robin bit reader over the page's concatenated sub-streams.

    Readers address the whole padded page buffer at absolute bit positions;
    reads past a stream's end return whatever follows (garbage-tolerant, as
    in the reference which reads into the adjacent stream / slack bytes).
    """

    def __init__(self, data: bytes, stream_offsets, num_bitstreams: int
                 = C.NUM_BITSTREAMS):
        # pad so reads beyond the end never fail
        self.data = bytes(data) + b"\x00" * 16
        self.readers = [BitReaderLSB(self.data, off * 8)
                        for off in stream_offsets]
        self.num_bitstreams = num_bitstreams
        self.cur = 0

    def read(self, n_bits: int) -> int:
        return self.readers[self.cur].read(n_bits)

    def peek(self, n_bits: int) -> int:
        return self.readers[self.cur].peek(n_bits)

    def consume(self, n_bits: int) -> None:
        self.readers[self.cur].consume(n_bits)

    def bs_switch(self):
        self.cur += 1
        if self.cur == self.num_bitstreams:
            self.cur = 0

    def bs_reset(self):
        self.cur = 0
