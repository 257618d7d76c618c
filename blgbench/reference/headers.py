# Frozen copy of brotlig_tpu_torch/format/headers.py at commit 5a3fdcdf7cdd; unchanged.
"""Container headers and page table (ref: inc/DataStream.h): the port's
copy of brotlig_tpu/format/headers.py, packing and parsing.

Byte layout matches the reference's memcpy'd C structs (MSVC little-endian
bitfields, LSB-first allocation):

StreamHeader (8 B):  u8 Id; u8 Magic(=Id^0xFF); u16 NumPages;
                     u32 bits { PageSizeIdx:2 | LastPageSize:18 |
                                Preconditioned:1 | Reserved:11 }
PreconditionHeader (8 B):
                     u32 bits { Swizzled:1 | PitchD3D12Aligned:1 |
                                WidthInBlocks-1:15 | HeightInBlocks-1:15 }
                     u32 bits { Format:8 | NumMips-1:5 | PitchInBytes-1:19 }
PageTable: NumPages x u32; entry[i>0] = byte offset of page i within the
data area, entry[0] = compressed size of the LAST page
(ref: BrotligEncoder.cpp:500-517, BrotligDecoder.cpp:150-151).
"""
from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

from . import constants as C
from .errors import CorruptStream, IncorrectStreamFormat, TooManyPages
from .precondition import DataConditionParams


@dataclass
class StreamHeader:
    num_pages: int
    page_size_idx: int
    last_page_size: int
    preconditioned: bool

    @property
    def page_size(self) -> int:
        return C.MIN_PAGE_SIZE << self.page_size_idx

    @property
    def uncompressed_size(self) -> int:
        ps = self.page_size
        return self.num_pages * ps - (0 if self.last_page_size == 0
                                      else ps - self.last_page_size)

    @classmethod
    def for_input(cls, input_size: int, page_size: int,
                  preconditioned: bool) -> "StreamHeader":
        num_pages, last = divmod(input_size, page_size)
        if last:
            num_pages += 1
        if num_pages > C.MAX_NUM_PAGES:
            raise TooManyPages("input too large for 16-bit page count")
        return cls(num_pages, C.page_size_index(page_size), last,
                   preconditioned)

    def pack(self) -> bytes:
        bits = (self.page_size_idx
                | (self.last_page_size << 2)
                | (int(self.preconditioned) << 20))
        return struct.pack("<BBHI", C.STREAM_ID, C.STREAM_ID ^ 0xFF,
                           self.num_pages, bits)

    @classmethod
    def unpack(cls, data: bytes) -> "StreamHeader":
        sid, magic, num_pages, bits = struct.unpack_from("<BBHI", data, 0)
        if sid != (magic ^ 0xFF):
            raise CorruptStream("corrupt stream: bad magic")
        if sid != C.STREAM_ID:
            raise IncorrectStreamFormat("incorrect stream format id")
        return cls(num_pages, bits & 0x3, (bits >> 2) & ((1 << 18) - 1),
                   bool((bits >> 20) & 1))


@dataclass
class PreconditionHeader:
    swizzled: bool
    pitch_d3d12_aligned: bool
    width_in_blocks: int
    height_in_blocks: int
    data_format: int
    num_mips: int
    pitch_in_bytes: int

    def pack(self) -> bytes:
        w0 = (int(self.swizzled)
              | (int(self.pitch_d3d12_aligned) << 1)
              | ((self.width_in_blocks - 1) << 2)
              | ((self.height_in_blocks - 1) << 17))
        w1 = (self.data_format
              | ((self.num_mips - 1) << 8)
              | ((self.pitch_in_bytes - 1) << 13))
        return struct.pack("<II", w0, w1)

    @classmethod
    def unpack(cls, data: bytes) -> "PreconditionHeader":
        w0, w1 = struct.unpack_from("<II", data, 0)
        return cls(
            swizzled=bool(w0 & 1),
            pitch_d3d12_aligned=bool((w0 >> 1) & 1),
            width_in_blocks=((w0 >> 2) & 0x7FFF) + 1,
            height_in_blocks=((w0 >> 17) & 0x7FFF) + 1,
            data_format=w1 & 0xFF,
            num_mips=((w1 >> 8) & 0x1F) + 1,
            pitch_in_bytes=((w1 >> 13) & 0x7FFFF) + 1,
        )


def pack_page_table(page_sizes) -> bytes:
    """Compressed page sizes -> on-disk page table."""
    sizes = np.asarray(page_sizes, dtype=np.int64)
    table = np.zeros(len(sizes), dtype=np.uint32)
    if len(sizes) > 1:
        table[1:] = np.cumsum(sizes[:-1])
    table[0] = sizes[-1]  # quirk: entry 0 holds the last page's size
    return table.tobytes()


def unpack_page_table(data: bytes, num_pages: int):
    """On-disk page table -> (offsets, sizes) of each compressed page."""
    table = np.frombuffer(data, dtype=np.uint32, count=num_pages)
    offsets = table.astype(np.int64).copy()
    offsets[0] = 0
    sizes = np.empty(num_pages, dtype=np.int64)
    if num_pages > 1:
        sizes[:-1] = offsets[1:] - offsets[:-1]
    sizes[-1] = int(table[0])
    return offsets, sizes


@dataclass
class ContainerInfo:
    """Fully parsed and validated container layout.

    offsets/sizes are absolute byte positions into the original blob;
    page_out_sizes[i] is page i's decompressed size (last-page rule);
    dc_params is initialized when the stream is preconditioned."""
    header: StreamHeader
    dc_params: DataConditionParams | None
    offsets: np.ndarray
    sizes: np.ndarray
    payload_base: int
    page_out_sizes: list
    out_size: int

    def raw_page_indices(self):
        return [i for i in range(self.header.num_pages)
                if int(self.sizes[i]) == self.page_out_sizes[i]]

    def compressed_page_indices(self):
        return [i for i in range(self.header.num_pages)
                if int(self.sizes[i]) != self.page_out_sizes[i]]


def parse_container(data: bytes) -> ContainerInfo:
    """Parse and validate a Brotli-G container's framing (headers +
    precondition geometry + page table; mirrors BrotligDecoder.cpp:437-482
    and the native decoder's table bounds check, brotlig_core.cpp:436-439).
    Raises CorruptStream on any out-of-bounds table entry."""
    if len(data) < C.STREAM_HEADER_SIZE_BYTES:
        raise CorruptStream("truncated stream header")
    header = StreamHeader.unpack(data)
    pos = C.STREAM_HEADER_SIZE_BYTES

    dc_params = None
    if header.preconditioned:
        if len(data) < pos + C.PRECON_HEADER_SIZE_BYTES:
            raise CorruptStream("truncated precondition header")
        ph = PreconditionHeader.unpack(data[pos:])
        pos += C.PRECON_HEADER_SIZE_BYTES
        dc_params = DataConditionParams(
            precondition=True, swizzle=ph.swizzled, format=ph.data_format,
            num_mip_levels=ph.num_mips,
            pitch_d3d12_aligned=ph.pitch_d3d12_aligned)
        dc_params.width_in_blocks[0] = ph.width_in_blocks
        dc_params.height_in_blocks[0] = ph.height_in_blocks
        dc_params.pitch_in_bytes[0] = ph.pitch_in_bytes

    num_pages = header.num_pages
    page_size = header.page_size
    out_size = header.uncompressed_size
    if dc_params is not None and not dc_params.initialize(out_size):
        # header geometry inconsistent with the claimed output size
        raise CorruptStream("precondition geometry does not match size")
    if num_pages == 0:
        return ContainerInfo(header, dc_params,
                             np.zeros(0, np.int64), np.zeros(0, np.int64),
                             pos, [], out_size)
    if len(data) < pos + num_pages * 4:
        raise CorruptStream("truncated page table")
    offsets, sizes = unpack_page_table(data[pos:], num_pages)
    payload_base = pos + num_pages * 4
    payload_len = len(data) - payload_base
    if (np.any(sizes < 0) or np.any(offsets < 0)
            or np.any(offsets + sizes > payload_len)
            or np.any(sizes > page_size)):
        raise CorruptStream("page table out of bounds")
    page_out_sizes = [
        header.last_page_size if (i == num_pages - 1
                                  and header.last_page_size) else page_size
        for i in range(num_pages)]
    return ContainerInfo(header, dc_params, offsets + payload_base,
                         sizes, payload_base, page_out_sizes, out_size)
