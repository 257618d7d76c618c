"""The benchmark's plain Brotli-G decoder: a frozen copy of the port's
scalar decoder, which judges the containers the timed path makes.

Copied at commit 5a3fdcdf7cdd from brotlig_tpu_torch/refimpl/
page_decoder.py (imports rewritten) and brotlig_tpu_torch/format/
{constants,errors,lut,bitio,huffman,rle,swizzle,headers,precondition}.py
(unchanged); `decode` below is brotlig_tpu_torch/refimpl/codec.py's
`decode`, with its imports rewritten. Python and NumPy only: it imports
nothing of brotlig_tpu_torch, brotlig_tpu or jax, so a later change to
the port cannot change the judge.
"""
from __future__ import annotations

from . import constants as C
from .headers import PreconditionHeader, StreamHeader, unpack_page_table
from .page_decoder import decode_page
from .precondition import (DataConditionParams, decondition,
                           delta_decode_page)


def decode(data: bytes) -> bytes:
    """Decompress a Brotli-G container with the scalar page decoder."""
    header = StreamHeader.unpack(data)
    pos = C.STREAM_HEADER_SIZE_BYTES

    dc_params = None
    if header.preconditioned:
        ph = PreconditionHeader.unpack(data[pos:])
        pos += C.PRECON_HEADER_SIZE_BYTES
        dc_params = DataConditionParams(
            precondition=True,
            swizzle=ph.swizzled,
            format=ph.data_format,
            num_mip_levels=ph.num_mips,
            pitch_d3d12_aligned=ph.pitch_d3d12_aligned,
        )
        dc_params.width_in_blocks[0] = ph.width_in_blocks
        dc_params.height_in_blocks[0] = ph.height_in_blocks
        dc_params.pitch_in_bytes[0] = ph.pitch_in_bytes

    num_pages = header.num_pages
    if num_pages == 0:
        return b""
    page_size = header.page_size
    out_size = header.uncompressed_size
    if header.preconditioned:
        dc_params.initialize(out_size)

    offsets, sizes = unpack_page_table(data[pos:], num_pages)
    pos += num_pages * 4
    payload = data[pos:]

    out = bytearray()
    for i in range(num_pages):
        page_out_size = (header.last_page_size
                         if (i == num_pages - 1 and header.last_page_size)
                         else page_size)
        page_data = payload[int(offsets[i]): int(offsets[i]) + int(sizes[i])]
        page, isdelta = decode_page(page_data, page_out_size)
        if isdelta and dc_params is not None:
            page = delta_decode_page(page, i * page_size, dc_params)
        out += page

    if header.preconditioned:
        return decondition(bytes(out), dc_params)
    return bytes(out[:out_size])
