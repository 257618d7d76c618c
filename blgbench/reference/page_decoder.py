# Frozen copy of brotlig_tpu_torch/refimpl/page_decoder.py at commit 5a3fdcdf7cdd; imports rewritten.
"""Scalar (NumPy/Python) Brotli-G page decoder — the correctness oracle.

Mirrors the reference CPU decoder semantics exactly
(src/decoder/PageDecoder.cpp:65-404). The port's copy of
brotlig_tpu/refimpl/page_decoder.py: its tests decode the preconditioned
host encode's pages with it, apart from the native decoder.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import constants as C
from . import lut
from .bitio import BitReaderLSB
from .huffman import build_decode_table, load_table_lengths, \
    reverse_bits
from .swizzle import Deswizzler


@dataclass
class DecodedTable:
    symbols: np.ndarray  # uint16[2^15]
    lens: np.ndarray     # uint8[2^15]


def _load_table(reader: Deswizzler, alphabet_size: int) -> DecodedTable:
    lengths, trivial_sym = load_table_lengths(reader, alphabet_size)
    if trivial_sym is not None:
        syms = np.full(C.HUFFMAN_TABLE_SIZE, trivial_sym, dtype=np.uint16)
        lens = np.zeros(C.HUFFMAN_TABLE_SIZE, dtype=np.uint8)
        return DecodedTable(syms, lens)
    syms, lens = build_decode_table(lengths, C.HUFFMAN_TABLE_BITS)
    return DecodedTable(syms, lens)


def _decode_symbol(reader: Deswizzler, table: DecodedTable) -> int:
    window = reader.peek(C.HUFFMAN_TABLE_BITS)
    idx = reverse_bits(window, C.HUFFMAN_TABLE_BITS)
    reader.consume(int(table.lens[idx]))
    return int(table.symbols[idx])


def parse_page_header(data: bytes):
    """Page header + bitstream size table -> (npostfix, ndirect, isdelta,
    stream byte offsets)."""
    input_size = len(data)
    br = BitReaderLSB(data)
    npostfix = br.read(C.PAGE_HEADER_NPOSTFIX_BITS)
    ndbits = br.read(C.PAGE_HEADER_NDIST_BITS)
    ndirect = ndbits << npostfix
    isdelta = bool(br.read(C.PAGE_HEADER_ISDELTAENCODED_BITS))
    br.consume(1)

    nbs = C.NUM_BITSTREAMS
    r_avg = (input_size + nbs - 1) // nbs
    base_size_bits = r_avg.bit_length()
    delta_bits_size_bits = (input_size - 1).bit_length().bit_length()

    base_size = br.read(base_size_bits)
    delta_size_bits = br.read(delta_bits_size_bits)
    header_bits = (C.PAGE_HEADER_SIZE_BITS + base_size_bits
                   + delta_bits_size_bits + nbs * delta_size_bits)
    header_bits = (header_bits + 31) // 32 * 32

    offsets = []
    pos = header_bits // 8
    for _ in range(nbs):
        delta = br.read(delta_size_bits)
        offsets.append(pos)
        pos += base_size + delta
    return npostfix, ndirect, isdelta, offsets


def decode_page(data: bytes, output_size: int):
    """Decode one compressed page.

    Returns (page_bytes, isdelta). Raw pages (len(data) == output_size) are
    returned as-is with isdelta=False (ref: PageDecoder.cpp:70-76).
    """
    if len(data) == output_size:
        return bytes(data), False

    npostfix, ndirect, isdelta, offsets = parse_page_header(data)
    reader = Deswizzler(data, offsets)

    icp = _load_table(reader, C.NUM_COMMAND_SYMBOLS_EFFECTIVE)
    dist = _load_table(reader, C.NUM_DISTANCE_SYMBOLS)
    lit = _load_table(reader, C.NUM_LITERAL_SYMBOLS)

    ring = list(C.DISTANCE_RING_INIT)
    out = bytearray(output_size)
    wpos = 0
    nbs = C.NUM_BITSTREAMS
    prev_tail = 0
    lit_queue = bytearray()
    lq_front = 0
    found_sentinel = False
    max_rounds = output_size // 2 + 34  # commands cover >= 2 bytes each

    while not found_sentinel:
        max_rounds -= 1
        if max_rounds < 0:
            raise ValueError("corrupt stream: no sentinel")
        litcount = 0
        bs_processed = 0
        cmds = []  # (insert_len, copy_len, distance)

        while bs_processed != nbs:
            cmd_prefix = _decode_symbol(reader, icp)
            if cmd_prefix <= C.NUM_COMMAND_SYMBOLS:
                insert_len = int(lut.CMD_INSERT_BASE[cmd_prefix])
                copy_len = int(lut.CMD_COPY_BASE[cmd_prefix])
                if insert_len == 0 and copy_len == 0:
                    found_sentinel = True
                    break
                insert_len += reader.read(int(lut.CMD_INSERT_EXTRA[cmd_prefix]))
                copy_len += reader.read(int(lut.CMD_COPY_EXTRA[cmd_prefix]))
                if cmd_prefix >= 128:
                    dist_code = _decode_symbol(reader, dist)
                else:
                    dist_code = 0
                # translate distance (ref: PageDecoder.cpp:345-404)
                if dist_code == 0:
                    d = ring[0]
                elif dist_code < 4:
                    d = ring[dist_code]
                elif dist_code < 16:
                    idx = (dist_code - 4) // 6  # 4..9 -> ring0, 10..15 -> ring1
                    delta = ((dist_code - 4) % 6 // 2) + 1
                    sign = 1 if (dist_code & 1) else -1
                    d = ring[idx] + sign * delta
                else:
                    nextra = lut.distance_symbol_extra_bits(
                        dist_code, npostfix, ndirect)
                    extra = reader.read(nextra)
                    d = lut.decode_distance_symbol(
                        dist_code, extra, npostfix, ndirect)
                if dist_code > 0:
                    ring = [d, ring[0], ring[1], ring[2]]
            else:
                insert_code = cmd_prefix - C.NUM_COMMAND_SYMBOLS
                nextra = int(lut.INSERT_EXTRA[insert_code])
                insert_len = int(lut.INSERT_BASE[insert_code]) + \
                    reader.read(nextra)
                copy_len = 0
                d = 0
            litcount += insert_len
            cmds.append((insert_len, copy_len, d))
            bs_processed += 1
            reader.bs_switch()
        reader.bs_reset()

        aclitcount = litcount - prev_tail if litcount > prev_tail else 0
        mult = ((aclitcount + bs_processed - 1) // bs_processed
                if bs_processed else 0)
        rlitcount = bs_processed * mult
        prev_tail = rlitcount + prev_tail - litcount

        for _ in range(rlitcount):
            lit_queue.append(_decode_symbol(reader, lit))
            reader.bs_switch()
        # note: stream index wraps back to 0 because rlitcount is a
        # multiple of bs_processed; reference relies on the same wrap.

        for insert_len, copy_len, d in cmds:
            if wpos + insert_len + copy_len > output_size:
                raise ValueError("corrupt stream: output overrun")
            if insert_len:
                if lq_front + insert_len > len(lit_queue):
                    raise ValueError("corrupt stream: literal underrun")
                out[wpos: wpos + insert_len] = \
                    lit_queue[lq_front: lq_front + insert_len]
                wpos += insert_len
                lq_front += insert_len
            if copy_len:
                src = wpos - d
                if src < 0:
                    raise ValueError("corrupt stream: distance before start")
                if d >= copy_len:
                    out[wpos: wpos + copy_len] = out[src: src + copy_len]
                    wpos += copy_len
                else:
                    for _ in range(copy_len):
                        out[wpos] = out[src]
                        wpos += 1
                        src += 1
        reader.bs_reset()

    return bytes(out[:output_size]), isdelta
