"""Scalar Brotli-G page encoder.

Produces valid Brotli-G pages decodable by the reference decoder. The parse
is greedy-with-lazy-matching (the reference uses brotli's Zopfli optimal
parse at q11 — see SURVEY.md §2.11; ratio parity is a later milestone, the
bitstream format here is exact: PageEncoder.cpp:247-651).

The port's copy of brotlig_tpu/refimpl/page_encoder.py, with encode_page
split in two: the parse (find_matches, the plain version of the CUDA
kernel in csrc/ref_parse.cu, ops/ref_parse_kernel.py) and serialize_page,
which codes a page's parse on the host.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from ..format import constants as C
from ..format import lut
from ..format.huffman import build_and_store_table, \
    package_merge_lengths
from ..format.swizzle import Swizzler


@dataclass
class Command:
    insert_len: int
    copy_len: int
    distance: int            # absolute distance (0 for insert-only/sentinel)
    cmd_prefix: int = 0
    dist_symbol: int = -1    # -1 = no distance symbol stored
    dist_extra_bits: int = 0
    dist_extra_val: int = 0


# ---------------------------------------------------------------------------
# Match finding (greedy + one-step lazy)
# ---------------------------------------------------------------------------

_HASH_BITS = 17
_HASH_MUL = 0x1E35A7BD


def _hash4(v: int) -> int:
    return ((v * _HASH_MUL) & 0xFFFFFFFF) >> (32 - _HASH_BITS)


def find_matches(data: bytes, max_chain: int = 64, min_len: int = 4):
    """Greedy/lazy LZ77 over one page. Returns list of (ins, copy, dist)."""
    n = len(data)
    head = np.full(1 << _HASH_BITS, -1, dtype=np.int64)
    prev = np.full(max(n, 1), -1, dtype=np.int64)
    if n >= 4:
        v = np.frombuffer(data, dtype=np.uint8).astype(np.uint32)
        quads = (v[:-3] | (v[1:-2] << 8) | (v[2:-1] << 16) | (v[3:] << 24))
        hashes = ((quads * np.uint32(_HASH_MUL)) >> np.uint32(32 - _HASH_BITS))
    else:
        hashes = np.zeros(0, dtype=np.uint32)

    def match_len(a: int, b: int, limit: int) -> int:
        l = 0
        while l < limit and data[a + l] == data[b + l]:
            l += 1
        return l

    def best_match(pos: int):
        if pos + min_len > n:
            return 0, 0
        best_len, best_dist = 0, 0
        cand = int(head[hashes[pos]])
        chain = max_chain
        limit = n - pos
        while cand >= 0 and chain > 0:
            l = match_len(cand, pos, limit)
            if l >= min_len and l > best_len:
                best_len, best_dist = l, pos - cand
            cand = int(prev[cand])
            chain -= 1
        return best_len, best_dist

    def insert_hash(pos: int):
        if pos < len(hashes):
            h = hashes[pos]
            prev[pos] = head[h]
            head[h] = pos

    commands = []
    pos = 0
    anchor = 0
    while pos < n:
        blen, bdist = best_match(pos)
        if blen >= min_len:
            # lazy: prefer a longer match at pos+1
            insert_hash(pos)
            nlen, ndist = best_match(pos + 1) if pos + 1 < n else (0, 0)
            if nlen > blen + 1:
                pos += 1
                continue
            commands.append((pos - anchor, blen, bdist))
            end = pos + blen
            pos += 1
            while pos < end:
                insert_hash(pos)
                pos += 1
            anchor = end
        else:
            insert_hash(pos)
            pos += 1
    tail = n - anchor
    return commands, tail


# ---------------------------------------------------------------------------
# Distance code assignment
# ---------------------------------------------------------------------------

def _ring_short_code(d: int, ring, offsets: bool):
    """Short code 0-15 for distance d against the ring, or None.

    Codes 0-3 are exact hits; with `offsets`, codes 4-15 encode
    ring[0]/ring[1] +/- {1,2,3} (decode mapping PageDecoder.cpp:345-404),
    all with zero extra bits."""
    for i in range(4):
        if d == ring[i]:
            return i
    if offsets:
        for depth in range(2):
            for mag in (1, 2, 3):
                code = 4 + 6 * depth + 2 * (mag - 1)
                if d == ring[depth] - mag:
                    return code
                if d == ring[depth] + mag:
                    return code + 1
    return None


def _dist_mode_cost(raw_cmds, npostfix: int, ndirect: int,
                    offsets: bool) -> int:
    """Exact Huffman bit cost of the distance plane for one short-code
    mode (matches the native encoder's per-page mode choice)."""
    ring = list(C.DISTANCE_RING_INIT)
    hist = np.zeros(C.NUM_DISTANCE_SYMBOLS, dtype=np.int64)
    extras = 0
    for ins, cpy, d in raw_cmds:
        if not cpy:
            continue
        sym = _ring_short_code(d, ring, offsets)
        if sym is None:
            sym, nbits, _extra = lut.encode_distance(d, npostfix, ndirect)
            extras += nbits
        inscode = lut.get_insert_length_code(ins)
        copycode = lut.get_copy_length_code(cpy)
        if not (sym == 0 and inscode < 8 and copycode < 16):
            hist[sym] += 1
        if sym > 0:
            ring = [d, ring[0], ring[1], ring[2]]
    lens = package_merge_lengths(hist)
    return int((hist * lens).sum()) + extras


def assign_codes(raw_cmds, tail: int, npostfix: int, ndirect: int):
    """Resolve command prefixes and distance symbols with ring semantics.

    The ring updates exactly as the decoder's TranslateDistance
    (PageDecoder.cpp:397-403): any distance symbol > 0 pushes. Ring
    offset codes 4-15 are used when they beat exact-hits-only by true
    Huffman cost (same per-page mode choice as the native encoder).
    """
    offsets = (_dist_mode_cost(raw_cmds, npostfix, ndirect, True)
               < _dist_mode_cost(raw_cmds, npostfix, ndirect, False))
    ring = list(C.DISTANCE_RING_INIT)
    out = []
    for ins, cpy, d in raw_cmds:
        cmd = Command(ins, cpy, d)
        sym = _ring_short_code(d, ring, offsets)
        if sym is None:
            sym, nbits, extra = lut.encode_distance(d, npostfix, ndirect)
            cmd.dist_extra_bits, cmd.dist_extra_val = nbits, extra
        inscode = lut.get_insert_length_code(ins)
        copycode = lut.get_copy_length_code(cpy)
        use_last = (sym == 0 and inscode < 8 and copycode < 16)
        cmd.cmd_prefix = lut.combine_length_codes(inscode, copycode, use_last)
        if use_last:
            cmd.dist_symbol = -1   # implicit last-distance, nothing stored
        else:
            cmd.dist_symbol = sym
        if sym > 0:
            ring = [d, ring[0], ring[1], ring[2]]
        out.append(cmd)

    if tail:
        inscode = lut.get_insert_length_code(tail)
        cmd = Command(tail, 0, 0,
                      cmd_prefix=C.NUM_COMMAND_SYMBOLS + inscode)
        out.append(cmd)
    out.append(Command(0, 0, 0, cmd_prefix=C.SENTINEL_COMMAND))
    return out


# ---------------------------------------------------------------------------
# Serialization
# ---------------------------------------------------------------------------

def _store_command(swz, cmd: Command, cmd_codes, cmd_lens):
    swz.append(int(cmd_lens[cmd.cmd_prefix]), int(cmd_codes[cmd.cmd_prefix]))
    if cmd.cmd_prefix <= C.NUM_COMMAND_SYMBOLS:
        inscode = lut.get_insert_length_code(cmd.insert_len)
        copycode = lut.get_copy_length_code(cmd.copy_len)
        ins_extra_bits = int(lut.INSERT_EXTRA[inscode])
        ins_extra_val = cmd.insert_len - int(lut.INSERT_BASE[inscode])
        cpy_extra_bits = int(lut.COPY_EXTRA[copycode])
        cpy_extra_val = (cmd.copy_len - int(lut.COPY_BASE[copycode])
                         if copycode > 1 else cmd.copy_len)
        bits = (cpy_extra_val << ins_extra_bits) | ins_extra_val
        swz.append(ins_extra_bits + cpy_extra_bits, bits)
    else:
        inscode = cmd.cmd_prefix - C.NUM_COMMAND_SYMBOLS
        ins_extra_bits = int(lut.INSERT_EXTRA[inscode])
        swz.append(ins_extra_bits, cmd.insert_len - int(lut.INSERT_BASE[inscode]))


def should_compress(data: bytes, num_literals: int, num_commands: int) -> bool:
    """Entropy-sampling compressibility gate (ref: PageEncoder.cpp:60-85)."""
    n = len(data)
    if n <= 2:
        return False
    if num_commands < (n >> 8) + 2 and num_literals > 0.99 * n:
        sample_rate = 13
        samples = np.frombuffer(data, dtype=np.uint8)[::sample_rate]
        hist = np.bincount(samples, minlength=256).astype(np.float64)
        total = float(hist.sum())
        nz = hist[hist > 0]
        bits_entropy = float(-(nz * np.log2(nz / total)).sum())
        if bits_entropy < total:   # BitsEntropy: >= 1 bit per sample
            bits_entropy = total
        if bits_entropy > n * 7.92 / sample_rate:
            return False
    return True


def encode_page(data: bytes, is_last: bool,
                delta_encoded: bool = False,
                max_chain: int = 64):
    """Encode one page; returns compressed bytes, or None if the page should
    be stored raw (not compressible / compressed >= input).
    """
    raw_cmds, tail = find_matches(data, max_chain=max_chain)
    return serialize_page(data, raw_cmds, tail, is_last, delta_encoded)


def serialize_page(data: bytes, raw_cmds, tail: int, is_last: bool,
                   delta_encoded: bool = False):
    """Code one page from its parse, find_matches' (raw_cmds, tail): the
    compressed bytes, or None if the page should be stored raw."""
    n = len(data)
    num_literals = sum(ins for ins, _, _ in raw_cmds) + tail
    num_commands = len(raw_cmds) + (1 if tail else 0) + 1
    if not should_compress(data, num_literals, num_commands):
        return None

    npostfix, ndirect = 0, 0
    cmds = assign_codes(raw_cmds, tail, npostfix, ndirect)

    # histograms + literal queue in command order
    hist_cmd = np.zeros(C.NUM_COMMAND_SYMBOLS_EFFECTIVE, dtype=np.int64)
    hist_dist = np.zeros(C.NUM_DISTANCE_SYMBOLS, dtype=np.int64)
    lit_queue = bytearray()
    pos = 0
    for cmd in cmds:
        hist_cmd[cmd.cmd_prefix] += 1
        if (cmd.copy_len and 128 <= cmd.cmd_prefix < C.NUM_COMMAND_SYMBOLS
                and cmd.dist_symbol >= 0):
            hist_dist[cmd.dist_symbol] += 1
        if cmd.insert_len:
            lit_queue.extend(data[pos: pos + cmd.insert_len])
        pos += cmd.insert_len + cmd.copy_len
    assert pos == n, f"commands cover {pos} of {n} bytes"
    hist_lit = np.bincount(np.frombuffer(bytes(lit_queue), np.uint8),
                           minlength=C.NUM_LITERAL_SYMBOLS)

    most_freq_lit = int(hist_lit.argmax())

    swz = Swizzler()
    cmd_codes, cmd_lens = build_and_store_table(
        hist_cmd, C.NUM_COMMAND_SYMBOLS_EFFECTIVE, swz)
    dist_codes, dist_lens = build_and_store_table(
        hist_dist, C.NUM_DISTANCE_SYMBOLS, swz)
    lit_codes, lit_lens = build_and_store_table(
        hist_lit, C.NUM_LITERAL_SYMBOLS, swz)

    # round-robin command/literal serialization (PageEncoder.cpp:475-540)
    nbs = C.NUM_BITSTREAMS
    total_cmds = len(cmds)
    n_rounds = (total_cmds + nbs - 1) // nbs
    eff_nbs = min(total_cmds, nbs)
    prev_tail = 0
    lq_front = 0
    ci = 0
    for rnd in range(n_rounds):
        litcount = 0
        bsindex = 0
        while bsindex < nbs:
            cmd = cmds[ci]
            ci += 1
            litcount += cmd.insert_len
            _store_command(swz, cmd, cmd_codes, cmd_lens)
            if cmd.insert_len == 0 and cmd.copy_len == 0:
                break
            if (cmd.copy_len and 128 <= cmd.cmd_prefix
                    < C.NUM_COMMAND_SYMBOLS):
                sym = cmd.dist_symbol
                swz.append(int(dist_lens[sym]), int(dist_codes[sym]))
                swz.append(cmd.dist_extra_bits, cmd.dist_extra_val)
            bsindex += 1
            swz.bs_switch()
        swz.bs_reset()

        aclit = litcount - prev_tail if litcount > prev_tail else 0
        mult = (aclit + eff_nbs - 1) // eff_nbs
        rlit = eff_nbs * mult
        prev_tail = rlit + prev_tail - litcount

        for _ in range(rlit):
            if lq_front >= len(lit_queue):
                if rnd < n_rounds - 1 or is_last:
                    b = most_freq_lit
                else:
                    break
            else:
                b = lit_queue[lq_front]
                lq_front += 1
            swz.append(int(lit_lens[b]), int(lit_codes[b]))
            swz.bs_switch()
        swz.bs_reset()

    # page header + size table
    swz.append_to_header(C.PAGE_HEADER_NPOSTFIX_BITS, npostfix)
    swz.append_to_header(C.PAGE_HEADER_NDIST_BITS, ndirect >> npostfix)
    swz.append_to_header(C.PAGE_HEADER_ISDELTAENCODED_BITS,
                         int(delta_encoded))
    swz.append_to_header(C.PAGE_HEADER_RESERVED_BITS, 0)
    swz.append_bitstream_sizes()

    out = swz.serialize()
    if len(out) >= n:
        return None
    return out
