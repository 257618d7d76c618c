# Frozen copy of brotlig_tpu_torch/format/huffman.py at commit 5a3fdcdf7cdd; unchanged.
"""Canonical Huffman coding for Brotli-G tables.

Covers both sides:
  * encoder: depth-limited code-length construction (package-merge, optimal —
    the reference uses a clamp-and-rebuild heuristic, BrotligHuffman.cpp:105,
    so our tables are never larger), canonical code assignment, and the three
    storage modes (trivial / simple / complex+RLE) of
    BuildStoreHuffmanTable (BrotligHuffman.cpp:262-363);
  * decoder: parsing the three storage modes (BrotligHuffmanTable.cpp:73-205)
    and building flat lookup tables (GenerateHuffmanTable, :44-71).

Bit order: canonical codes are MSB-first values; the wire carries them
LSB-first, so codes are bit-reversed at write time and lookups bit-reverse
the peeked window (the reference ships 4K-line reverse LUTs for this).

The port's copy of brotlig_tpu/format/huffman.py, unchanged in behaviour.
"""
from __future__ import annotations

import numpy as np

from . import constants as C
from .rle import compute_rle_codes

# Fixed code/length tables for "simple" trees with 2..4 symbols
# (ref: BrotligHuffmanTable.cpp:26-38). Row = table_idx.
SIMPLE_CODELENGTHS = (
    (1, 1),            # 2 symbols
    (1, 2, 2),         # 3 symbols
    (2, 2, 2, 2),      # 4 symbols, tree_select=0
    (1, 2, 3, 3),      # 4 symbols, tree_select=1
)

# Storage order of the 18 code-length-code lengths in complex mode
# (ref: BrotligHuffman.cpp:226-228 == BrotligHuffmanTable.cpp:40-42)
CODE_LENGTH_ORDER = (1, 2, 3, 4, 0, 5, 17, 6, 16, 7, 8, 9, 10, 11, 12, 13,
                     14, 15)


def reverse_bits(value: int, n_bits: int) -> int:
    r = 0
    for _ in range(n_bits):
        r = (r << 1) | (value & 1)
        value >>= 1
    return r


def max_bits_for_alphabet(alphabet_size: int) -> int:
    """Bit width used to store raw symbols in trivial/simple headers."""
    return (alphabet_size - 1).bit_length()


# ---------------------------------------------------------------------------
# Code length construction (encoder)
# ---------------------------------------------------------------------------

def package_merge_lengths(hist, max_depth: int = C.HUFFMAN_MAX_DEPTH):
    """Optimal depth-limited code lengths via package-merge.

    hist: array of counts. Returns np.uint8 lengths (0 for unused symbols).
    """
    hist = np.asarray(hist, dtype=np.int64)
    lengths = np.zeros(len(hist), dtype=np.uint8)
    used = np.flatnonzero(hist)
    n = len(used)
    if n == 0:
        return lengths
    if n == 1:
        lengths[used[0]] = 1
        return lengths
    if n > (1 << max_depth):
        raise ValueError("alphabet too large for depth limit")

    # package-merge over (weight, tuple-of-leaf-ids); a leaf's code length is
    # the number of solution items containing it.
    leaves = sorted((int(hist[s]), i) for i, s in enumerate(used))
    leaf_items = [(w, (i,)) for (w, i) in leaves]
    prev = []
    for _ in range(max_depth - 1):
        items = sorted(leaf_items + prev, key=lambda t: t[0])
        prev = [
            (items[k][0] + items[k + 1][0], items[k][1] + items[k + 1][1])
            for k in range(0, len(items) - 1, 2)
        ]
    items = sorted(leaf_items + prev, key=lambda t: t[0])
    counts = np.zeros(n, dtype=np.int64)
    for _, leafidxs in items[: 2 * n - 2]:
        for i in leafidxs:
            counts[i] += 1
    for i in range(n):
        lengths[used[i]] = counts[i]
    assert np.isclose((0.5 ** counts).sum(), 1.0), "Kraft violated"
    return lengths


def canonical_codes(lengths):
    """Canonical MSB-first codes assigned in symbol order per length.

    Matches both the reference encoder (BrotligHuffman.cpp:163-186) and the
    decoder's table fill (GenerateHuffmanTable). Returns int32 codes.
    """
    lengths = np.asarray(lengths)
    max_len = int(lengths.max()) if lengths.size else 0
    bl_count = np.bincount(lengths, minlength=max_len + 1)
    bl_count[0] = 0
    next_code = np.zeros(max_len + 2, dtype=np.int64)
    for bits in range(1, max_len + 1):
        next_code[bits] = (next_code[bits - 1] + bl_count[bits - 1]) << 1
    codes = np.zeros(len(lengths), dtype=np.int32)
    for sym in np.flatnonzero(lengths):
        ln = lengths[sym]
        codes[sym] = next_code[ln]
        next_code[ln] += 1
    return codes


def canonical_codes_lsb(lengths):
    """Canonical codes bit-reversed for LSB-first writing."""
    codes = canonical_codes(lengths)
    out = np.zeros_like(codes)
    for sym in np.flatnonzero(lengths):
        out[sym] = reverse_bits(int(codes[sym]), int(lengths[sym]))
    return out


# ---------------------------------------------------------------------------
# Flat decode tables (decoder)
# ---------------------------------------------------------------------------

def build_decode_table(lengths, table_bits: int):
    """Flat 2^table_bits direct-lookup table from code lengths.

    Index = MSB-first code left-aligned to table_bits (i.e. bit-reversed
    peek of table_bits wire bits). Returns (symbols uint16, lens uint8).
    Mirrors GenerateHuffmanTable (BrotligHuffmanTable.cpp:44-71).
    """
    lengths = np.asarray(lengths, dtype=np.int64)
    size = 1 << table_bits
    syms_out = np.zeros(size, dtype=np.uint16)
    lens_out = np.zeros(size, dtype=np.uint8)
    used = np.flatnonzero(lengths)
    if used.size == 0:
        return syms_out, lens_out
    codes = canonical_codes(lengths)
    starts = (codes[used].astype(np.int64) << (table_bits - lengths[used]))
    spans = (np.int64(1) << (table_bits - lengths[used]))
    order = np.argsort(starts, kind="stable")
    used, starts, spans = used[order], starts[order], spans[order]
    total = int(spans.sum())
    if total > size:
        raise ValueError("over-subscribed Huffman code")
    fill_syms = np.repeat(used.astype(np.uint16), spans)
    fill_lens = np.repeat(lengths[used].astype(np.uint8), spans)
    pos = int(starts[0])
    # canonical + sorted => contiguous from starts[0]
    syms_out[pos: pos + total] = fill_syms
    lens_out[pos: pos + total] = fill_lens
    return syms_out, lens_out


# ---------------------------------------------------------------------------
# Table storage (encoder side)
# ---------------------------------------------------------------------------

def build_and_store_table(hist, alphabet_size: int, swizzler):
    """Build a depth-limited canonical code for `hist` and serialize the
    table through `swizzler` (format: BrotligHuffman.cpp:262-363).

    Returns (codes_lsb int32, lengths uint8) for subsequent symbol encoding.
    """
    hist = np.asarray(hist, dtype=np.int64)
    assert len(hist) == alphabet_size
    used = np.flatnonzero(hist)
    count = len(used)
    max_bits = max_bits_for_alphabet(alphabet_size)
    codes = np.zeros(alphabet_size, dtype=np.int32)
    lengths = np.zeros(alphabet_size, dtype=np.uint8)

    if count <= 1:
        sym = int(used[0]) if count else 0
        swizzler.append(2, 0)          # tree type: trivial
        swizzler.append(2, 1)
        swizzler.append(2, 0)
        swizzler.append(max_bits, sym, bs_switch=True)
        swizzler.bs_reset()
        # code length 0: decode consumes no bits and always yields sym
        return codes, lengths

    lengths = package_merge_lengths(hist)
    codes = canonical_codes_lsb(lengths)

    if count <= 4:
        s4 = sorted(map(int, used), key=lambda s: (int(lengths[s]), s))
        swizzler.append(2, 1)          # tree type: simple
        swizzler.append(2, count - 1)
        if count == 4:
            tree_select = 1 if int(lengths[s4[0]]) == 1 else 0
            swizzler.append(1, tree_select)
            swizzler.append(1, 0)
        else:
            swizzler.append(2, 0)
        for s in s4:
            swizzler.append(max_bits, s, bs_switch=True)
        swizzler.bs_reset()
        return codes, lengths

    # complex: RLE-encode the code-length array, Huffman-code the RLE symbols
    swizzler.append(2, 2)              # tree type: complex
    swizzler.append(4, C.CODE_LENGTH_CODES - 4)

    rle_codes, rle_extra = compute_rle_codes(np.asarray(lengths))
    rle_hist = np.bincount(rle_codes, minlength=C.CODE_LENGTH_CODES)
    rle_lengths = package_merge_lengths(
        rle_hist, C.HUFFMAN_MAX_CODE_LENGTH_CODE_LENGTH)
    rle_codes_lsb = canonical_codes_lsb(rle_lengths)

    for pos in CODE_LENGTH_ORDER:
        swizzler.append(5, int(rle_lengths[pos]), bs_switch=True)
    swizzler.bs_reset()

    for code, extra in zip(rle_codes, rle_extra):
        code = int(code)
        swizzler.append(int(rle_lengths[code]), int(rle_codes_lsb[code]))
        if code == C.REPEAT_PREVIOUS_CODE_LENGTH:
            swizzler.append(2, int(extra), bs_switch=True)
        elif code == C.REPEAT_ZERO_CODE_LENGTH:
            swizzler.append(3, int(extra), bs_switch=True)
        else:
            swizzler.bs_switch()
    swizzler.bs_reset()
    return codes, lengths


# ---------------------------------------------------------------------------
# Table loading (decoder side)
# ---------------------------------------------------------------------------

def load_table_lengths(reader, alphabet_size: int):
    """Parse a serialized table; return per-symbol code lengths (uint8).

    `reader` is a Deswizzler. For trivial tables the returned lengths are all
    zero and the single symbol is returned separately:
      returns (lengths, trivial_symbol_or_None).
    Mirrors LoadHuffmanTable (BrotligHuffmanTable.cpp:73-205).
    """
    max_bits = max_bits_for_alphabet(alphabet_size)
    lengths = np.zeros(alphabet_size, dtype=np.uint8)
    ttype = reader.read(2)

    if ttype == 0:
        reader.consume(4)
        sym = reader.read(max_bits)
        reader.bs_reset()
        return lengths, sym

    if ttype == 1:
        num_symbols = reader.read(2) + 1
        tree_select = reader.read(1)
        reader.consume(1)
        table_idx = (num_symbols - 2 if num_symbols < 4
                     else (3 if tree_select else 2))
        fixed = SIMPLE_CODELENGTHS[table_idx]
        for i in range(num_symbols):
            sym = reader.read(max_bits)
            if sym >= alphabet_size:
                raise ValueError("corrupt stream: symbol out of range")
            lengths[sym] = fixed[i]
            reader.bs_switch()
        reader.bs_reset()
        return lengths, None

    if ttype != 2:
        raise ValueError("corrupt stream: bad huffman tree type")

    num_len_symbols = reader.read(4) + 4
    cl_lengths = np.zeros(C.CODE_LENGTH_CODES, dtype=np.uint8)
    for i in range(num_len_symbols):
        cl_lengths[CODE_LENGTH_ORDER[i]] = reader.read(5)
        reader.bs_switch()
    reader.bs_reset()

    cl_syms, cl_lens = build_decode_table(
        cl_lengths, C.HUFFMAN_CODE_LENGTH_TABLE_BITS)

    prev_len = C.INITIAL_REPEATED_CODE_LENGTH
    pos = 0
    left = alphabet_size
    while left > 0:
        window = reader.peek(C.HUFFMAN_CODE_LENGTH_TABLE_BITS)
        idx = reverse_bits(window, C.HUFFMAN_CODE_LENGTH_TABLE_BITS)
        sym = int(cl_syms[idx])
        reader.consume(int(cl_lens[idx]))
        if sym == C.REPEAT_PREVIOUS_CODE_LENGTH:
            reps = reader.read(2) + 3
            if reps > left:
                raise ValueError("corrupt stream: RLE repeat overflow")
            lengths[pos: pos + reps] = prev_len
            pos += reps
            left -= reps
        elif sym == C.REPEAT_ZERO_CODE_LENGTH:
            reps = reader.read(3) + 3
            if reps > left:
                raise ValueError("corrupt stream: RLE zero-run overflow")
            pos += reps
            left -= reps
        else:
            prev_len = sym
            lengths[pos] = sym
            pos += 1
            left -= 1
        reader.bs_switch()
    reader.bs_reset()
    return lengths, None
