# Frozen copy of brotlig_tpu_torch/format/rle.py at commit 5a3fdcdf7cdd; unchanged.
"""RLE codec for Huffman code-length arrays (complex table storage).

Wire semantics (decoder contract, BrotligHuffmanTable.cpp:149-195):
  * symbols 0..15: literal code length (0 = unused symbol);
  * 16: repeat previous non-zero length 3..6 times (2 extra bits);
  * 17: repeat zero 3..10 times (3 extra bits);
  * "previous length" starts at 8 and is updated only by literal lengths.

The encoder reproduces the reference's exact run-splitting quirks
(BrotligUtils.cpp:76-228) so that compressed sizes stay comparable.

The port's copy of brotlig_tpu/format/rle.py (without its test-only
inverse, decode_rle_codes).
"""
from __future__ import annotations

import numpy as np

from . import constants as C


def _encode_zero_reps(reps, out_codes, out_extra):
    if reps == 11:
        out_codes.append(0)
        out_extra.append(0)
        reps -= 1
    if reps < 3:
        out_codes.extend([0] * reps)
        out_extra.extend([0] * reps)
        return
    while True:
        chunk = min(reps, 10)
        reps -= chunk
        out_codes.append(C.REPEAT_ZERO_CODE_LENGTH)
        out_extra.append(chunk - 3)
        if reps < 3:
            break
    out_codes.extend([0] * reps)
    out_extra.extend([0] * reps)


def _encode_nonzero_reps(prev_value, value, reps, out_codes, out_extra):
    if prev_value != value:
        out_codes.append(value)
        out_extra.append(0)
        reps -= 1
    if reps == 7:
        out_codes.append(value)
        out_extra.append(0)
        reps -= 1
    if reps < 3:
        out_codes.extend([value] * reps)
        out_extra.extend([0] * reps)
        return
    while True:
        chunk = min(reps, 6)
        reps -= chunk
        out_codes.append(C.REPEAT_PREVIOUS_CODE_LENGTH)
        out_extra.append(chunk - 3)
        if reps < 3:
            break
    out_codes.extend([value] * reps)
    out_extra.extend([0] * reps)


def compute_rle_codes(lengths):
    """Code-length array -> (codes, extra_bits) covering every position.

    Mirrors ComputeRLECodes (BrotligUtils.cpp:172-228) including the
    first-position literal and the reps==11 / reps==7 split quirks.
    """
    lengths = np.asarray(lengths)
    out_codes: list[int] = []
    out_extra: list[int] = []
    prev_value = C.INITIAL_REPEATED_CODE_LENGTH
    i = 0
    size = len(lengths)
    while i < size:
        value = int(lengths[i])
        reps = 1
        if i == 0:
            out_codes.append(value)
            out_extra.append(0)
        else:
            k = i + 1
            while k < size and int(lengths[k]) == value:
                reps += 1
                k += 1
            if value == 0:
                _encode_zero_reps(reps, out_codes, out_extra)
            else:
                _encode_nonzero_reps(prev_value, value, reps,
                                     out_codes, out_extra)
        prev_value = value
        i += reps
    return np.asarray(out_codes, dtype=np.int32), np.asarray(
        out_extra, dtype=np.int32)
