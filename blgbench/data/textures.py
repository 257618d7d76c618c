"""Seeded BC1 / BC3 / BC5 textures with full mip chains.

Each mip level is a grid of blocks drawn from
`numpy.random.default_rng([seed, index, mip])`: endpoints that follow the
block's place, as chip_smoke.py's make_bc1 draws them (BC1's colour part
is make_bc1's, with the seed as an argument), and low-entropy index rows.
BC3 adds an alpha block whose indices are one 3-bit value repeated, the
smooth-alpha case; BC5 is two such single-channel blocks. Nothing here
reads a file.
"""
from __future__ import annotations

import numpy as np

from .assets import bc1_blocks

BLOCK_BYTES = {"bc1": 8, "bc3": 16, "bc5": 16}
FORMAT_CODES = {"bc1": 1, "bc3": 3, "bc5": 5}   # the container's Format


def mip_grids(width: int, height: int, mips: int) -> list:
    """(blocks wide, blocks high) of each mip level, as the container's
    precondition geometry lays them out (BrotligDataConditioner.h): level
    k is (width >> k) x (height >> k) pixels in whole blocks, so a side
    that reaches 0 pixels has 0 blocks."""
    return [(-(-(width >> k) // 4), -(-(height >> k) // 4))
            for k in range(mips)]


def full_mips(width: int, height: int) -> int:
    return max(width, height).bit_length()


def texture_size(fmt: str, width: int, height: int, mips: int) -> int:
    return sum(w * h for w, h in mip_grids(width, height, mips)) \
        * BLOCK_BYTES[fmt]


def _channel_blocks(r: np.random.Generator, wb: int, hb: int,
                    base: int) -> np.ndarray:
    """[n, 8] uint8 single-channel (BC4-style) blocks: two 8-bit
    endpoints that follow the block's place, then 16 3-bit indices, one
    value repeated in three blocks of four and drawn anew in the fourth."""
    n = wb * hb
    by, bx = np.divmod(np.arange(n, dtype=np.int64), wb)
    e0 = (base + bx * 256 // max(wb, 1) + r.integers(0, 4, n)) % 256
    e1 = (e0 * 3 // 4 + by * 64 // max(hb, 1)) % 256
    sel = r.integers(0, 8, n).astype(np.uint64)
    bits = np.zeros(n, np.uint64)
    for k in range(16):
        bits |= sel << np.uint64(3 * k)
    noisy = r.random(n) < 0.25
    bits[noisy] = r.integers(0, 1 << 48, int(noisy.sum()), dtype=np.uint64)
    out = np.empty((n, 8), np.uint8)
    out[:, 0] = e0
    out[:, 1] = e1
    out[:, 2:8] = bits.astype("<u8").view(np.uint8).reshape(n, 8)[:, :6]
    return out


def mip_blocks(fmt: str, r: np.random.Generator, wb: int,
               hb: int) -> np.ndarray:
    if fmt == "bc1":
        return bc1_blocks(r, wb, hb)
    if fmt == "bc3":
        return np.concatenate([_channel_blocks(r, wb, hb, 255),
                               bc1_blocks(r, wb, hb)], axis=1)
    if fmt == "bc5":
        return np.concatenate([_channel_blocks(r, wb, hb, 0),
                               _channel_blocks(r, wb, hb, 128)], axis=1)
    raise ValueError(f"format {fmt!r} not in {sorted(BLOCK_BYTES)}")


def make_texture(fmt: str, width: int, height: int, mips: int, seed: int,
                 index: int) -> bytes:
    """Texture `index` of a set: every mip level's blocks, level 0 first,
    `texture_size(fmt, width, height, mips)` bytes."""
    return b"".join(
        mip_blocks(fmt, np.random.default_rng([int(seed), int(index), k]),
                   wb, hb).tobytes()
        for k, (wb, hb) in enumerate(mip_grids(width, height, mips)))
