"""Seeded generators of a game's asset kinds.

Every generator takes the run's seed and the asset's place in its
manifest, and draws from `numpy.random.default_rng([seed, index])`, so one
seed always gives the same bytes and an asset's bytes do not depend on the
other assets. The seed draws the bytes, never the shape of the data (a
mesh's waves, a grid's width), so every seed gives the encoder and the
decoder the same work. Nothing here reads a file.

Kinds (a bundle's manifest assigns them in turn):
- "bcn": BC1 blocks, not preconditioned: endpoints that follow the block's
  place, low-entropy index rows (chip_smoke.py's make_bc1, with the seed
  as an argument);
- "mesh": float32 vertex buffers (position, normal, uv) of a smooth
  height field;
- "index": triangle index buffers of a grid mesh after a vertex-cache
  pass, uint16 below 65,536 vertices and uint32 above;
- "text": text or script drawn from a Zipf word model;
- "audio": already-compressed audio, i.e. seeded random bytes, which the
  encoder stores as raw pages.
"""
from __future__ import annotations

import numpy as np

KINDS = ("bcn", "mesh", "index", "text", "audio")


def rng_for(seed: int, index: int) -> np.random.Generator:
    """The generator of asset `index` under run seed `seed` (any whole
    number >= 0, also past 2**63)."""
    return np.random.default_rng([int(seed), int(index)])


def bc1_blocks(r: np.random.Generator, wb: int, hb: int) -> np.ndarray:
    """[hb * wb, 8] uint8 BC1 blocks of a wb x hb block grid: RGB565
    endpoints that follow the block's place with a little noise, the
    second a darker copy of the first, and one 2-bit index a pixel row
    (bytes 0x00, 0x55, 0xAA, 0xFF), as make_bc1 draws them."""
    n = wb * hb
    by, bx = np.divmod(np.arange(n, dtype=np.int64), wb)
    r5 = (bx * 32 // max(wb, 1) + r.integers(0, 2, n)) % 32
    g6 = (by * 64 // max(hb, 1) + r.integers(0, 3, n)) % 64
    b5 = ((bx + by) * 32 // max(wb + hb, 1) + r.integers(0, 2, n)) % 32
    c0 = (r5 << 11 | g6 << 5 | b5).astype("<u2")
    c1 = (c0.astype(np.uint32) * 3 // 4).astype("<u2")
    blocks = np.empty((n, 8), np.uint8)
    blocks[:, 0:2] = c0.view(np.uint8).reshape(-1, 2)
    blocks[:, 2:4] = c1.view(np.uint8).reshape(-1, 2)
    blocks[:, 4:8] = r.integers(0, 4, (n, 4)).astype(np.uint8) * 0x55
    return blocks


def gen_bcn(r: np.random.Generator, size: int) -> bytes:
    """BC1 blocks of a texture 1024 blocks wide, `size` bytes (a multiple
    of 8)."""
    n = size // 8
    wb = min(1024, n)
    return bc1_blocks(r, wb, -(-n // wb)).tobytes()[:size]


def gen_mesh(r: np.random.Generator, size: int) -> bytes:
    """Vertices of 8 float32 (x, y, z, nx, ny, nz, u, v) over a grid 256
    vertices wide; the height is a sum of three sine waves of fixed
    amplitudes and frequencies, at phases drawn from the seed."""
    nv = -(-size // 32)
    gy, gx = np.divmod(np.arange(nv, dtype=np.float32), np.float32(256))
    amp = np.float32([3.0, 1.5, 0.5])
    fx = np.float32([0.013, 0.041, 0.097])
    fy = np.float32([0.021, 0.033, 0.089])
    ph = r.uniform(0, 6.28, 3).astype(np.float32)
    h = np.zeros(nv, np.float32)
    dx = np.zeros(nv, np.float32)
    dy = np.zeros(nv, np.float32)
    for k in range(3):
        arg = fx[k] * gx + fy[k] * gy + ph[k]
        h += amp[k] * np.sin(arg)
        c = amp[k] * np.cos(arg)
        dx += c * fx[k]
        dy += c * fy[k]
    norm = np.sqrt(dx * dx + dy * dy + 1).astype(np.float32)
    v = np.empty((nv, 8), np.float32)
    v[:, 0] = gx * np.float32(0.5)
    v[:, 1] = h
    v[:, 2] = gy * np.float32(0.5)
    v[:, 3] = -dx / norm
    v[:, 4] = 1 / norm
    v[:, 5] = -dy / norm
    v[:, 6] = gx / np.float32(255)
    v[:, 7] = gy / np.float32(1024)
    return v.tobytes()[:size]


def gen_index(r: np.random.Generator, size: int) -> bytes:
    """Two triangles a cell of a grid mesh 256 vertices wide, as a mesh
    exporter writes them after a vertex-cache pass: rows in order, the
    triangles of each run of 64 in an order drawn from the seed. uint16
    while the vertices fit, uint32 past 65,536."""
    w = 256
    cells = -(-size // 12)                       # as uint16
    wide = (cells // (w - 1) + 2) * w > 65536    # a vertex past uint16
    dtype = np.dtype("<u4") if wide else np.dtype("<u2")
    n = -(-size // (6 * dtype.itemsize))
    n64 = -(-n // 64) * 64
    cell = r.permuted(np.arange(n64, dtype=np.int64).reshape(-1, 64),
                      axis=1).reshape(-1)[:n]
    row, col = np.divmod(cell, w - 1)
    i = row * w + col
    tri = np.stack([i, i + w, i + 1, i + 1, i + w, i + w + 1], axis=1)
    return tri.astype(dtype).tobytes()[:size]


def gen_text(r: np.random.Generator, size: int) -> bytes:
    """Words of a 4,096-word vocabulary drawn with Zipf weights (exponent
    1.1), separated by spaces, a newline every ~12 words. The words' lengths
    (2 to 10 letters) are fixed by their rank; their letters are drawn from
    the seed."""
    vocab = 4096
    lens = 2 + np.arange(vocab) * 7 % 9
    letters = r.integers(97, 123, int(lens.sum())).astype(np.uint8)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    p = 1.0 / np.arange(1, vocab + 1) ** 1.1
    p /= p.sum()
    nwords = size // 5 + 64
    while True:
        w = r.choice(vocab, nwords, p=p)
        wl = lens[w] + 1                     # the word and its separator
        if int(wl.sum()) >= size:
            break
        nwords *= 2
    end = np.cumsum(wl)
    keep = int(np.searchsorted(end, size)) + 1
    w, wl, end = w[:keep], wl[:keep], end[:keep]
    out = np.empty(int(end[-1]), np.uint8)
    # byte k of the output: letter (k - word start) of its word, or the
    # separator at the word's end
    word_of = np.repeat(np.arange(keep), wl)
    pos = np.arange(len(out)) - (end - wl)[word_of]
    is_sep = pos == wl[word_of] - 1
    src = starts[w][word_of] + np.minimum(pos, lens[w][word_of] - 1)
    out[:] = letters[src]
    sep = np.where(r.random(keep) < 1 / 12, 10, 32).astype(np.uint8)
    out[is_sep] = sep[word_of[is_sep]]
    return out.tobytes()[:size]


def gen_audio(r: np.random.Generator, size: int) -> bytes:
    return r.bytes(size)


GENERATORS = {"bcn": gen_bcn, "mesh": gen_mesh, "index": gen_index,
              "text": gen_text, "audio": gen_audio}


def make_asset(kind: str, size: int, seed: int, index: int) -> bytes:
    """Asset `index` of a manifest: `size` bytes of `kind`, from the seed."""
    return GENERATORS[kind](rng_for(seed, index), size)
