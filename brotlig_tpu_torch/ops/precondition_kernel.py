"""The BCn texture postprocess and preprocess with closed-form addresses:
the wrappers of csrc/precondition.cu and their plain versions.

They replace the JAX package's jitted region over map planes
(brotlig_tpu/ops/precondition.py:109 _delta_decode_device, :121
_gather_u8, :127 _delta_encode_device), which has no Pallas kernel.
ops/precondition.py calls them: the kernels on CUDA tensors, the plain
versions on CPU tensors. Both read only the geometry record that
pack_geometry packs on the host and one delta flag a page (None: every
page); no map plane is built.

Byte i of the conditioned stream is original byte cond_map[i]
(format/precondition.py::build_cond_map), in closed form: sub-stream k by
the sub-stream offsets, q = i - offset[k], block = q // sub_size and j =
q % sub_size, the mip by the mips' block offsets, row and column in that
mip with the 2x2 swizzle undone, then mip offset + row * pitch + col *
block bytes + sub-block offset + j. A delta span is where a colour
sub-stream meets a page.

The kernels work a tile at a time: whole row pairs of a mip, or a chunk
of column pairs of one row pair (the swizzle moves blocks only inside a
row pair), so that a tile's part of every sub-stream is one contiguous
segment. tile_plan is the plain twin of that cut, tile_blocks the blocks
it composes, and lookback_carries the twin of the carries that the
postprocess's look-back passes from tile to tile.

Each direction is one kernel launch, counted under
``_kernels.LAUNCHES["precond"]`` (both kernels share the key).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import _kernels
from ..format.precondition import DataConditionParams

# The record's int64 words (csrc/precondition.cu holds the same offsets).
(G_N, G_M, G_PAGE, G_BB, G_NSUB, G_NMIPS, G_SWIZZLE, G_NCOLOR, G_FORMAT,
 G_TBLOCKS, G_PADDED) = range(11)
G_SUB_SIZE, G_SUB_OFF, G_STREAM_OFF, G_COLOR = 11, 17, 23, 30
MAX_SUBS, MAX_COLORS = 6, 4
G_MIP, G_MIP_FIELDS, G_MAX_MIPS = 34, 10, 32
G_LEN = G_MIP + G_MIP_FIELDS * G_MAX_MIPS
# a mip's fields: width and height in blocks, pitch, byte offset, block
# offset, first row (the rows of the mips before it), then the kernels'
# multipliers and shifts for dividing by the width and by the swizzle's
# groups a row (divisor_magic)
(M_WIDTH, M_HEIGHT, M_PITCH, M_BYTES, M_BLOCKS, M_ROW, M_WMUL, M_WSHIFT,
 M_GMUL, M_GSHIFT) = range(10)
MAX_PAGE = 1 << 17
PAGE_ALIGN = 128         # the delta spans' chunks of 16 bytes meet one page
TILE_BYTES = 16384       # csrc/precondition.cu kTile: texture bytes a tile
# the kernels' per-CTA record (int64 [grid, REC_WORDS]): clock cycles by
# phase (the consumer threads' but the producer warp's look-back), then the
# CTA's tiles and its total cycles
PHASES = ("waiting for the producer", "the producer's look-back",
          "the delta scan", "assembling or splitting", "storing")
REC_TILES, REC_TOTAL = 5, 6
REC_WORDS = 7


def divisor_magic(d: int) -> tuple:
    """(mul, shift) with q // d == (q * mul) >> shift for every q < 2^31
    and mul < 2^32 (Granlund and Montgomery: mul = ceil(2^(31 + l) / d),
    2^l >= d); (0, 0) for d 0."""
    if d <= 0:
        return 0, 0
    shift = 31 + (d - 1).bit_length()
    return -(-(1 << shift) // d), shift


def pack_geometry(params: DataConditionParams, n: int,
                  page_size: int) -> torch.Tensor:
    """The geometry record of an initialised `params` over an n-byte
    stream in pages of page_size bytes: int64 [G_LEN] on the CPU. Raises
    ValueError on a geometry the closed form does not cover: an
    uninitialised one, one whose mips do not fill exactly n bytes, a row
    pitch below the row's blocks, more than 32 mips, or a page size that
    is not a positive multiple of 128 up to 128 KiB."""
    if not params.initialized:
        raise ValueError("precondition geometry is not initialised")
    nm = params.num_mip_levels
    if not 1 <= nm <= G_MAX_MIPS:
        raise ValueError(f"{nm} mips: the closed form takes 1 to "
                         f"{G_MAX_MIPS}")
    if params.mip_offsets_bytes[nm] != n:
        raise ValueError(f"precondition geometry covers "
                         f"{params.mip_offsets_bytes[nm]} bytes, the stream "
                         f"{n}")
    if not (0 < page_size <= MAX_PAGE and page_size % PAGE_ALIGN == 0):
        raise ValueError(f"page size {page_size}: want a multiple of "
                         f"{PAGE_ALIGN} up to {MAX_PAGE}")
    subs = params.sub_block_sizes
    bb = params.block_size_bytes
    if len(subs) > MAX_SUBS or len(params.color_sub_blocks) > MAX_COLORS:
        raise ValueError("more sub-blocks than the record holds")
    g = [0] * G_LEN
    g[G_N], g[G_PAGE], g[G_BB] = n, page_size, bb
    g[G_M] = params.t_num_blocks * bb
    g[G_NSUB], g[G_NMIPS], g[G_SWIZZLE] = len(subs), nm, int(params.swizzle)
    g[G_NCOLOR], g[G_FORMAT] = len(params.color_sub_blocks), params.format
    g[G_TBLOCKS] = params.t_num_blocks
    g[G_SUB_SIZE: G_SUB_SIZE + len(subs)] = subs
    g[G_SUB_OFF: G_SUB_OFF + len(subs)] = params.sub_block_offsets
    g[G_STREAM_OFF: G_STREAM_OFF + len(subs) + 1] = \
        params.sub_stream_offsets[: len(subs) + 1]
    g[G_COLOR: G_COLOR + g[G_NCOLOR]] = params.color_sub_blocks
    row = 0
    for mip in range(nm):
        w, h = params.width_in_blocks[mip], params.height_in_blocks[mip]
        pitch = params.pitch_in_bytes[mip]
        if w * h and pitch < w * bb:
            raise ValueError(f"mip {mip}: pitch {pitch} below its row of "
                             f"{w * bb} bytes")
        base = G_MIP + mip * G_MIP_FIELDS
        g[base: base + G_MIP_FIELDS] = (
            w, h, pitch, params.mip_offsets_bytes[mip],
            params.mip_offset_blocks[mip], row, *divisor_magic(w),
            *divisor_magic(max((w - w % 2) // 2, 1)))
        g[G_PADDED] |= int(h > 0 and pitch > w * bb)
        row += h
    return torch.tensor(g, dtype=torch.int64)


def span_pages(geom: torch.Tensor) -> np.ndarray:
    """bool [pages]: the pages that a delta span lies in (a colour
    sub-stream meets them)."""
    g = geom.tolist()
    ps = g[G_PAGE]
    out = np.zeros(-(-g[G_N] // ps), dtype=bool)
    for c in range(g[G_NCOLOR]):
        sub = g[G_COLOR + c]
        c0, c1 = g[G_STREAM_OFF + sub], g[G_STREAM_OFF + sub + 1]
        if c1 > c0:
            out[c0 // ps: (c1 - 1) // ps + 1] = True
    return out


def page_flags(flagged, num_pages: int):
    """uint8 [num_pages] on the CPU, 1 for each page index in `flagged`;
    None for None (every page)."""
    if flagged is None:
        return None
    flags = np.zeros(num_pages, dtype=np.uint8)
    idx = [i for i in flagged if 0 <= i < num_pages]
    flags[idx] = 1
    return torch.from_numpy(flags)


# ---------------------------------------------------------------------------
# Plain versions: the closed form as int64 torch ops on the record
# ---------------------------------------------------------------------------

def cond_addresses(geom: torch.Tensor, device="cpu") -> torch.Tensor:
    """int64 [m]: the original address of each conditioned byte i < m
    (equal to format/precondition.py::build_cond_map)."""
    g = geom.tolist()
    nm, bb = g[G_NMIPS], g[G_BB]
    mips = torch.tensor(g[G_MIP: G_MIP + nm * G_MIP_FIELDS],
                        dtype=torch.int64, device=device).view(nm, -1)
    parts = []
    for k in range(g[G_NSUB]):
        s0, s1 = g[G_STREAM_OFF + k], g[G_STREAM_OFF + k + 1]
        sz = g[G_SUB_SIZE + k]
        q = torch.arange(s1 - s0, dtype=torch.int64, device=device)
        blk, j = q // sz, q % sz
        mip = torch.searchsorted(mips[:, M_BLOCKS].contiguous(), blk,
                                 right=True) - 1

        def field(f, mip=mip):
            return mips[:, f][mip]
        b = blk - field(M_BLOCKS)
        w, h = field(M_WIDTH), field(M_HEIGHT)
        row, col = b // w, b % w
        if g[G_SWIZZLE]:
            rem_w, rem_h = w % 2, h % 2
            eff_w, eff_h = w - rem_w, h - rem_h
            swz = (w >= 2) & (h >= 2) & (row < eff_h) & (col < eff_w)
            eff = b - row * rem_w
            grps = (eff_w // 2).clamp(min=1)
            grp, in_grp = eff // 4, eff % 4
            row = torch.where(swz, 2 * (grp // grps) + in_grp // 2, row)
            col = torch.where(swz, 2 * (grp % grps) + in_grp % 2, col)
        parts.append(field(M_BYTES) + row * field(M_PITCH) + col * bb
                     + g[G_SUB_OFF + k] + j)
    if not parts:
        return torch.zeros(0, dtype=torch.int64, device=device)
    return torch.cat(parts)


def span_starts(geom: torch.Tensor, flags, device="cpu"):
    """int64 [n]: for each conditioned byte in a delta span of a flagged
    page (flags uint8 [pages], None: every page), its span's first byte;
    -1 elsewhere."""
    g = geom.tolist()
    n, ps = g[G_N], g[G_PAGE]
    i = torch.arange(n, dtype=torch.int64, device=device)
    page_start = i - i % ps
    start = torch.full((n,), -1, dtype=torch.int64, device=device)
    for c in range(g[G_NCOLOR]):
        sub = g[G_COLOR + c]
        c0, c1 = g[G_STREAM_OFF + sub], g[G_STREAM_OFF + sub + 1]
        inside = (i >= c0) & (i < c1)
        start = torch.where(inside, page_start.clamp(min=c0), start)
    if flags is not None:
        flagged = flags.to(device=device, dtype=torch.bool)[i // ps]
        start = torch.where(flagged, start, -1)
    return start


def postprocess_plain(x: torch.Tensor, geom: torch.Tensor, flags=None):
    """Delta decode (each span of a flagged page becomes its prefix sum
    modulo 256) and decondition of the conditioned stream x, uint8 [n], on
    its device: uint8 [n], the bytes no conditioned byte covers 0."""
    g = geom.tolist()
    n, m = g[G_N], g[G_M]
    dev = x.device
    x64 = x.to(torch.int64)
    start = span_starts(geom, flags, dev)
    c = torch.cumsum(x64, 0)
    before = torch.where(start > 0, c[(start - 1).clamp(min=0)], 0)
    dec = torch.where(start >= 0, (c - before) & 255, x64)
    out = torch.zeros(n, dtype=torch.uint8, device=dev)
    out[cond_addresses(geom, dev)] = dec[:m].to(torch.uint8)
    return out


def preprocess_plain(x: torch.Tensor, geom: torch.Tensor, flags=None):
    """Condition the texture x, uint8 [n], on its device and delta encode
    it: (conditioned uint8 [n], the conditioned tail past the sub-streams
    0; delta uint8 [n]: inside each span of a flagged page every byte less
    the byte before it, modulo 256, each span's first byte kept)."""
    g = geom.tolist()
    n, m = g[G_N], g[G_M]
    dev = x.device
    cond = torch.zeros(n, dtype=torch.uint8, device=dev)
    cond[:m] = x[cond_addresses(geom, dev)]
    c64 = cond.to(torch.int64)
    prev = torch.cat([c64.new_zeros(1), c64[:-1]])
    start = span_starts(geom, flags, dev)
    i = torch.arange(n, dtype=torch.int64, device=dev)
    diff = (start >= 0) & (i != start)
    delta = torch.where(diff, (c64 - prev) & 255, c64).to(torch.uint8)
    return cond, delta


# ---------------------------------------------------------------------------
# The kernels' tile cut and look-back carries, as int64 torch ops
# ---------------------------------------------------------------------------

def _mip(g, m):
    return g[G_MIP + m * G_MIP_FIELDS: G_MIP + (m + 1) * G_MIP_FIELDS]


def tile_plan(geom: torch.Tensor, tile_bytes: int = TILE_BYTES) -> dict:
    """The kernels' tiles, in stream order, as int64 tensors over them:

    mip; narrow (1: rows [row0, row0 + rows) of the mip, whole row pairs;
    0: a chunk of one row pair, rows [row0, row0 + rows), column pairs
    [cp0, cp1)); b0, b1, the tile's conditioned blocks; seg0 [T, nsub],
    each sub-stream's segment start in the stream (its length is (b1 - b0)
    * sub_size); and its texture pieces, piece_row / piece_rows /
    piece_c0 / piece_c1 / piece_pad [T, 3] (blocks [c0, c1) of rows
    [row, row + rows); pad: the piece also owns those rows' pitch
    padding; rows 0: no piece).

    A narrow mip (two rows with their padding fit tile_bytes) takes
    tile_bytes // (2 pitch) row pairs a tile; a wide one cuts each pair
    into chunks of tile_bytes // (4 block bytes) column pairs: in a
    swizzled pair, row 2p's groups, row 2p + 1's groups (the last chunk
    with the remainder column and the padding) and, in the chunk that
    holds conditioned block eff_w - 1 of the pair, row 2p's remainder and
    padding; an unswizzled pair is cut row-major, 4 * per blocks a
    chunk."""
    g = geom.tolist()
    bb, nm, nsub = g[G_BB], g[G_NMIPS], g[G_NSUB]
    cols = {k: [] for k in ("mip", "narrow", "row0", "rows", "cp0", "cp1",
                            "b0", "b1", "piece_row", "piece_rows",
                            "piece_c0", "piece_c1", "piece_pad")}
    i64 = dict(dtype=torch.int64)
    for m in range(nm):
        w, h, pitch, _, mipblk = _mip(g, m)[:5]
        if w <= 0 or h <= 0:
            continue
        units = (h + 1) // 2
        swz = bool(g[G_SWIZZLE]) and w >= 2 and h >= 2
        rem_w = w % 2
        eff_w, eff_h = w - rem_w, (h - h % 2 if swz else 0)
        ncp = (w + 1) // 2
        if 2 * pitch <= tile_bytes:
            per = tile_bytes // (2 * pitch)
            u = torch.arange(-(-units // per), **i64)
            r0 = 2 * u * per
            r1 = torch.clamp(r0 + 2 * per, max=h)
            l0, l1 = r0 * w, r1 * w
            none = torch.zeros_like(u)
            pr = torch.stack([r0, none - 1, none - 1], 1)
            prows = torch.stack([r1 - r0, none, none], 1)
            pc0 = torch.zeros_like(prows)
            pc1 = torch.stack([torch.full_like(u, w), none, none], 1)
            ppad = torch.stack([torch.ones_like(u), none, none], 1)
            new = dict(narrow=torch.ones_like(u), row0=r0, rows=r1 - r0,
                       cp0=none, cp1=torch.full_like(u, ncp))
        else:
            per = tile_bytes // (4 * bb)
            C = -(-ncp // per)
            u = torch.arange(units * C, **i64)
            p, i = u // C, u % C
            r0 = 2 * p
            nr = torch.clamp(h - r0, max=2)
            j0 = i * per
            j1 = torch.clamp(j0 + per, max=ncp)
            last = j1 == ncp

            def cut(e):
                return e + torch.where(e >= eff_w, rem_w, 0)
            sw = r0 + 1 < eff_h
            base = r0 * w
            l0_s = base + cut(4 * j0)
            l1_s = base + torch.where(last, 2 * w, cut(4 * j1))
            total = nr * w
            s_lin = torch.clamp(i * 4 * per, max=total)
            e_lin = torch.clamp(s_lin + 4 * per, max=total)
            l0 = torch.where(sw, l0_s, base + s_lin)
            l1 = torch.where(sw, l1_s, base + e_lin)
            # swizzled: A (row 2p's groups), B (row 2p + 1's), X (row 2p's
            # remainder and padding); row-major: P1 from block s, P2 past
            # the row's end
            rs = s_lin // w
            end0 = (rs + 1) * w
            p1_ok = s_lin < e_lin
            slots = [
                (torch.where(sw, 2 * j0 < eff_w, p1_ok),
                 torch.where(sw, r0, r0 + rs),
                 torch.where(sw, 2 * j0, s_lin - rs * w),
                 torch.where(sw, torch.clamp(2 * j1, max=eff_w),
                             torch.minimum(e_lin, end0) - rs * w),
                 torch.where(sw, False, e_lin >= end0)),
                (torch.where(sw, True, p1_ok & (e_lin > end0)),
                 torch.where(sw, r0 + 1, r0 + rs + 1),
                 torch.where(sw, 2 * j0, 0),
                 torch.where(sw, torch.clamp(2 * j1, max=w), e_lin - end0),
                 torch.where(sw, last, e_lin == end0 + w)),
                (sw & (4 * j0 <= eff_w - 1) & (eff_w - 1 < 4 * j1),
                 r0, torch.full_like(u, eff_w), torch.full_like(u, w),
                 torch.ones_like(u, dtype=torch.bool)),
            ]
            # packed in that order, as the kernel keeps them
            ok = torch.stack([sl[0] for sl in slots], 1)
            rank = torch.cumsum(ok.long(), 1) - 1
            tix = torch.arange(len(u))[:, None].expand_as(rank)
            pr = torch.full((len(u), 3), -1, **i64)
            prows, pc0, pc1, ppad = (torch.zeros_like(pr) for _ in range(4))
            for f, dst in ((1, pr), (2, pc0), (3, pc1), (4, ppad)):
                vals = torch.stack([sl[f].long() for sl in slots], 1)
                dst[tix[ok], rank[ok]] = vals[ok]
            prows[tix[ok], rank[ok]] = 1
            new = dict(narrow=0 * u, row0=r0, rows=nr, cp0=j0, cp1=j1)
        new.update(mip=torch.full_like(u, m), b0=mipblk + l0, b1=mipblk + l1,
                   piece_row=pr, piece_rows=prows, piece_c0=pc0,
                   piece_c1=pc1, piece_pad=ppad.long())
        for k in cols:
            cols[k].append(new[k])
    plan = {k: (torch.cat(v) if v else torch.zeros(
        (0, 3) if k.startswith("piece") else 0, **i64))
            for k, v in cols.items()}
    sizes = torch.tensor(g[G_SUB_SIZE: G_SUB_SIZE + nsub], **i64)
    starts = torch.tensor(g[G_STREAM_OFF: G_STREAM_OFF + nsub], **i64)
    plan["seg0"] = starts[None, :] + plan["b0"][:, None] * sizes[None, :]
    return plan


def _mip_fields(g, mip):
    """Per-element (w, h, pitch, bytes, mipblk) of each entry's mip."""
    nm = g[G_NMIPS]
    mips = torch.tensor(g[G_MIP: G_MIP + nm * G_MIP_FIELDS],
                        dtype=torch.int64).view(nm, -1)
    return [mips[:, f][mip] for f in range(5)]


def mip_cond(g, mip, r, c):
    """Block (r, c) of mip `mip` as its index among the mip's conditioned
    blocks (the kernels' closed form: the pair's groups, counted past row
    2p's remainder block)."""
    w, h = _mip_fields(g, mip)[:2]
    swz = bool(g[G_SWIZZLE]) & (w >= 2) & (h >= 2)
    rem_w = w % 2
    eff_w = w - rem_w
    eff_h = torch.where(swz, h - h % 2, 0)
    e = 4 * (c // 2) + 2 * (r % 2) + c % 2
    e = e + torch.where(e >= eff_w, rem_w, 0)
    return torch.where((r < eff_h) & (c < eff_w), (r - r % 2) * w + e,
                       r * w + c)


def tile_blocks(geom: torch.Tensor, plan: dict) -> tuple:
    """Every texture block of every tile's pieces: (tile, conditioned block
    index, texture offset of its first byte), int64 [blocks] each."""
    g = geom.tolist()
    tiles, conds, addrs = [], [], []
    for q in range(3):
        rows = plan["piece_rows"][:, q]
        ncols = plan["piece_c1"][:, q] - plan["piece_c0"][:, q]
        nblk = (rows * ncols).clamp(min=0)
        t = torch.repeat_interleave(torch.arange(len(rows)), nblk)
        first = torch.cumsum(nblk, 0) - nblk
        local = torch.arange(int(nblk.sum())) - first[t]
        r = plan["piece_row"][t, q] + local // ncols[t]
        c = plan["piece_c0"][t, q] + local % ncols[t]
        mip = plan["mip"][t]
        w, h, pitch, bytes_, mipblk = _mip_fields(g, mip)
        tiles.append(t)
        conds.append(mipblk + mip_cond(g, mip, r, c))
        addrs.append(bytes_ + r * pitch + c * g[G_BB])
    return tuple(torch.cat(v) for v in (tiles, conds, addrs))


def tile_ranges(geom: torch.Tensor, plan: dict) -> tuple:
    """Each tile piece's texture bytes: (start, end) int64 [T, 3], the
    pitch padding a piece owns included (empty pieces: start == end)."""
    g = geom.tolist()
    w, h, pitch, bytes_, _ = _mip_fields(g, plan["mip"])
    w, pitch, bytes_ = w[:, None], pitch[:, None], bytes_[:, None]
    row, rows = plan["piece_row"], plan["piece_rows"]
    c0, c1, pad = plan["piece_c0"], plan["piece_c1"], plan["piece_pad"]
    start = bytes_ + row * pitch + c0 * g[G_BB]
    end = torch.where(pad.bool(), bytes_ + (row + rows) * pitch,
                      bytes_ + (row + rows - 1) * pitch + c1 * g[G_BB])
    ok = rows > 0
    return torch.where(ok, start, 0), torch.where(ok, end, 0)


def lookback_carries(x: torch.Tensor, geom: torch.Tensor,
                     plan: dict | None = None) -> torch.Tensor:
    """The carries the postprocess's look-back computes, int64 [T,
    ncolor]: for each tile and colour sub-stream, the sum modulo 256 of
    the bytes before the tile's segment since the last span start (a page
    start or the sub-stream's start), as the kernel derives it: each
    tile's element (start seen, sum since its last start), then an
    exclusive segmented scan of the elements over the tiles. The kernel
    reads a carry only where the segment's first byte lies in a flagged
    page and starts no span."""
    g = geom.tolist()
    plan = tile_plan(geom) if plan is None else plan
    ps = g[G_PAGE]
    T = len(plan["b0"])
    out = torch.zeros((T, g[G_NCOLOR]), dtype=torch.int64)
    c = torch.cat([x.new_zeros(1, dtype=torch.int64),
                   torch.cumsum(x.to(torch.int64).cpu(), 0)])
    t_idx = torch.arange(T)
    for ci in range(g[G_NCOLOR]):
        k = g[G_COLOR + ci]
        s0, sz = g[G_STREAM_OFF + k], g[G_SUB_SIZE + k]
        gs = plan["seg0"][:, k]
        ge = gs + (plan["b1"] - plan["b0"]) * sz
        # the last span start in [gs, ge): the page start before ge, or s0
        last = torch.maximum((ge - 1) // ps * ps, torch.full_like(gs, s0))
        started = (ge > gs) & (last >= gs)
        val = torch.where(started, c[ge] - c[last.clamp(min=0)],
                          c[ge] - c[gs]) & 255
        # exclusive segmented scan over the tiles
        incl = torch.cumsum(val, 0)
        mark = torch.where(started, t_idx, -1)
        prev = torch.cummax(mark, 0).values
        before = torch.cat([prev.new_full((1,), -1), prev[:-1]])
        s_before = torch.cat([incl.new_zeros(1), incl[:-1]])
        from_start = s_before - torch.where(before >= 0, incl[before.clamp(
            min=0)], 0) + torch.where(before >= 0, val[before.clamp(min=0)],
                                      0)
        out[:, ci] = from_start & 255
    return out


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------

def _check(x: torch.Tensor, geom: torch.Tensor) -> None:
    if (geom.device.type != "cpu" or geom.dtype != torch.int64
            or geom.shape != (G_LEN,) or not geom.is_contiguous()):
        raise ValueError("geometry record: want int64 [G_LEN] on the CPU, "
                         "from pack_geometry")
    n = int(geom[G_N])
    if x.dtype != torch.uint8 or x.dim() != 1 or x.shape[0] != n:
        raise ValueError(f"stream: want uint8 [{n}], got {x.dtype} "
                         f"{tuple(x.shape)}")


def _aligned(*tensors) -> None:
    """The kernels' bulk copies and vector stores take 16-byte aligned
    tensors."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError("texture kernel argument is not 16-byte "
                             "aligned")


def _device_flags(flags, dev):
    """The CPU flags on the card (an asynchronous copy from page-locked
    memory), or None."""
    if flags is None:
        return None
    return flags.pin_memory().to(dev, non_blocking=True)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _record(geom: torch.Tensor, dev, post: bool):
    """A zeroed per-CTA record for a launch on dev."""
    with torch.cuda.device(dev):
        grid = _kernels.library().blg_precond_grid(geom.data_ptr(),
                                                   int(post))
    if grid <= 0:
        raise ValueError("geometry record the texture kernels refuse")
    return torch.zeros((grid, REC_WORDS), dtype=torch.int64, device=dev)


def lookback_words(geom: torch.Tensor, dev) -> torch.Tensor:
    """The postprocess's look-back buffer, zeroed on dev: int32 [2 +
    tiles x colours] (a tile counter, a count of finished CTAs, a word a
    tile and colour). The kernel leaves it zeroed."""
    tiles = _kernels.library().blg_precond_tiles(geom.data_ptr())
    if tiles < 0:
        raise ValueError("geometry record the texture kernels refuse")
    return torch.zeros(2 + tiles * int(geom[G_NCOLOR]), dtype=torch.int32,
                       device=dev)


def postprocess_cuda(x: torch.Tensor, geom: torch.Tensor, flags=None,
                     out: torch.Tensor | None = None,
                     return_record: bool = False):
    """blg_postprocess on x's device and current stream: what
    postprocess_plain computes, into `out` (uint8 [n] on that device, a
    new tensor when None). Every byte of out is written. The look-back's
    words are allocated for the call and freed after it. With
    return_record, returns (out, the per-CTA record, int64 [grid,
    REC_WORDS])."""
    _check(x, geom)
    x = x.contiguous()
    dev = x.device
    if out is None:
        out = torch.empty_like(x)
    fl = _device_flags(flags, dev)
    _kernels.check_cuda_args(x, out, *([] if fl is None else [fl]))
    _aligned(x, out)
    rec = _record(geom, dev, True) if return_record else None
    if x.shape[0]:
        work = lookback_words(geom, dev)
        _kernels.launch("precond", "blg_postprocess", dev, geom.data_ptr(),
                        x.data_ptr(), _ptr(fl), out.data_ptr(),
                        work.data_ptr(), _ptr(rec))
    return (out, rec) if return_record else out


def preprocess_cuda(x: torch.Tensor, geom: torch.Tensor, flags=None,
                    out: tuple | None = None, return_record: bool = False):
    """blg_preprocess on x's device and current stream: what
    preprocess_plain computes, (conditioned, delta), into `out` (two
    uint8 [n] tensors on that device, new ones when None). Where flags
    are given and none is set, delta is the conditioned tensor itself and
    the kernel writes only that. With return_record, returns (conditioned,
    delta, the per-CTA record)."""
    _check(x, geom)
    x = x.contiguous()
    dev = x.device
    cond, delta = (torch.empty_like(x), torch.empty_like(x)) \
        if out is None else out
    if flags is not None and not bool(flags.any()):
        delta = cond
    fl = _device_flags(flags, dev)
    _kernels.check_cuda_args(x, cond, delta,
                             *([] if fl is None else [fl]))
    _aligned(x, cond, delta)
    rec = _record(geom, dev, False) if return_record else None
    if x.shape[0]:
        _kernels.launch("precond", "blg_preprocess", dev, geom.data_ptr(),
                        x.data_ptr(), _ptr(fl), cond.data_ptr(),
                        None if delta is cond else delta.data_ptr(),
                        _ptr(rec))
    return (cond, delta, rec) if return_record else (cond, delta)
