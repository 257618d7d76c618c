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
PAGE_ALIGN = 128         # the kernels cut a page into 8 slices of 16 bytes


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


def _device_flags(flags, dev):
    """The CPU flags on the card (an asynchronous copy from page-locked
    memory), or None."""
    if flags is None:
        return None
    return flags.pin_memory().to(dev, non_blocking=True)


def postprocess_cuda(x: torch.Tensor, geom: torch.Tensor, flags=None,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """blg_postprocess on x's device and current stream: what
    postprocess_plain computes, into `out` (uint8 [n] on that device, a
    new tensor when None). Every byte of out is written."""
    _check(x, geom)
    x = x.contiguous()
    dev = x.device
    if out is None:
        out = torch.empty_like(x)
    fl = _device_flags(flags, dev)
    _kernels.check_cuda_args(x, out, *([] if fl is None else [fl]))
    if x.shape[0]:
        _kernels.launch("precond", "blg_postprocess", dev, geom.data_ptr(),
                        x.data_ptr(), None if fl is None else fl.data_ptr(),
                        out.data_ptr())
    return out


def preprocess_cuda(x: torch.Tensor, geom: torch.Tensor, flags=None,
                    out: tuple | None = None) -> tuple:
    """blg_preprocess on x's device and current stream: what
    preprocess_plain computes, (conditioned, delta), into `out` (two
    uint8 [n] tensors on that device, new ones when None). Where flags
    are given and none is set, delta is the conditioned tensor itself and
    the kernel writes only that."""
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
    if x.shape[0]:
        _kernels.launch("precond", "blg_preprocess", dev, geom.data_ptr(),
                        x.data_ptr(), None if fl is None else fl.data_ptr(),
                        cond.data_ptr(),
                        None if delta is cond else delta.data_ptr())
    return cond, delta
