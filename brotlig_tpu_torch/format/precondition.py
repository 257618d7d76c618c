"""BCn texture preconditioning: sub-block split, 2x2 block swizzle, per-page
delta coding, and their inverses as vectorized index maps. The port's copy
of brotlig_tpu/format/precondition.py, unchanged in behaviour.

The reference conditions with an explicit gather (BrotligDataConditioner.cpp)
and deconditions with a closed-form per-byte address transform
(PageDecoder.cpp:406-444). Here both directions use one precomputed index
map `cond_map` where `conditioned[i] == original[cond_map[i]]`, built with
vectorized NumPy from the same closed form; ops/precondition.py uses it as
a gather index on the device.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import constants as C


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclass
class DataConditionParams:
    precondition: bool = False
    swizzle: bool = False
    delta_encode: bool = False
    format: int = C.DATA_FORMAT_UNKNOWN
    width_in_pixels: int = 0
    height_in_pixels: int = 0
    num_mip_levels: int = 1
    row_pitch_in_bytes: int = 0
    pitch_d3d12_aligned: bool = False

    # derived geometry (mirrors BrotligDataConditioner.h:92-237)
    block_size_bytes: int = 1
    block_size_pixels: int = 1
    sub_block_sizes: tuple = ()
    sub_block_offsets: tuple = ()
    color_sub_blocks: tuple = ()
    width_in_blocks: list = field(default_factory=lambda: [0] * 33)
    height_in_blocks: list = field(default_factory=lambda: [0] * 33)
    pitch_in_bytes: list = field(default_factory=lambda: [0] * 33)
    num_blocks: list = field(default_factory=lambda: [0] * 33)
    sub_stream_offsets: list = field(default_factory=list)
    mip_offsets_bytes: list = field(default_factory=lambda: [0] * 34)
    mip_offset_blocks: list = field(default_factory=lambda: [0] * 34)
    t_num_blocks: int = 0
    initialized: bool = False

    def check(self):
        if self.width_in_pixels > 4 * C.PRECON_MAX_TEX_WIDTH_BLOCK:
            raise ValueError("texture too wide")
        if self.height_in_pixels > 4 * C.PRECON_MAX_TEX_HEIGHT_BLOCK:
            raise ValueError("texture too tall")
        if self.row_pitch_in_bytes > C.PRECON_MAX_TEX_PITCH_BYTES:
            raise ValueError("pitch too large")
        if self.num_mip_levels > C.PRECON_MAX_NUM_MIP_LEVELS:
            raise ValueError("too many mips")

    def initialize(self, input_size: int) -> bool:
        if self.initialized:
            return True
        geo = C.BCN_GEOMETRY.get(self.format)
        if geo is None:
            self.block_size_bytes = 1
            self.block_size_pixels = 1
            self.sub_block_sizes = (1,)
            self.color_sub_blocks = ()
        else:
            self.block_size_bytes = geo["block_bytes"]
            self.block_size_pixels = geo["block_pixels"]
            self.sub_block_sizes = geo["sub_sizes"]
            self.color_sub_blocks = geo["color_subs"]

        if self.num_mip_levels == 0:
            self.num_mip_levels = 1
        bp = self.block_size_pixels
        if self.width_in_blocks[0] == 0:
            self.width_in_blocks[0] = (self.width_in_pixels + bp - 1) // bp
        if self.height_in_blocks[0] == 0:
            self.height_in_blocks[0] = (self.height_in_pixels + bp - 1) // bp
        if self.width_in_pixels == 0:
            self.width_in_pixels = self.width_in_blocks[0] * bp
        if self.height_in_pixels == 0:
            self.height_in_pixels = self.height_in_blocks[0] * bp

        self.num_blocks[0] = self.width_in_blocks[0] * self.height_in_blocks[0]
        self.t_num_blocks = self.num_blocks[0]
        if self.pitch_in_bytes[0] == 0:
            if self.row_pitch_in_bytes:
                self.pitch_in_bytes[0] = self.row_pitch_in_bytes
            else:
                p = self.width_in_blocks[0] * self.block_size_bytes
                if self.pitch_d3d12_aligned:
                    p = _round_up(p, C.D3D12_TEXTURE_PITCH_ALIGNMENT_BYTES)
                self.pitch_in_bytes[0] = p

        mipw = (self.width_in_blocks[0] * bp) // 2
        miph = (self.height_in_blocks[0] * bp) // 2
        for mip in range(1, self.num_mip_levels + 1):
            if mip < self.num_mip_levels:
                self.width_in_blocks[mip] = (mipw + bp - 1) // bp
                self.height_in_blocks[mip] = (miph + bp - 1) // bp
                self.num_blocks[mip] = (self.width_in_blocks[mip]
                                        * self.height_in_blocks[mip])
                p = self.width_in_blocks[mip] * self.block_size_bytes
                if self.pitch_d3d12_aligned:
                    p = _round_up(p, C.D3D12_TEXTURE_PITCH_ALIGNMENT_BYTES)
                self.pitch_in_bytes[mip] = p
                self.t_num_blocks += self.num_blocks[mip]
            self.mip_offsets_bytes[mip] = (
                self.mip_offsets_bytes[mip - 1]
                + self.pitch_in_bytes[mip - 1]
                * self.height_in_blocks[mip - 1])
            self.mip_offset_blocks[mip] = (
                self.mip_offset_blocks[mip - 1] + self.num_blocks[mip - 1])
            mipw //= 2
            miph //= 2

        if self.mip_offsets_bytes[self.num_mip_levels] != input_size:
            return False

        nsub = len(self.sub_block_sizes)
        self.sub_block_offsets = tuple(
            int(sum(self.sub_block_sizes[:k])) for k in range(nsub))
        self.sub_stream_offsets = [0] * (nsub + 1)
        for sub in range(1, nsub + 1):
            self.sub_stream_offsets[sub] = (
                self.sub_stream_offsets[sub - 1]
                + self.sub_block_sizes[sub - 1] * self.t_num_blocks)
        if (self.sub_stream_offsets[nsub]
                != self.t_num_blocks * self.block_size_bytes):
            return False
        self.initialized = True
        return True


def build_cond_map(params: DataConditionParams) -> np.ndarray:
    """conditioned-index -> original-index map over the sub-stream region.

    Vectorization of DeconditionBC1_5 (PageDecoder.cpp:406-444): for every
    byte of every sub-stream compute its (mip, row, col, sub-block, byte)
    address, undoing the optional 2x2 block-tile swizzle.
    """
    maps = []
    region = C.PRECON_SWIZZLE_REGION_SIZE
    for sub, sub_size in enumerate(params.sub_block_sizes):
        total = params.t_num_blocks * sub_size
        idx = np.arange(total, dtype=np.int64)
        mip_block_starts = np.asarray(
            params.mip_offset_blocks[: params.num_mip_levels + 1],
            dtype=np.int64) * sub_size
        mip = np.searchsorted(mip_block_starts, idx, side="right") - 1
        adj = idx - mip_block_starts[mip]
        block = adj // sub_size
        widths = np.asarray(params.width_in_blocks[: params.num_mip_levels],
                            dtype=np.int64)
        heights = np.asarray(params.height_in_blocks[: params.num_mip_levels],
                             dtype=np.int64)
        pitches = np.asarray(params.pitch_in_bytes[: params.num_mip_levels],
                             dtype=np.int64)
        w = widths[mip]
        h = heights[mip]
        row = block // w
        col = block % w

        if params.swizzle:
            rem_w = w % region
            rem_h = h % region
            eff_w = w - rem_w
            eff_h = h - rem_h
            swz = (w >= region) & (h >= region) & (row < eff_h) & (col < eff_w)
            eff_block = block - row * rem_w
            width_grps = np.maximum(eff_w // region, 1)
            grp = eff_block // (region * region)
            in_grp = eff_block % (region * region)
            orow = region * (grp // width_grps) + in_grp // region
            ocol = region * (grp % width_grps) + in_grp % region
            row = np.where(swz, orow, row)
            col = np.where(swz, ocol, col)

        mip_pos = np.asarray(params.mip_offsets_bytes, dtype=np.int64)[mip]
        out = (mip_pos + row * pitches[mip]
               + col * params.block_size_bytes
               + params.sub_block_offsets[sub]
               + adj % sub_size)
        maps.append(out)
    return np.concatenate(maps) if maps else np.zeros(0, dtype=np.int64)


def condition(data: bytes, params: DataConditionParams) -> bytes:
    """Forward preconditioning (== reference Condition, via the shared map)."""
    arr = np.frombuffer(data, dtype=np.uint8)
    cond_map = build_cond_map(params)
    out = np.zeros(len(arr), dtype=np.uint8)
    out[: len(cond_map)] = arr[cond_map]
    return out.tobytes()


def decondition(conditioned: bytes, params: DataConditionParams) -> bytes:
    """Inverse preconditioning: scatter back to texture addresses."""
    arr = np.frombuffer(conditioned, dtype=np.uint8)
    cond_map = build_cond_map(params)
    out = np.zeros(len(arr), dtype=np.uint8)
    out[cond_map] = arr[: len(cond_map)]
    return out.tobytes()


def _color_intersections(page_start: int, page_end: int,
                         params: DataConditionParams):
    """Page-local (start, end) slices of color sub-streams in this page."""
    spans = []
    for sub in params.color_sub_blocks:
        c0 = params.sub_stream_offsets[sub]
        c1 = params.sub_stream_offsets[sub + 1]
        if c0 < page_end and page_start < c1:
            s = c0 - page_start if c0 > page_start else 0
            e = c1 - page_start if c1 < page_end else page_end - page_start
            spans.append((s, e))
    return spans


def delta_encode_page(page: bytes, page_start: int,
                      params: DataConditionParams):
    """Per-page byte delta over color sub-stream intersections
    (ref: PageEncoder.cpp:576-612). Returns (bytes, was_encoded)."""
    arr = np.frombuffer(page, dtype=np.uint8).copy()
    spans = _color_intersections(page_start, page_start + len(page), params)
    for s, e in spans:
        seg = arr[s:e]
        if len(seg) > 1:
            arr[s + 1: e] = np.diff(seg.astype(np.int16)).astype(np.uint8)
    return arr.tobytes(), bool(spans)


def delta_decode_page(page: bytes, page_start: int,
                      params: DataConditionParams) -> bytes:
    """Inverse of delta_encode_page: per-span prefix sum mod 256
    (ref: PageDecoder.cpp:446-471)."""
    arr = np.frombuffer(page, dtype=np.uint8).copy()
    for s, e in _color_intersections(page_start, page_start + len(page),
                                     params):
        seg = arr[s:e]
        arr[s:e] = np.cumsum(seg.astype(np.int64)).astype(np.uint8)
    return arr.tobytes()
