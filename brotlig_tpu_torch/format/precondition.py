"""BCn texture preconditioning geometry: the part of brotlig_tpu/format/
precondition.py that container parsing reaches (headers.parse_container
builds DataConditionParams and checks it against the output size). The
index maps and delta coding come with the preconditioned-decode slice.
"""
from __future__ import annotations

from dataclasses import dataclass, field

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
