"""Brotli-G format constants (the port's copy of brotlig_tpu/format/
constants.py, unchanged in value).

These constants define the Brotli-G bitstream format and must match the
reference SDK exactly (reference: inc/common/BrotligConstants.h).
tests/test_torch_api.py holds every value to the JAX package's.
"""

# ---------------------------------------------------------------------------
# Symbol alphabets (ref: BrotligConstants.h:32-42)
# ---------------------------------------------------------------------------
NUM_LITERAL_SYMBOLS = 256
NUM_COMMAND_SYMBOLS = 704          # RFC 7932 insert&copy codes
SENTINEL_COMMAND = NUM_COMMAND_SYMBOLS          # 704: end-of-page marker
NUM_END_LITERAL_SYMBOLS = 23       # insert-only tail codes 705..727
NUM_COMMAND_SYMBOLS_WITH_SENTINEL = NUM_COMMAND_SYMBOLS + 1
NUM_COMMAND_SYMBOLS_EFFECTIVE = (
    NUM_COMMAND_SYMBOLS_WITH_SENTINEL + NUM_END_LITERAL_SYMBOLS
)  # 728
NUM_DISTANCE_SYMBOLS = 544

# RFC 7932 code-length-code alphabet (for complex Huffman table storage)
CODE_LENGTH_CODES = 18
REPEAT_PREVIOUS_CODE_LENGTH = 16
REPEAT_ZERO_CODE_LENGTH = 17
INITIAL_REPEATED_CODE_LENGTH = 8

# ---------------------------------------------------------------------------
# Stream header (ref: BrotligConstants.h:47-62, DataStream.h:28-87)
# ---------------------------------------------------------------------------
STREAM_ID = 5
STREAM_ID_BITS = 8
STREAM_MAGIC_BITS = 8
STREAM_NUM_PAGES_BITS = 16
STREAM_PAGE_SIZE_IDX_BITS = 2
STREAM_LASTPAGE_SIZE_BITS = 18
STREAM_PRECONDITION_BITS = 1
STREAM_RESERVED_BITS = 11
STREAM_HEADER_SIZE_BYTES = 8

# ---------------------------------------------------------------------------
# Page header (ref: BrotligConstants.h:65-74)
# ---------------------------------------------------------------------------
PAGE_HEADER_NPOSTFIX_BITS = 2
PAGE_HEADER_NDIST_BITS = 4
PAGE_HEADER_ISDELTAENCODED_BITS = 1
PAGE_HEADER_RESERVED_BITS = 1
PAGE_HEADER_SIZE_BITS = 8
PAGE_HEADER_SIZE_BYTES = 1

# ---------------------------------------------------------------------------
# Core format parameters (ref: BrotligConstants.h:77-94)
# ---------------------------------------------------------------------------
MAX_NUM_BITSTREAMS = 64
NUM_BITSTREAMS = 32                # default / only supported lane count
COMMAND_GROUP_SIZE = 1
SWIZZLE_SIZE = 4
MIN_PAGE_SIZE = 32 * 1024
DEFAULT_PAGE_SIZE = 64 * 1024
MAX_PAGE_SIZE = 128 * 1024
DATA_ALIGNMENT = 4
MAX_NUM_PAGES = (1 << STREAM_NUM_PAGES_BITS) - 1
INPUT_BIT_MASK = 262143            # 2^18-1 ring mask used by the LZ stage

# ---------------------------------------------------------------------------
# Huffman limits (ref: BrotligConstants.h:97-110)
# ---------------------------------------------------------------------------
HUFFMAN_MAX_DEPTH = 15
HUFFMAN_NUM_CODE_LENGTH = 16              # lengths 0..15
HUFFMAN_TABLE_BITS = 15                   # flat decode table = 2^15 entries
HUFFMAN_TABLE_SIZE = 1 << HUFFMAN_TABLE_BITS
# Code-length-code ("RLE tree") limits: 9-bit max depth, 2^9 table
HUFFMAN_MAX_CODE_LENGTH_CODE_LENGTH = 9
HUFFMAN_CODE_LENGTH_TABLE_BITS = 9
HUFFMAN_CODE_LENGTH_TABLE_SIZE = 1 << 9

NUM_HUFFMAN_TREES = 3
ICP_TREE_INDEX = 0
DIST_TREE_INDEX = 1
LIT_TREE_INDEX = 2

# ---------------------------------------------------------------------------
# Distance coding
# ---------------------------------------------------------------------------
NUM_DISTANCE_SHORT_CODES = 16
MAX_NPOSTFIX = 3
DISTANCE_RING_INIT = (4, 11, 15, 16)

# Serialization granularity
DWORD_SIZE_BITS = 32
DWORD_SIZE_BYTES = 4

# ---------------------------------------------------------------------------
# Preconditioner (ref: BrotligConstants.h:131-243)
# ---------------------------------------------------------------------------
PRECON_SWIZZLING_BITS = 1
PRECON_PITCH_D3D12_ALIGNED_FLAG_BITS = 1
PRECON_TEX_WIDTH_BLOCK_BITS = 15
PRECON_TEX_HEIGHT_BLOCK_BITS = 15
PRECON_DATA_FORMAT_BITS = 8
PRECON_TEX_NUMMIPLEVELS_BITS = 5
PRECON_TEX_PITCH_BYTES_BITS = 19
PRECON_HEADER_SIZE_BYTES = 8

PRECON_MAX_TEX_WIDTH_BLOCK = 1 << PRECON_TEX_WIDTH_BLOCK_BITS
PRECON_MAX_TEX_HEIGHT_BLOCK = 1 << PRECON_TEX_HEIGHT_BLOCK_BITS
PRECON_MAX_TEX_PITCH_BYTES = 1 << PRECON_TEX_PITCH_BYTES_BITS
PRECON_MAX_NUM_MIP_LEVELS = 1 << PRECON_TEX_NUMMIPLEVELS_BITS

D3D12_TEXTURE_PITCH_ALIGNMENT_BYTES = 256
PRECON_SWIZZLE_REGION_SIZE = 2
PRECON_DELTA_BASES_SIZE_BYTES = 4

# Data formats (ref: BrotligCommon.h:76-83)
DATA_FORMAT_UNKNOWN = 0
DATA_FORMAT_BC1 = 1
DATA_FORMAT_BC2 = 2
DATA_FORMAT_BC3 = 3
DATA_FORMAT_BC4 = 4
DATA_FORMAT_BC5 = 5

# Per-format sub-block geometry: (block_size_bytes, block_size_pixels,
# sub_block_sizes, color_sub_block_indices)
# ref: BrotligConstants.h:179-239, BrotligDataConditioner.h:96-183
BCN_GEOMETRY = {
    DATA_FORMAT_BC1: dict(block_bytes=8, block_pixels=4,
                          sub_sizes=(2, 2, 4), color_subs=(0, 1)),
    DATA_FORMAT_BC2: dict(block_bytes=16, block_pixels=4,
                          sub_sizes=(8, 2, 2, 4), color_subs=(1, 2)),
    DATA_FORMAT_BC3: dict(block_bytes=16, block_pixels=4,
                          sub_sizes=(1, 1, 6, 2, 2, 4), color_subs=(3, 4)),
    DATA_FORMAT_BC4: dict(block_bytes=8, block_pixels=4,
                          sub_sizes=(1, 1, 6), color_subs=(0, 1)),
    DATA_FORMAT_BC5: dict(block_bytes=16, block_pixels=4,
                          sub_sizes=(1, 1, 6, 1, 1, 6), color_subs=(0, 1, 3, 4)),
}

# Page-size index encoding: page_size = MIN_PAGE_SIZE << idx
PAGE_SIZE_CHOICES = (32 * 1024, 64 * 1024, 128 * 1024)


def page_size_index(page_size: int) -> int:
    """PageSizeIdx such that MIN_PAGE_SIZE << idx == page_size."""
    idx = (page_size // MIN_PAGE_SIZE).bit_length() - 1
    if MIN_PAGE_SIZE << idx != page_size:
        raise ValueError(f"page_size {page_size} is not 32K<<k")
    return idx


def max_compressed_page_size(page_size: int) -> int:
    """Upper bound on one compressed page (ref: PageEncoder.h:286-289).

    The reference uses 2 * BrotliEncoderMaxCompressedSize(page); we reproduce
    that bound (brotli v1.0.9: size + overhead where overhead is small).
    """
    num_large_blocks = page_size >> 14
    overhead = 2 + (4 * num_large_blocks) + 3 + 1
    return 2 * (page_size + overhead)


def max_compressed_size(input_size: int, precondition: bool = False,
                        deltaencode: bool = False,
                        page_size: int = DEFAULT_PAGE_SIZE) -> int:
    """Worst-case container size (ref: BrotligEncoder.cpp:35-48)."""
    num_pages = (input_size + page_size - 1) // page_size
    est = (num_pages * max_compressed_page_size(page_size)
           + num_pages * PAGE_HEADER_SIZE_BYTES + STREAM_HEADER_SIZE_BYTES
           + num_pages * 4)  # page table (u32 per page)
    if precondition:
        est += PRECON_HEADER_SIZE_BYTES
        if deltaencode:
            est += num_pages * PRECON_DELTA_BASES_SIZE_BYTES
    return est
