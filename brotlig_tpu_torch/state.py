"""The state both packages compute and consume: the staged page buffer and
the Huffman tables. A codec has no weights; these conversions let a test
feed the port's decode step exactly what the JAX side computed, so that a
table mismatch and a decode mismatch show up separately.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .format import constants as C

from .ops.tables import build_search


class Staged(NamedTuple):
    """A batch of compressed pages as native.stage_pages lays them out:
    buf [Wc, P, 128] int32, word w of sub-stream s of page p at flat
    position w*32+s of row p (the JAX kernels' input layout), and npd
    [P, 4] int32 = (npostfix, ndirect, isdelta, 0)."""
    buf: torch.Tensor
    npd: torch.Tensor


class Tables(NamedTuple):
    """Per-page decode tables: for each of the three prefix codes a
    (search, trivial) pair, where search is tables.build_search's dict
    (limit/first/offset [P, 17], symdict [P, A]) and trivial [P] is the
    trivial-mode symbol or -1; bp [P, 32] holds each sub-stream's bit
    cursor past the tables, local to its stream."""
    bp: torch.Tensor
    icp: tuple
    dst: tuple
    lit: tuple


class KernelTables(NamedTuple):
    """Per-page decode tables as the fused decode and phase-A kernels read
    them, all int32: meta [P, 3, 3, 17] (limit, first, offset of each of
    the three codes), dicts [P, 728+544+256] (the canonical symbol
    dictionaries, side by side), trivs [P, 3] (trivial symbol or -1) and
    bp [P, 32] (each sub-stream's cursor past the tables). The tables
    kernel writes them; pack_tables makes them from Tables."""
    meta: torch.Tensor
    dicts: torch.Tensor
    trivs: torch.Tensor
    bp: torch.Tensor


def staged_from_numpy(buf3_np: np.ndarray, npd_np: np.ndarray,
                      device) -> Staged:
    """native.stage_pages' (buf3 [Wc, P, 128], npd [P, 4]) -> Staged on
    `device`. The layout stays as staged: the kernels index it directly."""
    if buf3_np.ndim != 3 or buf3_np.shape[2] != 128:
        raise ValueError(f"staged buffer shape {buf3_np.shape}")
    buf = torch.from_numpy(np.ascontiguousarray(buf3_np, np.int32))
    npd = torch.from_numpy(np.ascontiguousarray(npd_np, np.int32))
    return Staged(buf.to(device), npd.to(device))


def _search(lengths):
    return build_search(lengths, C.HUFFMAN_NUM_CODE_LENGTH,
                        C.HUFFMAN_TABLE_BITS)


def tables_from_lengths(lengths_icp, lengths_dst, lengths_lit, trivs,
                        bp) -> Tables:
    """Code lengths [P, A] x 3, trivs [P, 3] and stream-local cursors
    [P, 32] (what tables_kernel.load_tables_plain returns) -> Tables."""
    trivs = trivs.to(torch.int64)
    return Tables(bp.to(torch.int64),
                  (_search(lengths_icp), trivs[:, 0]),
                  (_search(lengths_dst), trivs[:, 1]),
                  (_search(lengths_lit), trivs[:, 2]))


def pack_tables(tables: Tables) -> KernelTables:
    """Tables -> KernelTables: the search arrays stacked and the three
    dictionaries concatenated, contiguous int32."""
    parts = (tables.icp, tables.dst, tables.lit)
    meta = torch.stack([torch.stack([s["limit"], s["first"], s["offset"]],
                                    dim=1) for s, _ in parts], dim=1)
    if meta.shape[-1] != C.HUFFMAN_NUM_CODE_LENGTH + 1:
        raise ValueError(f"search arrays of width {meta.shape[-1]}")
    dicts = torch.cat([s["symdict"] for s, _ in parts], dim=1)
    trivs = torch.stack([t for _, t in parts], dim=1)
    return KernelTables(*(x.to(torch.int32).contiguous()
                          for x in (meta, dicts, trivs, tables.bp)))


def tables_from_jax(lengths_icp, lengths_dst, lengths_lit, trivs,
                    bp) -> Tables:
    """The JAX table loader's outputs, as numpy arrays, -> Tables on the
    CPU.

    Takes what brotlig_tpu's load_tables_pallas returns, or three chained
    tables.load_table calls on stream_view_from_interleaved with the
    view's bp0 subtracted from the cursors: lengths [P, A] x 3, trivs
    [P, 3] and stream-local bit cursors [P, 32]."""
    def t(x):
        return torch.from_numpy(np.asarray(x, dtype=np.int64))
    return tables_from_lengths(t(lengths_icp), t(lengths_dst),
                               t(lengths_lit), t(trivs), t(bp))
