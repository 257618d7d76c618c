"""The state both packages compute and consume: the staged page buffer and
the Huffman tables. A codec has no weights; these conversions let a test
feed the port's decode step exactly what the JAX side computed, so that a
table mismatch and a decode mismatch show up separately.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import native
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
    `device`. The layout stays as staged: the kernels index it directly.
    A plain blocking upload; the decode pipeline stages into page-locked
    buffers and uploads with StagingBuffers instead."""
    if buf3_np.ndim != 3 or buf3_np.shape[2] != 128:
        raise ValueError(f"staged buffer shape {buf3_np.shape}")
    buf = torch.from_numpy(np.ascontiguousarray(buf3_np, np.int32))
    npd = torch.from_numpy(np.ascontiguousarray(npd_np, np.int32))
    return Staged(buf.to(device), npd.to(device))


class Streams:
    """The streams a decode runs on: `compute`, the device's current
    stream, where the kernels launch, and `copy`, for uploads and
    readbacks; events order one to the other. On the CPU both are None and
    every event call does nothing, so the same code runs eagerly there."""

    def __init__(self, device: torch.device):
        cuda = device.type == "cuda"
        self.device = device
        self.compute = torch.cuda.current_stream(device) if cuda else None
        self.copy = torch.cuda.Stream(device) if cuda else None

    def on_copy(self):
        """Context in which work is queued on the copy stream."""
        return torch.cuda.stream(self.copy)

    @staticmethod
    def record(stream):
        """An event recorded on `stream` now (None on the CPU)."""
        return None if stream is None else stream.record_event()

    @staticmethod
    def wait(stream, event) -> None:
        """Make `stream`'s later work wait for `event`."""
        if event is not None:
            stream.wait_event(event)

    @staticmethod
    def sync(event) -> None:
        """Block the host until `event` has completed."""
        if event is not None:
            event.synchronize()

    def host_empty(self, n: int, dtype) -> torch.Tensor:
        """n elements of host memory, page-locked when the device is a
        card, so that copies to and from it run asynchronously; raises
        when pinning fails."""
        return torch.empty(n, dtype=dtype, pin_memory=self.copy is not None)


class StagingBuffers:
    """Reused host buffers for one staged batch of up to `pages` pages
    at `wc` staged chunks (buf, npd, and an int64 row per page), and the
    event of their last upload: they are written again only after that
    upload has completed."""

    def __init__(self, streams: Streams, wc: int, pages: int):
        self.streams = streams
        self.wc = wc
        self.buf = streams.host_empty(wc * pages * 128, torch.int32)
        self.npd = streams.host_empty(pages * 4, torch.int32)
        self.rows = streams.host_empty(pages, torch.int64)
        self.uploaded = None

    def stage(self, payload: bytes, offsets, sizes, wl: int):
        """native.stage_pages into the buffers, once their last upload is
        done. Returns host views (buf3 [wc, P, 128], npd [P, 4])."""
        self.streams.sync(self.uploaded)
        P = len(offsets)
        buf3 = self.buf[: self.wc * P * 128].view(self.wc, P, 128)
        npd = self.npd[: P * 4].view(P, 4)
        native.stage_pages(payload, offsets, sizes, wl,
                           out=(buf3.numpy(), npd.numpy()))
        return buf3, npd

    def upload(self, buf3, npd, rows=None):
        """Copy a staged batch (and optionally its destination rows) to
        the device on the copy stream, and make the compute stream wait
        for the copy. Returns (Staged, rows or None) on the device."""
        st = self.streams
        if rows is not None:
            self.rows[: len(rows)].numpy()[:] = rows
            rows = self.rows[: len(rows)]
        with st.on_copy():
            dev = [None if t is None else t.to(st.device, non_blocking=True)
                   for t in (buf3, npd, rows)]
            self.uploaded = st.record(st.copy)
        st.wait(st.compute, self.uploaded)
        if st.compute is not None:
            for t in dev:
                if t is not None:
                    # allocated on the copy stream, read on the compute
                    # stream: not reused before the compute stream is done
                    t.record_stream(st.compute)
        return Staged(dev[0], dev[1]), dev[2]


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
