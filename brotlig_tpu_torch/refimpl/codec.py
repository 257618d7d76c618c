"""Stream-level Brotli-G codec of the scalar page coder: the port's copy of
brotlig_tpu/refimpl/codec.py, with the page parse moved to a device.

Mirrors the reference orchestration (src/BrotligEncoder.cpp:415-516,
src/BrotligDecoder.cpp:426-518): page split, optional preconditioning,
per-page encode with raw fallback, stream header + page table assembly.
encode gives the JAX package's bytes: condition and delta run on
`device` (ops/precondition.py, csrc/precondition.cu on the card), then
each group of pages is parsed in one batched launch (find_matches on the
card, ops/ref_parse_kernel.py), and each page is serialized on the host
(page_encoder.serialize_page), in page order.
"""
from __future__ import annotations

from ..format import constants as C
from ..format.errors import Aborted, MessageType
from ..format.headers import (PreconditionHeader, StreamHeader,
                              unpack_page_table)
from ..format.precondition import (DataConditionParams, decondition,
                                   delta_decode_page)
from ..ops.decode import resolve_device
from ..ops.encode import assemble, page_rows, stream_setup
from ..ops.ref_parse_kernel import find_matches_pages
from .page_decoder import decode_page
from .page_encoder import serialize_page

BATCH_PAGES = 64            # pages a parse launch


def parse_group(work: bytes, group, page_size: int, max_chain: int, dev):
    """The parse of the pages `group` of `work`, as find_matches gives it:
    one (raw_cmds, tail) a page, from one launch on `dev`."""
    import torch
    arr, sizes = page_rows(work, group, page_size)
    ins, cpy, dist, nc, tail = (t.cpu().numpy() for t in find_matches_pages(
        torch.from_numpy(arr).to(dev), torch.from_numpy(sizes).to(dev),
        max_chain))
    return [(list(zip(ins[r, :k].tolist(), cpy[r, :k].tolist(),
                      dist[r, :k].tolist())), int(tail[r]))
            for r, k in enumerate(nc.tolist())]


def serialize_group(work: bytes, raw_form: bytes, group, parses, isdelta,
                    page_size: int, num_pages: int, feedback=None) -> list:
    """Each page of `group` coded on the host from its parse: its bytes,
    or its raw_form bytes where it does not compress. feedback is called
    after each page with the JAX package's progress text."""
    out = []
    for i, (raw_cmds, tail) in zip(group, parses):
        start = i * page_size
        chunk = work[start: start + page_size]
        comp = serialize_page(chunk, raw_cmds, tail, i == num_pages - 1,
                              delta_encoded=isdelta[i])
        out.append(raw_form[start: start + page_size] if comp is None
                   else comp)
        if feedback is not None:
            progress = 100.0 * (i + 1) / num_pages
            if feedback(MessageType.PROGRESS, f"{progress}"):
                raise Aborted("encode aborted by feedback callback")
    return out


def encode(data: bytes, page_size: int = C.DEFAULT_PAGE_SIZE,
           dc_params: DataConditionParams | None = None,
           max_chain: int = 64, feedback=None, device="cuda") -> bytes:
    """Compress `data` into a Brotli-G container: the bytes of
    brotlig_tpu.refimpl.codec.encode with the same arguments.

    `device` runs condition + delta and the page parse: "cuda" the CUDA
    kernels (raises without a CUDA device), "cpu" their plain versions.
    A geometry that does not describe the input turns preconditioning
    off (a plain stream), as the reference does. `feedback(message_type,
    text) -> bool` mirrors BROTLIG_Feedback_Proc (BrotligCommon.h:92):
    called with per-page progress; returning True aborts (raises
    Aborted)."""
    dev = resolve_device(device)
    header, precondition, raw_form, work, isdelta = stream_setup(
        data, page_size, dc_params, dev)
    if not data:
        return header.pack()
    num_pages = header.num_pages
    pages = []
    for g0 in range(0, num_pages, BATCH_PAGES):
        group = range(g0, min(g0 + BATCH_PAGES, num_pages))
        parses = parse_group(work, group, page_size, max_chain, dev)
        pages += serialize_group(work, raw_form, group, parses, isdelta,
                                 page_size, num_pages, feedback)
    return assemble(header, precondition, dc_params, pages)


def decompressed_size(data: bytes) -> int:
    return StreamHeader.unpack(data).uncompressed_size


def decode(data: bytes) -> bytes:
    """Decompress a Brotli-G container with the scalar page decoder."""
    header = StreamHeader.unpack(data)
    pos = C.STREAM_HEADER_SIZE_BYTES

    dc_params = None
    if header.preconditioned:
        ph = PreconditionHeader.unpack(data[pos:])
        pos += C.PRECON_HEADER_SIZE_BYTES
        dc_params = DataConditionParams(
            precondition=True,
            swizzle=ph.swizzled,
            format=ph.data_format,
            num_mip_levels=ph.num_mips,
            pitch_d3d12_aligned=ph.pitch_d3d12_aligned,
        )
        dc_params.width_in_blocks[0] = ph.width_in_blocks
        dc_params.height_in_blocks[0] = ph.height_in_blocks
        dc_params.pitch_in_bytes[0] = ph.pitch_in_bytes

    num_pages = header.num_pages
    if num_pages == 0:
        return b""
    page_size = header.page_size
    out_size = header.uncompressed_size
    if header.preconditioned:
        dc_params.initialize(out_size)

    offsets, sizes = unpack_page_table(data[pos:], num_pages)
    pos += num_pages * 4
    payload = data[pos:]

    out = bytearray()
    for i in range(num_pages):
        page_out_size = (header.last_page_size
                         if (i == num_pages - 1 and header.last_page_size)
                         else page_size)
        page_data = payload[int(offsets[i]): int(offsets[i]) + int(sizes[i])]
        page, isdelta = decode_page(page_data, page_out_size)
        if isdelta and dc_params is not None:
            page = delta_decode_page(page, i * page_size, dc_params)
        out += page

    if header.preconditioned:
        return decondition(bytes(out), dc_params)
    return bytes(out[:out_size])
