"""The fused page-decode kernel (csrc/decode.cu) and its plain version, plus
the host-side staging hints.

Replaces brotlig_tpu/ops/pallas_decode.py::decode_fused_from_buf (kernel
body make_fused_kernel, with the LZ sweep make_phase_b_kernel_wide inside):
from a staged batch and its tables, decode every page's commands and
literals and execute the LZ77 copies, producing the page bytes.

On a CUDA tensor, decode_fused launches the kernel; on a CPU tensor it
runs the plain version (the torch wavefront of ops/decode.py on the
stream-major view of the staged buffer), which is also callable on a CUDA
tensor for comparison.

The JAX path sizes its VMEM planes by command/chunk buckets and reruns a
batch whose stats overflow them (mc_bucket_for, ch_bucket_for,
fused_bounds, decode.py's _finish_fused_state and pump_finish hint). The
kernel here builds each page in shared memory (one block of two warps per
page, the page's bytes in up to 128 KiB of dynamic shared memory), writes
literals straight to their output positions, and so has no bucket to
overflow, no literal queue and nothing to rerun.
"""
from __future__ import annotations

import torch

from ..format import constants as C

from .. import _kernels
from . import decode as D
from ..state import KernelTables, pack_tables
from .tables import stream_view_from_interleaved
from .tables_kernel import ALPHABETS, LEN_SLOTS, NBS

LIT_PAD = 64            # literal-queue slack past the page (the kernels')


def decode_fused(buf3: torch.Tensor, npd: torch.Tensor, tables,
                 page_size: int):
    """Decode a staged batch. buf3 [Wc, P, 128] int32, npd [P, 4] int32,
    tables: state.KernelTables or (the plain version's only form)
    state.Tables. Returns (out [P, page_size] uint8 with zeros past
    each page's coverage, ncmds [P], status [P] int32 of decode.ST_* bits,
    0 for a clean page)."""
    if buf3.is_cuda:
        return _decode_fused_cuda(buf3, npd, tables, page_size)
    if buf3.device.type == "cpu":
        return decode_fused_plain(buf3, npd, tables, page_size)
    raise ValueError(f"no decode route for device {buf3.device}")


def decode_fused_plain(buf3, npd, tables, page_size: int):
    """Plain torch version of the fused decode kernel."""
    npostfix, ndirect, syms = plain_symbols(buf3, npd, tables, page_size)
    out, status = D._stage_lz(*syms, npostfix, ndirect, page_size,
                              D.max_cmds_for(page_size))
    return out, syms[0], status


def plain_symbols(buf3, npd, tables, page_size: int):
    """The torch wavefront's phase A on a staged batch: (npostfix,
    ndirect, (ncmds, litbuf, ins, cpy, dcode, dextra)) as ops/decode.py's
    _phase_a returns them. The plain versions of the fused and the
    phase-A kernels both start here."""
    wl = buf3.shape[0] * 128 // NBS
    view, bp0 = stream_view_from_interleaved(buf3, wl)
    npostfix, ndirect = npd[:, 0].to(torch.int64), npd[:, 1].to(torch.int64)
    syms = D._phase_a(view, bp0 + tables.bp, tables.icp, tables.dst,
                      tables.lit, npostfix, ndirect, page_size,
                      D.max_cmds_for(page_size))
    return npostfix, ndirect, syms


def kernel_operands(buf3, npd, tables, page_size: int):
    """Check a staged batch and its tables (state.KernelTables, as the
    tables kernel returns them, or state.Tables, packed here) and convert
    them to what the fused and phase-A kernels take: (buf3, npd, bp, meta,
    dicts, trivs), contiguous int32."""
    if buf3.dtype != torch.int32 or buf3.dim() != 3 or buf3.shape[2] != 128:
        raise ValueError(f"staged buffer {tuple(buf3.shape)} {buf3.dtype}")
    if page_size not in C.PAGE_SIZE_CHOICES:
        raise ValueError(f"page size {page_size}")
    P = buf3.shape[1]
    npd = npd.to(torch.int32).contiguous()
    if not isinstance(tables, KernelTables):
        tables = pack_tables(tables)
    meta, dicts, trivs, bp = tables
    if npd.shape != (P, 4) or bp.shape != (P, NBS) or \
            meta.shape != (P, 3, 3, LEN_SLOTS) or trivs.shape != (P, 3) or \
            dicts.shape != (P, sum(ALPHABETS)):
        raise ValueError("staged batch and tables disagree on shape")
    return buf3.contiguous(), npd, bp, meta, dicts, trivs


def _decode_fused_cuda(buf3, npd, tables, page_size: int):
    ops = kernel_operands(buf3, npd, tables, page_size)
    wc, P, _ = buf3.shape
    dev = buf3.device
    out = torch.empty((P, page_size), dtype=torch.uint8, device=dev)
    ncmds = torch.empty(P, dtype=torch.int32, device=dev)
    status = torch.empty(P, dtype=torch.int32, device=dev)
    _kernels.check_cuda_args(*ops, out, ncmds, status)
    _kernels.launch(
        "decode", "blg_decode_pages", dev, ops[0].data_ptr(), wc, P,
        *[t.data_ptr() for t in ops[1:]], page_size,
        D.max_cmds_for(page_size) // NBS, out.data_ptr(), ncmds.data_ptr(),
        status.data_ptr())
    return out, ncmds, status


# ---------------------------------------------------------------------------
# Host-side hints (copied from brotlig_tpu/ops/pallas_decode.py, whose
# module imports jax)
# ---------------------------------------------------------------------------

def stream_words_hint(page_blobs) -> int:
    """Max per-stream word count over compressed pages (host-side parse of
    the self-describing size table; mirrors parse_page_headers_full).

    Items are either a full page blob, or ``(prefix, total_size)`` where
    prefix holds at least the page header + size table (the field widths
    derive from the page's TOTAL compressed size, so a bare truncated
    prefix would be misparsed)."""
    best = 1
    for item in page_blobs:
        if isinstance(item, tuple):
            blob, n = item
        else:
            blob, n = item, len(item)
        if n < 5:
            continue
        bits = int.from_bytes(blob[:16].ljust(16, b"\0"), "little")
        r_avg = (n + NBS - 1) // NBS
        base_bits = r_avg.bit_length()
        dlt_bits_bits = ((n - 1).bit_length()).bit_length()
        base = (bits >> 8) & ((1 << base_bits) - 1)
        dlt_bits = (bits >> (8 + base_bits)) & ((1 << dlt_bits_bits) - 1)
        if dlt_bits == 0:
            maxlen = base
        elif (8 + base_bits + dlt_bits_bits + NBS * dlt_bits + 7) // 8 \
                > len(blob):
            maxlen = n          # prefix too short: conservative bound
        else:
            pos = 8 + base_bits + dlt_bits_bits
            need = (pos + NBS * dlt_bits + 7) // 8
            big = int.from_bytes(blob[:need].ljust(need, b"\0"), "little")
            mx = 0
            for s in range(NBS):
                d = (big >> (pos + s * dlt_bits)) & ((1 << dlt_bits) - 1)
                if d > mx:
                    mx = d
            maxlen = base + mx
        wlen = maxlen // 4 + 2
        if wlen > best:
            best = wlen
    return best


def wl_bucket(wl: int) -> int:
    """Round the per-stream word capacity up to a bucket: powers of two to
    256, then multiples of 64 (a multiple of 4, as the stager requires)."""
    b = 32
    while b < min(wl, 256):
        b *= 2
    while b < wl:
        b += 64
    return b
