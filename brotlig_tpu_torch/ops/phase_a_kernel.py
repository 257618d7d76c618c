"""The phase-A kernel (csrc/phase_a.cu) and its plain version: the first
half of the two-phase decode route.

Replaces brotlig_tpu/ops/pallas_decode.py::phase_a_from_buf (kernel body
make_phase_a_kernel): from a staged batch and its tables, decode every
page's commands and literals and store them, with each copy's distance
already resolved through the distance ring. The sweep kernel
(sweep_kernel.sweep) then executes them.

On a CUDA tensor, phase_a launches the kernel; on a CPU tensor it runs the
plain version (the torch wavefront of ops/decode.py and its distance-ring
resolution on the stream-major view of the staged buffer), which is also
callable on a CUDA tensor for comparison.

The JAX kernel streams command rounds and literal chunk slots to HBM by
double-buffered DMA (stage_cmd/stage_lit and their semaphores); XLA then
unpacks the slot rows and compacts the literals (_unpack_slot_rows,
_compact_literals, _cmds_split), and the stats size the sweep's buckets or
send the batch to the XLA route (decode.py's _finish_pallas_state). None
of that has a counterpart here: the kernel writes the commands and a dense
literal queue straight into device-memory scratch that the wrapper sizes
for the worst case, so nothing can overflow. That is 256 pages x 32,800
commands x 3 fields x 4 B, about 100 MB, at 64 KiB pages, and about
200 MB at 128 KiB pages.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import _kernels
from . import decode as D
from .decode_kernel import LIT_PAD, kernel_operands, plain_symbols
from .tables_kernel import NBS


class PhaseA(NamedTuple):
    """A batch's decoded commands. ncmds [P]; ins, cpy, dist [P, max_cmds]
    (insert length, copy length, absolute distance; defined for commands
    < ncmds); litq [P, page_size + 64] uint8 (defined up to the page's
    literal count, the sum of its insert lengths); status [P] int32 of
    decode.ST_* bits, 0 for a clean page."""
    ncmds: torch.Tensor
    ins: torch.Tensor
    cpy: torch.Tensor
    dist: torch.Tensor
    litq: torch.Tensor
    status: torch.Tensor


def phase_a(buf3: torch.Tensor, npd: torch.Tensor, tables,
            page_size: int) -> PhaseA:
    """Phase A of a staged batch: buf3 [Wc, P, 128] int32, npd [P, 4]
    int32, tables: state.KernelTables or (the plain version's only form)
    state.Tables."""
    if buf3.is_cuda:
        return _phase_a_cuda(buf3, npd, tables, page_size)
    if buf3.device.type == "cpu":
        return phase_a_plain(buf3, npd, tables, page_size)
    raise ValueError(f"no phase-A route for device {buf3.device}")


def phase_a_plain(buf3, npd, tables, page_size: int) -> PhaseA:
    """Plain torch version of the phase-A kernel (int64 results; past
    ncmds the commands are zero, past the decoded literals the queue is
    zero)."""
    npostfix, ndirect, syms = plain_symbols(buf3, npd, tables, page_size)
    ncmds, litbuf, ins, cpy, dcode, dextra = syms
    dist = D._resolve_distances(dcode, dextra, ncmds, npostfix, ndirect)
    status = D.page_status(ncmds, ins, cpy, dist, page_size,
                           D.max_cmds_for(page_size))
    return PhaseA(ncmds, ins, cpy, dist, F.pad(litbuf, (0, LIT_PAD)), status)


def _phase_a_cuda(buf3, npd, tables, page_size: int) -> PhaseA:
    ops = kernel_operands(buf3, npd, tables, page_size)
    wc, P, _ = buf3.shape
    dev = buf3.device
    mc = D.max_cmds_for(page_size)

    def cmds():
        return torch.empty((P, mc), dtype=torch.int32, device=dev)
    out = PhaseA(torch.empty(P, dtype=torch.int32, device=dev),
                 cmds(), cmds(), cmds(),
                 torch.empty((P, page_size + LIT_PAD), dtype=torch.uint8,
                             device=dev),
                 torch.empty(P, dtype=torch.int32, device=dev))
    _kernels.check_cuda_args(*ops, *out)
    _kernels.launch(
        "phase_a", "blg_phase_a", dev, ops[0].data_ptr(), wc, P,
        *[t.data_ptr() for t in ops[1:]], page_size, mc // NBS,
        out.ins.data_ptr(), out.cpy.data_ptr(), out.dist.data_ptr(),
        out.litq.data_ptr(), out.ncmds.data_ptr(), out.status.data_ptr())
    return out
