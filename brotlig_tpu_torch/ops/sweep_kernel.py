"""The chunk-sweep LZ77 kernel (csrc/sweep.cu) and its plain version: the
second half of the two-phase decode route.

Replaces brotlig_tpu/ops/pallas_decode.py::_phase_b_sweep: its two kernel
bodies, make_phase_b_kernel (128-byte groups) and make_phase_b_kernel_wide
(512, 1024 or 2048 bytes), become one CUDA kernel templated on the group
width cw, and its XLA middle stage (commands past ncmds masked; output,
copy and literal starts by exclusive cumsum) becomes the kernel's
prologue: the kernel takes the phase-A kernel's fields as they are, and
nothing is read back to the host between the two kernels. middle_stage
states that layout in torch; no route runs it.

On CUDA tensors, sweep launches the kernel; on CPU tensors it runs the
plain version (ops/decode.py's pointer-doubling _phase_b, which has no
groups: cw does not change the bytes), which is also callable on CUDA
tensors for comparison.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import _kernels
from . import decode as D

FAR_START = 1 << 29     # start of a command past ncmds: never covers a byte


def sweep(ncmds, litq, ins, cpy, dist, page_size: int, cw: int = 1024):
    """Execute a batch's commands (phase_a_kernel.PhaseA's fields: ncmds
    [P]; litq [P, L] uint8; ins, cpy, dist [P, N], read below ncmds only).
    Returns out [P, page_size] uint8, zero past each page's coverage."""
    D._check_opts(None, cw)
    if ins.is_cuda:
        return launch_sweep(ncmds, litq, ins, cpy, dist, page_size, cw)
    if ins.device.type == "cpu":
        return sweep_plain(ncmds, litq, ins, cpy, dist, page_size)
    raise ValueError(f"no sweep route for device {ins.device}")


def _masked(ncmds, ins, cpy, dist, n: int):
    """The first n commands in int64, zero from ncmds on."""
    cid = torch.arange(n, device=ins.device)[None, :]
    valid = cid < ncmds.to(torch.int64)[:, None]
    return valid, [torch.where(valid, a[:, :n].to(torch.int64), 0)
                   for a in (ins, cpy, dist)]


def sweep_plain(ncmds, litq, ins, cpy, dist, page_size: int):
    """Plain torch version of the sweep kernel."""
    _, (ins, cpy, dist) = _masked(ncmds, ins, cpy, dist, ins.shape[1])
    return D._phase_b(ncmds, litq, ins, cpy, dist, page_size)


class SweepInputs(NamedTuple):
    """The layout the sweep kernel's prologue builds: st, cst,
    lst, dist [P, n] int32 output start, copy start, literal start and
    absolute distance of the first n commands (n: the batch's peak
    ncmds), st = FAR_START from ncmds on; total [P] int32 bytes covered;
    litq [P, L] uint8."""
    st: torch.Tensor
    cst: torch.Tensor
    lst: torch.Tensor
    dist: torch.Tensor
    total: torch.Tensor
    litq: torch.Tensor


def middle_stage(ncmds, litq, ins, cpy, dist, page_size: int) -> SweepInputs:
    """Mask commands past ncmds and lay out their starts by exclusive
    cumsum (_phase_b_sweep's XLA middle stage, pallas_decode.py:1439-1453),
    over the batch's longest command list (one host read): the plain
    statement of what the sweep kernel's prologue computes per page."""
    P, N = ins.shape
    n = max(1, min(N, int(ncmds.max()))) if P else 1
    valid, (ins, cpy, dist) = _masked(ncmds, ins, cpy, dist, n)
    ends = torch.cumsum(ins + cpy, dim=1)
    st = torch.where(valid, ends - ins - cpy, FAR_START)
    lst = torch.cumsum(ins, dim=1) - ins

    def i32(x):
        return x.clamp(-FAR_START, FAR_START).to(torch.int32).contiguous()
    return SweepInputs(i32(st), i32(st + ins), i32(lst), i32(dist),
                       i32(ends[:, -1].clamp(0, page_size)),
                       litq.contiguous())


def launch_sweep(ncmds, litq, ins, cpy, dist, page_size: int, cw: int):
    """One launch of the sweep kernel at group width cw on phase-A fields
    (PhaseA's ncmds [P], litq [P, L] uint8, ins/cpy/dist [P, N])."""
    P, N = ins.shape
    if page_size % cw or page_size % 16 or litq.shape[0] != P or \
            ncmds.shape != (P,) or cpy.shape != (P, N) or \
            dist.shape != (P, N):
        raise ValueError(f"sweep of {P} pages of {page_size} B at cw {cw}")
    dev = ins.device
    ops = [x.to(torch.int32).contiguous() for x in (ncmds, ins, cpy, dist)]
    litq = litq.contiguous()
    out = torch.empty((P, page_size), dtype=torch.uint8, device=dev)
    scratch = torch.empty((P, N, 4), dtype=torch.int32, device=dev)
    _kernels.check_cuda_args(*ops, litq, scratch, out)
    _kernels.launch("sweep", "blg_sweep", dev, *[x.data_ptr() for x in ops],
                    litq.data_ptr(), litq.shape[1], P, N, page_size, cw,
                    scratch.data_ptr(), out.data_ptr(), cw=cw)
    return out
