"""The chunk-sweep LZ77 kernel (csrc/sweep.cu) and its plain version: the
second half of the two-phase decode route.

Replaces brotlig_tpu/ops/pallas_decode.py::_phase_b_sweep: its XLA middle
stage (commands past ncmds masked; output, copy and literal starts by
exclusive cumsum; invalid commands moved to the start 1 << 29) becomes
torch ops here, and its two kernel bodies, make_phase_b_kernel (128-byte
groups) and make_phase_b_kernel_wide (512, 1024 or 2048 bytes), become one
CUDA kernel templated on the group width cw.

On CUDA tensors, sweep runs the middle stage and launches the kernel; on
CPU tensors it runs the plain version (ops/decode.py's pointer-doubling
_phase_b, which has no groups: cw does not change the bytes), which is
also callable on CUDA tensors for comparison.
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
        return launch_sweep(middle_stage(ncmds, litq, ins, cpy, dist,
                                         page_size), page_size, cw)
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
    """What the sweep kernel reads (the middle stage's result): st, cst,
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
    over the batch's longest command list (one host read)."""
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


def launch_sweep(inp: SweepInputs, page_size: int, cw: int):
    """One launch of the sweep kernel at group width cw."""
    P, n = inp.st.shape
    if page_size % cw or page_size % 16 or inp.litq.shape[0] != P:
        raise ValueError(f"sweep of {P} pages of {page_size} B at cw {cw}")
    out = torch.empty((P, page_size), dtype=torch.uint8,
                      device=inp.st.device)
    _kernels.check_cuda_args(*inp, out)
    rc = _kernels.library().blg_sweep(
        *[t.data_ptr() for t in inp[:6]], inp.litq.shape[1], P, n,
        page_size, cw, out.data_ptr(), _kernels.stream_ptr(out.device))
    if rc != 0:
        raise RuntimeError(f"sweep kernel launch failed (cudaError {rc})")
    _kernels.LAUNCHES["sweep"] += 1
    _kernels.SWEEP_LAUNCHES[cw] += 1
    return out
