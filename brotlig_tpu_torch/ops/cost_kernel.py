"""Wrapper of the q11 cost model's CUDA kernels (csrc/cost_model.cu).

ops/parse_dp.py::build_cost_model calls it on CUDA tensors (the plain
version, build_cost_model_plain, runs on CPU tensors). It replaces the JAX
package's compiled build_cost_model (brotlig_tpu/ops/parse_dp.py:71),
which has no Pallas kernel. A call makes two launches, each counted under
``_kernels.LAUNCHES["cost"]``: the table kernel (a thread block cluster a
page: starts, rings, the grid search over per-distance key counts, the
histograms, the three code lengths at once, the joint command costs) and
the position kernel (tiles of 2048 positions: each position's literal
cost, inherited ring, ring probes and the 12 candidate slots with their
distance costs).
"""
from __future__ import annotations

import torch

from .. import _kernels

LAUNCHES_PER_CALL = 2
BASE_SLOTS = 8               # find_candidates' slots
SLOTS = BASE_SLOTS + 4       # and the four ring probes
JOINT = 24 * 24              # (insert code, copy code) pairs
# the table kernel's phases, in order, whose clock cycles (the first
# thread of the page's first CTA, from the end of one phase to the end of
# the next) each page's record keeps (read by chip_smoke.py's phase
# split, never by a route)
PHASES = ("share totals", "starts, ring, key counts and insert marks",
          "chunk totals and literal histogram", "grid search",
          "ring mode and histograms", "cluster sums and ring-mode choice",
          "code lengths", "cost tables")
GRID = 16                    # then the (npostfix, ndirect) grid's costs,
REC_INTS = len(PHASES) + 2 * GRID   # int64, in the record's last words


def check_args(pages, in_sizes, ins, cpy, dist, ncmds, base_len,
               base_dist) -> None:
    """Raise ValueError unless the shapes are ones the kernels take: pages
    uint8 [P, S] with S a positive multiple of 4 up to 128 KiB; in_sizes
    and ncmds [P]; ins, cpy and dist [P, N] with N >= 1; base_len and
    base_dist [P, S, 8]."""
    if pages.dim() != 2 or pages.dtype != torch.uint8:
        raise ValueError(f"cost model pages: want uint8 [P, S], got "
                         f"{pages.dtype} {tuple(pages.shape)}")
    P, S = pages.shape
    if not (0 < S <= 1 << 17 and S % 4 == 0):
        raise ValueError(f"cost model pages: S must be a multiple of 4 in "
                         f"(0, 131072], got {S}")
    if ins.dim() != 2 or ins.shape[0] != P or ins.shape[1] < 1:
        raise ValueError(f"cost model commands: want [{P}, N >= 1], got "
                         f"{tuple(ins.shape)}")
    if (cpy.shape != ins.shape or dist.shape != ins.shape
            or in_sizes.shape != (P,) or ncmds.shape != (P,)
            or base_len.shape != (P, S, BASE_SLOTS)
            or base_dist.shape != (P, S, BASE_SLOTS)):
        raise ValueError(
            f"cost model shapes: pages {tuple(pages.shape)}, ins "
            f"{tuple(ins.shape)}, cpy {tuple(cpy.shape)}, dist "
            f"{tuple(dist.shape)}, in_sizes {tuple(in_sizes.shape)}, ncmds "
            f"{tuple(ncmds.shape)}, base_len {tuple(base_len.shape)}, "
            f"base_dist {tuple(base_dist.shape)} (want [P, S, "
            f"{BASE_SLOTS}])")


def _int32(x):
    """x as a contiguous int32 tensor whose data is 16-byte aligned (the
    kernels read rows of four)."""
    x = x.to(torch.int32).contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def build_cost_model_cuda(pages, in_sizes, ins, cpy, dist, ncmds, base_len,
                          base_dist, return_record: bool = False):
    """The cost model on the card: pages uint8 [P, S]; in_sizes, ncmds [P];
    ins/cpy/dist [P, N] (zero past ncmds); base_len/base_dist [P, S, 8]
    from find_candidates. Returns the plain version's six int32 outputs
    (litq [P, S], jointEq [P, 576], jointLq [P, 576], cand_len [P, S, 12],
    cand_dist [P, S, 12], dpackq [P, S, 12]); with return_record, also
    each page's record (int32 [P, REC_INTS]: clock cycles by phase, then
    the 16 grid points' costs as int64, `grid_costs`). Raises ValueError
    on a shape the kernels do not take (see check_args)."""
    check_args(pages, in_sizes, ins, cpy, dist, ncmds, base_len, base_dist)
    P, S = pages.shape
    N = ins.shape[1]
    dev = pages.device
    pages = pages.contiguous()
    if pages.data_ptr() % 16:
        pages = pages.clone()
    cmds = [_int32(x) for x in (in_sizes, ins, cpy, dist, ncmds)]
    base = [_int32(x) for x in (base_len, base_dist)]

    def empty(*shape):
        return torch.empty(shape, dtype=torch.int32, device=dev)
    litq = empty(P, S)
    joint_e, joint_l = empty(P, JOINT), empty(P, JOINT)
    cand_len, cand_dist, dpackq = (empty(P, S, SLOTS) for _ in range(3))
    out = (litq, joint_e, joint_l, cand_len, cand_dist, dpackq)
    rec = empty(P, REC_INTS) if return_record else None
    if P == 0:
        return out + (rec,) if return_record else out
    lib = _kernels.library()
    words = lib.blg_cost_scratch_ints(P, N, S)
    if words < 0:
        raise RuntimeError(f"cost kernels: no launch plan for P={P}, N={N}, "
                           f"S={S} on {dev}")
    scratch = empty(P, words)
    _kernels.check_cuda_args(pages, *cmds, *base, litq, joint_e, joint_l,
                             cand_len, cand_dist, dpackq, scratch)
    _kernels.launch("cost", "blg_cost_tables", dev, pages.data_ptr(),
                    *[t.data_ptr() for t in cmds], P, S, N,
                    joint_e.data_ptr(), joint_l.data_ptr(),
                    scratch.data_ptr(),
                    None if rec is None else rec.data_ptr())
    _kernels.launch("cost", "blg_cost_positions", dev, pages.data_ptr(),
                    cmds[0].data_ptr(), *[t.data_ptr() for t in base], P, S,
                    N, scratch.data_ptr(), litq.data_ptr(),
                    cand_len.data_ptr(), cand_dist.data_ptr(),
                    dpackq.data_ptr())
    return out + (rec,) if return_record else out


def grid_costs(rec) -> torch.Tensor:
    """The 16 (npostfix, ndirect) grid points' costs a page's record holds
    (int64 [P, 16], in 2^-16 bits: runs' entropy terms plus extra bits),
    the first minimum being the page's choice."""
    return rec[:, len(PHASES):].contiguous().view(torch.int64)


def unseen_half_bits_cuda(n: int, pad: float, device) -> torch.Tensor:
    """The kernels' half-bit cost of an unseen symbol in a table of t
    symbols, t = 1..n (int32 [n] on device): a check against
    parse_dp.unseen_bits, launched outside the main path and not
    counted."""
    out = torch.empty(n, dtype=torch.int32, device=device)
    _kernels.check_cuda_args(out)
    with torch.cuda.device(out.device):
        rc = _kernels.library().blg_cost_unseen_check(
            n, pad, out.data_ptr(), _kernels.stream_ptr(out.device))
    if rc != 0:
        raise RuntimeError(f"unseen check kernel failed (cudaError {rc})")
    return out
