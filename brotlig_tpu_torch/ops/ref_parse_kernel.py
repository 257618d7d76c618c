"""The page parse of the scalar page encoder on a batch of pages: the
wrapper of csrc/ref_parse.cu and its plain version.

find_matches_pages computes refimpl/page_encoder.py::find_matches (the
JAX package's brotlig_tpu/refimpl/page_encoder.py:45, a hash-chain parse
in host Python, which has no TPU kernel) for every row of a batch. On
CUDA tensors it launches the two kernels of csrc/ref_parse.cu, each
counted under ``_kernels.LAUNCHES["ref_parse"]``: sort (a block a page:
the page's positions stably sorted by hash, so that a chain is a run of
slots) and walk (a warp a page: the greedy-lazy walk, 32 chain candidates
a step). On CPU tensors it runs find_matches a row at a time, the plain
version. refimpl/codec.py calls it once a group of pages.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import _kernels
from ..refimpl.page_encoder import find_matches

LAUNCHES_PER_CALL = 2
MAX_PAGE = 1 << 17


def max_cmds_for(S: int) -> int:
    """Columns of the command arrays: a command copies at least 4 bytes."""
    return S // 4 + 1


def check_pages(pages, in_sizes) -> None:
    """Raise ValueError unless pages is uint8 [P, S], S a positive multiple
    of 16 up to 128 KiB, and in_sizes has P entries."""
    if pages.dim() != 2 or pages.dtype != torch.uint8:
        raise ValueError(f"parse pages: want uint8 [P, S], got "
                         f"{pages.dtype} {tuple(pages.shape)}")
    P, S = pages.shape
    if not (0 < S <= MAX_PAGE and S % 16 == 0):
        raise ValueError(f"parse pages: S must be a multiple of 16 in "
                         f"(0, {MAX_PAGE}], got {S}")
    if in_sizes.shape != (P,):
        raise ValueError(f"parse in_sizes: want ({P},), got "
                         f"{tuple(in_sizes.shape)}")


def find_matches_plain(pages, in_sizes, max_chain: int):
    """find_matches on each row's first in_sizes[row] bytes, packed as
    find_matches_cuda packs it."""
    P, S = pages.shape
    mc = max_cmds_for(S)
    cmds = np.zeros((3, P, mc), dtype=np.int32)
    ncmds = np.zeros(P, dtype=np.int32)
    tail = np.zeros(P, dtype=np.int32)
    arr = pages.numpy()
    for row, n in enumerate(in_sizes.tolist()):
        found, tail[row] = find_matches(arr[row, :n].tobytes(), max_chain)
        ncmds[row] = len(found)
        if found:
            cmds[:, row, :len(found)] = np.asarray(found, np.int32).T
    ins, cpy, dist = (torch.from_numpy(c) for c in cmds)
    return ins, cpy, dist, torch.from_numpy(ncmds), torch.from_numpy(tail)


def find_matches_cuda(pages, in_sizes, max_chain: int):
    """The two kernels on the pages' card. Returns (ins, cpy, dist [P,
    max_cmds_for(S)] int32, ncmds [P], tail [P]): find_matches_plain's
    tensors, on the card. A call allocates a scratch of 8 P S bytes."""
    pages = pages.contiguous()
    if pages.data_ptr() % 16:
        pages = pages.clone()
    dev = pages.device
    sizes = in_sizes.to(device=dev, dtype=torch.int32).contiguous()
    P, S = pages.shape
    mc = max_cmds_for(S)
    scratch = torch.empty(2 * P * S, dtype=torch.int32, device=dev)
    ins, cpy, dist = (torch.empty((P, mc), dtype=torch.int32, device=dev)
                      for _ in range(3))
    ncmds, tail = (torch.empty(P, dtype=torch.int32, device=dev)
                   for _ in range(2))
    _kernels.check_cuda_args(pages, sizes, scratch, ins, cpy, dist, ncmds,
                             tail)
    if P:
        _kernels.launch("ref_parse", "blg_ref_parse_sort", dev,
                        pages.data_ptr(), sizes.data_ptr(), P, S,
                        scratch.data_ptr())
        _kernels.launch("ref_parse", "blg_ref_parse_walk", dev,
                        pages.data_ptr(), sizes.data_ptr(), P, S,
                        int(max_chain), mc, scratch.data_ptr(),
                        ins.data_ptr(), cpy.data_ptr(), dist.data_ptr(),
                        ncmds.data_ptr(), tail.data_ptr())
    return ins, cpy, dist, ncmds, tail


def find_matches_pages(pages, in_sizes, max_chain: int = 64):
    """find_matches of every row of pages (uint8 [P, S]) over its first
    in_sizes[row] bytes (int [P], each in [0, S]): (ins, cpy, dist [P,
    max_cmds_for(S)] int32, ncmds [P], tail [P]) on the pages' device,
    row r's commands in its first ncmds[r] columns. CUDA tensors run the
    kernels, CPU tensors the plain version; raises on a shape they do not
    take."""
    check_pages(pages, in_sizes)
    S = pages.shape[1]
    if not all(0 <= n <= S for n in in_sizes.tolist()):
        raise ValueError("parse in_sizes: each must lie in [0, S]")
    max_chain = min(max(int(max_chain), 0), S)   # a chain holds < S
    if pages.is_cuda:
        return find_matches_cuda(pages, in_sizes, max_chain)
    if pages.device.type != "cpu":
        raise ValueError(f"parse pages on unsupported device {pages.device}")
    return find_matches_plain(pages, in_sizes.cpu(), max_chain)
