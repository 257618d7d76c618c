"""Wrappers of the matcher's CUDA kernels (csrc/match.cu).

ops/encode.py::find_commands and find_candidates call them on CUDA tensors
(their plain versions, find_commands_plain / find_candidates_plain, run on
CPU tensors). They replace the JAX package's compiled find_commands and
find_candidates over _scan_matches (brotlig_tpu/ops/encode.py:142, :339,
:360), which have no Pallas kernel. A call makes two launches, each
counted under ``_kernels.LAUNCHES["match"]``: sort_probe (a cluster of 2,
4 or 8 CTAs a page and key family: the family's sort and its probes on
chip) and finish (a block a page: the runs, the fold, the chain, and the
cover or the candidates' rows). A call allocates one scratch tensor
beside its outputs.
"""
from __future__ import annotations

import torch

from .. import _kernels

LAUNCHES_PER_CALL = 2
FAMILIES_COVER = 2          # the 4- and 8-byte key families
FAMILIES_CANDIDATES = 3     # and the 3-byte one
EXACT_WORDS = 16            # candidate ranking words: MAX_MATCH_WORDS
FAST_WORDS = 3              # FAST_PROBE_WORDS


def check_pages(pages, in_sizes) -> None:
    """Raise ValueError unless pages is uint8 [P, S] with S a positive
    multiple of 4 up to 128 KiB and in_sizes has P entries."""
    if pages.dim() != 2 or pages.dtype != torch.uint8:
        raise ValueError(f"matcher pages: want uint8 [P, S], got "
                         f"{pages.dtype} {tuple(pages.shape)}")
    P, S = pages.shape
    if not (0 < S <= 1 << 17 and S % 4 == 0):
        raise ValueError(f"matcher pages: S must be a multiple of 4 in "
                         f"(0, 131072], got {S}")
    if in_sizes.shape != (P,):
        raise ValueError(f"matcher in_sizes: want ({P},), got "
                         f"{tuple(in_sizes.shape)}")


def _operands(pages, in_sizes):
    """The pages as a 16-byte aligned contiguous uint8 tensor and the sizes
    as int32, both on the pages' device."""
    pages = pages.contiguous()
    if pages.data_ptr() % 16:
        pages = pages.clone()
    return pages, in_sizes.to(device=pages.device,
                              dtype=torch.int32).contiguous()


def _sort_probe(pages, sizes, nfam: int, rank_words: int):
    """Launch sort_probe; returns the call's scratch (the families' words,
    and the candidates' near probes, that the finish kernel reads)."""
    P, S = pages.shape
    scratch = torch.empty(_kernels.library().blg_match_scratch_ints(
        P, S, nfam), dtype=torch.int32, device=pages.device)
    _kernels.check_cuda_args(pages, sizes, scratch)
    _kernels.launch("match", "blg_match_sort_probe", pages.device,
                    pages.data_ptr(), sizes.data_ptr(), P, S, nfam,
                    rank_words, scratch.data_ptr())
    return scratch


def find_commands_cuda(pages, in_sizes, max_cmds: int, fast: bool = False):
    """The greedy cover on the card: pages uint8 [P, S], in_sizes [P] (page
    sizes in [0, S]). Returns (ins, cpy, dist [P, max_cmds] int32, ncmds
    [P] int32), the plain version's commands. Raises ValueError on a shape
    the kernels do not take (see check_pages; max_cmds >= 1)."""
    check_pages(pages, in_sizes)
    if max_cmds < 1:
        raise ValueError(f"find_commands needs max_cmds >= 1, got {max_cmds}")
    pages, sizes = _operands(pages, in_sizes)
    P, S = pages.shape
    dev = pages.device
    words = FAST_WORDS if fast else EXACT_WORDS
    # sort_probe first: the card starts on it while the outputs are made
    scratch = _sort_probe(pages, sizes, FAMILIES_COVER, words) if P else None
    ins, cpy, dist = (torch.empty((P, max_cmds), dtype=torch.int32,
                                  device=dev) for _ in range(3))
    ncmds = torch.empty(P, dtype=torch.int32, device=dev)
    if P == 0:
        return ins, cpy, dist, ncmds
    _kernels.check_cuda_args(ins, cpy, dist, ncmds)
    _kernels.launch("match", "blg_match_finish", dev, pages.data_ptr(),
                    sizes.data_ptr(), P, S, FAMILIES_COVER, max_cmds, 0,
                    words, scratch.data_ptr(), ins.data_ptr(), cpy.data_ptr(),
                    dist.data_ptr(), ncmds.data_ptr(), None, None)
    return ins, cpy, dist, ncmds


def find_candidates_cuda(pages, in_sizes, cap: int):
    """The DP's candidates on the card: pages uint8 [P, S], in_sizes [P]
    (page sizes in [0, S]), lengths clipped to cap. Returns (cand_len,
    cand_dist) [P, S, 8] int32, the plain version's. Raises ValueError on
    a shape the kernels do not take (see check_pages)."""
    check_pages(pages, in_sizes)
    pages, sizes = _operands(pages, in_sizes)
    P, S = pages.shape
    dev = pages.device
    scratch = (_sort_probe(pages, sizes, FAMILIES_CANDIDATES, EXACT_WORDS)
               if P else None)
    cand_len = torch.empty((P, S, 8), dtype=torch.int32, device=dev)
    cand_dist = torch.empty_like(cand_len)
    if P == 0:
        return cand_len, cand_dist
    _kernels.check_cuda_args(cand_len, cand_dist)
    _kernels.launch("match", "blg_match_finish", dev, pages.data_ptr(),
                    sizes.data_ptr(), P, S, FAMILIES_CANDIDATES, 1, cap,
                    EXACT_WORDS, scratch.data_ptr(), None, None, None, None,
                    cand_len.data_ptr(), cand_dist.data_ptr())
    return cand_len, cand_dist
