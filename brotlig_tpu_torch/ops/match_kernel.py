"""Wrappers of the matcher's CUDA kernels (csrc/match.cu).

ops/encode.py::find_commands and find_candidates call them on CUDA tensors
(their plain versions, find_commands_plain / find_candidates_plain, run on
CPU tensors). They replace the JAX package's compiled find_commands and
find_candidates over _scan_matches (brotlig_tpu/ops/encode.py:142, :339,
:360), which have no Pallas kernel. A call makes six launches of the
file's four kernels, each counted under ``_kernels.LAUNCHES["match"]``:
the two passes of the sort (hist, scatter; hist, scatter), probe and
finish.
"""
from __future__ import annotations

import torch

from .. import _kernels

LAUNCHES_PER_CALL = 6
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


def _sort_and_probe(pages, sizes, nfam: int, rank_words: int, cap: int,
                    cand_len=None, cand_dist=None):
    """Launch the sort (two passes of hist and scatter) and the probe
    kernel; returns the per-position (lens, dists) int32 [P, S] the finish
    kernel reads."""
    P, S = pages.shape
    dev = pages.device
    lib = _kernels.library()
    hist = torch.empty((P, nfam, 256, lib.blg_match_tiles(S)),
                       dtype=torch.int32, device=dev)
    pairs1 = torch.empty((P, nfam, 2 * S), dtype=torch.int32, device=dev)
    pairs2 = torch.empty_like(pairs1)
    rank = torch.empty((P, nfam, S), dtype=torch.int32, device=dev)
    lens = torch.empty((P, S), dtype=torch.int32, device=dev)
    dists = torch.empty_like(lens)
    out = [] if cand_len is None else [cand_len, cand_dist]
    _kernels.check_cuda_args(pages, sizes, hist, pairs1, pairs2, rank, lens,
                             dists, *out)
    common = (pages.data_ptr(), sizes.data_ptr(), P, S, nfam)
    for pas, src, dst in ((0, pairs1, pairs1), (1, pairs1, pairs2)):
        _kernels.launch("match", "blg_match_hist", dev, *common, pas,
                        src.data_ptr(), hist.data_ptr())
        _kernels.launch("match", "blg_match_scatter", dev, *common, pas,
                        hist.data_ptr(), src.data_ptr(), dst.data_ptr(),
                        rank.data_ptr())
    _kernels.launch("match", "blg_match_probe", dev, *common, rank_words,
                    cap, pairs2.data_ptr(), rank.data_ptr(), lens.data_ptr(),
                    dists.data_ptr(),
                    *[None if t is None else t.data_ptr()
                      for t in (cand_len, cand_dist)])
    return lens, dists


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
    ins, cpy, dist = (torch.empty((P, max_cmds), dtype=torch.int32,
                                  device=dev) for _ in range(3))
    ncmds = torch.empty(P, dtype=torch.int32, device=dev)
    if P == 0:
        return ins, cpy, dist, ncmds
    lens, dists = _sort_and_probe(pages, sizes, FAMILIES_COVER,
                                  FAST_WORDS if fast else EXACT_WORDS, 0)
    nodes = torch.empty((P, _kernels.library().blg_match_nodes_ints(S)),
                        dtype=torch.int32, device=dev)
    step = torch.empty((P, S), dtype=torch.int32, device=dev)
    _kernels.check_cuda_args(nodes, step, ins, cpy, dist, ncmds)
    _kernels.launch("match", "blg_match_finish", dev, sizes.data_ptr(), P,
                    S, max_cmds, 0, lens.data_ptr(), dists.data_ptr(),
                    step.data_ptr(), nodes.data_ptr(), ins.data_ptr(),
                    cpy.data_ptr(), dist.data_ptr(), ncmds.data_ptr(), None)
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
    cand_len = torch.empty((P, S, 8), dtype=torch.int32, device=dev)
    cand_dist = torch.empty_like(cand_len)
    if P == 0:
        return cand_len, cand_dist
    lens, dists = _sort_and_probe(pages, sizes, FAMILIES_CANDIDATES,
                                  EXACT_WORDS, cap, cand_len, cand_dist)
    _kernels.launch("match", "blg_match_finish", dev, sizes.data_ptr(), P,
                    S, 1, cap, lens.data_ptr(), dists.data_ptr(), None, None,
                    None, None, None, None, cand_len.data_ptr())
    return cand_len, cand_dist
