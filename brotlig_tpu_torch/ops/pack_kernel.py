"""Wrapper of the serializer's CUDA kernel (csrc/pack.cu).

The kernel packs a whole batch in one launch, one thread block a page:
ops/encode_pack.py::pack_pages_device and pack_partitioned call it on
CUDA tensors (the plain version, pack_pages_plain / pack_partitioned_plain,
runs on CPU tensors). It replaces the JAX package's compiled _pack_jit
(brotlig_tpu/ops/encode_pack.py:985), which has no Pallas kernel.
"""
from __future__ import annotations

import torch

from .. import _kernels

# the per-page record the kernel leaves in its scratch (read by a
# diagnosis and chip_smoke.py's phase split, never by a route): offsets
# in int32 words. Modes, counts and tsel hold one value a table (command,
# distance, literal); the code lengths are the three tables' in a row.
INFO_NPOSTFIX, INFO_NDIST = 0, 1
INFO_MODE, INFO_COUNT, INFO_TSEL = 2, 5, 8
# the size cases a page took (bits): its streams written into per-stream
# words in the scratch and assembled byte by byte (a stream past its
# words, or padding read from past them), its grid-search keys sorted in
# the scratch (more commands than the shared region holds keys for), its
# literal queue in shared memory (where it fits beside the page image)
INFO_BRANCH, BRANCH_WORDS, BRANCH_KEYS, BRANCH_LQ = 11, 1, 2, 4
INFO_NLITS, INFO_MOST_FREQ, INFO_NTOTAL, INFO_NKEYS, INFO_OFFSET_CODES = \
    14, 15, 16, 17, 18
INFO_BITS, INFO_CLOCKS, INFO_LENS = 19, 52, 64
# the kernel's phases, in order, whose clock cycles (thread 0's clock from
# the end of one to the end of the next) the record keeps at INFO_CLOCKS
PHASES = ("starts and ring codes", "distance sort", "grid search",
          "ring mode, fields, histograms, literal queue", "code lengths",
          "canonical codes and run-coded tables", "round schedule",
          "stream widths", "header", "bit packing",
          "copy out or assembly")


def pack_cuda(pages, in_sizes, ins, cpy, dist, ncmds, page_size: int,
              max_cmds: int, isdelta=None, return_info: bool = False):
    """Launch the serializer on a batch: pages uint8 [P, page_size];
    in_sizes, ncmds [P]; ins/cpy/dist [P, N] (zero past ncmds; values that
    fit int32); isdelta [P] or None. Returns (out [P, page_size] uint8,
    out_sizes [P] int64), the plain version's bytes and sizes; with
    return_info, also each page's record (int32 [P, INFO], see the INFO_*
    offsets). Raises ValueError on a shape the kernel does not take: rows
    of the page size (a multiple of 4, at most 128 KiB), at least one
    command column, a positive command bound."""
    P, S = pages.shape
    N = ins.shape[1] if ins.dim() == 2 else -1
    if not (S == page_size and 0 < page_size <= 1 << 17
            and page_size % 4 == 0 and N >= 1 and max_cmds >= 1):
        raise ValueError(
            f"pack kernel needs pages of page_size bytes (a multiple of 4, "
            f"at most 128 KiB), N >= 1 command columns and max_cmds >= 1; "
            f"got S={S}, page_size={page_size}, N={N}, max_cmds={max_cmds}, "
            f"P={P}")
    if (pages.dtype != torch.uint8 or cpy.shape != ins.shape
            or dist.shape != ins.shape or ins.shape[0] != P
            or in_sizes.shape != (P,) or ncmds.shape != (P,)
            or (isdelta is not None and isdelta.shape != (P,))):
        raise ValueError(
            f"pack shapes: pages {tuple(pages.shape)} {pages.dtype}, ins "
            f"{tuple(ins.shape)}, cpy {tuple(cpy.shape)}, dist "
            f"{tuple(dist.shape)}, in_sizes {tuple(in_sizes.shape)}, ncmds "
            f"{tuple(ncmds.shape)}")
    dev = pages.device
    i32 = [x.to(torch.int32).contiguous()
           for x in (in_sizes, ins, cpy, dist, ncmds)]
    flags = (None if isdelta is None
             else isdelta.to(torch.int32).contiguous())
    pages = pages.contiguous()
    out = torch.empty((P, page_size), dtype=torch.uint8, device=dev)
    sizes = torch.empty(P, dtype=torch.int32, device=dev)
    lib = _kernels.library()
    stride = lib.blg_pack_scratch_ints(N, S, page_size)
    scratch = torch.empty((P, stride), dtype=torch.int32, device=dev)
    _kernels.check_cuda_args(pages, *i32, out, sizes, scratch,
                             *([] if flags is None else [flags]))
    if P:
        _kernels.launch("pack", "blg_pack_pages", dev, pages.data_ptr(),
                        *[t.data_ptr() for t in i32],
                        None if flags is None else flags.data_ptr(),
                        P, S, N, page_size, max_cmds, out.data_ptr(),
                        sizes.data_ptr(), scratch.data_ptr())
    sizes = sizes.to(torch.int64)
    if return_info:
        info = lib.blg_pack_info_offset(N, S, page_size)
        return out, sizes, scratch[:, info:]
    return out, sizes
