"""The tables kernel (csrc/tables.cu) and its plain version.

Replaces brotlig_tpu/ops/pallas_tables.py::load_tables_pallas (kernel body
make_tables_kernel): for each page, read the three prefix codes (commands,
distances, literals) from the 32 interleaved sub-streams and return each
symbol's code length, each table's trivial symbol and every stream's bit
cursor past the tables.

On a CUDA tensor, load_tables launches the kernel; on a CPU tensor it runs
the plain version (three chained tables.load_table calls on the stream
view), which is also callable on a CUDA tensor for comparison. The
canonical search structures (tables.build_search) are built in plain torch
after either, as the JAX package builds them in XLA after its kernel.
"""
from __future__ import annotations

import torch

from ..format import constants as C

from .. import _kernels
from .tables import load_table, stream_view_from_interleaved

NBS = C.NUM_BITSTREAMS
# Tables end < 40 words into every stream; the speculative RLE overshoot
# stays < 64.
TABLE_WORDS = 64
ALPHABETS = (C.NUM_COMMAND_SYMBOLS_EFFECTIVE, C.NUM_DISTANCE_SYMBOLS,
             C.NUM_LITERAL_SYMBOLS)


def load_tables(buf3: torch.Tensor):
    """Table load for a staged batch buf3 [Wc, P, 128] int32.

    Returns (lengths_icp [P, 728], lengths_dst [P, 544], lengths_lit
    [P, 256], trivs [P, 3], bp [P, 32] stream-local bit cursors past the
    tables): the outputs of load_tables_pallas."""
    if buf3.is_cuda:
        return _load_tables_cuda(buf3)
    if buf3.device.type == "cpu":
        return load_tables_plain(buf3)
    raise ValueError(f"no tables route for device {buf3.device}")


def load_tables_plain(buf3: torch.Tensor):
    """Plain torch version of the tables kernel (int64 results)."""
    tl = min(TABLE_WORDS, buf3.shape[0] * 128 // NBS)
    view, bp0 = stream_view_from_interleaved(buf3, tl)
    bp = bp0
    lengths, trivs = [], []
    for A in ALPHABETS:
        ln, triv, bp = load_table(view, bp, A)
        lengths.append(ln)
        trivs.append(triv)
    return (*lengths, torch.stack(trivs, dim=1), bp - bp0)


def _load_tables_cuda(buf3: torch.Tensor):
    if buf3.dtype != torch.int32 or buf3.dim() != 3 or buf3.shape[2] != 128:
        raise ValueError(f"staged buffer {tuple(buf3.shape)} {buf3.dtype}")
    buf3 = buf3.contiguous()
    wc, P, _ = buf3.shape
    dev = buf3.device
    outs = [torch.empty((P, A), dtype=torch.int32, device=dev)
            for A in ALPHABETS]
    trivs = torch.empty((P, 3), dtype=torch.int32, device=dev)
    bp = torch.empty((P, NBS), dtype=torch.int32, device=dev)
    _kernels.check_cuda_args(buf3, *outs, trivs, bp)
    lib = _kernels.library()
    rc = lib.blg_load_tables(buf3.data_ptr(), wc, P,
                             *[o.data_ptr() for o in outs],
                             trivs.data_ptr(), bp.data_ptr(),
                             _kernels.stream_ptr(dev))
    if rc != 0:
        raise RuntimeError(f"tables kernel launch failed (cudaError {rc})")
    _kernels.LAUNCHES["tables"] += 1
    return (*outs, trivs, bp)
