"""The tables kernel (csrc/tables.cu) and its plain version.

Replaces brotlig_tpu/ops/pallas_tables.py::load_tables_pallas (kernel body
make_tables_kernel) together with the XLA tables.build_search that the JAX
package runs after it: for each page, read the three prefix codes
(commands, distances, literals) from the 32 interleaved sub-streams and
return them in canonical range-search form, packed as the fused decode and
phase-A kernels read them (state.KernelTables), with every stream's bit
cursor past the tables.

On a CUDA tensor, load_tables launches the kernel; on a CPU tensor it runs
the plain version, tables_plain: three chained tables.load_table calls on
the stream view (load_tables_plain, the code lengths), build_search on
each code (state.tables_from_lengths) and state.pack_tables. The plain
version is also callable on a CUDA tensor for comparison. The CPU decode
route reads the unpacked state.Tables (tables_from_lengths of
load_tables_plain) directly.
"""
from __future__ import annotations

import torch

from ..format import constants as C

from .. import _kernels
from ..state import KernelTables, pack_tables, tables_from_lengths
from .tables import load_table, stream_view_from_interleaved

NBS = C.NUM_BITSTREAMS
# Tables end < 40 words into every stream; the speculative RLE overshoot
# stays < 64 (csrc/tables.cu keeps these words in shared memory).
TABLE_WORDS = 64
ALPHABETS = (C.NUM_COMMAND_SYMBOLS_EFFECTIVE, C.NUM_DISTANCE_SYMBOLS,
             C.NUM_LITERAL_SYMBOLS)
LEN_SLOTS = C.HUFFMAN_NUM_CODE_LENGTH + 1       # limit/first/offset width


def load_tables(buf3: torch.Tensor) -> KernelTables:
    """The decode tables of a staged batch buf3 [Wc, P, 128] int32, as
    state.KernelTables (int32 meta [P, 3, 3, 17], dicts [P, 1528], trivs
    [P, 3], bp [P, 32])."""
    if buf3.is_cuda:
        return _load_tables_cuda(buf3)
    if buf3.device.type == "cpu":
        return tables_plain(buf3)
    raise ValueError(f"no tables route for device {buf3.device}")


def tables_plain(buf3: torch.Tensor) -> KernelTables:
    """Plain torch version of the tables kernel."""
    return pack_tables(tables_from_lengths(*load_tables_plain(buf3)))


def load_tables_plain(buf3: torch.Tensor):
    """The code lengths, as load_tables_pallas returns them (int64):
    (lengths_icp [P, 728], lengths_dst [P, 544], lengths_lit [P, 256],
    trivs [P, 3], bp [P, 32] stream-local bit cursors past the tables)."""
    tl = min(TABLE_WORDS, buf3.shape[0] * 128 // NBS)
    view, bp0 = stream_view_from_interleaved(buf3, tl)
    bp = bp0
    lengths, trivs = [], []
    for A in ALPHABETS:
        ln, triv, bp = load_table(view, bp, A)
        lengths.append(ln)
        trivs.append(triv)
    return (*lengths, torch.stack(trivs, dim=1), bp - bp0)


def _load_tables_cuda(buf3: torch.Tensor) -> KernelTables:
    if buf3.dtype != torch.int32 or buf3.dim() != 3 or buf3.shape[2] != 128:
        raise ValueError(f"staged buffer {tuple(buf3.shape)} {buf3.dtype}")
    buf3 = buf3.contiguous()
    wc, P, _ = buf3.shape
    dev = buf3.device

    def empty(*shape):
        return torch.empty(shape, dtype=torch.int32, device=dev)
    out = KernelTables(empty(P, 3, 3, LEN_SLOTS), empty(P, sum(ALPHABETS)),
                       empty(P, 3), empty(P, NBS))
    _kernels.check_cuda_args(buf3, *out)
    _kernels.launch("tables", "blg_load_tables", dev, buf3.data_ptr(), wc,
                    P, *[t.data_ptr() for t in out])
    return out
