"""The windowed-DP kernel (csrc/dp_parse.cu): the wrapper that launches it.

Replaces the XLA lax.scan of brotlig_tpu/ops/parse_dp.py::dp_parse, which
has no Pallas kernel: on the TPU, XLA fused the scan body into one device
loop. In eager torch each op of that body is a launch, about 1.85 million
of them for one cost-model iteration of a 64 KiB page, so the port runs
the whole block loop in one kernel instead, one thread block a page. Its
plain version is ops/parse_dp.py::dp_parse_plain (dp_parse dispatches: the
kernel on a CUDA tensor, the plain version on a CPU tensor). The kernel
stops a block at its fixed point and builds the terms that do not depend
on dp one block ahead in producer warps (csrc/dp_parse.cu's header);
tests/test_torch_dp_rounds.py renders that schedule in torch.
"""
from __future__ import annotations

import torch

from .. import _kernels

LEN_BITS = 10                     # from_len field of the packed dp value
NJOINT = 24 * 24                  # joint (insert code, copy code) symbols


def check_dp_args(S: int, B: int, W: int, R: int) -> None:
    """Raise ValueError unless the block B, window W and rounds R fit a
    page of S bytes: S % B == 0, W % B == 0, 0 < W < 1024, 0 < B <= 63,
    R >= 0 (the from_len field holds W; the closure's packed argmin holds
    a block cell in 6 bits)."""
    if not (0 < B <= 63 and 0 < W < (1 << LEN_BITS) and R >= 0
            and S % B == 0 and W % B == 0):
        raise ValueError(f"dp_parse needs S % B == 0, W % B == 0, "
                         f"0 < W < {1 << LEN_BITS}, 0 < B <= 63 and R >= 0; "
                         f"got S={S}, B={B}, W={W}, R={R}")


def dp_parse_cuda(litq, cand_len, dpackq, jointEq, jointLq, B: int, W: int,
                  R: int, return_rounds: bool = False):
    """Launch the DP kernel: litq [P, S], cand_len and dpackq [P, S, K],
    jointEq and jointLq [P, 576], all on one CUDA device, K <= 32 (the
    kernel holds a node's landing candidates in a bit mask). Returns the
    combined [P, S] int32 of parse_dp.dp_parse; with return_rounds, also
    the rounds each page ran, summed over its blocks (int32 [P]: a block
    stops at its first round in which no dp value fell, else after R). W +
    B and K size the kernel's shared memory (88,496 B at W 512, B 32, K
    12); a shape that needs more than the card's 227 KB raises here (the
    kernel's C entry point refuses it before any launch)."""
    P, S = litq.shape
    K = cand_len.shape[2] if cand_len.dim() == 3 else -1
    check_dp_args(S, B, W, R)
    if (cand_len.shape != (P, S, K) or dpackq.shape != (P, S, K)
            or not 0 < K <= 32
            or jointEq.shape != (P, NJOINT) or jointLq.shape != (P, NJOINT)):
        raise ValueError(
            f"dp_parse shapes: litq {tuple(litq.shape)}, cand_len "
            f"{tuple(cand_len.shape)}, dpackq {tuple(dpackq.shape)}, jointEq "
            f"{tuple(jointEq.shape)}, jointLq {tuple(jointLq.shape)}")
    ops = [x.to(torch.int32).contiguous()
           for x in (litq, cand_len, dpackq, jointEq, jointLq)]
    out = torch.empty((P, S), dtype=torch.int32, device=litq.device)
    rounds = (torch.empty(P, dtype=torch.int32, device=litq.device)
              if return_rounds else None)
    _kernels.check_cuda_args(*ops, out)
    _kernels.launch("dp_parse", "blg_dp_parse", litq.device,
                    *[t.data_ptr() for t in ops], P, S, K, B, W, R,
                    out.data_ptr(),
                    None if rounds is None else rounds.data_ptr())
    return (out, rounds) if return_rounds else out
