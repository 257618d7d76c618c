"""Public decode API of the PyTorch/CUDA port (mirrors brotlig_tpu.api).

decode()              -> batched page decode on a torch device
decompressed_size()   -> header-only size query
max_compressed_size() -> one-shot output buffer bound
"""
from __future__ import annotations

from .format import constants as C
from .format.headers import StreamHeader
from .ops.decode import decode_stream

__all__ = ["decode", "decompressed_size", "max_compressed_size"]

max_compressed_size = C.max_compressed_size


def decode(data: bytes, device="cuda", feedback=None,
           variant: str | None = None, sweep_cw: int = 1024,
           return_device: bool = False):
    """Decode a Brotli-G container on `device`.

    "cuda" runs the hand-written kernels and raises when torch has no
    CUDA device; "cpu" runs their plain torch versions. Preconditioned
    (BCn texture) containers are delta-decoded and deconditioned on
    `device` too; with return_device=True such a texture comes back as a
    uint8 tensor on `device` (see ops.decode.decode_stream for when).
    feedback: optional callable(progress 0..100) -> bool invoked per page
    batch; returning True raises format.errors.Aborted.
    variant / sweep_cw: the decode route ("fused", the default; "two_phase";
    "xla") and the sweep kernel's group width, as ops.decode.decode_stream
    describes them."""
    return decode_stream(data, device, feedback=feedback, variant=variant,
                         sweep_cw=sweep_cw, return_device=return_device)


def decompressed_size(data: bytes) -> int:
    return StreamHeader.unpack(data).uncompressed_size
