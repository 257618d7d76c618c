"""Public API of the PyTorch/CUDA port (mirrors brotlig_tpu.api).

encode()              -> device match finding (+ device or native packing)
decode()              -> batched page decode on a torch device
decode_cpu()          -> the native multithreaded C++ decoder on the host
decompressed_size()   -> header-only size query
max_compressed_size() -> one-shot output buffer bound
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

from . import native
from .format import constants as C
from .format.headers import StreamHeader, parse_container
from .format.precondition import (DataConditionParams, decondition,
                                  delta_decode_page)
from .ops.decode import decode_stream
from .ops.encode import encode_stream
from .ops.encode_pack import encode_stream_full

__all__ = ["encode", "decode", "decode_cpu", "decompressed_size",
           "max_compressed_size"]

max_compressed_size = C.max_compressed_size
ENCODE_BACKENDS = ("hybrid", "full", "native")


def encode(data: bytes, page_size: int = C.DEFAULT_PAGE_SIZE,
           dc_params: DataConditionParams | None = None,
           max_chain: int = 64, feedback=None, backend: str = "hybrid",
           quality: int = 11, device="cuda") -> bytes:
    """Compress a Brotli-G container.

    backend:
    - "hybrid" (the default; brotlig_tpu's "tpu"): bulk match finding on
      `device`, serialization by the native C++ packer. It always parses
      greedily, whatever `quality` says, so its ratio is below the native
      q11 encoder's.
    - "full" (brotlig_tpu's "tpu-full"): match finding AND serialization
      on `device`. quality < 10 is the greedy q1 tier; quality >= 10 adds
      the windowed-DP optimal parse (its block loop a CUDA kernel on the
      card), each page the smaller of the DP and the greedy parse.
    - "native" (brotlig_tpu's "cpu"): the native C++ encoder on the host;
      quality >= 10 is its two-pass optimal parse. It has no
      preconditioning: with dc_params it raises ValueError (brotlig_tpu
      falls back to its Python encoder there, which the port does not
      have).

    `device` is where the device backends run: "cuda" (the matcher, the
    DP and the serializer as CUDA kernels) raises when torch has no CUDA
    device, "cpu" runs their plain torch versions on the host.
    `dc_params` enables BCn preconditioning (conditioned and delta-encoded
    on `device`). feedback(msg_type, text) -> bool mirrors
    BROTLIG_Feedback_Proc: called per page batch on the device backends
    and per page by the native encoder; returning True raises
    format.errors.Aborted."""
    if backend == "hybrid":
        return encode_stream(data, page_size=page_size, dc_params=dc_params,
                             feedback=feedback, device=device)
    if backend == "full":
        return encode_stream_full(data, page_size=page_size,
                                  dc_params=dc_params, feedback=feedback,
                                  quality=quality, device=device)
    if backend == "native":
        if dc_params is not None:
            raise ValueError("the native encoder has no preconditioning; "
                             "use backend 'hybrid' or 'full' for dc_params")
        return native.encode(data, page_size=page_size, max_chain=max_chain,
                             quality=quality, feedback=feedback)
    raise ValueError(f"backend={backend!r} not in {ENCODE_BACKENDS}")


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


def decode_cpu(data: bytes, num_threads: int = 0) -> bytes:
    """Decode a Brotli-G container on the host with the native C++
    decoder, `num_threads` threads over the pages (0: one a core).

    A preconditioned container, which the native stream decoder refuses,
    is decoded a page at a time by native.decode_page in a thread pool:
    raw pages are copied, a page whose header sets the delta flag is
    delta decoded, and the whole is deconditioned (format/precondition.py).
    brotlig_tpu's decode_cpu takes its Python decoder there; the bytes
    are the same."""
    if not StreamHeader.unpack(data).preconditioned:
        return native.decode(data, num_threads=num_threads)
    info = parse_container(data)
    if not info.header.num_pages:
        return b""
    ps = info.header.page_size

    def page(i: int) -> bytes:
        off, size = int(info.offsets[i]), int(info.sizes[i])
        n = info.page_out_sizes[i]
        if size == n:
            return data[off: off + n]
        out = native.decode_page(data[off: off + size], n)
        # page header: npostfix (2 bits), ndirect (4), then the delta flag
        if data[off] >> 6 & 1:
            out = delta_decode_page(out, i * ps, info.dc_params)
        return out
    with ThreadPoolExecutor(num_threads or os.cpu_count() or 1) as pool:
        pages = list(pool.map(page, range(info.header.num_pages)))
    return decondition(b"".join(pages), info.dc_params)


def decompressed_size(data: bytes) -> int:
    return StreamHeader.unpack(data).uncompressed_size
