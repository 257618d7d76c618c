"""The yardstick of the kernels' roofline shares: the card's published
peak and the bytes each kernel family needs for a call, worked out from
the containers and textures the benchmark made.

The peak is NVIDIA's data sheet for one H100 SXM: 3.35 TB/s of HBM3 at
the full 700 W. A card may be set below that; `power_limit` reads the
card's limit so that every result carries it. The decode kernels and the
texture postprocess do a few integer operations a byte, so bytes bound
them; each byte is counted once where it is read and once where it is
written, whatever the kernel reads again.
"""
from __future__ import annotations

import subprocess

from .reference.headers import StreamHeader, unpack_page_table
from .reference import constants as C

HBM_BYTES_PER_S = 3.35e12


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reports them, or
    why they could not be read."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"
    return res.stdout.strip().splitlines()[0] if res.stdout.strip() \
        else f"nvidia-smi rc {res.returncode}"


def page_table(blob: bytes):
    """(compressed sizes, decoded sizes) of a container's pages, from its
    header and page table."""
    header = StreamHeader.unpack(blob)
    pos = C.STREAM_HEADER_SIZE_BYTES
    if header.preconditioned:
        pos += C.PRECON_HEADER_SIZE_BYTES
    n = header.num_pages
    _, sizes = unpack_page_table(blob[pos:], n)
    out = [header.page_size] * n
    if n and header.last_page_size:
        out[-1] = header.last_page_size
    return [int(s) for s in sizes], out


def decode_kernel_bytes(blob: bytes) -> int:
    """Bytes the decode kernels (tables, then the fused decode or phase A
    and the sweep) need for a container: each compressed page read once
    and its decoded bytes written once. Raw pages never reach them."""
    sizes, outs = page_table(blob)
    return sum(s + o for s, o in zip(sizes, outs) if s != o)


def precond_bytes(blob: bytes) -> int:
    """Bytes the texture postprocess needs for a preconditioned container
    decoded on the card: the decoded plane read once, the texture written
    once; 0 for a plain container."""
    header = StreamHeader.unpack(blob)
    return 2 * header.uncompressed_size if header.preconditioned else 0


def share_pct(nbytes: int, seconds: float | None) -> float | None:
    """The least time `nbytes` takes at the peak over the time taken, in
    %; None where there is no time or no bytes to read."""
    if not seconds or not nbytes:
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S / seconds
