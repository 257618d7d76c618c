"""How `correct` is decided, and the faults that must turn it false.

The format is lossless, so every number compared has the limit 0:
- decode: each judged output of the timed calls against the bytes the
  benchmark generated (the reference of a lossless decode is its input);
- encode: each container the timed calls made, decoded by the plain
  decoder in reference/ (nothing of the port judges), against the input.
`bad_bytes` counts the bytes that differ, plus the difference in length;
`failed_calls` the timed calls that raised. A run that judged no output
is not correct.

FAULTS break the timed path underneath, for the control and the tests:
- "lossy": the control. The guarantee the configurations state is a
  lossless codec; this breaks it as a lower precision would, the low bit
  of every byte dropped (decode: of the output; encode: of the input);
- "alter": one answer altered where it is produced (decode: a byte of
  the output; encode: a byte in the middle of the first page);
- "half": half of the answer left out (decode: the output's second half;
  encode: the container of the input's first half).
"""
from __future__ import annotations

import os
from concurrent.futures import ProcessPoolExecutor
import multiprocessing

import numpy as np

FAULTS = ("lossy", "alter", "half")


def as_bytes(out) -> bytes:
    """A call's output as bytes: a device tensor is read back."""
    if isinstance(out, (bytes, bytearray)):
        return bytes(out)
    return out.cpu().numpy().tobytes()


def bad_bytes(got: bytes, want: bytes) -> int:
    if got == want:
        return 0
    n = min(len(got), len(want))
    a = np.frombuffer(got, np.uint8, n)
    b = np.frombuffer(want, np.uint8, n)
    return int(np.count_nonzero(a != b)) + abs(len(got) - len(want))


def _low_bit_dropped(out):
    if isinstance(out, (bytes, bytearray)):
        return (np.frombuffer(out, np.uint8) & 0xFE).tobytes()
    return out & 0xFE


def _one_byte_altered(out, at: int):
    if isinstance(out, (bytes, bytearray)):
        b = bytearray(out)
        b[at] ^= 0xFF
        return bytes(b)
    out = out.clone()
    out[at] ^= 0xFF
    return out


def first_page_middle(blob: bytes) -> int:
    """The offset of the middle byte of a container's first page."""
    num_pages = int.from_bytes(blob[2:4], "little")
    precond = bool(blob[6] & 0x10)          # bit 20 of the header's bits
    table = 8 + (8 if precond else 0)
    base = table + 4 * num_pages
    # entry 0 of the page table is the last page's size; page 0 ends
    # where page 1 starts
    end = (int.from_bytes(blob[table + 4: table + 8], "little")
           if num_pages > 1 else len(blob) - base)
    return base + end // 2


def with_fault(call, op: str, fault: str | None):
    """`call(item)` with `fault` planted in its answer."""
    if fault is None:
        return call
    if fault not in FAULTS:
        raise ValueError(f"fault {fault!r} not in {FAULTS}")
    if op == "decode":
        def decode(it):
            out = call(it)
            if fault == "lossy":
                return _low_bit_dropped(out)
            if fault == "alter":
                return _one_byte_altered(out, len(out) // 2)
            return out[: len(out) // 2]
        return decode

    def encode(it):
        data = it.data
        if fault == "lossy":
            data = _low_bit_dropped(data)
        elif fault == "half":
            data = data[: len(data) // 2]
        blob = call(type(it)(it.name, data, it.dc, it.blob))
        if fault == "alter":
            blob = _one_byte_altered(blob, first_page_middle(blob))
        return blob
    return encode


def judge_outputs(kept: dict, items, records) -> dict:
    """Decode: every kept output against its input."""
    bad = [bad_bytes(as_bytes(out), items[records[k].item].data)
           for k, out in kept.items()]
    return {"compared": len(bad), "bad_bytes": sum(bad),
            "bad_calls": sum(b > 0 for b in bad)}


def _reference_bad(blob: bytes, want: bytes) -> int:
    from .reference import decode
    try:
        got = decode(blob)
    except Exception:           # a container the plain decoder refuses
        return max(len(want), 1)
    return bad_bytes(got, want)


def judge_containers(kept: dict, items, records,
                     workers: int | None = None) -> dict:
    """Encode: every kept container decoded by the plain decoder, in a
    pool of processes. A container equal to one already judged for the
    same input shares its verdict."""
    first: dict = {}            # item -> (container, job index)
    jobs, owner = [], []
    for k in sorted(kept):
        i = records[k].item
        blob = kept[k]
        if i in first and first[i][0] == blob:
            owner.append(first[i][1])
            continue
        jobs.append((blob, items[i].data))
        first.setdefault(i, (blob, len(jobs) - 1))
        owner.append(len(jobs) - 1)
    workers = min(workers or os.cpu_count() or 1, max(len(jobs), 1))
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(workers, mp_context=ctx) as pool:
        verdicts = list(pool.map(_reference_bad, *zip(*jobs))) if jobs \
            else []
    bad = [verdicts[j] for j in owner]
    return {"compared": len(bad), "bad_bytes": sum(bad),
            "bad_calls": sum(b > 0 for b in bad)}
