"""Multi-archive decode and encode (port of brotlig_tpu/parallel/runtime.py
on one process's share; the cross-process gathers are not ported yet).

Archives are assigned to processes statically, archive i to process
i % nprocs: the deterministic schedule that replaces the reference's
atomic work queue. Each process decodes its own share, and every output
keeps its archive index, so gathering them needs no ordering step. The
process identity comes from torch.distributed when it is initialised,
else it is (0, 1); a caller may pass its own.

decode_archives_batched pools the pages of many archives into shared
device batches, the way a loader streams thousands of small assets: the
analog of the reference GPU decoder draining a meta buffer of many
streams in one dispatch (BrotliGCompute.hlsl:1755-1882).
"""
from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from .. import api
from ..format.headers import parse_container
from ..ops.decode import (_check_opts, decode_batches, decode_stream,
                          resolve_device)
from ..ops.precondition import postprocess_device


def process_info():
    """(rank, world size) of this process in torch.distributed when it is
    initialised, else (0, 1)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def my_archive_indices(n_archives: int, process=None) -> list[int]:
    """Static interleaved assignment of archives to this process.

    `process=(pid, nprocs)` overrides auto-detection (a launcher that does
    not initialise torch.distributed passes its own identity)."""
    pid, nproc = process if process is not None else process_info()
    return list(range(pid, n_archives, nproc))


def decode_archives(blobs: Sequence[bytes], batch_pages: int = 256,
                    process=None, device="cuda") -> dict[int, bytes]:
    """Decode this process's share of `blobs` on `device`, one archive
    after another (ops.decode.decode_stream).

    Returns {archive_index: decompressed bytes} for the archives this
    process owns; with one process that is every archive."""
    return {i: decode_stream(blobs[i], device, batch_pages=batch_pages)
            for i in my_archive_indices(len(blobs), process)}


def decode_archives_to_dir(blobs: Sequence[bytes], out_dir,
                           batch_pages: int = 256, process=None, name=None,
                           device="cuda") -> list:
    """The shared-storage flow: each process decodes the archives it owns
    and writes them to `out_dir/<name(i)>`, so no bytes move between
    processes. Returns the paths this process wrote. `name(i)` defaults
    to 'archive_%05d.bin'."""
    os.makedirs(out_dir, exist_ok=True)
    if name is None:
        name = lambda i: f"archive_{i:05d}.bin"  # noqa: E731
    paths = []
    for i in my_archive_indices(len(blobs), process):
        data = decode_stream(blobs[i], device, batch_pages=batch_pages)
        path = os.path.join(out_dir, name(i))
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
        paths.append(path)
    return paths


def decode_archives_batched(blobs: Sequence[bytes], batch_pages: int = 256,
                            device="cuda", variant=None,
                            sweep_cw: int = 1024) -> list[bytes]:
    """Decode many containers in shared device batches; outputs keep
    archive order.

    The compressed pages of every archive are pooled by page size and go
    through the same staging, kernels and pipeline as decode_stream
    (ops.decode.decode_batches): size-sorted batches of `batch_pages`,
    the last one short, so each page is decoded once. Raw pages are
    copied on the host. A preconditioned archive is assembled on the host
    and then delta-decoded and deconditioned on `device`
    (ops.precondition.postprocess_device). variant and sweep_cw pick the
    route as in decode_stream."""
    _check_opts(variant, sweep_cw)
    dev = resolve_device(device)
    infos = [parse_container(blob) for blob in blobs]
    outs = [bytearray(info.out_size) for info in infos]
    delta_pages: list[set] = [set() for _ in blobs]
    # page size -> [(archive, page index)] of the compressed pages
    jobs_by_psize: dict[int, list] = {}
    for ai, (blob, info) in enumerate(zip(blobs, infos)):
        ps = info.header.page_size
        for i in info.raw_page_indices():
            off, n = int(info.offsets[i]), info.page_out_sizes[i]
            outs[ai][i * ps: i * ps + n] = blob[off: off + n]
        jobs_by_psize.setdefault(ps, []).extend(
            (ai, i) for i in info.compressed_page_indices())

    out_np = [np.frombuffer(o, np.uint8) for o in outs]
    for ps, jobs in jobs_by_psize.items():
        # one payload of the archives that have pages here
        archives = sorted({ai for ai, _ in jobs})
        base, parts, pos = {}, [], 0
        for ai in archives:
            base[ai] = pos
            parts.append(blobs[ai])
            pos += len(blobs[ai])
        offsets = [base[ai] + int(infos[ai].offsets[i]) for ai, i in jobs]
        sizes = [int(infos[ai].sizes[i]) for ai, i in jobs]

        def drain(keys, pages, isdelta, jobs=jobs, ps=ps):
            for row, j in enumerate(keys):
                ai, i = jobs[j]
                n = infos[ai].page_out_sizes[i]
                out_np[ai][i * ps: i * ps + n] = pages[row, :n]
                if isdelta[row]:
                    delta_pages[ai].add(i)

        decode_batches(b"".join(parts), np.arange(len(jobs)), offsets,
                       sizes, ps, dev, drain, batch_pages, variant, sweep_cw)

    results = []
    for ai, info in enumerate(infos):
        if info.dc_params is not None and info.out_size:
            results.append(postprocess_device(
                bytes(outs[ai]), info.dc_params, info.header.page_size, dev,
                delta_pages[ai]))
        else:
            results.append(bytes(outs[ai]))
    return results


def encode_archives(datas: Sequence[bytes], page_size: int = 65536,
                    process=None, quality: int = 11,
                    device="cuda") -> dict[int, bytes]:
    """Encode this process's share of `datas` with api.encode's default
    route, the hybrid, on `device` (which parses greedily whatever
    `quality` says). Returns {archive_index: container}."""
    return {i: api.encode(datas[i], page_size=page_size, quality=quality,
                          device=device)
            for i in my_archive_indices(len(datas), process)}
