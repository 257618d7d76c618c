"""Multi-archive and multi-process decode and encode (port of
brotlig_tpu/parallel/runtime.py).

Archives are assigned to processes statically, archive i to process
i % nprocs: the deterministic schedule that replaces the reference's
atomic work queue. Each process decodes its own share, and every output
keeps its archive index, so gathering them needs no ordering step. The
process identity comes from torch.distributed when it is initialised,
else it is (0, 1); a caller may pass its own. The gathers
(decode_archives_gather, encode_archives_gather) hand every process every
output over torch.distributed, one all_gather of owned bytes each.

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
from ..format.headers import StreamHeader, parse_container
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
                    process=None, quality: int = 11, device="cuda",
                    backend: str = "hybrid") -> dict[int, bytes]:
    """Encode this process's share of `datas` with api.encode on `backend`
    (on `device` for the device backends). The default, the hybrid, runs
    on the card and parses greedily whatever `quality` says;
    backend="native" is the host's native encoder, brotlig_tpu's default,
    and gives its bytes. Returns {archive_index: container}."""
    return {i: api.encode(datas[i], page_size=page_size, quality=quality,
                          device=device, backend=backend)
            for i in my_archive_indices(len(datas), process)}


def _exchanges(nproc: int) -> bool:
    """Whether a gather exchanges bytes: with more than one process, and
    whenever a group is initialised, a one-rank group too; one process
    without a group keeps its local outputs."""
    import torch.distributed as dist
    return nproc > 1 or (dist.is_available() and dist.is_initialized())


def _collective_device():
    """Where the initialised group's backend takes its tensors: the
    thread's current CUDA device for NCCL, the host otherwise (gloo)."""
    import torch
    import torch.distributed as dist
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _all_gather(t):
    """[nproc] tensors: every process's `t` (the same shape on each)."""
    import torch
    import torch.distributed as dist
    dev = _collective_device()
    t = t.to(dev)
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    return [p.cpu() for p in parts]


def _gather_owned(local: dict, sizes: list, nproc: int) -> list[bytes]:
    """Every archive's bytes on every process, in archive order, from each
    process's own (`local`, {archive_index: bytes}).

    Owner p's buffer holds archives p, p + nproc, ... concatenated, padded
    to the largest owner's share; one all_gather moves the buffers, so each
    receiver gets every archive's bytes once. `sizes` (every archive's
    length) places them, on every process alike."""
    import torch
    offsets, share = [], [0] * nproc
    for i, n in enumerate(sizes):
        offsets.append(share[i % nproc])
        share[i % nproc] += n
    buf = np.zeros(max(max(share), 1), np.uint8)
    for i, b in local.items():
        buf[offsets[i]: offsets[i] + len(b)] = np.frombuffer(b, np.uint8)
    g = [p.numpy() for p in _all_gather(torch.from_numpy(buf))]
    return [g[i % nproc][offsets[i]: offsets[i] + n].tobytes()
            for i, n in enumerate(sizes)]


def decode_archives_gather(blobs: Sequence[bytes], batch_pages: int = 256,
                           process=None, device="cuda") -> list[bytes]:
    """Decode this process's share of `blobs` on `device`, then gather so
    that every process holds every output, in archive order.

    Only owned bytes move (see _gather_owned): the output sizes come from
    the stream headers, which every process holds, so no sizes are
    exchanged. With more than one process the group must be initialised
    (torch.distributed), with gloo or NCCL; an initialised group always
    exchanges, a one-rank group too, and one process without a group gets
    its local decode. For the flow where no bytes move see
    decode_archives_to_dir."""
    local = decode_archives(blobs, batch_pages, process, device)
    _, nproc = process if process is not None else process_info()
    if not _exchanges(nproc):
        return [local[i] for i in range(len(blobs))]
    sizes = [StreamHeader.unpack(b).uncompressed_size for b in blobs]
    return _gather_owned(local, sizes, nproc)


def encode_archives_gather(datas: Sequence[bytes], page_size: int = 65536,
                           process=None, quality: int = 11, device="cuda",
                           backend: str = "hybrid") -> list[bytes]:
    """Encode this process's share of `datas` (encode_archives), then
    gather so that every process holds every container, in input order:
    the multi-process analog of the reference's container assembly
    (BrotligEncoder.cpp:469-516).

    Compressed sizes are known to their owner only, so one all_gather of
    the [n] int64 sizes comes first; then the owned bytes move as in
    decode_archives_gather, and as there one process without a group
    gets its local encode."""
    import torch
    local = encode_archives(datas, page_size, process, quality, device,
                            backend)
    _, nproc = process if process is not None else process_info()
    n = len(datas)
    if not _exchanges(nproc):
        return [local[i] for i in range(n)]
    sz = torch.zeros(n, dtype=torch.int64)
    for i, b in local.items():
        sz[i] = len(b)
    sz_all = _all_gather(sz)
    return _gather_owned(local, [int(sz_all[i % nproc][i]) for i in range(n)],
                         nproc)
