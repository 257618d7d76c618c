"""Decode with the pages split over several devices (port of
brotlig_tpu/parallel/sharding.py).

Brotli-G pages are independent by design, so the split is pure data
parallelism over pages: each device decodes one contiguous share of a
batch or a stream, and the shares are gathered in page order on the host.
No device talks to another. The JAX package expresses this as one SPMD
program over a 'pages' mesh; here every share runs on its own device from
a host thread of its own (a ThreadPoolExecutor the size of the device
list), with that device current in the thread and its own CUDA streams.
The stager, the drains and the ctypes calls into the kernels release the
GIL or are host work, so the shares overlap.

A device list may name one device more than once: each entry is one
share, with its own streams, which is how the split is exercised on a
host with one card. An explicit list may hold "cpu" devices, where every
kernel wrapper runs its plain version.
"""
from __future__ import annotations

import contextlib
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import native
from ..format.headers import parse_container
from ..ops.decode import (_check_opts, compressed_jobs, decode_batch,
                          decode_batches, decode_pages, max_cmds_for,
                          resolve_device)
from ..ops.decode_kernel import stream_words_hint, wl_bucket
from ..ops.precondition import postprocess_device
from ..state import staged_from_numpy


def device_list(devices=None) -> list[torch.device]:
    """The devices to split over, each a torch.device with an index.

    None means every CUDA device torch sees; it raises RuntimeError when
    there is none. An explicit list may repeat a device (one share an
    entry) and may hold "cpu"; a CUDA entry that torch does not see raises
    RuntimeError."""
    if devices is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
            raise RuntimeError("no CUDA device to shard over")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    out = []
    for d in devices:
        dev = resolve_device(d)
        if dev.type == "cuda":
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            if dev.index >= torch.cuda.device_count():
                raise RuntimeError(f"{dev} requested but torch sees "
                                   f"{torch.cuda.device_count()} CUDA "
                                   "devices")
        out.append(dev)
    if not out:
        raise ValueError("empty device list")
    return out


def shard_bounds(n: int, n_devices: int) -> list[tuple[int, int]]:
    """Contiguous shares [lo, hi) of n rows over n_devices, in order; the
    first n % n_devices shares hold one row more than the rest.

    brotlig_tpu's pad_batch rounds the batch up to a multiple of the mesh,
    because one SPMD program needs equal shards, and fills the extra rows
    with a dummy page that every shard then decodes. Here each device runs
    its own launches at its own share's size, so there are no padding rows
    and no dummy page: a device whose share is empty gets no launch."""
    base, extra = divmod(n, n_devices)
    bounds, lo = [], 0
    for k in range(n_devices):
        hi = lo + base + (k < extra)
        bounds.append((lo, hi))
        lo = hi
    return bounds


def _on(dev: torch.device):
    """Context for a share's host thread: `dev` current, and a CUDA stream
    of the share's own current on it (nothing on the CPU)."""
    if dev.type != "cuda":
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    stack.enter_context(torch.cuda.device(dev))
    stack.enter_context(torch.cuda.stream(torch.cuda.Stream(dev)))
    return stack


def _run_shares(devs, n: int, fn) -> list:
    """fn(dev, lo, hi) for every non-empty share of n rows, each in a host
    thread of its own under _on(dev); returns the results in share order
    (None for an empty share). Once every share has ended, a failure of
    any is raised (the first in share order)."""
    def one(dev, lo, hi):
        if lo == hi:
            return None
        with _on(dev):
            res = fn(dev, lo, hi)
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()
            return res
    bounds = shard_bounds(n, len(devs))
    with ThreadPoolExecutor(len(devs)) as pool:
        futs = [pool.submit(one, dev, lo, hi)
                for dev, (lo, hi) in zip(devs, bounds)]
    return [f.result() for f in futs]


def _gather(parts, page_size: int):
    """Shares' (out, isdelta) on their devices -> (out [P, page_size]
    uint8, isdelta [P] bool) on the host, in row order."""
    parts = [p for p in parts if p is not None]
    if not parts:
        return (torch.zeros((0, page_size), dtype=torch.uint8),
                torch.zeros(0, dtype=torch.bool))
    return (torch.cat([o.cpu() for o, _ in parts]),
            torch.cat([d.cpu().to(torch.bool) for _, d in parts]))


def _host_words(words, in_sizes):
    return (np.ascontiguousarray(np.asarray(words), dtype=np.uint32),
            np.asarray(in_sizes, dtype=np.int64))


def decode_pages_sharded(words, in_sizes, page_size: int, devices=None):
    """Decode a batch of compressed pages split over `devices`
    (device_list) on the plain route, ops.decode.decode_pages, on each
    device's share: the twin of brotlig_tpu's decode_pages_sharded.

    words: uint32 [P, W] host array (page r's bytes first in row r);
    in_sizes: [P] compressed sizes. Returns (out [P, page_size] uint8,
    isdelta [P] bool) on the host, in row order; raises ValueError on a
    corrupt page."""
    words, in_sizes = _host_words(words, in_sizes)
    devs = device_list(devices)
    mc = max_cmds_for(page_size)

    def share(dev, lo, hi):
        w = torch.from_numpy(words[lo:hi].astype(np.int64)).to(dev)
        s = torch.from_numpy(in_sizes[lo:hi]).to(dev)
        return decode_pages(w, s, page_size, mc)
    return _gather(_run_shares(devs, len(words), share), page_size)


def decode_pages_sharded_kernel(words, in_sizes, page_size: int,
                                devices=None, sweep_cw: int = 1024):
    """decode_pages_sharded on the port's fused route: each device stages
    its share (native.stage_pages) and runs ops.decode.decode_batch's
    fused route on it: the tables kernel (tables_kernel.load_tables) and
    the fused decode kernel (decode_kernel.decode_fused), or their plain
    versions on a "cpu" entry. The counterpart of brotlig_tpu's
    decode_pages_sharded_pallas, which runs its fused Pallas kernel under
    shard_map. sweep_cw is
    validated as decode_stream does; the fused kernel executes each
    round's copies at once and does not read it. Same inputs and outputs
    as decode_pages_sharded."""
    _check_opts(None, sweep_cw)
    words, in_sizes = _host_words(words, in_sizes)
    devs = device_list(devices)
    raw = words.view(np.uint8).reshape(len(words), -1)

    def share(dev, lo, hi):
        comps = [raw[r, : in_sizes[r]].tobytes() for r in range(lo, hi)]
        sizes = np.asarray([len(c) for c in comps], np.uint64)
        offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(
            np.uint64)
        staged = staged_from_numpy(*native.stage_pages(
            b"".join(comps), offsets, sizes,
            wl_bucket(stream_words_hint(comps))), dev)
        out, _, status = decode_batch(staged, page_size, "fused", sweep_cw)
        if bool((status != 0).any()):
            raise ValueError("corrupt stream")
        return out, staged.npd[:, 2] != 0
    return _gather(_run_shares(devs, len(words), share), page_size)


def decode_stream_sharded(data: bytes, devices=None, variant=None,
                          sweep_cw: int = 1024,
                          batch_pages: int = 256) -> bytes:
    """Decode a Brotli-G container with its compressed pages split over
    `devices` (device_list: every CUDA device when None).

    The container is parsed once and its raw pages are copied on the
    host. Each device takes a contiguous share of the compressed pages
    and runs it through the stream pipeline (ops.decode.decode_batches:
    staging, the route `variant` and `sweep_cw` pick, as in decode_stream,
    and the readback) in a host thread of its own; every drain writes its
    pages into the one host output at their places. A preconditioned
    container is then delta decoded and deconditioned on the first device
    (ops.precondition.postprocess_device). A page that breaks a bound
    raises ValueError("corrupt stream"), and a failure in any share fails
    the call."""
    _check_opts(variant, sweep_cw)
    devs = device_list(devices)
    info = parse_container(data)
    header, dc = info.header, info.dc_params
    if header.num_pages == 0:
        return b""
    ps = header.page_size
    out = bytearray(info.out_size)
    out_np = np.frombuffer(out, np.uint8)
    for i in info.raw_page_indices():
        off, n = int(info.offsets[i]), info.page_out_sizes[i]
        out[i * ps: i * ps + n] = data[off: off + n]
    comp, offs, szs = compressed_jobs(info)
    delta_pages: set = set()
    lock = threading.Lock()

    def drain(keys, pages, isdelta):
        for row, i in enumerate(keys):
            n = info.page_out_sizes[i]
            out_np[i * ps: i * ps + n] = pages[row, :n]
        with lock:
            delta_pages.update(int(i) for i in keys[isdelta])

    def share(dev, lo, hi):
        decode_batches(data, comp[lo:hi], offs[lo:hi], szs[lo:hi], ps, dev,
                       drain, batch_pages, variant, sweep_cw)
    _run_shares(devs, len(comp), share)
    if dc is None:
        return bytes(out)
    return postprocess_device(bytes(out), dc, ps, devs[0], delta_pages)
