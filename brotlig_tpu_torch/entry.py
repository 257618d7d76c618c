"""Entry points of the port: one batched page-decode step, and a dry run of
the codec split over several devices (the counterpart of
__graft_entry__.py).

    python -m brotlig_tpu_torch.entry [N_DEVICES]

runs the step on the card and then dryrun_multichip(N_DEVICES), default
every CUDA device torch sees. Both raise without a CUDA device, or with
fewer devices than asked for; a caller who wants the CPU passes "cpu"
devices explicitly.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from . import native
from .api import encode
from .format import constants as C
from .format.precondition import DataConditionParams
from .ops.decode import decode_batch, max_cmds_for, resolve_device
from .ops.decode_kernel import stream_words_hint, wl_bucket
from .ops.encode import find_commands
from .parallel.sharding import (decode_pages_sharded,
                                decode_pages_sharded_kernel,
                                decode_stream_sharded, device_list,
                                shard_bounds)
from .state import Staged, staged_from_numpy

PAGE_SIZE = C.MIN_PAGE_SIZE     # the smallest legal page


def example_pages(num_pages: int) -> tuple[list[bytes], list[bytes]]:
    """num_pages pages of PAGE_SIZE bytes of words, each with its
    compressed page from the native encoder (its parse and page packer).
    Returns (pages, compressed pages)."""
    words = [b"graft ", b"entry ", b"pages ", b"cuda ", b"decode "]
    pages, comps = [], []
    for i in range(num_pages):
        r = np.random.default_rng(i)
        buf = bytearray()
        while len(buf) < PAGE_SIZE:
            buf += words[int(r.integers(0, len(words)))]
        page = bytes(buf[:PAGE_SIZE])
        ins, cpy, dist, _ = native.parse_page(page)
        pages.append(page)
        comps.append(native.encode_page_cmds(page, True, ins, cpy, dist))
    return pages, comps


def example_words(comps) -> tuple[np.ndarray, np.ndarray]:
    """Compressed pages -> (words uint32 [P, W], sizes [P]): page r's bytes
    first in row r, as the sharded page decoders take them."""
    W = PAGE_SIZE // 4 + 2
    arr = np.zeros((len(comps), W * 4), dtype=np.uint8)
    for i, c in enumerate(comps):
        arr[i, : len(c)] = np.frombuffer(c, dtype=np.uint8)
    return (arr.view(np.uint32).reshape(len(comps), W),
            np.asarray([len(c) for c in comps], np.int64))


def entry(device="cuda"):
    """Returns (fn, example_args): fn(buf3, npd) decodes a staged batch of
    PAGE_SIZE pages (state.Staged's fields) and returns its pages, uint8
    [P, PAGE_SIZE]: on a card through the tables kernel and the fused
    decode kernel, on the CPU through their plain versions. The example is
    two pages staged on `device`; "cuda" raises without a CUDA device."""
    dev = resolve_device(device)
    _, comps = example_pages(2)
    sizes = np.asarray([len(c) for c in comps], np.uint64)
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.uint64)
    staged = staged_from_numpy(*native.stage_pages(
        b"".join(comps), offsets, sizes,
        wl_bucket(stream_words_hint(comps))), dev)

    def forward(buf3, npd):
        return decode_batch(Staged(buf3, npd), PAGE_SIZE)[0]
    return forward, (staged.buf, staged.npd)


def bc1_container(page_size: int, n_pages: int, device):
    """A preconditioned BC1 texture (swizzle and delta) of n_pages pages,
    the last one half full, with two pages' worth of noise blocks in it,
    so that the container holds a raw page beside delta-coded ones (at 4
    pages of 64 KiB and at 6 of 32 KiB, among others); encoded by the
    port's full-device encoder at q1 on `device`. Returns (texture,
    container)."""
    rng = np.random.default_rng(3)
    nblocks = (n_pages * page_size - page_size // 2) // 8
    wblocks = 64
    hblocks = nblocks // wblocks
    nblocks = wblocks * hblocks
    blocks = np.zeros((nblocks, 8), np.uint8)
    c0 = (rng.integers(0, 32, nblocks) * 2048
          + np.arange(nblocks) % 997).astype("<u2")
    blocks[:, 0:2] = c0.view(np.uint8).reshape(-1, 2)
    blocks[:, 2:4] = (c0 // 2).astype("<u2").view(np.uint8).reshape(-1, 2)
    blocks[:, 4:8] = (rng.integers(0, 4, (nblocks, 4)) * 0x55
                      ).astype(np.uint8)
    # two pages' worth of noise blocks an eighth of the way in: a raw page
    raw0 = nblocks // 8
    blocks[raw0: raw0 + page_size // 4] = rng.integers(
        0, 256, (page_size // 4, 8), dtype=np.uint8)
    tex = blocks.tobytes()
    params = DataConditionParams(
        precondition=True, swizzle=True, delta_encode=True,
        format=C.DATA_FORMAT_BC1, width_in_pixels=wblocks * 4,
        height_in_pixels=hblocks * 4, num_mip_levels=1)
    return tex, encode(tex, page_size=page_size, dc_params=params,
                       backend="full", quality=1, device=device)


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """Run the codec split over n_devices devices (the first n_devices of
    sharding.device_list(devices): every CUDA device when None), one step
    of each route:

    1. decode_stream_sharded of a 64 KiB-page preconditioned BC1 container
       whose raw pages and short last page fall across the shares' edges;
    2. decode_pages_sharded_kernel (the tables and fused decode kernels on
       each share) against decode_pages_sharded (the plain route), byte
       for byte, one page a device, and the first page against the native
       decoder;
    3. ops/encode.find_commands on each device's share of those pages,
       every command's copy checked against the page.

    Raises when fewer devices exist than are asked for, and on any
    mismatch."""
    devs = device_list(devices)
    if len(devs) < n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}): only "
                           f"{len(devs)} devices")
    devs = devs[:n_devices]

    tex, blob = bc1_container(64 * 1024, max(n_devices, 4), devs[0])
    if decode_stream_sharded(blob, devs) != tex:
        raise AssertionError("sharded BC1 stream decode differs")
    print(f"dryrun_multichip({n_devices}): 64 KiB-page BC1 container "
          f"(precondition and delta, raw and short last pages) decoded "
          f"over {[str(d) for d in devs]} by decode_stream_sharded",
          flush=True)

    pages, comps = example_pages(n_devices)
    words, sizes = example_words(comps)
    out_p, isd_p = decode_pages_sharded(words, sizes, PAGE_SIZE, devs)
    out_k, isd_k = decode_pages_sharded_kernel(words, sizes, PAGE_SIZE,
                                               devs)
    if not (torch.equal(out_k, out_p) and torch.equal(isd_k, isd_p)):
        raise AssertionError("the kernel route over the shares differs "
                             "from the plain route")
    if out_p[0].numpy().tobytes() != native.decode_page(comps[0],
                                                        PAGE_SIZE):
        raise AssertionError("sharded decode differs from the native "
                             "decoder")
    print(f"dryrun_multichip({n_devices}): the tables and fused decode "
          f"kernels over {n_devices} shares == the plain route", flush=True)

    mc = max_cmds_for(PAGE_SIZE)
    arr = np.frombuffer(b"".join(pages), np.uint8).reshape(n_devices, -1)
    for dev, (lo, hi) in zip(devs, shard_bounds(n_devices, n_devices)):
        p = torch.from_numpy(arr[lo:hi].copy()).to(dev)
        ins, cpy, dist, ncmds = (x.cpu().numpy() for x in find_commands(
            p, torch.full((hi - lo,), PAGE_SIZE, device=dev), mc, True))
        for row in range(hi - lo):
            k = int(ncmds[row])
            ends = np.cumsum(ins[row, :k] + cpy[row, :k])
            if k == 0 or ends[-1] > PAGE_SIZE:
                raise AssertionError(f"encode step on {dev}: bad coverage")
            page = arr[lo + row]
            for s0, L, d in zip(ends - cpy[row, :k], cpy[row, :k],
                                dist[row, :k]):
                src = s0 - d + np.arange(L) % d
                if not np.array_equal(page[s0: s0 + L], page[src]):
                    raise AssertionError(f"encode step on {dev}: a copy "
                                         "differs from its source")
    print(f"dryrun_multichip({n_devices}): encode step (find_commands) on "
          "each device's share, every copy == its source", flush=True)


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    print("entry forward:", tuple(out.shape), out.dtype, flush=True)
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1
                     else len(device_list()))
