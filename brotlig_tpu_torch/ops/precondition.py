"""BCn post-processing on a torch device: per-page delta decode and
decondition, and the encode side's condition and delta encode (port of
brotlig_tpu/ops/precondition.py, whose jitted region has no Pallas
kernel).

The reference deconditions with a per-byte address transform inside the
page loop (PageDecoder.cpp:243-265, BrotliGCompute.hlsl:978-1031) and
delta-decodes with a serial prefix loop (:467-471). The entry points here,
postprocess_flat_device, postprocess_device and preprocess_device, do the
same with closed-form addresses (ops/precondition_kernel.py): the
hand-written kernels of csrc/precondition.cu on a CUDA tensor, their plain
int64 torch versions on a CPU tensor. No map plane is built.

The JAX package's form stays below as the PyTorch yardstick that
chip_smoke.py times beside the kernels, and no entry point reaches it:
map planes built once per (device, geometry, size, page split) and kept on
that device, then

* delta decode: one global cumsum, from which each span subtracts the sum
  before its start. The arithmetic is uint8 throughout: the sums wrap
  modulo 256, which is the result the format wants (the JAX module sums
  in int32 and masks with & 255), and a temporary costs one byte a byte;
* decondition: one gather through the inverse of the shared condition
  index map (format/precondition.py::build_cond_map), with int32 indices.
"""
from __future__ import annotations

import numpy as np
import torch

from ..format.precondition import (DataConditionParams, _color_intersections,
                                   build_cond_map)
from . import precondition_kernel as PK

U8 = torch.uint8

# Map planes on their device, keyed by the device and the derived geometry.
# A stream of same-shape textures builds and uploads its maps once. The key
# holds the device because one process decodes on the CPU and on the card.
_MAP_CACHE: dict = {}
_MAP_CACHE_MAX = 16


def _geom_key(params: DataConditionParams):
    # key on the DERIVED geometry the map build actually consumes
    # (build_cond_map reads block dims + per-mip pitches, which
    # parse_container backfills directly; keying on the pixel fields
    # alone could alias two containers onto one cached map)
    return (params.format, params.num_mip_levels,
            tuple(params.width_in_blocks[: params.num_mip_levels]),
            tuple(params.height_in_blocks[: params.num_mip_levels]),
            tuple(params.pitch_in_bytes[: params.num_mip_levels]),
            params.pitch_d3d12_aligned, params.swizzle, params.delta_encode)


def _cached(key, build):
    hit = _MAP_CACHE.get(key)
    if hit is None:
        if len(_MAP_CACHE) >= _MAP_CACHE_MAX:
            _MAP_CACHE.pop(next(iter(_MAP_CACHE)))
        hit = _MAP_CACHE[key] = build()
    return hit


def _device(device) -> torch.device:
    """`device` as a torch.device with its index, so that "cuda" and
    "cuda:0" share cache entries."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _on(device, *arrays):
    return tuple(torch.from_numpy(a).to(device) for a in arrays)


def _from_bytes(data: bytes, device):
    return torch.from_numpy(np.frombuffer(data, np.uint8).copy()).to(device)


def _inv_maps(params: DataConditionParams, n: int, device):
    """(inverse index int32 [n], valid bool [n]) on `device` for
    deconditioning n bytes."""
    device = _device(device)

    def build():
        cond_map = build_cond_map(params)
        inv = np.zeros(n, dtype=np.int32)
        inv[cond_map] = np.arange(len(cond_map), dtype=np.int32)
        valid = np.zeros(n, dtype=bool)
        valid[cond_map] = True
        return _on(device, inv, valid)
    return _cached(("inv", str(device), _geom_key(params), n), build)


def _fwd_maps(params: DataConditionParams, n: int, device):
    """(forward index int32 [n], valid bool [n]) on `device` for
    conditioning n bytes."""
    device = _device(device)

    def build():
        cond_map = build_cond_map(params)
        m = len(cond_map)
        idx = np.zeros(n, dtype=np.int32)
        idx[:m] = cond_map
        valid = np.zeros(n, dtype=bool)
        valid[:m] = True
        return _on(device, idx, valid)
    return _cached(("fwd", str(device), _geom_key(params), n), build)


def _delta_masks(params: DataConditionParams, n: int, page_size: int,
                 device, flagged=None):
    """The delta spans on `device`: (starts int64 [K], each span's first
    byte in order; in_span bool [n]), plus the per-page isdelta flags; or
    None when there is no span. `flagged` restricts the spans to those
    page indices: None means every page, an empty set no page."""
    device = _device(device)
    fkey = None if flagged is None else tuple(sorted(flagged))

    def build():
        spans = [
            (s, e) for (s, e) in delta_spans(params, n, page_size)
            if flagged is None or (s // page_size) in flagged
        ]
        if not spans:
            return None
        num_pages = (n + page_size - 1) // page_size
        isdelta = [False] * num_pages
        starts = np.zeros(len(spans), dtype=np.int64)
        cover = np.zeros(n + 1, dtype=np.int32)
        for k, (s, e) in enumerate(spans):
            starts[k] = s
            cover[s] += 1
            cover[e] -= 1
            isdelta[s // page_size] = True
        in_span = np.cumsum(cover[:-1]) > 0
        return (*_on(device, starts, in_span), isdelta)
    return _cached(("delta", str(device), _geom_key(params), n, page_size,
                    fkey), build)


def _delta_decode_device(data_u8, starts, in_span):
    """Per-span prefix sums modulo 256; bytes outside the spans pass.

    c is the running sum of every byte; span k's bytes want c minus c at
    the byte before its start s_k. That value, cb_k, is spread over the
    bytes by a second cumsum of its differences placed at the starts
    (which also makes adjacent spans need no end marks)."""
    c = torch.cumsum(data_u8, 0, dtype=U8)
    cb = torch.where(starts > 0, c[(starts - 1).clamp_(min=0)],
                     torch.zeros((), dtype=U8, device=c.device))
    steps = torch.zeros_like(c)
    steps[starts] = cb - torch.cat([cb.new_zeros(1), cb[:-1]])
    decoded = c.sub_(torch.cumsum(steps, 0, dtype=U8))
    return torch.where(in_span, decoded, data_u8)


def _gather_u8(data_u8, idx, valid):
    out = data_u8.index_select(0, idx)
    return out.masked_fill_(~valid, 0)


def _delta_encode_device(data_u8, starts, in_span):
    """Inverse of _delta_decode_device: per-span byte differences, each
    span's first byte kept (ref PageEncoder.cpp:576-612 walks each color
    span serially)."""
    d = data_u8.clone()
    d[1:] -= data_u8[:-1]
    out = torch.where(in_span, d, data_u8)
    out[starts] = data_u8[starts]
    return out


def preprocess_device(data: bytes, params: DataConditionParams,
                      page_size: int, device):
    """Condition and per-page delta encode on `device`: the kernel on a
    card, its plain version on the CPU.

    The encode-side mirror of postprocess_device. Returns (conditioned
    bytes, delta-encoded bytes, per-page isdelta flags): a page is flagged
    when delta_encode is set and a delta span lies in it. Pages feed the
    encoder from the delta form, but a raw-page fallback must store the
    conditioned NON-delta bytes (the decoder only delta-decodes
    compressed pages, ref PageDecoder.cpp:70-76)."""
    n = len(data)
    x = _from_bytes(data, device)
    geom = PK.pack_geometry(params, n, page_size)
    isdelta = PK.span_pages(geom) & bool(params.delta_encode)
    flags = torch.from_numpy(isdelta.astype(np.uint8))
    if x.device.type == "cpu":
        cond, delta = PK.preprocess_plain(x, geom, flags)
    else:
        cond, delta = PK.preprocess_cuda(x, geom, flags)
    return (cond.cpu().numpy().tobytes(), delta.cpu().numpy().tobytes(),
            isdelta.tolist())


def delta_spans(params: DataConditionParams, total: int, page_size: int):
    """Absolute (start, end) delta spans: color-substream x page overlaps."""
    spans = []
    for pstart in range(0, total, page_size):
        pend = min(pstart + page_size, total)
        for s, e in _color_intersections(pstart, pend, params):
            spans.append((pstart + s, pstart + e))
    return spans


def postprocess_device(conditioned: bytes, params: DataConditionParams,
                       page_size: int, device, isdelta_pages=None) -> bytes:
    """Delta-decode (where flagged) and decondition on `device`; bytes in,
    bytes out.

    isdelta_pages: optional set of page indices whose pages were
    delta-encoded (None = all pages, matching encoders that always
    delta)."""
    x = _from_bytes(conditioned, device)
    out = postprocess_flat_device(x, params, page_size, isdelta_pages)
    return out.cpu().numpy().tobytes()


def postprocess_flat_device(x, params: DataConditionParams,
                            page_size: int, isdelta_pages=None):
    """Delta decode and decondition of a flat uint8 tensor on its own
    device, with closed-form addresses: the kernel on a card, its plain
    version on the CPU; returns a tensor on that device (no host
    roundtrip: the analog of the reference writing BCn bytes straight
    from its decode kernel, BrotliGCompute.hlsl:978-1031)."""
    n = int(x.shape[0])
    geom = PK.pack_geometry(params, n, page_size)
    flags = PK.page_flags(isdelta_pages, -(-n // page_size))
    if x.device.type == "cpu":
        return PK.postprocess_plain(x, geom, flags)
    return PK.postprocess_cuda(x, geom, flags)
