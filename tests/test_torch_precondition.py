"""The port's BCn preconditioning against the JAX package on the CPU: the
numpy geometry and coding of format/precondition.py, the device
post-processing of ops/precondition.py, and decode of preconditioned
containers. Exact equality: the format fixes every byte.

The references are the JAX package's numpy functions and its pure-Python
codec (brotlig_tpu.refimpl.codec); one test calls the jitted JAX
post-processing, at one small size.
"""
import numpy as np
import pytest
import torch

from brotlig_tpu.format import constants as C
from brotlig_tpu.format import precondition as JP
from brotlig_tpu.format.headers import parse_container
from brotlig_tpu.refimpl.codec import decode as ref_decode
from brotlig_tpu.refimpl.codec import encode as ref_encode

import brotlig_tpu_torch
from brotlig_tpu_torch.format import precondition as TP
from brotlig_tpu_torch.ops import precondition as TO
from test_torch_two_phase import torch_one_thread  # noqa: F401 (autouse)

FORMATS = (C.DATA_FORMAT_BC1, C.DATA_FORMAT_BC2, C.DATA_FORMAT_BC3,
           C.DATA_FORMAT_BC4, C.DATA_FORMAT_BC5)
PS = C.MIN_PAGE_SIZE


def params_pair(fmt, w_px, h_px, mips=1, swizzle=False, delta=False,
                pitch_aligned=False, size=None):
    """The same parameters as a JAX-package and a port object, both
    initialised for `size` bytes (the texture's own size by default)."""
    kw = dict(precondition=True, swizzle=swizzle, delta_encode=delta,
              format=fmt, width_in_pixels=w_px, height_in_pixels=h_px,
              num_mip_levels=mips, pitch_d3d12_aligned=pitch_aligned)
    pair = JP.DataConditionParams(**kw), TP.DataConditionParams(**kw)
    if size is None:
        size = texture_size(fmt, w_px, h_px, mips, pitch_aligned)
    assert pair[0].initialize(size) and pair[1].initialize(size)
    return pair


def texture_size(fmt, w_px, h_px, mips=1, pitch_aligned=False):
    p = JP.DataConditionParams(
        precondition=True, format=fmt, width_in_pixels=w_px,
        height_in_pixels=h_px, num_mip_levels=mips,
        pitch_d3d12_aligned=pitch_aligned)
    p.initialize(-1)            # fills the geometry; the size check fails
    return p.mip_offsets_bytes[p.num_mip_levels]


def texture(size, seed=0, random=False):
    """Texture bytes from a numpy seed: structured enough to compress, or
    random (every page stored raw)."""
    rng = np.random.default_rng(seed)
    if random:
        return rng.integers(0, 256, size=size, dtype=np.uint8).tobytes()
    base = rng.integers(0, 8, size=size).astype(np.int64)
    grad = (np.arange(size, dtype=np.int64) // 64) % 32
    return (base + grad).astype(np.uint8).tobytes()


def assert_format_functions_equal(jp, tp, size, page_size, seed=0):
    """Geometry, cond map, condition/decondition, per-page delta coding
    and the delta spans of the port equal the JAX package's."""
    for f in ("block_size_bytes", "sub_block_sizes", "sub_block_offsets",
              "color_sub_blocks", "width_in_blocks", "height_in_blocks",
              "pitch_in_bytes", "num_blocks", "sub_stream_offsets",
              "mip_offsets_bytes", "mip_offset_blocks", "t_num_blocks"):
        assert getattr(tp, f) == getattr(jp, f), f
    cond_map = TP.build_cond_map(tp)
    np.testing.assert_array_equal(cond_map, JP.build_cond_map(jp))
    data = texture(size, seed, random=True)
    cond = TP.condition(data, tp)
    assert cond == JP.condition(data, jp)
    back = TP.decondition(cond, tp)
    assert back == JP.decondition(cond, jp)
    # the texture's bytes come back; pitch padding comes back as zeros
    want = np.zeros(size, np.uint8)
    want[cond_map] = np.frombuffer(data, np.uint8)[cond_map]
    assert back == want.tobytes()
    for start in range(0, size, page_size):
        page = cond[start: start + page_size]
        enc = TP.delta_encode_page(page, start, tp)
        assert enc == JP.delta_encode_page(page, start, jp)
        assert TP.delta_decode_page(enc[0], start, tp) == \
            JP.delta_decode_page(enc[0], start, jp) == page
    from brotlig_tpu.ops.precondition import delta_spans
    assert TO.delta_spans(tp, size, page_size) == \
        delta_spans(jp, size, page_size)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("swizzle", [False, True])
def test_format_functions_equal_jax(fmt, swizzle):
    jp, tp = params_pair(fmt, 64, 48, mips=2, swizzle=swizzle, delta=True)
    size = texture_size(fmt, 64, 48, mips=2)
    assert_format_functions_equal(jp, tp, size, 1024, seed=fmt)


@pytest.mark.parametrize("fmt,w,h,mips", [
    (C.DATA_FORMAT_BC1, 64, 32, 2), (C.DATA_FORMAT_BC3, 64, 64, 3),
    (C.DATA_FORMAT_BC5, 40, 24, 2)])
def test_mips_and_d3d12_pitch_equal_jax(fmt, w, h, mips):
    jp, tp = params_pair(fmt, w, h, mips=mips, swizzle=True, delta=True,
                         pitch_aligned=True)
    size = texture_size(fmt, w, h, mips, pitch_aligned=True)
    assert len(TP.build_cond_map(tp)) < size     # pitch padding present
    assert_format_functions_equal(jp, tp, size, 2048, seed=w)


def test_size_mismatch_and_limits_as_jax():
    for mod in (JP, TP):
        p = mod.DataConditionParams(precondition=True,
                                    format=C.DATA_FORMAT_BC1,
                                    width_in_pixels=64, height_in_pixels=64)
        assert not p.initialize(12345)
    wide = dict(precondition=True, format=C.DATA_FORMAT_BC1,
                width_in_pixels=4 * C.PRECON_MAX_TEX_WIDTH_BLOCK + 4,
                height_in_pixels=64)
    with pytest.raises(ValueError, match="too wide") as want:
        JP.DataConditionParams(**wide).check()
    with pytest.raises(ValueError, match="too wide") as got:
        TP.DataConditionParams(**wide).check()
    assert str(got.value) == str(want.value)


def test_postprocess_and_preprocess_equal_jax():
    """The port's device functions on the CPU against the jitted JAX
    ones, on one texture of one 32 KiB page and a partial second page:
    every page flagged (None), no page (an empty set), and the first
    only."""
    from brotlig_tpu.ops import precondition as JO
    fmt = C.DATA_FORMAT_BC5
    jp, tp = params_pair(fmt, 256, 160, swizzle=True, delta=True)
    data = texture(texture_size(fmt, 256, 160), seed=3)
    assert PS < len(data) < 2 * PS
    want = JO.preprocess_device(data, jp, PS)
    got = TO.preprocess_device(data, tp, PS, "cpu")
    assert got[:2] == want[:2] and list(got[2]) == list(want[2])
    for flagged in (None, set(), {0}):
        assert TO.postprocess_device(want[1], tp, PS, "cpu", flagged) == \
            JO.postprocess_device(want[1], jp, PS, flagged)
    assert TO.postprocess_device(want[1], tp, PS, "cpu") == data
    assert TO.postprocess_device(want[0], tp, PS, "cpu", set()) == data


def test_map_cache_keys_on_the_device(monkeypatch):
    """One geometry used on two devices in one process gets maps on each
    device; the cache keeps its 16-entry bound."""
    monkeypatch.setattr(TO, "_MAP_CACHE", {})
    _, tp = params_pair(C.DATA_FORMAT_BC1, 64, 64, swizzle=True, delta=True)
    n = texture_size(C.DATA_FORMAT_BC1, 64, 64)
    for dev in ("cpu", "meta", "cpu"):
        inv, valid = TO._inv_maps(tp, n, dev)
        starts, in_span, _ = TO._delta_masks(tp, n, PS, dev)
        assert {t.device.type for t in (inv, valid, starts, in_span)} == \
            {dev}
    assert len(TO._MAP_CACHE) == 4
    assert TO._delta_masks(tp, n, PS, "cpu", set()) is None
    for w in range(8, 8 + 4 * 20, 4):
        _, p = params_pair(C.DATA_FORMAT_BC4, w, 8)
        TO._inv_maps(p, texture_size(C.DATA_FORMAT_BC4, w, 8), "cpu")
        assert len(TO._MAP_CACHE) <= TO._MAP_CACHE_MAX


def encode_texture(fmt, w, h, mips, swizzle, delta, random=False, seed=0):
    jp, _ = params_pair(fmt, w, h, mips=mips, swizzle=swizzle, delta=delta)
    data = texture(texture_size(fmt, w, h, mips), seed, random)
    return data, ref_encode(data, page_size=PS, dc_params=jp)


@pytest.mark.parametrize("fmt", [C.DATA_FORMAT_BC1, C.DATA_FORMAT_BC5])
@pytest.mark.parametrize("swizzle,delta", [(False, False), (True, True)])
def test_decode_preconditioned_cpu(fmt, swizzle, delta):
    data, blob = encode_texture(fmt, 128, 128, 2, swizzle, delta)
    assert parse_container(blob).dc_params is not None
    got = brotlig_tpu_torch.decode(blob, device="cpu")
    assert got == data == ref_decode(blob)


def test_decode_preconditioned_raw_pages_cpu():
    """A random BC3 texture stores raw pages, which hold the conditioned
    non-delta bytes: they are never delta-decoded."""
    data, blob = encode_texture(C.DATA_FORMAT_BC3, 128, 128, 1, True, True,
                                random=True)
    info = parse_container(blob)
    assert info.raw_page_indices() and not info.compressed_page_indices()
    assert brotlig_tpu_torch.decode(blob, device="cpu") == data \
        == ref_decode(blob)


def test_decode_preconditioned_over_batches_cpu():
    """Three pages (the last one short) in batches of two, through the
    device plane, returned on the device."""
    from brotlig_tpu_torch.ops.decode import decode_stream
    data, blob = encode_texture(C.DATA_FORMAT_BC1, 512, 272, 1, True, True,
                                seed=5)
    assert len(parse_container(blob).compressed_page_indices()) == 3
    res = decode_stream(blob, "cpu", batch_pages=2, return_device=True)
    assert isinstance(res, torch.Tensor) and res.dtype == torch.uint8
    assert res.numpy().tobytes() == data == ref_decode(blob)
