"""The texture postprocess and preprocess with closed-form addresses
(ops/precondition_kernel.py, csrc/precondition.cu).

On the CPU, the plain versions against the JAX package's numpy functions
(build_cond_map, condition, decondition, delta_encode_page,
delta_decode_page), which compile no JAX executable, on geometries that
cover BC1-BC5, swizzle on and off, widths and heights in blocks that are
odd or below 2, 4 mips and a full chain down to 1 x 1, D3D12-aligned
pitches with padding and an odd row pitch, a mip wider than a tile,
32, 64 and 128 KiB pages, pages that cut a colour segment inside a tile,
a partial last page, a texture smaller than a page and every page, no
page or some pages flagged; one case against the jitted JAX entry
points. The kernels' tile cut (tile_plan, at the kernels' tile size and
at 1 KiB, which makes every wide-mip case occur) partitions each
sub-stream and the texture, and the addresses it composes equal
build_cond_map's; the look-back's carries (lookback_carries) equal the
prefix sums postprocess_plain takes over span_starts. Tolerance 0: the
format fixes every byte. The file compiles no JAX executable but in
test_entry_points_equal_jitted_jax (~12 s cold in one process, the JAX
import included).

On a card (marker `cuda`, skipped without one), each kernel against its
plain version on the same cases, with its outputs poisoned beforehand so
that every byte no conditioned byte covers must be written as 0; decode
through the kernels with no map plane cached; and the launch counts on
the decode, pool and encode paths. Run there with

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_precondition_kernel.py

(this module imports JAX only inside the one test that compares with it).
"""
import numpy as np
import pytest
import torch

from brotlig_tpu.format import constants as C
from brotlig_tpu.format import precondition as JP

from brotlig_tpu_torch import _kernels
from brotlig_tpu_torch.format import precondition as TP
from brotlig_tpu_torch.ops import precondition as TO
from brotlig_tpu_torch.ops import precondition_kernel as PK
from test_torch_two_phase import torch_one_thread  # noqa: F401 (autouse)

KIB = 1024
# name: (format, width and height in pixels, mips, swizzle, D3D12-aligned
# pitch, delta encode, page size[, row pitch in bytes])
GEOMETRIES = {
    "bc1 64x72 blocks, swizzle, 32 KiB pages, partial last":
        (C.DATA_FORMAT_BC1, 256, 288, 1, True, False, True, 32 * KIB),
    "bc1 65x67 blocks (odd), no swizzle, 32 KiB":
        (C.DATA_FORMAT_BC1, 260, 268, 1, False, False, True, 32 * KIB),
    "bc1 67x129 blocks, 4 mips, aligned pitch, swizzle, 64 KiB":
        (C.DATA_FORMAT_BC1, 268, 516, 4, True, True, True, 64 * KIB),
    "bc1 1x5 blocks, 4 mips, swizzle (width below 2)":
        (C.DATA_FORMAT_BC1, 4, 20, 4, True, False, True, 32 * KIB),
    "bc2 33x37 blocks, swizzle, smaller than a 64 KiB page":
        (C.DATA_FORMAT_BC2, 132, 148, 1, True, False, True, 64 * KIB),
    "bc2 48x40 blocks, 4 mips, aligned pitch, no delta, 32 KiB":
        (C.DATA_FORMAT_BC2, 192, 160, 4, False, True, False, 32 * KIB),
    "bc3 64x68 blocks, 4 mips, swizzle, 64 KiB":
        (C.DATA_FORMAT_BC3, 256, 272, 4, True, False, True, 64 * KIB),
    "bc3 9x1 blocks, swizzle (height below 2)":
        (C.DATA_FORMAT_BC3, 36, 4, 1, True, False, True, 32 * KIB),
    "bc4 90x100 blocks, 3 mips, aligned pitch, swizzle, 32 KiB":
        (C.DATA_FORMAT_BC4, 360, 400, 3, True, True, True, 32 * KIB),
    "bc5 96x88 blocks, swizzle, 128 KiB, partial last":
        (C.DATA_FORMAT_BC5, 384, 352, 1, True, False, True, 128 * KIB),
    "bc5 1x1 block, swizzle":
        (C.DATA_FORMAT_BC5, 4, 4, 1, True, False, True, 32 * KIB),
    # wider than a tile (2 pitches > 16 KiB), odd width, odd row pitch
    "bc1 1031x7 blocks, swizzle, row pitch 8249, 32 KiB":
        (C.DATA_FORMAT_BC1, 4124, 28, 1, True, False, True, 32 * KIB, 8249),
    "bc1 64x64 blocks, 9 mips down to 1x1, swizzle, 32 KiB":
        (C.DATA_FORMAT_BC1, 256, 256, 9, True, False, True, 32 * KIB),
    "bc5 200x130 blocks, aligned pitch, swizzle, 128 KiB":
        (C.DATA_FORMAT_BC5, 800, 520, 1, True, True, True, 128 * KIB),
    # tiles of 20 rows (4000 colour bytes): 32 KiB pages cut them inside
    "bc1 100x180 blocks, pages cut colour segments mid-tile, 32 KiB":
        (C.DATA_FORMAT_BC1, 400, 720, 1, True, False, True, 32 * KIB),
}
FLAGS = ("every page", "no page", "some pages")


def geometry(name):
    """(JAX-package params, port params, texture size, page size) of a
    case, both initialised."""
    fmt, w, h, mips, swz, aligned, delta, page, *pitch = GEOMETRIES[name]
    kw = dict(precondition=True, swizzle=swz, delta_encode=delta,
              format=fmt, width_in_pixels=w, height_in_pixels=h,
              num_mip_levels=mips, pitch_d3d12_aligned=aligned,
              row_pitch_in_bytes=pitch[0] if pitch else 0)
    probe = JP.DataConditionParams(**kw)
    probe.initialize(-1)            # fills the geometry; the size check fails
    size = probe.mip_offsets_bytes[probe.num_mip_levels]
    jp, tp = JP.DataConditionParams(**kw), TP.DataConditionParams(**kw)
    assert jp.initialize(size) and tp.initialize(size)
    return jp, tp, size, page


def flagged_pages(mode, pages):
    """None (every page), an empty set, or every other page."""
    return {"every page": None, "no page": set(),
            "some pages": set(range(0, pages, 2)) if pages > 1 else set()
            }[mode]


def random_bytes(n, seed):
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


def jax_postprocess(cond: bytes, jp, page, flagged) -> bytes:
    pages = []
    for i, p0 in enumerate(range(0, len(cond), page)):
        chunk = cond[p0: p0 + page]
        if flagged is None or i in flagged:
            chunk = JP.delta_decode_page(chunk, p0, jp)
        pages.append(chunk)
    return JP.decondition(b"".join(pages), jp)


def jax_preprocess(data: bytes, jp, page):
    cond = JP.condition(data, jp)
    delta, flags = [], []
    for p0 in range(0, len(cond), page):
        chunk = cond[p0: p0 + page]
        if jp.delta_encode:
            chunk, was = JP.delta_encode_page(chunk, p0, jp)
        else:
            was = False
        delta.append(chunk)
        flags.append(was)
    return cond, b"".join(delta), flags


def case_inputs(name, mode):
    """(port params, geometry record, conditioned stream, flags, the JAX
    package's postprocess of it)."""
    jp, tp, size, page = geometry(name)
    cond = random_bytes(size, seed=len(name))
    pages = -(-size // page)
    flagged = flagged_pages(mode, pages)
    geom = PK.pack_geometry(tp, size, page)
    return (tp, geom, cond, PK.page_flags(flagged, pages),
            jax_postprocess(cond, jp, page, flagged))


def as_tensor(data: bytes, dev="cpu"):
    return torch.from_numpy(np.frombuffer(data, np.uint8).copy()).to(dev)


# ---------------------------------------------------------------------------
# The plain versions on the CPU, against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", FLAGS)
@pytest.mark.parametrize("name", GEOMETRIES)
def test_postprocess_plain_equals_jax(name, mode):
    _, geom, cond, flags, want = case_inputs(name, mode)
    got = PK.postprocess_plain(as_tensor(cond), geom, flags)
    assert got.dtype == torch.uint8 and got.numpy().tobytes() == want


@pytest.mark.parametrize("name", GEOMETRIES)
def test_preprocess_plain_equals_jax(name):
    """The conditioned bytes, the delta bytes and the flags the entry point
    derives, with the addresses equal to build_cond_map's; the
    postprocess of the delta bytes gives the texture back, its pitch
    padding as 0."""
    jp, tp, size, page = geometry(name)
    data = random_bytes(size, seed=len(name) + 1)
    want_cond, want_delta, want_flags = jax_preprocess(data, jp, page)
    geom = PK.pack_geometry(tp, size, page)
    np.testing.assert_array_equal(PK.cond_addresses(geom).numpy(),
                                  JP.build_cond_map(jp))
    flags = PK.span_pages(geom) & bool(tp.delta_encode)
    assert flags.tolist() == want_flags
    cond, delta = PK.preprocess_plain(as_tensor(data), geom,
                                      torch.from_numpy(flags.astype(np.uint8)))
    assert cond.numpy().tobytes() == want_cond
    assert delta.numpy().tobytes() == want_delta
    assert TO.preprocess_device(data, tp, page, "cpu") == \
        (want_cond, want_delta, want_flags)
    back = TO.postprocess_device(want_delta, tp, page, "cpu",
                                 set(np.flatnonzero(flags).tolist()))
    assert back == JP.decondition(want_cond, jp)


@pytest.mark.parametrize("tile_bytes", (PK.TILE_BYTES, 1024))
@pytest.mark.parametrize("name", GEOMETRIES)
def test_tile_plan_partitions_and_composes_the_map(name, tile_bytes):
    """The tiles' conditioned blocks follow one another from 0 to the last,
    so each sub-stream's segments partition it once; every block lies in
    its tile's pieces once, and the texture addresses they compose are
    cond_addresses, which are build_cond_map's; the pieces' byte ranges,
    padding included, cover the texture once."""
    jp, tp, size, page = geometry(name)
    geom = PK.pack_geometry(tp, size, page)
    g = geom.tolist()
    plan = PK.tile_plan(geom, tile_bytes)
    b0, b1 = plan["b0"], plan["b1"]
    assert b0[0] == 0 and b1[-1] == g[PK.G_TBLOCKS]
    assert torch.equal(b0[1:], b1[:-1]) and bool((b1 >= b0).all())
    for k in range(g[PK.G_NSUB]):
        sz, s0 = g[PK.G_SUB_SIZE + k], g[PK.G_STREAM_OFF + k]
        seg0 = plan["seg0"][:, k]
        assert torch.equal(seg0, s0 + b0 * sz)
        assert seg0[0] == s0 and seg0[-1] + (b1[-1] - b0[-1]) * sz == \
            g[PK.G_STREAM_OFF + k + 1]
    tile, cond, addr = PK.tile_blocks(geom, plan)
    order = torch.argsort(cond)
    assert torch.equal(cond[order], torch.arange(g[PK.G_TBLOCKS]))
    assert bool(((cond >= b0[tile]) & (cond < b1[tile])).all())
    composed = torch.cat([
        (addr[order][:, None] + g[PK.G_SUB_OFF + k]
         + torch.arange(g[PK.G_SUB_SIZE + k])[None, :]).reshape(-1)
        for k in range(g[PK.G_NSUB])])
    want = PK.cond_addresses(geom)
    assert torch.equal(composed, want)
    np.testing.assert_array_equal(want.numpy(), JP.build_cond_map(jp))
    start, end = PK.tile_ranges(geom, plan)
    ok = end > start
    edges = torch.zeros(size + 1, dtype=torch.int64)
    edges.index_add_(0, start[ok], torch.ones(int(ok.sum()),
                                              dtype=torch.int64))
    edges.index_add_(0, end[ok], -torch.ones(int(ok.sum()),
                                             dtype=torch.int64))
    assert bool((torch.cumsum(edges, 0)[:size] == 1).all())


@pytest.mark.parametrize("mode", FLAGS)
@pytest.mark.parametrize("name", GEOMETRIES)
def test_lookback_carries_equal_span_prefix_sums(name, mode):
    """Where the postprocess reads a carry (a tile's colour segment that
    starts inside a flagged page's span, past its first byte), the twin's
    carry is the sum modulo 256 of the span's bytes before the segment,
    as postprocess_plain takes it over span_starts; and decoding the
    segment's first byte with it gives postprocess_plain's byte."""
    _, geom, cond, flags, _ = case_inputs(name, mode)
    g = geom.tolist()
    x = as_tensor(cond)
    plan = PK.tile_plan(geom)
    carries = PK.lookback_carries(x, geom, plan)
    assert carries.shape == (len(plan["b0"]), g[PK.G_NCOLOR])
    c = torch.cat([torch.zeros(1, dtype=torch.int64),
                   torch.cumsum(x.to(torch.int64), 0)])
    start = PK.span_starts(geom, flags)
    dec = PK.postprocess_plain(x, geom, flags)
    addr = PK.cond_addresses(geom)
    used = 0
    for ci in range(g[PK.G_NCOLOR]):
        k = g[PK.G_COLOR + ci]
        gs = plan["seg0"][:, k]
        nonempty = plan["b1"] > plan["b0"]
        st = start[gs.clamp(max=len(start) - 1)]
        read = nonempty & (st >= 0) & (st != gs)
        want = (c[gs] - c[st.clamp(min=0)]) & 255
        assert torch.equal(carries[read, ci], want[read])
        first = (carries[:, ci] + x[gs.clamp(max=len(x) - 1)].long()) & 255
        assert torch.equal(first[read], dec[addr[gs[read]]].long())
        used += int(read.sum())
    if mode != "no page" and len(plan["b0"]) > 8:
        assert used > 0


def test_entry_points_equal_jitted_jax(monkeypatch):
    """The port's entry points on the CPU against the jitted JAX ones on a
    4-mip BC3 texture with aligned pitches over two 32 KiB pages; no map
    plane is cached on the way."""
    from brotlig_tpu.ops import precondition as JO
    monkeypatch.setattr(TO, "_MAP_CACHE", {})
    kw = dict(precondition=True, swizzle=True, delta_encode=True,
              format=C.DATA_FORMAT_BC3, width_in_pixels=196,
              height_in_pixels=132, num_mip_levels=4,
              pitch_d3d12_aligned=True)
    probe = JP.DataConditionParams(**kw)
    probe.initialize(-1)
    size = probe.mip_offsets_bytes[4]
    jp, tp = JP.DataConditionParams(**kw), TP.DataConditionParams(**kw)
    assert jp.initialize(size) and tp.initialize(size)
    page = 32 * KIB
    assert page < size < 2 * page
    data = random_bytes(size, seed=9)
    want = JO.preprocess_device(data, jp, page)
    got = TO.preprocess_device(data, tp, page, "cpu")
    assert got[:2] == want[:2] and list(got[2]) == list(want[2])
    for flagged in (None, set(), {1}):
        assert TO.postprocess_device(want[1], tp, page, "cpu", flagged) == \
            JO.postprocess_device(want[1], jp, page, flagged)
    assert TO._MAP_CACHE == {}


def test_geometry_record_refuses_what_it_cannot_cover():
    """A size that the mips do not fill, a pitch below its row, an
    uninitialised geometry and a page size off 128 raise ValueError; a CPU
    tensor never reaches a kernel."""
    _, tp, size, page = geometry("bc1 65x67 blocks (odd), no swizzle, "
                                 "32 KiB")
    with pytest.raises(ValueError, match="covers"):
        PK.pack_geometry(tp, size + 1, page)
    with pytest.raises(ValueError, match="multiple of 128"):
        PK.pack_geometry(tp, size, page + 64)
    with pytest.raises(ValueError, match="not initialised"):
        PK.pack_geometry(TP.DataConditionParams(), 0, page)
    short = TP.DataConditionParams(precondition=True,
                                   format=C.DATA_FORMAT_BC1)
    short.width_in_blocks[0], short.height_in_blocks[0] = 8, 4
    short.pitch_in_bytes[0] = 32                 # a row holds 64 bytes
    assert short.initialize(32 * 4)
    with pytest.raises(ValueError, match="pitch"):
        PK.pack_geometry(short, 32 * 4, page)
    geom = PK.pack_geometry(tp, size, page)
    with pytest.raises(ValueError, match="kernel argument on cpu"):
        PK.postprocess_cuda(torch.zeros(size, dtype=torch.uint8), geom)


# ---------------------------------------------------------------------------
# The kernels on the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def poisoned(n, dev):
    return torch.full((n,), 0xA5, dtype=torch.uint8, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", FLAGS)
@pytest.mark.parametrize("name", GEOMETRIES)
def test_postprocess_kernel_equals_plain(cuda_dev, name, mode):
    _, geom, cond, flags, want = case_inputs(name, mode)
    x = as_tensor(cond, cuda_dev)
    out = PK.postprocess_cuda(x, geom, flags, out=poisoned(len(cond),
                                                           cuda_dev))
    torch.cuda.synchronize()
    plain = PK.postprocess_plain(x.cpu(), geom, flags)
    assert torch.equal(out.cpu(), plain)
    assert out.cpu().numpy().tobytes() == want


@pytest.mark.cuda
@pytest.mark.parametrize("flags", ("none given", "span pages", "no page"))
@pytest.mark.parametrize("name", GEOMETRIES)
def test_preprocess_kernel_equals_plain(cuda_dev, name, flags):
    _, tp, size, page = geometry(name)
    data = as_tensor(random_bytes(size, seed=len(name) + 1), cuda_dev)
    geom = PK.pack_geometry(tp, size, page)
    fl = {"none given": None,
          "span pages": torch.from_numpy(PK.span_pages(geom).astype(
              np.uint8)),
          "no page": torch.zeros(-(-size // page), dtype=torch.uint8)}[flags]
    out = (poisoned(size, cuda_dev), poisoned(size, cuda_dev))
    cond, delta = PK.preprocess_cuda(data, geom, fl, out=out)
    torch.cuda.synchronize()
    want = PK.preprocess_plain(data.cpu(), geom, fl)
    assert torch.equal(cond.cpu(), want[0])
    assert torch.equal(delta.cpu(), want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("name", GEOMETRIES)
def test_kernel_tiles_and_records(cuda_dev, name):
    """The library's tile size and tile count are tile_plan's; each
    kernel's per-CTA record counts every tile once; the postprocess
    leaves its look-back words zeroed, so that two raw launches on one
    buffer give the same texture."""
    _, tp, size, page = geometry(name)
    geom = PK.pack_geometry(tp, size, page)
    lib = _kernels.library()
    tiles = len(PK.tile_plan(geom)["b0"])
    assert lib.blg_precond_tile_bytes() == PK.TILE_BYTES
    assert lib.blg_precond_tiles(geom.data_ptr()) == tiles
    x = as_tensor(random_bytes(size, seed=3), cuda_dev)
    out, rec = PK.postprocess_cuda(x, geom, out=poisoned(size, cuda_dev),
                                   return_record=True)
    *_, rec_pre = PK.preprocess_cuda(x, geom, return_record=True)
    torch.cuda.synchronize()
    for r in (rec, rec_pre):
        assert int(r[:, PK.REC_TILES].sum()) == tiles
        assert bool((r[:, PK.REC_TOTAL] > 0).all())
    assert torch.equal(out.cpu(), PK.postprocess_plain(x.cpu(), geom))
    work = PK.lookback_words(geom, cuda_dev)
    for _ in range(2):
        again = poisoned(size, cuda_dev)
        assert lib.blg_postprocess(
            geom.data_ptr(), x.data_ptr(), None, again.data_ptr(),
            work.data_ptr(), None, _kernels.stream_ptr(cuda_dev)) == 0
        torch.cuda.synchronize()
        assert torch.equal(again, out) and int(work.abs().sum()) == 0


def bc3_texture(dev):
    """A 256 x 256 BC3 texture with four mips and its preconditioned
    container, encoded on `dev` by the port's full route at q1."""
    from brotlig_tpu_torch import encode
    from brotlig_tpu_torch.format import constants as TC
    size = 16 * (64 * 64 + 32 * 32 + 16 * 16 + 8 * 8)
    rng = np.random.default_rng(4)
    tex = ((rng.integers(0, 8, size) + np.arange(size) // 64 % 32)
           .astype(np.uint8).tobytes())
    params = TP.DataConditionParams(
        precondition=True, swizzle=True, delta_encode=True,
        format=TC.DATA_FORMAT_BC3, width_in_pixels=256,
        height_in_pixels=256, num_mip_levels=4)
    return tex, encode(tex, page_size=32 * KIB, dc_params=params,
                       backend="full", quality=1, device=dev)


@pytest.mark.cuda
def test_texture_paths_launch_the_kernels_and_cache_no_map(cuda_dev,
                                                           monkeypatch):
    """Encode on the card (one preprocess launch), decode on the card (one
    postprocess launch) back to the texture, kept on the card too, and the
    pool of two textures (one launch each): no map plane cached."""
    from brotlig_tpu_torch import decode
    from brotlig_tpu_torch.parallel.runtime import decode_archives_batched
    monkeypatch.setattr(TO, "_MAP_CACHE", {})
    _kernels.reset_launches()
    tex, blob = bc3_texture("cuda")
    assert _kernels.LAUNCHES["precond"] == 1
    _kernels.reset_launches()
    assert decode(blob, device="cuda") == tex
    res = decode(blob, device="cuda", return_device=True)
    assert res.is_cuda and res.cpu().numpy().tobytes() == tex
    assert _kernels.LAUNCHES["precond"] == 2
    _kernels.reset_launches()
    assert decode_archives_batched([blob, blob], device="cuda") == [tex, tex]
    assert _kernels.LAUNCHES["precond"] == 2
    assert not [k for k in TO._MAP_CACHE if k[0] in ("inv", "fwd", "delta")]
