"""The hand-written CUDA kernels against their plain torch versions, on the
card. Skips without a CUDA device; on a machine with one (and nvcc), run:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

(--noconftest: the suite's conftest configures JAX, which the GPU machine
need not have). Every comparison is exact: the format fixes the bytes.
"""
import numpy as np
import pytest
import torch

from brotlig_tpu_torch import _kernels, decode, native, state
from brotlig_tpu_torch.format.headers import parse_container
from brotlig_tpu_torch.ops import decode as decode_mod
from brotlig_tpu_torch.ops import (decode_kernel, encode_pack,
                                   match_kernel, pack_kernel, phase_a_kernel,
                                   sweep_kernel, tables_kernel)
from brotlig_tpu_torch.ops.decode import VALID_SWEEP_CW, staged_batches
from brotlig_tpu_torch.state import Staged, tables_from_lengths
from test_roundtrip import make_data
from test_torch_encode_api import small_dp
from test_torch_two_phase import (EDGE_CASES, edge_case, mixed_pages,
                                  plain_phase_a, stage)

pytestmark = pytest.mark.cuda

KINDS = ("text", "structured", "repetitive", "zeros", "random", "text")


@pytest.fixture(scope="module")
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def container(page_size: int, quality: int = 11):
    data = b"".join(make_data(k, page_size, seed=i)
                    for i, k in enumerate(KINDS))
    return data, native.encode(data, page_size=page_size, quality=quality)


def first_batch(blob, dev):
    group, staged = next(staged_batches(blob, parse_container(blob), 256,
                                        dev))
    return group, staged


def decode_case(case, dev):
    """(page datas, staged batch, page size) of a container of the three
    page sizes or of an edge input of tests/test_torch_two_phase.py."""
    if case in EDGE_CASES:
        data, comp, page_size = edge_case(case)
        return [data], stage([comp], dev), page_size
    page_size = int(case)
    data, blob = container(page_size)
    group, st = first_batch(blob, dev)
    return ([data[i * page_size:(i + 1) * page_size] for i in group], st,
            page_size)


def assert_tables_equal(buf3):
    """The tables kernel's packed operands equal the plain version's."""
    got = tables_kernel.load_tables(buf3)
    torch.cuda.synchronize()
    want = tables_kernel.tables_plain(buf3)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and torch.equal(g, w)
    return got


@pytest.mark.parametrize("case", ("32768", "65536", "131072") + EDGE_CASES)
def test_tables_kernel_matches_plain(cuda_dev, case):
    _, st, _ = decode_case(case, cuda_dev)
    assert_tables_equal(st.buf)


@pytest.mark.parametrize("case", ("32768", "65536", "131072") + EDGE_CASES)
def test_decode_kernel_matches_plain(cuda_dev, case):
    datas, st, page_size = decode_case(case, cuda_dev)
    tabs = tables_from_lengths(*tables_kernel.load_tables_plain(st.buf))
    out, ncmds, status = decode_kernel.decode_fused(st.buf, st.npd, tabs,
                                                    page_size)
    torch.cuda.synchronize()
    p_out, p_ncmds, p_status = decode_kernel.decode_fused_plain(
        st.buf, st.npd, tabs, page_size)
    assert torch.equal(out, p_out)
    assert torch.equal(ncmds.long(), p_ncmds.long())
    assert torch.equal(status, p_status)
    assert int(status.abs().sum()) == 0
    for row, d in enumerate(datas):
        assert out[row, :len(d)].cpu().numpy().tobytes() == d


def no_torch_table_build(monkeypatch):
    """Make the torch search build raise: on the card the tables kernel
    builds the search arrays itself."""
    def banned(*args, **kwargs):
        raise AssertionError("the CUDA route ran the torch table build")
    monkeypatch.setattr(state, "build_search", banned)
    monkeypatch.setattr(decode_mod, "tables_from_lengths", banned)


def test_decode_stream_cuda(cuda_dev, monkeypatch):
    no_torch_table_build(monkeypatch)
    data, blob = container(65536)
    _kernels.reset_launches()
    assert decode(blob, device="cuda") == data
    assert _kernels.LAUNCHES["tables"] == 1
    assert _kernels.LAUNCHES["decode"] == 1


@pytest.mark.parametrize("S", [32768, 65536, 131072])
def test_garbage_pages_flagged_not_hung(cuda_dev, S):
    """All-zero streams decode as trivial codes whose commands never end
    the page: the fused and the phase-A kernel, and the plain version,
    must stop at their bounds and flag the page."""
    P, wc = 4, 8
    st = Staged(torch.zeros((wc, P, 128), dtype=torch.int32, device=cuda_dev),
                torch.zeros((P, 4), dtype=torch.int32, device=cuda_dev))
    got = assert_tables_equal(st.buf)
    tabs = tables_from_lengths(*tables_kernel.load_tables_plain(st.buf))
    _, _, status = decode_kernel.decode_fused(st.buf, st.npd, got, S)
    a = phase_a_kernel.phase_a(st.buf, st.npd, got, S)
    torch.cuda.synchronize()
    _, _, p_status = decode_kernel.decode_fused_plain(st.buf, st.npd, tabs, S)
    assert bool((status != 0).all()) and bool((p_status != 0).all())
    assert bool((a.status != 0).all())


def test_kernels_at_512_pages(cuda_dev):
    """One launch of each kernel over 512 pages (two waves of blocks on
    the card): the tables kernel equals its plain version, the fused
    kernel's pages and the phase-A kernel's through the sweep at every cw
    equal the input."""
    PS = 32768
    kinds = ("structured", "repetitive", "structured", "zeros")
    data = b"".join(make_data("text" if i % 16 == 0 else kinds[i % 4], PS,
                              seed=i) for i in range(512))
    blob = native.encode(data, page_size=PS, quality=1)
    info = parse_container(blob)
    assert len(info.compressed_page_indices()) >= 512
    group, st = next(staged_batches(blob, info, 512, cuda_dev))
    assert st.buf.shape[1] == 512
    tabs = assert_tables_equal(st.buf)
    out, ncmds, status = decode_kernel.decode_fused(st.buf, st.npd, tabs, PS)
    a = phase_a_kernel.phase_a(st.buf, st.npd, tabs, PS)
    torch.cuda.synchronize()
    assert int(status.abs().sum()) == 0 and int(a.status.abs().sum()) == 0
    assert torch.equal(ncmds, a.ncmds)
    want = torch.from_numpy(np.frombuffer(data, np.uint8).reshape(-1, PS))
    want = want[torch.tensor(group)].to(cuda_dev)
    assert torch.equal(out, want)
    for cw in VALID_SWEEP_CW:
        swept = sweep_kernel.sweep(a.ncmds, a.litq, a.ins, a.cpy, a.dist,
                                   PS, cw)
        assert torch.equal(swept, want)


def two_phase_case(name):
    """(datas, page blobs, page size) of the mixed batch or an edge input
    of tests/test_torch_two_phase.py."""
    if name == "mixed":
        datas, comps = mixed_pages()
        return datas, comps, 32768
    data, comp, page_size = edge_case(name)
    return [data], [comp], page_size


def assert_phase_a_equal(got, want):
    """Equal where PhaseA defines its fields: ncmds and status; commands
    below ncmds; the literal queue up to each page's literal count."""
    assert torch.equal(got.ncmds.long(), want.ncmds.long())
    assert torch.equal(got.status.long(), want.status.long())
    for p, k in enumerate(want.ncmds.tolist()):
        for g, w in ((got.ins, want.ins), (got.cpy, want.cpy),
                     (got.dist, want.dist)):
            assert torch.equal(g[p, :k].long(), w[p, :k].long())
        nlit = int(want.ins[p, :k].sum())
        assert torch.equal(got.litq[p, :nlit], want.litq[p, :nlit])


@pytest.mark.parametrize("case", ("mixed",) + EDGE_CASES)
def test_phase_a_kernel_matches_plain(cuda_dev, case):
    _, comps, page_size = two_phase_case(case)
    st, tabs, want = plain_phase_a(comps, page_size, cuda_dev)
    got = phase_a_kernel.phase_a(st.buf, st.npd, tabs, page_size)
    torch.cuda.synchronize()
    assert_phase_a_equal(got, want)
    assert int(got.status.abs().sum()) == 0


@pytest.mark.parametrize("cw", VALID_SWEEP_CW)
@pytest.mark.parametrize("case", ("mixed",) + EDGE_CASES)
def test_sweep_kernel_matches_plain(cuda_dev, case, cw):
    datas, comps, page_size = two_phase_case(case)
    st, tabs, _ = plain_phase_a(comps, page_size, cuda_dev)
    a = phase_a_kernel.phase_a(st.buf, st.npd, tabs, page_size)
    got = sweep_kernel.sweep(a.ncmds, a.litq, a.ins, a.cpy, a.dist,
                             page_size, cw)
    torch.cuda.synchronize()
    want = sweep_kernel.sweep_plain(a.ncmds, a.litq, a.ins, a.cpy, a.dist,
                                    page_size)
    assert torch.equal(got, want)
    for p, d in enumerate(datas):
        assert got[p, :len(d)].cpu().numpy().tobytes() == d


@pytest.mark.parametrize("cw", VALID_SWEEP_CW)
def test_sweep_kernel_no_and_all_commands(cuda_dev, cw):
    """The sweep's prologue on command lists made directly: a page with
    no command, one whose every slot is a command (ncmds = N) and one
    with huge lengths past its ncmds, which the prologue must mask."""
    S, N = 32768, 600
    r = np.random.default_rng(5)
    ins = r.integers(0, 5, (3, N))
    cpy = r.integers(2, 41, (3, N))
    ins[:, 0] = 1
    pos = np.cumsum(ins, axis=1) + np.cumsum(cpy, axis=1) - cpy
    dist = np.minimum(r.integers(1, 3000, (3, N)), pos)
    ncmds = np.array([0, N, N // 2])
    ins[2, N // 2:] = cpy[2, N // 2:] = 1 << 20
    litq = r.integers(0, 256, (3, S + 64), dtype=np.uint8)

    def dev(x, dtype=torch.int32):
        return torch.from_numpy(np.ascontiguousarray(x)).to(cuda_dev, dtype)
    args = (dev(ncmds), dev(litq, torch.uint8), dev(ins), dev(cpy),
            dev(dist))
    got = sweep_kernel.sweep(*args, S, cw)
    torch.cuda.synchronize()
    want = sweep_kernel.sweep_plain(*args, S)
    assert torch.equal(got, want)
    assert not want[0].any() and want[1].any() and want[2].any()


@pytest.mark.parametrize("cw", VALID_SWEEP_CW)
def test_decode_stream_two_phase_cuda(cuda_dev, cw, monkeypatch):
    """One launch of each kernel of the route, and no torch middle stage
    between the phase-A kernel and the sweep (the sweep's prologue lays
    out the commands)."""
    def no_middle_stage(*args, **kwargs):
        raise AssertionError("the two-phase route ran the middle stage")
    monkeypatch.setattr(sweep_kernel, "middle_stage", no_middle_stage)
    no_torch_table_build(monkeypatch)
    data, blob = container(65536)
    _kernels.reset_launches()
    assert decode(blob, device="cuda", variant="two_phase",
                  sweep_cw=cw) == data
    assert _kernels.LAUNCHES == {"tables": 1, "decode": 0, "phase_a": 1,
                                 "sweep": 1, "dp_parse": 0, "pack": 0,
                                 "match": 0, "cost": 0, "precond": 0,
                                 "ref_parse": 0}
    assert _kernels.SWEEP_LAUNCHES[cw] == 1


def test_xla_variant_runs_the_plain_route_on_the_card(cuda_dev):
    data = b"".join(make_data(k, 32768, seed=i)
                    for i, k in enumerate(("text", "structured")))
    blob = native.encode(data, page_size=32768)
    _kernels.reset_launches()
    assert decode(blob, device="cuda", variant="xla") == data
    assert not any(_kernels.LAUNCHES.values())


def test_two_phase_garbage_pages_flagged_not_hung(cuda_dev):
    """All-zero streams: the phase-A kernel stops at its bounds and flags
    every page, and the sweep runs over whatever it stored without
    reading or writing out of bounds."""
    P, wc, S = 4, 8, 32768
    st = Staged(torch.zeros((wc, P, 128), dtype=torch.int32, device=cuda_dev),
                torch.zeros((P, 4), dtype=torch.int32, device=cuda_dev))
    tabs = tables_from_lengths(*tables_kernel.load_tables_plain(st.buf))
    a = phase_a_kernel.phase_a(st.buf, st.npd, tables_kernel.load_tables(
        st.buf), S)
    p = phase_a_kernel.phase_a_plain(st.buf, st.npd, tabs, S)
    assert bool((a.status != 0).all()) and bool((p.status != 0).all())
    for cw in VALID_SWEEP_CW:
        out = sweep_kernel.sweep(a.ncmds, a.litq, a.ins, a.cpy, a.dist, S,
                                 cw)
        assert out.shape == (P, S)
    torch.cuda.synchronize()


def texture_container(swizzle_delta: bool = True):
    """A 256 x 256 BC5 texture with two mips (80 KiB, three 32 KiB pages)
    and its preconditioned container, from the JAX package's pure-Python
    encoder."""
    from brotlig_tpu.format import constants as C
    from brotlig_tpu.format.precondition import DataConditionParams
    from brotlig_tpu.refimpl.codec import encode
    rng = np.random.default_rng(0)
    size = 16 * (64 * 64 + 32 * 32)
    tex = ((rng.integers(0, 8, size) + np.arange(size) // 64 % 32)
           .astype(np.uint8).tobytes())
    p = DataConditionParams(precondition=True, swizzle=swizzle_delta,
                            delta_encode=swizzle_delta,
                            format=C.DATA_FORMAT_BC5, width_in_pixels=256,
                            height_in_pixels=256, num_mip_levels=2)
    return tex, encode(tex, page_size=32768, dc_params=p)


@pytest.mark.parametrize("variant", ["fused", "two_phase"])
def test_preconditioned_decode_cuda(cuda_dev, variant):
    """Decoded and deconditioned on the card, in batches of two pages,
    through the device plane: equal to the texture, each kernel of the
    route launched once a batch; returned on the card on request."""
    tex, blob = texture_container()
    _kernels.reset_launches()
    got = decode_mod.decode_stream(blob, "cuda", batch_pages=2,
                                   variant=variant)
    assert got == tex
    assert _kernels.LAUNCHES["tables"] == 2
    assert _kernels.LAUNCHES["decode" if variant == "fused"
                             else "phase_a"] == 2
    res = decode(blob, device="cuda", variant=variant, return_device=True)
    assert res.is_cuda and res.cpu().numpy().tobytes() == tex


def test_pipeline_loop_makes_no_synchronising_call(cuda_dev):
    """decode_batches over three batches with torch's sync debug mode set
    to raise: the loop waits on the card only through its events."""
    data, blob = container(65536)
    comp, offs, sizes = decode_mod.compressed_jobs(parse_container(blob))
    out = {}

    def drain(keys, pages, isdelta):
        for row, i in enumerate(keys):
            out[int(i)] = pages[row].tobytes()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        decode_mod.decode_batches(blob, comp, offs, sizes, 65536, cuda_dev,
                                  drain, batch_pages=2)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert sorted(out) == sorted(comp.tolist())
    for i in comp:
        assert out[int(i)] == data[i * 65536:(i + 1) * 65536]


def test_decode_archives_batched_cuda(cuda_dev):
    from brotlig_tpu_torch.parallel.runtime import decode_archives_batched
    tex, tblob = texture_container()
    datas = [make_data(k, 40_000 + 9000 * i, seed=i)
             for i, k in enumerate(KINDS)] + [tex]
    blobs = [native.encode(d, page_size=32768) for d in datas[:-1]] + [tblob]
    _kernels.reset_launches()
    assert decode_archives_batched(blobs, batch_pages=4,
                                   device="cuda") == datas
    n = sum(len(parse_container(b).compressed_page_indices())
            for b in blobs)
    assert _kernels.LAUNCHES["decode"] == -(-n // 4)


def test_abort_mid_pipeline_then_clean_decode(cuda_dev):
    """An abort raised in the second drain, with later batches still in
    flight on the card, leaves the next decode whole."""
    from brotlig_tpu_torch.format.errors import Aborted
    data, blob = container(32768)
    seen = []
    with pytest.raises(Aborted):
        decode_mod.decode_stream(
            blob, "cuda", batch_pages=1,
            feedback=lambda p: (seen.append(p), len(seen) == 2)[1])
    assert len(seen) == 2
    for _ in range(2):
        assert decode_mod.decode_stream(blob, "cuda", batch_pages=1) == data


# ---- the encoders: torch ops, the same on the card as on the CPU ----

def encode_rows(page_size: int = 65536):
    """A batch of pages of every kind, a partial page and tiny rows."""
    datas = [make_data(k, page_size, seed=i) for i, k in enumerate(KINDS)]
    datas += [make_data("text", 20000, seed=9), b"xyz" * 40, b"Q", b""]
    arr = np.zeros((len(datas), page_size), np.uint8)
    sizes = np.zeros(len(datas), np.int32)
    for i, d in enumerate(datas):
        arr[i, :len(d)] = np.frombuffer(d, np.uint8)
        sizes[i] = len(d)
    return datas, arr, sizes


@pytest.mark.parametrize("fast", [False, True])
def test_find_commands_card_equals_cpu(cuda_dev, fast):
    from brotlig_tpu_torch.ops.encode import find_commands
    _, arr, sizes = encode_rows()
    S = arr.shape[1]
    max_cmds = S // 4 + 16 if fast else S // 2 + 2
    want = find_commands(torch.from_numpy(arr), torch.from_numpy(sizes),
                         max_cmds, fast)
    _kernels.reset_launches()
    got = find_commands(torch.from_numpy(arr).to(cuda_dev),
                        torch.from_numpy(sizes).to(cuda_dev), max_cmds, fast)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    # the kernels, not torch ops
    assert _kernels.LAUNCHES["match"] == match_kernel.LAUNCHES_PER_CALL


def test_find_candidates_card_equals_cpu(cuda_dev):
    from brotlig_tpu_torch.ops.encode import find_candidates
    _, arr, sizes = encode_rows()
    want = find_candidates(torch.from_numpy(arr), torch.from_numpy(sizes),
                           512)
    _kernels.reset_launches()
    got = find_candidates(torch.from_numpy(arr).to(cuda_dev),
                          torch.from_numpy(sizes).to(cuda_dev), 512)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert _kernels.LAUNCHES["match"] == match_kernel.LAUNCHES_PER_CALL


def test_encode_pages_device_card_equals_cpu(cuda_dev):
    from brotlig_tpu_torch.ops.encode_pack import encode_pages_device
    datas, arr, sizes = encode_rows()
    isdelta = np.arange(len(datas)) % 2
    want = encode_pages_device(arr, sizes, arr.shape[1], isdelta, quality=1,
                               device="cpu")
    got = encode_pages_device(arr, sizes, arr.shape[1], isdelta, quality=1,
                              device=cuda_dev)
    assert got == want


@pytest.mark.parametrize("backend,quality",
                         [("hybrid", 11), ("full", 1), ("full", 11)])
def test_encode_on_card_decodes_on_card(cuda_dev, backend, quality,
                                        monkeypatch):
    """A stream encoded on the card equals the CPU route's and decodes on
    the card, every kernel of each route launched once a batch (and the DP
    kernel once a batch an iteration)."""
    from brotlig_tpu_torch import encode
    if quality >= 10:   # the CPU run it is held to: a narrowed DP
        small_dp(monkeypatch)
    data = b"".join(make_data(k, 65536, seed=i)
                    for i, k in enumerate(KINDS)) + make_data("text", 777)
    _kernels.reset_launches()
    blob = encode(data, backend=backend, quality=quality, device="cuda")
    assert _kernels.LAUNCHES["dp_parse"] == (quality >= 10 and
                                             backend == "full")
    # the serializer kernel once a batch a parse (greedy, and the DP's)
    assert _kernels.LAUNCHES["pack"] == (0 if backend == "hybrid" else
                                         1 + (quality >= 10))
    assert blob == encode(data, backend=backend, quality=quality,
                          device="cpu")
    for variant, kernels in (("fused", ("tables", "decode")),
                             ("two_phase", ("tables", "phase_a", "sweep"))):
        _kernels.reset_launches()
        assert decode(blob, device="cuda", variant=variant) == data
        assert all(_kernels.LAUNCHES[k] == 1 for k in kernels)


@pytest.mark.parametrize("backend,quality",
                         [("hybrid", 11), ("full", 1), ("full", 11)])
def test_preconditioned_encode_on_card(cuda_dev, backend, quality,
                                       monkeypatch):
    from brotlig_tpu_torch import encode
    if quality >= 10:
        small_dp(monkeypatch)
    from brotlig_tpu_torch.format import constants as C
    from brotlig_tpu_torch.format.precondition import DataConditionParams
    rng = np.random.default_rng(0)
    size = 16 * (64 * 64 + 32 * 32)
    tex = ((rng.integers(0, 8, size) + np.arange(size) // 64 % 32)
           .astype(np.uint8).tobytes())

    def params():
        return DataConditionParams(
            precondition=True, swizzle=True, delta_encode=True,
            format=C.DATA_FORMAT_BC5, width_in_pixels=256,
            height_in_pixels=256, num_mip_levels=2)
    blob = encode(tex, page_size=32768, dc_params=params(), backend=backend,
                  quality=quality, device="cuda")
    assert blob == encode(tex, page_size=32768, dc_params=params(),
                          backend=backend, quality=quality, device="cpu")
    assert decode(blob, device="cuda") == tex


# ---------------------------------------------------------------------------
# The windowed-DP kernel (csrc/dp_parse.cu) and the q11 route's parts
# ---------------------------------------------------------------------------

def dp_pages(kinds, S):
    """(uint8 [P, S] pages, int32 sizes) of (kind, length) rows, as
    tests/test_ops_encode.py::TestParseDP makes them."""
    arr = np.zeros((len(kinds), S), np.uint8)
    sizes = np.zeros(len(kinds), np.int32)
    for i, (kind, n) in enumerate(kinds):
        arr[i, :n] = np.frombuffer(make_data(kind, n, seed=i + 20), np.uint8)
        sizes[i] = n
    return arr, sizes


def dp_inputs(arr, sizes, W: int, dev):
    """The first cost-model iteration's DP inputs on dev: (litq, cand_len,
    dpackq, jointEq, jointLq)."""
    from brotlig_tpu_torch.ops import encode as TE
    from brotlig_tpu_torch.ops import parse_dp
    pages = torch.from_numpy(arr).to(dev)
    in_sizes = torch.from_numpy(sizes).to(dev)
    greedy = TE.find_commands(pages, in_sizes, arr.shape[1] // 4 + 16)
    m = parse_dp.build_cost_model(pages, in_sizes, *greedy,
                                  *TE.find_candidates(pages, in_sizes, W))
    return m[0], m[3], m[5], m[1], m[2]


TEST_PARSE_DP_KINDS = [("text", 2048), ("structured", 2048 - 97),
                       ("repetitive", 2048), ("random", 1000),
                       ("zeros", 2048)]


@pytest.mark.parametrize("R", [0, 1, 2, 16])
@pytest.mark.parametrize("shape", ["defaults", "test_parse_dp", "block_63",
                                   "window_32"])
def test_dp_kernel_matches_plain(cuda_dev, shape, R):
    """The kernel equals its plain version on the card, bit for bit: four
    32 KiB pages at the defaults (B 32, W 512), TestParseDP's shapes (S
    2048, W 256) with ragged sizes, its pages cut to S 2016 at B 63, W
    126 (two cells a lane), and at W 32 = B (no source before the
    previous block), at R 0, 1, 2 and 16. No page runs more than
    R rounds a block; away from the defaults the rounds equal those of the
    torch rendering of the kernel's schedule
    (tests/test_torch_dp_rounds.py); at R 16 the pages' blocks stop early
    on average (fewer than 16 rounds, so fewer than 17 passes, a
    block)."""
    from brotlig_tpu_torch.ops import dp_kernel, parse_dp
    from test_torch_dp_rounds import dp_parse_rounds
    if shape == "defaults":
        arr, sizes = dp_pages([(k, 32768) for k in KINDS[:4]], 32768)
        B, W = 32, 512
    elif shape in ("test_parse_dp", "window_32"):
        arr, sizes = dp_pages(TEST_PARSE_DP_KINDS, 2048)
        B, W = 32, 256 if shape == "test_parse_dp" else 32
    else:
        arr, sizes = dp_pages([(k, min(n, 2016)) for k, n
                               in TEST_PARSE_DP_KINDS], 2016)
        B, W = 63, 126
    ins = dp_inputs(arr, sizes, W, cuda_dev)
    _kernels.reset_launches()
    got = parse_dp.dp_parse(*ins, B, W, R)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["dp_parse"] == 1
    want = parse_dp.dp_parse_plain(*ins, B, W, R)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    again, rounds = dp_kernel.dp_parse_cuda(*ins, B, W, R,
                                            return_rounds=True)
    assert torch.equal(again, want)
    blocks = arr.shape[1] // B
    assert int(rounds.max()) <= R * blocks
    if shape != "defaults":
        _, ref_rounds = dp_parse_rounds(*[x.cpu() for x in ins], B, W, R)
        assert torch.equal(rounds.cpu().long(), ref_rounds)
    if R == 16:
        assert float(rounds.double().mean()) / blocks < 16


@pytest.mark.parametrize("S", [32, 64])
def test_dp_kernel_one_and_two_blocks(cuda_dev, S):
    """Pages of one and two blocks (B 32, W 32): the producers' first and
    last blocks meet; bit for bit at R 16."""
    from brotlig_tpu_torch.ops import parse_dp
    arr, sizes = dp_pages([(k, S) for k in KINDS[:3]], S)
    ins = dp_inputs(arr, sizes, 32, cuda_dev)
    got = parse_dp.dp_parse(*ins, 32, 32, 16)
    assert torch.equal(got, parse_dp.dp_parse_plain(*ins, 32, 32, 16))


def test_dp_kernel_stops_late_on_a_text_page(cuda_dev):
    """TestParseDP's text page at R 16: its blocks need several rounds
    (mean above 2) and stop before R (mean below 16), on the card as in
    the torch rendering; the output equals the plain version's."""
    from brotlig_tpu_torch.ops import dp_kernel, parse_dp
    arr, sizes = dp_pages(TEST_PARSE_DP_KINDS[:1], 2048)
    ins = dp_inputs(arr, sizes, 256, cuda_dev)
    got, rounds = dp_kernel.dp_parse_cuda(*ins, 32, 256, 16,
                                          return_rounds=True)
    assert torch.equal(got, parse_dp.dp_parse_plain(*ins, 32, 256, 16))
    assert 2 < int(rounds[0]) / (2048 // 32) < 16


@pytest.mark.parametrize("B,W,R,S", [(64, 256, 6, 2048), (32, 1024, 6, 2048),
                                     (32, 240, 6, 2048), (48, 480, 6, 2000),
                                     (32, 256, -1, 2048)])
def test_dp_kernel_refuses_bad_shapes(cuda_dev, B, W, R, S):
    from brotlig_tpu_torch.ops import parse_dp
    P, K = 2, 12
    z = torch.zeros((P, S), dtype=torch.int32, device=cuda_dev)
    zk = torch.zeros((P, S, K), dtype=torch.int32, device=cuda_dev)
    zj = torch.zeros((P, 576), dtype=torch.int32, device=cuda_dev)
    _kernels.reset_launches()
    with pytest.raises(ValueError, match="dp_parse needs"):
        parse_dp.dp_parse(z, zk, zk, zj, zj, B, W, R)
    assert _kernels.LAUNCHES["dp_parse"] == 0


def test_unseen_cost_on_card_equals_cpu(cuda_dev):
    """The float32 unseen-symbol half-bits of every table total in
    [1, 2^18), pads 2 and 4: a log2 one ulp off would flip a half-bit."""
    from brotlig_tpu_torch.ops.parse_dp import unseen_bits
    total = torch.arange(1, 1 << 18)
    for pad in (2.0, 4.0):
        got = torch.round(2.0 * unseen_bits(total.to(cuda_dev), pad))
        want = torch.round(2.0 * unseen_bits(total, pad))
        assert torch.equal(got.cpu(), want)


def test_find_commands_dp_card_equals_cpu(cuda_dev):
    from brotlig_tpu_torch.ops.parse_dp import find_commands_dp
    arr, sizes = dp_pages(TEST_PARSE_DP_KINDS, 2048)
    args = (2048 // 2 + 2,)
    kw = dict(iters=2, B=32, W=256, R=6)
    want = find_commands_dp(torch.from_numpy(arr), torch.from_numpy(sizes),
                            *args, **kw)
    _kernels.reset_launches()
    got = find_commands_dp(torch.from_numpy(arr).to(cuda_dev),
                           torch.from_numpy(sizes).to(cuda_dev), *args, **kw)
    assert _kernels.LAUNCHES["dp_parse"] == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_dp_candidates_and_cost_model_card_equal_cpu(cuda_dev):
    from brotlig_tpu_torch.ops import encode as TE
    from brotlig_tpu_torch.ops import parse_dp
    _, arr, sizes = encode_rows()
    W = 512
    outs = []
    for dev in (cuda_dev, "cpu"):
        pages = torch.from_numpy(arr).to(dev)
        in_sizes = torch.from_numpy(sizes).to(dev)
        cand = TE.find_candidates(pages, in_sizes, W)
        greedy = TE.find_commands(pages, in_sizes, arr.shape[1] // 4 + 16)
        outs.append([t.cpu() for t in cand + parse_dp.build_cost_model(
            pages, in_sizes, *greedy, *cand)])
    for g, w in zip(*outs):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# Pages split over devices (parallel/sharding.py), and every wrapper
# launching on its tensors' device
# ---------------------------------------------------------------------------

def test_decode_pages_sharded_kernel_over_two_shares(cuda_dev):
    """The tables and fused decode kernels over two shares of one card
    equal the plain route over the same shares, on the 64 KiB container's
    first batch."""
    from brotlig_tpu_torch.parallel.sharding import (
        decode_pages_sharded, decode_pages_sharded_kernel)
    data, blob = container(65536)
    info = parse_container(blob)
    comp = info.compressed_page_indices()
    W = 65536 // 4 + 2
    arr = np.zeros((len(comp), W * 4), np.uint8)
    for r, i in enumerate(comp):
        off, n = int(info.offsets[i]), int(info.sizes[i])
        arr[r, :n] = np.frombuffer(blob, np.uint8, n, off)
    words = arr.view(np.uint32).reshape(len(comp), W)
    sizes = info.sizes[comp]
    devs = ["cuda:0", "cuda:0"]
    _kernels.reset_launches()
    out, isd = decode_pages_sharded_kernel(words, sizes, 65536, devs)
    assert _kernels.LAUNCHES["tables"] == 2
    assert _kernels.LAUNCHES["decode"] == 2
    want, want_isd = decode_pages_sharded(words, sizes, 65536, devs)
    assert torch.equal(out, want) and torch.equal(isd, want_isd)
    for r, i in enumerate(comp):
        assert out[r].numpy().tobytes() == data[i * 65536:(i + 1) * 65536]


@pytest.mark.parametrize("n_shares", [1, 2])
def test_decode_stream_sharded_cuda(cuda_dev, n_shares):
    """decode_stream_sharded over [cuda:0] and [cuda:0, cuda:0] equals the
    input (a plain container of three batches a share, and a
    preconditioned texture); K1 and K2 launch once a batch of each
    share."""
    from brotlig_tpu_torch.parallel.sharding import (decode_stream_sharded,
                                                     shard_bounds)
    data = b"".join(make_data(KINDS[i % 6], 32768, seed=i)
                    for i in range(12 * n_shares))
    blob = native.encode(data, page_size=32768, quality=1)
    n_comp = len(parse_container(blob).compressed_page_indices())
    devs = ["cuda:0"] * n_shares
    _kernels.reset_launches()
    assert decode_stream_sharded(blob, devs, batch_pages=4) == data
    want = sum(-(-(hi - lo) // 4) for lo, hi in shard_bounds(n_comp,
                                                               n_shares))
    assert _kernels.LAUNCHES["tables"] == want
    assert _kernels.LAUNCHES["decode"] == want
    from brotlig_tpu_torch.entry import bc1_container
    tex, tblob = bc1_container(65536, 4, "cuda")
    assert decode_stream_sharded(tblob, devs) == tex


def test_every_wrapper_launches_on_its_tensors_device(cuda_dev):
    """From a thread whose current device is cuda:0, every kernel wrapper
    given tensors on cuda:1 launches there and equals its plain version
    (the C entry points launch on the current device; the wrappers make
    the tensors' device current)."""
    import threading
    from brotlig_tpu_torch.ops import dp_kernel, parse_dp
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    dev1 = torch.device("cuda", 1)
    errors = []

    def run():
        try:
            torch.cuda.set_device(0)
            datas, st, page_size = decode_case("65536", dev1)
            tabs = assert_tables_equal(st.buf)
            out, _, status = decode_kernel.decode_fused(st.buf, st.npd,
                                                        tabs, page_size)
            a = phase_a_kernel.phase_a(st.buf, st.npd, tabs, page_size)
            swept = sweep_kernel.sweep(a.ncmds, a.litq, a.ins, a.cpy,
                                       a.dist, page_size, 1024)
            torch.cuda.synchronize(dev1)
            assert torch.cuda.current_device() == 0
            assert out.device == dev1 and bool((status == 0).all())
            for r, d in enumerate(datas):
                assert out[r].cpu().numpy().tobytes() == d
                assert swept[r].cpu().numpy().tobytes() == d
            arr, sizes = dp_pages(TEST_PARSE_DP_KINDS, 2048)
            ins = dp_inputs(arr, sizes, 256, dev1)
            got = dp_kernel.dp_parse_cuda(*ins, 32, 256, 2)
            torch.cuda.synchronize(dev1)
            assert torch.equal(got, parse_dp.dp_parse_plain(*ins, 32, 256,
                                                            2))
            *ops, S, bound = pack_case("encode_rows", dev1)
            got = encode_pack.pack_partitioned(ops[0], ops[1], S, bound,
                                               *ops[2:])
            want = encode_pack.pack_partitioned_plain(ops[0], ops[1], S,
                                                      bound, *ops[2:])
            torch.cuda.synchronize(dev1)
            assert got[0].device == dev1
            assert all(torch.equal(g, w) for g, w in zip(got, want))
        except BaseException as e:      # re-raised in the test's thread
            errors.append(e)
    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=600)
    assert not t.is_alive()
    if errors:
        raise errors[0]


# ---- the serializer kernel (csrc/pack.cu) against its plain version ----

def _corpus_pages(n: int, S: int):
    """n corpus pages of S bytes (the last one partial) with the fast
    tier's commands: (pages, in_sizes, ins, cpy, dist, ncmds, isdelta)
    numpy arrays, S // 4 + 16 command columns."""
    from brotlig_tpu_torch.ops.encode import find_commands
    from brotlig_tpu_torch.utils.corpus import corpus
    arr = np.frombuffer(corpus(n, page=S), np.uint8).reshape(n, S).copy()
    sizes = np.full(n, S, np.int64)
    sizes[-1] -= S // 3
    arr[-1, sizes[-1]:] = 0
    cmds = find_commands(torch.from_numpy(arr), torch.from_numpy(sizes),
                         S // 4 + 16, fast=True)
    return (arr, sizes, *(c.numpy() for c in cmds), np.arange(n) % 2)


def pack_case(case: str, dev):
    """A serializer batch on `dev`: (pages, in_sizes, ins, cpy, dist,
    ncmds, isdelta, page size, command bound). "mixed" and "edge" are
    tests/test_torch_pack.py's batches (several buckets, the overflow page;
    the edge pages), "encode_rows" tests/test_torch_encode.py's serializer
    rows at the 2048 bucket, "corpus_32k", "corpus_64k" and "corpus_128k"
    16 corpus pages of 32 and 64 KiB and 4 of 128 KiB (the last one
    partial) with the fast tier's commands; the kernel's size cases:
    "many_keys" (the page with more grid-search keys than its
    shared-memory sort holds, beside a 128 KiB corpus page), "overflow"
    (the overflow page beside a text page); "one_page" (a 1-page batch)
    and "p144" (the 64 KiB pages 9 times over, 144 pages: more blocks than
    SMs)."""
    import test_torch_pack as TPK
    if case == "mixed":
        ops, S, bound = TPK.mixed_batch(), TPK.S, TPK.WIDE_CMDS
    elif case == "edge":
        ops, S, bound = TPK.edge_batch()[1:], TPK.S, TPK.WIDE_CMDS
    elif case == "overflow":
        names, *ops = TPK.edge_batch()
        keep = [names.index("overflow"), names.index("tail_only")]
        ops, S, bound = [x[keep] for x in ops], TPK.S, TPK.WIDE_CMDS
    elif case == "encode_rows":
        ops, S, bound = (TPK.encode_test_rows(), TPK.S,
                         encode_pack.BUCKET_MIN)
    elif case == "many_keys":
        S = TPK.CORPUS_128K
        data, ins, cpy, dist = TPK.many_keys_page()
        corp = _corpus_pages(1, S)
        bound = S // 4 + 16
        ops = [np.concatenate([a, b]) for a, b in zip(
            (np.frombuffer(data, np.uint8)[None], np.array([S]), ins[None],
             cpy[None], dist[None], np.array([len(dist)]), np.array([0])),
            corp)]
    else:
        S = {"corpus_32k": 32768, "corpus_128k": 131072}.get(case, 65536)
        ops = _corpus_pages(4 if S == 131072 else 16, S)
        bound = S // 4 + 16
        if case == "one_page":
            ops = [x[:1] for x in ops]
        elif case == "p144":
            ops = [np.concatenate([x] * 9) for x in ops]
            ops[6] = np.arange(144) % 2
    return [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
            for x in ops] + [S, bound]


@pytest.mark.parametrize("case", ["mixed", "edge", "encode_rows",
                                  "corpus_32k", "corpus_64k", "corpus_128k",
                                  "many_keys", "overflow", "one_page",
                                  "p144"])
def test_pack_kernel_matches_plain(cuda_dev, case):
    """pack_partitioned and pack_pages_device launch the kernel once for
    the whole batch, and their bytes and sizes equal the plain version's
    on the card and on the CPU (tolerance 0). Each page's record shows the
    size case it took: the literal queue in shared memory up to 64 KiB
    pages, the sort in device memory only for the many-keys page, the
    streams in device memory only where a stream overflows. Every page's
    blob decodes on the card to its input."""
    from brotlig_tpu_torch.format.headers import StreamHeader
    from brotlig_tpu_torch.ops.encode import assemble
    from brotlig_tpu_torch.parallel.runtime import decode_archives_batched
    pages, sizes, ins, cpy, dist, ncmds, isdelta, S, bound = pack_case(
        case, cuda_dev)
    _kernels.reset_launches()
    got = encode_pack.pack_partitioned(pages, sizes, S, bound, ins, cpy,
                                       dist, ncmds, isdelta)
    one = encode_pack.pack_pages_device(pages, sizes, ins, cpy, dist, ncmds,
                                        S, bound, isdelta)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["pack"] == 2
    want = encode_pack.pack_partitioned_plain(pages, sizes, S, bound, ins,
                                              cpy, dist, ncmds, isdelta)
    cpu = encode_pack.pack_partitioned_plain(
        *[x.cpu() for x in (pages, sizes)], S, bound,
        *[x.cpu() for x in (ins, cpy, dist, ncmds, isdelta)])
    for out in (got, one, cpu):
        assert out[1].dtype == torch.int64
        assert torch.equal(out[1].cpu(), want[1].cpu())
        assert torch.equal(out[0].cpu(), want[0].cpu())
    info = pack_kernel.pack_cuda(pages, sizes, ins, cpy, dist, ncmds, S,
                                 bound, isdelta, return_info=True)[2].cpu()
    branch = info[:, pack_kernel.INFO_BRANCH]
    over = got[1].cpu() == S + 1
    assert torch.equal((branch & pack_kernel.BRANCH_WORDS) != 0, over)
    keys = (branch & pack_kernel.BRANCH_KEYS) != 0
    assert keys.tolist() == [case == "many_keys" and i == 0
                             for i in range(len(branch))]
    assert bool(((branch & pack_kernel.BRANCH_LQ) != 0).all()) == (
        S <= 65536)
    assert (case == "overflow") <= bool(over.any())
    arr, in_sizes = pages.cpu().numpy(), sizes.cpu().numpy()
    blobs = encode_pack.page_blobs(got[0].cpu().numpy(),
                                   got[1].cpu().numpy(), in_sizes, arr)
    rows = [i for i in range(len(blobs)) if in_sizes[i]]
    containers = [assemble(StreamHeader.for_input(int(in_sizes[i]), S,
                                                  False), False, None,
                           [blobs[i]]) for i in rows]
    outs = decode_archives_batched(containers, device=cuda_dev)
    for i, o in zip(rows, outs):
        assert o == arr[i, :in_sizes[i]].tobytes()


def test_pack_kernel_refuses_bad_shapes(cuda_dev):
    pages, sizes, ins, cpy, dist, ncmds, isdelta, S, bound = pack_case(
        "encode_rows", cuda_dev)
    with pytest.raises(ValueError):
        pack_kernel.pack_cuda(pages[:, :S // 2], sizes, ins, cpy, dist,
                              ncmds, S, bound)
    with pytest.raises(ValueError):
        pack_kernel.pack_cuda(pages, sizes, ins[:, :0], cpy[:, :0],
                              dist[:, :0], ncmds, S, bound)
    with pytest.raises(ValueError):
        pack_kernel.pack_cuda(pages, sizes[:3], ins, cpy, dist, ncmds, S,
                              bound)
