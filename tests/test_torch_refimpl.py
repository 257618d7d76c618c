"""The port's scalar page coder (brotlig_tpu_torch/refimpl/ and the format
modules only it reaches) against the JAX package's on the CPU, and its
page parse's CUDA kernel against the plain version on a card.

Every comparison is exact (bytes and ints): the format fixes every byte.
The JAX side is brotlig_tpu/refimpl/ and brotlig_tpu/format/, pure numpy
and Python, so this file compiles no JAX executable. The whole-stream
cases hold brotlig_tpu_torch.encode(..., backend="native",
dc_params=..., device="cpu") to brotlig_tpu.encode(..., backend="cpu")
with separate parameter objects, at 32 KiB pages on textures of a few
pages.

On a card (marker `cuda`, skipped without one), the parse kernels
(csrc/ref_parse.cu) against find_matches on page kinds at 32, 64 and 128
KiB and several max_chain, on the rows that are hard for the walk's join
(test_torch_ref_parse.join_rows) at 64 and 128 KiB, and the route on the
card against the CPU route:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_refimpl.py
"""
import numpy as np
import pytest
import torch

import brotlig_tpu
from brotlig_tpu.format import bitio as JB
from brotlig_tpu.format import constants as C
from brotlig_tpu.format import huffman as JH
from brotlig_tpu.format import lut as JL
from brotlig_tpu.format import precondition as JP
from brotlig_tpu.format import rle as JR
from brotlig_tpu.format import swizzle as JS
from brotlig_tpu.refimpl import codec as JC
from brotlig_tpu.refimpl import page_decoder as JD
from brotlig_tpu.refimpl import page_encoder as JE

import brotlig_tpu_torch as bt
from brotlig_tpu_torch import _kernels, cli
from brotlig_tpu_torch.format import bitio as TB
from brotlig_tpu_torch.format import errors as TER
from brotlig_tpu_torch.format import huffman as TH
from brotlig_tpu_torch.format import lut as TL
from brotlig_tpu_torch.format import rle as TR
from brotlig_tpu_torch.format import swizzle as TS
from brotlig_tpu_torch.format import precondition as TP
from brotlig_tpu_torch.format.errors import Aborted, MessageType
from brotlig_tpu_torch.format.headers import StreamHeader
from brotlig_tpu_torch.ops import ref_parse_kernel as RK
from brotlig_tpu_torch.refimpl import codec as TC
from brotlig_tpu_torch.refimpl import page_decoder as TD
from brotlig_tpu_torch.refimpl import page_encoder as TE
from test_roundtrip import make_data
from test_torch_precondition import params_pair, texture, texture_size
from test_torch_ref_parse import join_rows
from test_torch_two_phase import torch_one_thread  # noqa: F401 (autouse)

PS = C.MIN_PAGE_SIZE
CHAINS = (0, 1, 4, 64, 200)


def page_of(kind: str, n: int, seed: int = 0) -> bytes:
    """A page of `kind`: test_roundtrip's kinds, "runs" (runs of random
    lengths and bytes) and "four" (four symbols, random)."""
    rng = np.random.default_rng(seed)
    if kind == "runs":
        lens = rng.integers(1, 300, size=n // 2 + 1)
        vals = rng.integers(0, 256, size=len(lens), dtype=np.uint8)
        return np.repeat(vals, lens)[:n].tobytes()
    if kind == "four":
        return (rng.integers(0, 4, size=n) * 0x55).astype(np.uint8).tobytes()
    return make_data(kind, n, seed)


# ---------------------------------------------------------------------------
# format/: lut, bitio, rle, huffman, swizzle, errors
# ---------------------------------------------------------------------------

def test_length_code_tables_equal():
    for name in ("INSERT_BASE", "INSERT_EXTRA", "COPY_BASE", "COPY_EXTRA",
                 "CMD_INSERT_CODE", "CMD_COPY_CODE", "CMD_INSERT_BASE",
                 "CMD_INSERT_EXTRA", "CMD_COPY_BASE", "CMD_COPY_EXTRA"):
        np.testing.assert_array_equal(getattr(TL, name), getattr(JL, name),
                                      err_msg=name)
    for n in range(0, 70000):
        assert TL.get_insert_length_code(n) == JL.get_insert_length_code(n)
        assert TL.get_copy_length_code(n) == JL.get_copy_length_code(n)
    for n in (1 << 17, 1 << 20, (1 << 24) - 1):
        assert TL.get_insert_length_code(n) == JL.get_insert_length_code(n)
        assert TL.get_copy_length_code(n) == JL.get_copy_length_code(n)
    for ic in range(24):
        for cc in range(24):
            for last in (False, True):
                assert (TL.combine_length_codes(ic, cc, last)
                        == JL.combine_length_codes(ic, cc, last))


@pytest.mark.parametrize("npostfix", range(4))
def test_distance_codes_equal(npostfix):
    rng = np.random.default_rng(npostfix)
    dists = list(range(1, 1200)) + rng.integers(1, 1 << 18, 300).tolist()
    for nd in range(16):
        ndirect = nd << npostfix
        for d in dists:
            got = TL.encode_distance(d, npostfix, ndirect)
            assert got == JL.encode_distance(d, npostfix, ndirect)
            sym, nbits, extra = got
            assert (TL.distance_symbol_extra_bits(sym, npostfix, ndirect)
                    == JL.distance_symbol_extra_bits(sym, npostfix, ndirect)
                    == nbits)
            assert (TL.decode_distance_symbol(sym, extra, npostfix, ndirect)
                    == JL.decode_distance_symbol(sym, extra, npostfix,
                                                 ndirect) == d)


def test_bit_io_equal():
    rng = np.random.default_rng(3)
    ops = [(int(k), int(v)) for k, v in zip(rng.integers(0, 33, 2000),
                                            rng.integers(0, 1 << 40, 2000))]
    tw, jw = TB.BitWriterLSB(), JB.BitWriterLSB()
    for k, v in ops:
        tw.write(k, v)
        jw.write(k, v)
    tw.align_to_dword()
    jw.align_to_dword()
    assert tw.getvalue() == jw.getvalue() and tw.nbytes() == jw.nbytes()
    data = tw.getvalue()
    tr, jr = TB.BitReaderLSB(data), JB.BitReaderLSB(data)
    for k, _ in ops:
        assert tr.peek(k) == jr.peek(k)
        assert tr.read(k) == jr.read(k)
    assert tr.read(40) == jr.read(40)       # past the end: zero bits


@pytest.mark.parametrize("seed", range(6))
def test_rle_codes_equal(seed):
    rng = np.random.default_rng(seed)
    size = int(rng.choice([18, 256, 704, 728]))
    runs = rng.integers(1, 24, size=size)
    vals = rng.integers(0, 16, size=size) * (rng.random(size) < 0.6)
    lengths = np.repeat(vals, runs)[:size].astype(np.uint8)
    got, want = TR.compute_rle_codes(lengths), JR.compute_rle_codes(lengths)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(JR.decode_rle_codes(*got, size), lengths)


def histograms():
    """{name: (histogram, alphabet size)}: empty, one and two symbols,
    three and four (simple trees), skewed past depth 15 (Fibonacci
    counts), and random over each alphabet."""
    rng = np.random.default_rng(11)
    fib = [1, 1]
    while len(fib) < 24:
        fib.append(fib[-1] + fib[-2])
    out = {}
    for alpha in (C.NUM_LITERAL_SYMBOLS, C.NUM_DISTANCE_SYMBOLS,
                  C.NUM_COMMAND_SYMBOLS_EFFECTIVE):
        h = np.zeros(alpha, np.int64)
        out[f"empty {alpha}"] = (h, alpha)
        for k, syms in ((1, [7]), (2, [3, alpha - 1]), (3, [0, 5, 9]),
                        (4, [1, 2, 30, 40])):
            h = np.zeros(alpha, np.int64)
            h[syms] = rng.integers(1, 50, len(syms))
            out[f"{k} symbols {alpha}"] = (h, alpha)
        h = np.zeros(alpha, np.int64)
        h[np.arange(24) * (alpha // 24)] = fib
        out[f"skewed {alpha}"] = (h, alpha)
        h = rng.integers(0, 1000, alpha) * (rng.random(alpha) < 0.5)
        out[f"random {alpha}"] = (h.astype(np.int64), alpha)
    h = np.zeros(C.NUM_LITERAL_SYMBOLS, np.int64)
    h[[1, 2, 30, 40]] = [100, 1, 1, 1]
    out["4 symbols, tree_select 1"] = (h, C.NUM_LITERAL_SYMBOLS)
    return out


HISTOGRAMS = histograms()


@pytest.mark.parametrize("name", list(HISTOGRAMS))
def test_huffman_tables_equal(name):
    hist, alpha = HISTOGRAMS[name]
    lengths = TH.package_merge_lengths(hist)
    np.testing.assert_array_equal(lengths, JH.package_merge_lengths(hist))
    assert int(lengths.max(initial=0)) <= C.HUFFMAN_MAX_DEPTH
    if lengths.any():
        np.testing.assert_array_equal(TH.canonical_codes(lengths),
                                      JH.canonical_codes(lengths))
        for got, want in zip(TH.build_decode_table(lengths, 15),
                             JH.build_decode_table(lengths, 15)):
            np.testing.assert_array_equal(got, want)
    ts, js = TS.Swizzler(), JS.Swizzler()
    for got, want in zip(TH.build_and_store_table(hist, alpha, ts),
                         JH.build_and_store_table(hist, alpha, js)):
        np.testing.assert_array_equal(got, want)
    for s in (ts, js):
        s.append_to_header(8, 0xA5)
        s.append_bitstream_sizes()
    blob = ts.serialize()
    assert blob == js.serialize()
    # the stored table reads back through the port's Deswizzler
    hdr = len(ts.header.getvalue())
    pos, offs = hdr, []
    for w in ts.writers:
        offs.append(pos)
        pos += w.nbytes()
    got = TH.load_table_lengths(TS.Deswizzler(blob, offs), alpha)
    want = JH.load_table_lengths(JS.Deswizzler(blob, offs), alpha)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    if got[1] is None:
        np.testing.assert_array_equal(got[0], TH.package_merge_lengths(hist))


def test_errors_equal():
    from brotlig_tpu.format import errors as JER
    for name in ("PageSizeError", "PreconditionError", "Aborted",
                 "TooManyPages", "CorruptStream", "IncorrectStreamFormat"):
        got, want = getattr(TER, name), getattr(JER, name)
        assert got.code == want.code and issubclass(got, TER.BrotligError)
        assert issubclass(got, ValueError)
    assert [e.value for e in TER.ErrorCode] == [e.value for e in JER.ErrorCode]


# ---------------------------------------------------------------------------
# refimpl/page_encoder.py and page_decoder.py
# ---------------------------------------------------------------------------

KINDS = ("text", "zeros", "runs", "four", "random")


@pytest.mark.parametrize("kind", KINDS)
def test_find_matches_equal(kind):
    data = page_of(kind, 3000 if kind == "four" else 6000, seed=2)
    for chain in CHAINS:
        assert TE.find_matches(data, chain) == JE.find_matches(data, chain)


def test_find_matches_short_inputs():
    for n in range(6):
        for data in (bytes(n), bytes(range(n)), b"\xaa" * n):
            for chain in CHAINS:
                assert (TE.find_matches(data, chain)
                        == JE.find_matches(data, chain))


def test_find_matches_pages_plain_packs_rows():
    """The plain route packs find_matches per row as the kernel does: the
    commands in a row's first ncmds columns, zeros after, a row's own
    size, a short last row."""
    S = 2048
    datas = [page_of(k, n, seed=i) for i, (k, n) in enumerate(
        (("text", S), ("zeros", S), ("runs", 1000), ("four", 3), ("text", 0),
         ("random", S)))]
    pages = torch.zeros((len(datas), S), dtype=torch.uint8)
    for r, d in enumerate(datas):
        pages[r, :len(d)] = torch.tensor(list(d), dtype=torch.uint8)
    sizes = torch.tensor([len(d) for d in datas], dtype=torch.int32)
    for chain in (0, 64, 10 ** 9):
        ins, cpy, dist, nc, tail = RK.find_matches_pages(pages, sizes, chain)
        assert ins.shape == (len(datas), RK.max_cmds_for(S))
        for r, d in enumerate(datas):
            cmds, t = JE.find_matches(d, min(chain, S))
            k = int(nc[r])
            assert k == len(cmds) and int(tail[r]) == t
            got = list(zip(ins[r, :k].tolist(), cpy[r, :k].tolist(),
                           dist[r, :k].tolist()))
            assert got == cmds
            assert not (ins[r, k:].any() or cpy[r, k:].any()
                        or dist[r, k:].any())
    with pytest.raises(ValueError, match="multiple of 16"):
        RK.find_matches_pages(torch.zeros((1, 100), dtype=torch.uint8),
                              torch.tensor([100]))
    with pytest.raises(ValueError, match="in_sizes"):
        RK.find_matches_pages(pages, sizes[:2])
    with pytest.raises(ValueError, match=r"\[0, S\]"):
        RK.find_matches_pages(pages, sizes + S)


@pytest.mark.parametrize("kind", ("text", "runs", "four", "random",
                                  "structured"))
def test_encode_page_equal(kind):
    data = page_of(kind, 5000, seed=4)
    for is_last in (False, True):
        for delta in (False, True):
            got = TE.encode_page(data, is_last, delta_encoded=delta)
            assert got == JE.encode_page(data, is_last, delta_encoded=delta)
    if kind == "random":
        assert got is None                  # stored raw
    cmds, tail = TE.find_matches(data)
    assert TE.serialize_page(data, cmds, tail, True, True) == got


@pytest.mark.parametrize("kind", ("text", "zeros", "runs", "four"))
def test_decode_page_equal(kind):
    data = page_of(kind, 4000, seed=5)
    for is_last, delta in ((False, True), (True, False)):
        page = JE.encode_page(data, is_last, delta_encoded=delta)
        assert page is not None
        got = TD.decode_page(page, len(data))
        assert got == JD.decode_page(page, len(data)) == (data, delta)
    assert TD.decode_page(data, len(data)) == (data, False)   # raw


# ---------------------------------------------------------------------------
# Whole containers: the route against brotlig_tpu.encode(backend="cpu")
# ---------------------------------------------------------------------------

def encode_pair(data, jp, tp, **kw):
    want = brotlig_tpu.encode(data, page_size=PS, dc_params=jp,
                              backend="cpu", **kw)
    got = bt.encode(data, page_size=PS, dc_params=tp, backend="native",
                    device="cpu", **kw)
    return got, want


TEXTURES = {
    # name: (format, width, height, mips, swizzle, delta, pitch aligned)
    "BC1 swizzle delta": (C.DATA_FORMAT_BC1, 256, 320, 1, True, True, False),
    "BC1 delta": (C.DATA_FORMAT_BC1, 256, 320, 1, False, True, False),
    "BC3 swizzle, 3 mips": (C.DATA_FORMAT_BC3, 128, 160, 3, True, False,
                            False),
    "BC5 plain, D3D12 pitch": (C.DATA_FORMAT_BC5, 72, 256, 1, False, False,
                               True),
    "BC3 delta, 2 mips, D3D12 pitch": (C.DATA_FORMAT_BC3, 100, 160, 2, False,
                                       True, True),
}


@pytest.mark.parametrize("name", list(TEXTURES))
def test_texture_containers_equal(name):
    fmt, w, h, mips, swz, delta, pitch = TEXTURES[name]
    size = texture_size(fmt, w, h, mips, pitch)
    jp, tp = params_pair(fmt, w, h, mips, swizzle=swz, delta=delta,
                         pitch_aligned=pitch)
    tex = texture(size, seed=len(name))
    got, want = encode_pair(tex, jp, tp)
    assert got == want
    assert TC.decompressed_size(got) == size
    if name == "BC1 swizzle delta":         # the port's scalar decoder
        assert TC.decode(got) == JC.decode(want)


def test_random_texture_pages_stored_raw():
    size = texture_size(C.DATA_FORMAT_BC1, 256, 256)
    jp, tp = params_pair(C.DATA_FORMAT_BC1, 256, 256, swizzle=True,
                         delta=True)
    tex = texture(size, seed=9, random=True)
    got, want = encode_pair(tex, jp, tp, max_chain=4)
    assert got == want and len(got) > size


def test_downgrades_and_empty_input():
    """Any dc_params takes the route, as in the JAX package: a geometry
    that does not fit the input and precondition=False give plain
    streams; empty input a bare header."""
    data = page_of("text", 9000, seed=1)
    kw = dict(precondition=True, swizzle=True, delta_encode=True,
              format=C.DATA_FORMAT_BC1, width_in_pixels=64,
              height_in_pixels=64)
    jp, tp = JP.DataConditionParams(**kw), TP.DataConditionParams(**kw)
    for chain in (1, 64):
        got, want = encode_pair(data, jp, tp, max_chain=chain)
        assert got == want
    assert not jp.initialized and not tp.initialized
    assert not StreamHeader.unpack(got).preconditioned
    got, want = encode_pair(b"", jp, tp)
    assert got == want
    size = texture_size(C.DATA_FORMAT_BC1, 64, 64)
    jp, tp = (P(**{**kw, "precondition": False})
              for P in (JP.DataConditionParams, TP.DataConditionParams))
    got, want = encode_pair(data[:size], jp, tp)
    assert got == want
    assert bt.decode_cpu(got) == data[:size]


def test_feedback_and_abort():
    size = texture_size(C.DATA_FORMAT_BC4, 256, 384)
    jp, tp = params_pair(C.DATA_FORMAT_BC4, 256, 384, swizzle=True,
                         delta=True)
    tex = texture(size, seed=3)
    seen = {"jax": [], "port": []}

    def record(key):
        def fb(kind, text):
            seen[key].append((int(kind), text))
            return False
        return fb
    want = brotlig_tpu.encode(tex, page_size=PS, dc_params=jp, backend="cpu",
                              feedback=record("jax"))
    got = bt.encode(tex, page_size=PS, dc_params=tp, backend="native",
                    device="cpu", feedback=record("port"))
    assert got == want
    assert seen["port"] == seen["jax"] == [
        (int(MessageType.PROGRESS), f"{100.0 * (i + 1) / 2}")
        for i in range(2)]
    calls = []

    def stop_after_first(kind, text):
        calls.append(text)
        return True
    with pytest.raises(Aborted, match="aborted"):
        bt.encode(tex, page_size=PS, dc_params=tp, backend="native",
                  device="cpu", feedback=stop_after_first)
    assert calls == ["50.0"]


def test_page_size_and_device_refusals():
    _, tp = params_pair(C.DATA_FORMAT_BC1, 64, 64)
    with pytest.raises(TER.PageSizeError, match="page size"):
        bt.encode(bytes(100), page_size=4096, dc_params=tp, backend="native",
                  device="cpu")
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="cuda"):
        bt.encode(bytes(100), dc_params=tp, backend="native", device="cuda")


def test_cli_native_precondition(tmp_path, capsys):
    fmt, w, h = C.DATA_FORMAT_BC1, 256, 320
    size = texture_size(fmt, w, h)
    tex = texture(size, seed=2)
    src = tmp_path / "tex.bin"
    src.write_bytes(tex)
    rc = cli.main([str(src), "--device", "cpu", "--encode-backend", "native",
                   "--precondition", "--data-format", "bc1", "--width",
                   str(w), "--height", str(h), "--swizzle", "--delta-encode",
                   "--page-size", str(PS)])
    assert rc == 0 and "ratio" in capsys.readouterr().out
    jp, _ = params_pair(fmt, w, h, swizzle=True, delta=True)
    want = brotlig_tpu.encode(tex, page_size=PS, dc_params=jp, backend="cpu")
    assert (tmp_path / "tex.bin.brotlig").read_bytes() == want


# ---------------------------------------------------------------------------
# On a card: the parse kernels against find_matches, the route against the
# CPU route
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def parse_batch(S: int, kinds, seed: int):
    """A batch of S-byte rows, one a kind, the last one short."""
    datas = [page_of(k, S, seed + i) for i, k in enumerate(kinds)]
    datas[-1] = datas[-1][: S - 1000 - seed]
    pages = torch.zeros((len(datas), S), dtype=torch.uint8)
    for r, d in enumerate(datas):
        pages[r, :len(d)] = torch.tensor(list(d), dtype=torch.uint8)
    return pages, torch.tensor([len(d) for d in datas], dtype=torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("S,chains,rows", [
    pytest.param(32768, (0, 1, 4, 64, 200), "kinds", id="32768-chains0"),
    pytest.param(65536, (1, 64), "kinds", id="65536-chains1"),
    pytest.param(131072, (64,), "kinds", id="131072-chains2"),
    pytest.param(65536, (0, 1, 64), "join", id="65536-join"),
    pytest.param(131072, (1, 64, 200), "join", id="131072-join")])
def test_parse_kernel_equals_plain(cuda_dev, S, chains, rows):
    kinds = ("text", "zeros", "runs", "four", "random", "structured",
             "repetitive", "text")
    if rows == "kinds":
        pages, sizes = parse_batch(S, kinds, seed=S // 32768)
    else:           # the rows that are hard for the walk's join
        datas = list(join_rows(RK.SEGMENT, S).values())
        arr = np.zeros((len(datas), S), np.uint8)
        for r, d in enumerate(datas):
            arr[r, :len(d)] = np.frombuffer(d, np.uint8)
        pages = torch.from_numpy(arr)
        sizes = torch.tensor([len(d) for d in datas], dtype=torch.int32)
    for chain in chains:
        _kernels.reset_launches()
        got = RK.find_matches_pages(pages.to(cuda_dev), sizes.to(cuda_dev),
                                    chain)
        torch.cuda.synchronize()
        assert _kernels.LAUNCHES["ref_parse"] == RK.LAUNCHES_PER_CALL
        want = RK.find_matches_plain(pages, sizes, chain)
        for name, g, w in zip(("ins", "cpy", "dist", "ncmds", "tail"), got,
                              want):
            nc = want[3]
            if g.dim() == 2:        # beyond ncmds the kernel leaves garbage
                cols = torch.arange(g.shape[1])[None, :] < nc[:, None]
                g, w = g.cpu()[cols], w[cols]
            assert torch.equal(g.cpu(), w), (S, chain, rows, name)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ("BC1 swizzle delta",
                                  "BC3 delta, 2 mips, D3D12 pitch"))
def test_route_on_card_equals_cpu(cuda_dev, name):
    fmt, w, h, mips, swz, delta, pitch = TEXTURES[name]
    size = texture_size(fmt, w, h, mips, pitch)
    _, tp = params_pair(fmt, w, h, mips, swizzle=swz, delta=delta,
                        pitch_aligned=pitch)
    tex = texture(size, seed=len(name))
    _kernels.reset_launches()
    got = bt.encode(tex, page_size=PS, dc_params=tp, backend="native",
                    device="cuda")
    assert _kernels.LAUNCHES["ref_parse"] == RK.LAUNCHES_PER_CALL
    assert _kernels.LAUNCHES["precond"] == 1
    assert got == bt.encode(tex, page_size=PS, dc_params=tp,
                            backend="native", device="cpu")
    assert bt.decode(got, device="cuda") == bt.decode_cpu(got)
