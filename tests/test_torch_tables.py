"""The port's header parse, canonical search structures and table loader
against the JAX package's (XLA route), on real encoded pages staged by
native.stage_pages; and the tables wrapper's CPU route against the JAX
loader chain. Exact equality."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from brotlig_tpu import native
from brotlig_tpu.format import constants as C
from brotlig_tpu.format.headers import parse_container
from brotlig_tpu.ops import tables as JT

from brotlig_tpu_torch.ops import tables as TT
from brotlig_tpu_torch.ops import tables_kernel
from brotlig_tpu_torch.ops.decode import staged_batches
from brotlig_tpu_torch.state import (pack_tables, tables_from_jax,
                                     tables_from_lengths)
from test_ops_tables import batch_words, make_pages
from test_torch_two_phase import torch_one_thread  # noqa: F401 (autouse)
from test_roundtrip import make_data

PS = 32768
ALPHABETS = (C.NUM_COMMAND_SYMBOLS_EFFECTIVE, C.NUM_DISTANCE_SYMBOLS,
             C.NUM_LITERAL_SYMBOLS)


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def encoded_pages():
    return make_pages()


@pytest.fixture(scope="module")
def staged():
    """A container whose pages use trivial, simple and complex codes."""
    rng = np.random.default_rng(3)
    pages = [make_data("text", PS, seed=1), bytes(PS),
             rng.choice([65, 66], size=PS, p=[0.8, 0.2]).astype(np.uint8)
             .tobytes(),
             rng.choice([1, 2, 3, 7], size=PS, p=[0.6, 0.2, 0.15, 0.05])
             .astype(np.uint8).tobytes(),
             make_data("structured", PS, seed=2)]
    blob = native.encode(b"".join(pages), page_size=PS)
    _, st = next(staged_batches(blob, parse_container(blob), 256, "cpu"))
    return st


@pytest.fixture(scope="module")
def jax_chain(staged):
    return _jax_chain(staged.buf.numpy())


def _jax_chain(buf3_np):
    tl = min(tables_kernel.TABLE_WORDS, buf3_np.shape[0] * 4)
    view, bp0 = JT.stream_view_from_interleaved(jnp.asarray(buf3_np), tl)
    bp, outs = bp0, []
    for A in ALPHABETS:
        ln, triv, bp = JT.load_table(view, bp, A)
        outs.append((np.asarray(ln), np.asarray(triv)))
    return outs, np.asarray(bp - bp0)


def test_header_parse_matches_jax(encoded_pages):
    words, sizes = batch_words(encoded_pages)
    got = TT.parse_page_headers_full(_t(words), _t(sizes))
    want = JT.parse_page_headers_full(words, sizes)
    for g, w in zip(got, want):
        _eq(g, w)


def test_bit_length_matches_jax():
    v = np.array([0, 1, 2, 3, 4, 7, 8, 255, 256, 65535, 2**31 - 1], np.int32)
    _eq(TT.bit_length(_t(v)), JT.bit_length(jnp.asarray(v)))


@pytest.mark.parametrize("tl", [16, 64])
def test_stream_views_match_jax(encoded_pages, staged, tl):
    words, sizes = batch_words(encoded_pages)
    sb = JT.parse_page_headers_full(words, sizes)[4]
    for g, w in zip(TT.narrow_stream_view(_t(words), _t(sb), tl),
                    JT.narrow_stream_view(words, sb, tl)):
        _eq(g, w)
    buf = staged.buf
    for g, w in zip(TT.stream_view_from_interleaved(buf, tl),
                    JT.stream_view_from_interleaved(jnp.asarray(buf.numpy()),
                                                    tl)):
        _eq(g, w)


def test_build_search_matches_jax(jax_chain):
    """Real code lengths of every table, random (incomplete and
    over-subscribed) lengths up to 15, and code-length-code-like ones."""
    rng = np.random.default_rng(9)
    cases = [(ln, 16, 15) for ln, _ in jax_chain[0]]
    cases.append((rng.integers(0, 16, size=(4, 300)).astype(np.int32), 16, 15))
    cases.append((np.where(rng.random((3, 18)) < 0.5, 0,
                           rng.integers(1, 12, size=(3, 18))).astype(np.int32),
                  9, 9))
    for ln, max_len, bits in cases:
        got = TT.build_search(_t(ln), max_len, bits)
        want = JT.build_search(jnp.asarray(ln), max_len, bits)
        for key in ("first", "limit", "offset", "symdict"):
            _eq(got[key], want[key])


def test_search_decode_every_window(staged, jax_chain):
    """All 2^15 windows through each real code of the batch."""
    outs, _ = jax_chain
    P = staged.buf.shape[1]
    w = np.broadcast_to(np.arange(1 << 15, dtype=np.int32), (P, 1 << 15))
    for ln, _ in outs:
        got_s = TT.build_search(_t(ln), 16, 15)
        want_s = JT.build_search(jnp.asarray(ln), 16, 15)
        gs, gl = TT.search_decode(got_s, _t(w), 16, 15)
        ws, wl = JT.search_decode(want_s, jnp.asarray(w), 16, 15)
        _eq(gs, ws)
        _eq(gl, wl)


def test_load_table_chain_matches_jax(staged, jax_chain):
    outs, jbp = jax_chain
    tl = min(tables_kernel.TABLE_WORDS, staged.buf.shape[0] * 4)
    view, bp0 = TT.stream_view_from_interleaved(staged.buf, tl)
    bp = bp0
    for A, (jln, jtriv) in zip(ALPHABETS, outs):
        ln, triv, bp = TT.load_table(view, bp, A)
        _eq(ln, jln)
        _eq(triv, jtriv)
    _eq(bp - bp0, jbp)
    # the fixture covers every storage mode: trivial codes, and pages
    # whose literal code is not complex
    trivs = np.stack([t for _, t in outs], axis=1)
    assert (trivs >= 0).any() and (trivs < 0).any()


def _jax_packed(jax_chain):
    outs, jbp = jax_chain
    return pack_tables(tables_from_jax(*[ln for ln, _ in outs],
                                       np.stack([t for _, t in outs], axis=1),
                                       jbp))


def test_pack_tables_matches_jax(staged, jax_chain):
    """The packed operands the tables kernel writes (meta, dicts, trivs,
    bp), from the port's plain tables and from the JAX loader's, element
    for element; the batch holds trivial codes and complex codes with
    unused (length-0) symbols, whose dictionary slots stay 0."""
    got = pack_tables(tables_from_lengths(
        *tables_kernel.load_tables_plain(staged.buf)))
    want = _jax_packed(jax_chain)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and g.is_contiguous()
        assert torch.equal(g, w)
    P = staged.buf.shape[1]
    assert got.meta.shape == (P, 3, 3, 17) and got.dicts.shape == (P, 1528)
    assert (got.trivs >= 0).any()
    outs, _ = jax_chain
    lens = np.concatenate([ln for ln, _ in outs], axis=1)
    unused = (lens == 0).sum(axis=1)
    assert (unused > 0).any() and ((got.trivs < 0).all(dim=1).numpy()
                                   & (unused > 0)).any()
    for p in range(P):
        n = 0
        for i, A in enumerate(ALPHABETS):
            used = int((outs[i][0][p] > 0).sum())
            assert not got.dicts[p, n + used:n + A].any()
            n += A
    limit, first, offset = got.meta.unbind(dim=2)
    assert not limit[:, :, 16].any()           # the shift 15 - 16 < 0
    assert not first[:, :, :2].any() and not offset[:, :, :2].any()


def test_tables_wrapper_cpu_route_matches_jax(staged, jax_chain):
    got = tables_kernel.load_tables(staged.buf)
    for g, w in zip(got, _jax_packed(jax_chain)):
        assert torch.equal(g, w)


def test_tables_wrapper_rejects_other_devices(staged):
    with pytest.raises(ValueError):
        tables_kernel.load_tables(staged.buf.to("meta"))
