"""The port's encoders (ops/encode.py, ops/encode_pack.py) held to the JAX
package's on the CPU, with tolerance 0: the command arrays of both
matcher tiers, the serializer's page bytes and sizes, the page blobs, and
the hybrid and full-device streams.

The JAX encoders are XLA only (no Pallas kernel), and each distinct
argument shape compiles an executable, 20-40 s each on the CPU. The file
compiles three, so every JAX call below has one of these shapes:

1. find_commands, exact tier: [9, S] pages, max_cmds S//2+2, called with
   three arguments as encode_stream_tpu calls it (the hybrid stream of
   nine pages reuses it);
2. find_commands, fast tier: [9, S], S//4+16, fast=True, as
   encode_pages_device calls it (every 9-row page batch reuses it);
3. _pack_jit at the 2048-command bucket with 16 rows, the group
   _pack_partitioned forms from 9..16 pages of that bucket: the serializer
   test calls it directly, and encode_pages_device and
   encode_stream_tpu_full reach it with nine pages that all fit the
   bucket (a page with more commands would compile another bucket; the
   tests check that none has).

Full text and structured pages have more commands than the 2048 bucket
holds, so they are compared through both matcher tiers and the hybrid
stream; tests/test_torch_encode_api.py packs them on the port alone (bucket
independence, round trips).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from brotlig_tpu.ops import encode as JE
from brotlig_tpu.ops import encode_pack as JP
from brotlig_tpu_torch import native
from brotlig_tpu_torch.ops import encode as TE
from brotlig_tpu_torch.ops import encode_pack as TP
from test_roundtrip import make_data
from test_torch_two_phase import torch_one_thread  # noqa: F401 (autouse)

S = 32768
EXACT_CMDS = S // 2 + 2
FAST_CMDS = S // 4 + 16
BUCKET = TP.BUCKET_MIN


def _rows():
    """The matcher rows: full pages of each kind, a partial page, tiny
    rows and an empty one."""
    return ([make_data(k, S, seed=1) for k in
             ("text", "zeros", "repetitive", "structured", "random")]
            + [make_data("text", 20000, seed=4), b"xyz" * 40, b"Q", b""])


def _bucket_rows():
    """Nine rows whose fast-tier commands fit the 2048 bucket: mixed
    pages, partial pages, short and tiny rows."""
    return [make_data("text", 12000, seed=5),
            make_data("structured", 14000, seed=6),
            make_data("repetitive", S, seed=7),
            make_data("text", 16384, seed=8) + make_data("random", 16384,
                                                         seed=8),
            make_data("structured", 12000, seed=9)
            + make_data("random", S - 12000, seed=9),
            bytes(5000), make_data("random", 3000, seed=3), b"the",
            b"ab" * 9]


def _full_stream():
    """Nine 32 KiB pages, the last one partial, each within the 2048
    bucket."""
    pages = _bucket_rows()[2:5] + [
        bytes(S), make_data("random", S, seed=2),
        make_data("text", 12000, seed=10) + make_data("random", S - 12000,
                                                      seed=10),
        make_data("repetitive", S, seed=11),
        make_data("structured", 14000, seed=12) + bytes(S - 14000)]
    return b"".join(pages) + make_data("text", 20000, seed=13)


def _hybrid_stream():
    """Nine 32 KiB pages, the last one partial: every kind of full page."""
    return (b"".join(make_data(k, S, seed=s) for k, s in (
        ("text", 1), ("zeros", 1), ("repetitive", 1), ("structured", 1),
        ("random", 1), ("text", 2), ("structured", 3), ("repetitive", 4)))
        + make_data("text", 20000, seed=4))


def _batch(rows):
    arr = np.zeros((len(rows), S), np.uint8)
    sizes = np.zeros(len(rows), np.int32)
    for i, r in enumerate(rows):
        arr[i, :len(r)] = np.frombuffer(r, np.uint8)
        sizes[i] = len(r)
    return arr, sizes


def _jax_find(arr, sizes, *args):
    return tuple(np.asarray(x) for x in
                 JE.find_commands(jnp.asarray(arr), jnp.asarray(sizes),
                                  *args))


def _torch_find(arr, sizes, max_cmds, fast):
    return tuple(x.numpy() for x in TE.find_commands(
        torch.from_numpy(arr), torch.from_numpy(sizes), max_cmds, fast))


@pytest.fixture(scope="module")
def rows():
    return _batch(_rows())


@pytest.fixture(scope="module")
def exact(rows):
    """(JAX, port) exact-tier commands of the matcher rows."""
    return (_jax_find(*rows, EXACT_CMDS),
            _torch_find(*rows, EXACT_CMDS, False))


@pytest.fixture(scope="module")
def fast(rows):
    """(JAX, port) fast-tier commands of the matcher rows."""
    return (_jax_find(*rows, FAST_CMDS, True),
            _torch_find(*rows, FAST_CMDS, True))


@pytest.fixture(scope="module")
def pack(rows, fast):
    """The serializer on 16 rows at the 2048 bucket (the matcher rows
    that fit it, then the bucket rows), isdelta set on every third row:
    (JAX (out, sizes), port (out, sizes), the rows' commands)."""
    keep = [i for i, n in enumerate(fast[0][3]) if n + 2 <= BUCKET]
    barr, bsizes = _batch(_bucket_rows())
    bcmds = _jax_find(barr, bsizes, FAST_CMDS, True)
    arr = np.concatenate([rows[0][keep], barr])
    sizes = np.concatenate([rows[1][keep], bsizes])
    cmds = [np.concatenate([c[keep], b])[:, :BUCKET] if c.ndim == 2
            else np.concatenate([c[keep], b])
            for c, b in zip(fast[0], bcmds)]
    assert len(arr) == 16 and max(cmds[3]) + 2 <= BUCKET
    isdelta = (np.arange(16) % 3 == 1).astype(np.int32)
    want = JP._pack_jit(jnp.asarray(arr), jnp.asarray(sizes), S, BUCKET,
                        *(jnp.asarray(c) for c in cmds),
                        jnp.asarray(isdelta))
    got = TP.pack_pages_device(
        torch.from_numpy(arr), torch.from_numpy(sizes),
        *(torch.from_numpy(c) for c in cmds), S, BUCKET,
        torch.from_numpy(isdelta))
    return ((np.asarray(want[0]), np.asarray(want[1])),
            (got[0].numpy(), got[1].numpy()), (arr, sizes, cmds))


@pytest.mark.parametrize("row", range(len(_rows())))
def test_find_commands_exact_tier_matches_jax(exact, row):
    want, got = exact
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g[row], w[row])


@pytest.mark.parametrize("row", range(len(_rows())))
def test_find_commands_fast_tier_matches_jax(fast, row):
    want, got = fast
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g[row], w[row])


def test_find_commands_edge_rows(exact, fast):
    """The empty and 1-byte rows have no command; a run of zeros is one
    distance-1 copy; the tiers differ on the full text page."""
    for want, _ in (exact, fast):
        nc = want[3]
        assert nc[7] == 0 and nc[8] == 0
        assert nc[1] == 1 and want[2][1, 0] == 1
    assert not np.array_equal(exact[0][3], fast[0][3])


@pytest.mark.parametrize("row", range(16))
def test_pack_pages_matches_jax(pack, row):
    (w_out, w_sz), (g_out, g_sz), _ = pack
    assert int(g_sz[row]) == int(w_sz[row])
    np.testing.assert_array_equal(g_out[row], w_out[row])


def test_packed_pages_decode(pack):
    """Every page the serializer made smaller decodes to its row, with
    its delta flag in the page header."""
    _, (out, sizes), (arr, in_sizes, _) = pack
    for i in range(16):
        n, sz = int(in_sizes[i]), int(sizes[i])
        if sz < n:
            assert ((out[i, 0] >> 6) & 1) == (i % 3 == 1)
            assert native.decode_page(out[i, :sz].tobytes(), n) == \
                arr[i, :n].tobytes()


def test_encode_pages_device_matches_jax():
    """Blobs of nine pages, isdelta on some and a raw form unlike the
    pages, so that raw pages show which bytes they store."""
    arr, sizes = _batch(_bucket_rows())
    raw = arr ^ np.uint8(0x5A)
    isdelta = np.array([1, 0, 1, 0, 0, 1, 0, 0, 1], np.int32)
    want = JP.encode_pages_device(arr, sizes, S, isdelta, raw, quality=1)
    got = TP.encode_pages_device(arr, sizes, S, isdelta, raw, quality=1,
                                 device="cpu")
    assert got == want
    assert any(len(b) == n for b, n in zip(got, sizes))   # a raw page


def test_hybrid_stream_matches_jax():
    data = _hybrid_stream()
    want = JE.encode_stream_tpu(data, page_size=S)
    got = TE.encode_stream(data, page_size=S, device="cpu")
    assert got == want
    assert native.decode(got) == data


def test_full_stream_matches_jax(monkeypatch):
    data = _full_stream()
    packed = []

    def pack(*args):
        packed.append(args[7])                  # ncmds of the batch
        return pack_partitioned(*args)
    pack_partitioned = TP.pack_partitioned
    monkeypatch.setattr(TP, "pack_partitioned", pack)
    got = TP.encode_stream_full(data, page_size=S, quality=1, device="cpu")
    # nine pages, all within the 2048 bucket (one JAX executable)
    assert len(packed) == 1 and len(packed[0]) == 9
    assert int(packed[0].max()) + 2 <= BUCKET
    want = JP.encode_stream_tpu_full(data, page_size=S, quality=1)
    assert got == want
    assert native.decode(got) == data
