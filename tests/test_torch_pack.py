"""What the serializer's CUDA kernel (csrc/pack.cu) relies on, held on the
CPU with the plain version (ops/encode_pack.py), which
tests/test_torch_encode.py pins to the JAX package's _pack_jit. No JAX
runs here.

- Bucket independence: one launch packs a whole batch at one command
  bound, where the plain version packs a command bucket at a time, so a
  page's bytes must not depend on the bound.
- The kernel's emission: lane s of a warp owns sub-stream s and appends
  its slots in order through a 64-bit accumulator; a numpy twin of that
  writer equals the plain version's prefix-sum packing, words and bits.
- Edge pages (empty, tail only, a trivial table, four symbols with each
  tsel, a page at the command bound, a stream past its word budget, the
  delta flag) pack and decode with the port's CPU decoder to their input.

tests/test_torch_kernels.py holds the kernel to the plain version on these
pages on the card (tolerance 0).
"""
import numpy as np
import pytest
import torch

from brotlig_tpu_torch import api, native
from brotlig_tpu_torch.format.headers import StreamHeader
from brotlig_tpu_torch.ops import encode as TE
from brotlig_tpu_torch.ops import encode_pack as TP
from brotlig_tpu_torch.ops.encode import assemble
from test_roundtrip import make_data
from test_torch_two_phase import torch_one_thread  # noqa: F401 (autouse)

S = 32768
MAX_CMDS = S // 4 + 16           # the bound both encode tiers pack with
WIDE_CMDS = 4 * S // 4 + 16      # room for the overflow page's commands
OVERFLOW_CMDS = 32700


def _cmds(rows, n: int):
    """[ins, cpy, dist] lists per row -> int64 [P, n] arrays and ncmds."""
    out = [np.zeros((len(rows), n), np.int64) for _ in range(3)]
    for r, cmds in enumerate(rows):
        for k, col in enumerate(cmds):
            out[k][r, :len(col)] = col
    return (*out, np.array([len(c[0]) for c in rows], np.int64))


def _tail_only(alphabet: bytes, counts, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    data = np.repeat(np.frombuffer(alphabet, np.uint8), counts)
    return rng.permutation(data).tobytes()


def edge_pages():
    """{name: (data, [ins, cpy, dist], isdelta)}: the pages the kernel
    must get exactly right besides the matchers' ones."""
    n = MAX_CMDS
    fours = S - 1 - 3 * n                  # copies of 4, the rest of 3
    at_bound = ([1] + [0] * (n - 1), [4] * fours + [3] * (n - fours),
                [1] * n)
    assert sum(at_bound[0]) + sum(at_bound[1]) == S
    rng = np.random.default_rng(11)
    far = rng.integers(1 << 30, (1 << 31) - 1, OVERFLOW_CMDS).tolist()
    return {
        "empty": (b"", ([], [], []), 0),
        "tail_only": (make_data("text", 9000, seed=21), ([], [], []), 0),
        "one_symbol": (b"A" * 5000, ([], [], []), 0),
        "four_flat": (_tail_only(b"acgt", [700] * 4, 1), ([], [], []), 0),
        "four_skew": (_tail_only(b"acgt", [3000, 9, 9, 9], 2),
                      ([], [], []), 0),
        "at_max_cmds": (bytes(S), at_bound, 0),
        "overflow": (make_data("random", S, seed=22),
                     ([0] * OVERFLOW_CMDS, [0] * OVERFLOW_CMDS, far), 0),
        "isdelta": (make_data("structured", S, seed=23), None, 1),
    }


def _batch(datas):
    arr = np.zeros((len(datas), S), np.uint8)
    sizes = np.zeros(len(datas), np.int64)
    for i, d in enumerate(datas):
        arr[i, :len(d)] = np.frombuffer(d, np.uint8)
        sizes[i] = len(d)
    return arr, sizes


def edge_batch():
    """The edge pages as one batch: (names, pages uint8 [P, S], in_sizes,
    ins, cpy, dist, ncmds, isdelta) numpy arrays, WIDE_CMDS command
    columns; the isdelta page takes the fast tier's commands."""
    pages = edge_pages()
    names = list(pages)
    arr, sizes = _batch([pages[k][0] for k in names])
    i = names.index("isdelta")
    fast = TE.find_commands(torch.from_numpy(arr[i:i + 1]),
                            torch.from_numpy(sizes[i:i + 1]), MAX_CMDS,
                            fast=True)
    nf = int(fast[3][0])
    rows = [pages[nm][1] if pages[nm][1] is not None else
            tuple(c[0, :nf].tolist() for c in fast[:3]) for nm in names]
    isdelta = np.array([pages[nm][2] for nm in names], np.int64)
    return (names, arr, sizes, *_cmds(rows, WIDE_CMDS), isdelta)


def mixed_batch():
    """Pages of several command buckets (full text and structured pages,
    a partial and a tiny one, the page at the command bound, the overflow
    page), the delta flag on every other row: (pages, in_sizes, ins, cpy,
    dist, ncmds, isdelta) numpy arrays at WIDE_CMDS columns."""
    names, arr, sizes, ins, cpy, dist, ncmds, _ = edge_batch()
    pick = [names.index(k) for k in ("at_max_cmds", "overflow")]
    datas = [make_data("text", S, seed=1), make_data("structured", S, 1),
             make_data("text", 20000, seed=4), b"Q"]
    marr, msizes = _batch(datas)
    fast = [c.numpy() for c in TE.find_commands(
        torch.from_numpy(marr), torch.from_numpy(msizes), MAX_CMDS,
        fast=True)]
    pad = [np.pad(c, ((0, 0), (0, WIDE_CMDS - MAX_CMDS))) for c in fast[:3]]
    cols = [np.concatenate([p, x[pick]]) for p, x in zip(pad,
                                                         (ins, cpy, dist))]
    return (np.concatenate([marr, arr[pick]]),
            np.concatenate([msizes, sizes[pick]]), *cols,
            np.concatenate([fast[3], ncmds[pick]]),
            np.arange(len(datas) + 2) % 2)


def encode_test_rows():
    """tests/test_torch_encode.py's serializer rows, with no JAX: its
    matcher rows that fit the 2048-command bucket, then its nine bucket
    rows, with the port's fast-tier commands (which that file holds equal
    to the JAX package's) cut to the bucket, the delta flag on every third
    row: (pages, in_sizes, ins, cpy, dist, ncmds, isdelta) numpy arrays."""
    rows = ([make_data(k, S, seed=1) for k in
             ("text", "zeros", "repetitive", "structured", "random")]
            + [make_data("text", 20000, seed=4), b"xyz" * 40, b"Q", b""])
    bucket = [make_data("text", 12000, seed=5),
              make_data("structured", 14000, seed=6),
              make_data("repetitive", S, seed=7),
              make_data("text", 16384, seed=8) + make_data("random", 16384,
                                                           seed=8),
              make_data("structured", 12000, seed=9)
              + make_data("random", S - 12000, seed=9),
              bytes(5000), make_data("random", 3000, seed=3), b"the",
              b"ab" * 9]
    arr, sizes = _batch(rows + bucket)
    cmds = [c.numpy() for c in TE.find_commands(
        torch.from_numpy(arr), torch.from_numpy(sizes), MAX_CMDS,
        fast=True)]
    keep = [i for i, n in enumerate(cmds[3]) if i >= len(rows)
            or n + 2 <= TP.BUCKET_MIN]
    assert len(keep) == 16
    return (arr[keep], sizes[keep],
            *(c[keep, :TP.BUCKET_MIN] for c in cmds[:3]), cmds[3][keep],
            (np.arange(16) % 3 == 1).astype(np.int64))


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


@pytest.fixture(scope="module")
def mixed():
    return mixed_batch()


@pytest.fixture(scope="module")
def edge():
    names, arr, sizes, ins, cpy, dist, ncmds, isdelta = edge_batch()
    out, out_sizes = TP.pack_partitioned(*_t(arr, sizes), S, WIDE_CMDS,
                                         *_t(ins, cpy, dist, ncmds, isdelta))
    return names, arr, sizes, out.numpy(), out_sizes.numpy()


def test_mixed_batch_spans_buckets(mixed):
    ncmds = mixed[5]
    buckets = {TP.command_bucket(int(n), WIDE_CMDS) for n in ncmds}
    assert {2048, 4096, 8192, 16384, 32768} <= buckets


def test_pack_is_bucket_independent_at_the_bound(mixed):
    """pack_pages_device of the whole batch at one bound (what the kernel
    does in one launch) equals pack_partitioned's bucket-by-bucket bytes
    and sizes, overflow page included."""
    arr, sizes, ins, cpy, dist, ncmds, isdelta = mixed
    whole = TP.pack_pages_device(*_t(arr, sizes, ins, cpy, dist, ncmds), S,
                                 WIDE_CMDS, *_t(isdelta))
    parts = TP.pack_partitioned(*_t(arr, sizes), S, WIDE_CMDS,
                                *_t(ins, cpy, dist, ncmds, isdelta))
    assert torch.equal(whole[1], parts[1])
    assert torch.equal(whole[0], parts[0])
    assert int(parts[1][-1]) == S + 1                      # overflow


def write_streams(nbits, vals, wst: int):
    """The kernel's bit writer as numpy: lane s appends stream s's slots
    in order through a 64-bit accumulator, a full 32-bit word at a time,
    words past wst dropped. Returns (words [P, 32, wst], bits [P, 32])."""
    P, nbs, _ = nbits.shape
    words = np.zeros((P, nbs, wst), np.int64)
    bits = np.zeros((P, nbs), np.int64)
    for p in range(P):
        for s in range(nbs):
            acc = nacc = w = 0
            for nb, v in zip(nbits[p, s].tolist(), vals[p, s].tolist()):
                if nb <= 0:
                    continue
                acc |= v << nacc
                nacc += nb
                bits[p, s] += nb
                if nacc >= 32:
                    if w < wst:
                        words[p, s, w] = acc & 0xFFFFFFFF
                    w += 1
                    acc >>= 32
                    nacc -= 32
            if nacc > 0 and w < wst:
                words[p, s, w] = acc
    return words, bits


@pytest.mark.parametrize("case", ["pages", "random", "overflow"])
def test_lane_writer_equals_plain_packing(mixed, case):
    """The lane-per-stream writer equals _stream_words on the plain
    version's slot planes of real pages, on random planes with empty
    slots, and on planes that pass the word budget."""
    if case == "pages":
        arr, sizes, ins, cpy, dist, ncmds, _ = mixed
        keep = [0, 2, 3]
        nbits, vals, _, _ = TP._slot_planes(
            *_t(arr[keep], sizes[keep], ins[keep, :4096], cpy[keep, :4096],
                dist[keep, :4096], ncmds[keep]), S, 4096)
        wst = TP.stream_budget(S)
    else:
        rng = np.random.default_rng(5)
        nb = rng.integers(0, 31, (2, 32, 400))
        nb[rng.random(nb.shape) < 0.3] = 0
        v = rng.integers(0, 1 << 30, nb.shape) & ((1 << nb) - 1)
        nbits, vals = torch.from_numpy(nb), torch.from_numpy(v)
        wst = 40 if case == "overflow" else 400
    want_words, want_bits = TP._stream_words(nbits, vals, wst)
    words, bits = write_streams(nbits.numpy(), vals.numpy(), wst)
    np.testing.assert_array_equal(bits, want_bits.numpy())
    np.testing.assert_array_equal(words, want_words.numpy())
    assert (case == "overflow") == bool((bits > 32 * wst).any())


def test_edge_tables(edge):
    """The literal tables of the tail-only pages take the storage modes
    their names say: trivial, simple with tsel 0 and with tsel 1."""
    names, arr, sizes, _, _ = edge
    want = {"one_symbol": (0, 0, 1), "four_flat": (1, 0, 4),
            "four_skew": (1, 1, 4), "tail_only": (2, 0, None)}
    rows = [names.index(k) for k in want]
    pages = torch.from_numpy(arr[rows]).long()
    valid = torch.arange(S)[None, :] < torch.from_numpy(sizes[rows])[:, None]
    hist = TP._histogram(pages, valid, TP.A_LIT)
    _, mode, _, tsel, count = TP._choose_table(hist, hist.sum(1), TP.A_LIT)
    for i, (m, t, c) in enumerate(want.values()):
        assert (int(mode[i]), int(tsel[i])) == (m, t)
        assert c is None or int(count[i]) == c


@pytest.mark.parametrize("name", list(edge_pages()))
def test_edge_page_decodes(edge, name):
    """Each edge page's blob (compressed, or raw where that is not
    smaller) decodes with api.decode_cpu, in a one-page container, to its
    input; the compressed pages decode with the native page decoder and
    carry their delta flag."""
    names, arr, sizes, out, out_sizes = edge
    i = names.index(name)
    n, sz = int(sizes[i]), int(out_sizes[i])
    blob = TP.page_blobs(out[i:i + 1], out_sizes[i:i + 1], sizes[i:i + 1],
                         arr[i:i + 1])[0]
    data = arr[i, :n].tobytes()
    header = StreamHeader.for_input(n, S, False)
    # an empty input is its stream header alone, as encode writes it
    container = (assemble(header, False, None, [blob]) if n
                 else header.pack())
    assert api.decode_cpu(container) == data
    assert n or blob == b""
    compressed = name not in ("empty", "overflow")
    assert (sz < n) == compressed
    if compressed:
        assert native.decode_page(out[i, :sz].tobytes(), n) == data
        assert (out[i, 0] >> 6) & 1 == (name == "isdelta")
    if name == "overflow":
        assert sz == S + 1
