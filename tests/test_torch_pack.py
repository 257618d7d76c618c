"""What the serializer's CUDA kernel (csrc/pack.cu) relies on, held on the
CPU with the plain version (ops/encode_pack.py), which
tests/test_torch_encode.py pins to the JAX package's _pack_jit. No JAX
runs here.

- Bucket independence: one launch packs a whole batch at one command
  bound, where the plain version packs a command bucket at a time, so a
  page's bytes must not depend on the bound.
- The kernel's bit packing: pass A sums the widths of contiguous shares
  of each stream's slots under the slot cap, a scan over the shares gives
  their bit offsets, the header follows from the stream totals, and pass
  B ORs every share, a 64-bit accumulator at a time, into a page image
  at its stream's byte offset, or, where a stream passes its word budget
  (or the padding reads past the last stream's words), into per-stream
  words assembled byte by byte. A numpy twin of that scheme equals the
  plain version's pages, bytes and sizes.
- The page with more grid-search keys than the kernel's shared-memory
  sort holds (tests/test_torch_kernels.py packs it on the card) replays
  to its data and packs and decodes on the CPU.
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


def _bitlen(x: int) -> int:
    return int(x).bit_length()


def _header(bits, byte0: int):
    """The page header and size table from the 32 stream bit counts (the
    fixed point): (header bytes, stream bytes)."""
    sb = [(b + 7) // 8 for b in bits]
    tot, mn = sum(sb), min(sb)
    delta_bits = max(1, max(_bitlen(x - mn) for x in sb))
    est = 4 + tot
    for _ in range(6):
        base_bits = _bitlen((est + 31) // 32)
        dbs_bits = _bitlen(_bitlen(max(est - 1, 1)))
        est = ((8 + base_bits + dbs_bits + 32 * delta_bits + 7) // 8
               + 3) // 4 * 4 + tot
    acc = at = 0
    for nb, v in ([(8, byte0), (base_bits, mn), (dbs_bits, delta_bits)]
                  + [(delta_bits, x - mn) for x in sb]):
        acc |= (v & ((1 << nb) - 1)) << at
        at += nb
    return acc.to_bytes((at + 31) // 32 * 4, "little"), sb


def _or_slots(words, limit: int, at: int, nbits, vals) -> None:
    """Pass B's writer: slots LSB first from bit `at` through a 64-bit
    accumulator, each 32-bit word ORed in once; words past limit
    dropped."""
    w, nacc, acc = at >> 5, at & 31, 0
    for nb, v in zip(nbits.tolist(), vals.tolist()):
        if nb <= 0:
            continue
        acc |= v << nacc
        nacc += nb
        if nacc >= 32:
            if w < limit:
                words[w] |= acc & 0xFFFFFFFF
            w += 1
            acc >>= 32
            nacc -= 32
    if nacc > 0 and w < limit:
        words[w] |= acc & 0xFFFFFFFF


def share_pack(nbits, vals, tb_cols: int, edyn: int, byte0: int,
               page_size: int, shares: int = 16):
    """The kernel's bit packing and assembly of one page as numpy, from
    its slot planes nbits/vals [32, K]: tb_cols table-block columns, then
    dynamic slots e = 0, 1, ..., those at e >= edyn dropped (the cap).
    Returns (out uint8 [page_size], out size, took the words branch)."""
    nb = nbits.copy()
    nb[:, tb_cols + edyn:] = 0
    dyn = nb.shape[1] - tb_cols
    per = -(-dyn // shares)
    cuts = [0] + [tb_cols + min(k * per, dyn) for k in range(1, shares + 1)]
    # pass A, then the scan over the shares (the table block leads share 0)
    share_bits = np.array([[int(nb[s, cuts[k]:cuts[k + 1]].sum())
                            for k in range(shares)] for s in range(32)])
    offs = np.cumsum(share_bits, axis=1) - share_bits
    bits = share_bits.sum(1).tolist()
    hdr, sb = _header(bits, byte0)
    tot = sum(sb)
    sbp = np.concatenate([[0], np.cumsum(sb)]).tolist()
    pay_end = (tot + 3) // 4 * 4
    wst = TP.stream_budget(page_size)
    overflow = max(bits) > 32 * wst
    spill = overflow or (pay_end > tot and sb[31] + pay_end - tot - 1
                         >= 4 * wst)
    out = np.zeros(page_size, np.uint8)
    if not spill:
        img = [int.from_bytes(hdr[i:i + 4], "little")
               for i in range(0, len(hdr), 4)]
        img += [0] * (page_size // 4 - len(img))
        for s in range(32):
            for k in range(shares):
                _or_slots(img, page_size // 4,
                          8 * (len(hdr) + sbp[s]) + int(offs[s, k]),
                          nb[s, cuts[k]:cuts[k + 1]],
                          vals[s, cuts[k]:cuts[k + 1]])
        out[:] = np.array(img, np.uint32).view(np.uint8)
    else:
        words = [[0] * wst for _ in range(32)]
        for s in range(32):
            for k in range(shares):
                _or_slots(words[s], wst, int(offs[s, k]),
                          nb[s, cuts[k]:cuts[k + 1]],
                          vals[s, cuts[k]:cuts[k + 1]])
        flat = [x for row in words for x in row]
        for b in range(min(page_size, len(hdr) + pay_end)):
            if b < len(hdr):
                out[b] = hdr[b]
                continue
            pay = b - len(hdr)
            s = min(max(i for i in range(33) if sbp[i] <= pay), 31)
            inb = pay - sbp[s]
            wi = min(s * wst + (inb >> 2), 32 * wst - 1)
            out[b] = (flat[wi] >> (8 * (inb & 3))) & 0xFF
    size = page_size + 1 if overflow else len(hdr) + pay_end
    return out, size, spill


def _planes_of(arr, sizes, ins, cpy, dist, ncmds, isdelta, S: int,
               bound: int):
    """One page's plain slot planes and what share_pack needs beside
    them: (nbits [32, K], vals, table-block columns, edyn, header byte)."""
    nb, vv, h_np, h_nd = TP._slot_planes(
        *_t(arr, sizes, ins, cpy, dist, ncmds), S, bound)
    R = (bound + 2 + 31) // 32
    edyn = 6 * R + (S + 64) // 32 + 2
    byte0 = int(h_np[0]) | int(h_nd[0]) << 2 | int(isdelta[0]) << 6
    return (nb[0].numpy(), vv[0].numpy(), nb.shape[2] - edyn, edyn, byte0)


def _random_planes(case: str, rng):
    """Slot planes [32, K] with zero-width slots: "random" (20 table-block
    columns, the last 30 past the cap), "overflow" (streams past their
    words), "pad_read" (stream 31 one byte short of its words, the
    padding after it two bytes or more, so the plain assembly reads it
    from stream 31's last word)."""
    wst = TP.stream_budget(S)
    if case == "pad_read":
        nb = np.zeros((32, 4 * wst - 1), np.int64)
        nb[31] = 8
        nb[:31, :10] = 8
        v = rng.integers(0, 256, nb.shape)
        return nb, v, 0, nb.shape[1]
    k = 400 if case == "random" else 3000
    nb = rng.integers(0, 31, (32, k))
    nb[rng.random(nb.shape) < 0.3] = 0
    v = rng.integers(0, 1 << 30, nb.shape) & ((1 << nb) - 1)
    return nb, v, 20, k - 20 - (30 if case == "random" else 0)


CORPUS_128K = 131072


@pytest.mark.parametrize("case", ["pages", "random", "overflow", "pad_read",
                                  "page_128k", "past_page"])
def test_share_writer_equals_plain_assembly(mixed, monkeypatch, case):
    """share_pack, the kernel's passes A and B, equals pack_pages_plain's
    bytes and size: on real pages (three of the mixed batch at the 4096
    bound, a 128 KiB corpus page, a page of random bytes whose streams pass
    the page size without overflowing) and on random slot planes given to
    pack_pages_plain in place of its own (the slot cap, an overflow, the
    padding read from stream 31's last word)."""
    rng = np.random.default_rng(5)
    if case in ("pages", "page_128k", "past_page"):
        if case == "pages":
            arr, sizes, ins, cpy, dist, ncmds, isdelta = mixed
            keep, page, bound = [0, 2, 3], S, 4096
            ops = [arr[keep], sizes[keep]] + [
                x[keep, :bound] for x in (ins, cpy, dist)] + [
                ncmds[keep], isdelta[keep]]
        else:
            from brotlig_tpu_torch.utils.corpus import corpus
            page = CORPUS_128K if case == "page_128k" else S
            bound = page // 4 + 16
            data = (corpus(1, page=page) if case == "page_128k"
                    else make_data("random", page, seed=8))
            arr, sizes = np.frombuffer(data, np.uint8)[None].copy(), \
                np.array([page], np.int64)
            cmds = [c.numpy() for c in TE.find_commands(
                torch.from_numpy(arr), torch.from_numpy(sizes), bound,
                fast=True)]
            ops = [arr, sizes, *cmds, np.array([1])]
        out, sizes_w = TP.pack_pages_plain(*_t(*ops[:6]), page, bound,
                                           *_t(ops[6]))
        for i in range(out.shape[0]):
            one = [x[i:i + 1] for x in ops]
            got, size, spill = share_pack(*_planes_of(*one, page, bound),
                                          page)
            assert not spill
            assert size == int(sizes_w[i])
            np.testing.assert_array_equal(got, out[i].numpy())
        if case == "past_page":
            assert int(sizes_w[0]) > page + 1   # past it, no overflow
        return
    nb, v, tb_cols, edyn = _random_planes(case, rng)
    byte0 = 0x65                         # npostfix 1, ndist 9, isdelta
    got, size, spill = share_pack(nb, v, tb_cols, edyn, byte0, S)
    keep = tb_cols + edyn
    monkeypatch.setattr(TP, "_slot_planes", lambda *a: (
        torch.from_numpy(nb[None, :, :keep]),
        torch.from_numpy(v[None, :, :keep]),
        torch.tensor([byte0 & 3]), torch.tensor([(byte0 >> 2) & 15])))
    zero = torch.zeros((1, 1), dtype=torch.int64)
    out, sizes_w = TP.pack_pages_plain(
        torch.zeros((1, S), dtype=torch.uint8), torch.tensor([S]), zero,
        zero, zero, torch.tensor([0]), S, 1, torch.tensor([1]))
    assert spill == (case != "random")
    assert (size == S + 1) == (case == "overflow")
    assert size == int(sizes_w[0])
    np.testing.assert_array_equal(got, out[0].numpy())


def many_keys_page(seed: int = 31):
    """A 128 KiB page of 32,784 commands (the most a 128 KiB page packs
    under) whose copies of 3 and 4 bytes take distances from 17 to 400,
    none equal to one of the four before it: every command is a grid
    search key, more than the 2^15 the kernel's shared-memory sort holds
    at that page size. (data, ins, cpy, dist) with the data made by
    replaying the commands after 4096 random literals."""
    rng = np.random.default_rng(seed)
    n, lead = CORPUS_128K // 4 + 16, 4096
    cpy = np.full(n, 4, np.int64)
    cpy[rng.choice(n, 4 * n - (CORPUS_128K - lead), replace=False)] = 3
    ins = np.zeros(n, np.int64)
    ins[0] = lead
    dist = np.zeros(n, np.int64)
    last = [4, 11, 15, 16]
    for j in range(n):
        d = int(rng.integers(17, 401))
        while d in last:
            d = int(rng.integers(17, 401))
        dist[j] = d
        last = last[1:] + [d]
    buf = bytearray(rng.integers(0, 256, lead, dtype=np.uint8).tobytes())
    for c, d in zip(cpy.tolist(), dist.tolist()):
        for _ in range(c):
            buf.append(buf[-d])
    assert len(buf) == CORPUS_128K
    return bytes(buf), ins, cpy, dist


def test_many_keys_page_packs_and_decodes():
    """The many-keys page: its commands cover it exactly, and the plain
    version packs it into a compressed page that decodes with the port's
    CPU decoder (the card's kernel sorts its keys in device memory)."""
    data, ins, cpy, dist = many_keys_page()
    assert int(ins.sum() + cpy.sum()) == CORPUS_128K
    assert len(dist) > 1 << 15
    arr = np.frombuffer(data, np.uint8)[None].copy()
    sizes = np.array([CORPUS_128K])
    out, out_sizes = TP.pack_partitioned(
        *_t(arr, sizes), CORPUS_128K, len(dist),
        *_t(ins[None], cpy[None], dist[None], np.array([len(dist)]),
            np.array([0])))
    sz = int(out_sizes[0])
    assert sz < CORPUS_128K
    header = StreamHeader.for_input(CORPUS_128K, CORPUS_128K, False)
    blob = out[0, :sz].numpy().tobytes()
    assert api.decode_cpu(assemble(header, False, None, [blob])) == data


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
