"""The matcher's kernels (csrc/match.cu) and their formulation, held to the
plain versions (ops/encode.py::find_commands_plain, find_candidates_plain)
with tolerance 0. The plain versions are pinned to the JAX package by
tests/test_torch_encode.py and tests/test_torch_parse_dp.py, so this file
calls no JAX function and compiles no JAX executable.

CPU part: `twin_commands` / `twin_candidates` are numpy renderings of what
the kernels compute, step for step where it differs from the plain
version: keys only where they cover bytes inside the page; the sort as
two stable 8-bit passes (low key byte, then high) over those positions,
whose slots hold uint16 positions up to 64 KiB pages; the probes in
sorted order (slot i's k-th probe is slot i - k while its key is the
same), a common prefix counted to min(cap, room); a family's result per
position as one word, len << 24 | distance, len the winner's full prefix
to 192 bytes continued from the cap (0, never stored, where there is no
probe), and for the candidates its first probes the same way into a row
of 8 words a position, gated and clipped when the row is written; the
fold of the two families' words
with the distance-1 runs from a bitmap of run breaks, each position's
length a uint16 up to 64 KiB pages; the chain extension walked down each
residue class mod 192; and the greedy cover as walks over successors
(found from the lengths as they are walked) in 64 segments that the
true path joins (no jump doubling). Cases: text, structured, random,
all-zero and one-byte-run pages; a short last page with garbage past its
size; a cover past max_cmds; 192-byte-exact chains; 32, 64 and 128 KiB
rows, and an all-zero 128 KiB row, whose one key holds 131,069 positions
(past a 16-bit count).

GPU part (`cuda` marker, skips without a card): the kernels against the
plain version on the same cases, both tiers and the candidates, with the
launches counted, and the wrappers refusing shapes they do not take.

Cold time on one torch thread: ~19 s (this file alone, CPU).
"""
import numpy as np
import pytest
import torch

from brotlig_tpu_torch import _kernels
from brotlig_tpu_torch.ops import encode as TE
from brotlig_tpu_torch.ops import match_kernel as MK
from test_roundtrip import make_data
from test_torch_kernels import cuda_dev  # noqa: F401 (fixture)
from test_torch_two_phase import torch_one_thread  # noqa: F401 (autouse)

M32 = 0xFFFFFFFF
CAPMAX = TE.EXT_ROUNDS * 4 * TE.MAX_MATCH_WORDS       # 192
# key families: bytes a key covers, probes, probes exported as near slots
FAMILIES = ((4, TE.NUM_CANDIDATES, TE.NUM_NEAR),
            (8, TE.NUM_CANDIDATES_8, TE.NUM_NEAR_8), (3, 2, 2))
PAD = CAPMAX + 8
SEGS = 64           # the cover's segment walkers a page (csrc/match.cu)
SMALL_PAGE = 1 << 16   # positions fit uint16 up to here
LEN_SHIFT = 24         # a family's word: len << 24 | distance


# ---------------------------------------------------------------------------
# the kernels' formulation in numpy
# ---------------------------------------------------------------------------

def _keys(b, f: int, n: int):
    """Family f's key at positions [0, n), all inside the page."""
    p = np.arange(n)
    w = [b[p + k].astype(np.uint64) for k in range(8 if f == 1 else 4)]
    if f == 2:
        return ((w[0] | w[1] << 8 | w[2] << 16) * TE.HASH_MUL_8 & M32) >> 16
    h = (w[0] | w[1] << 8 | w[2] << 16 | w[3] << 24) * TE.HASH_MUL & M32
    if f == 1:
        hi = w[4] | w[5] << 8 | w[6] << 16 | w[7] << 24
        h ^= hi * TE.HASH_MUL_8 & M32
    return h >> 16


def _lcp(b, i, c, maxb: int, rem):
    """Common prefix of the suffixes at i and c, counted to min(maxb,
    rem)."""
    lim = np.minimum(maxb, rem)
    m = np.zeros(len(i), np.int64)
    alive = lim > 0
    for j in range(maxb):
        alive &= (j < lim) & (b[i + j] == b[c + j])
        if not alive.any():
            break
        m += alive
    return m


def _sorted_slots(key):
    """The sort's slots: the positions [0, n) after the stable pass by the
    key's low byte and then the stable pass by its high byte."""
    low = np.argsort(key & 255, kind="stable")
    return low[np.argsort(key[low] >> 8, kind="stable")]


def _family(b, S: int, limit: int, f: int, words: int):
    """Family f's probes in sorted order: the word at each position (len
    << 24 | distance, 0 where it has no key or no probe) and its first
    probes [S, near] as prefix << 24 | distance (0 where the prefix is)."""
    L, nprobe, nnear = FAMILIES[f]
    n = max(0, limit - L + 1)
    key = _keys(b, f, n)
    slots = _sorted_slots(key)
    if S <= SMALL_PAGE:
        assert n == 0 or slots.max() < 1 << 16
    skey = key[slots]
    p = slots
    rem = limit - p
    mb = 8 if f == 2 else 4 * words
    fl = np.zeros(n, np.int64)
    fd = np.zeros(n, np.int64)
    near = np.zeros((S, nnear), np.int64)
    i = np.arange(n)
    for k in range(1, nprobe + 1):
        j = np.maximum(i - k, 0)
        ok = (i >= k) & (skey[j] == skey)
        c = slots[j]
        ml = np.zeros(n, np.int64)
        ml[ok] = _lcp(b, p[ok], c[ok], mb, rem[ok])
        if k <= nnear:
            near[p, k - 1] = np.where(ml > 0, ml << LEN_SHIFT | (p - c), 0)
        better = ml > fl
        fl = np.where(better, ml, fl)
        fd = np.where(better, p - c, fd)
    # the winner's full prefix, continued past the cap where it reached it
    full = fl.copy()
    on = (fd > 0) & (fl == mb)
    full[on] = mb + _lcp(b, p[on] + mb, p[on] - fd[on] + mb, CAPMAX - mb,
                         rem[on] - mb)
    word = np.zeros(S, np.int64)
    word[p] = full << LEN_SHIFT | fd
    assert (full < 1 << 8).all() and (fd < 1 << LEN_SHIFT).all()
    return word, near


def _runs(row, limit: int):
    """The distance-1 runs from the run breaks (p = 0, p at or past the
    size, or byte p != byte p - 1): the distance to the next break, 0 at
    a break."""
    S = len(row)
    pos = np.arange(S)
    brk = np.ones(S, bool)
    brk[1:limit] = row[1:limit] != row[:limit - 1]
    nf = np.minimum.accumulate(np.where(brk, pos, S)[::-1])[::-1]
    return np.where(brk, 0, nf - pos)


def _fold(words, run, limit: int, maxb: int):
    """Each position's length and distance before the chain: family 0's
    word, family 1's where its capped prefix is strictly longer, then the
    run where it is strictly longer."""
    S = len(run)
    pos = np.arange(S)
    r0 = np.where(pos + 4 <= limit, words[0], 0)
    r1 = np.where(pos + 8 <= limit, words[1], 0)
    l0, l1 = r0 >> LEN_SHIFT, r1 >> LEN_SHIFT
    second = np.minimum(l1, maxb) > np.minimum(l0, maxb)
    lens = np.where(second, l1, l0)
    dists = np.where(second, r1, r0) & ((1 << LEN_SHIFT) - 1)
    longer = run > lens
    return np.where(longer, run, lens), np.where(longer, 1, dists)


NEAR_AT = (0, 4, 6)   # each family's first word in a row of near probes


def _scan(row, limit: int, rank_words: int, nfam: int):
    """One page: (lens, dists) after the fold, and the rows of near probes
    [S, 8] (4-byte family at 0-2, 8-byte at 4-5, 3-byte at 6-7)."""
    S = len(row)
    b = np.concatenate([row, np.zeros(PAD, np.uint8)])
    fams = [_family(b, S, limit, f, rank_words) for f in range(nfam)]
    lens, dists = _fold([w for w, _ in fams[:2]], _runs(row, limit),
                        limit, 4 * rank_words)
    if S <= SMALL_PAGE:
        assert lens.max(initial=0) < 1 << 16
    near = np.zeros((S, 8), np.int64)
    for at, (_, nr) in zip(NEAR_AT, fams):
        near[:, at:at + nr.shape[1]] = nr
    return lens, dists, near


def _chain(lens, dists, limit: int):
    """Walk each residue class mod 192 downwards: a position holding
    exactly 192 bytes whose continuation at +192 has the same distance
    (and a length) extends to the chain's end."""
    S = len(lens)
    fin = np.zeros(S, np.int64)
    la, da, ca, ta = (np.zeros(CAPMAX, np.int64) for _ in range(4))
    for m in range((S - 1) // CAPMAX, -1, -1):
        p = np.arange(CAPMAX) + CAPMAX * m
        v = p < S
        p = p[v]
        lk, dk = lens[p], dists[p]
        cont = (lk == CAPMAX) & (da[v] == dk) & (la[v] > 0)
        cnt = np.where(cont, ca[v] + 1, 0)
        term = np.where(cont, ta[v], lk)
        fin[p] = np.minimum(CAPMAX * cnt + term, np.maximum(limit - p, 0))
        la[v], da[v], ca[v], ta[v] = lk, dk, cnt, term
    if S <= SMALL_PAGE:
        assert fin.max(initial=0) < 1 << 16
    return fin


def _cover(fin, limit: int, late=None) -> list:
    """The greedy cover's nodes (match starts) as the finish kernel lists
    them: walker k follows the successors (the first taken position at or
    after a node's end) from the first taken position of its segment to
    the first past it; the true path, from the first taken position,
    follows each segment's walker from the first of its nodes it reaches
    (at once when it enters at the walker's start). late, a list, gets
    the nodes the true path took in each segment before it joined."""
    S = len(fin)
    pos = np.arange(S)
    tpos = np.flatnonzero((fin >= TE.MIN_MATCH) & (pos + fin <= limit))

    def first_at(j):
        k = np.searchsorted(tpos, j)
        return int(tpos[k]) if k < len(tpos) else S

    def succ(i):
        return first_at(i + int(fin[i]))
    seg = -(-S // SEGS)
    walkers, exits = [], []
    for k in range(SEGS):
        x, nodes = first_at(k * seg), []
        while x < min(S, (k + 1) * seg):
            nodes.append(x)
            x = succ(x)
        walkers.append(nodes)
        exits.append(x)
    t, out = first_at(0), []
    for k in range(SEGS):
        on, before = set(walkers[k]), len(out)
        while t < min(S, (k + 1) * seg) and t not in on:
            out.append(t)
            t = succ(t)
        if late is not None:
            late.append(len(out) - before)
        if t < min(S, (k + 1) * seg):
            out += walkers[k][walkers[k].index(t):]
            t = exits[k]
    return out


def twin_commands(arr, sizes, max_cmds: int, fast: bool = False):
    """find_commands as the kernels compute it: numpy (ins, cpy, dist,
    ncmds), int32."""
    P, S = arr.shape
    out = [np.zeros((P, max_cmds), np.int32) for _ in range(3)]
    ncmds = np.zeros(P, np.int32)
    words = TE.FAST_PROBE_WORDS if fast else TE.MAX_MATCH_WORDS
    for r in range(P):
        limit = min(max(int(sizes[r]), 0), S)
        lens, dists, _ = _scan(arr[r], limit, words, 2)
        fin = _chain(lens, dists, limit)
        end = 0
        nodes = _cover(fin, limit)[:max_cmds]
        for n, i in enumerate(nodes):
            out[0][r, n], out[1][r, n], out[2][r, n] = (i - end, fin[i],
                                                        dists[i])
            end = i + int(fin[i])
        ncmds[r] = len(nodes)
    return (*out, ncmds)


def twin_candidates(arr, sizes, cap: int):
    """find_candidates as the kernels compute it: numpy (cand_len,
    cand_dist) [P, S, 8] int32."""
    P, S = arr.shape
    cl = np.zeros((P, S, 8), np.int32)
    cd = np.zeros((P, S, 8), np.int32)
    for r in range(P):
        limit = min(max(int(sizes[r]), 0), S)
        lens, dists, near = _scan(arr[r], limit, TE.MAX_MATCH_WORDS, 3)
        words = near[:, [0, 1, 2, 4, 5, 6, 7]]   # slots 1-7
        ml = words >> LEN_SHIFT
        slots = np.minimum(np.concatenate([_chain(lens, dists, limit)[:, None],
                                           ml[:, :5]], axis=1), cap)
        cl[r, :, :6] = np.where(slots >= TE.MIN_MATCH, slots, 0)
        cl[r, :, 6:] = np.minimum(np.where(ml[:, 5:] >= 2, ml[:, 5:], 0), cap)
        cd[r, :, 0] = dists
        cd[r, :, 1:] = words & ((1 << LEN_SHIFT) - 1)
    return cl, cd


# ---------------------------------------------------------------------------
# cases
# ---------------------------------------------------------------------------

SMALL = 4096


def _chain_row(S: int, seed: int):
    """A page of 192-byte blocks repeated (matches of exactly 192 bytes
    that chain at one distance) with two breaks, after a random head."""
    rng = np.random.default_rng(seed)
    blk = rng.integers(0, 256, CAPMAX, dtype=np.uint8)
    row = np.concatenate([rng.integers(0, 256, 100, dtype=np.uint8)]
                         + [blk] * (S // CAPMAX + 1))[:S]
    row[S // 2] ^= 3
    row[S // 3 + 5] ^= 0x40
    return row


def case(name: str):
    """(pages uint8 [P, S], in_sizes int32 [P], max_cmds or None)."""
    rng = np.random.default_rng(len(name))
    if name in ("text", "structured", "random", "zeros"):
        arr = np.frombuffer(make_data(name, 2 * SMALL, seed=3), np.uint8)
        return arr.reshape(2, SMALL).copy(), np.full(2, SMALL, np.int32), None
    if name == "one_byte_run":
        arr = np.full((2, SMALL), 7, np.uint8)
        arr[1, 1000:1100] = 9
        return arr, np.full(2, SMALL, np.int32), None
    if name == "short_last_page":
        arr = rng.integers(0, 256, (2, SMALL), dtype=np.uint8)
        arr[0] = np.frombuffer(make_data("text", SMALL, seed=5), np.uint8)
        arr[1, :2501] = np.frombuffer(make_data("text", 2501, seed=6),
                                      np.uint8)
        return arr, np.array([SMALL, 2501], np.int32), None
    if name == "over_max_cmds":
        arr = np.frombuffer(make_data("text", 2 * SMALL, seed=7), np.uint8)
        return arr.reshape(2, SMALL).copy(), np.full(2, SMALL, np.int32), 37
    if name == "chain_192":
        arr = np.stack([_chain_row(2 * SMALL, 8), _chain_row(2 * SMALL, 9)])
        return arr, np.array([2 * SMALL, 2 * SMALL - 77], np.int32), None
    if name == "zeros_128k":
        return np.zeros((1, 1 << 17), np.uint8), np.full(1, 1 << 17,
                                                         np.int32), None
    S = {"rows_32k": 1 << 15, "rows_64k": 1 << 16, "rows_128k": 1 << 17}[name]
    arr = np.frombuffer(make_data("text", S, seed=S), np.uint8)[None].copy()
    return arr, np.full(1, S, np.int32), None


CASES = ("text", "structured", "random", "zeros", "one_byte_run",
         "short_last_page", "over_max_cmds", "chain_192", "rows_32k",
         "rows_64k", "rows_128k", "zeros_128k")


def bound(S: int, fast: bool, max_cmds) -> int:
    return max_cmds or (S // 4 + 16 if fast else S // 2 + 2)


def plain_commands(arr, sizes, max_cmds: int, fast: bool):
    return [x.numpy() for x in TE.find_commands_plain(
        torch.from_numpy(arr), torch.from_numpy(sizes), max_cmds, fast)]


def plain_candidates(arr, sizes, cap: int):
    return [x.numpy() for x in TE.find_candidates_plain(
        torch.from_numpy(arr), torch.from_numpy(sizes), cap)]


# ---------------------------------------------------------------------------
# CPU: the twin against the plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("name", CASES)
def test_twin_commands_equal_plain(name, fast):
    arr, sizes, mc = case(name)
    mc = bound(arr.shape[1], fast, mc)
    got = twin_commands(arr, sizes, mc, fast)
    want = plain_commands(arr, sizes, mc, fast)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if name == "over_max_cmds":
        assert (got[3] == mc).all()


@pytest.mark.parametrize("name", [c for c in CASES if "128k" not in c])
def test_twin_candidates_equal_plain(name):
    arr, sizes, _ = case(name)
    cap = 100 if name == "chain_192" else 512
    got = twin_candidates(arr, sizes, cap)
    want = plain_candidates(arr, sizes, cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", ["text", "rows_64k", "zeros_128k",
                                  "structured", "random", "one_byte_run",
                                  "rows_32k", "rows_128k"])
def test_sort_passes_equal_stable_sort(name):
    """The two 8-bit passes give a stable sort by the whole key: each
    key's positions in ascending order. On the all-zero 128 KiB row one
    key holds 131,069 positions, past what a uint16 count or slot holds,
    so 128 KiB pages keep uint32 slots."""
    arr, sizes, _ = case(name)
    b = np.concatenate([arr[0], np.zeros(PAD, np.uint8)])
    key = _keys(b, 0, int(sizes[0]) - 3)
    slots = _sorted_slots(key)
    np.testing.assert_array_equal(slots, np.argsort(key, kind="stable"))
    hot = np.bincount(key.astype(np.int64)).max()
    assert (hot == (1 << 17) - 3) == (name == "zeros_128k")
    assert (hot > 0xFFFF) == (name == "zeros_128k")


def test_chain_case_chains():
    """The chain case exercises what it is for: positions whose match
    extends past 192 bytes at one distance, and a break that ends one."""
    arr, sizes, _ = case("chain_192")
    lens, dists, _ = _scan(arr[0], int(sizes[0]), TE.MAX_MATCH_WORDS, 2)
    fin = _chain(lens, dists, int(sizes[0]))
    chained = (lens == CAPMAX) & (fin > CAPMAX)
    assert chained.sum() > 1000 and (fin[chained] < arr.shape[1]).all()


def test_cover_joins_walkers_late():
    """The text rows exercise the cover's repair: segments where the true
    path enters off its walker's path and joins it only later."""
    arr, sizes, _ = case("rows_64k")
    lens, dists, _ = _scan(arr[0], int(sizes[0]), TE.MAX_MATCH_WORDS, 2)
    late = []
    _cover(_chain(lens, dists, int(sizes[0])), int(sizes[0]), late)
    assert len(late) == SEGS and sum(x > 0 for x in late) >= SEGS // 4


def test_wrappers_refuse_bad_shapes():
    """The wrappers check shapes before they touch a device."""
    ok = torch.zeros((2, 64), dtype=torch.uint8)
    sizes = torch.full((2,), 64)
    for pages, in_sizes in ((torch.zeros((2, 62), dtype=torch.uint8), sizes),
                            (torch.zeros((2, 1 << 18), dtype=torch.uint8),
                             sizes),
                            (ok.to(torch.int32), sizes),
                            (ok[0], sizes[:1]),
                            (ok, sizes[:1])):
        with pytest.raises(ValueError):
            MK.find_commands_cuda(pages, in_sizes, 10)
        with pytest.raises(ValueError):
            MK.find_candidates_cuda(pages, in_sizes, 512)
    with pytest.raises(ValueError):
        MK.find_commands_cuda(ok, sizes, 0)


# ---------------------------------------------------------------------------
# GPU: the kernels against the plain version
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_match_kernels_equal_plain(cuda_dev, name):  # noqa: F811
    arr, sizes, mc = case(name)
    pages = torch.from_numpy(arr).to(cuda_dev)
    in_sizes = torch.from_numpy(sizes).to(cuda_dev)
    _kernels.reset_launches()
    for fast in (False, True):
        n = bound(arr.shape[1], fast, mc)
        got = TE.find_commands(pages, in_sizes, n, fast)
        for g, w in zip(got, plain_commands(arr, sizes, n, fast)):
            np.testing.assert_array_equal(g.cpu().numpy(), w)
    for cap in (512, 100):
        got = TE.find_candidates(pages, in_sizes, cap)
        for g, w in zip(got, plain_candidates(arr, sizes, cap)):
            np.testing.assert_array_equal(g.cpu().numpy(), w)
    assert _kernels.LAUNCHES["match"] == 4 * MK.LAUNCHES_PER_CALL


@pytest.mark.cuda
def test_match_wrappers_refuse_bad_shapes_on_card(cuda_dev):  # noqa: F811
    sizes = torch.full((2,), 64, device=cuda_dev)
    for pages in (torch.zeros((2, 62), dtype=torch.uint8, device=cuda_dev),
                  torch.zeros((2, 64), dtype=torch.int32, device=cuda_dev),
                  torch.zeros((3, 64), dtype=torch.uint8, device=cuda_dev)):
        with pytest.raises(ValueError):
            TE.find_commands(pages, sizes, 10)
        with pytest.raises(ValueError):
            TE.find_candidates(pages, sizes, 512)
    none = torch.zeros((0, 64), dtype=torch.uint8, device=cuda_dev)
    _kernels.reset_launches()
    got = TE.find_commands(none, sizes[:0], 10)
    assert got[0].shape == (0, 10) and _kernels.LAUNCHES["match"] == 0
