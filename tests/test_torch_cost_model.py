"""The q11 cost model's kernels (csrc/cost_model.cu) and their formulation,
held to the plain version (ops/parse_dp.py::build_cost_model_plain) with
tolerance 0. The plain version is pinned to the JAX package by
tests/test_torch_parse_dp.py, so this file calls no JAX function and
compiles no JAX executable.

CPU part: `twin_model` is a numpy rendering of what the kernels compute
with c CTAs a page, step for step where it differs from the plain
version: the (npostfix, ndirect) grid search from per-distance key counts
in c slices, priced in c equal shares of the present distances joined by
carries, keys past the slices in a sorted side list (`grid_costs`, whose
16 costs are also held to the plain version's runs over the sorted
keys); the literal histogram counted from each CTA's
share of the cover, with no literal queue (`literal_hist_cover`); the
covering command found once a tile of 2048 positions, then in the tile's
slice of the starts (`_covering_tiles`); the ring probes four bytes a
compare, the source as aligned words with a funnel shift
(`_probe_words`); half-bit cost tables (twice a used symbol's code
length, the unseen cost otherwise) in place of float32 gathers; the ring
before each command as the kernel's list of pushed values; the lowest
ring code by a first-match loop. The command and distance histograms and
the code lengths come from the serializer's plain functions. The twin
runs at c = 1 on every case and at c = 2 and 8 on the 2 KiB cases and
the 16,384-command page. Cases: text, structured, repetitive, random and
all-zero pages (greedy commands at the bounds S // 2 + 2, and 200, which
the text page fills; rows of 2016 bytes); a page whose literal table is
trivial (one symbol) with no command, one whose literal table is simple
(three symbols), one its commands cover exactly with no tail, a short
page with garbage past its size, distances of 1 (ring offsets r0 - k <=
0) and the initial ring at the page start (pos - r < 0); the DP's own
commands in a second iteration; 32, 64 and 128 KiB rows; and pages laid
out by hand (`_synthetic`): a best grid point with npostfix 3, no grid
key at all, distances past the page and just under 2^28, and a 64 KiB
page of 16,384 commands.

GPU part (`cuda` marker, skips without a card): the kernels against the
plain version on the card on the same cases, with their launches
counted, the table kernel's 16 grid costs (from its record) against the
plain version's runs over the sorted keys, at 1, 8, 33, 64 and 80 pages
(clusters of 8, 8, 4, 2 and 1 CTAs a page on 132 SMs), and at 80 pages
of 128 KiB, whose distance counts live in the scratch; the kernels'
unseen-symbol half-bits against parse_dp.unseen_bits for every total in
[1, 2^18); the wrapper refusing shapes it does not take.

Cold time on one torch thread: ~34 s, ~24 s of it the tests (this file
alone, CPU).
"""
import functools

import numpy as np
import pytest
import torch

from brotlig_tpu_torch import _kernels
from brotlig_tpu_torch.ops import cost_kernel as CK
from brotlig_tpu_torch.ops import encode as TE
from brotlig_tpu_torch.ops import encode_pack as TP
from brotlig_tpu_torch.ops import parse_dp as TD
from test_roundtrip import make_data
from test_torch_kernels import cuda_dev  # noqa: F401 (fixture)
from test_torch_two_phase import torch_one_thread  # noqa: F401 (autouse)

S = 2048
W = 256                 # the candidates' cap
MODEL = ("litq", "jointEq", "jointLq", "cand_len", "cand_dist", "dpackq")
INIT_PV = (16, 15, 11)  # the initial ring's tail, oldest first
FAR = 1 << 28           # grid-search distances at or past it are left out


# ---------------------------------------------------------------------------
# the kernels' formulation in numpy
# ---------------------------------------------------------------------------

def _bitlen(x):
    x = np.asarray(x, np.int64).copy()
    bl = np.zeros_like(x)
    for s in (32, 16, 8, 4, 2, 1):
        take = (x >> s) > 0
        bl += np.where(take, s, 0)
        x = np.where(take, x >> s, x)
    return bl + (x > 0)


def _encode_distance(d, npostfix: int, ndirect: int):
    """(symbol, extra bits) of distances d >= 1 (EncodeDistance)."""
    direct = d <= ndirect
    dd = np.maximum(d - ndirect - 1, 0)
    postfix = dd & ((1 << npostfix) - 1)
    h4 = (dd >> npostfix) + 4
    nb = _bitlen(h4) - 2
    b = (h4 >> nb) & 1
    sym = 16 + ndirect + (((2 * (nb - 1) + b) << npostfix) | postfix)
    return np.where(direct, 16 + d - 1, sym), np.where(direct, 0, nb)


def _ring_table(ins, cpy, dist, n: int):
    """The ring (r0, r1, r2, r3) before each command j <= n, as the
    serializer kernel keeps it: r0 is the previous copy's distance (4 at
    the start, 0 after a command that is not a copy), r1..r3 the three
    latest values a push displaced."""
    ring = np.zeros((n + 1, 4), np.int64)
    pv = []

    def pvx(i):
        return INIT_PV[i] if i < 3 else pv[i - 3]
    for j in range(n + 1):
        r0 = 4 if j == 0 else (int(dist[j - 1]) if cpy[j - 1] > 0
                               and dist[j - 1] > 0 else 0)
        t = len(pv)
        ring[j] = (r0, pvx(2 + t), pvx(1 + t), pvx(t))
        if j < n and cpy[j] > 0 and dist[j] > 0 and dist[j] != r0:
            pv.append(r0)
    return ring


POS_TILE = 2048          # positions a block of the position kernel


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


def _covering_tiles(starts, covered: int, n: int, S_: int):
    """Each position's column as the position kernel finds it: a tile of
    POS_TILE positions takes the starts of the commands that cover it (the
    last start at or before its first position to the last before its
    end) and each position searches them for the last start at or before
    it; at or past the covered bytes, n."""
    col = np.full(S_, n, np.int64)
    for t0 in range(0, S_, POS_TILE):
        if n == 0 or t0 >= covered:
            continue
        jlo = np.searchsorted(starts[:n], t0, "right") - 1
        jhi = np.searchsorted(starts[:n], min(t0 + POS_TILE, covered) - 1,
                              "right") - 1
        pos = np.arange(t0, min(t0 + POS_TILE, S_))
        pos = pos[pos < covered]
        col[pos] = jlo + np.searchsorted(starts[jlo:jhi + 1], pos,
                                         "right") - 1
    return col


def _words(row):
    """The page as little-endian 32-bit words, zeros past its end."""
    w = np.zeros(len(row) // 4 + 8, np.uint64)
    w[:len(row) // 4] = np.frombuffer(row.tobytes(), "<u4")
    return w


def _word_at(w, byte):
    """The four bytes from byte on: two aligned words and a funnel shift."""
    lo, hi = w[byte >> 2], w[(byte >> 2) + 1]
    return ((hi << np.uint64(32)) | lo) >> (8 * (byte & 3)).astype(
        np.uint64) & np.uint64(0xffffffff)


def _probe_words(row, size: int, r):
    """The ring probe at every position, four bytes a compare: the common
    prefix of the bytes at pos and pos - r, counted to min(16, size - pos),
    kept from 2 on."""
    S_ = len(row)
    w = _words(row)
    pos = np.arange(S_)
    room = np.minimum(16, min(size, S_) - pos)
    alive = (r >= 1) & (pos - r >= 0) & (room > 0)
    src = np.where(alive, pos - r, 0)
    m = np.zeros(S_, np.int64)
    go = alive.copy()
    for v in range(4):
        go &= 4 * v < room
        x = _word_at(w, pos + 4 * v) ^ _word_at(w, src + 4 * v)
        low = (x & (~x + np.uint64(1))).astype(np.float64)
        first = np.where(x != 0, np.log2(np.maximum(low, 1)).astype(np.int64)
                         >> 3, 4)
        m = np.where(go, m + first, m)
        go &= x == 0
    m = np.where(alive, np.minimum(m, room), 0)
    ok = m >= 2
    return np.where(ok, m, 0), np.where(ok, r, 0)


def _ring_code(d, ring):
    """The lowest ring code of each distance d >= 1 against its ring."""
    r0, r1, r2, r3 = ring.T[:, :, None]
    vals = [r0, r1, r2, r3]
    for k in (1, 2, 3):
        vals += [r0 - k, r0 + k]
    for k in (1, 2, 3):
        vals += [r1 - k, r1 + k]
    code = np.full(d.shape, -1, np.int64)
    for c, v in enumerate(vals):
        code = np.where((code < 0) & (d >= 1) & (d == v), c, code)
    return code


def grid_keys(ins, cpy, dist, n: int):
    """The grid search's keys: the copies' distances that are not exact
    ring hits (codes 0-3), below 2^28."""
    ring = _ring_table(ins, cpy, dist, n)[:n]
    d = np.asarray(dist[:n], np.int64)
    copy = (np.asarray(cpy[:n]) > 0) & (d > 0)
    exact = _ring_code(d[:, None], ring)[:, 0]
    keep = copy & ~((exact >= 0) & (exact <= 3)) & (d < FAR)
    return d[keep]


def _run_cost(cnt, log2k):
    """One run's entropy term in 2^-16 bits (float64, round half even)."""
    c = np.asarray(cnt, np.float64)
    return np.rint((c * (log2k - np.log2(c)) + 6.0) * 65536.0).astype(np.int64)


def grid_costs(keys, S_: int, c: int):
    """The 16 grid points' costs as the table kernel prices them: the keys
    counted by distance into c slices of up(S / c, 64) distances (keys past
    them in a sorted side list); the present distances in distance order
    split into c equal shares by rank (CTA r the ranks [M r / c, M (r + 1)
    / c) of M), then the side list; in each share, a run starts where the
    symbol is inside the alphabet and differs from the previous key's (the
    first key's previous is the last present distance before the share);
    each share gives its first and last run start, the cost of the runs it
    closes and its extra bits, and the shares are joined in order, the
    open run closed at the end. Returns int64 [16]."""
    keys = np.asarray(keys, np.int64)
    K = len(keys)
    log2k = np.log2(max(K, 1))
    DR = c * _up(-(-S_ // c), 64)
    cnt = np.bincount(keys[keys < DR], minlength=DR)
    side = np.sort(keys[keys >= DR])
    present = np.nonzero(cnt)[0]
    M = len(present)
    parts = []      # (distances, counts) of each share, then the side list
    for r in range(c):
        d = present[M * r // c:M * (r + 1) // c]
        parts.append((d, cnt[d]))
    parts.append((side, np.ones(len(side), np.int64)))
    out = np.zeros(16, np.int64)
    for g in range(16):
        np_, nd_ = g >> 2, (0, 3, 8, 15)[g & 3] << (g >> 2)
        cost = nbs = 0
        prev_l, prevd, base = -1, -1, 0
        for d, k in parts:
            if len(d) == 0:
                continue
            sym, nb = _encode_distance(d, np_, nd_)
            first_prev = (_encode_distance(np.array([prevd]), np_, nd_)[0][0]
                          if prevd > 0 else -1)
            prev = np.concatenate([[first_prev], sym[:-1]])
            pos = base + np.concatenate([[0], np.cumsum(k)[:-1]])
            sp = pos[(sym < TP.A_DST) & (sym != prev)]
            cost += int(_run_cost(np.diff(sp), log2k).sum())
            nbs += int((k * nb).sum())
            if len(sp):
                if prev_l >= 0:
                    cost += int(_run_cost(sp[0] - prev_l, log2k))
                prev_l = sp[-1]
            prevd, base = int(d[-1]), base + int(k.sum())
        if prev_l >= 0:
            cost += int(_run_cost(K - prev_l, log2k))
        out[g] = cost + (nbs << 16)
    return out


def literal_hist_cover(row, size: int, ins, cpy, n: int, c: int):
    """The literal histogram as the table kernel counts it: CTA r marks
    its share of up(S / c, 32) positions that lie in an insert region (of
    the commands from the last start at or before its first position to
    the last before its end) or in the tail, inside the page's size, and
    counts the marked bytes; the shares' counts are summed."""
    S_ = len(row)
    ln = (np.asarray(ins[:n], np.int64) + np.asarray(cpy[:n], np.int64))
    starts = np.cumsum(ln) - ln
    covered = int(ln.sum())
    lim = min(size, S_)
    pr = _up(-(-S_ // c), 32)
    hist = np.zeros(256, np.int64)
    for r in range(c):
        P0, P1 = r * pr, min(r * pr + pr, S_)
        if P1 <= P0:
            continue
        edge = np.zeros(P1 - P0 + 1, np.int64)
        a, b = max(P0, covered), min(lim, P1)
        if a < b:
            edge[a - P0] += 1
            edge[b - P0] -= 1
        if n > 0 and P0 < covered:
            jlo = np.searchsorted(starts, P0, "right") - 1
            jhi = np.searchsorted(starts, P1 - 1, "right") - 1
            a = np.maximum(starts[jlo:jhi + 1], P0)
            b = np.minimum(np.minimum(
                starts[jlo:jhi + 1] + np.asarray(ins[jlo:jhi + 1]), lim), P1)
            live = a < b
            np.add.at(edge, a[live] - P0, 1)
            np.add.at(edge, b[live] - P0, -1)
        mark = np.cumsum(edge[:-1]) > 0
        hist += np.bincount(row[P0:P1][mark], minlength=256)
    return hist


def twin_model(arr, sizes, ins, cpy, dist, ncmds, base_len, base_dist,
               c: int = 1):
    """The six cost-model outputs as the kernels compute them with c CTAs a
    page (int64 numpy)."""
    P, S_ = arr.shape
    t64 = [torch.from_numpy(np.asarray(x, np.int64))
           for x in (sizes, ins, cpy, dist, ncmds)]
    (_, _, _, _, _, _, (hist_cmd, hist_dst, _)) = TP.page_histograms(
        torch.from_numpy(arr), *t64)
    npostfix = np.zeros(P, np.int64)
    ndist = np.zeros(P, np.int64)
    hist_lit = np.zeros((P, 256), np.int64)
    for p in range(P):
        n = int(ncmds[p])
        best = int(np.argmin(grid_costs(grid_keys(ins[p], cpy[p], dist[p], n),
                                        S_, c)))
        npostfix[p], ndist[p] = best >> 2, (0, 3, 8, 15)[best & 3]
        hist_lit[p] = literal_hist_cover(arr[p], int(sizes[p]), ins[p],
                                         cpy[p], n, c)
    tabs = []
    for h, A, pad in zip((hist_cmd, hist_dst, torch.from_numpy(hist_lit)),
                         (TP.A_CMD, TP.A_DST, TP.A_LIT), (2.0, 4.0, 2.0)):
        total = h.sum(1)
        lens = TP._choose_table(h, total, A)[0].numpy()
        unseen = torch.round(2 * TD.unseen_bits(total.clamp(min=1), pad))
        tabs.append(np.where(h.numpy() > 0, 2 * lens,
                             unseen.long().numpy()[:, None]))
    cmd_q, dst_q, lit_q = tabs
    ic, cc = np.divmod(np.arange(576), 24)
    ic_t, cc_t = torch.from_numpy(ic), torch.from_numpy(cc)
    sym_e = TP.combine_codes_vec(ic_t, cc_t, torch.zeros(576, dtype=bool))
    sym_l = TP.combine_codes_vec(ic_t, cc_t, torch.ones(576, dtype=bool))
    joint_e = cmd_q[:, sym_e.numpy()]
    joint_l = np.where((ic < 8) & (cc < 16), cmd_q[:, sym_l.numpy()],
                       TD.INF_Q)
    litq = np.take_along_axis(lit_q, arr.astype(np.int64), 1)
    K = base_len.shape[2] + 4
    cand_len = np.zeros((P, S_, K), np.int64)
    cand_dist = np.zeros((P, S_, K), np.int64)
    dpackq = np.zeros((P, S_, K), np.int64)
    for p in range(P):
        n = int(ncmds[p])
        ln = (ins[p, :n] + cpy[p, :n]).astype(np.int64)
        starts = np.cumsum(ln) - ln
        ring = _ring_table(ins[p], cpy[p], dist[p], n)[
            _covering_tiles(starts, int(ln.sum()), n, S_)]
        probes = [_probe_words(arr[p], int(sizes[p]), ring[:, k])
                  for k in range(4)]
        cand_len[p] = np.concatenate(
            [base_len[p], np.stack([x[0] for x in probes], 1)], 1)
        cand_dist[p] = np.concatenate(
            [base_dist[p], np.stack([x[1] for x in probes], 1)], 1)
        d = cand_dist[p]
        sym, nb = _encode_distance(np.maximum(d, 1), int(npostfix[p]),
                                   int(ndist[p]) << int(npostfix[p]))
        dq = np.where(sym < TP.A_DST,
                      dst_q[p][np.clip(sym, 0, TP.A_DST - 1)], 80) + 2 * nb
        rsym = _ring_code(d, ring)
        dq = np.where(rsym >= 0, np.minimum(dq, dst_q[p][np.maximum(rsym, 0)]),
                      dq)
        dpackq[p] = (np.minimum(dq, TD.INF_Q) << 1) | (rsym == 0)
    return litq, joint_e, joint_l, cand_len, cand_dist, dpackq


# ---------------------------------------------------------------------------
# cases
# ---------------------------------------------------------------------------

def _rows(kinds, S_: int, seed: int = 20):
    """(pages, sizes) of (kind, size) rows, garbage past each size."""
    rng = np.random.default_rng(seed)
    arr = rng.integers(0, 256, (len(kinds), S_)).astype(np.uint8)
    sizes = np.zeros(len(kinds), np.int32)
    for i, (kind, n) in enumerate(kinds):
        arr[i, :n] = np.frombuffer(make_data(kind, n, seed=i + seed),
                                   np.uint8)
        sizes[i] = n
    return arr, sizes


def _np(x):
    return tuple(np.ascontiguousarray(t.numpy()) for t in x)


def _greedy(arr, sizes, max_cmds=None):
    """The exact tier's greedy commands at a command bound (S // 4 + 16 by
    default) and the candidates."""
    pages, in_sizes = torch.from_numpy(arr), torch.from_numpy(sizes)
    bound = arr.shape[1] // 4 + 16 if max_cmds is None else max_cmds
    cmds = _np(TE.find_commands(pages, in_sizes, bound))
    return cmds + _np(TE.find_candidates(pages, in_sizes, W))


def _edges():
    """Pages of S bytes: 'a' x S with no command (a trivial literal table,
    the initial ring at the page start); three byte values at random with
    their greedy commands (a simple literal table); 'abc' repeated, one
    command covering it exactly (no tail); a 700-byte text page with
    garbage after it; 'a' x S with its greedy commands (distance 1)."""
    rng = np.random.default_rng(5)
    arr = rng.integers(0, 256, (5, S)).astype(np.uint8)
    sizes = np.full(5, S, np.int32)
    arr[0] = ord("a")
    arr[1] = rng.choice(np.frombuffer(b"xyz", np.uint8), S)
    arr[2] = np.resize(np.frombuffer(b"abc", np.uint8), S)
    arr[3, :700] = np.frombuffer(make_data("text", 700, seed=3), np.uint8)
    sizes[3] = 700
    arr[4] = ord("a")
    ins, cpy, dist, ncmds, cl, cd = _greedy(arr, sizes)
    for x in (ins, cpy, dist):
        x[0] = 0
        x[2] = 0
    ncmds[0] = 0
    ins[2, 0], cpy[2, 0], dist[2, 0], ncmds[2] = 3, S - 3, 3, 1
    return arr, sizes, ins, cpy, dist, ncmds, cl, cd


def _dp_second():
    """The DP's commands after one iteration on the kinds pages: the
    cost model's inputs of the second iteration."""
    arr, sizes, *rest = case("kinds")
    ins, cpy, dist, ncmds, cl, cd = rest
    t = [torch.from_numpy(x) for x in (arr, sizes, ins, cpy, dist, ncmds,
                                        cl, cd)]
    litq, jE, jL, clen, cdist, dpk = TD.build_cost_model_plain(*t)
    comb = TD.dp_parse_plain(litq, clen, dpk, jE, jL, 32, 64, 2)
    out = TD.backtrack(comb.numpy(), clen.numpy(), cdist.numpy(),
                       dpk.numpy(), sizes, S // 4 + 16)
    assert (out[3] >= 0).all() and not np.array_equal(out[3], ncmds)
    return (arr, sizes, *out, cl, cd)


def _synthetic(name: str):
    """A page of text with commands laid out by hand and random base
    candidates (the cost model does not check that a command's copy
    matches): 'npostfix', 2-byte inserts and 3-byte copies whose distances
    d have d - 1 a multiple of 8 nineteen times in twenty, so the best grid
    point has npostfix 3 and the other postfixes' symbols interleave in
    distance order; 'no_keys', copies at distances 4 and 11 in turn, every
    one an exact ring hit (no grid-search key); 'far', distances past the page
    (up to just under 2^28, and some at or past it, which the search
    leaves out) among near ones; 'many', a 64 KiB page of 16,384 commands
    (1-byte inserts, 3-byte copies) whose distances are near ones, ring
    hits and far ones."""
    rng = np.random.default_rng(11)
    S_ = 65536 if name == "many" else S
    arr, sizes = _rows([("text", S_)], S_, seed=13)
    if name == "npostfix":
        n, ins_v, cpy_v = S_ // 5, 2, 3
        d = 1 + 8 * rng.integers(2, 250, n)
        odd = rng.random(n) < 0.05
        d[odd] = rng.integers(5, 1800, odd.sum())
    elif name == "no_keys":
        n, ins_v, cpy_v = S_ // 4, 1, 3
        d = np.where(np.arange(n) % 2, 11, 4)
    elif name == "far":
        n, ins_v, cpy_v = S_ // 7, 3, 4
        d = rng.integers(1, 2000, n)
        kind = rng.integers(0, 4, n)
        d = np.where(kind == 1, rng.integers(S_, S_ + 6000, n), d)
        d = np.where(kind == 2, FAR - rng.integers(1, 40, n), d)
        d = np.where((kind == 3) & (rng.random(n) < 0.3),
                     FAR + rng.integers(0, 9, n), d)
    else:
        n, ins_v, cpy_v = S_ // 4, 1, 3
        d = rng.integers(1, 60000, n)
        reuse = rng.random(n) < 0.3
        d[1:][reuse[1:]] = d[:-1][reuse[1:]]
        d = np.where(rng.random(n) < 0.05, rng.integers(S_, 1 << 20, n), d)
    N = S_ // 4 + 16
    ins, cpy, dist = (np.zeros((1, N), np.int32) for _ in range(3))
    ins[0, :n], cpy[0, :n], dist[0, :n] = ins_v, cpy_v, d
    base_len = np.where(rng.random((1, S_, 8)) < 0.5, 0,
                        rng.integers(3, 200, (1, S_, 8))).astype(np.int32)
    base_dist = np.where(base_len > 0, rng.integers(1, 60000, (1, S_, 8)),
                         0).astype(np.int32)
    return (arr, sizes, ins, cpy, dist, np.array([n], np.int32), base_len,
            base_dist)


SYNTHETIC = ("npostfix", "no_keys", "far", "many")
KINDS = [("text", S), ("structured", S - 97), ("repetitive", S),
         ("random", 1000), ("zeros", S)]
BIG = {"32k": ("text", 32768, 32768), "64k": ("structured", 65536, 65536),
       "128k": ("text", 131072, 131072 - 5000)}
CASES = ("kinds", "bound_200", "s2016", "edges", "dp_second", "32k", "64k",
         "128k") + SYNTHETIC


@functools.lru_cache(maxsize=None)
def case(name: str):
    """(pages, sizes, ins, cpy, dist, ncmds, base_len, base_dist) numpy
    arrays of a case."""
    if name in ("kinds", "bound_200"):
        # TestParseDP's command bound S // 2 + 2; at 200 the text page
        # fills every column and leaves a long tail
        arr, sizes = _rows(KINDS, S)
        return (arr, sizes) + _greedy(arr, sizes, S // 2 + 2 if name ==
                                      "kinds" else 200)
    if name == "s2016":
        # the DP tests' B 63 shape: rows of 2016 bytes, not a multiple of
        # the position kernel's 256
        arr, sizes = _rows([(k, min(n, 2016)) for k, n in KINDS], 2016)
        return (arr, sizes) + _greedy(arr, sizes)
    if name == "edges":
        return _edges()
    if name == "dp_second":
        return _dp_second()
    if name in SYNTHETIC:
        return _synthetic(name)
    kind, S_, n = BIG[name]
    arr, sizes = _rows([(kind, n)], S_, seed=7)
    return (arr, sizes) + _greedy(arr, sizes)


def plain(args, dev="cpu"):
    return TD.build_cost_model_plain(
        *[torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in args])


@functools.lru_cache(maxsize=None)
def plain_of(name: str):
    """The plain version's outputs on a case, on the CPU (numpy)."""
    return tuple(t.numpy() for t in plain(case(name)))


@functools.lru_cache(maxsize=None)
def plain_stats(name: str):
    """page_histograms' npostfix, ndist and literal histogram on a case
    (numpy)."""
    arr, sizes, ins, cpy, dist, ncmds, *_ = case(name)
    t64 = [torch.from_numpy(np.asarray(x, np.int64))
           for x in (sizes, ins, cpy, dist, ncmds)]
    _, _, _, npf, ndist, _, hists = TP.page_histograms(torch.from_numpy(arr),
                                                       *t64)
    return npf.numpy(), ndist.numpy(), hists[2].numpy()


# the cases of 2 KiB pages, whose twin runs in well under a second
SMALL = ("kinds", "bound_200", "s2016", "edges", "dp_second", "npostfix",
         "no_keys", "far")


# ---------------------------------------------------------------------------
# CPU: the twin against the plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", CASES)
def test_twin_equals_plain(name):
    got = twin_model(*case(name))
    for nm, g, w in zip(MODEL, got, plain_of(name)):
        np.testing.assert_array_equal(g, w, err_msg=nm)


@pytest.mark.parametrize("c", (2, 8))
def test_twin_slices_equal_plain(c):
    """The twin with 2 and 8 CTAs a page (slices of distances and of page
    positions) on the 2 KiB cases and the 16,384-command page."""
    for name in SMALL + ("many",):
        got = twin_model(*case(name), c=c)
        for nm, g, w in zip(MODEL, got, plain_of(name)):
            np.testing.assert_array_equal(g, w, err_msg=f"{name} {nm}")


def _sorted_run_costs(keys):
    """The plain version's 16 grid costs: _dist_cost over the sorted keys
    (ops/encode_pack.py::_build_fields)."""
    d = torch.from_numpy(np.sort(np.asarray(keys, np.int64)))[None, None, :]
    gnp = torch.arange(4).repeat_interleave(4)[None, :, None]
    gnd = torch.tensor([0, 3, 8, 15]).repeat(4)[None, :, None]
    sym, nb, _ = TP._encode_distance(d, gnp, gnd << gnp)
    mask = torch.ones(1, 16, d.shape[2], dtype=torch.bool)
    return TP._dist_cost(sym, nb, mask, presorted=True)[0].numpy()


@pytest.mark.parametrize("c", (1, 2, 8))
def test_grid_costs_equal_sorted_runs(c):
    """All 16 grid points' costs from per-distance counts, priced in c
    shares joined by carries (keys past the slices in the side list), equal the
    plain version's runs over the sorted keys, on every page of every
    case; the first minimum is the plain version's (npostfix, ndist)."""
    for name in CASES:
        arr, sizes, ins, cpy, dist, ncmds, *_ = case(name)
        npf, ndist, _ = plain_stats(name)
        for p in range(arr.shape[0]):
            keys = grid_keys(ins[p], cpy[p], dist[p], int(ncmds[p]))
            got = grid_costs(keys, arr.shape[1], c)
            np.testing.assert_array_equal(got, _sorted_run_costs(keys),
                                          err_msg=f"{name} page {p}")
            best = int(np.argmin(got))
            assert (best >> 2, (0, 3, 8, 15)[best & 3]) == (
                int(npf[p]), int(ndist[p])), (name, p)


@pytest.mark.parametrize("c", (1, 2, 8))
def test_literal_cover_equals_plain(c):
    """The literal histogram counted from each CTA's share of the cover
    (no literal queue) equals page_histograms' on every page."""
    for name in CASES:
        arr, sizes, ins, cpy, dist, ncmds, *_ = case(name)
        want = plain_stats(name)[2]
        for p in range(arr.shape[0]):
            got = literal_hist_cover(arr[p], int(sizes[p]), ins[p], cpy[p],
                                     int(ncmds[p]), c)
            np.testing.assert_array_equal(got, want[p],
                                          err_msg=f"{name} page {p}")


def test_synthetic_cases_take_their_branches():
    """The hand-laid pages reach what they are for: npostfix > 0 with keys
    of other postfixes between them in distance order; no key at all;
    keys past the page, just under 2^28 and at or past it; more than
    16,000 commands, so that every CTA of a cluster of 8 has a share."""
    arr, sizes, ins, cpy, dist, ncmds, *_ = case("npostfix")
    keys = np.sort(grid_keys(ins[0], cpy[0], dist[0], int(ncmds[0])))
    best = int(np.argmin(grid_costs(keys, S, 1)))
    npf, nd = best >> 2, (0, 3, 8, 15)[best & 3] << (best >> 2)
    post = (keys[keys > nd] - nd - 1) & ((1 << npf) - 1)
    assert npf > 0 and (np.diff(post) != 0).sum() > 10
    arr, sizes, ins, cpy, dist, ncmds, *_ = case("no_keys")
    assert int(ncmds[0]) > 0 and len(grid_keys(ins[0], cpy[0], dist[0],
                                               int(ncmds[0]))) == 0
    arr, sizes, ins, cpy, dist, ncmds, *_ = case("far")
    keys = grid_keys(ins[0], cpy[0], dist[0], int(ncmds[0]))
    assert (keys >= S).sum() > 10 and (keys >= FAR - 40).sum() > 10
    assert (dist[0, :int(ncmds[0])] >= FAR).sum() > 0
    arr, sizes, ins, cpy, dist, ncmds, *_ = case("many")
    assert int(ncmds[0]) > 16000 and arr.shape[1] == 65536


def test_edge_cases_take_their_branches():
    """The edge pages reach what they are for: a trivial and a simple
    literal table, no command, an exact cover, ring probes before the page
    start, and ring offsets r0 - k <= 0."""
    arr, sizes, ins, cpy, dist, ncmds, *_ = case("edges")
    t64 = [torch.from_numpy(np.asarray(x, np.int64))
           for x in (sizes, ins, cpy, dist, ncmds)]
    hist_lit = TP.page_histograms(torch.from_numpy(arr), *t64)[6][2]
    used = (hist_lit > 0).sum(1).tolist()
    assert used[0] == 1 and used[1] == 3 and ncmds[0] == 0
    assert ins[2, 0] + cpy[2, 0] == sizes[2] and ncmds[2] == 1
    assert ncmds[4] > 0 and (dist[4, :ncmds[4]] == 1).any()
    ring = _ring_table(ins[4], cpy[4], dist[4], int(ncmds[4]))
    assert (ring[:, 0] == 1).any()


def test_build_cost_model_dispatch_on_cpu(monkeypatch):
    """A CPU tensor runs the plain version and launches nothing; another
    device type is refused."""
    def refuse(*args):
        raise AssertionError("the kernel wrapper ran on a CPU tensor")
    monkeypatch.setattr(CK, "build_cost_model_cuda", refuse)
    args = [torch.from_numpy(np.ascontiguousarray(x)) for x in case("edges")]
    _kernels.reset_launches()
    got = TD.build_cost_model(*args)
    assert _kernels.LAUNCHES["cost"] == 0
    for g, w in zip(got, TD.build_cost_model_plain(*args)):
        assert g.dtype == torch.int32 and torch.equal(g, w)
    with pytest.raises(ValueError, match="no build_cost_model route"):
        TD.build_cost_model(*[a.to("meta") for a in args])


def _bad_shapes(dev="cpu"):
    """Argument lists the wrapper must refuse, each with one fault."""
    P, N, S_ = 2, 8, 64

    def z(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=dev)
    good = [z(P, S_, dtype=torch.uint8), z(P), z(P, N), z(P, N), z(P, N),
            z(P), z(P, S_, 8), z(P, S_, 8)]
    faults = [(0, z(P, 62, dtype=torch.uint8)),
              (0, z(P, 1 << 18, dtype=torch.uint8)),
              (0, z(P, S_)),
              (2, z(P, 0)), (3, z(P, N + 1)), (1, z(P + 1)),
              (5, z(P, 1)), (6, z(P, S_, 12)), (7, z(P, S_ // 2, 8))]
    for i, bad in faults:
        args = list(good)
        args[i] = bad
        yield args


def test_wrapper_refuses_bad_shapes():
    """The wrapper checks shapes before it touches a device."""
    for args in _bad_shapes():
        with pytest.raises(ValueError):
            CK.build_cost_model_cuda(*args)


# ---------------------------------------------------------------------------
# GPU: the kernels against the plain version
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_cost_kernels_equal_plain(cuda_dev, name):  # noqa: F811
    args = case(name)
    ops = [torch.from_numpy(np.ascontiguousarray(x)).to(cuda_dev)
           for x in args]
    _kernels.reset_launches()
    got = TD.build_cost_model(*ops)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["cost"] == CK.LAUNCHES_PER_CALL
    for nm, g, w in zip(MODEL, got, plain(args, cuda_dev)):
        assert g.dtype == torch.int32 and g.is_cuda
        assert torch.equal(g, w), nm


@pytest.mark.cuda
@pytest.mark.parametrize("P", (1, 8, 33, 64, 80))
def test_cost_kernels_cluster_sizes(cuda_dev, P):  # noqa: F811
    """P pages of the 2 KiB cases (the kinds and edge pages in turn), whose
    clusters take 8, 4, 2 or 1 CTAs a page (the most whose CTAs fit the
    card's SMs), against the plain version; each page's clock record is
    filled."""
    parts = [case("kinds"), case("edges")]
    N = max(x[2].shape[1] for x in parts)
    rows = []
    for i in range(P):
        a = parts[i % 2]
        j = (i // 2) % a[0].shape[0]
        rows.append([np.pad(x[j], (0, N - x.shape[1])) if k in (2, 3, 4)
                     else x[j] for k, x in enumerate(a)])
    args = [np.stack([r[k] for r in rows]) for k in range(8)]
    ops = [torch.from_numpy(np.ascontiguousarray(x)).to(cuda_dev)
           for x in args]
    sms = torch.cuda.get_device_properties(cuda_dev).multi_processor_count
    want_c = max([1] + [c for c in (2, 4, 8) if P * c <= sms])
    lib = _kernels.library()
    assert lib.blg_cost_plan(P, N, S, 0) == want_c
    *got, rec = CK.build_cost_model_cuda(*ops, return_record=True)
    torch.cuda.synchronize()
    for nm, g, w in zip(MODEL, got, plain(args, cuda_dev)):
        assert torch.equal(g, w), (nm, P)
    assert rec.shape == (P, CK.REC_INTS)
    assert (rec[:, :len(CK.PHASES)] >= 0).all()


@pytest.mark.cuda
def test_cost_kernels_counts_in_scratch(cuda_dev):  # noqa: F811
    """80 pages of 128 KiB: clusters of one CTA, whose distance counts
    (64 K words) do not fit its shared memory and live in the scratch;
    against the plain version on the card. The pages repeat one laid out
    by hand (text, 32,768 commands of 1-byte inserts and 3-byte copies at
    near, repeated and far distances) with random base candidates."""
    rng = np.random.default_rng(17)
    S_, n, P = 131072, 32768, 80
    arr, sizes = _rows([("text", S_)], S_, seed=19)
    N = S_ // 4 + 16
    d = rng.integers(1, 120000, n)
    reuse = rng.random(n - 1) < 0.3
    d[1:][reuse] = d[:-1][reuse]
    d = np.where(rng.random(n) < 0.05, rng.integers(S_, 1 << 20, n), d)
    one = [np.zeros((1, N), np.int32) for _ in range(3)]
    one[0][0, :n], one[1][0, :n], one[2][0, :n] = 1, 3, d
    base_len = np.where(rng.random((1, S_, 8)) < 0.5, 0,
                        rng.integers(3, 200, (1, S_, 8))).astype(np.int32)
    base_dist = np.where(base_len > 0, rng.integers(1, 120000, (1, S_, 8)),
                         0).astype(np.int32)
    rows = [arr, sizes, *one, np.array([n], np.int32), base_len, base_dist]
    ops = [torch.from_numpy(np.ascontiguousarray(x)).to(cuda_dev).expand(
        (P,) + x.shape[1:]).contiguous() for x in rows]
    lib = _kernels.library()
    assert lib.blg_cost_plan(P, N, S_, 0) == 1
    assert lib.blg_cost_plan(P, N, S_, 2) == 0
    got = CK.build_cost_model_cuda(*ops)
    torch.cuda.synchronize()
    for nm, g, w in zip(MODEL, got, TD.build_cost_model_plain(*ops)):
        assert torch.equal(g, w), nm


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_cost_kernel_grid_costs(cuda_dev, name):  # noqa: F811
    """All 16 grid points' costs the table kernel priced (its record)
    equal the plain version's runs over the sorted keys, on every page."""
    args = case(name)
    ops = [torch.from_numpy(np.ascontiguousarray(x)).to(cuda_dev)
           for x in args]
    rec = CK.build_cost_model_cuda(*ops, return_record=True)[-1]
    got = CK.grid_costs(rec).cpu().numpy()
    arr, sizes, ins, cpy, dist, ncmds, *_ = args
    for p in range(arr.shape[0]):
        keys = grid_keys(ins[p], cpy[p], dist[p], int(ncmds[p]))
        np.testing.assert_array_equal(got[p], _sorted_run_costs(keys),
                                      err_msg=f"page {p}")


@pytest.mark.cuda
def test_unseen_half_bits_on_card(cuda_dev):  # noqa: F811
    """The kernels' unseen-symbol half-bits for every total in [1, 2^18),
    pads 2 and 4, against parse_dp.unseen_bits on the CPU."""
    total = torch.arange(1, 1 << 18)
    for pad in (2.0, 4.0):
        got = CK.unseen_half_bits_cuda(total.numel(), pad, cuda_dev)
        want = torch.round(2 * TD.unseen_bits(total, pad)).to(torch.int32)
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_cost_wrapper_refuses_bad_shapes_on_card(cuda_dev):  # noqa: F811
    _kernels.reset_launches()
    for args in _bad_shapes(cuda_dev):
        with pytest.raises(ValueError):
            TD.build_cost_model(*args)
    assert _kernels.LAUNCHES["cost"] == 0
