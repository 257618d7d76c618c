"""The parse kernels' split walk (brotlig_tpu_torch/csrc/ref_parse.cu) as
a numpy model, held to the port's find_matches on the CPU.

The kernels cut a page into segments of ops/ref_parse_kernel.SEGMENT
positions, walk each from its first position (a walker, marking every
loop-top position it visits), walk each walker's continuation from its
exit until it meets a mark or passes the segment it started in, and join:
the true walk takes walker 0 from position 0, then after each walker its
continuation, then the walker whose mark the continuation met from that
position on; after a continuation that met no mark it walks on its own
until it meets one. `split_parse` is that model, segment for segment; its
commands must equal find_matches's for any segment length, so it runs at
K = 1, 2, 7 and the kernel's K segments a page on every kind of page, a
zero page, a repeated 3,000-byte block, copies and runs that end on the
segment boundaries, short pages (one segment, one segment +- 1, under 4
bytes) and max_chain 0, 1 and 64. Imports no JAX (find_matches here is
the port's copy, held to the JAX package's in test_torch_refimpl.py);
~8 s of tests, ~11 s cold with its imports, on one core.
"""
import numpy as np
import pytest
import torch

from brotlig_tpu_torch.ops import ref_parse_kernel as RK
from brotlig_tpu_torch.refimpl.page_encoder import find_matches

S = 8192                                  # the rows' width
KINDS = ("text", "zeros", "runs", "four", "random")
CHAINS = (0, 1, 64)


def page_of(kind: str, n: int, seed: int = 0) -> bytes:
    """test_torch_refimpl's page kinds, without its JAX-side imports."""
    rng = np.random.default_rng(seed)
    if kind == "text":
        words = [b"the ", b"quick ", b"brown ", b"fox ", b"jumps ",
                 b"over ", b"lazy ", b"dog ", b"pack ", b"my ", b"box "]
        return b"".join(words[int(i)] for i in
                        rng.integers(0, len(words), n // 3 + 1))[:n]
    if kind == "zeros":
        return bytes(n)
    if kind == "runs":
        lens = rng.integers(1, 300, size=n // 2 + 1)
        vals = rng.integers(0, 256, size=len(lens), dtype=np.uint8)
        return np.repeat(vals, lens)[:n].tobytes()
    if kind == "four":
        return (rng.integers(0, 4, size=n) * 0x55).astype(np.uint8).tobytes()
    return rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()


def edges_page(n: int, seg: int, seed: int = 0) -> bytes:
    """Random bytes with, before every segment boundary, a run of one byte
    or a copy of earlier bytes that ends exactly there."""
    rng = np.random.default_rng(seed)
    out = rng.integers(0, 256, n, dtype=np.uint8)
    for k, hi in enumerate(range(seg, n + 1, seg)):
        run = 16 + (37 * k) % max(seg // 2, 1)
        if k % 2:
            out[max(hi - run, 0):hi] = out[k % 7]
        elif hi >= 2 * run:
            src = (hi - 2 * run) // 2
            out[hi - run:hi] = out[src:src + run]
    return out.tobytes()


def lost_page(n: int, seg: int, seed: int = 0) -> bytes:
    """Random bytes where the join must walk on its own. With L = 3 seg,
    the true walk copies [L - 50, L + 10) (its only source), then from L +
    10 a copy that ends at E2 = L + seg + 176, past the next segment's
    start; walker j, from L, takes a longer source to L + seg + 76, and no
    walker visits E2: the continuation meets no mark, and the join walks
    from E2 on its own until it meets one. A fourth source, a copy
    of [L + seg, L + seg + 300) for walker j + 1, is placed where it fits
    (not with 1024-byte segments). The sources lie before L - 50, the one
    to E2 farther back than the one walker j takes: at L + 10 a farther
    candidate beats a nearer one of more than 32 bytes."""
    rng = np.random.default_rng(seed)
    out = rng.integers(0, 256, n, dtype=np.uint8)
    L = 3 * seg
    at = 16
    for a, b in ((L - 50, L + 10), (L + 10, L + seg + 176), (L, L + seg + 76),
                 (L + seg, L + seg + 300)):
        if b <= n and at + (b - a) <= L - 50:
            out[at:at + b - a] = out[a:b]
            at += b - a + 16
    return out.tobytes()


def join_rows(seg: int, width: int = S):
    """The rows that are hard for the join, by name, at most width bytes."""
    block = np.random.default_rng(3).integers(0, 256, 3000, dtype=np.uint8)
    short = (np.random.default_rng(4).integers(0, 4, seg + 1) * 0x55).astype(
        np.uint8).tobytes()
    return {"zero page": bytes(width),
            "3000-byte block repeated": np.resize(block, width).tobytes(),
            "runs ending on boundaries": edges_page(width, seg),
            "a continuation that meets no mark": lost_page(width, seg),
            "one segment - 1": short[:seg - 1],
            "one segment": short[:seg],
            "one segment + 1": short,
            "3 bytes": short[:3], "1 byte": short[:1], "empty": b""}


class Page:
    """best() of a page as the kernels compute it: the chain at q is the
    slots before q's in a stable sort of the positions by hash, while the
    hash is q's, at most max_chain of them; the first strictly longest
    match of at least 4 bytes wins. Memoised: best is a pure function of
    the page."""

    def __init__(self, data: bytes, max_chain: int):
        self.data, self.n, self.max_chain = data, len(data), max_chain
        self.memo = {}
        if self.n >= 4:
            v = np.frombuffer(data, np.uint8).astype(np.uint32)
            quad = v[:-3] | (v[1:-2] << 8) | (v[2:-1] << 16) | (v[3:] << 24)
            self.h = ((quad * np.uint32(0x1E35A7BD)) >> np.uint32(15)).tolist()
            self.order = np.argsort(self.h, kind="stable").tolist()
            self.rank = [0] * len(self.h)
            for r, p in enumerate(self.order):
                self.rank[p] = r

    def match_len(self, a: int, b: int, limit: int) -> int:
        d = self.data
        lo, k = 0, 8               # d[a:a+lo] == d[b:b+lo]
        while k < limit and d[a:a + k] == d[b:b + k]:
            lo, k = k, 2 * k
        hi = min(k, limit)
        if d[a:a + hi] == d[b:b + hi]:
            return hi
        while hi - lo > 1:         # d[a:a+hi] != d[b:b+hi]
            mid = (lo + hi) // 2
            lo, hi = (mid, hi) if d[a:a + mid] == d[b:b + mid] else (lo, mid)
        return lo

    def best(self, q: int):
        if q + 4 > self.n or self.max_chain <= 0:
            return 0, 0
        if q not in self.memo:
            r, hq, limit = self.rank[q], self.h[q], self.n - q
            bl = bd = 0
            for k in range(1, min(self.max_chain, r) + 1):
                c = self.order[r - k]
                if self.h[c] != hq:
                    break
                ln = self.match_len(c, q, limit)
                if ln >= 4 and ln > bl:
                    bl, bd = ln, q - c
            self.memo[q] = (bl, bd)
        return self.memo[q]

    def walk(self, pos: int, stop, emit) -> int:
        """The greedy-lazy walk from loop-top position pos until stop(pos)
        holds at a loop top; emit(pos, len, dist) takes each command."""
        kept_q, kept = -1, (0, 0)
        while not stop(pos):
            b = kept if kept_q == pos else self.best(pos)
            if b[0] >= 4:
                kept = self.best(pos + 1) if pos + 1 < self.n else (0, 0)
                kept_q = pos + 1
                if kept[0] > b[0] + 1:
                    pos += 1
                    continue
                emit((pos, b[0], b[1]))
                pos += b[0]
            else:
                pos += 1
        return pos


def split_parse(data: bytes, max_chain: int, seg: int, stats=None):
    """find_matches's (commands, tail) by the kernels' split walk with
    segments of seg positions; stats (a dict) counts the join's cases."""
    page = Page(data, max_chain)
    n = len(data)
    K = -(-n // seg)
    marks = np.zeros(n + 1, bool)
    walkers = []                                 # (commands, exit)
    for k in range(K):
        lo, hi = k * seg, min((k + 1) * seg, n)
        cmds = []

        def stop(p, hi=hi):
            if p >= hi:
                return True
            marks[p] = True
            return False
        walkers.append((cmds, page.walk(lo, stop, cmds.append)))
    conts = []                                   # (commands, where stopped)
    for cmds_k, x in walkers:
        cmds = []
        y = n
        if x < n:
            lim = min((x // seg + 1) * seg, n)
            y = page.walk(x, lambda p, lim=lim: p >= lim or marks[p],
                          cmds.append)
        conts.append((cmds, y))
    stats = {} if stats is None else stats
    for key in ("joined", "lost", "taken"):
        stats[key] = 0
    out, k, idx = [], 0, 0
    while n > 0:
        stats["taken"] += 1
        out += walkers[k][0][idx:]
        if walkers[k][1] >= n:
            break
        out += conts[k][0]
        y = conts[k][1]
        if y < n and not marks[y]:               # lost: walk on alone
            stats["lost"] += 1
            y = page.walk(y, lambda p: p >= n or marks[p], out.append)
        if y >= n:
            break
        stats["joined"] += 1
        k = y // seg
        idx = sum(1 for c in walkers[k][0] if c[0] < y)
    stats["skipped"] = K - stats["taken"]
    cmds, anchor = [], 0
    for pos, ln, d in out:
        cmds.append((pos - anchor, ln, d))
        anchor = pos + ln
    return cmds, n - anchor


def segment_lengths():
    """K = 1, 2, 7 and the kernel's K segments on an S-byte row."""
    return [-(-S // K) for K in (1, 2, 7, RK.segments_for(S))]


ROWS = [(kind, None) for kind in KINDS] + \
    [("join", name) for name in join_rows(RK.SEGMENT)]


@pytest.mark.parametrize("chain", CHAINS)
@pytest.mark.parametrize("kind,name", ROWS)
def test_split_walk_equals_find_matches(kind, name, chain):
    for seg in segment_lengths():
        if kind == "join":
            data = join_rows(seg if name.startswith("runs") else
                             RK.SEGMENT)[name]
        else:
            data = page_of(kind, S, seed=len(kind))
        assert split_parse(data, chain, seg) == find_matches(data, chain), \
            (kind, name, chain, seg)


def test_join_rows_reach_every_case():
    """The join's cases all occur: a continuation that meets its walker,
    segments whose walker the true walk never takes, and a continuation
    that meets no mark (on its own row, at every max_chain but 0)."""
    rows = join_rows(RK.SEGMENT)
    for chain in (1, 64):
        seen = {"joined": 0, "lost": 0, "skipped": 0}
        for data in [page_of("text", S, 1), *rows.values()]:
            st = {}
            split_parse(data, chain, RK.SEGMENT, st)
            for key in seen:
                seen[key] += st[key]
        assert all(v > 0 for v in seen.values()), (chain, seen)
        st = {}
        split_parse(rows["a continuation that meets no mark"], chain,
                    RK.SEGMENT, st)
        assert st["lost"] == 1, st


def test_segments_and_launch_plan():
    """K = ceil(S / 1024) walkers a page; the plan's three launches and
    their scratch, on CPU tensors (the shapes the kernels are given)."""
    assert RK.SEGMENT == 1024
    assert [RK.segments_for(s) for s in (32768, 65536, 131072, 8192, 48)] \
        == [32, 64, 128, 8, 1]
    pages = torch.zeros((3, 4096), dtype=torch.uint8)
    sizes = torch.tensor([4096, 100, 0], dtype=torch.int32)
    outs, plan = RK.launch_plan(pages, sizes, 64)
    assert [s for s, _, _ in plan] == ["sort", "walk", "join"]
    assert len(plan) == RK.LAUNCHES_PER_CALL
    assert [tuple(t.shape) for t in outs] == [(3, 1025)] * 3 + [(3,)] * 2
    table, segs, marks, lists = plan[2][2][6:10]
    assert tuple(table.shape) == (3, 2, 4096)
    assert tuple(segs.shape) == (3, 4, 4)
    assert tuple(marks.shape) == (3, 4, 32)
    assert tuple(lists.shape) == (3, 4, 2, 3, 256)
