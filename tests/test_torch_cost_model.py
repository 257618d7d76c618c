"""The q11 cost model's kernels (csrc/cost_model.cu) and their formulation,
held to the plain version (ops/parse_dp.py::build_cost_model_plain) with
tolerance 0. The plain version is pinned to the JAX package by
tests/test_torch_parse_dp.py, so this file calls no JAX function and
compiles no JAX executable.

CPU part: `twin_model` is a numpy rendering of what the kernels compute,
step for step where it differs from the plain version: half-bit cost
tables (twice a used symbol's code length, the unseen cost otherwise) in
place of float32 gathers, the ring before each command as the serializer
kernel's list of pushed values, the covering command by a binary search
per position, the ring probes as a byte loop counted to min(16, size -
pos), and the lowest ring code by a first-match loop. The statistics and
code lengths come from the serializer's plain functions, which the kernel
shares with csrc/pack.cu (held to them by tests/test_torch_pack.py). Cases:
text, structured, repetitive, random and all-zero pages (greedy commands
at the bounds S // 2 + 2, and 200, which the text page fills; rows of
2016 bytes);
a page whose literal table is trivial (one symbol) with no command, one
whose literal table is simple (three symbols), one its commands cover
exactly with no tail, a short page with garbage past its size, distances
of 1 (ring offsets r0 - k <= 0) and the initial ring at the page start
(pos - r < 0); the DP's own commands in a second iteration; 32, 64 and
128 KiB rows.

GPU part (`cuda` marker, skips without a card): the kernels against the
plain version on the card on the same cases, with their launches counted;
the kernels' unseen-symbol half-bits against parse_dp.unseen_bits for
every total in [1, 2^18); the wrapper refusing shapes it does not take.

Cold time on one torch thread: ~17 s, 12 s of it the tests (this file
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


def _covering(starts, covered: int, n: int, S_: int):
    """Each position's column: the last command starting at or before it
    (a binary search a position), n at or past the covered bytes."""
    pos = np.arange(S_)
    if n == 0:
        return np.zeros(S_, np.int64)
    lo = np.zeros(S_, np.int64)
    hi = np.full(S_, n - 1, np.int64)
    while (lo < hi).any():
        live = lo < hi
        mid = (lo + hi + 1) >> 1
        take = starts[np.minimum(mid, n - 1)] <= pos
        lo = np.where(live & take, mid, lo)
        hi = np.where(live & ~take, mid - 1, hi)
    return np.where(pos < covered, lo, n)


def _probe(row, size: int, r):
    """The ring probe at every position: the common prefix of the bytes
    at pos and pos - r, counted to min(16, size - pos), kept from 2 on."""
    S_ = len(row)
    pos = np.arange(S_)
    room = np.minimum(16, min(size, S_) - pos)
    alive = (r >= 1) & (pos - r >= 0)
    m = np.zeros(S_, np.int64)
    for j in range(16):
        a = row[np.minimum(pos + j, S_ - 1)]
        b = row[np.clip(pos - r + j, 0, S_ - 1)]
        alive &= (j < room) & (a == b)
        m += alive
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


def twin_model(arr, sizes, ins, cpy, dist, ncmds, base_len, base_dist):
    """The six cost-model outputs as the kernels compute them (int64
    numpy)."""
    P, S_ = arr.shape
    t64 = [torch.from_numpy(np.asarray(x, np.int64))
           for x in (sizes, ins, cpy, dist, ncmds)]
    (_, _, _, npostfix, ndist, _, hists) = TP.page_histograms(
        torch.from_numpy(arr), *t64)
    npostfix, ndist = npostfix.numpy(), ndist.numpy()
    tabs = []
    for h, A, pad in zip(hists, (TP.A_CMD, TP.A_DST, TP.A_LIT),
                         (2.0, 4.0, 2.0)):
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
            _covering(starts, int(ln.sum()), n, S_)]
        probes = [_probe(arr[p], int(sizes[p]), ring[:, k]) for k in range(4)]
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


KINDS = [("text", S), ("structured", S - 97), ("repetitive", S),
         ("random", 1000), ("zeros", S)]
BIG = {"32k": ("text", 32768, 32768), "64k": ("structured", 65536, 65536),
       "128k": ("text", 131072, 131072 - 5000)}
CASES = ("kinds", "bound_200", "s2016", "edges", "dp_second", "32k", "64k",
         "128k")


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
    kind, S_, n = BIG[name]
    arr, sizes = _rows([(kind, n)], S_, seed=7)
    return (arr, sizes) + _greedy(arr, sizes)


def plain(args, dev="cpu"):
    return TD.build_cost_model_plain(
        *[torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in args])


# ---------------------------------------------------------------------------
# CPU: the twin against the plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", CASES)
def test_twin_equals_plain(name):
    args = case(name)
    got = twin_model(*args)
    for nm, g, w in zip(MODEL, got, plain(args)):
        np.testing.assert_array_equal(g, w.numpy(), err_msg=nm)


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
