"""Brotli-G page serialization on a torch device (port of
brotlig_tpu/ops/encode_pack.py, whose XLA functions become torch ops
here; none of it is a Pallas kernel). On CUDA tensors the serializer is
one launch of a hand-written kernel (csrc/pack.cu, ops/pack_kernel.py),
where the JAX package compiles pack_pages_device with jax.jit; the torch
ops below are its plain version and the CPU route.

Given bulk-greedy commands (ops/encode.py::find_commands), whole
compressed pages are packed on the device: histograms, prefix codes, the
32-lane round-robin schedule and the self-describing size table, with no
sequential bit writing:

* code lengths: ceil(-log2 p) is prefix-free by construction; a bounded
  widen loop absorbs the rare depth-15 clip overflow, and a refine pass
  hands the Kraft slack to the most frequent symbols;
* tables are stored as the reference encoder stores them
  (BrotligHuffman.cpp:262-363): trivial / simple / complex per page,
  complex tables run-coded with the reference's RLE splitting; item j of
  a section rides stream j % 32;
* the literal interleave follows R_k = 32 * ceil(cumlit_k / 32), the
  closed form of the prev_tail recurrence (PageEncoder.cpp:518-522);
* bit packing: every emission (<= 30 bits) touches at most two 32-bit
  words; a stream's word values are differences of a prefix sum over its
  sorted contributions.

The arithmetic is int64 (torch indexes with int64, and the CPU build has
no uint32 shifts); where the JAX module relies on uint32 wraparound, the
values are masked to 32 bits. The (npostfix, ndirect) and ring-mode
searches compare entropy costs in fixed point (integer sums of rounded
float64 terms), so the same counts give the same cost in any order and on
any device; the JAX module sums float32 terms.
"""
from __future__ import annotations

import numpy as np
import torch

from ..format import constants as C
from . import arith_lut, pack_kernel
from .decode import resolve_device
from .encode import (assemble, check_feedback, find_commands, page_rows,
                     stream_setup)

I64 = torch.int64
M32 = 0xFFFFFFFF
NBS = C.NUM_BITSTREAMS

A_CMD = C.NUM_COMMAND_SYMBOLS_EFFECTIVE  # 728
A_DST = C.NUM_DISTANCE_SYMBOLS           # 544
A_LIT = C.NUM_LITERAL_SYMBOLS            # 256
CL_ORDER = (1, 2, 3, 4, 0, 5, 17, 6, 16, 7, 8, 9, 10, 11, 12, 13, 14, 15)
COST_FRAC_BITS = 16                      # fixed-point fraction of a bit
BUCKET_MIN = 2048                        # smallest command-count bucket


def _lshift(x: int, t: torch.Tensor) -> torch.Tensor:
    """The constant x shifted left by each element of t."""
    return torch.bitwise_left_shift(torch.full_like(t, x), t)


def _bitlen_arr(x: torch.Tensor) -> torch.Tensor:
    """Bit length of each element of x, for 0 <= x < 2^32."""
    bl = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        take = (x >> s) > 0
        bl = bl + torch.where(take, s, 0)
        x = torch.where(take, x >> s, x)
    return bl + (x > 0).to(x.dtype)


def _rev_bits(v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Bit-reverse the low n bits of v (n <= 15 per element)."""
    i = torch.arange(15, device=v.device)
    bit = (v[..., None] >> i) & 1
    sh = (n[..., None] - 1 - i).clamp(min=0)
    return torch.where(i < n[..., None], bit << sh, 0).sum(-1)


def _lengths_from_hist(hist: torch.Tensor, total: torch.Tensor):
    """Kraft-safe code lengths: ceil(log2(total/count)) clipped to [1, 15],
    widened until Kraft holds, then the slack handed to the most frequent
    symbols. hist: [P, A]; total: [P] (> 0 where any symbol is used)."""
    t = total.clamp(min=1)[:, None]
    h1 = hist.clamp(min=1)
    ratio = (t + h1 - 1) // h1
    lens = _bitlen_arr((ratio - 1).clamp(min=0)).clamp(1, 15)
    lens = torch.where(hist > 0, lens, 0)
    for _ in range(15):
        units = torch.where(lens > 0, _lshift(1, 15 - lens), 0)
        over = units.sum(1) > (1 << 15)
        lens = torch.where(over[:, None] & (lens > 0),
                           (lens + 1).clamp(max=15), lens)
    # refine: each pass shortens the count-ordered prefix of eligible
    # symbols whose cumulative widening cost fits the slack
    units = torch.where(lens > 0, _lshift(1, 15 - lens), 0)
    slack = (1 << 15) - units.sum(1)
    order = torch.sort(-torch.where(hist > 0, hist, -1), dim=1,
                       stable=True).indices
    inv = torch.empty_like(order).scatter_(
        1, order, torch.arange(order.shape[1], device=order.device)
        .expand_as(order))
    hist_s = torch.gather(hist, 1, order)
    for _ in range(3):
        elig = (lens > 1) & (hist > 0)
        cost = torch.where(elig, _lshift(1, 15 - lens.clamp(1, 15)), 0)
        cost_s = torch.gather(cost, 1, order)
        elig_s = torch.gather(elig, 1, order)
        cum = torch.cumsum(cost_s, dim=1)
        pay_s = elig_s & (cum <= slack[:, None]) & (hist_s > 0)
        slack = slack - torch.where(pay_s, cost_s, 0).sum(1)
        lens = lens - torch.gather(pay_s.to(I64), 1, inv)
    return lens


def _canonical_codes(lens: torch.Tensor):
    """Canonical MSB codes per symbol (assigned in symbol order per length),
    returned bit-reversed for LSB-first writing, and as they are.
    lens: [P, A]."""
    P = lens.shape[0]
    onehot = lens[:, :, None] == torch.arange(16, device=lens.device)
    counts = onehot.sum(1)
    counts[:, 0] = 0
    first = [torch.zeros(P, dtype=I64, device=lens.device)]
    for length in range(1, 16):
        first.append((first[length - 1] + counts[:, length - 1]) << 1)
    first = torch.stack(first, dim=1)                       # [P, 16]
    # rank of each symbol within its length class
    rank = torch.gather(onehot.to(I64).cumsum(1), 2,
                        lens.clamp(0, 15)[:, :, None])[:, :, 0] - 1
    rank = torch.where(lens > 0, rank, 0)
    code = torch.gather(first, 1, lens.clamp(0, 15)) + rank
    return _rev_bits(code, lens), code


def _histogram(values: torch.Tensor, valid: torch.Tensor, alphabet: int):
    """Per-row counts [P, alphabet] of the valid values in [0, alphabet)."""
    ok = valid & (values >= 0) & (values < alphabet)
    v = torch.where(ok, values, alphabet).to(I64)
    h = torch.zeros((v.shape[0], alphabet + 1), dtype=I64, device=v.device)
    h.scatter_add_(1, v, torch.ones_like(v))
    return h[:, :alphabet]


def _encode_distance(d, np_, nd_):
    """EncodeDistance (format/lut.py:125-142) of distances d >= 1 under
    postfix bits np_ and direct codes nd_ (tensors that broadcast with d).
    Returns (sym, nbits, extra)."""
    direct = d <= nd_
    dd = (d - nd_ - 1).clamp(min=0)
    postfix = dd & (_lshift(1, np_) - 1)
    hval = dd >> np_
    nb = _bitlen_arr(hval + 4) - 2
    b = ((hval + 4) >> nb) & 1
    extra = hval + 4 - ((2 + b) << nb)
    sym = 16 + nd_ + (((2 * (nb - 1) + b) << np_) | postfix)
    sym = torch.where(direct, 16 + d - 1, sym)
    nb = torch.where(direct, 0, nb)
    extra = torch.where(direct, 0, extra)
    return sym, nb, extra


def _encode_distance_vec(d, npostfix, ndirect):
    """_encode_distance with per-page parameters: d [P, N];
    npostfix/ndirect [P]."""
    return _encode_distance(d, npostfix[:, None], ndirect[:, None])


def _len_code(v, lo: int, mid_add: int, hi_lo: int, hi_add: int):
    """The middle and high branches shared by the insert and copy length
    codes: (mid, hi)."""
    nb = _bitlen_arr((v - lo).clamp(min=1)) - 2
    mid = nb * 2 + ((v - lo).clamp(min=0) >> nb.clamp(min=0)) + mid_add
    hi = _bitlen_arr((v - hi_lo).clamp(min=1)) + hi_add
    return mid, hi


def ins_code_vec(v):
    """Insert-length code (RFC 7932 table; format/lut.py), vectorized."""
    mid, hi = _len_code(v, 2, 2, 66, 9)
    return torch.where(v < 6, v, torch.where(
        v < 130, mid, torch.where(v < 2114, hi, torch.where(
            v < 6210, 21, torch.where(v < 22594, 22, 23)))))


def cpy_code_vec(v):
    """Copy-length code (RFC 7932 table; format/lut.py), vectorized."""
    mid, hi = _len_code(v, 6, 4, 70, 11)
    return torch.where(v < 10, (v - 2).clamp(min=0), torch.where(
        v < 134, mid, torch.where(v < 2118, hi, 23)))


def combine_codes_vec(ic, cc, use_last):
    """CombineLengthCodes (format/lut.py): the joint command prefix symbol
    for insert code ic, copy code cc and the implicit-ring0 flag
    use_last."""
    bits64 = (cc & 7) | ((ic & 7) << 3)
    cell = 2 * ((cc >> 3) + 3 * (ic >> 3))
    off = ((cell << 5) + 0x40
           + (torch.bitwise_right_shift(torch.full_like(cell, 0x520D40),
                                        cell.clamp(0, 20)) & 0xC0))
    prefix_nl = off | bits64
    prefix_l = torch.where(cc < 8, bits64, bits64 | 64)
    return torch.where(use_last, prefix_l, prefix_nl)


def _ring_before(dist, valid):
    """Exact distance-ring state (r0, r1, r2, r3) before each command.

    ring[0] before command j is always d_{j-1}, so pushes happen exactly
    where the distance changes, each displacing the then-ring[0] into
    ring[1]: ring[k] before j is the displaced value at the k-th most
    recent change (initial ring {4, 11, 15, 16}, PageDecoder.cpp)."""
    P, N = dist.shape
    d = torch.where(valid, dist, 0)
    r0 = torch.cat([d.new_full((P, 1), 4), d[:, :-1]], dim=1)
    push = (d != r0) & valid
    t_exc = torch.cumsum(push.to(I64), dim=1) - push.to(I64)
    # displaced values in push order after the initial ring tail:
    # pv_ext = [16, 15, 11, pv_1, pv_2, ...]; ring[k] is pv_ext[3 + t - k]
    pv_seq = torch.zeros((P, N + 1), dtype=I64, device=d.device)
    pv_seq.scatter_add_(1, torch.where(push, t_exc, N), r0)
    init = torch.tensor([16, 15, 11], dtype=I64, device=d.device)
    pv_ext = torch.cat([init.expand(P, 3), pv_seq[:, :N]], dim=1)

    def back(k):
        return torch.gather(pv_ext, 1, (3 + t_exc - k).clamp(0, N + 2))
    return r0, back(1), back(2), back(3)


def literal_cover(in_sizes, ins, cpy, valid, S: int):
    """Where each byte of a page lies under its commands: (cmd_of [P, S],
    the last command starting at or before the byte; covered [P, 1], the
    bytes the commands cover; in_lit [P, S], the byte is a literal: in an
    insert region or in the tail, and inside the page)."""
    P, N = ins.shape
    pos_idx = torch.arange(S, device=ins.device).expand(P, S).contiguous()
    cov = ins + cpy
    starts = torch.cumsum(cov, dim=1) - cov
    starts_m = torch.where(valid, starts, 1 << 29)
    cmd_of = (torch.searchsorted(starts_m, pos_idx, right=True) - 1
              ).clamp(0, N - 1)
    st_of = torch.gather(starts, 1, cmd_of)
    ins_of = torch.gather(ins, 1, cmd_of)
    covered = cov.sum(1)[:, None]
    in_lit = (((pos_idx < st_of + ins_of) | (pos_idx >= covered))
              & (pos_idx < in_sizes[:, None]))
    return cmd_of, covered, in_lit


def _suffix_min(x: torch.Tensor) -> torch.Tensor:
    return torch.cummin(x.flip(-1), dim=-1).values.flip(-1)


def _dist_cost(syms, extra_nb, mask, presorted: bool = False):
    """Distance-code cost over the last axis: entropy + extra bits + ~6
    bits of storage per used symbol (native brotlig_encode.cpp:513-519),
    in units of 2^-COST_FRAC_BITS bits, as int64. presorted=True skips the
    sort (syms ascending under the mask, masked entries at the end)."""
    N = syms.shape[-1]
    n_m = mask.sum(-1, keepdim=True)
    sv = torch.where(mask, syms, A_DST)
    if not presorted:
        sv = torch.sort(sv, dim=-1).values
    seg = torch.cat([torch.ones_like(sv[..., :1], dtype=torch.bool),
                     sv[..., 1:] != sv[..., :-1]], dim=-1) & (sv < A_DST)
    # each run's count: the next run start after its start (suffix min)
    pos = torch.arange(N, device=sv.device).expand_as(sv)
    sfx = _suffix_min(torch.where(seg, pos, N))
    nxt = torch.cat([sfx[..., 1:], torch.full_like(sfx[..., :1], N)],
                    dim=-1)
    cnt = torch.where(seg, nxt.clamp(max=N) - pos, 0)
    cnt = torch.minimum(cnt, (n_m - pos).clamp(min=0))
    live = seg & (cnt > 0)
    c = cnt.to(torch.float64)
    bits = c * (torch.log2(n_m.clamp(min=1).to(torch.float64))
                - torch.log2(c.clamp(min=1))) + 6.0
    ent = torch.where(live, torch.round(bits * (1 << COST_FRAC_BITS))
                      .to(I64), 0).sum(-1)
    return ent + (torch.where(mask, extra_nb, 0).sum(-1) << COST_FRAC_BITS)


def _build_fields(in_sizes, ins, cpy, dist, ncmds):
    """Per-command wire fields: {name: ([P, N] array, tail value [P],
    sentinel value [P])} over the command slots [commands..., tail?,
    sentinel] (see _Slots), plus (ntotal, has_tail, npostfix, ndist)
    per page for the schedule and the page header."""
    P, N = ins.shape
    dev = ins.device
    valid = torch.arange(N, device=dev)[None, :] < ncmds[:, None]
    tail = in_sizes - (ins + cpy).sum(1)

    # ---- distance ring codes 0-15 (exact ring state, zero extra bits) ----
    is_copy = valid & (cpy > 0) & (dist > 0)
    d = dist.clamp(min=1)
    r0, r1, r2, r3 = _ring_before(dist, is_copy)
    ring_code = torch.full_like(d, -1)
    # native RingShortCode order: exact hits 0-3, then ring[0/1] +/- 1..3
    cands = [(r0, 0), (r1, 1), (r2, 2), (r3, 3)]
    for k in range(3):
        cands += [(r0 - (k + 1), 4 + 2 * k), (r0 + (k + 1), 5 + 2 * k)]
    for k in range(3):
        cands += [(r1 - (k + 1), 10 + 2 * k), (r1 + (k + 1), 11 + 2 * k)]
    for val, code in reversed(cands):
        ring_code = torch.where(d == val, code, ring_code)
    ring_code = torch.where(is_copy, ring_code, -1)

    # ---- per-page (npostfix, ndirect) search over the distances that are
    # not exact ring hits (native brotlig_encode.cpp:474-527); the
    # distance -> symbol map is monotone for every grid point, so one sort
    # serves all 16, evaluated together, first minimum winning ----
    exact_hit = (ring_code >= 0) & (ring_code <= 3)
    search = is_copy & ~exact_hit
    d_srt = torch.sort(torch.where(search, d, 1 << 28), dim=1).values
    m_srt = d_srt < (1 << 28)
    d_eval = torch.where(m_srt, d_srt, 1)[:, None, :]
    grid_np = torch.arange(4, device=dev).repeat_interleave(4)
    grid_nd = torch.tensor([0, 3, 8, 15], device=dev).repeat(4)
    sym_g, nb_g, _ = _encode_distance(d_eval, grid_np[None, :, None],
                                      (grid_nd << grid_np)[None, :, None])
    best = torch.argmin(_dist_cost(sym_g, nb_g, m_srt[:, None, :],
                                   presorted=True), dim=1)
    npostfix = grid_np[best]
    ndist = grid_nd[best]
    ndirect = ndist << npostfix

    # ---- ring mode: exact hits only (0-3) vs also the offset codes 4-15
    # (zero extra bits, but a wider histogram; native :530-560) ----
    dsym_l, dnb_l, dx_l = _encode_distance_vec(d, npostfix, ndirect)
    ring_exact = torch.where(exact_hit, ring_code, -1)
    mask_m = is_copy & (ring_code != 0)
    costs = [_dist_cost(torch.where(rc >= 0, rc, dsym_l),
                        torch.where(rc >= 0, 0, dnb_l), mask_m)
             for rc in (ring_exact, ring_code)]
    ring_sel = torch.where((costs[1] < costs[0])[:, None], ring_code,
                           ring_exact)
    use_ring = ring_sel >= 0
    dsym = torch.where(use_ring, ring_sel, dsym_l)
    dnbits = torch.where(use_ring, 0, dnb_l)
    dextra = torch.where(use_ring, 0, dx_l)

    ic = ins_code_vec(ins)
    cc = cpy_code_vec(cpy)
    use_last = (ring_code == 0) & (ic < 8) & (cc < 16)
    prefix = combine_codes_vec(ic, cc, use_last)
    store_dist = valid & ~use_last
    ins_extra = ins - arith_lut.insert_base(ic)
    cpy_extra = torch.where(cc > 1, cpy - arith_lut.copy_base(cc), cpy)

    # the tail insert-only command and the sentinel are virtual slots
    tail_code = ins_code_vec(tail)
    has_tail = tail > 0
    ntotal = ncmds + 1 + has_tail.to(I64)
    zero = torch.zeros_like(tail)

    def cmd(x, where=valid):
        return torch.where(where, x, 0)
    fields = dict(
        prefix=(cmd(prefix), torch.where(has_tail, 704 + tail_code, 704),
                torch.full_like(tail, 704)),
        ins=(cmd(ins), tail, zero),
        insb=(cmd(arith_lut.insert_extra(ic)),
              torch.where(has_tail, arith_lut.insert_extra(tail_code), 0),
              zero),
        insx=(cmd(ins_extra),
              torch.where(has_tail, tail - arith_lut.insert_base(tail_code),
                          0), zero),
        cpyb=(cmd(arith_lut.copy_extra(cc)), zero, zero),
        cpyx=(cmd(cpy_extra), zero, zero),
        dsym=(cmd(dsym, store_dist), zero, zero),
        dnb=(cmd(dnbits, store_dist), zero, zero),
        dx=(cmd(dextra, store_dist), zero, zero),
        sdist=(store_dist.to(I64), zero, zero),
    )
    return fields, ntotal, has_tail, npostfix, ndist


class _Slots:
    """The virtual gather over [commands..., tail?, sentinel] at command
    slots t_idx [P, K]: a slot past the commands reads the tail value
    where the page has a tail there, else the sentinel value."""

    def __init__(self, t_idx, ncmds, has_tail, n: int):
        self.at = t_idx.clamp(0, n - 1)
        self.in_arr = t_idx < ncmds[:, None]
        self.is_tail = has_tail[:, None] & (t_idx == ncmds[:, None])

    def get(self, field):
        arr, tail_v, sent_v = field
        return torch.where(self.in_arr, torch.gather(arr, 1, self.at),
                           torch.where(self.is_tail, tail_v[:, None],
                                       sent_v[:, None]))


def _rle_items(lens, A: int):
    """Run-coded table items, mirroring the reference's splitting
    (format/rle.py::compute_rle_codes, BrotligUtils.cpp:76-228): literal
    lengths 0..15, code 16 = repeat the previous nonzero 3..6 times (2
    extra bits), code 17 = repeat zero 3..10 times (3 extra bits), with
    the first-position literal and the reps == 11 / reps == 7 splits.

    lens: [P, A]. Returns (codes, extra, ewidth) each [P, A32] and the
    item count M [P], A32 = ceil(A/32)*32; items j >= M are zero."""
    P = lens.shape[0]
    dev = lens.device
    A32 = (A + 31) // 32 * 32
    pos = torch.arange(A, device=dev).expand(P, A)

    # runs: position 0 is always its own unit; real runs start at 1
    prev_len = torch.cat([lens.new_zeros(P, 1), lens[:, :-1]], dim=1)
    start = (pos <= 1) | (lens != prev_len)
    run_id = torch.cumsum(start.to(I64), dim=1) - 1
    nruns = run_id[:, -1] + 1

    # per-run start / value / reps / previous value, in run index space
    rs = torch.zeros((P, A + 1), dtype=I64, device=dev)
    rs.scatter_add_(1, torch.where(start, run_id, A), pos)
    rs = rs[:, :A]
    v = torch.gather(lens, 1, rs.clamp(0, A - 1))
    r_next = torch.cat([rs[:, 1:], rs.new_full((P, 1), A)], dim=1)
    ridx = pos
    r_end = torch.where(ridx + 1 < nruns[:, None], r_next, A)
    reps = (r_end - rs).clamp(min=0)
    prev = torch.cat([v.new_full((P, 1), 8), v[:, :-1]], dim=1)

    is0 = ridx == 0
    zero = v == 0
    # zero runs: optional leading literal 0 (reps == 11), chunks of <= 10
    leadz = (reps == 11).to(I64)
    rz = reps - leadz
    tz, remz = rz // 10, rz % 10
    kz = tz + (remz >= 3).to(I64)
    lz = torch.where(remz >= 3, 0, remz)
    # nonzero runs: a literal if prev differs, a second if then 7 are left
    lead1 = (prev != v).to(I64)
    r1 = reps - lead1
    lead2 = (r1 == 7).to(I64)
    rn = r1 - lead2
    tn, remn = rn // 6, rn % 6
    kn = tn + (remn >= 3).to(I64)
    ln = torch.where(remn >= 3, 0, remn)

    lead = torch.where(is0, 1, torch.where(zero, leadz, lead1 + lead2))
    k = torch.where(is0, 0, torch.where(zero, kz, kn))
    ltr = torch.where(is0, 0, torch.where(zero, lz, ln))
    t = torch.where(zero, tz, tn)
    rem = torch.where(zero, remz, remn)
    n_items = torch.where(ridx < nruns[:, None], lead + k + ltr, 0)
    off = torch.cumsum(n_items, dim=1) - n_items                # exclusive
    M = off[:, -1] + n_items[:, -1]

    # item index -> run: scatter the run starts, forward-fill
    tgt = torch.where((n_items > 0) & (ridx < nruns[:, None]), off, A32)
    mark = torch.zeros((P, A32 + 1), dtype=I64, device=dev)
    mark.scatter_reduce_(1, tgt, ridx.contiguous(), "amax",
                         include_self=True)
    run_of = torch.cummax(mark[:, :A32], dim=1).values
    q = torch.arange(A32, device=dev)[None, :] - torch.gather(off, 1, run_of)

    def g(a):
        return torch.gather(a, 1, run_of)
    vi, leadi, ki, ti, remi = g(v), g(lead), g(k), g(t), g(rem)
    zi = vi == 0
    in_code = (q >= leadi) & (q < leadi + ki)
    codes = torch.where(in_code, torch.where(zi, 17, 16), vi)
    extra = torch.where(in_code, torch.where(q - leadi < ti,
                                             torch.where(zi, 7, 3),
                                             remi - 3), 0)
    ewidth = torch.where(in_code, torch.where(zi, 3, 2), 0)
    live = torch.arange(A32, device=dev)[None, :] < M[:, None]
    return (torch.where(live, codes, 0), torch.where(live, extra, 0),
            torch.where(live, ewidth, 0), M)


def _choose_table(hist, total, A: int):
    """The cheapest storage mode per page, as the reference encoder picks
    it (BrotligHuffman.cpp:262-363): <= 1 used symbol -> trivial, <= 4 ->
    simple with the decoder's fixed length rows, else complex. Returns
    (lens [P, A], mode [P] 0/1/2, emit_syms [P, 4] in (length, symbol)
    order, tsel [P], count [P])."""
    P = hist.shape[0]
    dev = hist.device
    count = (hist > 0).sum(1)
    lens_cplx = _lengths_from_hist(hist, total)

    # the used symbols ascending (padding A), and their counts
    symid = torch.arange(A, device=dev).expand(P, A)
    s4 = torch.sort(torch.where(hist > 0, symid, A), dim=1).values[:, :4]
    c4 = torch.gather(hist, 1, s4.clamp(0, A - 1))
    c4 = torch.where(s4 < A, c4, 0)

    # the four by count descending (stable on symbol) for assignment
    order = torch.sort(-c4, dim=1, stable=True).indices
    cd = torch.gather(c4, 1, order)
    # count == 4: flat {2,2,2,2} vs skew {1,2,3,3} by actual coded bits
    cost_flat = 2 * cd.sum(1)
    cost_skew = cd[:, 0] + 2 * cd[:, 1] + 3 * (cd[:, 2] + cd[:, 3])
    tsel = ((count == 4) & (cost_skew < cost_flat)).to(I64)

    def row(*x):
        return torch.tensor(x, dtype=I64, device=dev)[None, :]
    lens_by_rank = torch.where(
        count[:, None] == 2, row(1, 1, 0, 0), torch.where(
            count[:, None] == 3, row(1, 2, 2, 0), torch.where(
                tsel[:, None] == 1, row(1, 2, 3, 3), row(2, 2, 2, 2))))
    rank_of_slot = torch.argsort(order, dim=1)
    len4 = torch.gather(lens_by_rank, 1, rank_of_slot)
    len4 = torch.where(s4 < A, len4, 0)
    lens_simp = torch.zeros((P, A + 1), dtype=I64, device=dev)
    lens_simp.scatter_reduce_(1, s4.clamp(0, A), len4, "amax",
                              include_self=True)
    lens_simp = lens_simp[:, :A]

    mode = torch.where(count <= 1, 0, torch.where(count <= 4, 1, 2))
    lens = torch.where(mode[:, None] == 0, 0,
                       torch.where(mode[:, None] == 1, lens_simp, lens_cplx))
    # emission order: the decoder assigns its fixed rows in listed order,
    # and those rows are nondecreasing -> sort by (length, symbol)
    ek = torch.where(s4 < A, len4 * (A + 1) + s4, 16 * (A + 1) + A)
    emit_syms = torch.gather(s4, 1, torch.sort(ek, dim=1,
                                               stable=True).indices)
    emit_syms = torch.where(emit_syms < A, emit_syms, 0)
    return lens, mode, emit_syms, tsel, count


def _table_block(mode, cl_lens, cl_codes, item_c, item_x, item_w, M,
                 emit_syms, tsel, count, A: int):
    """Emission slots of one table, per stream, in all three storage
    modes: (nbits [P, 32, K], vals [P, 32, K]) with K = 2 + ceil(A/32):
    [header, cl lengths or simple symbols, item columns]. Unit j of a
    section lands in stream j % 32 (format/swizzle.py)."""
    P = cl_lens.shape[0]
    dev = cl_lens.device
    kmax = (A + 31) // 32
    max_bits = (A - 1).bit_length()
    s_idx = torch.arange(NBS, device=dev)[None, :]
    m_s = (mode == 1)[:, None]
    m_c = (mode == 2)[:, None]
    # header column, stream 0 only. trivial: type0 + 4 pad bits + symbol;
    # simple: type1 + (count-1) + 2 select bits + first symbol; complex:
    # type2 + (18-4). (huffman.py:169-240)
    hdr_t = (1 << 2) | (emit_syms[:, 0] << 6)
    hdr_s = (1 | ((count - 1).clamp(min=0) << 2) | (tsel << 4)
             | (emit_syms[:, 0] << 6))
    hdr_v = torch.where(mode == 0, hdr_t,
                        torch.where(mode == 1, hdr_s, 2 | ((18 - 4) << 2)))
    hdr_n = torch.where(mode == 2, 6, 6 + max_bits)
    col_n = [torch.where(s_idx == 0, hdr_n[:, None], 0)]
    col_v = [hdr_v[:, None].expand(P, NBS)]
    # second column: complex cl lengths (5 bits, streams 0..17, CL_ORDER);
    # simple remaining symbols (max_bits, streams 1..count-1)
    cl_at = cl_lens[:, list(CL_ORDER)]
    cl_slot_v = torch.cat([cl_at, cl_at.new_zeros(P, 14)], dim=1)
    sym_slot_v = torch.cat([emit_syms.new_zeros(P, 1), emit_syms[:, 1:4],
                            emit_syms.new_zeros(P, 28)], dim=1)
    n2 = torch.where(m_c & (s_idx < 18), 5, 0)
    n2 = torch.where(m_s & (s_idx >= 1) & (s_idx < count[:, None]),
                     max_bits, n2)
    col_n.append(n2)
    col_v.append(torch.where(m_c, cl_slot_v,
                             torch.where(m_s, sym_slot_v, 0)))
    # item columns (complex only): item j = k*32 + s, its extra bits in
    # the same slot as its code
    ci = item_c.clamp(0, 17)
    cl_n_of = torch.gather(cl_lens, 1, ci)
    it_n = cl_n_of + item_w
    it_v = torch.gather(cl_codes, 1, ci) | (item_x << cl_n_of.clamp(max=15))
    j = torch.arange(kmax * NBS, device=dev)[None, :]
    live = m_c & (j < M[:, None])
    items_n = torch.where(live, it_n, 0).view(P, kmax, NBS).transpose(1, 2)
    items_v = torch.where(live, it_v, 0).view(P, kmax, NBS).transpose(1, 2)
    return (torch.cat([torch.stack(col_n, dim=2), items_n], dim=2),
            torch.cat([torch.stack(col_v, dim=2), items_v], dim=2))


def _cl_tree(item_c, item_live, M):
    """The code-length code (depth <= 9) over a table's run-coded items:
    (lengths [P, 18], reversed codes [P, 18])."""
    L = _lengths_from_hist(_histogram(item_c, item_live, 18), M).clamp(max=9)
    for _ in range(9):
        units = torch.where(L > 0, _lshift(1, 9 - L), 0)
        over = units.sum(1) > (1 << 9)
        L = torch.where(over[:, None] & (L > 0), (L + 1).clamp(max=9), L)
    return L, _canonical_codes(L)[0]


def _word_sum(contrib, widx, w_ids):
    """Per-stream 32-bit words from (contribution, word index) pairs
    sorted by word index: differences of the contributions' prefix sum at
    the word boundaries, modulo 2^32."""
    csum = torch.cumsum(contrib, dim=2)
    bound = torch.searchsorted(widx.contiguous(), w_ids)
    bz = torch.cat([torch.zeros_like(csum[:, :, :1]), csum], dim=2)
    at = torch.gather(bz, 2, bound)
    return (at[:, :, 1:] - at[:, :, :-1]) & M32


def pack_pages_device(pages, in_sizes, ins, cpy, dist, ncmds,
                      page_size: int, max_cmds: int, isdelta=None):
    """Serialize compressed pages on their device.

    pages: uint8 [P, S]; in_sizes, ncmds: [P]; ins/cpy/dist: [P, N]
    commands (zero past ncmds); max_cmds: the command bound that sets the
    round count. Returns (out [P, page_size] uint8, out_sizes [P] int64);
    a page whose compressed size is not below its input size must be
    stored raw by the caller (out_sizes is still the compressed size, or
    page_size + 1 where a stream overflowed its word budget).
    isdelta: optional [P] delta-encoded flags for the page header byte.

    CUDA tensors go to the hand-written kernel (csrc/pack.cu, one launch),
    CPU tensors to the plain version, pack_pages_plain."""
    if pages.device.type == "cuda":
        return pack_kernel.pack_cuda(pages, in_sizes, ins, cpy, dist, ncmds,
                                     page_size, max_cmds, isdelta)
    return pack_pages_plain(pages, in_sizes, ins, cpy, dist, ncmds,
                            page_size, max_cmds, isdelta)


def stream_budget(page_size: int) -> int:
    """Wst, the 32-bit words a sub-stream may fill: three quarters of a
    stored page's share, plus 16 for the tables."""
    return (page_size // NBS) // 4 * 3 + 16


def page_histograms(pages, in_sizes, ins, cpy, dist, ncmds):
    """The wire fields and the three histograms a page's prefix codes are
    built from (int64 inputs): (fields, ntotal, has_tail, npostfix, ndist
    as _build_fields returns them, literal_cover's (cmd_of, covered,
    in_lit), (command [P, 728], distance [P, 544], literal [P, 256])
    histograms). The literal histogram counts the insert regions and the
    tail; the command one also the tail's and the sentinel's symbols."""
    N = ins.shape[1]
    fields, ntotal, has_tail, npostfix, ndist = _build_fields(
        in_sizes, ins, cpy, dist, ncmds)
    valid = torch.arange(N, device=ins.device)[None, :] < ncmds[:, None]
    hist_cmd = _histogram(fields["prefix"][0], valid, A_CMD)
    hist_cmd.scatter_add_(1, fields["prefix"][1].clamp(0, A_CMD - 1)[:, None],
                          has_tail.to(I64)[:, None])
    hist_cmd[:, 704] += 1
    hist_dst = _histogram(fields["dsym"][0], fields["sdist"][0] > 0, A_DST)
    cover = literal_cover(in_sizes, ins, cpy, valid, pages.shape[1])
    hist_lit = _histogram(pages.to(I64), cover[2], A_LIT)
    return (fields, ntotal, has_tail, npostfix, ndist, cover,
            (hist_cmd, hist_dst, hist_lit))


def _slot_planes(pages, in_sizes, ins, cpy, dist, ncmds, page_size: int,
                 max_cmds: int):
    """Every sub-stream's emission slots in order: (nbits [P, 32, K],
    values [P, 32, K], npostfix [P], ndist [P]): the table block (the
    three tables' header, code-length or symbol column and run-coded item
    columns), then each round's five command fields and its literals."""
    P, S = pages.shape
    dev = pages.device
    in_sizes = in_sizes.to(I64)
    ncmds = ncmds.to(I64)
    ins, cpy, dist = ins.to(I64), cpy.to(I64), dist.to(I64)
    N = ins.shape[1]
    (fields, ntotal, has_tail, h_np, h_ndist, (_, _, in_lit),
     (hist_cmd, hist_dst, hist_lit)) = page_histograms(
        pages, in_sizes, ins, cpy, dist, ncmds)
    page_bytes = pages.to(I64)
    n_lits = hist_lit.sum(1)
    most_freq = torch.argmax(hist_lit, dim=1)

    # ---- storage mode, code lengths, canonical codes ----
    cmd_lens, cmd_mode, cmd_es, cmd_ts, cmd_cnt = _choose_table(
        hist_cmd, hist_cmd.sum(1), A_CMD)
    dst_lens, dst_mode, dst_es, dst_ts, dst_cnt = _choose_table(
        hist_dst, hist_dst.sum(1), A_DST)
    lit_lens, lit_mode, lit_es, lit_ts, lit_cnt = _choose_table(
        hist_lit, n_lits, A_LIT)
    cmd_codes = _canonical_codes(cmd_lens)[0]
    dst_codes = _canonical_codes(dst_lens)[0]
    lit_codes = _canonical_codes(lit_lens)[0]

    # ---- table emission block (mode-dependent, run-coded items) ----
    tb_n, tb_v = [], []
    for md, sy_l, es, ts, cnt, A in (
            (cmd_mode, cmd_lens, cmd_es, cmd_ts, cmd_cnt, A_CMD),
            (dst_mode, dst_lens, dst_es, dst_ts, dst_cnt, A_DST),
            (lit_mode, lit_lens, lit_es, lit_ts, lit_cnt, A_LIT)):
        it_c, it_x, it_w, M = _rle_items(sy_l, A)
        live = torch.arange(it_c.shape[1], device=dev)[None, :] < M[:, None]
        cl_l, cl_c = _cl_tree(it_c, live, M)
        n, v = _table_block(md, cl_l, cl_c, it_c, it_x, it_w, M, es, ts,
                            cnt, A)
        tb_n.append(n)
        tb_v.append(v)

    # ---- round schedule ----
    R = (max_cmds + 2 + NBS - 1) // NBS
    slot_ids = torch.arange(R * NBS, device=dev).expand(P, R * NBS)
    ins_slots = _Slots(slot_ids, ncmds, has_tail, N).get(fields["ins"])
    ins_slots = torch.where(slot_ids < ntotal[:, None], ins_slots, 0)
    cumlit = torch.cumsum(ins_slots.view(P, R, NBS).sum(2), dim=1)
    eff = ntotal.clamp(max=NBS)
    f_round = (ntotal - 1) // NBS                       # final round index
    R_full = 32 * ((cumlit + 31) // 32)
    r_idx = torch.arange(R, device=dev)[None, :]
    Rf_prev = torch.where(f_round > 0, torch.gather(
        R_full, 1, (f_round - 1).clamp(min=0)[:, None])[:, 0], 0)
    cum_f = torch.gather(cumlit, 1, f_round[:, None])[:, 0]
    ac_f = (cum_f - Rf_prev).clamp(min=0)
    e = eff.clamp(min=1)
    R_final = Rf_prev + e * ((ac_f + e - 1) // e)
    Rarr = torch.where(r_idx < f_round[:, None], R_full, R_final[:, None])
    Rprev = torch.cat([Rarr.new_zeros(P, 1), Rarr[:, :-1]], dim=1)
    lits_r = (Rarr - Rprev).clamp(min=0)                # [P, R]

    # per-(stream, round) literal counts and emission slot bases
    s_ids = torch.arange(NBS, device=dev)
    cnt = ((lits_r[:, :, None] - s_ids).clamp(min=0) + 31) // 32  # [P,R,32]
    per_rs = 5 + cnt
    base = (torch.cumsum(per_rs, dim=1) - per_rs).transpose(1, 2)  # [P,32,R]
    base = base.contiguous()
    cnt_sr = cnt.transpose(1, 2)

    lit_cap = page_size + 64
    Edyn = 6 * R + lit_cap // 32 + 2
    e_ids = torch.arange(Edyn, device=dev).expand(P, NBS, Edyn).contiguous()
    r_of = (torch.searchsorted(base, e_ids, right=True) - 1).clamp(0, R - 1)
    u = e_ids - torch.gather(base, 2, r_of)
    cnt_r = torch.gather(cnt_sr, 2, r_of)
    s_col = s_ids[None, :, None]
    cmd_slot = r_of * NBS + s_col                               # [P,32,E]
    is_cmd_field = (u < 5) & (cmd_slot < ntotal[:, None, None])
    is_lit = (u >= 5) & (u - 5 < cnt_r)

    # ---- literal queue (insert regions + tail, then padding) ----
    lit_rank = torch.cumsum(in_lit.to(I64), dim=1)             # inclusive
    q_ids = torch.arange(lit_cap, device=dev).expand(P, lit_cap)
    lq_pos = torch.searchsorted(lit_rank, (q_ids + 1).contiguous())
    lq = torch.gather(page_bytes, 1, lq_pos.clamp(0, S - 1))
    lq = torch.where(q_ids < n_lits[:, None], lq, most_freq[:, None])

    # ---- resolve the dynamic slots to (nbits, value) ----
    slots = _Slots(cmd_slot.view(P, NBS * Edyn), ncmds, has_tail, N)

    def vgather(name):
        return slots.get(fields[name]).view(P, NBS, Edyn)

    def lookup(table, idx):
        return torch.gather(table, 1, idx.reshape(P, -1)).view(P, NBS, Edyn)
    pfx = vgather("prefix").clamp(0, A_CMD - 1)
    sd = vgather("sdist") > 0
    dsymg = vgather("dsym").clamp(0, A_DST - 1)
    j_global = (torch.gather(Rprev[:, None, :].expand(P, NBS, R), 2, r_of)
                + (u - 5) * NBS + s_col)
    lbyte = lookup(lq, j_global.clamp(0, lit_cap - 1))
    field_n = [lookup(cmd_lens, pfx), vgather("insb"), vgather("cpyb"),
               torch.where(sd, lookup(dst_lens, dsymg), 0),
               torch.where(sd, vgather("dnb"), 0)]
    field_v = [lookup(cmd_codes, pfx), vgather("insx"), vgather("cpyx"),
               lookup(dst_codes, dsymg), vgather("dx")]
    nb = torch.where(is_lit, lookup(lit_lens, lbyte), 0)
    vv = torch.where(is_lit, lookup(lit_codes, lbyte), 0)
    for k in range(5):
        at_k = is_cmd_field & (u == k)
        nb = torch.where(at_k, field_n[k], nb)
        vv = torch.where(at_k, field_v[k], vv)

    # the static table block first
    nbits_all = torch.cat(tb_n + [nb], dim=2)
    vals_all = torch.cat(tb_v + [vv], dim=2) & M32
    return nbits_all, vals_all, h_np, h_ndist


def _stream_words(nbits_all, vals_all, Wst: int):
    """Bit packing per stream: (words [P, 32, Wst], bits [P, 32]). Each
    slot (<= 30 bits) touches at most two 32-bit words; bits past Wst
    words are dropped."""
    P = nbits_all.shape[0]
    offs = torch.cumsum(nbits_all, dim=2) - nbits_all           # exclusive
    stream_bits = offs[:, :, -1] + nbits_all[:, :, -1]
    sh = offs & 31
    live = nbits_all > 0
    contrib_a = torch.where(live, (vals_all << sh) & M32, 0)
    contrib_b = torch.where(live & (sh > 0), vals_all >> (32 - sh), 0)
    w_ids = torch.arange(Wst + 1, device=nbits_all.device)
    w_ids = w_ids.expand(P, NBS, Wst + 1).contiguous()
    widx_a = offs >> 5
    stream_words = (_word_sum(contrib_a, widx_a, w_ids)
                    + _word_sum(contrib_b, widx_a + 1, w_ids)) & M32
    return stream_words, stream_bits


def pack_pages_plain(pages, in_sizes, ins, cpy, dist, ncmds,
                     page_size: int, max_cmds: int, isdelta=None):
    """pack_pages_device as torch ops on any device (the CPU route, and
    the statement the CUDA kernel is held to)."""
    P = pages.shape[0]
    dev = pages.device
    nbits_all, vals_all, h_np, h_ndist = _slot_planes(
        pages, in_sizes, ins, cpy, dist, ncmds, page_size, max_cmds)
    Wst = stream_budget(page_size)
    stream_words, stream_bits = _stream_words(nbits_all, vals_all, Wst)
    overflow = stream_bits > 32 * Wst

    # ---- page header + size table (BrotligSwizzler.cpp:68-142 fixed
    # point) ----
    stream_bytes = (stream_bits + 7) // 8                       # [P, 32]
    tot_sb = stream_bytes.sum(1)
    mn_sb = stream_bytes.min(1).values
    off_sb = stream_bytes - mn_sb[:, None]
    delta_bits = _bitlen_arr(off_sb).max(1).values.clamp(min=1)
    hdr_bits0 = 8                                       # page header byte
    est = ((hdr_bits0 + 7) // 8 + 3) // 4 * 4 + tot_sb
    for _ in range(6):  # the fixed point converges in a few steps
        base_bits = _bitlen_arr((est + 31) // 32)
        dbs_bits = _bitlen_arr(_bitlen_arr((est - 1).clamp(min=1)))
        nh = hdr_bits0 + base_bits + dbs_bits + NBS * delta_bits
        est = ((nh + 7) // 8 + 3) // 4 * 4 + tot_sb
    hdr_bits = hdr_bits0 + base_bits + dbs_bits + NBS * delta_bits
    hdr_bytes = (hdr_bits + 31) // 32 * 4
    HW = 24
    hdr_words = torch.zeros((P, HW), dtype=I64, device=dev)

    def hput(bitoff, nbits, value):
        """Add one variable-width field per page to the header words."""
        w = (bitoff >> 5)[:, None]
        shl = bitoff & 31
        v = value & torch.where(nbits >= 32, M32,
                                _lshift(1, nbits.clamp(max=31)) - 1)
        put = nbits > 0
        hdr_words.scatter_add_(1, w.clamp(0, HW - 1),
                               torch.where(put, (v << shl) & M32, 0)[:, None])
        spill = torch.where(put & (shl > 0), v >> (32 - shl), 0)
        hdr_words.scatter_add_(1, (w + 1).clamp(0, HW - 1), spill[:, None])
        return bitoff + nbits

    # page header byte LSB-first: npostfix(2), ndist(4), isdelta(1),
    # reserved(1) = 0 (format/constants.py:44-47)
    hdr_byte0 = h_np | (h_ndist << 2)
    if isdelta is not None:
        hdr_byte0 = hdr_byte0 | ((isdelta.to(I64) & 1) << 6)
    eight = torch.full((P,), 8, dtype=I64, device=dev)
    bo = hput(torch.zeros_like(eight), eight, hdr_byte0)
    bo = hput(bo, base_bits, mn_sb)
    bo = hput(bo, dbs_bits, delta_bits)
    for s in range(NBS):
        bo = hput(bo, delta_bits, off_sb[:, s])
    hdr_words &= M32

    # ---- assemble: header words + concatenated streams, DWORD padded ----
    out_total = hdr_bytes + (tot_sb + 3) // 4 * 4
    sb_prefix = torch.cat([stream_bytes.new_zeros(P, 1),
                           torch.cumsum(stream_bytes, dim=1)], dim=1)
    b_ids = torch.arange(page_size, device=dev).expand(P, page_size)
    pay_b = (b_ids - hdr_bytes[:, None]).contiguous()
    strm_of = (torch.searchsorted(sb_prefix, pay_b, right=True) - 1
               ).clamp(0, NBS - 1)
    in_strm = pay_b - torch.gather(sb_prefix, 1, strm_of)
    widx = (strm_of * Wst + (in_strm >> 2)).clamp(0, NBS * Wst - 1)
    wval = torch.gather(stream_words.reshape(P, NBS * Wst), 1, widx)
    pay_byte = (wval >> ((in_strm & 3) << 3)) & 0xFF
    hw_byte = torch.gather(hdr_words, 1, (b_ids >> 2).clamp(0, HW - 1))
    hdr_byte = (hw_byte >> ((b_ids & 3) << 3)) & 0xFF
    out = torch.where(b_ids < hdr_bytes[:, None], hdr_byte,
                      torch.where(pay_b < ((tot_sb[:, None] + 3) // 4) * 4,
                                  pay_byte, 0)).to(torch.uint8)
    out_sizes = torch.where(overflow.any(1), page_size + 1, out_total)
    return out, out_sizes


def command_bucket(n: int, max_cmds: int) -> int:
    """The command bound a page with n commands is packed under: the
    smallest power of two from 2048 up that holds n + 2 slots (commands,
    tail, sentinel), at most max_cmds."""
    b = BUCKET_MIN
    while b < n + 2:
        b *= 2
    return min(b, max_cmds)


def pack_partitioned(pages, in_sizes, page_size: int, max_cmds: int,
                     ins, cpy, dist, ncmds, isdelta):
    """Pack a batch of pages: on CUDA tensors one launch of the kernel
    for the whole batch (a page's bytes do not depend on the command bound
    it is packed under), on CPU tensors pack_partitioned_plain. Returns
    (out [P, page_size] uint8, out_sizes [P] int64) on the pages'
    device."""
    if pages.device.type == "cuda":
        return pack_kernel.pack_cuda(pages, in_sizes, ins, cpy, dist, ncmds,
                                     page_size, max_cmds, isdelta)
    return pack_partitioned_plain(pages, in_sizes, page_size, max_cmds,
                                  ins, cpy, dist, ncmds, isdelta)


def pack_partitioned_plain(pages, in_sizes, page_size: int, max_cmds: int,
                           ins, cpy, dist, ncmds, isdelta):
    """The plain version in groups by command count (see command_bucket).

    The schedule's round count, and with it every [P, 32, E] emission
    plane, follows the command bound; grouping pages by their real command
    count keeps one dense page from widening the whole batch. A group has
    exactly its pages (the JAX module pads groups to power-of-two row
    counts to bound its compiles; rows are independent, so the bytes are
    the same). Returns (out [P, page_size] uint8, out_sizes [P]) on the
    pages' device."""
    P = pages.shape[0]
    groups: dict = {}
    for i, n in enumerate(ncmds.tolist()):
        groups.setdefault(command_bucket(n, max_cmds), []).append(i)
    out = torch.empty((P, page_size), dtype=torch.uint8, device=pages.device)
    out_sizes = torch.empty(P, dtype=I64, device=pages.device)
    for b, idxs in sorted(groups.items()):
        rix = torch.tensor(idxs, device=pages.device)
        o, sz = pack_pages_plain(
            pages[rix], in_sizes[rix], ins[rix, :b], cpy[rix, :b],
            dist[rix, :b], ncmds[rix], page_size, b, isdelta[rix])
        out[rix] = o
        out_sizes[rix] = sz
    return out, out_sizes


def page_blobs(out, out_sizes, in_sizes, raw_pages):
    """Each page's blob from host arrays: the compressed bytes, or the raw
    page (raw_pages' row) where compression did not make it smaller."""
    blobs = []
    for i in range(len(in_sizes)):
        n, sz = int(in_sizes[i]), int(out_sizes[i])
        blobs.append(raw_pages[i, :n].tobytes() if sz >= n
                     else out[i, :sz].tobytes())
    return blobs


def encode_pages_device(pages_np, in_sizes_np, page_size: int,
                        isdelta_np=None, raw_pages_np=None,
                        quality: int = 11, device="cuda"):
    """Page encode on `device`: the bulk matcher and the device serializer.
    quality < 10 packs the matcher's fast (q1) tier's greedy parse;
    quality >= 10 packs the exact tier's greedy parse, runs the windowed-DP
    optimal parse (ops/parse_dp.py) seeded with it, packs that too, and
    keeps the DP page where it is strictly smaller. Returns a list of page
    blobs: the compressed page, or the raw page bytes when not smaller.
    For preconditioned streams pages_np holds the delta-encoded form and
    raw_pages_np the conditioned non-delta form that a raw page stores
    (the decoder skips the delta decode on raw pages)."""
    from .parse_dp import find_commands_dp   # parse_dp imports this module
    dev = resolve_device(device)
    max_cmds = page_size // 4 + 16   # every command copies >= MIN_MATCH = 4
    pages = torch.from_numpy(np.ascontiguousarray(pages_np)).to(dev)
    in_sizes = torch.from_numpy(np.asarray(in_sizes_np, np.int64)).to(dev)
    if isdelta_np is None:
        isdelta_np = np.zeros(pages_np.shape[0], dtype=np.int64)
    isdelta = torch.from_numpy(np.asarray(isdelta_np, np.int64)).to(dev)
    greedy = find_commands(pages, in_sizes, max_cmds, fast=quality < 10)
    out, sizes = pack_partitioned(pages, in_sizes, page_size, max_cmds,
                                  *greedy, isdelta)
    if quality >= 10:
        dcmds = find_commands_dp(pages, in_sizes, max_cmds,
                                 greedy_cmds=greedy)
        out2, sizes2 = pack_partitioned(
            pages, in_sizes, page_size, max_cmds,
            *(torch.from_numpy(x).to(dev) for x in dcmds), isdelta)
        win = sizes2 < sizes
        out = torch.where(win[:, None], out2, out)
        sizes = torch.where(win, sizes2, sizes)
    raw = pages_np if raw_pages_np is None else raw_pages_np
    return page_blobs(out.cpu().numpy(), sizes.cpu().numpy(), in_sizes_np,
                      raw)


def encode_stream_full(data: bytes, page_size: int = 65536,
                       batch_pages: int = 64, dc_params=None, feedback=None,
                       quality: int = 11, device="cuda") -> bytes:
    """Container encode with match finding AND serialization on `device`
    (the native packer is not involved). `dc_params` enables BCn
    preconditioning, conditioned and delta-encoded on `device` too.
    quality >= 10 runs the windowed-DP optimal parse, each page the
    smaller of it and the greedy parse (see encode_pages_device).

    feedback(msg_type, text) -> bool is called once per page batch;
    returning True raises format.errors.Aborted."""
    dev = resolve_device(device)
    header, precondition, raw_form, work, isdelta = stream_setup(
        data, page_size, dc_params, dev)
    if not data:
        return header.pack()
    num_pages = header.num_pages
    pages_out = []
    for c0 in range(0, num_pages, batch_pages):
        group = list(range(c0, min(c0 + batch_pages, num_pages)))
        arr, sizes = page_rows(work, group, page_size)
        raw, _ = page_rows(raw_form, group, page_size)
        flags = np.asarray([isdelta[i] for i in group], dtype=np.int64)
        pages_out.extend(encode_pages_device(arr, sizes, page_size, flags,
                                             raw, quality, dev))
        check_feedback(feedback, len(pages_out), num_pages)
    return assemble(header, precondition, dc_params, pages_out)
