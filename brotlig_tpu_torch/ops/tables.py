"""Batched Brotli-G page-header parsing and Huffman table loading (torch
port of brotlig_tpu/ops/tables.py).

Everything is vectorized over a batch of pages [P] with 32 lanes per page.
The RLE code-length stream is decoded speculatively per lane: lane s owns
items s, s+32, ... of the round-robin schedule, so all 32 lanes parse in
lockstep and the true item count and per-lane bit positions are
reconciled afterwards. This module is the plain version of the tables
kernel (csrc/tables.cu), and the tests pin it to the JAX module.

Integer work is int64 throughout; where XLA defines a result for a shift
by a negative or too-large amount (it is 0), the port writes that out.
"""
from __future__ import annotations

import torch

from ..format import constants as C

from .bits import peek_bits

I64 = torch.int64

CL_ORDER = (1, 2, 3, 4, 0, 5, 17, 6, 16, 7, 8, 9, 10, 11, 12, 13, 14, 15)
# fixed code lengths of the simple storage mode, by table index:
# 0:(1,1) 1:(1,2,2) 2:(2,2,2,2) 3:(1,2,3,3)
SIMPLE_FIXED = ((1, 1, 0, 0), (1, 2, 2, 0), (2, 2, 2, 2), (1, 2, 3, 3))

# Bits of page header + size table never exceed 8 + 20 + 5 + 32*18 < 1024
# (widths derive from in_size <= 128 KiB), so header parsing only needs the
# first HEADER_WORDS words of each page.
HEADER_WORDS = 32


def bit_length(x):
    """Integer bit_length (position of highest set bit + 1), vectorized."""
    x = x.to(I64)
    r = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        t = x >> s
        take = t > 0
        r = r + torch.where(take, s, 0)
        x = torch.where(take, t, x)
    return r + (x > 0).to(I64)


def parse_page_headers_full(words, in_sizes):
    """Parse page header + size table for a batch of compressed pages
    (PageDecoder.cpp:83-121).

    words: [P, W] uint32 values; in_sizes: [P] compressed byte sizes.
    Returns (npostfix, ndirect, isdelta [P], lane_bitpos [P, 32],
    stream_bytes [P, 32] byte offset of each sub-stream)."""
    P = words.shape[0]
    dev = words.device
    nbs = C.NUM_BITSTREAMS
    in_sizes = in_sizes.to(I64)
    pos0 = torch.zeros((P, 1), dtype=I64, device=dev)
    npostfix = peek_bits(words, pos0, 2)[:, 0]
    ndbits = peek_bits(words, pos0 + 2, 4)[:, 0]
    ndirect = ndbits << npostfix
    isdelta = peek_bits(words, pos0 + 6, 1)[:, 0]

    r_avg = (in_sizes + nbs - 1) // nbs
    base_size_bits = bit_length(r_avg)
    delta_bits_size_bits = bit_length(bit_length(in_sizes - 1))

    p8 = torch.full((P, 1), 8, dtype=I64, device=dev)
    base_size = peek_bits(words, p8, base_size_bits[:, None])[:, 0]
    delta_size_bits = peek_bits(words, p8 + base_size_bits[:, None],
                                delta_bits_size_bits[:, None])[:, 0]

    header_bits = (8 + base_size_bits + delta_bits_size_bits
                   + nbs * delta_size_bits)
    header_bits = (header_bits + 31) // 32 * 32

    lane = torch.arange(nbs, dtype=I64, device=dev)[None, :]
    delta_pos = (8 + base_size_bits + delta_bits_size_bits)[:, None] \
        + lane * delta_size_bits[:, None]
    deltas = peek_bits(words, delta_pos, delta_size_bits[:, None])
    stream_len = base_size[:, None] + deltas
    stream_start = torch.cumsum(stream_len, dim=1) - stream_len
    stream_bytes = header_bits[:, None] // 8 + stream_start
    lane_bitpos = stream_bytes * 8
    return npostfix, ndirect, isdelta, lane_bitpos, stream_bytes


def narrow_stream_view(words, stream_bytes, tl: int):
    """Compact per-stream table view: the first `tl` words of each of the
    32 sub-streams, stream-major — view[p, s*tl + w] = bytes
    [stream_bytes[p,s] + 4w, +4) of page p. Returns (view [P, 32*tl],
    bp0 [P, 32] bit position of each stream's start within the view)."""
    P, W = words.shape
    dev = words.device
    w_idx = torch.arange(tl + 1, dtype=I64, device=dev)
    byte0 = stream_bytes.to(I64)[:, :, None] + 4 * w_idx[None, None, :]
    flat = byte0.reshape(P, 32 * (tl + 1))
    g = torch.gather(words, 1, (flat >> 2).clamp(0, W - 1)) \
        .reshape(P, 32, tl + 1)
    sh = (byte0 & 3) * 8
    shl = sh[:, :, :tl]
    hi = torch.where(shl == 0, 0,
                     (g[:, :, 1:] << (32 - shl).clamp(max=31)) & 0xFFFFFFFF)
    view = ((g[:, :, :tl] >> shl) | hi).reshape(P, 32 * tl)
    lane = torch.arange(32, dtype=I64, device=dev)[None, :]
    bp0 = (lane * (tl * 32)).expand(P, 32)
    return view, bp0


def stream_view_from_interleaved(buf3, tl: int):
    """The stream-major view of narrow_stream_view, sliced out of a
    word-round-robin interleaved buffer [Wc, P, 128] int32 (word w of
    stream s at flat w*32+s, native.stage_pages' layout). Returns
    (view [P, 32*tl] uint32 values as int64, bp0 [P, 32])."""
    tlc = tl * 32 // 128
    P = buf3.shape[1]
    sub = buf3[:tlc].permute(1, 0, 2).reshape(P, tl, 32)
    view = sub.permute(0, 2, 1).reshape(P, 32 * tl).to(I64) & 0xFFFFFFFF
    lane = torch.arange(32, dtype=I64, device=buf3.device)[None, :]
    bp0 = (lane * (tl * 32)).expand(P, 32)
    return view, bp0


# ---------------------------------------------------------------------------
# Canonical range-search structures
# ---------------------------------------------------------------------------

def _shl0(x, s):
    """x << s with XLA's rule for out-of-range amounts (result 0)."""
    ok = (s >= 0) & (s < 63)
    return torch.where(ok, x << s.clamp(0, 62), 0)


def build_search(lengths, max_len: int, table_bits: int):
    """lengths [P, A] -> dict of canonical range-search arrays.

    limit[l]  : [P, max_len+1] left-aligned first-invalid code per length
    first[l]  : [P, max_len+1] canonical first code per length
    offset[l] : [P, max_len+1] rank of first symbol of length l
    symdict   : [P, A] symbols in canonical (len, symbol) order
    """
    P, A = lengths.shape
    dev = lengths.device
    L = max_len + 1
    lens_i = lengths.to(I64).clamp(0, max_len)
    oh = (lens_i[:, :, None]
          == torch.arange(L, dtype=I64, device=dev)[None, None, :]).to(I64)
    counts = oh.sum(dim=1)                          # [P, L]
    counts[:, 0] = 0

    # canonical recurrence first[l] = (first[l-1] + counts[l-1]) * 2
    cols = [torch.zeros(P, dtype=I64, device=dev),
            torch.zeros(P, dtype=I64, device=dev)]
    for l in range(2, L):
        cols.append((cols[l - 1] + counts[:, l - 1]) * 2)
    first = torch.stack(cols[:L], dim=1)

    shift = table_bits - torch.arange(L, dtype=I64, device=dev)[None, :]
    limit = _shl0(first + counts, shift.expand(P, L))
    offset = torch.cumsum(counts, dim=1) - counts

    # canonical (len, symbol) order via counting ranks + one scatter
    excl = torch.cumsum(oh, dim=1) - oh             # [P, A, L]
    rank_same = torch.where(
        lens_i > 0, torch.gather(excl, 2, lens_i[:, :, None])[:, :, 0], 0)
    off_sym = torch.gather(offset, 1, lens_i)
    rank = torch.where(lengths > 0, off_sym + rank_same, A)
    sym_ids = torch.arange(A, dtype=I64, device=dev)[None, :].expand(P, A)
    symdict = torch.zeros((P, A + 1), dtype=I64, device=dev)
    symdict.scatter_(1, rank, sym_ids)              # column A = dropped
    return dict(first=first, limit=limit, offset=offset,
                symdict=symdict[:, :A].contiguous())


def search_decode(search, window, max_len: int, table_bits: int):
    """Decode one symbol per element from MSB-aligned windows.

    window: [P, K] table_bits-wide MSB-first code windows (already
    bit-reversed from the LSB wire). Returns (symbol, code_len)."""
    w = window.to(I64)
    length = torch.ones_like(w)
    for l in range(1, max_len):
        length = length + (w >= search["limit"][:, l][:, None]).to(I64)
    first_l = torch.gather(search["first"], 1, length)
    off_l = torch.gather(search["offset"], 1, length)
    shift = table_bits - length
    code = torch.where(shift >= 0, w >> shift.clamp(min=0), 0)
    A = search["symdict"].shape[1]
    rank = (off_l + code - first_l).clamp(0, A - 1)
    sym = torch.gather(search["symdict"], 1, rank)
    return sym, length


# ---------------------------------------------------------------------------
# Table loading
# ---------------------------------------------------------------------------

def _rev_n(v, n: int):
    """Bit-reverse the low n bits (n <= 16), vectorized."""
    v = v.to(I64)
    r = torch.zeros_like(v)
    for i in range(n):
        r = r | (((v >> i) & 1) << (n - 1 - i))
    return r


def load_table(words, lane_bitpos, alphabet_size: int):
    """Load one Huffman table for every page in the batch.

    Returns (lengths [P, A] int64, trivial_sym [P] (-1 if none),
    new_lane_bitpos [P, 32])."""
    P = words.shape[0]
    dev = words.device
    A = alphabet_size
    max_bits = (A - 1).bit_length()
    bp = lane_bitpos.to(I64)
    rows = torch.arange(P, device=dev)

    s0 = bp[:, 0:1]
    ttype = peek_bits(words, s0, 2)[:, 0]
    m_triv = ttype == 0
    m_simp = ttype == 1
    m_cplx = ttype == 2

    # --- trivial ---
    triv_sym = peek_bits(words, s0 + 6, max_bits)[:, 0]
    trivial_sym = torch.where(m_triv, triv_sym, -1)

    # --- simple ---
    nsym = peek_bits(words, s0 + 2, 2)[:, 0] + 1
    tsel = peek_bits(words, s0 + 4, 1)[:, 0]
    fixed = torch.tensor(SIMPLE_FIXED, dtype=I64, device=dev)
    tbl_idx = torch.where(nsym < 4, nsym - 2,
                          torch.where(tsel == 1, 3, 2)).clamp(0, 3)

    # column A is the trash column for inactive (and out-of-range) symbols
    lengths = torch.zeros((P, A + 1), dtype=I64, device=dev)
    new_bp = bp.clone()
    adv0 = torch.where(m_triv | m_simp | m_cplx, 6, 0)
    adv0 = adv0 + torch.where(m_triv, max_bits, 0)
    simple_syms = []
    for i in range(4):
        read_pos = bp[:, i] + 6 if i == 0 else bp[:, i]
        sym_i = peek_bits(words, read_pos[:, None], max_bits)[:, 0]
        active = m_simp & (i < nsym)
        simple_syms.append((sym_i, active))
        if i == 0:
            adv0 = adv0 + torch.where(m_simp, max_bits, 0)
        else:
            new_bp[:, i] += torch.where(active, max_bits, 0)
    for i in range(4):
        sym_i, active = simple_syms[i]
        col = torch.where(active & (sym_i < A), sym_i, A)
        lengths[rows, col] = torch.where(active, fixed[tbl_idx, i],
                                         lengths[rows, col])

    # --- complex ---
    nlen = peek_bits(words, s0 + 2, 4)[:, 0] + 4
    cl_lengths = torch.zeros((P, C.CODE_LENGTH_CODES), dtype=I64, device=dev)
    for i in range(C.CODE_LENGTH_CODES):
        read_pos = new_bp[:, i] + (6 if i == 0 else 0)
        v = peek_bits(words, read_pos[:, None], 5)[:, 0]
        active = m_cplx & (i < nlen)
        cl_lengths[:, CL_ORDER[i]] = torch.where(active, v, 0)
        if i == 0:
            adv0 = adv0 + torch.where(m_cplx, 5, 0)
        else:
            new_bp[:, i] += torch.where(active, 5, 0)
    new_bp[:, 0] += adv0

    # speculative RLE decode: lane s owns items s, s+32, ...
    steps = (A + C.NUM_BITSTREAMS - 1) // C.NUM_BITSTREAMS
    cl_search = build_search(cl_lengths, 9, 9)
    rle_bp0 = new_bp
    bpos = rle_bp0
    syms_t, extra_t, bp_hist = [], [], [rle_bp0]
    for _ in range(steps):
        win = peek_bits(words, bpos, 9)
        sym, ln = search_decode(cl_search, _rev_n(win, 9), 9, 9)
        is16 = sym == C.REPEAT_PREVIOUS_CODE_LENGTH
        is17 = sym == C.REPEAT_ZERO_CODE_LENGTH
        ebits = torch.where(is16, 2, torch.where(is17, 3, 0))
        extra = peek_bits(words, bpos + ln, ebits)
        bpos = bpos + ln + ebits
        syms_t.append(sym)
        extra_t.append(extra)
        bp_hist.append(bpos)
    # item-major order: item g = step g//32, lane g%32
    N = steps * 32
    syms_g = torch.stack(syms_t, dim=1).reshape(P, N)
    extra_g = torch.stack(extra_t, dim=1).reshape(P, N)

    is16g = syms_g == C.REPEAT_PREVIOUS_CODE_LENGTH
    is17g = syms_g == C.REPEAT_ZERO_CODE_LENGTH
    lit_g = ~(is16g | is17g)
    run = torch.where(lit_g, 1, extra_g + 3)
    cum = torch.cumsum(run, dim=1)
    # last item index: first g with cum >= A
    g_last = (cum < A).to(I64).sum(dim=1)
    gidx = torch.arange(N, dtype=I64, device=dev)[None, :]
    valid_g = gidx <= g_last[:, None]

    # repeat-previous value: last literal value before g (init 8)
    lit_pos = torch.where(lit_g, gidx, -1)
    last_lit = torch.cummax(lit_pos, dim=1).values
    prev_lit = torch.cat([torch.full((P, 1), -1, dtype=I64, device=dev),
                          last_lit[:, :-1]], dim=1)
    prev_val = torch.where(
        prev_lit >= 0, torch.gather(syms_g, 1, prev_lit.clamp(min=0)),
        C.INITIAL_REPEATED_CODE_LENGTH)
    val_g = torch.where(lit_g, syms_g, torch.where(is16g, prev_val, 0))
    run_valid = torch.where(valid_g, run, 0)

    # expand runs -> lengths[t] = val of covering item
    cumv = torch.cumsum(run_valid, dim=1)
    t_idx = torch.arange(A, dtype=I64, device=dev)[None, :].expand(P, A)
    item_of_t = torch.searchsorted(cumv, t_idx.contiguous(), right=True)
    cplx_lengths = torch.gather(val_g, 1, item_of_t.clamp(0, N - 1))

    # reconcile per-lane bit positions: lane s consumed
    # n_s = floor((g_last - s)/32) + 1 real items (0 if g_last < s)
    lanes = torch.arange(32, dtype=I64, device=dev)[None, :]
    n_s = torch.where(g_last[:, None] >= lanes,
                      (g_last[:, None] - lanes) // 32 + 1, 0)
    hist = torch.stack(bp_hist, dim=2)              # [P, 32, steps+1]
    rle_bp_done = torch.gather(hist, 2,
                               n_s.clamp(max=steps)[:, :, None])[:, :, 0]

    # --- merge branches ---
    out_lengths = torch.where(m_cplx[:, None], cplx_lengths, lengths[:, :A])
    final_bp = torch.where(m_cplx[:, None], rle_bp_done, new_bp)
    return out_lengths, trivial_sym, final_bp
