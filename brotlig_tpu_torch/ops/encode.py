"""Bulk-greedy LZ77 match finding on a torch device (port of
brotlig_tpu/ops/encode.py, whose XLA functions become torch ops here; none
of it is a Pallas kernel).

The reference encoder's hot loop is a sequential hash-chain parse
(PageEncoder.cpp:87-147). Here every position of a batch of pages is
matched at once:

1. candidates: one stable sort of each page's 4-byte (and 8-byte) hashes
   groups equal keys in position order, so rank r - k is the k-th nearest
   predecessor with the same key;
2. lengths: an LCP over 4-byte words ranks the candidates, the winner gets
   a full LCP with capped extension, distance-1 runs get exact lengths, and
   longer matches chain at the same distance by pointer doubling;
3. the greedy parse: the sequential cover becomes log-depth, by jump
   tables step^(2^k) and the orbit identity node[j + 2^k] = step^(2^k)(node[j]).

The output is dense (ins, cpy, dist) command arrays per page; the native
packer (encode_stream) or the device serializer (ops/encode_pack.py)
writes them.

find_commands and find_candidates dispatch on the pages' device: CUDA
tensors go to the hand-written kernels of csrc/match.cu (wrapper
ops/match_kernel.py: a stable radix sort a key family and each
position's rank in it, the probes over blocks of positions, the chain
extension, and the greedy cover walked in segments that the true path
joins), CPU tensors to find_commands_plain / find_candidates_plain, the
torch ops below.

The arithmetic is int64: the hashes' 32-bit products are taken modulo
2^32 explicitly (`_mul32`), so the CPU and the card run the same ops (no
uint32 shift, which torch's CPU build lacks). The windowed DP parse
(ops/parse_dp.py) reads more than the longest match: `find_candidates`
adds the nearest 4- and 8-byte-key predecessors and a 3-byte-key family
of short copies, which the greedy parse never computes.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import native
from ..format import constants as C
from ..format.errors import Aborted, MessageType
from ..format.headers import PreconditionHeader, StreamHeader, pack_page_table
from . import match_kernel
from .decode import resolve_device
from .precondition import preprocess_device

I64 = torch.int64
M32 = 0xFFFFFFFF

HASH_MUL = 0x1E35A7BD
HASH_MUL_8 = 0x9E3779B1
HASH_BITS = 16
MAX_MATCH_WORDS = 16          # LCP probes 64 bytes per round
MIN_MATCH = 4
NUM_CANDIDATES = 16           # nearest same-hash predecessors probed
NUM_CANDIDATES_8 = 4          # nearest probes in the 8-byte-key family
NUM_NEAR = 3                  # 4-byte-key candidates exported to the DP
NUM_NEAR_8 = 2                # 8-byte-key candidates exported to the DP
FAST_PROBE_WORDS = 3          # fast tier: candidate ranking LCP cap 12 bytes
EXT_ROUNDS = 3                # contiguous LCP cap = EXT_ROUNDS * 64 bytes


def _mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """(x * m) mod 2^32 for int64 x in [0, 2^32) and a 32-bit constant m,
    without an int64 overflow: the constant is split into 16-bit halves."""
    lo = x * (m & 0xFFFF)
    hi = ((x * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def _shift_left(x: torch.Tensor, k: int) -> torch.Tensor:
    """Row shift x[:, k:] with k zeros appended (the JAX concatenates)."""
    P, S = x.shape
    if k == 0:
        return x
    if k >= S:
        return torch.zeros_like(x)
    return torch.cat([x[:, k:], x.new_zeros(P, k)], dim=1)


def _shift_right(x: torch.Tensor, k: int, fill: int) -> torch.Tensor:
    return torch.cat([x.new_full((x.shape[0], k), fill), x[:, :-k]], dim=1)


def _quads(pages: torch.Tensor) -> torch.Tensor:
    """4-byte little-endian word starting at every byte offset [P, S],
    int64 in [0, 2^32)."""
    b = pages.to(I64)
    q = b
    for k in range(1, 4):
        q = q | (_shift_left(b, k) << (8 * k))
    return q


def _ctz_bytes(x: torch.Tensor) -> torch.Tensor:
    """Number of trailing zero BYTES of a 32-bit value (4 when x == 0)."""
    return (((x & 0xFF) == 0).to(I64) + ((x & 0xFFFF) == 0).to(I64)
            + ((x & 0xFFFFFF) == 0).to(I64) + (x == 0).to(I64))


def _match_len(quads, pos, cand, limit, words: int = MAX_MATCH_WORDS):
    """LCP of the suffixes at pos/cand in bytes, capped at 4*words.

    quads: [P, S]; pos/cand: [P, S] (cand < pos; cand = -1 -> 0); limit:
    [P, 1] page sizes. Both sides are gathered, each clamped to the last
    word (the windowed DP's form)."""
    S = quads.shape[1]
    valid = cand >= 0
    ml = torch.zeros_like(pos)
    still = valid
    for w in range(words):
        qa = torch.gather(quads, 1, (pos + 4 * w).clamp(0, S - 1))
        qb = torch.gather(quads, 1, (cand + 4 * w).clamp(0, S - 1))
        x = qa ^ qb
        eq = x == 0
        ml = ml + torch.where(still, torch.where(eq, 4, _ctz_bytes(x)), 0)
        still = still & eq
    ml = torch.minimum(ml, (limit - pos).clamp(min=0))
    return torch.where(valid, ml, 0)


def _match_len_at(quads, cand, limit, off: int,
                  words: int = MAX_MATCH_WORDS):
    """LCP of the suffixes at (iota + off) vs cand, capped at 4*words: the
    winner-verification form of _match_len. The position side is a row
    shift (zeros past the page) instead of a gather; its garbage past the
    page differs from _match_len's, but both are clamped by the same
    `limit - pos` bound, so the lengths are identical."""
    P, S = quads.shape
    valid = cand >= 0
    iota = torch.arange(S, dtype=I64, device=quads.device)[None, :]
    ml = torch.zeros((P, S), dtype=I64, device=quads.device)
    still = valid
    for w in range(words):
        qa = _shift_left(quads, off + 4 * w)
        qb = torch.gather(quads, 1, (cand + 4 * w).clamp(0, S - 1))
        x = qa ^ qb
        eq = x == 0
        ml = ml + torch.where(still, torch.where(eq, 4, _ctz_bytes(x)), 0)
        still = still & eq
    ml = torch.minimum(ml, (limit - (iota + off)).clamp(min=0))
    return torch.where(valid, ml, 0)


def _probe_family(quads, limit, h, nprobe: int, rank_words: int,
                  nnear: int = 0):
    """Rank the `nprobe` nearest same-hash predecessors of every position
    by an LCP capped at 4*rank_words bytes; returns (best_len, best_dist)
    in position space, and with nnear > 0 also (near_len, near_dist)
    [P, S, nnear]: probes 1..nnear (smallest distance first), the
    distance 0 where the probe's length is. The stable sort groups
    positions by hash in ascending position order, so rank r - k IS the
    k-th nearest predecessor whenever its hash matches; the LCPs are
    compared in sorted space, against the sorted words shifted by k."""
    S = quads.shape[1]
    h_sorted, order = torch.sort(h, dim=1, stable=True)
    inv = torch.empty_like(order).scatter_(
        1, order, torch.arange(S, device=h.device).expand_as(order))
    qs = [torch.gather(quads, 1, (order + 4 * w).clamp(0, S - 1))
          for w in range(rank_words)]
    rem_s = (limit - order).clamp(min=0)

    best_len = torch.zeros_like(order)
    best_dist = torch.zeros_like(order)
    near = []
    for k in range(1, nprobe + 1):
        same = h_sorted == _shift_right(h_sorted, k, -1)
        cand = _shift_right(order, k, 0)
        ml = torch.zeros_like(order)
        still = same
        for w in range(rank_words):
            x = qs[w] ^ _shift_right(qs[w], k, 0)
            eq = x == 0
            ml = ml + torch.where(still, torch.where(eq, 4, _ctz_bytes(x)),
                                  0)
            still = still & eq
        ml = torch.where(same, torch.minimum(ml, rem_s), 0)
        better = ml > best_len
        if k <= nnear:
            near.append((ml, torch.where(ml > 0, order - cand, 0)))
        best_len = torch.where(better, ml, best_len)
        best_dist = torch.where(better, order - cand, best_dist)

    def unsort(x):
        return torch.gather(x, 1, inv)
    if not nnear:
        return unsort(best_len), unsort(best_dist)
    return (unsort(best_len), unsort(best_dist),
            torch.stack([unsort(m) for m, _ in near], dim=2),
            torch.stack([unsort(d) for _, d in near], dim=2))


def _scan_matches(pages: torch.Tensor, in_sizes: torch.Tensor,
                  fast: bool = False, with_tri: bool = False):
    """Longest candidate per position, with the run-1 and log-depth chain
    extensions: (best_len, best_dist) [P, S] int64. fast=True is the q1
    tier: candidates are ranked over FAST_PROBE_WORDS words (12 bytes)
    instead of 64 bytes.

    with_tri=True (the exact tier, for the DP parse) returns (best_len,
    best_dist, near_len, near_dist, (tri_len, tri_dist)) instead: near_*
    [P, S, NUM_NEAR + NUM_NEAR_8] are the nearest 4-byte-key and then
    8-byte-key probes, their lengths clipped to the page; tri_* [P, S, 2]
    the two nearest 3-byte-key predecessors, lengths LCPs capped at 8
    bytes and gated at >= 2 (the short copies the 4-byte families cannot
    see; hash collisions gate out, since the LCP counts real bytes)."""
    if with_tri and fast:
        raise ValueError("the DP candidates come from the exact tier")
    P, S = pages.shape
    dev = pages.device
    limit = in_sizes.to(I64)[:, None]
    iota = torch.arange(S, dtype=I64, device=dev)[None, :].expand(P, S)
    quads = _quads(pages)
    cap = 4 * MAX_MATCH_WORDS
    rank_words = FAST_PROBE_WORDS if fast else MAX_MATCH_WORDS
    # keys past the page end are unique per byte offset, so they never match
    tail_key = (1 << HASH_BITS) + (iota & 0xFF)

    # family 1: 4-byte keys, dense groups, nearest occurrences
    hq = _mul32(quads, HASH_MUL)
    h4 = torch.where(iota + MIN_MATCH <= limit, hq >> (32 - HASH_BITS),
                     tail_key)
    nnear = (NUM_NEAR, NUM_NEAR_8) if with_tri else (0, 0)
    best_len, best_dist, *near4 = _probe_family(
        quads, limit, h4, NUM_CANDIDATES, rank_words, nnear[0])

    # family 2: 8-byte keys, sparse groups whose nearest members reach far
    # back (the reference's deep hash chains at log-sort cost)
    h8 = (hq ^ _mul32(_shift_left(quads, 4), HASH_MUL_8)) >> (32 - HASH_BITS)
    h8 = torch.where(iota + 8 <= limit, h8, tail_key)
    b8_len, b8_dist, *near8 = _probe_family(
        quads, limit, h8, NUM_CANDIDATES_8, rank_words, nnear[1])
    far_better = b8_len > best_len
    best_len = torch.where(far_better, b8_len, best_len)
    best_dist = torch.where(far_better, b8_dist, best_dist)

    # one full LCP + capped extension of each position's winner
    cand = torch.where(best_len > 0, iota - best_dist, -1)
    ml = _match_len_at(quads, cand, limit, 0)
    for ext in range(1, EXT_ROUNDS):
        capped = (ml == ext * cap) & (cand >= 0)
        more = _match_len_at(quads, torch.where(capped, cand + ext * cap, -1),
                             limit, ext * cap)
        ml = ml + torch.where(capped, more, 0)
    best_len = ml

    # distance-1 runs: exact (uncapped) lengths for byte repeats
    b = pages.to(I64)
    prev_b = _shift_right(b, 1, -1)
    eq = (b == prev_b) & (iota < limit)
    # next position where eq is False, scanning right (suffix min of flips)
    flip = torch.where(~eq, iota, S)
    next_flip = torch.cummin(flip.flip(1), dim=1).values.flip(1)
    run_len = torch.where(eq, next_flip - iota, 0)
    run_len = torch.minimum(run_len, (limit - iota).clamp(min=0))
    better = run_len > best_len
    best_len = torch.where(better, run_len, best_len)
    best_dist = torch.where(better, 1, best_dist)

    # unbounded extension in log depth: a match capped at capmax whose
    # continuation position holds a full-cap match at the SAME distance is
    # one contiguous match of both; chain lengths by pointer doubling over
    # stride capmax
    capmax = EXT_ROUNDS * cap
    d_pad = torch.cat([best_dist, best_dist.new_zeros(P, 1)], dim=1)
    l_pad = torch.cat([best_len, best_len.new_zeros(P, 1)], dim=1)
    nxt_i = (iota + capmax).clamp(max=S)
    cont = ((best_len == capmax)
            & (torch.gather(d_pad, 1, nxt_i) == best_dist)
            & (torch.gather(l_pad, 1, nxt_i) > 0))
    cnt = cont.to(I64)
    link = torch.where(cont, nxt_i, S)
    nblocks = (S + capmax - 1) // capmax
    for _ in range(max(1, (nblocks - 1).bit_length())):
        cnt_pad = torch.cat([cnt, cnt.new_zeros(P, 1)], dim=1)
        cnt = cnt + torch.gather(cnt_pad, 1, link)
        link_ext = torch.cat([link, link.new_full((P, 1), S)], dim=1)
        link = torch.gather(link_ext, 1, link)
    term = (iota + capmax * cnt).clamp(max=S)
    ext_len = capmax * cnt + torch.gather(l_pad, 1, term)
    best_len = torch.where(cnt > 0, ext_len, best_len)
    room = (limit - iota).clamp(min=0)
    best_len = torch.minimum(best_len, room)
    if not with_tri:
        return best_len, best_dist
    near_len = torch.minimum(torch.cat([near4[0], near8[0]], dim=2),
                             room[:, :, None])
    near_dist = torch.cat([near4[1], near8[1]], dim=2)

    # family 3: 3-byte keys, LCP cap 8 bytes (longer matches are the other
    # families' job)
    b = pages.to(I64)
    tri = b | (_shift_left(b, 1) << 8) | (_shift_left(b, 2) << 16)
    h3 = torch.where(iota + 3 <= limit,
                     _mul32(tri, HASH_MUL_8) >> (32 - HASH_BITS), tail_key)
    _, _, t_len, t_dist = _probe_family(quads, limit, h3, 2, 2, 2)
    t_len = torch.minimum(torch.where(t_len >= 2, t_len, 0),
                          room[:, :, None])
    return best_len, best_dist, near_len, near_dist, (t_len, t_dist)


def find_candidates(pages: torch.Tensor, in_sizes: torch.Tensor, cap: int):
    """Per-position match candidates for the DP parse, on the pages'
    device: slot 0 the longest match, then the nearest 4- and 8-byte-key
    predecessors (smallest distance first), both gated at MIN_MATCH, then
    the two 3-byte-key slots (gated at >= 2). Lengths are clipped to `cap`
    (the DP's window). pages: uint8 [P, S]; in_sizes: [P]. Returns
    (cand_len, cand_dist) [P, S, 8] int32.

    On CUDA tensors it launches the matcher's kernels (csrc/match.cu), on
    CPU tensors it runs find_candidates_plain."""
    if pages.is_cuda:
        return match_kernel.find_candidates_cuda(pages, in_sizes, cap)
    if pages.device.type == "cpu":
        return find_candidates_plain(pages, in_sizes, cap)
    raise ValueError(f"no find_candidates route for device {pages.device}")


def find_candidates_plain(pages: torch.Tensor, in_sizes: torch.Tensor,
                          cap: int):
    """find_candidates as torch ops, on any device (the JAX package's
    compiled find_candidates, op for op)."""
    best_len, best_dist, near_len, near_dist, (t_len, t_dist) = \
        _scan_matches(pages, in_sizes, with_tri=True)
    cand_len = torch.cat([best_len.clamp(max=cap)[:, :, None],
                          near_len.clamp(max=cap)], dim=2)
    cand_len = torch.where(cand_len >= MIN_MATCH, cand_len, 0)
    cand_len = torch.cat([cand_len, t_len.clamp(max=cap)], dim=2)
    cand_dist = torch.cat([best_dist[:, :, None], near_dist, t_dist], dim=2)
    return cand_len.to(torch.int32), cand_dist.to(torch.int32)


def find_commands(pages: torch.Tensor, in_sizes: torch.Tensor,
                  max_cmds: int, fast: bool = False):
    """Bulk-greedy LZ77 over a batch of pages, on their device.

    pages: uint8 [P, S]; in_sizes: [P] integer page sizes.
    Returns (ins, cpy, dist [P, max_cmds] int32, ncmds [P] int32):
    commands cover a prefix of each page; the rest is the caller's
    insert-only tail. fast=True is the q1 tier (see _scan_matches).

    On CUDA tensors it launches the matcher's kernels (csrc/match.cu), on
    CPU tensors it runs find_commands_plain."""
    if pages.is_cuda:
        return match_kernel.find_commands_cuda(pages, in_sizes, max_cmds,
                                               fast)
    if pages.device.type == "cpu":
        return find_commands_plain(pages, in_sizes, max_cmds, fast)
    raise ValueError(f"no find_commands route for device {pages.device}")


def find_commands_plain(pages: torch.Tensor, in_sizes: torch.Tensor,
                        max_cmds: int, fast: bool = False):
    """find_commands as torch ops, on any device (the JAX package's
    compiled find_commands, op for op: the greedy cover by jump doubling
    and orbit listing)."""
    P, S = pages.shape
    dev = pages.device
    limit = in_sizes.to(I64)[:, None]
    iota = torch.arange(S, dtype=I64, device=dev)[None, :].expand(P, S)
    best_len, best_dist = _scan_matches(pages, in_sizes, fast)

    # plain greedy (distance gates and lazy matching measured worse)
    taken = (best_len >= MIN_MATCH) & (iota + best_len <= limit)
    # next taken match start at or after i; the orbit jumps match start to
    # match start, so literal runs cost no orbit nodes
    taken_pos = torch.where(taken, iota, S)
    nxt = torch.cummin(taken_pos.flip(1), dim=1).values.flip(1)
    nxt_pad = torch.cat([nxt, nxt.new_full((P, 1), S)], dim=1)
    # from a match at i the next command starts at the first match
    # position >= i + len; the sentinel S is a fixed point
    step = torch.gather(nxt_pad, 1, (iota + best_len).clamp(0, S))
    jk = torch.cat([step, step.new_full((P, 1), S)], dim=1)

    # jump doubling + orbit listing over the padded index space [0, S]
    levels = max(1, (max_cmds - 1).bit_length())
    nodes = torch.zeros((P, 1 << levels), dtype=I64, device=dev)
    nodes[:, 0] = nxt[:, 0]
    size = 1
    for _ in range(levels):
        nodes[:, size:2 * size] = torch.gather(jk, 1, nodes[:, :size])
        jk = torch.gather(jk, 1, jk.clamp(max=S))
        size *= 2

    nodes = nodes[:, :max_cmds]
    node_match = nodes < limit.clamp(max=S)
    ncmds = node_match.sum(dim=1)
    in_range = (torch.arange(max_cmds, device=dev)[None, :]
                < ncmds[:, None])
    at = nodes.clamp(0, S - 1)
    cmd_pos = torch.where(in_range, nodes, 0)
    cmd_len = torch.where(in_range, torch.gather(best_len, 1, at), 0)
    cmd_dist = torch.where(in_range, torch.gather(best_dist, 1, at), 0)
    prev_end = _shift_right(cmd_pos + cmd_len, 1, 0)
    ins = torch.where(in_range, cmd_pos - prev_end, 0)
    i32 = torch.int32
    return (ins.to(i32), cmd_len.to(i32), cmd_dist.to(i32), ncmds.to(i32))


# ---------------------------------------------------------------------------
# Stream level: device match finding + native serialization (the hybrid)
# ---------------------------------------------------------------------------

def stream_setup(data: bytes, page_size: int, dc_params, device):
    """What both encode routes do before their pages: check the page size,
    initialise preconditioning (a geometry that does not fit the input
    turns it off, as the reference does), and condition + delta encode on
    `device`. Returns (header, precondition, raw_form, work, isdelta
    flags): pages are encoded from `work`; a page stored raw holds its
    bytes of `raw_form`, the conditioned non-delta bytes."""
    if not (C.MIN_PAGE_SIZE <= page_size <= C.MAX_PAGE_SIZE):
        raise ValueError("page size out of range")
    precondition = dc_params is not None and dc_params.precondition
    if precondition and not dc_params.initialize(len(data)):
        precondition = False
    header = StreamHeader.for_input(len(data), page_size, precondition)
    raw_form, work = data, data
    isdelta = [False] * header.num_pages
    if precondition and data:
        raw_form, work, isdelta = preprocess_device(data, dc_params,
                                                    page_size, device)
    return header, precondition, raw_form, work, isdelta


def page_rows(work: bytes, group, page_size: int):
    """The pages `group` of `work` as zero-padded rows: (uint8 [P,
    page_size], int32 sizes [P])."""
    arr = np.zeros((len(group), page_size), dtype=np.uint8)
    sizes = np.zeros(len(group), dtype=np.int32)
    for row, i in enumerate(group):
        chunk = work[i * page_size: (i + 1) * page_size]
        arr[row, : len(chunk)] = np.frombuffer(chunk, np.uint8)
        sizes[row] = len(chunk)
    return arr, sizes


def assemble(header, precondition: bool, dc_params, pages_out) -> bytes:
    """The container: stream header, precondition header, page table,
    pages."""
    out = bytearray(header.pack())
    if precondition:
        out += PreconditionHeader(
            swizzled=dc_params.swizzle,
            pitch_d3d12_aligned=dc_params.pitch_d3d12_aligned,
            width_in_blocks=dc_params.width_in_blocks[0],
            height_in_blocks=dc_params.height_in_blocks[0],
            data_format=dc_params.format,
            num_mips=dc_params.num_mip_levels,
            pitch_in_bytes=dc_params.pitch_in_bytes[0],
        ).pack()
    out += pack_page_table([len(p) for p in pages_out])
    for p in pages_out:
        out += p
    return bytes(out)


def check_feedback(feedback, done: int, total: int) -> None:
    if feedback is not None and feedback(MessageType.PROGRESS,
                                         f"pages {done}/{total}"):
        raise Aborted("encode aborted by feedback callback")


def encode_stream(data: bytes, page_size: int = 65536, batch_pages: int = 64,
                  dc_params=None, feedback=None, device="cuda") -> bytes:
    """Compress a container with device match finding (the exact tier of
    find_commands, always greedy) on `device` and the native packer.

    The per-page entropy coding and serialization run in the native C++
    packer, page-parallel in threads; a page it cannot shrink is stored
    raw (for a preconditioned stream, its conditioned non-delta bytes).
    `dc_params` enables BCn preconditioning, conditioned and delta-encoded
    on `device`. feedback(msg_type, text) -> bool is called once per page
    batch; returning True raises format.errors.Aborted."""
    dev = resolve_device(device)
    header, precondition, raw_form, work, isdelta = stream_setup(
        data, page_size, dc_params, dev)
    if not data:
        return header.pack()
    num_pages = header.num_pages
    max_cmds = page_size // 2 + 2
    pages_out = []
    for c0 in range(0, num_pages, batch_pages):
        group = list(range(c0, min(c0 + batch_pages, num_pages)))
        arr, sizes = page_rows(work, group, page_size)
        cmds = find_commands(torch.from_numpy(arr).to(dev),
                             torch.from_numpy(sizes).to(dev), max_cmds)
        ins, cpy, dist, nc = (t.cpu().numpy() for t in cmds)

        def pack(row_i):
            row, i = row_i
            n, k = int(sizes[row]), int(nc[row])
            blob = native.encode_page_cmds(
                arr[row, :n].tobytes(), i == num_pages - 1, ins[row, :k],
                cpy[row, :k], dist[row, :k], isdelta=isdelta[i])
            if len(blob) == n:   # raw: the non-delta conditioned bytes
                blob = raw_form[i * page_size: i * page_size + n]
            return blob

        with ThreadPoolExecutor() as ex:
            pages_out.extend(ex.map(pack, list(enumerate(group))))
        check_feedback(feedback, len(pages_out), num_pages)
    return assemble(header, precondition, dc_params, pages_out)
