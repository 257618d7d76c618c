"""Batched Brotli-G page decode in plain torch (port of the XLA wavefront in
brotlig_tpu/ops/decode.py), and the port's container-level decode.

* Phase A — wavefront symbol decode, vectorized over [pages, 32 lanes].
  Each round decodes one command per lane (speculatively; lanes past the
  sentinel are rolled back) and the round's literal batches, in the
  reference's round-robin schedule (PageDecoder.cpp:158-236).
* Phase B — LZ77 resolution: the distance ring by pointer doubling, then
  each output byte's source by a second pointer-doubling pass over copy
  chains, and one final gather of literals.

This is the port's CPU route and the plain version of the fused decode
kernel (csrc/decode.cu, wrapped by decode_kernel.decode_fused) and of the
two-phase route's kernels (phase_a_kernel, sweep_kernel): the tests pin it
to the JAX wavefront, and the chip smoke test holds the kernels to it.
Loops whose trip count depends on the data read one scalar per iteration
from the device (torch runs eagerly).

Two things differ from the JAX module on purpose: literals go straight
into a dense queue by one scatter per batch (no slot buffer and
compaction pass; the JAX form avoided scatters for TPU cost reasons), and
output bytes past a page's coverage are zero instead of unspecified.
"""
from __future__ import annotations

import os
from collections import deque
from typing import NamedTuple

import numpy as np
import torch

from .. import native
from ..format import constants as C
from ..format.errors import Aborted
from ..format.headers import parse_container
from ..state import (StagingBuffers, Streams, staged_from_numpy,
                     tables_from_lengths)
from . import arith_lut, tables_kernel
from .bits import extract_bits, fetch_window, reverse_bits_15
from .precondition import postprocess_device, postprocess_flat_device
from .tables import (HEADER_WORDS, build_search, load_table,
                     narrow_stream_view, parse_page_headers_full,
                     search_decode)

I64 = torch.int64
NBS = C.NUM_BITSTREAMS
LIT_UNROLL = 8          # literal batches decoded per 6-word window fetch

# per-page status bits (0 = decoded cleanly); the CUDA kernel sets the same
ST_NO_SENTINEL = 1      # no sentinel within max_cmds commands
ST_OVERRUN = 2          # commands (or literals) cover more than the page
ST_DISTANCE = 4         # a copy reaches before the page start


def _flat_decode_window(search, trivial, window15):
    """Symbol decode from an already-extracted 15-bit window: canonical
    range search, overridden by the table's trivial symbol if it has one."""
    idx = reverse_bits_15(window15)
    sym, ln = search_decode(search, idx, C.HUFFMAN_NUM_CODE_LENGTH,
                            C.HUFFMAN_TABLE_BITS)
    is_triv = (trivial >= 0)[:, None]
    sym = torch.where(is_triv, trivial[:, None], sym)
    ln = torch.where(is_triv, 0, ln)
    return sym, ln


def _mk_search(lengths):
    return build_search(lengths, C.HUFFMAN_NUM_CODE_LENGTH,
                        C.HUFFMAN_TABLE_BITS)


def _phase_a(words, lane_bp, icp, dist, lit, npostfix, ndirect,
             page_size: int, max_cmds: int):
    """Wavefront command/literal decode. Returns (ncmds [P], litbuf
    [P, page_size] uint8, ins, cpy, dcode, dextra [P, max_cmds])."""
    P = words.shape[0]
    dev = words.device
    lane = torch.arange(NBS, dtype=I64, device=dev)[None, :]
    max_rounds = (max_cmds + NBS - 1) // NBS
    lit_cap = page_size + 64

    icp_s, icp_t = icp
    dist_s, dist_t = dist
    lit_s, lit_t = lit
    npf = npostfix.to(I64)[:, None]
    ndir = ndirect.to(I64)[:, None]

    def zeros(*shape):
        return torch.zeros(shape, dtype=I64, device=dev)

    bp = lane_bp.to(I64)
    done = torch.zeros(P, dtype=torch.bool, device=dev)
    ncmds, prev_tail, qtail = zeros(P), zeros(P), zeros(P)
    ins_a, cpy_a, dextra_a = (zeros(P, max_cmds), zeros(P, max_cmds),
                              zeros(P, max_cmds))
    dcode_a = torch.full((P, max_cmds), -1, dtype=I64, device=dev)
    litq = torch.zeros((P, lit_cap + 1), dtype=torch.uint8, device=dev)

    for r in range(max_rounds):
        active = ~done

        # one window covers the whole command per lane: code(<=15) + ins
        # extra(<=24) + cpy extra(<=24) + dist code(<=15) + dist extra
        # (<=30) + intra-word shift(<=31) = 139+31 <= 6*32 bits
        win, sh = fetch_window(words, bp, 6)
        cmd_window = extract_bits(win, sh, 0, 15, 6)
        sym, ln = _flat_decode_window(icp_s, icp_t, cmd_window)
        bp1 = bp + ln
        is_norm = sym < C.NUM_COMMAND_SYMBOLS
        is_sent = sym == C.SENTINEL_COMMAND
        is_insonly = sym > C.NUM_COMMAND_SYMBOLS

        ic_norm, cc_norm = arith_lut.split_command(sym)
        inscode = torch.where(is_insonly, sym - C.NUM_COMMAND_SYMBOLS,
                              torch.where(is_norm, ic_norm, 0)).clamp(0, 23)
        copycode = torch.where(is_norm, cc_norm, 0).clamp(0, 23)
        ins_bits = torch.where(is_sent, 0, arith_lut.insert_extra(inscode))
        ins_base = torch.where(is_sent, 0, arith_lut.insert_base(inscode))
        cpy_bits = torch.where(is_norm, arith_lut.copy_extra(copycode), 0)
        cpy_base = torch.where(is_norm, arith_lut.copy_base(copycode), 0)

        ins_extra = extract_bits(win, sh, ln, ins_bits, 6)
        cpy_extra = extract_bits(win, sh, ln + ins_bits, cpy_bits, 6)
        insert_len = ins_base + ins_extra
        copy_len = cpy_base + cpy_extra
        bp2 = bp1 + ins_bits + cpy_bits
        d_off = ln + ins_bits + cpy_bits

        # --- distance symbol + extra (only commands >= 128) ---
        need_dist = is_norm & (sym >= 128)
        dist_window = extract_bits(win, sh, d_off, 15, 6)
        dsym, dln = _flat_decode_window(dist_s, dist_t, dist_window)
        dln_eff = torch.where(need_dist, dln, 0)
        is_long = dsym >= (16 + ndir)
        dnb = torch.where(need_dist & is_long,
                          1 + ((dsym - ndir - 16).clamp(min=0) >> (npf + 1)),
                          0).clamp(0, 30)
        dextra = extract_bits(win, sh, d_off + dln_eff, dnb, 6)
        bp4 = bp2 + dln_eff + dnb

        # --- sentinel lane + rollback: lanes past k keep their cursor,
        # lane k consumes the sentinel code only ---
        k = torch.where(is_sent, lane, NBS).min(dim=1).values
        k = torch.where(active, k, 0)
        valid = active[:, None] & (lane < k[:, None])
        at_k = active[:, None] & (lane == k[:, None])
        bp = torch.where(valid, bp4, torch.where(at_k, bp1, bp))

        insert_len = torch.where(valid, insert_len, 0)
        copy_len = torch.where(valid, copy_len, 0)
        dcode = torch.where(valid & need_dist, dsym,
                            torch.where(valid & is_norm, 0, -1))
        dextra = torch.where(valid, dextra, 0)

        col = slice(r * NBS, (r + 1) * NBS)
        ins_a[:, col] = insert_len
        cpy_a[:, col] = copy_len
        dcode_a[:, col] = dcode
        dextra_a[:, col] = dextra
        ncmds = ncmds + k

        # --- literal batches: rlit = k * ceil(max(litcount - prev_tail,
        # 0) / k); literal j of the round comes from lane j % 32 ---
        litcount = insert_len.sum(dim=1)
        aclit = (litcount - prev_tail).clamp(min=0)
        mult = torch.where(k > 0, (aclit + k - 1) // k.clamp(min=1), 0)
        rlit = torch.where(active, k * mult, 0)
        prev_tail = torch.where(active, rlit + prev_tail - litcount,
                                prev_tail)
        done = done | (active & (k < NBS))
        rmax, all_done = torch.stack(
            [rlit.max(), done.all().to(I64)]).tolist()

        for j0 in range(0, rmax, NBS * LIT_UNROLL):
            # 8 batches x <= 15 bits + 31-bit shift + 15-bit peek <= 192
            win, sh = fetch_window(words, bp, 6)
            delta = torch.zeros_like(bp)
            for jj in range(LIT_UNROLL):
                j = j0 + jj * NBS + lane
                act = j < rlit[:, None]
                window15 = extract_bits(win, sh, delta, 15, 6)
                s, n = _flat_decode_window(lit_s, lit_t, window15)
                delta = delta + torch.where(act, n, 0)
                pos = qtail[:, None] + j
                pos = torch.where(act & (pos < lit_cap), pos, lit_cap)
                litq.scatter_(1, pos, s.to(torch.uint8))
            bp = bp + delta
        qtail = qtail + rlit
        if all_done:
            break

    return (ncmds, litq[:, :page_size], ins_a, cpy_a, dcode_a, dextra_a)


def _resolve_distances(dcode_a, dextra_a, ncmds, npostfix, ndirect):
    """Distance-ring resolution by pointer doubling (PageDecoder.cpp:
    345-404 semantics). Returns dist [P, N] absolute distances."""
    P, N = dcode_a.shape
    dev = dcode_a.device
    cid = torch.arange(N, dtype=I64, device=dev)[None, :]
    valid = cid < ncmds.to(I64)[:, None]
    code = torch.where(valid, dcode_a, -1)

    npf = npostfix.to(I64)[:, None]
    ndir = ndirect.to(I64)[:, None]
    is_dir = (code >= 16) & (code < 16 + ndir)
    is_long = code >= 16 + ndir
    s = (code - ndir - 16).clamp(min=0)
    # extra-bit counts above 30 only occur in corrupt streams; the clamp
    # keeps their (flagged) arithmetic defined
    nbits = (1 + (s >> (npf + 1))).clamp(max=40)
    hcode = s >> npf
    lcode = s & ((1 << npf) - 1)
    offs = ((2 + (hcode & 1)) << nbits) - 4
    long_val = ((offs + dextra_a) << npf) + lcode + ndir + 1
    abs_val = torch.where(is_dir, code - 15, long_val)

    # ring-relative codes 0..15 -> (depth, delta)
    is_rel = (code >= 0) & (code < 16)
    depth = torch.where(code < 4, code.clamp(min=0),
                        torch.where(code < 10, 0, 1))
    d_off = (code - 4).clamp(min=0)
    delta_mag = (d_off % 6) // 2 + 1
    delta_sign = torch.where((code & 1) == 1, 1, -1)
    delta = torch.where((code >= 4) & (code < 16), delta_sign * delta_mag, 0)

    # push ranks: virtual pushes 0..3 hold the initial ring
    is_push = (valid & (code > 0)).to(I64)
    push_cum = torch.cumsum(is_push, dim=1)
    rank = 4 + push_cum - is_push                   # exclusive
    ref_push = rank - 1 - depth

    # push number -> command index: the j-th push is the first command
    # whose running push count reaches j+1; virtual pushes 0..3 map to
    # nodes N..N+3
    want = (ref_push - 4).clamp(0, N - 1) + 1
    ref_cmd = torch.searchsorted(push_cum.contiguous(), want.contiguous(),
                                 right=False).clamp(0, N - 1)
    parent = torch.where(is_rel,
                         torch.where(ref_push < 4,
                                     N + ref_push.clamp(0, 3), ref_cmd),
                         cid)               # absolute/no-dist: self-root
    dl = torch.where(is_rel, delta, 0)

    # node value base (roots): commands with absolute code; virtual ring
    val = torch.where(is_long | is_dir, abs_val, 0)
    virt = torch.tensor([16, 15, 11, 4], dtype=I64, device=dev)
    val = torch.cat([val, virt[None, :].expand(P, 4)], dim=1)
    parent = torch.cat(
        [parent, torch.arange(N, N + 4, dtype=I64, device=dev)[None, :]
         .expand(P, 4)], dim=1)
    dl = torch.cat([dl, torch.zeros((P, 4), dtype=I64, device=dev)], dim=1)

    # ring chains are short (depth <= 3 + small delta hops): stop at the
    # fixed point instead of running all log2(N) rounds
    for _ in range(max(1, (N + 4 - 1).bit_length())):
        par_par = torch.gather(parent, 1, parent)
        dl = dl + torch.gather(dl, 1, parent)
        changed = bool((par_par != parent).any())
        parent = par_par
        if not changed:
            break

    dist = torch.gather(val, 1, parent) + dl
    return dist[:, :N]


def _phase_b(ncmds, litbuf, ins_a, cpy_a, dist, page_size: int):
    """Source-chain LZ77 resolution -> output bytes [P, page_size] uint8
    (zero past each page's coverage)."""
    P, N = ins_a.shape
    dev = ins_a.device
    S = page_size
    cov = ins_a + cpy_a
    ends = torch.cumsum(cov, dim=1)
    starts = ends - cov                              # exclusive
    lit_starts = torch.cumsum(ins_a, dim=1) - ins_a  # exclusive

    pos = torch.arange(S, dtype=I64, device=dev)[None, :].expand(P, S)
    # covering command per position: scatter-max each command's index at
    # its start (zero-coverage duplicates resolve to the last) and
    # forward-fill with cummax; column S catches starts past the page
    cid = torch.arange(N, dtype=I64, device=dev)[None, :].expand(P, N)
    in_cmds = cid < ncmds.to(I64)[:, None]
    scatter_pos = torch.where(in_cmds, starts.clamp(0, S), S)
    mark = torch.zeros((P, S + 1), dtype=I64, device=dev)
    mark.scatter_reduce_(1, scatter_pos, cid, "amax")
    cmd_of = torch.cummax(mark[:, :S], dim=1).values.clamp(0, N - 1)

    st = torch.gather(starts, 1, cmd_of)
    ins_c = torch.gather(ins_a, 1, cmd_of)
    lst = torch.gather(lit_starts, 1, cmd_of)
    dst = torch.gather(dist, 1, cmd_of)

    in_insert = pos < st + ins_c
    # position p of a copy with distance d reads cstart - d + (p - cstart)
    # % d, which lands OUTSIDE the copy's own region: chains only hop
    # across commands and the doubling below converges in a few rounds
    cstart = st + ins_c
    d_safe = dst.clamp(min=1)
    src_copy = cstart - d_safe + (pos - cstart) % d_safe
    src = torch.where(in_insert, S + lst + (pos - st),
                      src_copy.clamp(0, S - 1))

    for _ in range(max(1, (S - 1).bit_length())):
        chained = src < S
        if not bool(chained.any()):
            break
        nxt = torch.gather(src, 1, src.clamp(0, S - 1))
        src = torch.where(chained, nxt, src)

    lit_idx = (src - S).clamp(0, litbuf.shape[1] - 1)
    out = torch.gather(litbuf, 1, lit_idx)
    total = ends[:, -1:] if N else torch.zeros((P, 1), dtype=I64, device=dev)
    return torch.where(pos < total, out, 0).to(torch.uint8)


def _stage_symbols(words, in_sizes, page_size: int, max_cmds: int):
    """Headers + tables + wavefront symbol decode (phase A) from a batch
    of page words [P, W]."""
    W = words.shape[1]
    npostfix, ndirect, isdelta, _, stream_bytes = \
        parse_page_headers_full(words[:, :min(W, HEADER_WORDS)], in_sizes)
    view, vbp0 = narrow_stream_view(words, stream_bytes, 64)
    bp = vbp0
    icp_len, icp_triv, bp = load_table(
        view, bp, C.NUM_COMMAND_SYMBOLS_EFFECTIVE)
    dst_len, dst_triv, bp = load_table(view, bp, C.NUM_DISTANCE_SYMBOLS)
    lit_len, lit_triv, bp = load_table(view, bp, C.NUM_LITERAL_SYMBOLS)
    lane_bp = stream_bytes * 8 + (bp - vbp0)

    ncmds, litbuf, ins_a, cpy_a, dcode_a, dextra_a = _phase_a(
        words, lane_bp,
        (_mk_search(icp_len), icp_triv), (_mk_search(dst_len), dst_triv),
        (_mk_search(lit_len), lit_triv), npostfix, ndirect,
        page_size, max_cmds)
    return (ncmds, litbuf, ins_a, cpy_a, dcode_a, dextra_a,
            npostfix, ndirect, isdelta)


def _stage_lz(ncmds, litbuf, ins_a, cpy_a, dcode_a, dextra_a,
              npostfix, ndirect, page_size: int, max_cmds: int):
    """Distance-ring resolution + source-chain LZ77 execution (phase B).
    Returns (out [P, page_size] uint8, status [P] int32)."""
    dist = _resolve_distances(dcode_a, dextra_a, ncmds, npostfix, ndirect)
    out = _phase_b(ncmds, litbuf, ins_a, cpy_a, dist, page_size)
    return out, page_status(ncmds, ins_a, cpy_a, dist, page_size, max_cmds)


def page_status(ncmds, ins_a, cpy_a, dist, page_size: int, max_cmds: int):
    """Per-page status bits (ST_*) of a decoded command list."""
    cov_end = torch.cumsum(ins_a + cpy_a, dim=1)
    cstart = cov_end - cpy_a
    bad_dist = ((cpy_a > 0) & ((dist > cstart) | (dist <= 0))).any(dim=1)
    total = cov_end[:, -1]
    st = torch.where(ncmds >= max_cmds, ST_NO_SENTINEL, 0)
    st = st | torch.where(total > page_size, ST_OVERRUN, 0)
    st = st | torch.where(bad_dist, ST_DISTANCE, 0)
    return st.to(torch.int32)


def decode_pages(words, in_sizes, page_size: int, max_cmds: int):
    """Decode a batch of compressed (non-raw) pages from their words.

    words: [P, W] uint32 values (any integer dtype); in_sizes: [P].
    Returns (out [P, page_size] uint8, isdelta [P]); raises ValueError
    when a page is corrupt."""
    words = words.to(I64) & 0xFFFFFFFF
    (ncmds, litbuf, ins_a, cpy_a, dcode_a, dextra_a, npostfix, ndirect,
     isdelta) = _stage_symbols(words, in_sizes, page_size, max_cmds)
    out, status = _stage_lz(ncmds, litbuf, ins_a, cpy_a, dcode_a, dextra_a,
                            npostfix, ndirect, page_size, max_cmds)
    if bool((status != 0).any()):
        raise ValueError("corrupt stream")
    return out, isdelta


def max_cmds_for(page_size: int) -> int:
    n = page_size // 2 + 2
    return (n + NBS - 1) // NBS * NBS


# ---------------------------------------------------------------------------
# Container-level decode
# ---------------------------------------------------------------------------

VALID_SWEEP_CW = (128, 512, 1024, 2048)
VALID_VARIANTS = ("fused", "two_phase", "xla")


def env_decode_opts():
    """Resolve (variant, sweep_cw) from the BLG_* environment once, at a
    process edge (the profile tools). Library code takes them as
    explicit arguments and reads no environment. BLG_VARIANT names the
    route; without it BLG_PALLAS=0 picks "xla" and BLG_FUSED=0
    "two_phase", else "fused". BLG_SWEEP_CW defaults to 2048. Unknown
    values raise ValueError instead of quietly switching routes."""
    variant = os.environ.get("BLG_VARIANT")
    if variant is None:
        if os.environ.get("BLG_PALLAS", "1") == "0":
            variant = "xla"
        elif os.environ.get("BLG_FUSED", "1") == "0":
            variant = "two_phase"
        else:
            variant = "fused"
    if variant not in VALID_VARIANTS:
        raise ValueError(f"BLG_VARIANT={variant!r} not in {VALID_VARIANTS}")
    cw = int(os.environ.get("BLG_SWEEP_CW", "2048"))
    if cw not in VALID_SWEEP_CW:
        raise ValueError(f"BLG_SWEEP_CW={cw} not in {VALID_SWEEP_CW}")
    return variant, cw


def _check_opts(variant, sweep_cw: int):
    if variant is not None and variant not in VALID_VARIANTS:
        raise ValueError(f"variant={variant!r} not in {VALID_VARIANTS}")
    if sweep_cw not in VALID_SWEEP_CW:
        raise ValueError(f"sweep_cw={sweep_cw} not in {VALID_SWEEP_CW}")


def resolve_device(device) -> torch.device:
    """torch.device for `device`; raises when CUDA is asked for and absent
    (there is no quiet CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda is not "
                           "available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def decode_batch(staged, page_size: int, variant=None,
                 sweep_cw: int = 1024):
    """Decode one staged batch on the route `variant` names (see
    decode_stream). Returns (out [P, page_size] uint8, ncmds [P], status
    [P])."""
    # these modules import this one
    from . import decode_kernel, phase_a_kernel, sweep_kernel
    if variant == "xla" or not staged.buf.is_cuda:
        # the plain routes read the unpacked tables
        tabs = tables_from_lengths(
            *tables_kernel.load_tables_plain(staged.buf))
    else:
        tabs = tables_kernel.load_tables(staged.buf)  # packed, by the kernel
    if variant == "xla":
        return decode_kernel.decode_fused_plain(staged.buf, staged.npd, tabs,
                                                page_size)
    if variant == "two_phase":
        a = phase_a_kernel.phase_a(staged.buf, staged.npd, tabs, page_size)
        out = sweep_kernel.sweep(a.ncmds, a.litq, a.ins, a.cpy, a.dist,
                                 page_size, sweep_cw)
        return out, a.ncmds, a.status
    return decode_kernel.decode_fused(staged.buf, staged.npd, tabs,
                                      page_size)


def batch_plan(payload: bytes, offsets, sizes, batch_pages: int):
    """How the compressed pages at `offsets`/`sizes` of `payload` are
    staged: (wl, the per-stream word capacity of the staged buffer, a
    bucket of the largest sub-stream; batches, lists of at most
    `batch_pages` positions into offsets/sizes, sorted by compressed size
    so that similar pages finish together). The last batch is short, not
    padded."""
    from .decode_kernel import stream_words_hint, wl_bucket
    order = sorted(range(len(sizes)), key=lambda j: int(sizes[j]))
    mv = memoryview(payload)
    wl = wl_bucket(stream_words_hint(
        [(bytes(mv[int(o): int(o) + 96]), int(n))
         for o, n in zip(offsets, sizes)]))
    return wl, [order[c0: c0 + batch_pages]
                for c0 in range(0, len(order), batch_pages)]


def compressed_jobs(info):
    """(page indices, offsets, sizes) of a parsed container's compressed
    pages."""
    comp = np.asarray(info.compressed_page_indices(), dtype=np.int64)
    return comp, info.offsets[comp], info.sizes[comp]


def staged_batches(data: bytes, info, batch_pages: int, device):
    """Yield (page indices, state.Staged on `device`) for the compressed
    pages of a parsed container (format.headers.parse_container), batch
    by batch as batch_plan makes them, each staged by native.stage_pages
    (which parses each page's size table and interleaves its 32
    sub-streams on the host) and uploaded with a plain blocking copy.
    decode_stream runs the same batches through decode_batches."""
    comp, offs, szs = compressed_jobs(info)
    if not len(comp):
        return
    wl, batches = batch_plan(data, offs, szs, batch_pages)
    for b in batches:
        buf3_np, npd_np = native.stage_pages(data, offs[b], szs[b], wl)
        yield [int(i) for i in comp[b]], staged_from_numpy(buf3_np, npd_np,
                                                           device)


class _InFlight(NamedTuple):
    """A launched batch not yet drained."""
    keys: np.ndarray        # the batch's page keys, in row order
    isdelta: np.ndarray     # each page's delta flag, from the host staging
    device: tuple           # device tensors its queued work still uses
    pages: np.ndarray | None    # host rows, valid once `done` completed
    status: np.ndarray      # host status, valid once `done` completed
    done: object            # event after its readback (None on the CPU)


def decode_batches(payload: bytes, keys, offsets, sizes, page_size: int,
                   dev: torch.device, drain, batch_pages: int = 256,
                   variant=None, sweep_cw: int = 1024, plane=None) -> None:
    """Decode compressed pages of `payload` (page j at offsets[j] with
    sizes[j] bytes, known to the caller as keys[j]) in the batches of
    batch_plan, dispatching ahead and draining behind.

    For each batch, in order: stage it on the host into reused buffers
    (page-locked on a card) while the card still runs the batch before;
    upload it on the copy stream; launch its route on the compute stream
    (decode_batch); queue the readback of its status, and of its pages
    unless `plane` is given, into reused host buffers on the copy stream.
    Then drain the oldest batch while more than two are in flight: wait
    for its readback's event (the only point where the host waits for the
    card), raise ValueError("corrupt stream") if a page has a status bit,
    and call drain(keys, pages [n, page_size] uint8 numpy or None,
    isdelta [n] bool) on the host. Batches drain in launch order.

    plane: optional uint8 [rows, page_size] tensor on `dev`; each batch's
    pages are copied into rows `keys` of it on the device (index_copy_)
    and not read back. Whatever drain raises (format.errors.Aborted, for
    one) propagates once every queued copy has completed."""
    offsets = np.asarray(offsets, dtype=np.uint64)
    sizes = np.asarray(sizes, dtype=np.uint64)
    keys = np.asarray(keys, dtype=np.int64)
    wl, batches = batch_plan(payload, offsets, sizes, batch_pages)
    if not batches:
        return
    st = Streams(dev)
    P = len(batches[0])
    staging = [StagingBuffers(st, wl * NBS // 128, P) for _ in range(2)]
    # a batch's readback buffers are reused three batches later, after
    # its drain
    back_status = [st.host_empty(P, torch.int32) for _ in range(3)]
    back_pages = [None if plane is not None
                  else st.host_empty(P * page_size, torch.uint8)
                  for _ in range(3)]
    inflight: deque = deque()
    try:
        for k, b in enumerate(batches):
            n = len(b)
            buf = staging[k % 2]
            buf3, npd = buf.stage(payload, offsets[b], sizes[b], wl)
            isdelta = npd.numpy()[:, 2] != 0
            staged, rows = buf.upload(buf3, npd,
                                      None if plane is None else keys[b])
            pages, _, status = decode_batch(staged, page_size, variant,
                                            sweep_cw)
            if plane is not None:
                plane.index_copy_(0, rows, pages)
            launched = st.record(st.compute)
            status_h = back_status[k % 3][:n]
            pages_h = None if plane is not None else \
                back_pages[k % 3][: n * page_size].view(n, page_size)
            with st.on_copy():
                st.wait(st.copy, launched)
                status_h.copy_(status, non_blocking=True)
                if pages_h is not None:
                    pages_h.copy_(pages, non_blocking=True)
                done = st.record(st.copy)
            inflight.append(_InFlight(
                keys[b], isdelta, (staged, rows, pages, status),
                None if pages_h is None else pages_h.numpy(),
                status_h.numpy(), done))
            if len(inflight) > 2:
                _drain(st, inflight.popleft(), drain)
        while inflight:
            _drain(st, inflight.popleft(), drain)
    finally:
        # no copy may still write into buffers this call drops
        for b in inflight:
            st.sync(b.done)


def _drain(st: Streams, b: _InFlight, drain) -> None:
    st.sync(b.done)
    if bool((b.status != 0).any()):
        raise ValueError("corrupt stream")
    drain(b.keys, b.pages, b.isdelta)


def decode_stream(data: bytes, device, batch_pages: int = 256,
                  feedback=None, variant=None, sweep_cw: int = 1024,
                  return_device: bool = False):
    """Decode a full Brotli-G container on `device` ("cuda" or "cpu").

    Raw pages are copied on the host; compressed pages are decoded in
    size-sorted batches of `batch_pages` by decode_batches (dispatch
    ahead, drain behind), each through the tables step and a decode
    route on the device: the CUDA kernels for a CUDA device, their plain
    versions on the CPU.

    variant picks the route, as in the JAX package:
    * None or "fused": the tables kernel, then the fused decode kernel
      (commands, literals and copies in one launch);
    * "two_phase": the tables kernel, the phase-A kernel (commands and
      literals to device memory), then the sweep kernel at `sweep_cw`;
    * "xla": the plain torch wavefront on `device`, no kernel (the
      counterpart of the JAX package's XLA route); only when asked for.
    sweep_cw (128, 512, 1024 or 2048) is the sweep kernel's group width.
    It is validated on every route and used only by "two_phase": the
    fused kernel executes each round's copies at once. The bytes never
    depend on it. Bad values raise ValueError.

    Preconditioned (BCn texture) containers are delta-decoded and
    deconditioned on `device` (ops.precondition). Up to 1 GiB of pages,
    the decoded pages stay there, in a [num_pages, page_size] plane, and
    only the deconditioned bytes come back; with return_device=True they
    stay on the device and a uint8 tensor is returned. Larger streams,
    and streams of raw pages only, are assembled on the host and then
    postprocessed on `device` (bytes are returned).

    feedback: optional callable(progress 0..100) -> bool, invoked after
    each batch drains with the share of compressed pages drained;
    returning True raises format.errors.Aborted."""
    _check_opts(variant, sweep_cw)
    dev = resolve_device(device)
    info = parse_container(data)
    header, dc = info.header, info.dc_params
    if header.num_pages == 0:
        return b""
    page_size = header.page_size
    page_out_sizes = info.page_out_sizes
    raw_idx = info.raw_page_indices()
    comp, offs, szs = compressed_jobs(info)
    # the fused postprocess keeps the decoded pages on the device, bounded
    # to 1 GiB of plane (multi-GB bundles assemble on the host)
    fuse_dc = dc is not None and len(comp) > 0 and \
        header.num_pages * page_size <= (1 << 30)

    out = bytearray(info.out_size)
    out_np = np.frombuffer(out, np.uint8)
    plane = None
    if fuse_dc:
        plane = torch.zeros((header.num_pages, page_size), dtype=torch.uint8,
                            device=dev)
        if raw_idx:
            # raw pages go into the plane once
            raw_rows = np.zeros((len(raw_idx), page_size), np.uint8)
            for r, i in enumerate(raw_idx):
                off = int(info.offsets[i])
                raw_rows[r, : page_out_sizes[i]] = np.frombuffer(
                    data, np.uint8, page_out_sizes[i], off)
            plane.index_copy_(0, torch.tensor(raw_idx, device=dev),
                              torch.from_numpy(raw_rows).to(dev))
    else:
        for i in raw_idx:
            off = int(info.offsets[i])
            out[i * page_size: i * page_size + page_out_sizes[i]] = \
                data[off: off + page_out_sizes[i]]

    isdelta_pages: set = set()
    drained = [0]

    def drain(keys, pages, isdelta):
        isdelta_pages.update(int(i) for i in keys[isdelta])
        if pages is not None:
            for row, i in enumerate(keys):
                n = page_out_sizes[i]
                out_np[i * page_size: i * page_size + n] = pages[row, :n]
        drained[0] += len(keys)
        if feedback is not None and feedback(
                drained[0] * 100.0 / max(len(comp), 1)):
            raise Aborted("decode aborted by feedback proc")

    decode_batches(data, comp, offs, szs, page_size, dev, drain,
                   batch_pages, variant, sweep_cw, plane)

    if dc is None:
        return bytes(out)
    # only compressed pages whose header flag is set were delta-encoded
    flagged = isdelta_pages if len(comp) else set()
    if fuse_dc:
        res = postprocess_flat_device(plane.reshape(-1)[: info.out_size],
                                      dc, page_size, flagged)
        return res if return_device else _host_bytes(res)
    return postprocess_device(bytes(out), dc, page_size, dev, flagged)


def _host_bytes(t: torch.Tensor) -> bytes:
    """A uint8 device tensor's bytes, read back through page-locked
    memory on a card."""
    if not t.is_cuda:
        return t.numpy().tobytes()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host.numpy().tobytes()
