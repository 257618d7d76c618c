"""The windowed-DP optimal parse on a torch device (port of
brotlig_tpu/ops/parse_dp.py): the q11 tier of the full-device encoder.

The reference encoder's ratio comes from brotli's q11 optimal parse: a
shortest path over literal and match transitions under a cost model fit to
a previous parse. Here, per batch of pages:

* `build_cost_model`: from the previous parse's commands (the greedy parse
  first), the serializer's own table lengths, the page's searched
  (npostfix, ndirect) and the distance ring each byte inherits, priced in
  half-bits: each byte as a literal, each joint (insert code, copy code)
  command symbol in both distance forms, and each candidate's distance
  (with the four ring distances probed as extra candidates). On a CUDA
  tensor it launches the kernels (csrc/cost_model.cu through
  ops/cost_kernel.py: a thread block cluster a page for the tables, then
  tiles of positions); on a CPU tensor it runs `build_cost_model_plain`,
  the JAX module's jitted function as torch ops;
* `dp_parse`: dp[p], the least half-bits to encode the first p bytes, by
  blocks of B positions over a W-deep window of sources, R rounds of match
  relaxes per block; the literal chains of a block collapse into one
  prefix-sum cummin. On a CUDA tensor it launches the kernel
  (csrc/dp_parse.cu through ops/dp_kernel.py), which runs the whole block
  loop in one launch; on a CPU tensor it runs `dp_parse_plain`, the JAX
  module's lax.scan as a Python loop of torch ops;
* `backtrack` (host numpy): the backpointers into commands;
* `find_commands_dp`: the greedy parse seeds the cost model, and the model
  is refit to each DP parse, `iters` times (BLG_DP_ITERS, default 3).

Costs are half-bit fixed point packed with the backpointer length into one
int ((cost << LEN_BITS) | from_len), so a min carries its argmin; costs
saturate at INF_Q, so every packed value is below 2^31 and the int64 plain
version and the int32 kernel agree bit for bit. The cost model compares
float32 table costs as the JAX module does (the same round-half-even of
the same float32 values).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from . import arith_lut
from . import cost_kernel, dp_kernel
from .encode import _match_len, _quads, find_candidates, find_commands
from .encode_pack import (A_CMD, A_DST, A_LIT, _choose_table,
                          _encode_distance_vec, _ring_before,
                          combine_codes_vec, cpy_code_vec, page_histograms)

I64 = torch.int64

# the DP's static copy-length bucket bases (the JAX module's CPY_BASE; its
# last four entries are not RFC 7932's, and the DP prices them by index,
# as the JAX module does)
CPY_BASE = (2, 3, 4, 5, 6, 7, 8, 9, 10, 12, 14, 18, 22, 30, 38, 54, 70,
            102, 134, 198, 262, 390, 518, 774)
# insert-length code bases (RFC 7932): the code of n is the last base <= n
INS_BASE = (0, 1, 2, 3, 4, 5, 6, 8, 10, 14, 18, 26, 34, 50, 66, 98, 130,
            194, 322, 578, 1090, 2114, 6210, 22594)

COST_BITS = 21                    # half-bit cost field
LEN_BITS = dp_kernel.LEN_BITS     # from_len field (W <= 1023)
INF_Q = (1 << COST_BITS) - 1      # saturating cost, half-bits

# defaults of find_commands_dp's block, window and rounds, read when it is
# called (encode_pages_device passes none)
BLOCK, WINDOW, ROUNDS = 32, 512, 16

# copy extra-bit widths by code (RFC 7932), half-bit units
_CPY_EXTRA_Q = 2 * np.asarray(
    [0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4,
     5, 5, 6, 7, 8, 9, 10, 24], np.int64)


def _copy_code_static(L: int) -> int:
    """The index of the last bucket base <= L."""
    cc = 0
    for i, b in enumerate(CPY_BASE):
        if b <= L:
            cc = i
    return cc


def unseen_bits(total: torch.Tensor, pad: float) -> torch.Tensor:
    """The float32 bits charged for a symbol the previous parse did not
    use: min(15, log2(total) + pad), total >= 1 symbols in the table."""
    return torch.clamp(torch.log2(total.to(torch.float32)) + pad, max=15.0)


def _half_bits(bits: torch.Tensor) -> torch.Tensor:
    return torch.round(2.0 * bits).to(I64)


def build_cost_model(pages, in_sizes, ins, cpy, dist, ncmds, base_len,
                     base_dist):
    """Per-page DP cost tables and candidate set from a previous parse
    (see build_cost_model_plain for the arguments and outputs). On a CUDA
    tensor it launches the kernels (csrc/cost_model.cu through
    ops/cost_kernel.py), on a CPU tensor it runs the plain version."""
    args = (pages, in_sizes, ins, cpy, dist, ncmds, base_len, base_dist)
    if pages.is_cuda:
        return cost_kernel.build_cost_model_cuda(*args)
    if pages.device.type == "cpu":
        return build_cost_model_plain(*args)
    raise ValueError(f"no build_cost_model route for device {pages.device}")


def build_cost_model_plain(pages, in_sizes, ins, cpy, dist, ncmds, base_len,
                           base_dist):
    """Plain torch version of the cost-model kernels, on any device:
    per-page DP cost tables and candidate set from a previous parse.

    pages: uint8 [P, S]; in_sizes, ncmds: [P]; ins/cpy/dist: [P, N]
    commands; base_len/base_dist: [P, S, 8] from find_candidates. Each
    byte inherits the distance ring of the previous parse at its covering
    command; the four ring distances are probed as extra candidates (at
    most 16 bytes), and a candidate distance that ring-codes against the
    inherited state is credited the ring symbol's cost.

    Returns int32 (litq [P, S], jointEq [P, 576], jointLq [P, 576],
    cand_len [P, S, 12], cand_dist [P, S, 12], dpackq [P, S, 12]):
      litq    - half-bits of byte p as a literal;
      jointEq - joint (ins, cpy) command-symbol half-bits, explicit form;
      jointLq - the same in the implicit-ring0 (use_last) form, INF_Q
                where that form does not exist (ic >= 8 or cc >= 16);
      dpackq  - (half-bits of candidate k's distance at p << 1) | ring-0
                hit flag."""
    P, S = pages.shape
    dev = pages.device
    in_sizes, ncmds = in_sizes.to(I64), ncmds.to(I64)
    ins, cpy, dist = ins.to(I64), cpy.to(I64), dist.to(I64)
    N = ins.shape[1]
    # the histograms the serializer builds its tables from
    (_, _, _, npostfix, ndist, (cmd_of, covered, _),
     (hist_cmd, hist_dst, hist_lit)) = page_histograms(
        pages, in_sizes, ins, cpy, dist, ncmds)
    ndirect = ndist << npostfix
    valid = torch.arange(N, device=dev)[None, :] < ncmds[:, None]

    # ---- serializer table lengths -> per-symbol bits, float32 [P, A] ----
    def sym_cost(hist, total, A, pad):
        lens = _choose_table(hist, total, A)[0]
        unseen = unseen_bits(total.clamp(min=1), pad)[:, None]
        return torch.where(hist > 0, lens.to(torch.float32), unseen)

    lit_c = sym_cost(hist_lit, hist_lit.sum(1), A_LIT, 2.0)
    dst_c = sym_cost(hist_dst, hist_dst.sum(1), A_DST, 4.0)
    cmd_c = sym_cost(hist_cmd, hist_cmd.sum(1), A_CMD, 2.0)

    # ---- joint (ins, cpy) command-symbol costs [P, 576] ----
    grid = torch.arange(24, device=dev)
    ic_g, cc_g = grid[:, None].expand(24, 24), grid[None, :].expand(24, 24)
    explicit = combine_codes_vec(ic_g, cc_g, torch.zeros_like(ic_g,
                                                             dtype=torch.bool))
    jointEq = _half_bits(cmd_c[:, explicit.reshape(-1)])
    implicit = combine_codes_vec(ic_g, cc_g, torch.ones_like(ic_g,
                                                            dtype=torch.bool))
    repr_ok = ((ic_g < 8) & (cc_g < 16)).reshape(-1)
    jointLq = torch.where(repr_ok, _half_bits(cmd_c[:, implicit.reshape(-1)]),
                          INF_Q)

    # ---- per-byte literal cost ----
    litq = _half_bits(torch.gather(lit_c, 1, pages.to(I64)))

    # ---- inherited ring state per byte (the tail inherits the state
    # after the last command) ----
    is_copy = valid & (cpy > 0) & (dist > 0)
    rings = _ring_before(torch.cat([dist, dist.new_zeros(P, 1)], dim=1),
                         torch.cat([is_copy, is_copy.new_zeros(P, 1)], dim=1))
    pos_idx = torch.arange(S, device=dev).expand(P, S)
    cmd_of_e = torch.where(pos_idx >= covered, ncmds[:, None], cmd_of)
    rb = [torch.gather(r, 1, cmd_of_e.clamp(0, N)) for r in rings]

    # ---- ring-distance probe candidates ----
    quads = _quads(pages)
    limit = in_sizes[:, None]
    ring_l, ring_d = [], []
    for r in rb:
        cnd = torch.where((r >= 1) & (pos_idx - r >= 0), pos_idx - r, -1)
        ml = _match_len(quads, pos_idx, cnd, limit, words=4)
        ok = ml >= 2
        ring_l.append(torch.where(ok, ml, 0))
        ring_d.append(torch.where(ok, r, 0))
    cand_len = torch.cat([base_len.to(I64), torch.stack(ring_l, dim=2)], dim=2)
    cand_dist = torch.cat([base_dist.to(I64), torch.stack(ring_d, dim=2)],
                          dim=2)

    # ---- candidate distance costs: symbol + extra bits, or the ring
    # symbol's cost where the distance hits the inherited ring ----
    K = cand_dist.shape[2]
    dsym, dnb, _ = _encode_distance_vec(
        cand_dist.reshape(P, S * K).clamp(min=1), npostfix, ndirect)
    dbits = torch.where(dsym < A_DST,
                        torch.gather(dst_c, 1, dsym.clamp(0, A_DST - 1)), 40.0)
    dq = (_half_bits(dbits) + 2 * dnb).reshape(P, S, K)
    rsym = torch.full_like(cand_dist, -1)
    pairs = [(rb[0], 0), (rb[1], 1), (rb[2], 2), (rb[3], 3)]
    for j in range(3):
        pairs += [(rb[0] - (j + 1), 4 + 2 * j), (rb[0] + (j + 1), 5 + 2 * j)]
    for j in range(3):
        pairs += [(rb[1] - (j + 1), 10 + 2 * j),
                  (rb[1] + (j + 1), 11 + 2 * j)]
    for val, code in reversed(pairs):
        rsym = torch.where((cand_dist == val[:, :, None]) & (cand_dist >= 1),
                           code, rsym)
    ring_q = _half_bits(torch.gather(
        dst_c, 1, rsym.clamp(0, A_DST - 1).reshape(P, S * K))).reshape(P, S, K)
    dq = torch.where(rsym >= 0, torch.minimum(dq, ring_q), dq)
    # the low bit flags a ring-0 hit: the edge may then take the use_last
    # symbol with no distance at all (jointLq)
    dpackq = (dq.clamp(max=INF_Q) << 1) | (rsym == 0).to(I64)
    i32 = torch.int32
    return (litq.to(i32), jointEq.to(i32), jointLq.to(i32), cand_len.to(i32),
            cand_dist.to(i32), dpackq.to(i32))


def dp_parse(litq, cand_len, dpackq, jointEq, jointLq, B: int, W: int,
             R: int) -> torch.Tensor:
    """Windowed-DP shortest path: int32 [P, S] whose column p-1 holds
    ((dp[p] half-bits) << LEN_BITS) | from_len(p), from_len 0 for a
    literal step. Inputs from build_cost_model; B positions a block, W
    source window (the longest match relaxed), R match-edge rounds a
    block. Requires S % B == 0, W % B == 0, W <= 1023 and B <= 63.

    On a CUDA tensor it launches the kernel, on a CPU tensor it runs the
    plain version."""
    if litq.is_cuda:
        return dp_kernel.dp_parse_cuda(litq, cand_len, dpackq, jointEq,
                                       jointLq, B, W, R)
    if litq.device.type == "cpu":
        return dp_parse_plain(litq, cand_len, dpackq, jointEq, jointLq, B, W,
                              R)
    raise ValueError(f"no dp_parse route for device {litq.device}")


def dp_parse_plain(litq, cand_len, dpackq, jointEq, jointLq, B: int, W: int,
                   R: int) -> torch.Tensor:
    """Plain torch version of the DP kernel, on any device: the JAX
    module's block scan as a Python loop, op for op (int64 arithmetic).

    Each node carries its pending-insert anchor (the last command end on
    its best path), so a match relax prices the exact joint symbol and the
    insert extra bits. Per block: a literal closure (the packed argmin
    cummin of dp - prefix cost), then R rounds of relaxing match edges at
    the static bucket bases (a gather) and at each candidate's full length
    (a scatter-min), each round closed again by literals, and a final
    closure; a match relax that wins sets the target's anchor to itself."""
    P, S = litq.shape
    K = cand_len.shape[2]
    dp_kernel.check_dp_args(S, B, W, R)
    dev = litq.device
    INF_C = INF_Q << LEN_BITS
    litq, cand_len, dpackq = litq.to(I64), cand_len.to(I64), dpackq.to(I64)
    jointEq, jointLq = jointEq.to(I64), jointLq.to(I64)

    # pad left by W (window slices start at >= 0) and right by B (the last
    # block's slice)
    litq_p = torch.cat([litq.new_zeros(P, W), litq, litq.new_zeros(P, B)], 1)
    clen_p = torch.cat([cand_len.new_zeros(P, W, K), cand_len,
                        cand_len.new_zeros(P, B, K)], 1)
    dpk_p = torch.cat([dpackq.new_full((P, W, K), INF_Q << 1), dpackq,
                       dpackq.new_full((P, B, K), INF_Q << 1)], 1)

    # static bucket-base edge tables
    LENS = [x for x in CPY_BASE if x <= W]
    cc_b = [_copy_code_static(x) for x in LENS]

    def const(x):
        return torch.as_tensor(np.asarray(x, np.int64), device=dev)
    lens_c = const(LENS)
    ccb = const(cc_b)
    cpyx_b = const(_CPY_EXTRA_Q[cc_b])[None, None, :, None]
    # source cell in the [window | block] concat for target t, length L
    u_grid = const([[W + t - x for x in LENS] for t in range(B)])  # [B, nL]
    ins_bounds = const(INS_BASE[1:])
    insx_q = 2 * arith_lut.insert_extra(torch.arange(24, device=dev))
    o_idx = torch.arange(W + B, device=dev)[None, :, None]
    bidx = torch.arange(B, device=dev)[None, :]

    dpwin = torch.full((P, W), INF_C, dtype=I64, device=dev)
    dpwin[:, W - 1] = 0
    anchwin = torch.zeros((P, W), dtype=I64, device=dev)
    blocks = []
    for s0 in range(0, S, B):
        litw = litq_p[:, s0 + 1:s0 + 1 + W + B]
        clenw = clen_p[:, s0 + 1:s0 + 1 + W + B]
        dpkw = dpk_p[:, s0 + 1:s0 + 1 + W + B]
        dcw = dpkw >> 1
        rs0w = (dpkw & 1) > 0

        # full-length edges: the distance + copy-extra part is dp-free
        ccf = cpy_code_vec(clenw.clamp(min=2))
        cpyx_f = 2 * arith_lut.copy_extra(ccf)
        full_rest = (dcw + cpyx_f).clamp(max=INF_Q)
        full_t = o_idx + clenw - W
        full_ok = (clenw >= 2) & (full_t >= 0) & (full_t < B)
        full_ti = torch.where(full_ok, full_t, B).reshape(P, -1)

        # bucket-base edges [P, B, nL, K]
        cl_g = clenw[:, u_grid, :]
        dc_g = dcw[:, u_grid, :]
        rs0_g = rs0w[:, u_grid, :]
        base_rest = (dc_g + cpyx_b).clamp(max=INF_Q)
        base_ok = cl_g >= lens_c[None, None, :, None]
        base_tag = lens_c[None, None, :, None]

        # literal prefix sums: lp[t] = litq of byte s0 + t
        A = torch.cumsum(litw[:, W - 1:W + B - 1], dim=1)
        seed = dpwin[:, W - 1] >> LEN_BITS
        seed_anch = anchwin[:, W - 1]
        pos_cat = s0 + 1 + torch.arange(W + B, device=dev)[None, :] - W
        pos_blk = pos_cat[:, W:]

        def closure(dp_blk, anch_blk):
            c = dp_blk >> LEN_BITS
            m = c - A
            srcm = torch.cat([seed[:, None], m[:, :-1]], dim=1)
            # packed argmin: the value in the high bits, the source cell in
            # the low 6 (m > -4096: litq < 64 half-bits a byte, B <= 63)
            zp = torch.cummin(((srcm + 4096) << 6) | bidx, dim=1).values
            litc = ((zp >> 6) - 4096 + A).clamp(max=INF_Q)
            take_lit = litc < c
            anch_src = torch.cat([seed_anch[:, None], anch_blk[:, :-1]],
                                 dim=1)
            win_anch = torch.gather(anch_src, 1, zp & 63)
            return (torch.where(take_lit, litc << LEN_BITS, dp_blk),
                    torch.where(take_lit, win_anch, anch_blk))

        dp_blk = torch.full((P, B), INF_C, dtype=I64, device=dev)
        anch_blk = torch.zeros((P, B), dtype=I64, device=dev)
        for _ in range(R):
            dp_blk, anch_blk = closure(dp_blk, anch_blk)
            dp0 = dp_blk
            cost_cat = torch.cat([dpwin, dp_blk], dim=1) >> LEN_BITS
            anch_cat = torch.cat([anchwin, anch_blk], dim=1)
            pend = (pos_cat - anch_cat).clamp(0, 1 << 22)
            ic_u = torch.bucketize(pend, ins_bounds, right=True)
            insx_u = insx_q[ic_u]

            # gather relax over the bucket-base lengths
            src = cost_cat[:, u_grid] + insx_u[:, u_grid]       # [P, B, nL]
            jidx = (ic_u[:, u_grid] * 24 + ccb).reshape(P, -1)
            jE = torch.gather(jointEq, 1, jidx).reshape(P, B, -1)
            jL = torch.gather(jointLq, 1, jidx).reshape(P, B, -1)
            tot = ((src + jE)[..., None] + base_rest).clamp(max=INF_Q)
            # the use_last channel: a ring-0 candidate emits no distance
            totL = ((src + jL)[..., None] + cpyx_b).clamp(max=INF_Q)
            tot = torch.where(rs0_g, torch.minimum(tot, totL), tot)
            tot = torch.where(base_ok, tot, INF_Q)
            comb = (tot << LEN_BITS) | base_tag
            dp_blk = torch.minimum(dp_blk, comb.reshape(P, B, -1).amin(2))

            # scatter relax at the candidates' full lengths
            jfi = (ic_u[:, :, None] * 24 + ccf).reshape(P, -1)
            jEf = torch.gather(jointEq, 1, jfi).reshape(P, W + B, K)
            jLf = torch.gather(jointLq, 1, jfi).reshape(P, W + B, K)
            head = (cost_cat + insx_u)[:, :, None]
            fE = (head + jEf + full_rest).clamp(max=INF_Q)
            fL = (head + jLf + cpyx_f).clamp(max=INF_Q)
            fcost = torch.where(rs0w, torch.minimum(fE, fL), fE)
            fcost = torch.where(full_ok, fcost, INF_Q)
            fcomb = ((fcost << LEN_BITS) | clenw).reshape(P, -1)
            # column B takes the edges that land outside the block
            dp_pad = torch.cat([dp_blk, dp_blk.new_zeros(P, 1)], dim=1)
            dp_blk = dp_pad.scatter_reduce_(1, full_ti, fcomb, "amin")[:, :B]

            # a winning match relax ends a command at its target
            anch_blk = torch.where(dp_blk < dp0, pos_blk, anch_blk)
        dp_blk, anch_blk = closure(dp_blk, anch_blk)
        dpwin = torch.cat([dpwin, dp_blk], dim=1)[:, -W:]
        anchwin = torch.cat([anchwin, anch_blk], dim=1)[:, -W:]
        blocks.append(dp_blk)
    return torch.cat(blocks, dim=1).to(torch.int32)


def backtrack(combined, cand_len, cand_dist, dpackq, in_sizes,
              max_cmds: int):
    """Walk the DP's backpointers into dense (ins, cpy, dist [P, max_cmds],
    ncmds [P]) int32 numpy arrays; a page with more than max_cmds commands
    gets ncmds -1 (the caller keeps its greedy commands).

    Host numpy: every node whose best in-edge is a match is an `end`; the
    chain from the page end steps from an end to the last end at or
    before its match start (one searchsorted for all ends). At a
    command's start, a ring-0 candidate of at least its length is taken
    first (the DP may have priced the use_last channel, which only a
    ring-0 candidate realizes), else the cheapest distance; ties go to the
    lower slot."""
    P, S = combined.shape
    flen = (combined & ((1 << LEN_BITS) - 1)).astype(np.int64)
    ins_o = np.zeros((P, max_cmds), np.int32)
    cpy_o = np.zeros((P, max_cmds), np.int32)
    dist_o = np.zeros((P, max_cmds), np.int32)
    nc_o = np.zeros(P, np.int32)
    for p in range(P):
        n = int(in_sizes[p])
        ends = np.nonzero(flen[p, :n] > 0)[0] + 1
        if ends.size == 0:
            continue
        starts = ends - flen[p, ends - 1]
        prev = (np.searchsorted(ends, starts, side="right") - 1).tolist()
        chain = []
        j = ends.size - 1
        while j >= 0 and len(chain) <= max_cmds:
            chain.append(j)
            j = prev[j]
        if len(chain) > max_cmds:
            nc_o[p] = -1
            continue
        at = np.asarray(chain[::-1])
        st, e = starts[at], ends[at]
        L = e - st
        ks = cand_len[p, st].astype(np.int64) >= L[:, None]
        pk = dpackq[p, st].astype(np.int64)
        r0 = ks & ((pk & 1) > 0)
        use = np.where(r0.any(1)[:, None], r0, ks)
        if not use.any(1).all():
            raise RuntimeError(f"page {p}: a DP match edge has no candidate")
        k = np.argmin(np.where(use, pk >> 1, np.int64(1) << 40), axis=1)
        m = at.size
        ins_o[p, :m] = st - np.concatenate([[0], e[:-1]])
        cpy_o[p, :m] = L
        dist_o[p, :m] = cand_dist[p, st, k]
        nc_o[p] = m
    return ins_o, cpy_o, dist_o, nc_o


def find_commands_dp(pages, in_sizes, max_cmds: int, iters: int | None = None,
                     B: int | None = None, W: int | None = None,
                     R: int | None = None, greedy_cmds=None):
    """The optimal parse of a batch of pages on their device: the greedy
    parse's statistics fit the cost model, the DP parses under it, and the
    model is refit to that parse, `iters` times.

    pages: uint8 [P, S]; in_sizes: [P] (tensors on one device). iters
    defaults to BLG_DP_ITERS (3); B, W and R default to the module's
    BLOCK, WINDOW and ROUNDS (32, 512, 16). greedy_cmds: the find_commands
    output to seed the model (computed, exact tier, when None). Returns
    (ins, cpy, dist [P, max_cmds], ncmds [P]) int32 numpy arrays; a page
    whose DP parse overflows max_cmds keeps its greedy commands."""
    if iters is None:
        iters = int(os.environ.get("BLG_DP_ITERS", "3"))
    if iters < 1:
        raise ValueError("find_commands_dp needs iters >= 1")
    B = BLOCK if B is None else B
    W = WINDOW if W is None else W
    R = ROUNDS if R is None else R
    dev = pages.device
    if greedy_cmds is None:
        greedy_cmds = find_commands(pages, in_sizes, max_cmds)
    cmds = tuple(greedy_cmds)
    greedy = tuple(c.cpu().numpy() for c in cmds)
    sizes_np = in_sizes.cpu().numpy()
    base_len, base_dist = find_candidates(pages, in_sizes, W)
    for _ in range(iters):
        litq, jointEq, jointLq, cand_len, cand_dist, dpackq = \
            build_cost_model(pages, in_sizes, *cmds, base_len, base_dist)
        combined = dp_parse(litq, cand_len, dpackq, jointEq, jointLq, B, W,
                            R)
        out = backtrack(combined.cpu().numpy(), cand_len.cpu().numpy(),
                        cand_dist.cpu().numpy(), dpackq.cpu().numpy(),
                        sizes_np, max_cmds)
        for p in np.nonzero(out[3] < 0)[0]:
            for new, old in zip(out, greedy):
                new[p] = old[p]
        cmds = tuple(torch.from_numpy(x).to(dev) for x in out)
    return out
