"""The schedule of the windowed-DP kernel (csrc/dp_parse.cu) rendered in
torch and held to ops/parse_dp.py::dp_parse_plain, bit for bit.

The kernel changes the plain version's schedule, not its function:
  * a block stops at the first round in which no dp value fell (no
    literal closure took a cell and no match relax won): that round left
    the block's (dp, anchor) state as it found it, so every later round and
    the final closure would leave it so too; otherwise it stops after R
    rounds and runs the final closure;
  * the edges whose source lies in the window (before the block) are
    relaxed in the block's first round only: their sources' dp values and
    insert codes are fixed while the block runs, and dp only falls, so
    they cannot win again; later rounds relax the edges whose source is a
    cell of the block;
  * insert codes come from a closed form (ins_code below) instead of 23
    compares.
`dp_parse_rounds` is that schedule as torch ops, with the rounds each page
ran; tests/test_torch_kernels.py holds the kernel's own round counts to
it on the card. The inputs come from the port's CPU route at
tests/test_ops_encode.py::TestParseDP's shapes (S 2048, W 256); no JAX runs
here (tests/test_torch_parse_dp.py pins the plain version to the JAX
package).
"""
import numpy as np
import pytest
import torch

from brotlig_tpu_torch.ops import arith_lut
from brotlig_tpu_torch.ops import encode as TE
from brotlig_tpu_torch.ops import parse_dp as TD
from brotlig_tpu_torch.ops.encode_pack import cpy_code_vec
from test_roundtrip import make_data
from test_torch_two_phase import torch_one_thread  # noqa: F401 (autouse)

I64 = torch.int64
S = 2048
B, W = 32, 256
KINDS = [("text", S), ("structured", S - 97), ("repetitive", S),
         ("random", 1000), ("zeros", S)]
ROUNDS = (0, 1, 2, 6, 16)


def ins_code(v: torch.Tensor) -> torch.Tensor:
    """The kernel's closed form of the insert code of v >= 0 (the index of
    the last INS_BASE entry <= v): v itself below 6; from 6 to 257 two
    codes per power of two of v - 2; from 258 on, 17 plus the bases from
    322 on that v reaches."""
    x = (v - 2).clamp(min=4)
    nb = torch.floor(torch.log2(x.double())).to(I64)
    mid = 2 * nb + ((x >> (nb - 1)) & 1) + 2
    big = 17 + sum((v >= b).to(I64) for b in TD.INS_BASE[18:])
    return torch.where(v < 6, v, torch.where(v < 258, mid, big))


def dp_parse_rounds(litq, cand_len, dpackq, jointEq, jointLq, B: int,
                    W: int, R: int):
    """The kernel's schedule (module docstring) as torch ops on [P, ...]
    pages. Returns (combined int32 [P, S], as dp_parse_plain's, and the
    rounds each page ran, summed over its blocks, int64 [P])."""
    P, S = litq.shape
    K = cand_len.shape[2]
    INF_Q, LB = TD.INF_Q, TD.LEN_BITS
    INF_C = INF_Q << LB
    litq, cand_len, dpackq = litq.to(I64), cand_len.to(I64), dpackq.to(I64)
    jointEq, jointLq = jointEq.to(I64), jointLq.to(I64)
    litq_p = torch.cat([litq.new_zeros(P, W), litq, litq.new_zeros(P, B)], 1)
    clen_p = torch.cat([cand_len.new_zeros(P, W, K), cand_len,
                        cand_len.new_zeros(P, B, K)], 1)
    dpk_p = torch.cat([dpackq.new_full((P, W, K), INF_Q << 1), dpackq,
                       dpackq.new_full((P, B, K), INF_Q << 1)], 1)
    lens = [x for x in TD.CPY_BASE if x <= W]
    ccb = torch.tensor([TD._copy_code_static(x) for x in lens])
    lens_c = torch.tensor(lens)
    cpyx_b = torch.as_tensor(TD._CPY_EXTRA_Q[ccb.numpy()])[None, None, :,
                                                           None]
    u_grid = torch.tensor([[W + t - x for x in lens] for t in range(B)])
    insx_q = 2 * arith_lut.insert_extra(torch.arange(24))
    o_idx = torch.arange(W + B)[None, :, None]
    bidx = torch.arange(B)[None, :]
    # the edges a later round relaxes: those whose source is a block cell
    base_in = (u_grid >= W)[None, :, :, None]
    full_in = o_idx >= W

    dpwin = torch.full((P, W), INF_C, dtype=I64)
    dpwin[:, W - 1] = 0
    anchwin = torch.zeros((P, W), dtype=I64)
    rounds = torch.zeros(P, dtype=I64)
    blocks = []
    for s0 in range(0, S, B):
        clenw = clen_p[:, s0 + 1:s0 + 1 + W + B]
        dpkw = dpk_p[:, s0 + 1:s0 + 1 + W + B]
        dcw, rs0w = dpkw >> 1, (dpkw & 1) > 0
        ccf = cpy_code_vec(clenw.clamp(min=2))
        cpyx_f = 2 * arith_lut.copy_extra(ccf)
        full_rest = (dcw + cpyx_f).clamp(max=INF_Q)
        full_t = o_idx + clenw - W
        full_ok = (clenw >= 2) & (full_t >= 0) & (full_t < B)
        full_ti = torch.where(full_ok, full_t, B).reshape(P, -1)
        cl_g, dc_g, rs0_g = (clenw[:, u_grid, :], dcw[:, u_grid, :],
                             rs0w[:, u_grid, :])
        base_rest = (dc_g + cpyx_b).clamp(max=INF_Q)
        base_ok = cl_g >= lens_c[None, None, :, None]
        A = torch.cumsum(litq_p[:, s0 + W:s0 + W + B], dim=1)
        seed = dpwin[:, W - 1] >> LB
        seed_anch = anchwin[:, W - 1]
        pos_cat = s0 + 1 + torch.arange(W + B)[None, :] - W
        pos_blk = pos_cat[:, W:]

        def closure(dp_blk, anch_blk):
            c = dp_blk >> LB
            m = c - A
            srcm = torch.cat([seed[:, None], m[:, :-1]], dim=1)
            zp = torch.cummin(((srcm + 4096) << 6) | bidx, dim=1).values
            litc = ((zp >> 6) - 4096 + A).clamp(max=INF_Q)
            take = litc < c
            anch_src = torch.cat([seed_anch[:, None], anch_blk[:, :-1]], 1)
            return (torch.where(take, litc << LB, dp_blk),
                    torch.where(take, torch.gather(anch_src, 1, zp & 63),
                                anch_blk))

        def relax(dp_blk, anch_blk, first: bool):
            cost_cat = torch.cat([dpwin, dp_blk], dim=1) >> LB
            anch_cat = torch.cat([anchwin, anch_blk], dim=1)
            ic_u = ins_code((pos_cat - anch_cat).clamp(0, 1 << 22))
            insx_u = insx_q[ic_u]
            src = cost_cat[:, u_grid] + insx_u[:, u_grid]
            jidx = (ic_u[:, u_grid] * 24 + ccb).reshape(P, -1)
            jE = torch.gather(jointEq, 1, jidx).reshape(P, B, -1)
            jL = torch.gather(jointLq, 1, jidx).reshape(P, B, -1)
            tot = ((src + jE)[..., None] + base_rest).clamp(max=INF_Q)
            totL = ((src + jL)[..., None] + cpyx_b).clamp(max=INF_Q)
            tot = torch.where(rs0_g, torch.minimum(tot, totL), tot)
            tot = torch.where(base_ok & (first | base_in), tot, INF_Q)
            comb = (tot << LB) | lens_c[None, None, :, None]
            out = torch.minimum(dp_blk, comb.reshape(P, B, -1).amin(2))
            jfi = (ic_u[:, :, None] * 24 + ccf).reshape(P, -1)
            jEf = torch.gather(jointEq, 1, jfi).reshape(P, W + B, K)
            jLf = torch.gather(jointLq, 1, jfi).reshape(P, W + B, K)
            head = (cost_cat + insx_u)[:, :, None]
            fE = (head + jEf + full_rest).clamp(max=INF_Q)
            fL = (head + jLf + cpyx_f).clamp(max=INF_Q)
            fcost = torch.where(rs0w, torch.minimum(fE, fL), fE)
            fcost = torch.where(full_ok & (first | full_in), fcost, INF_Q)
            fcomb = ((fcost << LB) | clenw).reshape(P, -1)
            pad = torch.cat([out, out.new_zeros(P, 1)], dim=1)
            return pad.scatter_reduce_(1, full_ti, fcomb, "amin")[:, :B]

        dp_blk = torch.full((P, B), INF_C, dtype=I64)
        anch_blk = torch.zeros((P, B), dtype=I64)
        live = torch.ones(P, dtype=torch.bool)   # no fixed point yet
        for r in range(R):
            rounds += live
            dp_c, anch_c = closure(dp_blk, anch_blk)
            dp_r = relax(dp_c, anch_c, r == 0)
            anch_r = torch.where(dp_r < dp_c, pos_blk, anch_c)
            fell = (dp_r < dp_blk).any(1)
            dp_blk = torch.where(live[:, None], dp_r, dp_blk)
            anch_blk = torch.where(live[:, None], anch_r, anch_blk)
            live &= fell
            if not live.any():
                break
        dp_c, anch_c = closure(dp_blk, anch_blk)
        dp_blk = torch.where(live[:, None], dp_c, dp_blk)
        anch_blk = torch.where(live[:, None], anch_c, anch_blk)
        dpwin = torch.cat([dpwin, dp_blk], dim=1)[:, -W:]
        anchwin = torch.cat([anchwin, anch_blk], dim=1)[:, -W:]
        blocks.append(dp_blk)
    return torch.cat(blocks, dim=1).to(torch.int32), rounds


def dp_inputs(kinds, n: int, W: int):
    """The first cost-model iteration's DP inputs (litq, cand_len, dpackq,
    jointEq, jointLq) of (kind, length) pages of n bytes, from the port's
    CPU route; pages as tests/test_ops_encode.py::TestParseDP makes
    them."""
    arr = np.zeros((len(kinds), n), np.uint8)
    sizes = np.zeros(len(kinds), np.int32)
    for i, (kind, size) in enumerate(kinds):
        arr[i, :size] = np.frombuffer(make_data(kind, size, seed=i + 20),
                                      np.uint8)
        sizes[i] = size
    pages, in_sizes = torch.from_numpy(arr), torch.from_numpy(sizes)
    greedy = TE.find_commands(pages, in_sizes, n // 2 + 2)
    m = TD.build_cost_model(pages, in_sizes, *greedy,
                            *TE.find_candidates(pages, in_sizes, W))
    return m[0], m[3], m[5], m[1], m[2]


@pytest.fixture(scope="module")
def inputs():
    return dp_inputs(KINDS, S, W)


@pytest.fixture(scope="module")
def schedule(inputs):
    """dp_parse_rounds on the inputs at a given R, each R run once."""
    runs = {}

    def run(R):
        if R not in runs:
            runs[R] = dp_parse_rounds(*inputs, B, W, R)
        return runs[R]
    return run


@pytest.mark.parametrize("R", ROUNDS)
def test_schedule_matches_plain(inputs, schedule, R):
    """Bit for bit at every R, R 0 and 1 included; no page runs more than
    R rounds a block."""
    got, rounds = schedule(R)
    want = TD.dp_parse_plain(*inputs, B, W, R)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert int(rounds.max()) <= R * (S // B)


def test_fixed_point_is_reached_late(schedule):
    """At R 16 the text page's blocks need several rounds: the mean lies
    above 2 and below 16, so the exit is taken late, not only at round
    2; every page stops before R on average."""
    _, rounds = schedule(16)
    mean = rounds.double() / (S // B)
    assert 2 < float(mean[0]) < 16
    assert bool((mean < 16).all())


def test_insert_code_closed_form():
    """ins_code equals dp_parse_plain's bucketize over INS_BASE on the
    whole clipped range [0, 2^22]."""
    v = torch.arange(0, (1 << 22) + 1)
    want = torch.bucketize(v, torch.tensor(TD.INS_BASE[1:]), right=True)
    assert torch.equal(ins_code(v), want)
