"""The torch twins of two steps of the page-decode round (csrc/
page_round.cuh, csrc/decode.cu): the distance ring as a 5-step scan of
lane transforms (ops/ring.py) and the fused kernel's placement of
literals at their output positions (literal_positions, below). Both are
held to the plain route, which tests/test_torch_two_phase.py pins to the
JAX XLA route, exactly; no JAX runs here.
"""
import numpy as np
import pytest
import torch

from brotlig_tpu_torch.ops import decode as TD
from brotlig_tpu_torch.ops.decode_kernel import LIT_PAD, plain_symbols
from brotlig_tpu_torch.ops.ring import INITIAL_RING, resolve_rounds
from brotlig_tpu_torch.ops.tables_kernel import NBS, load_tables_plain
from brotlig_tpu_torch.state import tables_from_lengths
from test_torch_two_phase import edge_case, mixed_pages, stage
from test_torch_two_phase import torch_one_thread  # noqa: F401 (autouse)

PS = 32768


@pytest.fixture(scope="module", params=("mixed", "dense_commands"))
def symbols(request):
    """(npostfix, ndirect, (ncmds, litbuf, ins, cpy, dcode, dextra)) of
    the plain phase A on tests/test_torch_two_phase.py's mixed batch and
    on its > 255-commands-a-group page."""
    if request.param == "mixed":
        comps = mixed_pages()[1]
    else:
        comps = [edge_case("dense_commands")[1]]
    st = stage(comps)
    tabs = tables_from_lengths(*load_tables_plain(st.buf))
    return plain_symbols(st.buf, st.npd, tabs, PS)


def test_ring_scan_matches_resolve_distances(symbols):
    npf, ndir, (ncmds, _, _, _, dcode, dextra) = symbols
    assert int(ncmds.max()) > 32            # more than one round
    want = TD._resolve_distances(dcode, dextra, ncmds, npf, ndir)
    got = resolve_rounds(dcode, dextra, ncmds, npf, ndir)
    assert torch.equal(got, want)


def serial_ring(codes, absv, ring):
    """The walk the scan replaced: commands in order, each reading the
    ring and pushing its distance unless its code is 0 (or -1)."""
    ring = list(ring)
    out = []
    for c, a in zip(codes, absv):
        if c < 0:
            d = 0
        elif c < 4:
            d = ring[c]
        elif c < 16:
            mag = ((c - 4) % 6) // 2 + 1
            d = ring[0 if c < 10 else 1] + (mag if c & 1 else -mag)
        else:
            d = a
        out.append(d)
        if c > 0:
            ring = [d] + ring[:3]
    return out, ring


def absolute_code(r, npf: int, ndir: int):
    """A random absolute distance code for (npostfix, ndirect) and valid
    extra bits for it."""
    if ndir and r.random() < 0.5:
        return 16 + int(r.integers(0, ndir)), 0
    code = 16 + ndir + int(r.integers(0, 24 << npf))
    nb = 1 + ((code - ndir - 16) >> (npf + 1))
    return code, int(r.integers(0, 1 << nb))


@pytest.mark.parametrize("k", [1, 17, 32])
def test_ring_scan_code_sweep(k):
    """Every relative code 0..15 in every lane, and rows with absolute
    codes mixed in, after a first round of absolute codes that leaves a
    ring other than the initial one; k commands in the swept round."""
    r = np.random.default_rng(k)
    rows = []
    for p in range(24):
        npf, ndir = p % 4, (0, 4, 12)[p % 3] << (p % 4)
        first = [absolute_code(r, npf, ndir) for _ in range(32)]
        sweep = [((i + p) % 16, 0) for i in range(32)]
        if p >= 16:                     # a few absolute codes too
            for i in range(p % 5, 32, 5):
                sweep[i] = absolute_code(r, npf, ndir)
        rows.append((npf, ndir, first + sweep))
    npf = torch.tensor([row[0] for row in rows])
    ndir = torch.tensor([row[1] for row in rows])
    dcode = torch.tensor([[c for c, _ in row[2]] for row in rows])
    dextra = torch.tensor([[e for _, e in row[2]] for row in rows])
    ncmds = torch.full((len(rows),), 32 + k)
    got = resolve_rounds(dcode, dextra, ncmds, npf, ndir)
    assert torch.equal(got, TD._resolve_distances(dcode, dextra, ncmds,
                                                  npf, ndir))
    # the same against the serial walk, ring after the round included
    from brotlig_tpu_torch.ops.ring import absolute_values
    absv = absolute_values(dcode, dextra, npf, ndir)
    for p in range(len(rows)):
        codes = dcode[p, :32 + k].tolist()
        want, _ = serial_ring(codes, absv[p].tolist(), INITIAL_RING)
        assert got[p, :32 + k].tolist() == want
        assert not got[p, 32 + k:].any()


def test_ring_scan_ring_out_matches_serial_walk():
    from brotlig_tpu_torch.ops.ring import absolute_values, ring_scan
    r = np.random.default_rng(5)
    P = 64
    npf = torch.tensor(r.integers(0, 4, P))
    ndir = torch.tensor(r.integers(0, 16, P)) << npf
    codes, extras = [], []
    for p in range(P):
        row = [absolute_code(r, int(npf[p]), int(ndir[p]))
               if r.random() < 0.3 else (int(r.integers(-1, 16)), 0)
               for _ in range(32)]
        codes.append([c for c, _ in row])
        extras.append([e for _, e in row])
    dcode, dextra = torch.tensor(codes), torch.tensor(extras)
    k = torch.tensor(r.integers(0, 33, P))
    ring_in = torch.tensor(r.integers(1, 5000, (P, 4)))
    dist, ring_out = ring_scan(dcode, dextra, npf, ndir, k, ring_in)
    absv = absolute_values(dcode, dextra, npf, ndir)
    for p in range(P):
        kp = int(k[p])
        want, ring = serial_ring(codes[p][:kp], absv[p].tolist(),
                                 ring_in[p].tolist())
        assert dist[p].tolist() == want + [0] * (32 - kp)
        assert ring_out[p].tolist() == ring


def literal_positions(ncmds, ins, cpy, page_size: int):
    """Where the fused kernel writes each decoded literal, round by round
    as csrc/decode.cu does it: a round decodes rlit literals (decode.py's
    rounding, the surplus prev_tail carried on); round-local literal l is
    first the held carry (l < prev_tail), then the new ones; l below the
    round's literal count goes to the insert of the last command whose
    literal start is <= l, the rest into the carry for the next round.
    ncmds [P]; ins, cpy [P, N] as phase A gives them. Returns [P,
    page_size + 64] int64: per literal-queue entry (decode order) its
    output position, -1 for entries never placed (the last round's
    surplus, and entries past the page's literals)."""
    P, N = ins.shape
    dev = ins.device
    lane = torch.arange(NBS, dtype=torch.int64, device=dev)[None, :]
    ncmds = ncmds.to(torch.int64)
    cap = page_size + LIT_PAD
    pos = torch.full((P, cap + 1), -1, dtype=torch.int64, device=dev)
    rows = torch.arange(P, device=dev)[:, None]
    carry = torch.full((P, NBS), cap, dtype=torch.int64, device=dev)
    prev_tail = torch.zeros(P, dtype=torch.int64, device=dev)
    qtail = torch.zeros_like(prev_tail)
    pos_tot = torch.zeros_like(prev_tail)
    for r in range(N // NBS):
        active = ncmds >= r * NBS
        if not bool(active.any()):
            break
        k = (ncmds - r * NBS).clamp(0, NBS)
        valid = lane < k[:, None]
        cols = slice(r * NBS, (r + 1) * NBS)
        i_r = torch.where(valid, ins[:, cols].to(torch.int64), 0)
        cov = i_r + torch.where(valid, cpy[:, cols].to(torch.int64), 0)
        lst = torch.cumsum(i_r, dim=1) - i_r
        wst = pos_tot[:, None] + torch.cumsum(cov, dim=1) - cov
        litcount = i_r.sum(dim=1)
        held = prev_tail
        aclit = (litcount - held).clamp(min=0)
        rlit = torch.where(k > 0, k * ((aclit + k - 1) // k.clamp(min=1)),
                           0)
        rlit = torch.where(active, rlit, 0)
        width = int((held + rlit).max())
        l = torch.arange(width, dtype=torch.int64, device=dev)[None, :]
        q = torch.where(l < held[:, None],
                        torch.gather(carry, 1, l.clamp(max=NBS - 1)
                                     .expand(P, width)),
                        qtail[:, None] + l - held[:, None])
        live = active[:, None] & (l < (held + rlit)[:, None])
        # the last command with lst <= l among the round's k
        lst_k = torch.where(valid, lst, torch.iinfo(torch.int64).max)
        ci = (torch.searchsorted(lst_k.contiguous(),
                                 l.expand(P, width).contiguous(),
                                 right=True) - 1).clamp(0, NBS - 1)
        out_pos = torch.gather(wst, 1, ci) + l - torch.gather(lst, 1, ci)
        placed = live & (l < litcount[:, None])
        pos[rows, torch.where(placed, q, cap).clamp(0, cap)] = \
            torch.where(placed, out_pos, -1)
        to_carry = live & ~placed
        slot = torch.where(to_carry, l - litcount[:, None], NBS)
        new_carry = torch.full((P, NBS + 1), cap, dtype=torch.int64,
                               device=dev)
        new_carry.scatter_(1, slot.clamp(0, NBS), torch.where(to_carry, q,
                                                              cap))
        carry = torch.where(active[:, None], new_carry[:, :NBS], carry)
        prev_tail = torch.where(active, rlit + held - litcount, prev_tail)
        qtail = qtail + rlit
        pos_tot = pos_tot + torch.where(active, cov.sum(dim=1), 0)
        if not bool((active & (k == NBS)).any()):
            break
    return pos[:, :cap]


def test_literal_positions_place_every_insert(symbols):
    """Scattering the literal queue to the placement twin's positions
    gives the plain LZ77 result at every insert byte, each written
    once."""
    npf, ndir, (ncmds, litbuf, ins, cpy, dcode, dextra) = symbols
    dist = TD._resolve_distances(dcode, dextra, ncmds, npf, ndir)
    want = TD._phase_b(ncmds, litbuf, ins, cpy, dist, PS)
    pos = literal_positions(ncmds, ins, cpy, PS)
    valid = torch.arange(ins.shape[1])[None, :] < ncmds[:, None]
    ins_v = torch.where(valid, ins, 0)
    cov = ins_v + torch.where(valid, cpy, 0)
    starts = torch.cumsum(cov, dim=1) - cov
    for p in range(ins.shape[0]):
        nlit = int(ins_v[p].sum())
        got = pos[p, :nlit]
        inserts = torch.cat([torch.arange(s, s + n) for s, n in
                             zip(starts[p].tolist(), ins_v[p].tolist())
                             if n])
        assert torch.equal(got, inserts)       # in order, each once
        assert (pos[p, nlit:] == -1).all()
        assert torch.equal(want[p, got], litbuf[p, :nlit])
