"""The distance ring of one command round as a 5-step scan of lane
transforms: the torch twin of ring_scan in csrc/page_round.cuh, which the
fused decode kernel (K2) and the phase-A kernel (K4) run every round.

Counterpart of brotlig_tpu/ops/pallas_decode.py::_LaneOps.resolve_ring.
Each lane's command maps the ring before it (four distances, most recent
first) to the ring after it. A map is four slots of (src, val):
src CONST (4) means the constant val, src j means ring_in[j] + val (the
kernel packs the four sources a byte each and composes them with one
byte permute). The class is closed under composition, so 5 Hillis-Steele
steps over the 32 lanes give every lane's inclusive composite, one more
shift the exclusive one (the ring its command reads), and lane 31's the
ring after the round.

The semantics are those of ops/decode.py::_resolve_distances, which the
tests pin to the JAX XLA route: codes 0..3 read ring slot 0..3; codes
4..15 add -3..+3 to slot 0 (codes < 10) or slot 1; codes >= 16 are
absolute; every code but 0 pushes its distance; -1 is no distance.
Values add modulo 2^32 as in the kernel (int64 here, wrapped at the end).
"""
from __future__ import annotations

import torch

I64 = torch.int64
NBS = 32
INT_MAX = 2 ** 31 - 1
INITIAL_RING = (4, 11, 15, 16)
CONST = 4


def _wrap32(x):
    return ((x + 2 ** 31) & 0xFFFFFFFF) - 2 ** 31


def absolute_values(dcode, dextra, npostfix, ndirect):
    """[P, 32] value of each absolute code (>= 16; 0 elsewhere), clamped
    at INT_MAX as the kernel clamps it."""
    npf = npostfix.to(I64)[:, None]
    ndir = ndirect.to(I64)[:, None]
    code = dcode.to(I64)
    s = (code - ndir - 16).clamp(min=0)
    nbits = (1 + (s >> (npf + 1))).clamp(max=40)
    offs = ((2 + ((s >> npf) & 1)) << nbits) - 4
    longv = ((offs + dextra.to(I64)) << npf) + (s & ((1 << npf) - 1)) \
        + ndir + 1
    absv = torch.where(code >= 16 + ndir, longv,
                       torch.where(code >= 16, code - 15, 0))
    return absv.clamp(max=INT_MAX)


def _shift_up(src, val, sh: int):
    """Lane i gets lane i - sh's transform; lanes < sh the identity."""
    P = src.shape[0]
    ident = torch.arange(4, dtype=I64, device=src.device)
    head_s = ident.expand(P, sh, 4)
    head_v = torch.zeros((P, sh, 4), dtype=I64, device=src.device)
    return (torch.cat([head_s, src[:, :NBS - sh]], dim=1),
            torch.cat([head_v, val[:, :NBS - sh]], dim=1))


def _apply(src, val, ring):
    """ring_out[.., j] for transform slots (src, val) on ring [P, 4]."""
    base = torch.gather(ring, 1, src.clamp(0, 3).reshape(src.shape[0], -1))
    return torch.where(src == CONST, val, base.reshape(src.shape) + val)


def ring_scan(dcode, dextra, npostfix, ndirect, k, ring_in):
    """One round per page. dcode, dextra [P, 32] (lane i: command i of the
    round); k [P] commands in the round (lanes >= k hold none); ring_in
    [P, 4] the ring before the round. Returns (dist [P, 32] int64, ring
    out [P, 4] int64)."""
    dev = dcode.device
    lane = torch.arange(NBS, device=dev)[None, :]
    code = torch.where(lane < k.to(I64)[:, None], dcode.to(I64), -1)
    absv = absolute_values(code, dextra, npostfix, ndirect)
    ring = ring_in.to(I64)

    is_rel = (code >= 0) & (code < 16)
    depth = torch.where(code < 4, code.clamp(min=0),
                        torch.where(code < 10, 0, 1))
    mag = ((code - 4).clamp(min=0) % 6) // 2 + 1
    delta = torch.where((code >= 4) & is_rel,
                        torch.where((code & 1) == 1, mag, -mag), 0)
    push = code > 0

    zero = torch.zeros_like(code)
    src = torch.stack([torch.where(push, torch.where(is_rel, depth, CONST),
                                   0),
                       torch.where(push, 0, 1), torch.where(push, 1, 2),
                       torch.where(push, 2, 3)], dim=2)
    val = torch.stack([torch.where(push, torch.where(is_rel, delta, absv), 0),
                       zero, zero, zero], dim=2)
    for sh in (1, 2, 4, 8, 16):
        a_src, a_val = _shift_up(src, val, sh)
        pick = src.clamp(0, 3)
        p_src = torch.gather(a_src, 2, pick)
        p_val = torch.gather(a_val, 2, pick)
        const = src == CONST
        src, val = (torch.where(const, src, p_src),
                    torch.where(const, val, p_val + val))

    e_src, e_val = _shift_up(src, val, 1)
    d = depth[:, :, None]
    ring_d = _apply(torch.gather(e_src, 2, d), torch.gather(e_val, 2, d),
                    ring)[:, :, 0]
    dist = torch.where(code >= 16, absv,
                       torch.where(is_rel, ring_d + delta, 0))
    ring_out = _apply(src[:, NBS - 1], val[:, NBS - 1], ring)
    return _wrap32(dist), _wrap32(ring_out)


def resolve_rounds(dcode, dextra, ncmds, npostfix, ndirect):
    """ring_scan round by round over a page's commands [P, N] (N a
    multiple of 32), carrying the ring as the kernels do. Returns dist
    [P, N] int64 (0 past ncmds)."""
    P, N = dcode.shape
    ring = torch.tensor(INITIAL_RING, dtype=I64,
                        device=dcode.device).expand(P, 4)
    ncmds = ncmds.to(I64)
    out = []
    for r in range(N // NBS):
        cols = slice(r * NBS, (r + 1) * NBS)
        k = (ncmds - r * NBS).clamp(0, NBS)
        dist, ring_next = ring_scan(dcode[:, cols], dextra[:, cols],
                                    npostfix, ndirect, k, ring)
        ring = torch.where((k > 0)[:, None], ring_next, ring)
        out.append(dist)
    return torch.cat(out, dim=1)
