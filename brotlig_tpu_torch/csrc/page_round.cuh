// One command round of a page, shared by the fused decode kernel
// (decode.cu, K2) and the phase-A kernel (phase_a.cu, K4): the counterpart
// of the round body both TPU kernels run (brotlig_tpu/ops/pallas_decode.py,
// make_phase_a_kernel and make_fused_kernel: decode_cmd_fields,
// resolve_ring, prefix32_excl, the literal chunks).
//
// One warp decodes a page; lane s owns sub-stream s, as in the reference
// GPU decoder (BrotliGCompute.hlsl:1349-1432), and reads it through a bit
// reservoir in registers (lane_ops.cuh, BitReader). A round:
//   1. every lane decodes one command (insert/copy code, extra bits,
//      distance code and extra bits) at its own cursor, speculatively;
//   2. the first lane holding the sentinel (k, a ballot) ends the page:
//      lanes past k roll their reader back, lane k consumes the sentinel
//      code;
//   3. the distance ring (initially 4, 11, 15, 16) over the round's k
//      commands, as a 5-step scan of lane transforms (ring_scan);
//   4. rlit = k * ceil(max(literals - prev_tail, 0) / k) literals are
//      decoded, literal j by lane j % 32, and handed to the kernel.
// The kernels differ in what they do with a round: K2 places its literals
// and executes its copies in the page, K4 stores the commands for the
// sweep kernel (sweep.cu).
//
// Symbols decode through a first-level table in shared memory (one load
// for a code of up to kLutBits bits), falling back to the range search.
// The ring scan composes transforms with selects and one byte permute:
// written with indexed picks, the compiler turned each step into nested
// divergent branches, and the scan cost more than the rest of the round.
#pragma once

#include <climits>

#include "lane_ops.cuh"

namespace blg {

constexpr int kDictTotal = kAlphaIcp + kAlphaDst + kAlphaLit;
constexpr int kMetaPerTable = 3 * kLenSlots;       // limit, first, offset
// per-page status bits, as ops/decode.py's ST_*
constexpr int kStNoSentinel = 1;
constexpr int kStOverrun = 2;
constexpr int kStDistance = 4;

// What a block keeps in shared memory for its page's three prefix codes.
struct CodeSmem {
  int meta[3 * kMetaPerTable];
  int dict[kDictTotal];
  uint16_t lut[3][kLutSize];
};

struct PageCodes {
  Huff icp, dst, lit;
};

// The three prefix codes of page p: the range-search arrays copied into
// shared memory, then the first-level tables built from them by the
// block's nthreads threads. Ends with __syncthreads().
__device__ __forceinline__ PageCodes load_page_codes(
    const int32_t* __restrict__ meta, const int32_t* __restrict__ dicts,
    const int32_t* __restrict__ trivs, size_t pp, int tid, int nthreads,
    CodeSmem& sm) {
  for (int i = tid; i < 3 * kMetaPerTable; i += nthreads)
    sm.meta[i] = meta[pp * 3 * kMetaPerTable + i];
  for (int i = tid; i < kDictTotal; i += nthreads)
    sm.dict[i] = dicts[pp * kDictTotal + i];
  __syncthreads();
  const int* m0 = sm.meta;
  const int* m1 = sm.meta + kMetaPerTable;
  const int* m2 = sm.meta + 2 * kMetaPerTable;
  const PageCodes c{
      Huff{m0, m0 + kLenSlots, m0 + 2 * kLenSlots, sm.dict, kAlphaIcp,
           trivs[pp * 3 + 0], sm.lut[0]},
      Huff{m1, m1 + kLenSlots, m1 + 2 * kLenSlots, sm.dict + kAlphaIcp,
           kAlphaDst, trivs[pp * 3 + 1], sm.lut[1]},
      Huff{m2, m2 + kLenSlots, m2 + 2 * kLenSlots,
           sm.dict + kAlphaIcp + kAlphaDst, kAlphaLit, trivs[pp * 3 + 2],
           sm.lut[2]}};
  build_lut(c.icp, sm.lut[0], tid, nthreads);
  build_lut(c.dst, sm.lut[1], tid, nthreads);
  build_lut(c.lit, sm.lut[2], tid, nthreads);
  __syncthreads();
  return c;
}

struct Ring {
  int r[4] = {4, 11, 15, 16};
};

// A ring transform: slot j of the ring after it is val[j] when its source
// is kConst, else slot src_j of the ring before it plus val[j]. The four
// sources are packed a byte each (byte j = src_j), so composing sources
// is one byte permute. Values add modulo 2^32, as the plain version's int
// additions wrap.
constexpr unsigned kConst = 4;
constexpr unsigned kIdentSrcs = 0x03020100u;

struct RingMap {
  unsigned srcs;
  unsigned val[4];
};

// slot j (0..3) of four registers, by selects: no branch, no local array
__device__ __forceinline__ unsigned sel4(unsigned j, const unsigned* a) {
  const unsigned lo = (j & 1u) ? a[1] : a[0];
  const unsigned hi = (j & 1u) ? a[3] : a[2];
  return (j & 2u) ? hi : lo;
}

__device__ __forceinline__ unsigned src_of(unsigned srcs, int j) {
  return (srcs >> (8 * j)) & 0xffu;
}

// t applied after a, as one transform
__device__ __forceinline__ RingMap compose(const RingMap& a,
                                           const RingMap& t) {
  // byte_perm selector: nibble j picks byte src_j of a.srcs, or byte 4
  // (the second operand, all kConst) for a constant slot
  const unsigned sel = (t.srcs & 0x7u) | ((t.srcs >> 4) & 0x70u) |
                       ((t.srcs >> 8) & 0x700u) | ((t.srcs >> 12) & 0x7000u);
  RingMap o;
  o.srcs = __byte_perm(a.srcs, kConst * 0x01010101u, sel);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const unsigned s = src_of(t.srcs, j);
    o.val[j] = t.val[j] + (s == kConst ? 0u : sel4(s, a.val));
  }
  return o;
}

__device__ __forceinline__ RingMap shfl_up_map(const RingMap& m, int sh,
                                               int lane) {
  RingMap a;
  a.srcs = __shfl_up_sync(kFull, m.srcs, sh);
#pragma unroll
  for (int j = 0; j < 4; ++j) a.val[j] = __shfl_up_sync(kFull, m.val[j], sh);
  if (lane < sh) a = RingMap{kIdentSrcs, {0u, 0u, 0u, 0u}};
  return a;
}

// slot j of the ring that transform m makes of ring
__device__ __forceinline__ unsigned map_slot(const RingMap& m, unsigned j,
                                             const unsigned* ring) {
  const unsigned s = (m.srcs >> (8 * j)) & 0xffu;
  return sel4(j, m.val) + (s == kConst ? 0u : sel4(s, ring));
}

// Step 3: the distance of this lane's command and the ring after the
// round, from each lane's distance code (-1: no command or no distance)
// and its absolute value (codes >= 16). The counterpart of
// _LaneOps.resolve_ring (pallas_decode.py:216-298), with the semantics of
// ops/decode.py::_resolve_distances: codes 0..3 read ring slot 0..3, codes
// 4..15 add -3..+3 to slot 0 (codes < 10) or 1, codes >= 16 are absolute,
// and every code but 0 pushes its distance. A lane's transform maps the
// ring before its command to the ring after; transforms of this class
// compose into one of the same class, so 5 shuffle steps give every
// lane's inclusive composite (Hillis-Steele), one more shift the
// exclusive one, and lane 31's the round's.
__device__ __forceinline__ int ring_scan(int code, int absv, int lane,
                                         Ring& ring) {
  const bool is_rel = code >= 0 && code < 16;
  const int depth = code < 4 ? max(code, 0) : (code < 10 ? 0 : 1);
  const int mag = (max(code - 4, 0) % 6) / 2 + 1;
  const int delta = code >= 4 && is_rel ? ((code & 1) ? mag : -mag) : 0;
  const bool push = code > 0;

  // a push shifts the ring down one slot and puts its distance in slot 0
  RingMap t{push ? 0x02010000u | (is_rel ? static_cast<unsigned>(depth)
                                         : kConst)
                 : kIdentSrcs,
            {push ? static_cast<unsigned>(is_rel ? delta : absv) : 0u, 0u,
             0u, 0u}};
#pragma unroll
  for (int sh = 1; sh < kStreams; sh <<= 1)
    t = compose(shfl_up_map(t, sh, lane), t);

  unsigned rin[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) rin[j] = static_cast<unsigned>(ring.r[j]);
  const RingMap before = shfl_up_map(t, 1, lane);
  const unsigned read = map_slot(before, static_cast<unsigned>(depth), rin);
  const int dist = code >= 16
                       ? absv
                       : (is_rel ? static_cast<int>(
                                       read + static_cast<unsigned>(delta))
                                 : 0);
  RingMap last;
  last.srcs = __shfl_sync(kFull, t.srcs, kStreams - 1);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    last.val[j] = __shfl_sync(kFull, t.val[j], kStreams - 1);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    ring.r[j] = static_cast<int>(map_slot(last, j, rin));
  return dist;
}

// What a lane keeps for the whole page: its sub-stream, the length-code
// tables a lane each, and the page's distance parameters.
struct RoundCtx {
  LaneStream ls;
  LenTables lt;
  int lane;
  int npf;
  int ndir;
};

// What steps 1-3 give each lane.
struct RoundCmds {
  int k;           // commands in this round: lanes < k hold one
  int insert_len;  // this lane's command (0 on lanes >= k)
  int copy_len;
  int dist;        // absolute distance after the ring (0: none)
  int excl_cov;    // output bytes of the round's commands before this one
  int excl_ins;    // literals of the round's commands before this one
  int covtot;      // output bytes of the whole round
  int litcount;    // literals of the whole round
};

// Steps 1-3 of a round; advances this lane's reader br and the ring.
__device__ __forceinline__ RoundCmds decode_round_cmds(
    const PageCodes& codes, const RoundCtx& cx, BitReader& br, Ring& ring) {
  const LaneStream& ls = cx.ls;
  const int npf = cx.npf, ndir = cx.ndir;
  // ---- 1. one command per lane, on a copy of the reader ----
  BitReader t = br;
  int sym, ln;
  peek_sym(codes.icp, t, sym, ln);
  t.skip(ls, ln);
  const bool is_norm = sym < kSentinel;
  const bool is_sent = sym == kSentinel;
  int ic = 0, cc = 0;
  if (is_norm) split_command(sym, ic, cc);
  const int inscode = min(max(sym > kSentinel ? sym - kSentinel : ic, 0), 23);
  const int copycode = min(max(cc, 0), 23);
  // every lane shuffles; the sentinel lane and non-command lanes drop it
  const int ins_bits_l = __shfl_sync(kFull, cx.lt.ins_extra, inscode);
  const int ins_base_l = __shfl_sync(kFull, cx.lt.ins_base, inscode);
  const int cpy_bits_l = __shfl_sync(kFull, cx.lt.cpy_extra, copycode);
  const int cpy_base_l = __shfl_sync(kFull, cx.lt.cpy_base, copycode);
  const int ins_bits = is_sent ? 0 : ins_bits_l;
  const int ins_base = is_sent ? 0 : ins_base_l;
  const int cpy_bits = is_norm ? cpy_bits_l : 0;
  const int cpy_base = is_norm ? cpy_base_l : 0;
  int insert_len = ins_base + static_cast<int>(t.take(ls, ins_bits));
  int copy_len = cpy_base + static_cast<int>(t.take(ls, cpy_bits));
  const bool need_dist = is_norm && sym >= 128;
  int dsym = 0, dnb = 0, dextra = 0;
  if (need_dist) {
    int dln;
    peek_sym(codes.dst, t, dsym, dln);
    t.skip(ls, dln);
    dnb = dsym >= 16 + ndir ? 1 + (max(dsym - ndir - 16, 0) >> (npf + 1))
                            : 0;
    dnb = min(max(dnb, 0), 30);
    dextra = static_cast<int>(t.take(ls, dnb));
  }

  // ---- 2. sentinel lane and rollback ----
  const int lane = cx.lane;
  const unsigned sent = __ballot_sync(kFull, is_sent);
  const int k = sent ? __ffs(sent) - 1 : kStreams;
  const bool valid = lane < k;
  if (valid) {
    br = t;
  } else {
    if (lane == k) br.skip(ls, ln);
    insert_len = 0;
    copy_len = 0;
  }
  const int dcode = valid ? (need_dist ? dsym : (is_norm ? 0 : -1)) : -1;

  // ---- 3. distances: absolute codes here, the ring by a scan ----
  long long absv = 0;
  if (dcode >= 16 + ndir) {
    const int s = dcode - ndir - 16;
    // > 30 extra bits only in a corrupt stream; keep the shift defined
    const int nbits = min(1 + (s >> (npf + 1)), 40);
    const long long offs =
        (static_cast<long long>(2 + ((s >> npf) & 1)) << nbits) - 4;
    absv = ((offs + dextra) << npf) + (s & ((1 << npf) - 1)) + ndir + 1;
  } else if (dcode >= 16) {
    absv = dcode - 15;
  }
  const int dist = ring_scan(
      dcode, static_cast<int>(min(absv, static_cast<long long>(INT_MAX))),
      lane, ring);

  const int cov = insert_len + copy_len;
  const int incl_cov = warp_incl_sum(cov, lane);
  const int incl_ins = warp_incl_sum(insert_len, lane);
  return RoundCmds{k,
                   insert_len,
                   copy_len,
                   dist,
                   incl_cov - cov,
                   incl_ins - insert_len,
                   __shfl_sync(kFull, incl_cov, kStreams - 1),
                   __shfl_sync(kFull, incl_ins, kStreams - 1)};
}

// Step 4's count: rlit = k * ceil(max(litcount - prev_tail, 0) / k); the
// rounding surplus carries into the next round as prev_tail.
__device__ __forceinline__ int round_literal_count(int k, int litcount,
                                                   int& prev_tail) {
  const int aclit = max(litcount - prev_tail, 0);
  const int rlit = k > 0 ? k * ((aclit + k - 1) / k) : 0;
  prev_tail = rlit + prev_tail - litcount;
  return rlit;
}

// Step 4, one literal at this lane's cursor: the round's literal j is
// decoded by lane j % 32 from its own sub-stream.
__device__ __forceinline__ int decode_literal(const Huff& lit,
                                              const RoundCtx& cx,
                                              BitReader& br) {
  int s, n;
  peek_sym(lit, br, s, n);
  br.skip(cx.ls, n);
  return s;
}

}  // namespace blg
