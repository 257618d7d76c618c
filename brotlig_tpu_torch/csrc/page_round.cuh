// One command round of a page, shared by the fused decode kernel
// (decode.cu, K2) and the phase-A kernel (phase_a.cu, K4): the counterpart
// of the round body both TPU kernels run (brotlig_tpu/ops/pallas_decode.py,
// make_phase_a_kernel and make_fused_kernel: decode_cmd_fields,
// resolve_ring, prefix32_excl, the literal chunks).
//
// One warp per page; lane s owns sub-stream s, as in the reference GPU
// decoder (BrotliGCompute.hlsl:1349-1432). A round:
//   1. every lane decodes one command (insert/copy code, extra bits,
//      distance code and extra bits) at its own cursor;
//   2. the first lane holding the sentinel (k, a ballot) ends the page:
//      lanes past k keep their cursor, lane k consumes the sentinel code;
//   3. the distance ring (initially 4, 11, 15, 16) is walked over the
//      round's k commands in order, broadcasting each by a shuffle;
//   4. rlit = k * ceil(max(literals - prev_tail, 0) / k) literals are
//      decoded, literal j by lane j % 32, into the page's literal queue.
// The kernels differ only in what follows: K2 executes the round's copies
// at once, K4 stores the commands for the sweep kernel (sweep.cu).
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

// The three prefix codes of page p, with their range-search arrays copied
// into the block's shared memory (s_meta: 3 * kMetaPerTable ints, s_dict:
// kDictTotal ints). Ends with __syncwarp(): one warp per block.
struct PageCodes {
  Huff icp, dst, lit;
};

__device__ __forceinline__ PageCodes load_page_codes(
    const int32_t* __restrict__ meta, const int32_t* __restrict__ dicts,
    const int32_t* __restrict__ trivs, size_t pp, int lane, int* s_meta,
    int* s_dict) {
  for (int i = lane; i < 3 * kMetaPerTable; i += kStreams)
    s_meta[i] = meta[pp * 3 * kMetaPerTable + i];
  for (int i = lane; i < kDictTotal; i += kStreams)
    s_dict[i] = dicts[pp * kDictTotal + i];
  __syncwarp();
  const int* m1 = s_meta + kMetaPerTable;
  const int* m2 = s_meta + 2 * kMetaPerTable;
  return PageCodes{
      Huff{s_meta, s_meta + kLenSlots, s_meta + 2 * kLenSlots, s_dict,
           kAlphaIcp, trivs[pp * 3 + 0]},
      Huff{m1, m1 + kLenSlots, m1 + 2 * kLenSlots, s_dict + kAlphaIcp,
           kAlphaDst, trivs[pp * 3 + 1]},
      Huff{m2, m2 + kLenSlots, m2 + 2 * kLenSlots,
           s_dict + kAlphaIcp + kAlphaDst, kAlphaLit, trivs[pp * 3 + 2]}};
}

struct Ring {
  int r0 = 4, r1 = 11, r2 = 15, r3 = 16;
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

// Steps 1-3 of a round; advances this lane's cursor bp and the ring.
__device__ __forceinline__ RoundCmds decode_round_cmds(
    const PageCodes& codes, const Streams& st, int lane, int npf, int ndir,
    int& bp, Ring& ring) {
  // ---- 1. one command per lane ----
  int sym, ln;
  decode_sym(codes.icp, st.peek(lane, bp, 15), sym, ln);
  const bool is_norm = sym < kSentinel;
  const bool is_sent = sym == kSentinel;
  int ic = 0, cc = 0;
  if (is_norm) split_command(sym, ic, cc);
  const int inscode = min(max(sym > kSentinel ? sym - kSentinel : ic, 0), 23);
  const int copycode = min(max(cc, 0), 23);
  const int ins_bits = is_sent ? 0 : kInsertExtra[inscode];
  const int ins_base = is_sent ? 0 : kInsertBase[inscode];
  const int cpy_bits = is_norm ? kCopyExtra[copycode] : 0;
  const int cpy_base = is_norm ? kCopyBase[copycode] : 0;
  int insert_len =
      ins_base + static_cast<int>(st.peek(lane, bp + ln, ins_bits));
  int copy_len = cpy_base + static_cast<int>(
                                st.peek(lane, bp + ln + ins_bits, cpy_bits));
  const int d_off = ln + ins_bits + cpy_bits;
  const bool need_dist = is_norm && sym >= 128;
  int dsym, dln;
  decode_sym(codes.dst, st.peek(lane, bp + d_off, 15), dsym, dln);
  const int dln_eff = need_dist ? dln : 0;
  int dnb = need_dist && dsym >= 16 + ndir
                ? 1 + (max(dsym - ndir - 16, 0) >> (npf + 1))
                : 0;
  dnb = min(max(dnb, 0), 30);
  const int dextra =
      static_cast<int>(st.peek(lane, bp + d_off + dln_eff, dnb));

  // ---- 2. sentinel lane and rollback ----
  const unsigned sent = __ballot_sync(kFull, is_sent);
  const int k = sent ? __ffs(sent) - 1 : kStreams;
  const bool valid = lane < k;
  bp = valid ? bp + d_off + dln_eff + dnb : (lane == k ? bp + ln : bp);
  if (!valid) {
    insert_len = 0;
    copy_len = 0;
  }
  const int dcode = valid ? (need_dist ? dsym : (is_norm ? 0 : -1)) : -1;

  // ---- 3. distances: absolute codes here, the ring in command order ----
  long long absv = 0;
  if (dcode >= 16 + ndir) {
    const int s = dcode - ndir - 16;
    // > 30 extra bits only in a corrupt stream; keep the shift defined
    const int nbits = min(1 + (s >> (npf + 1)), 40);
    const long long offs =
        (static_cast<long long>(2 + ((s >> npf) & 1)) << nbits) - 4;
    absv = ((offs + (valid ? dextra : 0)) << npf) + (s & ((1 << npf) - 1)) +
           ndir + 1;
  } else if (dcode >= 16) {
    absv = dcode - 15;
  }
  const int absv_i =
      static_cast<int>(min(absv, static_cast<long long>(INT_MAX)));
  int my_dist = 0;
  for (int i = 0; i < k; ++i) {
    const int c = __shfl_sync(kFull, dcode, i);
    const int av = __shfl_sync(kFull, absv_i, i);
    int d;
    if (c < 0) {
      d = 0;
    } else if (c < 4) {
      d = c == 0 ? ring.r0 : (c == 1 ? ring.r1 : (c == 2 ? ring.r2 : ring.r3));
    } else if (c < 16) {
      const int base = c < 10 ? ring.r0 : ring.r1;
      const int mag = ((c - 4) % 6) / 2 + 1;
      d = (c & 1) ? base + mag : base - mag;
    } else {
      d = av;
    }
    if (lane == i) my_dist = d;
    if (c > 0) {
      ring.r3 = ring.r2;
      ring.r2 = ring.r1;
      ring.r1 = ring.r0;
      ring.r0 = d;
    }
  }

  const int cov = insert_len + copy_len;
  const int incl_cov = warp_incl_sum(cov, lane);
  const int incl_ins = warp_incl_sum(insert_len, lane);
  return RoundCmds{k,
                   insert_len,
                   copy_len,
                   my_dist,
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

// Step 4: literals 0..rlit-1 of the round into q, literal j by lane j % 32
// from its own sub-stream.
__device__ __forceinline__ void decode_round_literals(const Huff& lit,
                                                      const Streams& st,
                                                      int lane, int rlit,
                                                      int& bp, uint8_t* q) {
  for (int j = lane; j < rlit; j += kStreams) {
    int s, n;
    decode_sym(lit, st.peek(lane, bp, 15), s, n);
    bp += n;
    q[j] = static_cast<uint8_t>(s);
  }
}

}  // namespace blg
