// The device serializer: whole compressed Brotli-G pages from commands.
//
// Replaces brotlig_tpu/ops/encode_pack.py:985 (_pack_jit), which has no
// Pallas kernel: on the TPU, XLA compiles pack_pages_device (:656) into one
// program a command bucket. Plain version: ops/encode_pack.py::
// pack_pages_plain (the same serializer as eager torch ops, about 6,700
// launches a command bucket); wrapper: ops/pack_kernel.py::pack_cuda.
//
// One thread block a page computes, byte for byte, what the plain version
// computes: the wire fields of every command (exact distance-ring codes,
// the (npostfix, ndirect) grid search, the ring-mode choice), the three
// histograms and their prefix codes (trivial / simple / complex storage,
// Kraft-safe lengths with the refine passes, canonical codes), the
// run-coded tables with their code-length codes, the 32-lane round
// schedule with its literal queue, the bit packing of the 32 sub-streams,
// the self-describing size table (the header's fixed point) and the
// assembly of header words and DWORD-padded streams. The page's output
// does not depend on the command bound it runs under (rounds past a
// page's final round emit nothing), so one launch covers a whole batch,
// where the plain version runs once a command bucket.
// Its phases 0 to 5 (the statistics and the code lengths) are page_stats
// in page_tables.cuh, whose helpers the q11 cost model's kernels
// (cost_model.cu) also use.
//
// What bounds it on this card: a page is a chain of block-wide steps that
// one block runs alone; the bytes it moves (a page, its commands, the
// output) take microseconds. A batch of P pages occupies P of the 132 SMs,
// and a launch lasts as long as its slowest page. The design shortens that
// chain by giving every step to all 16 warps and keeping its data in
// shared memory (the per-page record's clock stamps, which chip_smoke.py
// prints, time each phase):
//   * per-command work reads coalesced: the scans (command starts, ring
//     pushes) run over tiles of 4 commands a thread with a block scan a
//     tile, the other passes take command tid + 512 k;
//   * histograms count through warp_count: equal values of a warp's lanes
//     add once (atomics of many lanes on one shared address serialise,
//     and a page's hot bins made them the longest step); the literal
//     histogram is counted from the literal queue, a sub-histogram a
//     warp, merged once;
//   * the literals are found through a bitmap of the page's positions in
//     shared memory, each command marking its insert region: a thread
//     that walked the commands over its own bytes would wait on dependent
//     loads in divergent loops;
//   * the grid search's distances are sorted in shared memory (bitonic;
//     the steps whose partners lie within 64 keys run in registers inside
//     a warp), and warp g prices grid point g in one pass over the sorted
//     keys, four a lane, with the run terms of lengths up to 512 in a
//     table;
//   * the bit packing follows the plain version's own scheme: a slot's
//     bit offset is a prefix sum of the widths before it in its stream.
//     The streams' slots are cut into items, a round's five command fields
//     or a row of 32 literal-queue positions (literal j goes to sub-stream
//     j & 31), and each warp takes a contiguous share of the items, lane s
//     stream s. Pass A sums the widths of each share; a scan over the
//     shares gives every share's offset and the 32 stream totals; the
//     header and size table, which need only those totals, come next; pass
//     B ORs each slot into a page image in shared memory at its stream's
//     byte offset, and one coalesced copy writes the image out;
//   * costs are fixed point as in the plain version: each run's float64
//     term c * (log2 n - log2 c) + 6 is computed with the same libdevice
//     log2 and with rounded (non-fused) double operations, then rounded
//     half to even, so the sums equal the plain version's on the card.
// Two size cases keep device memory, inside the same kernel: a page with
// more commands than the shared region holds grid-search keys for sorts
// its keys in its scratch; a page whose streams pass their Wst words (or whose padding
// reaches past the last stream's words) is written into per-stream words
// in its scratch and assembled byte by byte, as the plain version does,
// since its bytes past a stream's Wst words are the next stream's first
// words. The literal queue lives in shared memory when it fits beside the
// image (pages up to 64 KiB), else in the scratch.
//
// Inputs (int32 unless noted): pages uint8 [P, S] (S == page_size),
// in_sizes [P], ins/cpy/dist [P, N] (zero past ncmds), ncmds [P], isdelta
// [P] or null. Outputs: out uint8 [P, page_size], out_sizes [P] (the
// compressed size, or page_size + 1 where a stream overflows its Wst
// words). Scratch: int32 [P, blg_pack_scratch_ints(N, S, page_size)].
// The contract is the plain version's for commands whose values fit int32
// and whose lengths cover at most the page (what the matchers produce):
// field values fit their bit widths, so the bit append's OR equals the
// plain version's sums of contributions.
#include "page_tables.cuh"

namespace blg_pack {
namespace {

constexpr int kInfoBranch = 11;       // the record's size cases (kBranch*)
constexpr int kInfoClocks = 52;       // its clock cycles a phase
constexpr int kBranchWords = 1;       // streams in the scratch's words
constexpr int kBranchKeys = 2;        // the sort in the scratch
constexpr int kBranchLq = 4;          // the literal queue in shared memory

__constant__ int kClOrder[18] = {1, 2,  3,  4,  0,  5,  17, 6,  16,
                                 7, 8,  9,  10, 11, 12, 13, 14, 15};

// Canonical codes (symbol order within a length), bit-reversed; one warp.
__device__ void canonical_codes(const int* lens, int A, unsigned* code,
                                int* next) {
  const int lane = lane_id();
  if (lane < 16) next[lane] = 0;
  __syncwarp();
  for (int b = 0; b < A; b += 32)
    warp_count(next, b + lane < A ? lens[b + lane] : -1);
  __syncwarp();
  if (lane == 0) {
    int first = 0, prev_count = 0;
    for (int L = 0; L < 16; ++L) {
      const int c = next[L];
      if (L > 0) first = (first + prev_count) << 1;
      next[L] = first;
      prev_count = L == 0 ? 0 : c;
    }
  }
  __syncwarp();
  const unsigned below = (1u << lane) - 1u;
  for (int base = 0; base < A; base += 32) {
    const int i = base + lane;
    const int L = i < A ? lens[i] : -1;
    const unsigned m = __match_any_sync(kFull, L);
    const int at = i < A ? next[L] : 0;
    __syncwarp();
    if (i < A) {
      const unsigned c = static_cast<unsigned>(at + __popc(m & below));
      code[i] = L > 0 ? __brev(c) >> (32 - L) : 0u;
      if ((m & below) == 0) next[L] = at + __popc(m);
    }
    __syncwarp();
  }
}

// _rle_items: the run-coded items of one table (one warp): item byte =
// code | extra << 5 (code 16: repeat the previous nonzero, 2 extra bits;
// 17: repeat zero, 3 extra bits). Returns the item count.
__device__ int rle_items(const int* lens, int A, short* runs,
                         unsigned char* items) {
  const int lane = lane_id();
  const unsigned below = (1u << lane) - 1u;
  int nr = 0;
  for (int b = 0; b < A; b += 32) {
    const int pos = b + lane;
    const bool st = pos < A && (pos <= 1 || lens[pos] != lens[pos - 1]);
    const unsigned m = __ballot_sync(kFull, st);
    if (st) runs[nr + __popc(m & below)] = static_cast<short>(pos);
    nr += __popc(m);
  }
  __syncwarp();
  int off = 0;
  for (int b = 0; b < nr; b += 32) {
    const int k = b + lane;
    int ni = 0, lead = 0, kk = 0, t = 0, rem = 0, v = 0;
    if (k < nr) {
      const int rs = runs[k];
      const int re = k + 1 < nr ? runs[k + 1] : A;
      const int reps = re - rs;
      v = lens[rs];
      const int prev = k == 0 ? 8 : lens[runs[k - 1]];
      int ltr;
      if (k == 0) {
        lead = 1;
        kk = 0;
        ltr = 0;
        t = 0;
        rem = 0;
      } else if (v == 0) {
        lead = reps == 11;
        const int rz = reps - lead;
        t = rz / 10;
        rem = rz % 10;
        kk = t + (rem >= 3);
        ltr = rem >= 3 ? 0 : rem;
      } else {
        const int lead1 = prev != v;
        const int r1 = reps - lead1;
        const int lead2 = r1 == 7;
        const int rn = r1 - lead2;
        lead = lead1 + lead2;
        t = rn / 6;
        rem = rn % 6;
        kk = t + (rem >= 3);
        ltr = rem >= 3 ? 0 : rem;
      }
      ni = lead + kk + ltr;
    }
    const int inc = warp_incl_scan(ni);
    const int at = off + inc - ni;
    for (int q = 0; q < ni; ++q) {
      int code = v, extra = 0;
      if (q >= lead && q < lead + kk) {
        code = v == 0 ? 17 : 16;
        extra = q - lead < t ? (v == 0 ? 7 : 3) : rem - 3;
      }
      items[at + q] = static_cast<unsigned char>(code | (extra << 5));
    }
    off += __shfl_sync(kFull, inc, 31);
  }
  __syncwarp();
  return off;
}

// Pass A's sink: a stream's bits.
struct BitCount {
  long long bits = 0;
  __device__ void put(int nb, unsigned long long) {
    if (nb > 0) bits += nb;
  }
};

// Pass B's sink: a stream's slots, LSB first from bit `at` on, ORed into
// 32-bit words (the page image in shared memory, or a stream's Wst words
// in device memory); words at or past `limit` are dropped. A 64-bit
// accumulator gathers the bits and writes each word once, with atomicOr:
// the first and last words of a warp's share, and the words where two
// streams meet, have two writers.
struct BitOr {
  unsigned* words;
  long long limit, w;
  unsigned long long acc = 0;
  int nacc;
  __device__ BitOr(unsigned* words_, long long limit_, long long at)
      : words(words_), limit(limit_), w(at >> 5),
        nacc(static_cast<int>(at & 31)) {}
  __device__ void put(int nb, unsigned long long v) {
    if (nb <= 0) return;
    acc |= v << nacc;
    nacc += nb;
    if (nacc >= 32) {
      if (w < limit) atomicOr(words + w, static_cast<unsigned>(acc));
      ++w;
      acc >>= 32;
      nacc -= 32;
    }
  }
  __device__ void flush() {
    if (nacc > 0 && w < limit) atomicOr(words + w, static_cast<unsigned>(acc));
  }
};

__global__ void __launch_bounds__(kThreads, 1)
    pack_kernel(const uint8_t* __restrict__ pages,
                const int32_t* __restrict__ in_sizes,
                const int32_t* __restrict__ ins_g,
                const int32_t* __restrict__ cpy_g,
                const int32_t* __restrict__ dist_g,
                const int32_t* __restrict__ ncmds_g,
                const int32_t* __restrict__ isdelta_g, int S, int N,
                int page_size, int max_cmds, int region, int lq_shared,
                uint8_t* __restrict__ out_g, int32_t* __restrict__ out_sizes,
                int32_t* __restrict__ scr_g) {
  __shared__ Smem sm;
  // Rarr of each used round, then the region (see blg_pack_pages)
  extern __shared__ __align__(16) unsigned char dyn[];
  long long* rarr = reinterpret_cast<long long*>(dyn);
  unsigned char* reg = dyn + rarr_bytes(N);
  const int tid = threadIdx.x;
  const int lane = lane_id();
  const int w = warp_id();
  const int page = blockIdx.x;
  const Layout lay(N, S, page_size);
  const int wst = lay.wst;
  int32_t* scr = scr_g + static_cast<size_t>(page) * lay.total;
  const int4* cmd4 = reinterpret_cast<int4*>(scr + lay.cmd4);
  unsigned* words = reinterpret_cast<unsigned*>(scr + lay.words);
  int* info = scr + lay.info;
  const uint8_t* pg = pages + static_cast<size_t>(page) * S;
  const int32_t* ins = ins_g + static_cast<size_t>(page) * N;
  const int32_t* cpy = cpy_g + static_cast<size_t>(page) * N;
  const int32_t* dist = dist_g + static_cast<size_t>(page) * N;
  const int n = min(max(ncmds_g[page], 0), N);
  const int insz = in_sizes[page];
  const int isdelta = isdelta_g ? isdelta_g[page] & 1 : 0;
  // thread 0's clock at the end of each phase (the per-page record)
  long long stamp[kPhases + 1];
  stamp[0] = clock64();
  auto mark = [&](int k) {
    if (tid == 0) stamp[k] = clock64();
  };

  // ---- phases 0 to 5: the page's statistics and code lengths
  // (page_tables.cuh) ----
  const PageStats st = page_stats(
      pg, ins, cpy, dist, n, insz, S, page_size, lay, scr, reg, region,
      lq_shared, sm, stamp);
  const long long tail = st.tail;
  const bool has_tail = st.has_tail;
  const int ntotal = st.ntotal, tail_code = st.tail_code;
  const int npostfix = st.npostfix, ndist = st.ndist;
  const int nkeys = st.nkeys, n_lits = st.n_lits, most_freq = st.most_freq;
  const bool keys_shared = st.keys_shared, offset_codes = st.offset_codes;
  const uint8_t* lq = st.lq;
  const int tbase[3] = {0, kACmd, kACmd + kADst};
  const int talpha[3] = {kACmd, kADst, kALit};
  if (w < 3) {
    canonical_codes(sm.lens + tbase[w], talpha[w], sm.code + tbase[w],
                    sm.next[w]);
    const int M = rle_items(sm.lens + tbase[w], talpha[w],
                            sm.runs + tbase[w], sm.items + tbase[w]);
    if (lane < 18) sm.clh[w][lane] = 0;
    __syncwarp();
    for (int b = 0; b < M; b += 32)
      warp_count(sm.clh[w], b + lane < M ? sm.items[tbase[w] + b + lane] & 31
                                         : -1);
    if (lane == 0) sm.M[w] = M;
  }
  __syncthreads();
  for (int T = 0; T < 3; ++T) {
    // _cl_tree: lengths of the code-length code, depth 9
    int* L = sm.cll[T];
    build_lengths(sm.clh[T], 18, sm.M[T], L, sm);
    if (tid < 18) L[tid] = min(L[tid], 9);
    __syncthreads();
    for (int it = 0; it < 9; ++it) {
      int u = tid < 18 && L[tid] > 0 ? 1 << (9 - L[tid]) : 0;
      u = block_sum(u, sm.red);
      if (u <= (1 << 9)) break;
      if (tid < 18 && L[tid] > 0) L[tid] = min(L[tid] + 1, 9);
      __syncthreads();
    }
  }
  if (w < 3) canonical_codes(sm.cll[w], 18, sm.clc[w], sm.next[w]);
  mark(6);           // canonical codes, run-coded tables, their codes

  // ---- round schedule: each round's literal bound (R_k) ----
  const int R = (max_cmds + 2 + kNbs - 1) / kNbs;
  const int nR = min((ntotal - 1) / kNbs + 1, R);
  const int rn = (nR + kThreads - 1) / kThreads;
  const int q0 = min(tid * rn, nR), q1 = min(q0 + rn, nR);
  auto slot_ins = [&](int t) -> long long {
    if (t < n) return ins[t];
    return t == n && has_tail ? tail : 0;
  };
  long long lsum = 0;
  for (int r = q0; r < q1; ++r)
    for (int k = 0; k < kNbs; ++k) lsum += slot_ins(r * kNbs + k);
  long long ltot;
  long long cum = block_excl_scan(lsum, &ltot, sm.red);
  for (int r = q0; r < q1; ++r) {
    for (int k = 0; k < kNbs; ++k) cum += slot_ins(r * kNbs + k);
    rarr[r] = cum;                            // cumlit, inclusive
  }
  __syncthreads();
  if (tid == 0) {
    const int f = nR - 1;
    const long long rf_prev = f > 0 ? (rarr[f - 1] + 31) / 32 * 32 : 0;
    const long long ac_f = max(rarr[f] - rf_prev, 0LL);
    const long long e = max(min(ntotal, kNbs), 1);
    rarr[f] = rf_prev + e * ((ac_f + e - 1) / e);
  }
  __syncthreads();
  for (int r = tid; r < nR - 1; r += kThreads)
    rarr[r] = (rarr[r] + 31) / 32 * 32;
  // the literal sub-histograms and bitmap are done with: the image
  // starts empty
  unsigned* img = reinterpret_cast<unsigned*>(reg);
  for (int i = tid; i < page_size / 4; i += kThreads) img[i] = 0u;
  __syncthreads();
  mark(7);                                       // round schedule

  // ---- the streams' slots as items. Every round but the last ends on a
  // multiple of 32 literals, so round r's literals j in [Rprev, Rarr[r])
  // fall in rows of 32 and literal j goes to sub-stream j & 31. Item
  // ic(r) = r + Rprev / 32 is round r's five command fields (slot
  // 32 r + s of stream s), the items after it up to ic(r + 1) its rows.
  // A stream's dynamic slot e (the cap edyn counts them) is 5 r + k +
  // Rprev / 32 for command field k, 5 (r + 1) + j / 32 for literal j. ----
  const long long edyn = 6LL * R + (page_size + 64) / 32 + 2;
  const int* clen = sm.lens;
  const unsigned* ccode = sm.code;
  const int* dlen = sm.lens + kACmd;
  const unsigned* dcode = sm.code + kACmd;
  const int* llen = sm.lens + kACmd + kADst;
  const unsigned* lcode = sm.code + kACmd + kADst;
  auto ic = [&](int r) {
    return r + static_cast<int>((r ? rarr[r - 1] : 0) >> 5);
  };
  const int n_items = nR + static_cast<int>((rarr[nR - 1] + 31) >> 5);
  const int per = (n_items + kWarps - 1) / kWarps;
  const int it0 = min(w * per, n_items), it1 = min(it0 + per, n_items);
  const int s = lane;
  // the table block: the three tables' header, code-length or symbol
  // column and run-coded item columns, ahead of every stream's rounds
  auto table_block = [&](auto& out) {
    for (int T = 0; T < 3; ++T) {
      const int A = talpha[T];
      const int maxb = A == kALit ? 8 : 10;
      const int mode = sm.mode[T];
      if (s == 0) {
        const unsigned long long e0 = sm.emit[T][0];
        const unsigned long long hv =
            mode == 0 ? (4ull | (e0 << 6))
            : mode == 1
                ? (1ull | (static_cast<unsigned long long>(
                               max(sm.cnt[T] - 1, 0)) << 2) |
                   (static_cast<unsigned long long>(sm.tsel[T]) << 4) |
                   (e0 << 6))
                : (2ull | (14ull << 2));
        out.put(mode == 2 ? 6 : 6 + maxb, hv);
      }
      if (mode == 2 && s < 18) out.put(5, sm.cll[T][kClOrder[s]]);
      if (mode == 1 && s >= 1 && s < sm.cnt[T]) out.put(maxb, sm.emit[T][s]);
      if (mode == 2) {
        const int M = sm.M[T];
        const unsigned char* it = sm.items + tbase[T];
        for (int j = s; j < M; j += kNbs) {
          const int code = it[j] & 31, extra = it[j] >> 5;
          const int cl = sm.cll[T][code];
          const int width = code == 16 ? 2 : code == 17 ? 3 : 0;
          out.put(cl + width,
                  sm.clc[T][code] |
                      (static_cast<unsigned long long>(extra) << cl));
        }
      }
    }
  };
  // this warp's share of the items, lane s's slots of stream s in order
  auto share = [&](auto& out) {
    if (it0 >= it1) return;
    int r = 0, hi = nR - 1;   // the round of item it0
    while (r < hi) {
      const int mid = (r + hi + 1) >> 1;
      if (ic(mid) <= it0) r = mid;
      else hi = mid - 1;
    }
    long long rprev = r ? rarr[r - 1] : 0, rcur = rarr[r];
    int icr = ic(r);
    for (int it = it0; it < it1; ++it) {
      if (r + 1 < nR && it == ic(r + 1)) {
        ++r;
        rprev = rcur;
        rcur = rarr[r];
        icr = it;
      }
      if (it == icr) {
        const long long e0 = 5LL * r + (rprev >> 5);
        if (e0 >= edyn) continue;
        const int t = r * kNbs + s;
        int fn[5] = {0, 0, 0, 0, 0};
        unsigned long long fv[5] = {0, 0, 0, 0, 0};
        if (t < n) {
          const int4 c = cmd4[t];
          const int prefix = c.x & 1023;
          const int dsym = min((c.x >> 10) & 1023, kADst - 1);
          const bool sd = (c.x >> 20) & 1;
          fn[0] = clen[prefix];
          fv[0] = ccode[prefix];
          fn[1] = (c.x >> 21) & 31;
          fv[1] = static_cast<unsigned>(c.z & 0xFFFFFF);
          fn[2] = (c.x >> 26) & 31;
          fv[2] = static_cast<unsigned>(c.w);
          if (sd) {
            fn[3] = dlen[dsym];
            fv[3] = dcode[dsym];
            fn[4] = (c.z >> 24) & 31;
            fv[4] = static_cast<unsigned>(c.y);
          }
        } else if (t < ntotal) {
          const int prefix =
              t == n && has_tail ? kSentinel + tail_code : kSentinel;
          fn[0] = clen[prefix];
          fv[0] = ccode[prefix];
          if (t == n && has_tail) {
            fn[1] = insert_extra(tail_code);
            fv[1] = static_cast<unsigned long long>(
                tail - insert_base(tail_code));
          }
        }
        for (int k = 0; k < 5; ++k)
          if (e0 + k < edyn) out.put(fn[k], fv[k]);
      } else {
        const long long q = (rprev >> 5) + (it - icr - 1);
        const long long j = 32 * q + s;
        if (j < rcur && 5LL * (r + 1) + q < edyn) {
          const int byte = j < n_lits ? lq[j] : most_freq;
          out.put(llen[byte], lcode[byte]);
        }
      }
    }
  };

  // ---- pass A: the bits of each warp's share of each stream ----
  {
    BitCount tb, sh;
    if (w == 0) table_block(tb);
    share(sh);
    sm.share[w][s] = sh.bits;
    if (w == 0) sm.bits[s] = tb.bits;   // the table block leads
  }
  __syncthreads();
  if (tid < kNbs) {   // the scan over the shares, one stream a thread
    long long at = sm.bits[tid];
    for (int k = 0; k < kWarps; ++k) {
      const long long b = sm.share[k][tid];
      sm.share[k][tid] = at;
      at += b;
    }
    sm.bits[tid] = at;
  }
  __syncthreads();
  mark(8);                                       // stream widths

  // ---- page header and size table (the fixed point) ----
  if (tid == 0) {
    long long tot = 0, mn = LLONG_MAX;
    bool overflow = false;
    for (int k = 0; k < kNbs; ++k) {
      const long long sb = (sm.bits[k] + 7) / 8;
      tot += sb;
      mn = min(mn, sb);
      overflow |= sm.bits[k] > 32LL * wst;
    }
    int delta_bits = 1;
    for (int k = 0; k < kNbs; ++k)
      delta_bits = max(delta_bits, bitlen((sm.bits[k] + 7) / 8 - mn));
    long long est = 4 + tot;
    int base_bits = 0, dbs_bits = 0;
    for (int it = 0; it < 6; ++it) {
      base_bits = bitlen((est + 31) / 32);
      dbs_bits = bitlen(bitlen(max(est - 1, 1LL)));
      const long long nh = 8 + base_bits + dbs_bits + kNbs * delta_bits;
      est = ((nh + 7) / 8 + 3) / 4 * 4 + tot;
    }
    const long long hdr_bits = 8 + base_bits + dbs_bits + kNbs * delta_bits;
    const long long hdr_bytes = (hdr_bits + 31) / 32 * 4;
    for (int i = 0; i < kHW; ++i) sm.hw[i] = 0u;
    long long bo = 0;
    auto hput = [&](int nb, long long value) {
      const long long wi = bo >> 5;
      const int shl = static_cast<int>(bo & 31);
      const unsigned long long v =
          static_cast<unsigned long long>(value) &
          (nb >= 32 ? 0xFFFFFFFFull : (1ull << min(nb, 31)) - 1);
      if (nb > 0) {
        sm.hw[min(max(wi, 0LL), static_cast<long long>(kHW - 1))] +=
            static_cast<unsigned>((v << shl) & 0xFFFFFFFFull);
        if (shl > 0)
          sm.hw[min(max(wi + 1, 0LL), static_cast<long long>(kHW - 1))] +=
              static_cast<unsigned>(v >> (32 - shl));
      }
      bo += nb;
    };
    hput(8, npostfix | (ndist << 2) | (isdelta << 6));
    hput(base_bits, mn);
    hput(dbs_bits, delta_bits);
    for (int k = 0; k < kNbs; ++k)
      hput(delta_bits, (sm.bits[k] + 7) / 8 - mn);
    sm.sbp[0] = 0;
    for (int k = 0; k < kNbs; ++k)
      sm.sbp[k + 1] = sm.sbp[k] + (sm.bits[k] + 7) / 8;
    const long long out_total = hdr_bytes + (tot + 3) / 4 * 4;
    out_sizes[page] = overflow ? page_size + 1
                               : static_cast<int32_t>(out_total);
    sm.hdr_bytes = hdr_bytes;
    sm.pay_end = (tot + 3) / 4 * 4;
    // The plain assembly reads the padding after the streams from the
    // last stream's words; past its Wst words that read lands on stream
    // 31's last word. Such a page, and one whose streams overflow, takes
    // the scratch's words and that assembly.
    const long long last_pad =
        (sm.bits[kNbs - 1] + 7) / 8 + (sm.pay_end - tot) - 1;
    sm.spill = overflow || (sm.pay_end > tot && last_pad >= 4LL * wst);
    // the per-page record (read back by a diagnosis, never by a route)
    info[0] = npostfix;
    info[1] = ndist;
    for (int T = 0; T < 3; ++T) {
      info[2 + T] = sm.mode[T];
      info[5 + T] = sm.cnt[T];
      info[8 + T] = sm.tsel[T];
    }
    info[kInfoBranch] = (sm.spill ? kBranchWords : 0) |
                        (keys_shared ? 0 : kBranchKeys) |
                        (lq_shared ? kBranchLq : 0);
    info[14] = n_lits;
    info[15] = most_freq;
    info[16] = ntotal;
    info[17] = nkeys;
    info[18] = offset_codes;
    for (int k = 0; k < kNbs; ++k) info[19 + k] = static_cast<int>(sm.bits[k]);
  }
  for (int i = tid; i < kATot; i += kThreads) info[64 + i] = sm.lens[i];
  __syncthreads();
  const bool spill = sm.spill;
  const long long hdr_bytes = sm.hdr_bytes;
  if (spill) {
    for (int i = tid; i < kNbs * wst; i += kThreads) words[i] = 0u;
  } else if (tid < hdr_bytes / 4 && tid < page_size / 4) {
    img[tid] = sm.hw[tid];
  }
  __syncthreads();
  mark(9);                                       // header

  // ---- pass B: every slot ORed in at its bit offset ----
  {
    // warp 0 writes the table block first and runs on into its share
    const long long at = w == 0 ? 0 : sm.share[w][s];
    BitOr out = spill ? BitOr(words + static_cast<size_t>(s) * wst, wst, at)
                      : BitOr(img, page_size / 4,
                              8 * (hdr_bytes + sm.sbp[s]) + at);
    if (w == 0) table_block(out);
    share(out);
    out.flush();
  }
  __syncthreads();
  mark(10);                                      // bit packing

  uint8_t* outp = out_g + static_cast<size_t>(page) * page_size;
  if (!spill) {
    // ---- copy out: the image, 16 bytes a thread where aligned ----
    if (page_size % 16 == 0) {
      const uint4* src = reinterpret_cast<const uint4*>(img);
      uint4* dst = reinterpret_cast<uint4*>(outp);
      for (int q = tid; q < page_size / 16; q += kThreads) dst[q] = src[q];
    } else {
      uint32_t* dst = reinterpret_cast<uint32_t*>(outp);
      for (int q = tid; q < page_size / 4; q += kThreads) dst[q] = img[q];
    }
  } else {
    // ---- assembly: header words, then the streams, DWORD padded ----
    const long long pay_end = sm.pay_end;
    uint32_t* out = reinterpret_cast<uint32_t*>(outp);
    for (int q = tid; q < page_size / 4; q += kThreads) {
      uint32_t word = 0;
      for (int k = 0; k < 4; ++k) {
        const long long b = 4LL * q + k;
        unsigned byte = 0;
        if (b < hdr_bytes) {
          byte = (sm.hw[min(b >> 2, static_cast<long long>(kHW - 1))] >>
                  ((b & 3) * 8)) & 0xFF;
        } else if (b - hdr_bytes < pay_end) {
          const long long pay = b - hdr_bytes;
          int lo = 0, hi = kNbs;        // last k in [0, 32] with sbp <= pay
          while (lo < hi) {
            const int mid = (lo + hi + 1) >> 1;
            if (sm.sbp[mid] <= pay) lo = mid;
            else hi = mid - 1;
          }
          const int k2 = min(lo, kNbs - 1);
          const long long in = pay - sm.sbp[k2];
          const long long wi = min(max(k2 * static_cast<long long>(wst) +
                                           (in >> 2), 0LL),
                                   static_cast<long long>(kNbs) * wst - 1);
          byte = (words[wi] >> ((in & 3) * 8)) & 0xFF;
        }
        word |= byte << (8 * k);
      }
      out[q] = word;
    }
  }
  __syncthreads();
  if (tid == 0) {
    stamp[kPhases] = clock64();                  // copy out or assembly
    for (int k = 0; k < kPhases; ++k)
      info[kInfoClocks + k] = static_cast<int>(stamp[k + 1] - stamp[k]);
  }
}

}  // namespace
}  // namespace blg_pack


// int32 words of scratch a page needs at (N, S, page_size).
extern "C" long long blg_pack_scratch_ints(int N, int S, int page_size) {
  return blg_pack::Layout(N, S, page_size).total;
}

// Where the per-page record starts in a page's scratch, in int32 words.
extern "C" long long blg_pack_info_offset(int N, int S, int page_size) {
  return blg_pack::Layout(N, S, page_size).info;
}

// Bytes of dynamic shared memory a launch at (N, S, page_size) takes on
// the current device, or -1 if the page size does not fit.
extern "C" long long blg_pack_smem(int N, int S, int page_size) {
  long long bytes;
  int region, lq_shared;
  if (blg_pack::smem_plan(blg_pack::pack_kernel, N, S, page_size, &bytes,
                              &region, &lq_shared) !=
      cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  return bytes;
}

// Launch the serializer over P pages (one block a page).
extern "C" int blg_pack_pages(const void* pages, const void* in_sizes,
                              const void* ins, const void* cpy,
                              const void* dist, const void* ncmds,
                              const void* isdelta, int P, int S, int N,
                              int page_size, int max_cmds, void* out,
                              void* out_sizes, void* scratch, void* stream) {
  if (P <= 0) return 0;
  long long smem;
  int region, lq_shared;
  cudaError_t e = blg_pack::smem_plan(blg_pack::pack_kernel, N, S, page_size,
                                      &smem, &region, &lq_shared);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(blg_pack::pack_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  blg_pack::pack_kernel<<<P, blg_pack::kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(pages), static_cast<const int32_t*>(in_sizes),
      static_cast<const int32_t*>(ins), static_cast<const int32_t*>(cpy),
      static_cast<const int32_t*>(dist), static_cast<const int32_t*>(ncmds),
      static_cast<const int32_t*>(isdelta), S, N, page_size, max_cmds,
      region, lq_shared, static_cast<uint8_t*>(out),
      static_cast<int32_t*>(out_sizes), static_cast<int32_t*>(scratch));
  return static_cast<int>(cudaGetLastError());
}
