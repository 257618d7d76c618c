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
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace blg_pack {
namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;  // also the grid search's 16 points
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNbs = 32;
constexpr int kACmd = 728;
constexpr int kADst = 544;
constexpr int kALit = 256;
constexpr int kATot = kACmd + kADst + kALit;
constexpr int kSentinel = 704;
constexpr int kHW = 24;               // header words
constexpr int kInfoInts = 64 + kATot;  // the per-page record (see below)
constexpr int kInfoBranch = 11;       // its size cases taken (kBranch*)
constexpr int kInfoClocks = 52;       // its clock cycles a phase
constexpr int kPhases = 11;
constexpr int kTile = 4 * kThreads;   // commands a tile of the scans
constexpr int kBranchWords = 1;       // streams in the scratch's words
constexpr int kBranchKeys = 2;        // the sort in the scratch
constexpr int kBranchLq = 4;          // the literal queue in shared memory
constexpr int kSubHist = kWarps * kALit * 4;   // bytes of the literal
                                               // sub-histograms
constexpr int kFar = 1 << 28;         // grid-search distances at or past it
                                      // are left out, as in the plain sort

__constant__ int kClOrder[18] = {1, 2,  3,  4,  0,  5,  17, 6,  16,
                                 7, 8,  9,  10, 11, 12, 13, 14, 15};
__constant__ int kGridNd[4] = {0, 3, 8, 15};

__host__ __device__ inline long long up4(long long x) {
  return (x + 3) & ~3LL;
}

__host__ __device__ inline long long up16(long long x) {
  return (x + 15) & ~15LL;
}

// Scratch offsets of one page, in int32 words.
struct Layout {
  long long starts, pv, ringc, cmd4, sortb, lq, words, info, total;
  int wst;
  __host__ __device__ Layout(int N, int S, int page_size) {
    wst = (page_size / kNbs) / 4 * 3 + 16;
    long long p2 = 1;
    while (p2 < N) p2 <<= 1;
    starts = 0;
    pv = N;
    ringc = 2LL * N;
    cmd4 = up4(3LL * N);
    sortb = cmd4 + 4LL * N;
    lq = sortb + p2;
    words = up4(lq + (S + 3) / 4);
    info = words + static_cast<long long>(kNbs) * wst;
    total = up4(info + kInfoInts);
  }
};

// Bytes of dynamic shared memory ahead of the shared region: each round's
// literal bound (Rarr), at most (N + 1) / 32 + 1 rounds.
__host__ __device__ inline long long rarr_bytes(int N) {
  return up16(8LL * ((N + 1) / kNbs + 1));
}

// The shared region's first part: the page image, or before it the
// literal sub-histograms and the bitmap of literal positions. The literal
// queue follows it when it fits.
__host__ __device__ inline long long image_bytes(int page_size) {
  const long long img = up16(page_size);
  const long long lit = kSubHist + up16((page_size + 7) / 8);
  return img > lit ? img : lit;
}

struct Smem {
  int hist[kATot];       // cmd | dst | lit
  int lens[kATot];
  unsigned code[kATot];  // canonical codes, bit-reversed
  int dh[2][kADst];      // ring-mode histograms
  int srt[kACmd];        // used symbols by count rank
  int ukey[kACmd];       // the used symbols' rank keys
  int nused;
  unsigned char items[kATot];
  short runs[kATot];
  int clh[3][18], cll[3][18];
  unsigned clc[3][18];
  int mode[3], cnt[3], tsel[3], emit[3][4], M[3];
  int s4[4], sym4[3][4], len4[3][4];   // a simple table's symbols
  long long red[kWarps];
  long long grid[kWarps];              // each grid point's cost
  long long runc[kThreads];            // grid run terms, lengths 1..512
  int nkeys;                           // grid-search keys gathered
  long long share[kWarps][kNbs];       // bits of each warp's share of a
                                       // stream, then its bit offset
  long long bits[kNbs];
  long long sbp[kNbs + 1];
  unsigned hw[kHW];
  long long hdr_bytes, pay_end;
  int spill;                           // streams go to the scratch's words
  int next[3][16];
};

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }
__device__ __forceinline__ int warp_id() { return threadIdx.x >> 5; }

__device__ __forceinline__ int bitlen(long long x) {
  return x > 0 ? 64 - __clzll(x) : 0;
}

template <typename T>
__device__ T warp_incl_scan(T v) {
  const int lane = lane_id();
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += y;
  }
  return v;
}

// Adds one to h[v] for each lane whose v is not negative; every lane of
// the warp calls it. Lanes with equal v add together, one atomic for
// each value: atomics of many lanes on one shared address serialise.
__device__ __forceinline__ void warp_count(int* h, int v) {
  const unsigned m = __match_any_sync(kFull, v);
  if (v >= 0 && lane_id() == __ffs(m) - 1) atomicAdd(h + v, __popc(m));
}

// Exclusive prefix sum over the block's threads in thread order.
template <typename T>
__device__ T block_excl_scan(T v, T* total, long long* red) {
  T* r = reinterpret_cast<T*>(red);
  const T inc = warp_incl_scan(v);
  if (lane_id() == 31) r[warp_id()] = inc;
  __syncthreads();
  T base = 0, tot = 0;
  for (int i = 0; i < kWarps; ++i) {
    const T x = r[i];
    if (i < warp_id()) base += x;
    tot += x;
  }
  __syncthreads();
  *total = tot;
  return base + inc - v;
}

template <typename T>
__device__ T block_sum(T v, long long* red) {
  T* r = reinterpret_cast<T*>(red);
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  if (lane_id() == 0) r[warp_id()] = v;
  __syncthreads();
  T t = 0;
  for (int i = 0; i < kWarps; ++i) t += r[i];
  __syncthreads();
  return t;
}

__device__ int block_max(int v, long long* red) {
  int* r = reinterpret_cast<int*>(red);
  for (int o = 16; o; o >>= 1) v = max(v, __shfl_xor_sync(kFull, v, o));
  if (lane_id() == 0) r[warp_id()] = v;
  __syncthreads();
  int t = INT_MIN;
  for (int i = 0; i < kWarps; ++i) t = max(t, r[i]);
  __syncthreads();
  return t;
}

// ---- RFC 7932 length codes (ops/encode_pack.py, ops/arith_lut.py) ----

__device__ int ins_code(int v) {
  if (v < 6) return v;
  if (v < 130) {
    const int nb = bitlen(v - 2) - 2;
    return nb * 2 + ((v - 2) >> nb) + 2;
  }
  if (v < 2114) return bitlen(v - 66) + 9;
  if (v < 6210) return 21;
  if (v < 22594) return 22;
  return 23;
}

__device__ int cpy_code(int v) {
  if (v < 10) return max(v - 2, 0);
  if (v < 134) {
    const int nb = bitlen(v - 6) - 2;
    return nb * 2 + ((v - 6) >> nb) + 4;
  }
  if (v < 2118) return bitlen(v - 70) + 11;
  return 23;
}

__device__ int insert_extra(int c) {
  if (c == 23) return 24;
  if (c == 22) return 14;
  if (c == 21) return 12;
  if (c >= 16) return c - 10;
  if (c < 6) return 0;
  return ((c - 6) >> 1) + 1;
}

__device__ int insert_base(int c) {
  if (c == 23) return 22594;
  if (c == 22) return 6210;
  if (c == 21) return 2114;
  if (c >= 16) return (1 << min(max(c - 10, 0), 11)) + 66;
  if (c < 6) return c;
  return ((2 + (c & 1)) << (((c - 6) >> 1) + 1)) + 2;
}

__device__ int copy_extra(int c) {
  if (c == 23) return 24;
  if (c >= 18) return c - 12;
  if (c < 8) return 0;
  return ((c - 8) >> 1) + 1;
}

__device__ int copy_base(int c) {
  if (c == 23) return 2118;
  if (c >= 18) return (1 << min(max(c - 12, 0), 10)) + 70;
  if (c < 8) return c + 2;
  return ((2 + (c & 1)) << (((c - 8) >> 1) + 1)) + 6;
}

__device__ int combine_codes(int ic, int cc, bool use_last) {
  const int bits64 = (cc & 7) | ((ic & 7) << 3);
  if (use_last) return cc < 8 ? bits64 : (bits64 | 64);
  const int cell = 2 * ((cc >> 3) + 3 * (ic >> 3));
  const int off = (cell << 5) + 0x40 +
                  ((0x520D40 >> min(max(cell, 0), 20)) & 0xC0);
  return off | bits64;
}

// EncodeDistance of d >= 1 under npostfix np and ndirect nd: the symbol,
// its extra-bit count and the extra value.
__device__ void encode_distance(long long d, int np, int nd, int* sym,
                                int* nb, long long* extra) {
  if (d <= nd) {
    *sym = static_cast<int>(16 + d - 1);
    *nb = 0;
    *extra = 0;
    return;
  }
  const long long dd = d - nd - 1;
  const long long postfix = dd & ((1LL << np) - 1);
  const long long hval = dd >> np;
  const int n = bitlen(hval + 4) - 2;
  const long long b = ((hval + 4) >> n) & 1;
  *extra = hval + 4 - ((2 + b) << n);
  *nb = n;
  *sym = static_cast<int>(16 + nd + (((2 * (n - 1) + b) << np) | postfix));
}

__device__ __forceinline__ int dist_sym(long long d, int np, int nd,
                                        int* nb) {
  int s;
  long long x;
  encode_distance(d, np, nd, &s, nb, &x);
  return s;
}

// dist_sym for a grid-search key (1 <= d < kFar) in 32-bit arithmetic.
__device__ __forceinline__ int key_sym(int d, int np, int nd, int* nb) {
  if (d <= nd) {
    *nb = 0;
    return 16 + d - 1;
  }
  const unsigned dd = static_cast<unsigned>(d - nd - 1);
  const unsigned h4 = (dd >> np) + 4u;
  const int n = 30 - __clz(static_cast<int>(h4));
  *nb = n;
  return 16 + nd +
         static_cast<int>(((2u * (n - 1) + ((h4 >> n) & 1u)) << np) |
                          (dd & ((1u << np) - 1u)));
}

// One run's entropy term in 2^-16 bits: round(c * (log2 n - log2 c) + 6),
// with the plain version's float64 operations one at a time (no fused
// multiply-add) and its round half to even.
__device__ long long run_cost(int c, double log2n) {
  const double cd = static_cast<double>(c);
  double t = __dsub_rn(log2n, log2(cd));
  t = __dmul_rn(cd, t);
  t = __dadd_rn(t, 6.0);
  t = __dmul_rn(t, 65536.0);
  return static_cast<long long>(rint(t));
}

// ---- prefix codes ----

// _lengths_from_hist: ceil(log2(total / count)) clipped to [1, 15],
// widened until Kraft holds, then three passes that shorten the
// count-ordered prefix of eligible symbols whose cost fits the slack.
// Block-wide; hist and lens in shared memory.
__device__ void build_lengths(const int* hist, int A, int total, int* lens,
                              Smem& sm) {
  const int tid = threadIdx.x;
  const int t = max(total, 1);
  int used = 0;
  for (int i = tid; i < A; i += kThreads) {
    const int h = hist[i];
    int l = 0;
    if (h > 0) {
      const int ratio = (t + h - 1) / h;
      l = min(max(bitlen(max(ratio - 1, 0)), 1), 15);
      ++used;
    }
    lens[i] = l;
  }
  const int count = block_sum(used, sm.red);
  int units = 0;
  for (int it = 0; it < 15; ++it) {
    units = 0;
    for (int i = tid; i < A; i += kThreads)
      if (lens[i] > 0) units += 1 << (15 - lens[i]);
    units = block_sum(units, sm.red);
    if (units <= (1 << 15)) break;
    for (int i = tid; i < A; i += kThreads)
      if (lens[i] > 0) lens[i] = min(lens[i] + 1, 15);
    __syncthreads();
  }
  int slack = (1 << 15) - units;
  // count-descending ranks of the used symbols, ties by symbol: a used
  // symbol's key, count << 10 | (1023 - symbol), is outranked by the
  // larger keys alone, so the ranks are counted over the used symbols
  if (tid == 0) sm.nused = 0;
  __syncthreads();
  const unsigned below = (1u << lane_id()) - 1u;
  for (int i0 = 0; i0 < A; i0 += kThreads) {
    const int i = i0 + tid;
    const bool u = i < A && hist[i] > 0;
    const unsigned m = __ballot_sync(kFull, u);
    int at = 0;
    if (lane_id() == 0 && m) at = atomicAdd(&sm.nused, __popc(m));
    at = __shfl_sync(kFull, at, 0);
    if (u) sm.ukey[at + __popc(m & below)] = hist[i] << 10 | (1023 - i);
  }
  __syncthreads();
  for (int u = tid; u < count; u += kThreads) {
    const int key = sm.ukey[u];
    int r = 0;
    for (int v = 0; v < count; ++v) r += sm.ukey[v] > key;
    sm.srt[r] = 1023 - (key & 1023);
  }
  __syncthreads();
  const int per = (count + kThreads - 1) / kThreads;
  const int r0 = min(tid * per, count), r1 = min(r0 + per, count);
  for (int pass = 0; pass < 3; ++pass) {
    int sum = 0;
    for (int r = r0; r < r1; ++r) {
      const int l = lens[sm.srt[r]];
      sum += l > 1 ? 1 << (15 - l) : 0;
    }
    int tot;
    int cum = block_excl_scan(sum, &tot, sm.red);
    unsigned pay = 0;
    int paid = 0;
    for (int r = r0; r < r1; ++r) {
      const int l = lens[sm.srt[r]];
      const int c = l > 1 ? 1 << (15 - l) : 0;
      cum += c;
      if (l > 1 && cum <= slack) {
        pay |= 1u << (r - r0);
        paid += c;
      }
    }
    paid = block_sum(paid, sm.red);
    for (int r = r0; r < r1; ++r)
      if (pay >> (r - r0) & 1) lens[sm.srt[r]] -= 1;
    slack -= paid;
    __syncthreads();
  }
}

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

// _choose_table: storage mode, tsel and the (length, symbol) emission
// order of a simple table, and the final code lengths. Block-wide.
__device__ void choose_table(int T, int A, Smem& sm) {
  const int base = T == 0 ? 0 : T == 1 ? kACmd : kACmd + kADst;
  const int* hist = sm.hist + base;
  int* lens = sm.lens + base;
  const int tid = threadIdx.x;
  int used = 0, total = 0;
  for (int i = tid; i < A; i += kThreads) {
    used += hist[i] > 0;
    total += hist[i];
  }
  const int count = block_sum(used, sm.red);
  total = block_sum(total, sm.red);
  if (count > 4) {
    build_lengths(hist, A, total, lens, sm);
  } else if (warp_id() == 0) {
    // the used symbols ascending, padded with A
    const int lane = lane_id();
    int found = 0;
    for (int b = 0; b < A && found < 4; b += 32) {
      const bool u = b + lane < A && hist[b + lane] > 0;
      unsigned m = __ballot_sync(kFull, u);
      while (m && found < 4) {
        if (lane == 0) sm.s4[found] = b + __ffs(m) - 1;
        ++found;
        m &= m - 1;
      }
    }
    if (lane == 0) {
      int s4[4], c4[4], order[4], rank_of[4];
      for (int k = 0; k < 4; ++k) {
        s4[k] = k < found ? sm.s4[k] : A;
        c4[k] = s4[k] < A ? hist[s4[k]] : 0;
        order[k] = k;
      }
      // stable sort of the slots by count, descending
      for (int a = 1; a < 4; ++a)
        for (int b = a; b > 0 && c4[order[b]] > c4[order[b - 1]]; --b) {
          const int x = order[b];
          order[b] = order[b - 1];
          order[b - 1] = x;
        }
      int cd[4];
      for (int k = 0; k < 4; ++k) {
        cd[k] = c4[order[k]];
        rank_of[order[k]] = k;
      }
      const int flat = 2 * (cd[0] + cd[1] + cd[2] + cd[3]);
      const int skew = cd[0] + 2 * cd[1] + 3 * (cd[2] + cd[3]);
      const int tsel = count == 4 && skew < flat;
      // the decoder's fixed length rows by count rank: two symbols, three,
      // four skewed (tsel), four flat
      const int rows[16] = {1, 1, 0, 0, 1, 2, 2, 0, 1, 2, 3, 3, 2, 2, 2, 2};
      const int row = count == 2 ? 0 : count == 3 ? 1 : tsel ? 2 : 3;
      int ek[4], eo[4];
      for (int k = 0; k < 4; ++k) {
        const int len = s4[k] < A ? rows[4 * row + rank_of[k]] : 0;
        sm.sym4[T][k] = s4[k];
        sm.len4[T][k] = len;
        // emission order: (length, symbol), padding last
        ek[k] = s4[k] < A ? len * (A + 1) + s4[k] : 16 * (A + 1) + A;
        eo[k] = k;
      }
      for (int a = 1; a < 4; ++a)
        for (int b = a; b > 0 && ek[eo[b]] < ek[eo[b - 1]]; --b) {
          const int x = eo[b];
          eo[b] = eo[b - 1];
          eo[b - 1] = x;
        }
      for (int k = 0; k < 4; ++k) {
        const int s = s4[eo[k]];
        sm.emit[T][k] = s < A ? s : 0;
      }
      sm.tsel[T] = tsel;
    }
  }
  __syncthreads();
  const int mode = count <= 1 ? 0 : count <= 4 ? 1 : 2;
  if (mode != 2) {
    for (int i = tid; i < A; i += kThreads) lens[i] = 0;
    __syncthreads();
    if (mode == 1 && tid < 4 && sm.sym4[T][tid] < A)
      lens[sm.sym4[T][tid]] = sm.len4[T][tid];
  } else if (tid == 0) {
    // mode 2 keeps tsel 0 and emits no symbol list
    sm.tsel[T] = 0;
    for (int k = 0; k < 4; ++k) sm.emit[T][k] = 0;
  }
  if (tid == 0) {
    sm.mode[T] = mode;
    sm.cnt[T] = count;
  }
  __syncthreads();
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

template <typename T>
__device__ T warp_sum(T v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Ascending bitonic sort of a[0, m), m a power of two; block-wide, a in
// shared or device memory. The compare steps whose partners lie more than
// 32 apart pass over the whole array with a block barrier each; the rest
// of a merge (partners at most 32 apart) stays inside aligned blocks of
// 64 keys, which each warp finishes in registers (lane l holds keys l and
// l + 32 of a block; partners under 32 apart are a shuffle away). The
// merges of up to 64 keys run that way in one pass.
__device__ void bitonic_sort(int* a, int m) {
  const int lane = lane_id();
  // merges k0 to k1 on the warp's blocks, each from its step j = top (or
  // k / 2 where top is 0) down to 1
  auto in_warp = [&](int k0, int k1, int top) {
    for (int b = warp_id() * 64; b < m; b += kWarps * 64) {
      const int i0 = b + lane, i1 = i0 + 32;
      int x0 = i0 < m ? a[i0] : INT_MAX, x1 = i1 < m ? a[i1] : INT_MAX;
      for (int k = k0; k <= k1; k <<= 1) {
        for (int j = top ? top : k >> 1; j > 0; j >>= 1) {
          if (j == 32) {
            if ((x0 > x1) == ((i0 & k) == 0)) {
              const int x = x0;
              x0 = x1;
              x1 = x;
            }
          } else {
            const int y0 = __shfl_xor_sync(kFull, x0, j);
            const int y1 = __shfl_xor_sync(kFull, x1, j);
            const bool low = (lane & j) == 0;
            x0 = (((i0 & k) == 0) == low) ? min(x0, y0) : max(x0, y0);
            x1 = (((i1 & k) == 0) == low) ? min(x1, y1) : max(x1, y1);
          }
        }
      }
      if (i0 < m) a[i0] = x0;
      if (i1 < m) a[i1] = x1;
    }
  };
  in_warp(2, min(m, 64), 0);
  __syncthreads();
  for (int k = 128; k <= m; k <<= 1) {
    for (int jj = k >> 1; jj > 32; jj >>= 1) {
      // four pairs a thread at a time: their loads first, then the stores
      for (int p0 = threadIdx.x; p0 < m / 2; p0 += 4 * kThreads) {
        int i[4], x[4], y[4];
        for (int r = 0; r < 4; ++r) {
          const int p = p0 + r * kThreads;
          i[r] = ((p & ~(jj - 1)) << 1) | (p & (jj - 1));
          if (p < m / 2) {
            x[r] = a[i[r]];
            y[r] = a[i[r] ^ jj];
          }
        }
        for (int r = 0; r < 4; ++r)
          if (p0 + r * kThreads < m / 2 &&
              (x[r] > y[r]) == ((i[r] & k) == 0)) {
            a[i[r]] = y[r];
            a[i[r] ^ jj] = x[r];
          }
      }
      __syncthreads();
    }
    in_warp(k, k, 32);
    __syncthreads();
  }
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
  int* starts = scr + lay.starts;
  int* pv = scr + lay.pv;
  int* ringc = scr + lay.ringc;
  int4* cmd4 = reinterpret_cast<int4*>(scr + lay.cmd4);
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

  for (int i = tid; i < kATot; i += kThreads) sm.hist[i] = 0;
  for (int i = tid; i < 2 * kADst; i += kThreads) (&sm.dh[0][0])[i] = 0;

  if (tid == 0) sm.nkeys = 0;

  // ---- command starts; the tail. In tiles of kTile commands, thread t
  // the four from 4 t on: the loads coalesce, and a block scan a tile
  // carries the sum ----
  long long covered = 0;
  for (int base = 0; base < n; base += kTile) {
    const int j0 = base + 4 * tid;
    long long len[4], sum = 0;
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + q;
      len[q] = j < n ? static_cast<long long>(ins[j]) + cpy[j] : 0;
      sum += len[q];
    }
    long long tot;
    long long st = covered + block_excl_scan(sum, &tot, sm.red);
    for (int q = 0; q < 4; ++q) {
      if (j0 + q < n) starts[j0 + q] = static_cast<int>(st);
      st += len[q];
    }
    covered += tot;
  }
  const long long tail = insz - covered;
  const bool has_tail = tail > 0;
  const int ntotal = n + 1 + has_tail;

  // ---- exact ring state before each command (_ring_before), and the
  // grid search's keys: the distances that are not exact ring hits ----
  auto is_copy = [&](int j) { return cpy[j] > 0 && dist[j] > 0; };
  auto ring0 = [&](int j) {
    return j == 0 ? 4 : (is_copy(j - 1) ? dist[j - 1] : 0);
  };
  auto pvx = [&](int i) {
    return i == 0 ? 16 : i == 1 ? 15 : i == 2 ? 11 : pv[i - 3];
  };
  // a page whose commands could give more keys than the region holds
  // sorts them in its scratch
  long long m2max = 1;
  while (m2max < n) m2max <<= 1;
  const bool keys_shared = 4 * m2max <= region;
  int* keys = keys_shared ? reinterpret_cast<int*>(reg) : scr + lay.sortb;
  const unsigned below = (1u << lane) - 1u;
  int pushed = 0;
  for (int base = 0; base < n; base += kTile) {
    const int j0 = base + 4 * tid;
    int pushes = 0;
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + q;
      if (j < n) pushes += is_copy(j) && dist[j] != ring0(j);
    }
    int tot;
    const int pex = pushed + block_excl_scan(pushes, &tot, sm.red);
    int t = pex;
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + q;
      if (j >= n) break;
      const int r0 = ring0(j);
      if (is_copy(j) && dist[j] != r0) pv[t++] = r0;
    }
    __syncthreads();
    t = pex;
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + q;
      bool key = false;
      int d = 0;
      if (j < n) {
        const int r0 = ring0(j);
        int rc = -1;
        d = dist[j];
        if (is_copy(j)) {
          const int r1 = pvx(2 + t), r2 = pvx(1 + t), r3 = pvx(t);
          if (d == r0) rc = 0;
          else if (d == r1) rc = 1;
          else if (d == r2) rc = 2;
          else if (d == r3) rc = 3;
          else if (d == r0 - 1) rc = 4;
          else if (d == r0 + 1) rc = 5;
          else if (d == r0 - 2) rc = 6;
          else if (d == r0 + 2) rc = 7;
          else if (d == r0 - 3) rc = 8;
          else if (d == r0 + 3) rc = 9;
          else if (d == r1 - 1) rc = 10;
          else if (d == r1 + 1) rc = 11;
          else if (d == r1 - 2) rc = 12;
          else if (d == r1 + 2) rc = 13;
          else if (d == r1 - 3) rc = 14;
          else if (d == r1 + 3) rc = 15;
          if (d != r0) ++t;
          key = !(rc >= 0 && rc <= 3) && d < kFar;
        }
        ringc[j] = rc;
      }
      // one slot reservation a warp; the keys' order does not matter
      const unsigned m = __ballot_sync(kFull, key);
      int at = 0;
      if (lane == 0 && m) at = atomicAdd(&sm.nkeys, __popc(m));
      at = __shfl_sync(kFull, at, 0);
      if (key) keys[at + __popc(m & below)] = d;
    }
    pushed += tot;
  }
  __syncthreads();

  // ---- the (npostfix, ndirect) grid search: the sorted keys, 16 grid
  // points, the first minimum wins ----
  const int nkeys = sm.nkeys;
  const double log2k = log2(static_cast<double>(max(nkeys, 1)));
  sm.runc[tid] = run_cost(tid + 1, log2k);
  mark(1);                                       // starts, ring codes
  int m2 = 4;   // at least a lane's four keys of the grid search
  while (m2 < nkeys) m2 <<= 1;
  for (int i = nkeys + tid; i < m2; i += kThreads) keys[i] = INT_MAX;
  __syncthreads();
  bitonic_sort(keys, m2);
  mark(2);                                       // the distance sort
  {
    // warp g prices grid point g: runs of equal symbols in sorted order
    // that start on a symbol of the alphabet, each up to the next start.
    // Lane l takes keys 4 l to 4 l + 3 of every 128.
    auto run = [&](int c) {
      return c <= kThreads ? sm.runc[c - 1] : run_cost(c, log2k);
    };
    const int gnp = w >> 2, gnd = kGridNd[w & 3] << gnp;
    long long cost = 0, nbs = 0;
    int open = -1;   // the last start before the chunk
    for (int b = 0; b < nkeys; b += 128) {
      const int i0 = b + 4 * lane;
      int s[4] = {INT_MAX, INT_MAX, INT_MAX, INT_MAX};
      if (i0 < nkeys) {
        const int4 k4 = *reinterpret_cast<const int4*>(keys + i0);
        const int kv[4] = {k4.x, k4.y, k4.z, k4.w};
        for (int u = 0; u < 4; ++u) {
          if (i0 + u >= nkeys) break;
          int nb;
          s[u] = key_sym(kv[u], gnp, gnd, &nb);
          nbs += nb;
        }
      }
      int prev = __shfl_up_sync(kFull, s[3], 1);
      if (lane == 0) {
        int nb;
        prev = b > 0 ? key_sym(keys[b - 1], gnp, gnd, &nb) : -1;
      }
      bool start[4];
      int last = -1;
      for (int u = 0; u < 4; ++u) {
        start[u] = i0 + u < nkeys && s[u] < kADst && s[u] != prev;
        if (start[u]) last = i0 + u;
        prev = s[u];
      }
      // the last start at or before this lane's keys: a max scan
      int upto = last;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, upto, o);
        if (lane >= o) upto = max(upto, y);
      }
      int ps = __shfl_up_sync(kFull, upto, 1);
      ps = max(lane ? ps : -1, open);
      for (int u = 0; u < 4; ++u)
        if (start[u]) {
          if (ps >= 0) cost += run(i0 + u - ps);
          ps = i0 + u;
        }
      open = max(open, __shfl_sync(kFull, upto, 31));
    }
    if (lane == 0 && open >= 0) cost += run(nkeys - open);
    cost = warp_sum(cost);
    nbs = warp_sum(nbs);
    if (lane == 0) sm.grid[w] = cost + (nbs << 16);
  }
  __syncthreads();
  int best = 0;
  for (int g = 1; g < kWarps; ++g)
    if (sm.grid[g] < sm.grid[best]) best = g;
  mark(3);                                       // the 16 grid points
  const int npostfix = best >> 2;
  const int ndist = kGridNd[best & 3];
  const int ndirect = ndist << npostfix;

  // the keys are done with: the region now holds the literal
  // sub-histograms and bitmap (and the literal queue, where it fits)
  int* subh = reinterpret_cast<int*>(reg);
  for (int i = tid; i < kWarps * kALit; i += kThreads) subh[i] = 0;
  uint8_t* lq = lq_shared ? reg + image_bytes(page_size)
                          : reinterpret_cast<uint8_t*>(scr + lay.lq);

  // ---- ring mode: exact hits only vs the offset codes too ----
  int nm = 0, ge[2] = {0, 0};
  long long nbk[2] = {0, 0};
  for (int j0 = 0; j0 < n; j0 += kThreads) {
    const int j = j0 + tid;
    int s0 = -1, s1 = -1;
    if (j < n && is_copy(j) && ringc[j] != 0) {
      const int rc = ringc[j];
      ++nm;
      int dnb;
      const int ds = dist_sym(max(dist[j], 1), npostfix, ndirect, &dnb);
      const bool exact = rc >= 1 && rc <= 3;
      s0 = exact ? rc : ds;
      s1 = rc >= 0 ? rc : ds;
      nbk[0] += exact ? 0 : dnb;
      nbk[1] += rc >= 0 ? 0 : dnb;
      if (s0 >= kADst) {
        ++ge[0];
        s0 = -1;
      }
      if (s1 >= kADst) {
        ++ge[1];
        s1 = -1;
      }
    }
    warp_count(sm.dh[0], s0);
    warp_count(sm.dh[1], s1);
  }
  nm = block_sum(nm, sm.red);
  long long ring_cost[2];
  const double log2m = log2(static_cast<double>(max(nm, 1)));
  for (int k = 0; k < 2; ++k) {
    const int gek = block_sum(ge[k], sm.red);
    int top = -1;
    for (int v = tid; v < kADst; v += kThreads)
      if (sm.dh[k][v] > 0) top = max(top, v);
    top = block_max(top, sm.red);
    long long c = 0;
    for (int v = tid; v < kADst; v += kThreads) {
      const int h = sm.dh[k][v];
      if (h > 0) c += run_cost(h + (v == top ? gek : 0), log2m);
    }
    c = block_sum(c, sm.red);
    ring_cost[k] = c + (block_sum(nbk[k], sm.red) << 16);
  }
  const bool offset_codes = ring_cost[1] < ring_cost[0];

  // ---- per-command wire fields, command and distance histograms ----
  for (int j0 = 0; j0 < n; j0 += kThreads) {
    const int j = j0 + tid;
    int hc = -1, hd = -1;
    if (j < n) {
      const int rc = ringc[j];
      const int in = ins[j], cp = cpy[j];
      const int sel = offset_codes ? rc : (rc >= 0 && rc <= 3 ? rc : -1);
      int dsym = sel, dnb = 0;
      long long dx = 0;
      if (sel < 0) encode_distance(max(dist[j], 1), npostfix, ndirect,
                                   &dsym, &dnb, &dx);
      const int ic = ins_code(in), cc = cpy_code(cp);
      const bool use_last = rc == 0 && ic < 8 && cc < 16;
      const int prefix = combine_codes(ic, cc, use_last);
      const bool sd = !use_last;
      if (prefix >= 0 && prefix < kACmd) hc = prefix;
      if (sd && dsym >= 0 && dsym < kADst) hd = dsym;
      const int insx = in - insert_base(ic);
      const int cpyx = cc > 1 ? cp - copy_base(cc) : cp;
      cmd4[j] = make_int4(
          prefix | ((sd ? dsym : 0) << 10) | (static_cast<int>(sd) << 20) |
              (insert_extra(ic) << 21) | (copy_extra(cc) << 26),
          sd ? static_cast<int>(dx) : 0, insx | ((sd ? dnb : 0) << 24),
          cpyx);
    }
    warp_count(sm.hist, hc);
    warp_count(sm.hist + kACmd, hd);
  }
  const int tail_code = has_tail ? ins_code(static_cast<int>(tail)) : 0;
  if (tid == 0) {
    if (has_tail) atomicAdd(&sm.hist[kSentinel + tail_code], 1);
    atomicAdd(&sm.hist[kSentinel], 1);
  }

  // ---- literal cover: the insert regions and the tail, a bitmap of the
  // page's positions in shared memory; then each thread's words of it,
  // in page order, with their bytes read 16 at a time ----
  unsigned* litmap = reinterpret_cast<unsigned*>(reg + kSubHist);
  const int nwords = (S + 31) / 32;
  const long long lim = min(insz, S);
  auto bits_of = [](long long a, long long b) {   // bits a..b-1 of a word
    const unsigned hi = b >= 32 ? kFull : (1u << b) - 1u;
    return hi & ~((1u << a) - 1u);
  };
  for (int i = tid; i < nwords; i += kThreads) {
    const long long lo = 32LL * i;
    const long long a = max(lo, covered), b = min(lo + 32, lim);
    litmap[i] = a < b ? bits_of(a - lo, b - lo) : 0u;
  }
  __syncthreads();
  for (int j = tid; j < n; j += kThreads) {
    const long long a = starts[j], b = min(a + ins[j], lim);
    for (long long lo = a & ~31LL; lo < b; lo += 32)
      atomicOr(&litmap[lo >> 5],
               bits_of(max(a, lo) - lo, min(b, lo + 32) - lo));
  }
  __syncthreads();
  const int wpt = (nwords + kThreads - 1) / kThreads;
  const int w0 = min(tid * wpt, nwords), w1 = min(w0 + wpt, nwords);
  int nlit_local = 0;
  for (int i = w0; i < w1; ++i) nlit_local += __popc(litmap[i]);
  int n_lits;
  int at = block_excl_scan(nlit_local, &n_lits, sm.red);   // its queue slot
  for (int i = w0; i < w1; ++i) {
    const unsigned bits = litmap[i];
    if (!bits) continue;
    const int p = 32 * i;
    unsigned v[8];
    if (p + 32 <= S && (S & 15) == 0) {
      const uint4 x = *reinterpret_cast<const uint4*>(pg + p);
      const uint4 y = *reinterpret_cast<const uint4*>(pg + p + 16);
      v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
      v[4] = y.x; v[5] = y.y; v[6] = y.z; v[7] = y.w;
    } else {
      for (int k = 0; k < 8; ++k) {
        v[k] = 0;
        for (int e = 0; e < 4; ++e)
          if (p + 4 * k + e < S) v[k] |= pg[p + 4 * k + e] << (8 * e);
      }
    }
    for (int k = 0; k < 8; ++k) {
      unsigned b4 = (bits >> (4 * k)) & 15u;
      while (b4) {
        lq[at++] = static_cast<uint8_t>(v[k] >> (8 * (__ffs(b4) - 1)));
        b4 &= b4 - 1;
      }
    }
  }
  __syncthreads();
  {
    // the literal histogram from the queue: warp w counts its share into
    // its own sub-histogram, 32 literals a step
    const int per_w = (n_lits + kWarps - 1) / kWarps;
    const int l0 = w * per_w, l1 = min(l0 + per_w, n_lits);
    for (int b = l0; b < l1; b += 32)
      warp_count(subh + w * kALit, b + lane < l1 ? lq[b + lane] : -1);
  }
  __syncthreads();
  int mf = -1;
  for (int v = tid; v < kALit; v += kThreads) {
    int h = 0;
    for (int k = 0; k < kWarps; ++k) h += subh[k * kALit + v];
    sm.hist[kACmd + kADst + v] = h;
    mf = max(mf, (h << 8) | (255 - v));
  }
  const int most_freq = 255 - (block_max(mf, sm.red) & 255);
  mark(4);                   // ring mode, fields, histograms, literals

  // ---- the three prefix codes ----
  choose_table(0, kACmd, sm);
  choose_table(1, kADst, sm);
  choose_table(2, kALit, sm);
  mark(5);                                       // code lengths
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

// The dynamic shared memory of a launch on the current device: Rarr,
// then a region as large as the card allows up to what a page needs: the
// image (and the literal queue after it where both fit), or during the
// sort 4 * 2^ceil(log2 N) bytes of keys. Sets the bytes, the region and
// whether the literal queue is in it; returns a CUDA error or 0.
cudaError_t smem_plan(int N, int S, int page_size, long long* bytes,
                      int* region, int* lq_shared) {
  int dev = 0, optin = 0;
  cudaFuncAttributes fa;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, pack_kernel);
  if (e != cudaSuccess) return e;
  const long long head = rarr_bytes(N);
  const long long avail =
      optin - static_cast<long long>(fa.sharedSizeBytes) - head;
  const long long img = image_bytes(page_size);
  const long long lqb = up16(S);
  *lq_shared = img + lqb <= avail;
  long long keys = 4;
  while (keys < 4LL * N) keys <<= 1;
  long long reg = img + (*lq_shared ? lqb : 0);
  if (keys > reg) reg = keys < avail ? keys : avail;
  if (reg < img) return cudaErrorInvalidValue;
  *region = static_cast<int>(reg);
  *bytes = head + reg;
  return cudaSuccess;
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
  if (blg_pack::smem_plan(N, S, page_size, &bytes, &region, &lq_shared) !=
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
  cudaError_t e = blg_pack::smem_plan(N, S, page_size, &smem, &region,
                                      &lq_shared);
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
