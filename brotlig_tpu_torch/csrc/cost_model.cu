// The q11 cost model: the windowed DP's cost tables and candidate set from
// a previous parse's commands.
//
// Replaces brotlig_tpu/ops/parse_dp.py:71 (build_cost_model), which has no
// Pallas kernel: on the TPU, XLA compiles it into one jax.jit program.
// Plain version: ops/parse_dp.py::build_cost_model_plain (the same function
// as eager torch ops, ~3,000 launches a call); wrapper:
// ops/cost_kernel.py::build_cost_model_cuda. Two kernels, two launches a
// call (a third, unseen_check_kernel, only checks the unseen-symbol cost):
//
//   * cost_tables_kernel, a thread block cluster of c CTAs a page (c the
//     most of 8, 4 and 2 whose CTAs, one an SM, fit the card: 8 for an
//     8-page batch, 2 for 64 pages; 1 past 66 pages). It computes what the
//     serializer's statistics give (ops/encode_pack.py::page_histograms and
//     _choose_table) as far as the cost model reads them, then the
//     half-bit symbol costs:
//       - starts and ring: CTA r takes a contiguous share of the commands;
//         a first pass sums its bytes and ring pushes and finds its last
//         three pushed values, the cluster exchanges them, and a second
//         pass writes each command's start and the exact ring before it
//         (_ring_before), counts each grid-search key, marks each insert
//         region in the literal bitmap of the CTA whose share of the page
//         holds it (regions of more than 16 words by the whole block), and
//         records the command that covers each position tile's first byte;
//       - the (npostfix, ndirect) grid search without a sort: the plain
//         version prices runs of equal symbols over the keys in distance
//         order, so each distinct distance's count decides every run.
//         CTA r owns a slice of distances in its shared memory (16-bit
//         counts, two a word, below 65536 command columns); the key
//         counts arrive there as atomics over distributed shared memory.
//         The cluster exchanges each chunk's present distances and keys,
//         and CTA r takes an equal share by rank of all the present
//         distances (most lie in the first slice), compacts them with
//         their key positions from whichever CTA holds them, and warp g
//         prices grid point g over them (a run starts on a symbol inside
//         the alphabet that differs from the previous key's). Runs join
//         across shares in the leader: each share gives its first and last
//         run start, the cost of the runs between and the extra bits. Keys
//         at or past the slices (up to the 2^28 cut) go to a side list
//         that the leader sorts and prices after the last share;
//       - the literal histogram: CTA r counts the bytes of its share of the
//         page that its bitmap marks, or that lie in the tail, straight
//         from the page (no literal queue);
//       - the ring mode and the histograms: each CTA counts its commands
//         into its own ring-mode, command and (both modes') distance
//         histograms; no wire fields are written;
//       - the three code lengths at once, each on a CTA of its own (on
//         warp groups of one CTA where c < 3): the table's owner sums the
//         cluster's histograms over distributed shared memory, then
//         _choose_table's lengths (trivial and simple tables included; the
//         used symbols ranked by a bitonic sort);
//       - the costs: a used symbol costs twice its code length, an unused
//         one round(2 * min(15, log2f(total) + pad)) (pad 2 for literals and
//         commands, 4 for distances; libdevice log2f and rintf, no fast
//         math, as torch's float32 log2 and round give on the card). It
//         writes jointEq / jointLq [P, 576] and, into the page's scratch,
//         the literal and distance cost tables, the ring before each
//         command and after the last one (N + 1 columns), and npostfix,
//         ndirect, the command count and the bytes the commands cover.
//   * cost_positions_kernel, a block a tile of kPosTile positions of one
//     page: the page's two cost tables, the tile's bytes and the starts and
//     rings of the commands that cover it (from the one the table kernel
//     recorded for the tile) in shared memory; each warp takes 32
//     positions a round, its base rows brought in by cp.async two rounds
//     ahead. A position's literal cost, its covering command (a search
//     over the tile's starts; at or past the covered bytes the ring after
//     the last command), the four ring-distance probes (a common
//     prefix of at most 16 bytes, counted to the page's size, kept from 2
//     bytes on; four bytes a compare, the source as aligned words with a
//     funnel shift), the 12 candidate slots (the 8 base slots copied, then
//     the 4 ring slots) and each slot's distance cost: symbol plus extra
//     bits under the page's (npostfix, ndirect), 40 bits past the
//     alphabet, or the lowest ring code the distance takes against the
//     inherited ring where that is cheaper, with the ring-0 hit in the low
//     bit. Each output slab of a warp's 32 positions is staged in shared
//     memory and stored as contiguous 16-byte lanes.
//
// What bounds it on this card: the bytes. An iteration of the 8-page q11
// batch reads the base candidates (33.6 MB) and writes the three [P, S, 12]
// outputs (75.5 MB): ~34 us at 3.35 TB/s; the arithmetic is a few dozen
// integer operations a slot (the ring code without branches). The table
// kernel is a per-page chain, paced by its slowest page and its barriers,
// not by bytes: the cluster spreads each phase over c SMs and keeps the
// exchange on chip; thread 0 of a page's first CTA stamps each phase's end
// into the page's record, with the 16 grid points' costs.
//
// Inputs (int32 unless noted): pages uint8 [P, S], in_sizes [P], ins / cpy /
// dist [P, N] (zero past ncmds), ncmds [P], base_len / base_dist [P, S, 8].
// Outputs: litq [P, S], jointEq / jointLq [P, 576], cand_len / cand_dist /
// dpackq [P, S, 12]. Scratch: int32 [P, blg_cost_scratch_ints(P, N, S)]. The
// contract is the plain version's for commands whose lengths cover at most
// the page and page sizes at most S (what the matchers and the DP give).
#include <climits>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "page_tables.cuh"

namespace cg = cooperative_groups;

namespace blg_cost {
namespace {

using namespace blg_pack;

constexpr int kInfQ = (1 << 21) - 1;   // parse_dp.INF_Q
constexpr int kJoint = 24 * 24;        // (insert code, copy code) pairs
constexpr int kBase = 8;               // find_candidates' slots
constexpr int kSlots = kBase + 4;      // and the four ring probes
constexpr int kProbe = 16;             // bytes a ring probe compares
constexpr int kHdrInts = 4;            // n, covered, npostfix, ndirect
constexpr int kMaxCluster = 8;
constexpr int kChunk = 8 * kThreads;   // distances a scan of the counts
constexpr int kMaxChunks = 32;         // chunks of the counted distances
constexpr int kBuf = kChunk;           // present distances priced at once
constexpr int kLong = 256;             // long insert regions the block marks
constexpr int kRecPhases = 8;          // the table kernel's clock record,
constexpr int kRecInts = kRecPhases + 2 * kWarps;   // then the grid costs
constexpr int kTabKeys = 1024;         // the rank sort's keys (>= kACmd)
constexpr int kPosThreads = 256;
constexpr int kPosWarps = kPosThreads / 32;
constexpr int kPosTile = 2048;         // positions a block
constexpr int kPosWarpRows = kPosTile / kPosWarps;   // a warp's positions
constexpr int kPosRounds = kPosWarpRows / 32;
constexpr int kSliceCap = kPosTile + 1;   // commands a tile keeps on chip
constexpr int kTileWords = kPosTile / 4 + 8;

__host__ __device__ inline long long up_to(long long x, long long m) {
  return (x + m - 1) / m * m;
}

// A launch's shape: the cluster, each CTA's slice of distances and of page
// positions, where the distance counts live, the table kernel's dynamic
// shared memory, and a page's scratch (int32 words).
struct Plan {
  int c;             // CTAs a page
  int sl;            // distances a slice (a multiple of 64)
  int pr;            // page positions a CTA's literal share (a multiple
                     // of 32)
  int half;          // 16-bit counts, two a word
  int cnt_smem;      // the counts in shared memory (else in the scratch)
  int slice_words;   // words of a slice's counts
  long long o_bm, o_cnt, o_u, smem;   // shared memory offsets and bytes
  long long starts, pv, rc4, side, ring, hdr, litq, dstq, tiles, gcnt, total;
};

// What a CTA publishes to its cluster (the others read it over
// distributed shared memory).
struct Xchg {
  long long cov;               // bytes its commands cover
  long long part[kWarps];      // grid point g: its share's run costs
  long long nbs[kWarps];       // and extra bits
  long long nbk[2];            // ring mode: extra bits under each mode
  int push;                    // ring pushes in its share
  int nlast, last3[3];         // its last pushed values, newest first
  // each chunk of its slice: present distances, keys, the largest present
  int pc[kMaxChunks], kk[kMaxChunks], cl[kMaxChunks];
  int nside;                   // (leader) keys past the slices
  int F[kWarps], L[kWarps];    // grid point g: first and last run start
  int best;                    // (leader) the grid point chosen
  int nm, ge[2];               // ring mode: copies; symbols past the table
  struct {
    int cmd[kACmd];
    int dst[2][kADst];         // the distance histogram under each mode
    int dh[2][kADst];          // the ring-mode histograms
    int lit[kALit];
  } h;
};

// A CTA's own shared state.
struct Local {
  long long runc[kThreads];    // run terms of lengths 1..kThreads
  long long red[2 * kWarps];
  long long sgrid[kWarps];     // (leader) each grid point's cost
  // (leader) each share's grid summaries, then the side list's
  long long part[kMaxCluster + 1][kWarps], nbs[kMaxCluster + 1][kWarps];
  int F[kMaxCluster + 1][kWarps], L[kMaxCluster + 1][kWarps];
  long long cov_base, cov_all;
  int carry[3];                // the ring values pushed before the share
  int push_base, M, kc, lastall, nside, carryd, nlong;
  int longa[kLong], longb[kLong];   // long insert regions of pass 2
  // each chunk of the cluster's counts, in distance order: the present
  // distances and keys before it, the last present distance before it
  int rank0[kMaxChunks + 1], pos0[kMaxChunks + 1], prevd[kMaxChunks];
};

// One table's code-length build.
struct Tab {
  int hist[kACmd];
  int lens[kACmd];
  int key[kTabKeys];
  long long red[2 * kWarps];
  int nused;
};

constexpr long long kHead = ((sizeof(Xchg) + 15) / 16) * 16 +
                            ((sizeof(Local) + 15) / 16) * 16;

// Sets *p for P pages of S bytes with N command columns on the current
// device; returns a CUDA error or 0.
cudaError_t make_plan(int P, int N, int S, Plan* p) {
  int dev = 0, sms = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  int c = 1;
  for (int k = 2; k <= kMaxCluster; k *= 2)
    if (static_cast<long long>(P) * k <= sms) c = k;
  p->c = c;
  p->sl = static_cast<int>(up_to((S + c - 1) / c, 64));
  p->pr = static_cast<int>(up_to((S + c - 1) / c, 32));
  p->half = N < 65536;
  if (c * ((p->sl + kChunk - 1) / kChunk) > kMaxChunks)
    return cudaErrorInvalidValue;
  p->slice_words = p->half ? p->sl / 2 : p->sl;
  const long long grid_u = 4LL * (2 * kBuf + 4);
  const long long lit_u = 4LL * kWarps * kALit;
  const long long tab_u = 3LL * sizeof(Tab);
  long long u = grid_u > lit_u ? grid_u : lit_u;
  u = up_to(u > tab_u ? u : tab_u, 16);
  const long long bm = up_to(4LL * (p->pr / 32), 16);
  const long long cnt = up_to(4LL * p->slice_words, 16);
  p->cnt_smem = kHead + bm + cnt + u <= optin;
  p->o_bm = kHead;
  p->o_cnt = kHead + bm;
  p->o_u = p->o_cnt + (p->cnt_smem ? cnt : 0);
  p->smem = p->o_u + u;
  if (p->smem > optin) return cudaErrorInvalidValue;
  long long p2 = 4;
  while (p2 < N) p2 <<= 1;
  p->starts = 0;
  p->pv = N;
  p->rc4 = 2LL * N;
  p->side = up_to(p->rc4 + (N + 3) / 4, 4);
  p->ring = up_to(p->side + p2, 4);
  p->hdr = p->ring + 4LL * (N + 1);
  p->litq = p->hdr + kHdrInts;
  p->dstq = p->litq + kALit;
  p->tiles = p->dstq + kADst;
  p->gcnt = up_to(p->tiles + (S + kPosTile - 1) / kPosTile + 1, 4);
  p->total = up_to(
      p->gcnt + (p->cnt_smem ? 0 : static_cast<long long>(c) * p->slice_words),
      4);
  return cudaSuccess;
}

// Half-bits of a symbol the previous parse did not use, in a table of
// `total` symbols: round(2 * min(15, log2f(total) + pad)), parse_dp's
// unseen_bits in float32.
__device__ __forceinline__ int unseen_q(int total, float pad) {
  const float bits = fminf(log2f(static_cast<float>(max(total, 1))) + pad,
                           15.0f);
  return static_cast<int>(rintf(2.0f * bits));
}

// ---- a group of whole warps of a block: the whole block (barrier 0) or
// warps of it behind a named barrier ----

__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

struct Grp {
  int t, n, id;        // thread in the group, threads, barrier
  long long* red;      // 2 kWarps words
  __device__ void sync() const {
    if (id == 0) __syncthreads();
    else named_sync(id, n);
  }
  __device__ int warp() const { return t >> 5; }
  __device__ int warps() const { return n >> 5; }
};

template <typename T>
__device__ T gsum(const Grp& g, T v) {
  v = warp_sum(v);
  T* r = reinterpret_cast<T*>(g.red);
  if ((g.t & 31) == 0) r[g.warp()] = v;
  g.sync();
  T s = 0;
  for (int i = 0; i < g.warps(); ++i) s += r[i];
  g.sync();
  return s;
}

// Two sums at once over the group (one pair of barriers; g.red holds two
// words a warp), in place.
__device__ void gsum2(const Grp& g, long long& a, long long& b) {
  a = warp_sum(a);
  b = warp_sum(b);
  if ((g.t & 31) == 0) {
    g.red[2 * g.warp()] = a;
    g.red[2 * g.warp() + 1] = b;
  }
  g.sync();
  long long sa = 0, sb = 0;
  for (int i = 0; i < g.warps(); ++i) {
    sa += g.red[2 * i];
    sb += g.red[2 * i + 1];
  }
  g.sync();
  a = sa;
  b = sb;
}

// Two maxima at once over the group (one pair of barriers), in place.
__device__ void gmax2(const Grp& g, int& a, int& b) {
  for (int o = 16; o; o >>= 1) {
    a = max(a, __shfl_xor_sync(kFull, a, o));
    b = max(b, __shfl_xor_sync(kFull, b, o));
  }
  int* r = reinterpret_cast<int*>(g.red);
  if ((g.t & 31) == 0) {
    r[2 * g.warp()] = a;
    r[2 * g.warp() + 1] = b;
  }
  g.sync();
  for (int i = 0; i < g.warps(); ++i) {
    a = max(a, r[2 * i]);
    b = max(b, r[2 * i + 1]);
  }
  g.sync();
}

// Ascending bitonic sort of a[0, m), m a power of two, over the group, as
// page_tables.cuh's bitonic_sort: the compare steps whose partners lie 64
// or more apart pass over the array with a group barrier each; the rest of
// a merge runs in registers, each warp on aligned blocks of 64 keys (lane
// l keys l and l + 32).
__device__ void gsort(const Grp& g, int* a, int m) {
  const int lane = g.t & 31;
  auto in_warp = [&](int k0, int k1, int top) {
    for (int b = g.warp() * 64; b < m; b += g.warps() * 64) {
      const int i0 = b + lane, i1 = i0 + 32;
      int x0 = i0 < m ? a[i0] : INT_MAX, x1 = i1 < m ? a[i1] : INT_MAX;
      for (int k = k0; k <= k1; k <<= 1) {
        for (int j = top ? top : k >> 1; j > 0; j >>= 1) {
          if (j == 32) {
            if ((x0 > x1) == ((i0 & k) == 0)) {
              const int t = x0;
              x0 = x1;
              x1 = t;
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
  g.sync();
  for (int k = 128; k <= m; k <<= 1) {
    for (int j = k >> 1; j > 32; j >>= 1) {
      for (int p = g.t; p < m / 2; p += g.n) {
        const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
        const int x = a[i], y = a[i + j];
        if ((x > y) == ((i & k) == 0)) {
          a[i] = y;
          a[i + j] = x;
        }
      }
      g.sync();
    }
    in_warp(k, k, 32);
    g.sync();
  }
}

// _lengths_from_hist over the group (count > 4 used symbols, total their
// sum): ceil(log2(total / count)) clipped to [1, 15], widened until Kraft
// holds, then three passes that shorten the count-ordered prefix of
// eligible symbols whose cost fits the slack. The used symbols are ranked
// by a sort of count << 10 | (1023 - symbol), descending (ascending on
// INT_MAX minus it).
__device__ void group_lengths(const Grp& g, Tab& tb, int A, int total,
                              int count) {
  const int t = max(total, 1);
  for (int i = g.t; i < A; i += g.n) {
    const int h = tb.hist[i];
    int l = 0;
    if (h > 0) {
      const int ratio = (t + h - 1) / h;
      l = min(max(bitlen(max(ratio - 1, 0)), 1), 15);
    }
    tb.lens[i] = l;
  }
  int units = 0;
  for (int it = 0; it < 15; ++it) {
    units = 0;
    for (int i = g.t; i < A; i += g.n)
      if (tb.lens[i] > 0) units += 1 << (15 - tb.lens[i]);
    units = gsum(g, units);
    if (units <= (1 << 15)) break;
    for (int i = g.t; i < A; i += g.n)
      if (tb.lens[i] > 0) tb.lens[i] = min(tb.lens[i] + 1, 15);
  }
  int slack = (1 << 15) - units;
  int m2 = 1;
  while (m2 < count) m2 <<= 1;
  if (g.t == 0) tb.nused = 0;
  g.sync();
  const unsigned below = (1u << (g.t & 31)) - 1u;
  for (int i0 = 0; i0 < A; i0 += g.n) {
    const int i = i0 + g.t;
    const bool u = i < A && tb.hist[i] > 0;
    const unsigned m = __ballot_sync(kFull, u);
    int at = 0;
    if ((g.t & 31) == 0 && m) at = atomicAdd(&tb.nused, __popc(m));
    at = __shfl_sync(kFull, at, 0);
    if (u)
      tb.key[at + __popc(m & below)] =
          INT_MAX - (tb.hist[i] << 10 | (1023 - i));
  }
  for (int i = count + g.t; i < m2; i += g.n) tb.key[i] = INT_MAX;
  g.sync();
  gsort(g, tb.key, m2);
  auto sym = [&](int r) { return 1023 - ((INT_MAX - tb.key[r]) & 1023); };
  // the three passes on the group's first warp (no group barrier), lane l
  // a contiguous run of ranks
  if (g.t < 32) {
    const int per = (count + 31) / 32;
    const int r0 = min(g.t * per, count), r1 = min(r0 + per, count);
    for (int pass = 0; pass < 3; ++pass) {
      int sum = 0;
      for (int r = r0; r < r1; ++r) {
        const int l = tb.lens[sym(r)];
        sum += l > 1 ? 1 << (15 - l) : 0;
      }
      int cum = warp_incl_scan(sum) - sum;
      unsigned pay = 0;
      int paid = 0;
      for (int r = r0; r < r1; ++r) {
        const int l = tb.lens[sym(r)];
        const int c = l > 1 ? 1 << (15 - l) : 0;
        cum += c;
        if (l > 1 && cum <= slack) {
          pay |= 1u << (r - r0);
          paid += c;
        }
      }
      paid = warp_sum(paid);
      for (int r = r0; r < r1; ++r)
        if (pay >> (r - r0) & 1) tb.lens[sym(r)] -= 1;
      slack -= paid;
    }
  }
  g.sync();
}

// _choose_table's code lengths of one table over the group (tb.hist
// filled): none for at most one used symbol, the decoder's fixed rows for
// two to four, else _lengths_from_hist. Returns the histogram's total.
__device__ int group_table(const Grp& g, Tab& tb, int A) {
  int used = 0, total = 0;
  for (int i = g.t; i < A; i += g.n) {
    used += tb.hist[i] > 0;
    total += tb.hist[i];
  }
  long long cnt2 = used, tot2 = total;
  gsum2(g, cnt2, tot2);
  const int count = static_cast<int>(cnt2);
  total = static_cast<int>(tot2);
  if (count > 4) {
    group_lengths(g, tb, A, total, count);
    return total;
  }
  for (int i = g.t; i < A; i += g.n) tb.lens[i] = 0;
  g.sync();
  if (count >= 2 && g.t < 32) {
    // the used symbols ascending, their counts, ranked by count
    // (descending, stable), lengths from the row of the count (and tsel)
    const int lane = g.t;
    int s4[4] = {A, A, A, A};
    int found = 0;
    for (int b = 0; b < A && found < 4; b += 32) {
      const bool u = b + lane < A && tb.hist[b + lane] > 0;
      unsigned m = __ballot_sync(kFull, u);
      while (m && found < 4) {
        const int s = b + __ffs(m) - 1;
        for (int k = 0; k < 4; ++k)
          if (k == found) s4[k] = s;
        ++found;
        m &= m - 1;
      }
    }
    if (lane == 0) {
      int c4[4], order[4], rank_of[4];
      for (int k = 0; k < 4; ++k) {
        c4[k] = s4[k] < A ? tb.hist[s4[k]] : 0;
        order[k] = k;
      }
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
      const int rows[16] = {1, 1, 0, 0, 1, 2, 2, 0, 1, 2, 3, 3, 2, 2, 2, 2};
      const int row = count == 2 ? 0 : count == 3 ? 1 : tsel ? 2 : 3;
      for (int k = 0; k < 4; ++k)
        if (s4[k] < A) tb.lens[s4[k]] = rows[4 * row + rank_of[k]];
    }
  }
  g.sync();
  return total;
}

// The lowest ring code whose distance is d (d >= 1) against the ring
// (r0, r1, r2, r3), or -1: the exact hits, then r0 -+ 1..3 (codes 4-9),
// then r1 -+ 1..3 (10-15), without branches.
__device__ __forceinline__ int ring_code(int d, int r0, int r1, int r2,
                                         int r3) {
  const int e0 = d - r0, e1 = d - r1;
  const int a0 = abs(e0), a1 = abs(e1);
  int code = a1 >= 1 && a1 <= 3 ? 8 + 2 * a1 + (e1 > 0) : -1;
  code = a0 >= 1 && a0 <= 3 ? 2 + 2 * a0 + (e0 > 0) : code;
  code = d == r3 ? 3 : code;
  code = d == r2 ? 2 : code;
  code = d == r1 ? 1 : code;
  return d == r0 ? 0 : code;
}

__global__ void __launch_bounds__(kThreads, 1)
    cost_tables_kernel(const uint8_t* __restrict__ pages,
                       const int32_t* __restrict__ in_sizes,
                       const int32_t* __restrict__ ins_g,
                       const int32_t* __restrict__ cpy_g,
                       const int32_t* __restrict__ dist_g,
                       const int32_t* __restrict__ ncmds_g, int S, int N,
                       Plan pl, int32_t* __restrict__ joint_e,
                       int32_t* __restrict__ joint_l,
                       int32_t* __restrict__ scr_g,
                       int32_t* __restrict__ rec) {
  extern __shared__ __align__(16) unsigned char dyn[];
  cg::cluster_group cluster = cg::this_cluster();
  const int c = pl.c;
  const int r = static_cast<int>(cluster.block_rank());
  const int page = blockIdx.x / c;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  Xchg& x = *reinterpret_cast<Xchg*>(dyn);
  Local& lc = *reinterpret_cast<Local*>(dyn + (sizeof(Xchg) + 15) / 16 * 16);
  unsigned* bm = reinterpret_cast<unsigned*>(dyn + pl.o_bm);
  unsigned* cnt_s = reinterpret_cast<unsigned*>(dyn + pl.o_cnt);
  unsigned char* u = dyn + pl.o_u;
  auto X = [&](int t) { return cluster.map_shared_rank(&x, t); };

  int32_t* scr = scr_g + static_cast<size_t>(page) * pl.total;
  const size_t row = static_cast<size_t>(page) * N;
  const uint8_t* pg = pages + static_cast<size_t>(page) * S;
  const int32_t* ins = ins_g + row;
  const int32_t* cpy = cpy_g + row;
  const int32_t* dist = dist_g + row;
  const int n = min(max(ncmds_g[page], 0), N);
  const int insz = in_sizes[page];
  const long long lim = min(static_cast<long long>(insz),
                            static_cast<long long>(S));
  int* starts = scr + pl.starts;
  int* pv = scr + pl.pv;
  unsigned* rc4 = reinterpret_cast<unsigned*>(scr + pl.rc4);
  int* side = scr + pl.side;
  int4* ring = reinterpret_cast<int4*>(scr + pl.ring);
  int* tiles = scr + pl.tiles;
  unsigned* gcnt = reinterpret_cast<unsigned*>(scr + pl.gcnt);
  unsigned* mine = pl.cnt_smem
                       ? cnt_s
                       : gcnt + static_cast<size_t>(r) * pl.slice_words;
  auto slice = [&](int t) {
    return pl.cnt_smem ? cluster.map_shared_rank(cnt_s, t)
                       : gcnt + static_cast<size_t>(t) * pl.slice_words;
  };
  auto bits_of = [](long long a, long long b) {   // bits a..b-1 of a word
    const unsigned hi = b >= 32 ? kFull : (1u << b) - 1u;
    return hi & ~((1u << a) - 1u);
  };
  // marks the positions [a, b) of the literal bitmap word at w0 in the CTA
  // whose share of the page holds them
  auto mark_lit = [&](long long a, long long b, long long w0) {
    const int o = static_cast<int>(w0 / pl.pr);
    atomicOr(cluster.map_shared_rank(bm, o) + (w0 - o * pl.pr) / 32,
             bits_of(max(a, w0) - w0, min(b, w0 + 32) - w0));
  };
  long long stamp[kRecPhases + 1];
  auto mark = [&](int k) {
    if (r == 0 && tid == 0) stamp[k] = clock64();
  };
  mark(0);

  // ---- what the cluster adds into starts at zero ----
  for (int i = tid; i < pl.slice_words; i += kThreads) mine[i] = 0;
  for (int i = tid; i < pl.pr / 32; i += kThreads) bm[i] = 0;
  for (int i = tid; i < kMaxChunks; i += kThreads)
    x.pc[i] = x.kk[i] = x.cl[i] = 0;
  int* hz = reinterpret_cast<int*>(&x.h);
  for (int i = tid; i < static_cast<int>(sizeof(x.h) / 4); i += kThreads)
    hz[i] = 0;
  if (tid == 0) {
    x.nside = x.nm = x.ge[0] = x.ge[1] = 0;
    x.nbk[0] = x.nbk[1] = 0;
  }

  // ---- pass 1: the share's bytes and ring pushes, its last pushes ----
  const int q = ((n + c - 1) / c + 3) & ~3;
  const int lo = min(r * q, n), hi = min(lo + q, n);
  auto is_copy = [&](int j) { return cpy[j] > 0 && dist[j] > 0; };
  auto ring0 = [&](int j) {
    return j == 0 ? 4 : (is_copy(j - 1) ? dist[j - 1] : 0);
  };
  auto pushes = [&](int j) { return is_copy(j) && dist[j] != ring0(j); };
  {
    long long cov = 0;
    int npush = 0;
    for (int j = lo + tid; j < hi; j += kThreads) {
      cov += static_cast<long long>(ins[j]) + cpy[j];
      npush += pushes(j);
    }
    long long np2 = npush;
    gsum2(Grp{tid, kThreads, 0, lc.red}, cov, np2);
    npush = static_cast<int>(np2);
    if (tid == 0) {
      x.cov = cov;
      x.push = npush;
    }
    if (w == 0) {
      int found = 0;
      for (int jb = hi - 1; jb >= lo && found < 3; jb -= 32) {
        const int j = jb - lane;
        const bool p = j >= lo && pushes(j);
        const int v = p ? ring0(j) : 0;
        unsigned m = __ballot_sync(kFull, p);
        while (m && found < 3) {
          const int val = __shfl_sync(kFull, v, __ffs(m) - 1);
          if (lane == 0) x.last3[found] = val;
          ++found;
          m &= m - 1;
        }
      }
      if (lane == 0) x.nlast = found;
    }
  }
  cluster.sync();   // (1) every share's totals; the counts are zero

  if (w == 0) {
    // lane t reads CTA t's totals: the bytes and pushes before the share,
    // and the last three values pushed before it (newest first)
    const bool in = lane < c;
    const Xchg* xt = X(in ? lane : 0);
    const long long cv = in ? xt->cov : 0;
    const int pu = in ? xt->push : 0, nl = in ? xt->nlast : 0;
    const int l0 = xt->last3[0], l1 = xt->last3[1], l2 = xt->last3[2];
    const long long cb = warp_sum(lane < r ? cv : 0LL);
    const long long call = warp_sum(cv);
    const int pb = warp_sum(lane < r ? pu : 0);
    int nc = 0, col[3] = {0, 0, 0};
    for (int t = r - 1; t >= 0 && nc < 3; --t) {
      const int nt = __shfl_sync(kFull, nl, t);
      const int v0 = __shfl_sync(kFull, l0, t);
      const int v1 = __shfl_sync(kFull, l1, t);
      const int v2 = __shfl_sync(kFull, l2, t);
      for (int k = 0; k < 3; ++k)
        if (k < nt && nc < 3) {
          const int v = k == 0 ? v0 : k == 1 ? v1 : v2;
          col[0] = nc == 0 ? v : col[0];
          col[1] = nc == 1 ? v : col[1];
          col[2] = nc == 2 ? v : col[2];
          ++nc;
        }
    }
    if (lane == 0) {
      // pvx(pb + k), the ring values the pushes before the share displaced
      for (int k = 0; k < 3; ++k) {
        const int i = pb + k;
        lc.carry[k] = i == 0 ? 16 : i == 1 ? 15 : i == 2 ? 11
                    : k == 0 ? col[2] : k == 1 ? col[1] : col[0];
      }
      lc.cov_base = cb;
      lc.cov_all = call;
      lc.push_base = pb;
      lc.nlong = 0;
    }
  }
  __syncthreads();
  mark(1);
  const long long covered = lc.cov_all;
  const int push_base = lc.push_base;
  auto pvx = [&](int i) {
    return i < push_base + 3 ? lc.carry[i - push_base] : pv[i - 3];
  };

  // ---- pass 2: starts, pushed values, the ring before each command, the
  // ring codes, the grid-search keys counted, the insert regions marked
  // in the literal bitmaps of the CTAs whose positions they cover, and the
  // command that covers each position tile's first byte. Tiles of kTile
  // commands, thread t the four from 4 t on ----
  {
    const int DR = c * pl.sl;
    long long at_byte = lc.cov_base;
    int pushed = push_base;
    for (int base = lo; base < hi; base += kTile) {
      const int j0 = base + 4 * tid;
      long long len[4], sum = 0;
      int np = 0;
      for (int k = 0; k < 4; ++k) {
        const int j = j0 + k;
        len[k] = 0;
        if (j < hi) {
          len[k] = static_cast<long long>(ins[j]) + cpy[j];
          np += pushes(j);
        }
        sum += len[k];
      }
      // one scan of both: a tile's pushes (at most kTile) in the low bits
      long long tot;
      const long long ex = block_excl_scan(sum << 12 | np, &tot, lc.red);
      const long long ltot = tot >> 12;
      const int ptot = static_cast<int>(tot & 4095);
      long long st = at_byte + (ex >> 12);
      const int t_first = pushed + static_cast<int>(ex & 4095);
      int t = t_first;
      for (int k = 0; k < 4; ++k) {
        const int j = j0 + k;
        if (j < hi) {
          starts[j] = static_cast<int>(st);
          // an insert region of more than 16 words goes to the block's
          // list, marked by all threads after the tiles
          const long long b = min(st + ins[j], lim);
          int slot = kLong;
          if (b - (st & ~31LL) > 512) slot = atomicAdd(&lc.nlong, 1);
          if (slot < kLong) {
            lc.longa[slot] = static_cast<int>(st);
            lc.longb[slot] = static_cast<int>(b);
          } else {
            for (long long w0 = st & ~31LL; w0 < b; w0 += 32)
              mark_lit(st, b, w0);
          }
          // the command that covers each position tile's first byte
          for (long long tb = (st + kPosTile - 1) / kPosTile * kPosTile;
               tb < st + len[k] && tb < S; tb += kPosTile)
            tiles[tb / kPosTile] = j;
          st += len[k];
          if (pushes(j)) pv[t++] = ring0(j);
        }
      }
      __syncthreads();
      t = t_first;
      unsigned rcw = 0;
      for (int k = 0; k < 4; ++k) {
        const int j = j0 + k;
        int rc = -1, d = 0;
        bool key = false;
        if (j < hi) {
          const int r0 = ring0(j);
          const int r1 = pvx(2 + t), r2 = pvx(1 + t), r3 = pvx(t);
          ring[j] = make_int4(r0, r1, r2, r3);
          d = dist[j];
          if (is_copy(j)) {
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
        }
        rcw |= static_cast<unsigned>(rc & 255) << (8 * k);
        // the key's count, in the slice that owns its distance: equal
        // distances of the warp add together, one atomic each
        const bool counted = key && d < DR;
        const int o = counted ? d / pl.sl : 0;
        const unsigned m = __match_any_sync(kFull, counted ? d : -1);
        if (counted && lane == __ffs(m) - 1) {
          const int i = d - o * pl.sl;
          unsigned* sp = slice(o);
          if (pl.half)
            atomicAdd(sp + (i >> 1), static_cast<unsigned>(__popc(m))
                                         << (16 * (i & 1)));
          else
            atomicAdd(sp + i, static_cast<unsigned>(__popc(m)));
        }
        if (key && d >= DR) side[atomicAdd(&X(0)->nside, 1)] = d;
      }
      if (j0 < hi) rc4[j0 >> 2] = rcw;
      at_byte += ltot;
      pushed += ptot;
    }
    __syncthreads();
    for (int i = 0; i < min(lc.nlong, kLong); ++i) {
      const long long a = lc.longa[i], b = lc.longb[i];
      for (long long w0 = (a & ~31LL) + 32LL * tid; w0 < b;
           w0 += 32LL * kThreads)
        mark_lit(a, b, w0);
    }
    // the ring after the last command, which the bytes past them inherit
    if (tid == 0 && (n > 0 ? lo <= n - 1 && n - 1 < hi : r == 0))
      ring[n] = make_int4(ring0(n), pvx(2 + pushed), pvx(1 + pushed),
                          pvx(pushed));
  }
  cluster.sync();   // (2) every key counted, every start written
  mark(2);

  // the distance counts in chunks of kChunk: thread t the eight from 8 t
  // on (a slice is a multiple of 64 distances: all eight inside it, or
  // none), from the slice of CTA o
  const int nch = (pl.sl + kChunk - 1) / kChunk;
  auto chunk_counts = [&](int o, int ch, int* cn) {
    const int i0 = ch * kChunk + 8 * tid;
    if (i0 >= pl.sl) {
      for (int k = 0; k < 8; ++k) cn[k] = 0;
      return;
    }
    const uint4* src = reinterpret_cast<const uint4*>(o == r ? mine : slice(o));
    if (pl.half) {
      const uint4 v = src[i0 >> 3];
      const unsigned wd[4] = {v.x, v.y, v.z, v.w};
      for (int k = 0; k < 4; ++k) {
        cn[2 * k] = wd[k] & 0xffff;
        cn[2 * k + 1] = wd[k] >> 16;
      }
    } else {
      const uint4 v0 = src[i0 >> 2], v1 = src[(i0 >> 2) + 1];
      cn[0] = v0.x; cn[1] = v0.y; cn[2] = v0.z; cn[3] = v0.w;
      cn[4] = v1.x; cn[5] = v1.y; cn[6] = v1.z; cn[7] = v1.w;
    }
  };
  // each chunk of this slice: its present distances, keys and largest
  // present distance
  for (int ch = 0; ch < nch; ++ch) {
    int cn[8], npres = 0, nk = 0, ld = 0;
    chunk_counts(r, ch, cn);
    for (int k = 0; k < 8; ++k)
      if (cn[k] > 0) {
        ++npres;
        nk += cn[k];
        ld = r * pl.sl + ch * kChunk + 8 * tid + k;
      }
    npres = warp_sum(npres);
    nk = warp_sum(nk);
    for (int o = 16; o; o >>= 1) ld = max(ld, __shfl_xor_sync(kFull, ld, o));
    if (lane == 0 && npres > 0) {
      atomicAdd(&x.pc[ch], npres);
      atomicAdd(&x.kk[ch], nk);
      atomicMax(&x.cl[ch], ld);
    }
  }
  cluster.sync();   // (2b) every chunk's totals
  if (w == 0) {
    // lane g reads chunk g of the cluster's counts (chunk g % nch of CTA
    // g / nch): the ranks and key positions before each chunk, the last
    // present distance before it and overall
    const bool in = lane < c * nch;
    const Xchg* xt = X(in ? lane / nch : 0);
    const int ch = in ? lane % nch : 0;
    const int pc = in ? xt->pc[ch] : 0, kk = in ? xt->kk[ch] : 0;
    const int cl = xt->cl[ch];
    const int rk = warp_incl_scan(pc) - pc, ps = warp_incl_scan(kk) - kk;
    int lastc = pc > 0 ? lane : -1;   // the last chunk with a distance
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, lastc, o);
      if (lane >= o) lastc = max(lastc, y);
    }
    int before = __shfl_up_sync(kFull, lastc, 1);
    before = lane ? before : -1;
    const int pd = __shfl_sync(kFull, cl, max(before, 0));
    const int all = __shfl_sync(kFull, lastc, 31);
    const int lastall = __shfl_sync(kFull, cl, max(all, 0));
    if (in) {
      lc.rank0[lane] = rk;
      lc.pos0[lane] = ps;
      lc.prevd[lane] = before >= 0 ? pd : -1;
    }
    const int M = warp_sum(pc), kc = warp_sum(kk);
    if (lane == 0) {
      lc.rank0[c * nch] = M;
      lc.pos0[c * nch] = kc;
      lc.M = M;
      lc.kc = kc;
      lc.lastall = all >= 0 ? lastall : -1;
      lc.nside = X(0)->nside;
    }
  }

  // ---- the literal histogram: this CTA's share of the page's positions,
  // the insert regions (marked in pass 2) and the tail, counted from the
  // page four bytes at a time into each warp's sub-histogram ----
  {
    int* subh = reinterpret_cast<int*>(u);
    const int P0 = r * pl.pr, P1 = min(P0 + pl.pr, S);
    for (int i = tid; i < kWarps * kALit; i += kThreads) subh[i] = 0;
    __syncthreads();
    const unsigned* pw = reinterpret_cast<const unsigned*>(pg);
    for (int p = P0 + 4 * tid; p < P1; p += 4 * kThreads) {
      unsigned nib = (bm[(p - P0) >> 5] >> ((p - P0) & 31)) & 15u;
      for (int k = 0; k < 4; ++k)
        if (p + k >= covered && p + k < lim) nib |= 1u << k;
      if (!nib) continue;
      const unsigned word = pw[p >> 2];
      for (int k = 0; k < 4; ++k)
        if (nib >> k & 1)
          atomicAdd(&subh[w * kALit + ((word >> (8 * k)) & 255)], 1);
    }
    __syncthreads();
    for (int v = tid; v < kALit; v += kThreads) {
      int h = 0;
      for (int k = 0; k < kWarps; ++k) h += subh[k * kALit + v];
      x.h.lit[v] = h;
    }
  }
  const int nside = lc.nside, kc = lc.kc, K = kc + nside;
  const double log2k = log2(static_cast<double>(max(K, 1)));
  lc.runc[tid] = run_cost(tid + 1, log2k);
  if (r == 0 && nside > 0) {
    int m2 = 4;
    while (m2 < nside) m2 <<= 1;
    for (int i = nside + tid; i < m2; i += kThreads) side[i] = INT_MAX;
    __syncthreads();
    bitonic_sort(side, m2);
  }
  __syncthreads();
  mark(3);

  // ---- the grid search: each CTA's share of the present distances, warp
  // g pricing grid point g; the leader prices the side list and joins the
  // shares' runs ----
  auto run = [&](int cnt) {
    return cnt <= kThreads ? lc.runc[cnt - 1] : run_cost(cnt, log2k);
  };
  int* ed = reinterpret_cast<int*>(u);   // present distances to price
  int* ep = ed + kBuf;                   // and their first key positions
  const int gnp = w >> 2, gnd = kGridNd[w & 3] << gnp;
  // runs over ed/ep[0, m) (ep[m] the key after them), lane l the elements
  // 4 l to 4 l + 3 of every 128: prev the previous key's symbol, open the
  // last run start, first the first; each lane's share of the costs
  auto price = [&](int m, int& prev, int& open, int& first, long long& cost,
                   long long& nbs) {
    for (int b = 0; b < m; b += 128) {
      const int e0 = b + 4 * lane;
      const int4 d4 = *reinterpret_cast<const int4*>(ed + e0);
      const int4 p4 = *reinterpret_cast<const int4*>(ep + e0);
      const int dv[4] = {d4.x, d4.y, d4.z, d4.w};
      const int pv4[5] = {p4.x, p4.y, p4.z, p4.w, ep[e0 + 4]};
      int s[4];
      for (int k = 0; k < 4; ++k) {
        s[k] = INT_MAX;
        if (e0 + k < m) {
          int nb;
          s[k] = key_sym(dv[k], gnp, gnd, &nb);
          nbs += static_cast<long long>(pv4[k + 1] - pv4[k]) * nb;
        }
      }
      int prv = __shfl_up_sync(kFull, s[3], 1);
      if (lane == 0) prv = prev;
      bool st[4];
      int last = -1, firstl = -1, mylast = prv;
      for (int k = 0; k < 4; ++k) {
        st[k] = e0 + k < m && s[k] < kADst && s[k] != prv;
        if (st[k]) {
          last = pv4[k];
          if (firstl < 0) firstl = pv4[k];
        }
        if (e0 + k < m) mylast = s[k];
        prv = s[k];
      }
      int upto = last;   // the last start at or before this lane's keys
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, upto, o);
        if (lane >= o) upto = max(upto, y);
      }
      int ps = __shfl_up_sync(kFull, upto, 1);
      ps = max(lane ? ps : -1, open);
      const unsigned fm = __ballot_sync(kFull, firstl >= 0 && ps < 0);
      if (fm && first < 0) first = __shfl_sync(kFull, firstl, __ffs(fm) - 1);
      for (int k = 0; k < 4; ++k)
        if (st[k]) {
          if (ps >= 0) cost += run(pv4[k] - ps);
          ps = pv4[k];
        }
      open = max(open, __shfl_sync(kFull, upto, 31));
      prev = __shfl_sync(kFull, mylast, (min(m, b + 128) - 1 - b) >> 2);
    }
  };
  {
    // this CTA prices the present distances of ranks [lo_r, hi_r) in
    // distance order, an equal share of the cluster's: the chunks that
    // hold them (in whichever CTA) compacted into the buffer, priced when
    // it is full and at the end
    const int M = lc.M;
    const int lo_r = static_cast<int>(static_cast<long long>(M) * r / c);
    const int hi_r = static_cast<int>(static_cast<long long>(M) * (r + 1) / c);
    int prev = -1, open = -1, first = -1;
    long long cost = 0, nbs = 0;
    int fill = 0, pd = -1;   // elements buffered; the key before the share
    bool started = false, carried = false;
    auto flush = [&]() {
      __syncthreads();
      if (!started) {
        if (carried) pd = lc.carryd;
        if (pd > 0) {
          int nb;
          prev = key_sym(pd, gnp, gnd, &nb);
        }
        started = true;
      }
      price(fill, prev, open, first, cost, nbs);
      __syncthreads();
      fill = 0;
    };
    const long long mask40 = (1LL << 40) - 1;
    // the chunks that hold the share, each one's counts loaded while the
    // one before is compacted
    int g0 = c * nch, g1 = -1;
    for (int g = 0; g < c * nch; ++g)
      if (lc.rank0[g + 1] > lo_r && lc.rank0[g] < hi_r) {
        g0 = min(g0, g);
        g1 = g;
      }
    int cn[8], nx[8] = {};
    if (g0 <= g1) chunk_counts(g0 / nch, g0 % nch, cn);
    for (int gch = g0; gch <= g1; ++gch) {
      if (gch < g1) chunk_counts((gch + 1) / nch, (gch + 1) % nch, nx);
      const int rk0 = lc.rank0[gch], rk1 = lc.rank0[gch + 1];
      const int s0 = max(lo_r, rk0), s1 = min(hi_r, rk1);
      if (s0 == lo_r) {
        // the share's first chunk: the key before it is the last distance
        // before the chunk, or the one before rank s0 inside it
        carried = s0 > rk0;
        pd = lc.prevd[gch];
      }
      const int o = gch / nch, ch = gch % nch;
      // the chunk's ranks [s0, s1) into the buffer, in pieces that fit
      for (int a0 = s0; a0 < s1;) {
        if (fill == kBuf) flush();
        const int a1 = min(s1, a0 + kBuf - fill);
        int npres = 0, nk = 0;
        for (int k = 0; k < 8; ++k) {
          npres += cn[k] > 0;
          nk += cn[k];
        }
        long long tot;
        const long long ex = block_excl_scan(
            (static_cast<long long>(npres) << 40) | nk, &tot, lc.red);
        int rank = rk0 + static_cast<int>(ex >> 40);
        int p = lc.pos0[gch] + static_cast<int>(ex & mask40);
        const int d0 = o * pl.sl + ch * kChunk + 8 * tid;
        const int at = fill - a0;
        for (int k = 0; k < 8; ++k)
          if (cn[k] > 0) {
            if (rank >= a0 && rank < a1) {
              ed[at + rank] = d0 + k;
              ep[at + rank] = p;
              if (rank == a1 - 1) ep[at + a1] = p + cn[k];
            }
            if (rank == s0 - 1 && s0 == lo_r) lc.carryd = d0 + k;
            ++rank;
            p += cn[k];
          }
        fill += a1 - a0;
        a0 = a1;
      }
      for (int k = 0; k < 8; ++k) cn[k] = nx[k];
    }
    if (fill > 0) flush();
    cost = warp_sum(cost);
    nbs = warp_sum(nbs);
    if (lane == 0) {
      x.F[w] = first;
      x.L[w] = open;
      x.part[w] = cost;
      x.nbs[w] = nbs;
    }
  }
  if (r == 0 && nside > 0) {
    int prev = -1, open = -1, first = -1;
    long long cost = 0, nbs = 0;
    if (lc.lastall > 0) {
      int nb;
      prev = key_sym(lc.lastall, gnp, gnd, &nb);
    }
    for (int b0 = 0; b0 < nside; b0 += kBuf) {
      const int m = min(kBuf, nside - b0);
      for (int i = tid; i < m; i += kThreads) {
        ed[i] = side[b0 + i];
        ep[i] = kc + b0 + i;
      }
      if (tid == 0) ep[m] = kc + b0 + m;
      __syncthreads();
      price(m, prev, open, first, cost, nbs);
      __syncthreads();
    }
    cost = warp_sum(cost);
    nbs = warp_sum(nbs);
    if (lane == 0) {
      lc.F[kMaxCluster][w] = first;
      lc.L[kMaxCluster][w] = open;
      lc.part[kMaxCluster][w] = cost;
      lc.nbs[kMaxCluster][w] = nbs;
    }
  }
  cluster.sync();   // (3) every slice priced
  if (r == 0) {
    for (int i = tid; i < c * kWarps; i += kThreads) {
      const int t = i / kWarps, g = i % kWarps;
      const Xchg* xt = X(t);
      lc.F[t][g] = xt->F[g];
      lc.L[t][g] = xt->L[g];
      lc.part[t][g] = xt->part[g];
      lc.nbs[t][g] = xt->nbs[g];
    }
    __syncthreads();
    if (tid < kWarps) {
      long long cost = 0, nb = 0;
      int prevL = -1;
      for (int t = 0; t <= kMaxCluster; ++t) {
        if (t < c || (t == kMaxCluster && nside > 0)) {
          cost += lc.part[t][tid];
          nb += lc.nbs[t][tid];
          if (lc.F[t][tid] >= 0) {
            if (prevL >= 0) cost += run(lc.F[t][tid] - prevL);
            prevL = lc.L[t][tid];
          }
        }
      }
      if (prevL >= 0) cost += run(K - prevL);
      lc.sgrid[tid] = cost + (nb << 16);
      if (rec)
        reinterpret_cast<long long*>(rec + static_cast<size_t>(page) *
                                               kRecInts + kRecPhases)[tid] =
            lc.sgrid[tid];
    }
    __syncthreads();
    if (tid == 0) {
      int best = 0;
      for (int g = 1; g < kWarps; ++g)
        if (lc.sgrid[g] < lc.sgrid[best]) best = g;
      x.best = best;
    }
  }
  cluster.sync();   // (4) the grid point chosen
  mark(4);
  const int best = X(0)->best;
  const int npostfix = best >> 2;
  const int ndirect = kGridNd[best & 3] << npostfix;

  // ---- ring mode, command and distance histograms of the share: the
  // distance histogram under both ring modes, chosen by its owner ----
  {
    int nm = 0, ge0 = 0, ge1 = 0;
    long long nbk0 = 0, nbk1 = 0;
    for (int base = lo; base < hi; base += kTile) {
      const int j0 = base + 4 * tid;
      const unsigned rcw = j0 < hi ? rc4[j0 >> 2] : 0u;
      for (int k = 0; k < 4; ++k) {
        const int j = j0 + k;
        int s0 = -1, s1 = -1, hc = -1, hd0 = -1, hd1 = -1;
        if (j < hi) {
          const int rc = static_cast<signed char>(rcw >> (8 * k));
          const int in = ins[j], cp = cpy[j], d = dist[j];
          int dnb;
          const int ds = dist_sym(max(d, 1), npostfix, ndirect, &dnb);
          if (cp > 0 && d > 0 && rc != 0) {
            ++nm;
            const bool exact = rc >= 1 && rc <= 3;
            s0 = exact ? rc : ds;
            s1 = rc >= 0 ? rc : ds;
            nbk0 += exact ? 0 : dnb;
            nbk1 += rc >= 0 ? 0 : dnb;
            if (s0 >= kADst) {
              ++ge0;
              s0 = -1;
            }
            if (s1 >= kADst) {
              ++ge1;
              s1 = -1;
            }
          }
          const int ic = ins_code(in), cc = cpy_code(cp);
          const bool use_last = rc == 0 && ic < 8 && cc < 16;
          const int prefix = combine_codes(ic, cc, use_last);
          if (prefix >= 0 && prefix < kACmd) hc = prefix;
          if (!use_last) {
            const int e0 = rc >= 0 && rc <= 3 ? rc : ds;
            const int e1 = rc >= 0 ? rc : ds;
            if (e0 >= 0 && e0 < kADst) hd0 = e0;
            if (e1 >= 0 && e1 < kADst) hd1 = e1;
          }
        }
        warp_count(x.h.dh[0], s0);
        warp_count(x.h.dh[1], s1);
        warp_count(x.h.cmd, hc);
        warp_count(x.h.dst[0], hd0);
        warp_count(x.h.dst[1], hd1);
      }
    }
    nm = warp_sum(nm);
    ge0 = warp_sum(ge0);
    ge1 = warp_sum(ge1);
    nbk0 = warp_sum(nbk0);
    nbk1 = warp_sum(nbk1);
    if (lane == 0) {
      atomicAdd(&x.nm, nm);
      atomicAdd(&x.ge[0], ge0);
      atomicAdd(&x.ge[1], ge1);
      atomicAdd(reinterpret_cast<unsigned long long*>(&x.nbk[0]),
                static_cast<unsigned long long>(nbk0));
      atomicAdd(reinterpret_cast<unsigned long long*>(&x.nbk[1]),
                static_cast<unsigned long long>(nbk1));
    }
    if (r == 0 && tid == 0) {
      // the tail's insert-only command and the sentinel
      const long long tail = insz - covered;
      if (tail > 0)
        atomicAdd(&x.h.cmd[kSentinel + ins_code(static_cast<int>(tail))], 1);
      atomicAdd(&x.h.cmd[kSentinel], 1);
    }
  }
  cluster.sync();   // (5) every histogram counted
  mark(5);

  // ---- the three tables: table T on CTA T, or on warp groups of a CTA
  // where the cluster has fewer than three (c 2: the command table on CTA
  // 0, distances and literals on CTA 1's two halves; c 1: warps 0-7, 8-11,
  // 12-15). The owner sums the cluster's histograms first ----
  int T = -1, gw0 = 0, gnw = kWarps;
  if (c >= 3) {
    if (r < 3) T = r;
  } else if (c == 2) {
    if (r == 0) {
      T = 0;
    } else {
      T = w < 8 ? 1 : 2;
      gw0 = w < 8 ? 0 : 8;
      gnw = 8;
    }
  } else {
    T = w < 8 ? 0 : w < 12 ? 1 : 2;
    gw0 = w < 8 ? 0 : w < 12 ? 8 : 12;
    gnw = w < 8 ? 8 : 4;
  }
  Tab* tabs = reinterpret_cast<Tab*>(u);
  Grp g{tid - 32 * gw0, 32 * gnw, gnw == kWarps ? 0 : 1 + T,
        T >= 0 ? tabs[T].red : lc.red};
  // the sum over the cluster of one word of each CTA's exchange (the
  // cluster's loads issued together)
  auto csum = [&](const int* mine_word) {
    int h = 0;
#pragma unroll
    for (int t = 0; t < kMaxCluster; ++t)
      if (t < c) h += *cluster.map_shared_rank(mine_word, t);
    return h;
  };
  if (T == 0) {
    for (int v = g.t; v < kACmd; v += g.n) tabs[0].hist[v] = csum(&x.h.cmd[v]);
  } else if (T == 2) {
    for (int v = g.t; v < kALit; v += g.n) tabs[2].hist[v] = csum(&x.h.lit[v]);
  } else if (T == 1) {
    // the ring mode: exact hits only, or the offset codes too
    Tab& tb = tabs[1];
    const int nm = csum(&x.nm);
    const int ge[2] = {csum(&x.ge[0]), csum(&x.ge[1])};
    long long nbk[2] = {0, 0};
#pragma unroll
    for (int t = 0; t < kMaxCluster; ++t)
      if (t < c) {
        const Xchg* xt = X(t);
        nbk[0] += xt->nbk[0];
        nbk[1] += xt->nbk[1];
      }
    int top0 = -1, top1 = -1;
    for (int v = g.t; v < kADst; v += g.n) {
      const int h0 = csum(&x.h.dh[0][v]), h1 = csum(&x.h.dh[1][v]);
      tb.hist[v] = h0;
      tb.lens[v] = h1;
      if (h0 > 0) top0 = v;
      if (h1 > 0) top1 = v;
    }
    gmax2(g, top0, top1);
    const double log2m = log2(static_cast<double>(max(nm, 1)));
    long long c0 = 0, c1 = 0;
    for (int v = g.t; v < kADst; v += g.n) {
      const int h0 = tb.hist[v], h1 = tb.lens[v];
      if (h0 > 0) c0 += run_cost(h0 + (v == top0 ? ge[0] : 0), log2m);
      if (h1 > 0) c1 += run_cost(h1 + (v == top1 ? ge[1] : 0), log2m);
    }
    gsum2(g, c0, c1);
    c0 += nbk[0] << 16;
    c1 += nbk[1] << 16;
    const int oc = c1 < c0;
    for (int v = g.t; v < kADst; v += g.n) tb.hist[v] = csum(&x.h.dst[oc][v]);
  }
  cluster.sync();   // (6) no CTA reads another's shared memory past here
  mark(6);
  if (T < 0) return;
  Tab& tb = tabs[T];
  const int A = T == 0 ? kACmd : T == 1 ? kADst : kALit;
  const int total = group_table(g, tb, A);
  mark(7);
  const int uq = unseen_q(total, T == 1 ? 4.0f : 2.0f);
  auto cost = [&](int i) { return tb.hist[i] > 0 ? 2 * tb.lens[i] : uq; };
  if (T == 2) {
    for (int i = g.t; i < kALit; i += g.n) scr[pl.litq + i] = cost(i);
  } else if (T == 1) {
    for (int i = g.t; i < kADst; i += g.n) scr[pl.dstq + i] = cost(i);
  } else {
    const size_t jrow = static_cast<size_t>(page) * kJoint;
    for (int i = g.t; i < kJoint; i += g.n) {
      const int ic = i / 24, cc = i % 24;
      joint_e[jrow + i] = cost(combine_codes(ic, cc, false));
      joint_l[jrow + i] = ic < 8 && cc < 16
                              ? cost(combine_codes(ic, cc, true))
                              : kInfQ;
    }
  }
  if (r == 0 && tid == 0) {
    mark(8);
    int* hdr = scr + pl.hdr;
    hdr[0] = n;
    hdr[1] = static_cast<int>(min(covered, static_cast<long long>(S)));
    hdr[2] = npostfix;
    hdr[3] = ndirect;
    if (rec)
      for (int k = 0; k < kRecPhases; ++k)
        rec[static_cast<size_t>(page) * kRecInts + k] =
            static_cast<int>(stamp[k + 1] - stamp[k]);
  }
}

// ---- the position kernel ----

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kLeft>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kLeft) : "memory");
}

struct PosSm {
  int4 rg[kSliceCap];                     // the tile's commands' rings
  int4 in[kPosWarps][2][2][64];           // a warp's base rows, two rounds
  int4 out[kPosWarps][3 * 32];            // a warp's output slab
  int4 ring_n;                            // the ring after the last command
  int st[kSliceCap];                      // the tile's commands' starts
  int lit[kALit];
  int dst[kADst];
  unsigned tile[kTileWords];              // the tile's bytes and 28 after
  int jlo, cnt, covered, npostfix, ndirect, size;
};

__global__ void __launch_bounds__(kPosThreads, 2)
    cost_positions_kernel(const uint8_t* __restrict__ pages,
                          const int32_t* __restrict__ in_sizes,
                          const int32_t* __restrict__ base_len,
                          const int32_t* __restrict__ base_dist, int S,
                          Plan pl, const int32_t* __restrict__ scr_g,
                          int32_t* __restrict__ litq,
                          int32_t* __restrict__ cand_len,
                          int32_t* __restrict__ cand_dist,
                          int32_t* __restrict__ dpackq) {
  extern __shared__ __align__(16) unsigned char dyn[];
  PosSm& sm = *reinterpret_cast<PosSm*>(dyn);
  const int page = blockIdx.y, t0 = blockIdx.x * kPosTile;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int32_t* scr = scr_g + static_cast<size_t>(page) * pl.total;
  const int* starts = scr + pl.starts;
  const int4* ring = reinterpret_cast<const int4*>(scr + pl.ring);
  const unsigned* pw =
      reinterpret_cast<const unsigned*>(pages + static_cast<size_t>(page) * S);
  const size_t row0 = static_cast<size_t>(page) * S;
  const int nwords = S >> 2;

  // a round of this warp's base rows (32 positions, 1 KB an array) into
  // shared memory, lane l the 16-byte chunks l and l + 32
  auto issue = [&](int k) {
    const int p0 = t0 + w * kPosWarpRows + 32 * k;
    for (int h = 0; h < 2; ++h) {
      const int ch = lane + 32 * h;
      if (p0 + (ch >> 1) < S) {
        const size_t at = (row0 + p0) * kBase + 4 * ch;
        cp16(&sm.in[w][k & 1][0][ch], base_len + at);
        cp16(&sm.in[w][k & 1][1][ch], base_dist + at);
      }
    }
    cp_commit();
  };
  issue(0);
  issue(1);
  for (int i = tid; i < kALit; i += kPosThreads) sm.lit[i] = scr[pl.litq + i];
  for (int i = tid; i < kADst; i += kPosThreads) sm.dst[i] = scr[pl.dstq + i];
  for (int i = tid; i < kTileWords; i += kPosThreads) {
    const int wi = (t0 >> 2) + i;
    sm.tile[i] = wi < nwords ? pw[wi] : 0u;
  }
  if (tid == 0) {
    // the commands that cover the tile: the one that covers its first
    // byte (the table kernel's record) to the one that covers the next
    // tile's, or the last
    const int n = scr[pl.hdr], covered = scr[pl.hdr + 1];
    const int* tiles = scr + pl.tiles;
    int jlo = 0, cnt = 0;
    if (n > 0 && t0 < covered) {
      jlo = tiles[blockIdx.x];
      cnt = (t0 + kPosTile < covered ? tiles[blockIdx.x + 1] : n - 1) - jlo +
            1;
    }
    sm.jlo = jlo;
    sm.cnt = cnt;
    sm.covered = covered;
    sm.npostfix = scr[pl.hdr + 2];
    sm.ndirect = scr[pl.hdr + 3];
    sm.size = min(in_sizes[page], S);
    sm.ring_n = ring[n];
  }
  __syncthreads();
  const int jlo = sm.jlo, cnt = sm.cnt;
  const bool kept = cnt <= kSliceCap;
  if (kept)
    for (int i = tid; i < cnt; i += kPosThreads) {
      sm.st[i] = starts[jlo + i];
      sm.rg[i] = ring[jlo + i];
    }
  __syncthreads();
  const int* st = kept ? sm.st : starts + jlo;
  const int4* rg = kept ? sm.rg : ring + jlo;
  const int covered = sm.covered, npostfix = sm.npostfix;
  const int ndirect = sm.ndirect, size = sm.size;

  for (int k = 0; k < kPosRounds; ++k) {
    if (k + 1 < kPosRounds) cp_wait<1>();
    else cp_wait<0>();
    __syncwarp();
    const int p0 = t0 + w * kPosWarpRows + 32 * k;
    const int pos = p0 + lane;
    const bool live = pos < S;
    int len[kSlots], dist[kSlots], packq[kSlots];
    if (live) {
      const int4* bl = &sm.in[w][k & 1][0][2 * lane];
      const int4* bd = &sm.in[w][k & 1][1][2 * lane];
      for (int h = 0; h < 2; ++h) {
        const int4 l4 = bl[h], d4 = bd[h];
        len[4 * h] = l4.x; len[4 * h + 1] = l4.y;
        len[4 * h + 2] = l4.z; len[4 * h + 3] = l4.w;
        dist[4 * h] = d4.x; dist[4 * h + 1] = d4.y;
        dist[4 * h + 2] = d4.z; dist[4 * h + 3] = d4.w;
      }
    }
    __syncwarp();
    if (k + 2 < kPosRounds) issue(k + 2);
    if (live) {
      const int o = pos - t0;
      litq[row0 + pos] = sm.lit[(sm.tile[o >> 2] >> (8 * (o & 3))) & 255];
      // the covering command's ring; the bytes past the commands take the
      // ring after the last one
      int4 rv = sm.ring_n;
      if (pos < covered) {
        int l = 0, h = cnt - 1;
        while (l < h) {
          const int mid = (l + h + 1) >> 1;
          if (st[mid] <= pos) l = mid;
          else h = mid - 1;
        }
        rv = rg[l];
      }
      const int rgs[4] = {rv.x, rv.y, rv.z, rv.w};
      // the ring probes, four bytes a compare: no byte at or past the
      // page's size decides a length; the four probes' source words are
      // loaded together, and the first differing word decides
      const int room = min(kProbe, size - pos);
      const int ash = 8 * (o & 3);
      unsigned a[5];
      for (int i = 0; i < 5; ++i) a[i] = sm.tile[(o >> 2) + i];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int rr = rgs[kk];
        const bool ok = rr >= 1 && pos - rr >= 0 && room > 0;
        const int src = ok ? pos - rr : 0, sw = src >> 2;
        const int bsh = 8 * (src & 3);
        unsigned b[5];
        for (int v = 0; v < 5; ++v)
          b[v] = sw + v < nwords ? __ldg(pw + sw + v) : 0u;
        int m = kProbe;
        for (int v = 3; v >= 0; --v) {
          const unsigned xv = __funnelshift_r(a[v], a[v + 1], ash) ^
                              __funnelshift_r(b[v], b[v + 1], bsh);
          if (xv) m = 4 * v + ((__ffs(xv) - 1) >> 3);
        }
        m = ok ? min(m, room) : 0;
        len[kBase + kk] = m >= 2 ? m : 0;
        dist[kBase + kk] = m >= 2 ? rr : 0;
      }
      for (int s = 0; s < kSlots; ++s) {
        int nb;
        const int sym = key_sym(max(dist[s], 1), npostfix, ndirect, &nb);
        int dq = (sym < kADst ? sm.dst[sym] : 80) + 2 * nb;
        const int rsym = dist[s] >= 1 ? ring_code(dist[s], rgs[0], rgs[1],
                                                  rgs[2], rgs[3])
                                      : -1;
        if (rsym >= 0) dq = min(dq, sm.dst[rsym]);
        packq[s] = (min(dq, kInfQ) << 1) | (rsym == 0);
      }
    }
    // each output's [32, 12] slab through shared memory, stored as
    // contiguous 16-byte lanes
    const int nrow = min(32, S - p0);
    auto store = [&](const int (&v)[kSlots], int32_t* outp) {
      if (live)
        for (int h = 0; h < 3; ++h)
          sm.out[w][3 * lane + h] =
              make_int4(v[4 * h], v[4 * h + 1], v[4 * h + 2], v[4 * h + 3]);
      __syncwarp();
      int4* dst = reinterpret_cast<int4*>(outp) + (row0 + p0) * 3;
      for (int ch = lane; ch < 3 * nrow; ch += 32) dst[ch] = sm.out[w][ch];
      __syncwarp();
    };
    if (nrow > 0) {
      store(len, cand_len);
      store(dist, cand_dist);
      store(packq, dpackq);
    }
  }
}

// The unseen-symbol half-bits of the totals 1..n (a check of unseen_q
// against the plain version's float32 cost, run by the tests and
// chip_smoke.py, never by a route).
__global__ void unseen_check_kernel(int n, float pad, int32_t* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = unseen_q(i + 1, pad);
}

int launch_error(cudaError_t e) {
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace blg_cost

// int32 words of scratch a page needs for P pages of S bytes and N command
// columns on the current device (-1 if the shapes do not fit).
extern "C" long long blg_cost_scratch_ints(int P, int N, int S) {
  blg_cost::Plan p;
  if (blg_cost::make_plan(P, N, S, &p) != cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  return p.total;
}

// CTAs a page of the table kernel (its cluster), and its dynamic shared
// memory a CTA in bytes, for P pages of S bytes and N command columns; the
// distance counts in shared memory (1) or in the scratch (0); -1 if the
// shapes do not fit.
extern "C" long long blg_cost_plan(int P, int N, int S, int what) {
  blg_cost::Plan p;
  if (blg_cost::make_plan(P, N, S, &p) != cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  return what == 0 ? p.c : what == 1 ? p.smem : p.cnt_smem;
}

// Dynamic shared memory of a block of the position kernel, in bytes.
extern "C" long long blg_cost_positions_smem() {
  return static_cast<long long>(sizeof(blg_cost::PosSm));
}

// Launch the table kernel over P pages: a cluster of blg_cost_plan(..., 0)
// CTAs a page. rec, when not null, receives each page's record (int32
// [P, 40]): clock cycles by phase (8), then the 16 grid points' costs
// (int64).
extern "C" int blg_cost_tables(const void* pages, const void* in_sizes,
                               const void* ins, const void* cpy,
                               const void* dist, const void* ncmds, int P,
                               int S, int N, void* joint_e, void* joint_l,
                               void* scratch, void* rec, void* stream) {
  using namespace blg_cost;
  if (P <= 0) return 0;
  Plan pl;
  cudaError_t e = make_plan(P, N, S, &pl);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(cost_tables_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(pl.smem));
  if (e != cudaSuccess) return launch_error(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.c * P, 1, 1);
  cfg.blockDim = dim3(blg_pack::kThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(pl.smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pl.c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(
      &cfg, cost_tables_kernel, static_cast<const uint8_t*>(pages),
      static_cast<const int32_t*>(in_sizes), static_cast<const int32_t*>(ins),
      static_cast<const int32_t*>(cpy), static_cast<const int32_t*>(dist),
      static_cast<const int32_t*>(ncmds), S, N, pl,
      static_cast<int32_t*>(joint_e), static_cast<int32_t*>(joint_l),
      static_cast<int32_t*>(scratch), static_cast<int32_t*>(rec));
  return launch_error(e);
}

// Launch the position kernel over P pages of S positions: a block a tile
// of kPosTile positions.
extern "C" int blg_cost_positions(const void* pages, const void* in_sizes,
                                  const void* base_len, const void* base_dist,
                                  int P, int S, int N, const void* scratch,
                                  void* litq, void* cand_len, void* cand_dist,
                                  void* dpackq, void* stream) {
  using namespace blg_cost;
  if (P <= 0 || S <= 0) return 0;
  Plan pl;
  cudaError_t e = make_plan(P, N, S, &pl);
  const int smem = static_cast<int>(sizeof(PosSm));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(cost_positions_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (e != cudaSuccess) return launch_error(e);
  const dim3 grid((S + kPosTile - 1) / kPosTile, P);
  cost_positions_kernel<<<grid, kPosThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(pages),
      static_cast<const int32_t*>(in_sizes),
      static_cast<const int32_t*>(base_len),
      static_cast<const int32_t*>(base_dist), S, pl,
      static_cast<const int32_t*>(scratch), static_cast<int32_t*>(litq),
      static_cast<int32_t*>(cand_len), static_cast<int32_t*>(cand_dist),
      static_cast<int32_t*>(dpackq));
  return launch_error(cudaSuccess);
}

// Write unseen_q(t, pad) for t = 1..n into out[0..n).
extern "C" int blg_cost_unseen_check(int n, float pad, void* out,
                                     void* stream) {
  if (n <= 0) return 0;
  blg_cost::unseen_check_kernel<<<(n + 255) / 256, 256, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      n, pad, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
