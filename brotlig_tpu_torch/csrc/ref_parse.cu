// The page parse of the scalar page encoder: the greedy parse with a
// one-step lazy match over 4-byte hash chains, for a batch of pages.
//
// Replaces no TPU kernel. The JAX package runs this parse in host Python
// (brotlig_tpu/refimpl/page_encoder.py:45, find_matches) for every
// preconditioned encode on its "cpu"/"auto" backends; the port runs it
// here, and serializes the pages on the host as the JAX package does.
// Plain version: refimpl/page_encoder.py::find_matches (a copy of the JAX
// function), a page at a time; wrapper: ops/ref_parse_kernel.py. The
// kernels compute exactly what find_matches computes:
//   * hash(p) = (quad(p) * 0x1E35A7BD mod 2^32) >> 15, 17 bits, over the
//     positions p <= n - 4 of a page of n bytes;
//   * the chain at q is every earlier position with q's hash, nearest
//     first, at most max_chain of them (find_matches inserts every
//     position exactly once and in order, and calls best(q) with exactly
//     the positions before q inserted, so the chain is a pure function of
//     the page);
//   * best(q) is (0, 0) when q + 4 > n; otherwise the first candidate in
//     chain order whose match with q is the longest, if that is >= 4 (a
//     candidate wins only when strictly longer than the best so far). A
//     length has no cap: its limit is n - q;
//   * the walk: at pos with best length b >= 4, take pos + 1 as a literal
//     when best(pos + 1) is longer than b + 1 (best(pos + 1) is (0, 0) when
//     pos + 1 = n); else emit (pos - anchor, b, distance) and jump by b.
//     Below 4, pos + 1. The tail is n - anchor.
// Since best is a pure function of the page, so is a step's successor:
// pos + 1 after a literal or a lazy step, pos + b after a command. The
// anchor only sets the insert lengths. A walk started at any position
// therefore follows the true walk exactly from the first loop-top position
// the two share.
//
// What bounds it on this card: chains of dependent steps. The bytes (each
// page read once, its commands written once) take microseconds, and the
// candidates the walk compares tens of nanoseconds more; the first design
// walked each page in one warp and took 22.4 ms on 8 config-3 pages, 97%
// of it the walk (0.6 ms the sort, a block a page; NVIDIA H100 80GB HBM3,
// 700 W). Its walk was paced by its instruction chain, not by memory: a
// 128 KiB page with max_chain 0, which loads no candidate, took ~130
// cycles a position. This design cuts that chain into segments walked at
// once and joins them exactly:
//
// Three launches a call:
//   * sort (a thread block cluster of 1, 2, 4 or 8 CTAs a page, the most
//     whose clusters all fit the card at once, 1024 threads each, the page
//     in each CTA's shared memory): a stable LSD radix sort of the
//     positions 0..n-4 by hash, two passes (the low 9 bits, then the high
//     8). Each warp counts the digits of a contiguous run of the positions
//     (shared-memory atomics, four rows of 32 in flight), the counts are
//     scanned over the warps (one thread a digit) and the cluster's CTAs
//     (each reads every CTA's digit totals in distributed shared memory),
//     and each position goes to its slot, equal digits of a row ranked by
//     one ballot a digit bit. Then each position's slot r and whether slot
//     r - 1 holds the same hash, as one word r << 1 | flag, and kStart on
//     each slot that starts its hash's run. With the sort the chain at q is
//     slots r - 1, r - 2, ... down to its run's start: a step reads 32
//     candidates in one coalesced load instead of chasing links;
//   * walk (speculative segment walkers): each page is cut into segments of
//     kSeg = 1024 positions, K = ceil(S / 1024): 64 on a 64 KiB page.
//     Walker k, a warp, runs the walk from its segment's first position
//     until it passes the segment's end, marking every loop-top position
//     it visits (lane i keeps word i of the segment's bitmap in a
//     register) and recording its commands (position, length, distance)
//     and its exit. The walkers of every page of a call run at once, W
//     warps a CTA (the page in its shared memory), W the least of 4, 8, 16
//     and 32 that gives no more CTAs than SMs (4 for 8 pages, 32 for a
//     64-page group). A segment of 1024 positions is one bitmap word a
//     lane; a walker's work is ~1/K of the page's and the join's ~K cheap
//     steps, and K = 64 fills the card's warps on a 64-page group. A step
//     is best(): 32 candidates a batch, a lane a candidate, its first 32
//     bytes compared eight at a time; a candidate that matches all 32 is
//     extended by the whole warp, 128 bytes a step, nearest first (zlib's
//     byte test against the longest so far skips the rest), so a zero page
//     costs a few hundred steps, not one lane's 16,000 compares; one
//     __reduce_max_sync of len << 5 | 31 - lane keeps the nearest of the
//     longest. The slot words of the next 32 positions sit in the lanes'
//     registers, and a run of positions with no chain (a ballot of their
//     flags) is passed as literals in one step;
//   * join (a 1024-thread block a page, the page and the marks in shared
//     memory): first every walker's continuation, in parallel (a warp a
//     walker): the walk from its exit until it lands on a position that
//     the walker of the segment it is in marked (there the two paths are
//     one), or passes that segment's end ("lost"). Then warp 0 follows the
//     true walk: it starts with walker 0 at position 0; after a walker's
//     commands from where the true walk met it and its continuation's, it
//     goes on with the walker whose mark the continuation met, at its
//     first command after that position. Segments that a match jumps over
//     are skipped. After a lost continuation warp 0 walks on its own (the
//     same step) until it meets a mark: never slower than the first
//     design's walk. It records the pieces (a walker's or a
//     continuation's commands from an index), their offsets by a running
//     count and the anchor before each; then the whole block copies the
//     pieces to the outputs, each command's insert length from the end of
//     the one before it, and writes ncmds (-1 past max_cmds) and tail.
//
// Where the tables live: the page in shared memory (each CTA its copy);
// the sort's output (8 bytes a position) in device memory at every page
// size, where a 64-page group's 33.5 MB stays in the 50 MB L2. A copy of
// the sorted positions in each walk and join CTA's shared memory (uint16
// up to 64 KiB pages; 128 KiB pages do not fit) cost about as much to make
// as it saved on the route's chains (max_chain 64), so there is none: a
// best() batch reads its 32 candidates in one coalesced load from L2. What
// remains is each walker's instruction chain (a best() batch is ~20
// dependent loads, shuffles and votes), and for a 64-page group the sort's
// two scatter passes (a third of the call).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace blg_rp {

constexpr uint32_t kHashMul = 0x1E35A7BDu;
constexpr int kHashShift = 32 - 17;
constexpr int kThreads = 1024;            // sort and join
constexpr int kWarps = kThreads / 32;
constexpr int kLoBits = 9;                // the sort's first pass
constexpr int kDigits = 1 << kLoBits;     // its digits (the second has 256)
constexpr int kPad = 16;                  // bytes past the page in smem
constexpr int kSeg = 1024;                // a walker's segment of positions
constexpr int kSegWords = kSeg / 32;      // its words of the marks bitmap
constexpr int kCap = kSeg / 4;            // its commands at most
constexpr int kMaxCluster = 8;
constexpr int kShort = 32;                // a lane's own compare, bytes
constexpr int kStart = -0x7FFFFFFF - 1;   // a sorted slot that starts its run
constexpr int kPosMask = 0x7FFFFFFF;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t hash_at(const uint8_t* page, int p) {
  const uint32_t quad = page[p] | (uint32_t(page[p + 1]) << 8) |
                        (uint32_t(page[p + 2]) << 16) |
                        (uint32_t(page[p + 3]) << 24);
  return (quad * kHashMul) >> kHashShift;
}

// Bytes a..a+3 of the page as a little-endian word (a + 4 <= S + kPad).
__device__ __forceinline__ uint32_t word_at(const uint32_t* w, int a) {
  const int i = a >> 2;
  return __funnelshift_r(w[i], w[i + 1], (a & 3) << 3);
}

// The common prefix of positions a and b, at most limit bytes; two words
// a step, their loads together.
__device__ __forceinline__ int match_len(const uint8_t* page, int a, int b,
                                         int limit) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(page);
  int l = 0;
  while (l + 8 <= limit) {
    const uint32_t x = word_at(w, a + l) ^ word_at(w, b + l);
    const uint32_t y = word_at(w, a + l + 4) ^ word_at(w, b + l + 4);
    if (x) return l + ((__ffs(x) - 1) >> 3);
    if (y) return l + 4 + ((__ffs(y) - 1) >> 3);
    l += 8;
  }
  while (l < limit && page[a + l] == page[b + l]) ++l;
  return l;
}

// The common prefix of positions a and b (a < b), at most limit bytes,
// given that it is at least l: the warp compares 128 bytes a step, four a
// lane.
__device__ __forceinline__ int warp_match(const uint8_t* page, int a, int b,
                                          int l, int limit, int lane) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(page);
  while (true) {
    const int o = l + 4 * lane;
    uint32_t x = 0;
    if (o < limit) {
      x = word_at(w, a + o) ^ word_at(w, b + o);
      if (o + 4 > limit) x |= kFull << (8 * (limit - o));   // past limit
    }
    const unsigned bad = __ballot_sync(kFull, o >= limit || x != 0);
    if (bad) {
      const int f = __ffs(bad) - 1;
      const uint32_t xf = __shfl_sync(kFull, x, f);
      const int of = l + 4 * f;
      return of >= limit ? limit : of + ((__ffs(xf) - 1) >> 3);
    }
    l += 128;
  }
}

// Row `row` of pages into shared memory, 16 bytes a thread a step; kPad
// zero bytes after it.
__device__ __forceinline__ void load_page(const uint8_t* pages, int row,
                                          int S, uint8_t* page) {
  const uint4* src =
      reinterpret_cast<const uint4*>(pages + static_cast<size_t>(row) * S);
  uint4* dst = reinterpret_cast<uint4*>(page);
#pragma unroll 8
  for (int i = threadIdx.x; i < S / 16; i += blockDim.x) dst[i] = src[i];
  if (threadIdx.x < kPad / 16)
    dst[S / 16 + threadIdx.x] = make_uint4(0, 0, 0, 0);
}

__device__ __forceinline__ int page_size(const int32_t* sizes, int row,
                                         int S) {
  const int n = sizes[row];
  return n < 0 ? 0 : (n > S ? S : n);
}

__host__ __device__ __forceinline__ int segments(int S) {
  return (S + kSeg - 1) / kSeg;
}

// ---------------------------------------------------------------------------
// sort: a cluster of nc CTAs a page
// ---------------------------------------------------------------------------

// The lanes of the warp whose digit (of `bits` bits) equals this lane's,
// among the valid ones: one ballot a bit.
__device__ __forceinline__ unsigned digit_peers(uint32_t digit, bool valid,
                                                int bits) {
  unsigned peers = __ballot_sync(kFull, valid);
#pragma unroll
  for (int bit = 0; bit < bits; ++bit) {
    const bool set = (digit >> bit) & 1;
    const unsigned b = __ballot_sync(kFull, set);
    peers &= set ? b : ~b;
  }
  return peers;
}

// The exclusive prefix sum of v over the block's kThreads threads (sums:
// kWarps ints of shared memory).
__device__ int block_exclusive(int v, int* sums) {
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  int incl = v;
  for (int off = 1; off < 32; off <<= 1) {
    const int x = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += x;
  }
  if (lane == 31) sums[wid] = incl;
  __syncthreads();
  if (wid == 0) {
    const int x = sums[lane];
    int run = x;
    for (int off = 1; off < kWarps; off <<= 1) {
      const int y = __shfl_up_sync(kFull, run, off);
      if (lane >= off) run += y;
    }
    sums[lane] = run - x;
  }
  __syncthreads();
  const int out = incl - v + sums[wid];
  __syncthreads();
  return out;
}

// One stable pass over the elements [0, m): this CTA's part of them, warp
// wid a contiguous run, counted by digit into cnt[wid][digit]; each digit's
// start over the cluster (every CTA's totals), then each element to its
// slot of dst. Pass 0 reads the positions themselves and sorts by the low
// kLoBits of the hash; pass 1 reads src (pass 0's order) and sorts by the
// high bits. A warp takes kUnroll rows of 32 elements at once: their loads,
// hashes and digit peers are independent.
template <int kPass>
__device__ void sort_pass(const uint8_t* page, int m, const int32_t* src,
                          int32_t* dst, int* cnt, int* tot, int* sums,
                          cg::cluster_group& cluster) {
  constexpr int kBits = kPass == 0 ? kLoBits : 17 - kLoBits;
  constexpr int kUnroll = 4;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int nc = static_cast<int>(cluster.num_blocks());
  const int r = static_cast<int>(cluster.block_rank());
  const int part = (m + nc - 1) / nc;
  const int q = (part + kWarps - 1) / kWarps;
  const int lo = r * part + wid * q;
  const int hi = min(min(m, (r + 1) * part), lo + q);
  auto digit = [&](int p) {
    const uint32_t h = hash_at(page, p);
    return kPass == 0 ? h & (kDigits - 1) : h >> kLoBits;
  };
  for (int j = tid; j < kWarps * kDigits; j += kThreads) cnt[j] = 0;
  __syncthreads();
  for (int e0 = lo + lane; e0 - lane < hi; e0 += 32 * kUnroll) {
    int p[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = e0 + 32 * u;
      p[u] = e < hi ? (kPass == 0 ? e : src[e]) : -1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (p[u] >= 0) atomicAdd(&cnt[wid * kDigits + int(digit(p[u]))], 1);
  }
  __syncthreads();
  if (tid < (1 << kBits)) {
    int run = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = cnt[w * kDigits + tid];
      cnt[w * kDigits + tid] = run;
      run += c;
    }
    tot[tid] = run;
  }
  cluster.sync();   // every CTA's digit totals
  int all = 0, before = 0;
  if (tid < (1 << kBits)) {
    for (int t = 0; t < nc; ++t) {
      const int v = t == r ? tot[tid] : cluster.map_shared_rank(tot, t)[tid];
      all += v;
      if (t < r) before += v;
    }
  }
  const int start =
      block_exclusive(tid < (1 << kBits) ? all : 0, sums) + before;
  if (tid < (1 << kBits))
    for (int w = 0; w < kWarps; ++w) cnt[w * kDigits + tid] += start;
  __syncthreads();
  const unsigned below = (1u << lane) - 1;
  for (int e0 = lo + lane; e0 - lane < hi; e0 += 32 * kUnroll) {
    int p[kUnroll];
    uint32_t d[kUnroll];
    unsigned peers[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = e0 + 32 * u;
      p[u] = e < hi ? (kPass == 0 ? e : src[e]) : -1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) d[u] = p[u] >= 0 ? digit(p[u]) : 0;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      peers[u] = digit_peers(d[u], p[u] >= 0, kBits);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool ok = p[u] >= 0;
      int slot = 0;
      if (ok) slot = cnt[wid * kDigits + d[u]] + __popc(peers[u] & below);
      __syncwarp();
      if (ok && lane == __ffs(peers[u]) - 1)
        cnt[wid * kDigits + d[u]] += __popc(peers[u]);
      __syncwarp();
      if (ok) dst[slot] = p[u];
    }
  }
  cluster.sync();   // every slot written, by every CTA; tot free again
}

// scratch: int32 [P, 2, S]; writes row b's positions by hash (stable) to
// [b, 0], kStart set on each slot that starts its hash's run, and each
// position's slot word r << 1 | chained to [b, 1].
__global__ void __launch_bounds__(kThreads, 1)
sort_kernel(const uint8_t* __restrict__ pages, const int32_t* __restrict__ sizes,
            int S, int32_t* __restrict__ scratch) {
  extern __shared__ uint4 smem_u4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int nc = static_cast<int>(cluster.num_blocks());
  const int r = static_cast<int>(cluster.block_rank());
  const int row = blockIdx.x / nc;
  uint8_t* page = reinterpret_cast<uint8_t*>(smem_u4);
  int* cnt = reinterpret_cast<int*>(page + S + kPad);   // [warps][digits]
  int* tot = cnt + kWarps * kDigits;                    // [digits]
  int* sums = tot + kDigits;                            // [warps]
  const int n = page_size(sizes, row, S);
  const int m = n >= 4 ? n - 3 : 0;                     // hashed positions
  int32_t* A = scratch + static_cast<size_t>(row) * 2 * S;
  int32_t* B = A + S;
  load_page(pages, row, S, page);
  __syncthreads();
  sort_pass<0>(page, m, nullptr, B, cnt, tot, sums, cluster);
  sort_pass<1>(page, m, B, A, cnt, tot, sums, cluster);
  // slot words: B[p] = r << 1 | (slot r - 1 holds p's hash); a slot that
  // starts its hash's run gets kStart in A (its neighbour reads A[r - 1]
  // masked)
  const int part = (m + nc - 1) / nc;
  for (int i = r * part + threadIdx.x; i < min(m, (r + 1) * part);
       i += kThreads) {
    const int p = A[i];
    const bool chained =
        i > 0 && hash_at(page, A[i - 1] & kPosMask) == hash_at(page, p);
    B[p] = (i << 1) | int(chained);
    if (!chained) A[i] = p | kStart;
  }
}

// ---------------------------------------------------------------------------
// the walk's step, shared by the walkers, the continuations and the join
// ---------------------------------------------------------------------------

struct Walker {
  const uint8_t* page;        // shared memory, kPad zero bytes past it
  const int32_t* sorted;      // positions by hash, stable; kStart on each
                              // slot that starts its hash's run
  const int32_t* slots;       // r << 1 | chained, by position
  int n, m, max_chain, lane;
  int wbase, wslot;           // the slot words of positions wbase + lane
  unsigned wchain;            // which of them have a chain

  __device__ void init(const uint8_t* pg, const int32_t* so,
                       const int32_t* sl, int n_, int chain) {
    page = pg;
    sorted = so;
    slots = sl;
    n = n_;
    m = n_ >= 4 ? n_ - 3 : 0;
    max_chain = chain;
    lane = threadIdx.x & 31;
    wbase = -64;
    wslot = 0;
    wchain = 0;
  }

  __device__ void window(int q) {
    if (q < wbase || q >= wbase + 32) {
      wbase = q;
      wslot = q + lane < m ? slots[q + lane] : 0;
      wchain = __ballot_sync(kFull, max_chain > 0 && (wslot & 1));
    }
  }

  // The positions from q on whose best is (0, 0) without a candidate (no
  // chain: the hash is new, q + 4 > n or max_chain is 0): 0 to 32 of them.
  __device__ int unchained_run(int q) {
    window(q);
    const int o = q - wbase;
    const unsigned ahead = wchain >> o;
    return ahead ? __ffs(ahead) - 1 : 32 - o;
  }

  // best(q) = (length, distance), warp-uniform.
  __device__ int2 best(int q) {
    if (q + 4 > n || max_chain <= 0) return make_int2(0, 0);
    window(q);
    const int word = __shfl_sync(kFull, wslot, q - wbase);
    if (!(word & 1)) return make_int2(0, 0);
    const int r = word >> 1;
    const int limit = n - q;
    int best_len = 0, best_dist = 0;
    for (int k0 = 1; k0 <= max_chain && k0 <= r; k0 += 32) {
      const int k = k0 + lane;
      const bool in = k <= max_chain && k <= r;
      const int e = in ? sorted[r - k] : 0;
      const int c = e & kPosMask;
      // the chain ends with the slot that starts q's hash's run
      const unsigned starts = __ballot_sync(kFull, in && e < 0);
      const int count = min(__popc(__ballot_sync(kFull, in)),
                            starts ? __ffs(starts) : 32);
      int len = 0;
      const bool test =
          lane < count && (best_len == 0 ||
                           (best_len < limit &&
                            page[c + best_len] == page[q + best_len]));
      if (test) len = match_len(page, c, q, min(limit, kShort));
      // candidates whose first kShort bytes match: the warp extends them,
      // nearest first; one that cannot beat an earlier one of the batch
      // (zlib's test at that one's length) keeps its prefix
      unsigned longs = __ballot_sync(kFull, test && len == kShort &&
                                                kShort < limit);
      int run_max = 0;
      while (longs) {
        const int l = __ffs(longs) - 1;
        longs &= longs - 1;
        const int cl = __shfl_sync(kFull, c, l);
        if (run_max > 0 && (run_max >= limit ||
                            page[cl + run_max] != page[q + run_max]))
          continue;
        const int ext = warp_match(page, cl, q, kShort, limit, lane);
        if (lane == l) len = ext;
        run_max = max(run_max, ext);
      }
      const unsigned key = len >= 4 && len > best_len
                               ? (unsigned(len) << 5) | unsigned(31 - lane)
                               : 0u;
      const unsigned top = __reduce_max_sync(kFull, key);
      if (top) {
        best_len = int(top >> 5);
        best_dist = q - __shfl_sync(kFull, c, 31 - int(top & 31));
      }
      if (starts || count < 32) break;
    }
    return make_int2(best_len, best_dist);
  }
};

// The walk from loop-top position pos, all lanes together, until the stop
// rule holds. stop.until(a, b), for a run [a, b) of at most 32 loop-top
// positions the walk passes in turn, returns the first of them at which the
// walk stops (b if none) and records the ones before it as visited.
// emit(pos, len, dist) takes each command. Returns the position where the
// walk stopped.
template <class W, class Stop, class Emit>
__device__ int walk_from(W& w, int pos, Stop& stop, Emit& emit) {
  int kept_q = -1;
  int2 kept = make_int2(0, 0);
  while (true) {
    const int run = kept_q == pos ? 0 : w.unchained_run(pos);
    const int span = run > 0 ? run : 1;
    const int t = stop.until(pos, pos + span);
    if (t < pos + span) return t;
    if (run > 0) {   // literals: no position of the run has a chain
      pos += run;
      continue;
    }
    const int2 b = kept_q == pos ? kept : w.best(pos);
    if (b.x >= 4) {
      kept = pos + 1 < w.n ? w.best(pos + 1) : make_int2(0, 0);
      kept_q = pos + 1;
      if (kept.x > b.x + 1) {
        ++pos;
        continue;
      }
      emit(pos, b.x, b.y);
      pos += b.x;
    } else {
      ++pos;
    }
  }
}

// The first set bit of a bitmap in [a, b), or b; b - a <= 32.
__device__ __forceinline__ int first_set(const uint32_t* bm, int a, int b) {
  while (a < b) {
    const uint32_t v = bm[a >> 5] >> (a & 31);
    if (v) return min(b, a + __ffs(v) - 1);
    a = (a | 31) + 1;
  }
  return b;
}

__device__ __forceinline__ bool bit_at(const uint32_t* bm, int p) {
  return (bm[p >> 5] >> (p & 31)) & 1;
}

// A walker's rule: stop at its segment's end hi; mark the positions before
// it. Lane i keeps word i of the segment's marks (positions lo + 32 i on)
// in a register.
struct SegStop {
  uint32_t bits;
  int lo, hi, lane;
  __device__ int until(int a, int b) {
    if (a >= hi) return a;
    const int t = min(b, hi);
    const int s = max(a - lo - 32 * lane, 0), e = min(t - lo - 32 * lane, 32);
    if (s < e) bits |= e - s == 32 ? kFull : ((1u << (e - s)) - 1) << s;
    return t;
  }
};

// A continuation's and the join's own walk's rule: stop at a position a
// walker marked, or at lim (the end of the segment where a continuation
// started, or n).
struct JoinStop {
  const uint32_t* marks;      // the page's, by position
  int lim;
  __device__ int until(int a, int b) {
    return a >= lim ? a : first_set(marks, a, min(b, lim));
  }
};

// Commands into a list: position, length, distance rows of kCap.
struct ListEmit {
  int32_t* list;
  int count, last_end;
  __device__ void operator()(int pos, int len, int dist) {
    if (threadIdx.x % 32 == 0) {
      list[count] = pos;
      list[kCap + count] = len;
      list[2 * kCap + count] = dist;
    }
    ++count;
    last_end = pos + len;
  }
};

// Commands straight to a page's outputs (the join's own walk).
struct OutEmit {
  int32_t *ins, *cpy, *dist;
  int max_cmds, nc, anchor;
  __device__ void operator()(int pos, int len, int d) {
    if (threadIdx.x % 32 == 0 && nc < max_cmds) {
      ins[nc] = pos - anchor;
      cpy[nc] = len;
      dist[nc] = d;
    }
    ++nc;
    anchor = pos + len;
  }
};

// ---------------------------------------------------------------------------
// walk: the segment walkers, W warps a CTA, a page's walkers over
// ceil(K / W) CTAs
// ---------------------------------------------------------------------------

// segs int32 [P, K, 4]: each walker's command count, exit, last command's
// end (-1 without one); marks uint32 [P, K, kSegWords]; lists int32 [P, K,
// 2, 3, kCap]: the walker's commands (then its continuation's, from the
// join).
__global__ void __launch_bounds__(kThreads)
walk_kernel(const uint8_t* __restrict__ pages, const int32_t* __restrict__ sizes,
            int S, int max_chain, int ctas_per_page,
            const int32_t* __restrict__ table, int32_t* __restrict__ segs,
            uint32_t* __restrict__ marks, int32_t* __restrict__ lists) {
  extern __shared__ uint4 smem_u4[];
  uint8_t* page = reinterpret_cast<uint8_t*>(smem_u4);
  const int K = segments(S);
  const int W = blockDim.x / 32, warp = threadIdx.x / 32,
            lane = threadIdx.x % 32;
  const int row = blockIdx.x / ctas_per_page;
  const int k = (blockIdx.x % ctas_per_page) * W + warp;
  const int n = page_size(sizes, row, S);
  const int32_t* sorted = table + static_cast<size_t>(row) * 2 * S;
  load_page(pages, row, S, page);
  __syncthreads();
  if (k >= K) return;
  const int lo = k * kSeg, hi = min(lo + kSeg, n);
  const size_t seg = static_cast<size_t>(row) * K + k;
  Walker w;
  w.init(page, sorted, sorted + S, n, max_chain);
  ListEmit emit{lists + seg * 6 * kCap, 0, -1};
  SegStop stop{0u, lo, hi, lane};
  const int x = lo < n ? walk_from(w, lo, stop, emit) : lo;
  marks[seg * kSegWords + lane] = stop.bits;
  if (lane == 0) {
    segs[seg * 4] = emit.count;
    segs[seg * 4 + 1] = x;
    segs[seg * 4 + 2] = emit.last_end;
  }
}

// ---------------------------------------------------------------------------
// join: a 1024-thread block a page
// ---------------------------------------------------------------------------

// The commands of walker k's list (cnt of them) before position y, by the
// warp.
__device__ int list_index(const int32_t* list, int cnt, int y) {
  int idx = 0;
  for (int i0 = 0; i0 < cnt; i0 += 32) {
    const int i = i0 + int(threadIdx.x % 32);
    idx += __popc(__ballot_sync(kFull, i < cnt && list[i] < y));
  }
  return idx;
}

__global__ void __launch_bounds__(kThreads, 1)
join_kernel(const uint8_t* __restrict__ pages, const int32_t* __restrict__ sizes,
            int S, int max_chain, int max_cmds,
            const int32_t* __restrict__ table, const int32_t* __restrict__ segs,
            const uint32_t* __restrict__ marks_g, int32_t* __restrict__ lists,
            int32_t* __restrict__ ins, int32_t* __restrict__ cpy,
            int32_t* __restrict__ dist, int32_t* __restrict__ ncmds,
            int32_t* __restrict__ tail) {
  extern __shared__ uint4 smem_u4[];
  const int K = segments(S);
  const int row = blockIdx.x, tid = threadIdx.x, warp = tid / 32,
            lane = tid % 32;
  uint8_t* page = reinterpret_cast<uint8_t*>(smem_u4);
  uint32_t* marks = reinterpret_cast<uint32_t*>(page + S + kPad);  // [K*32]
  int* cnt = reinterpret_cast<int*>(marks + K * kSegWords);
  int* ex = cnt + K;         // each walker's exit
  int* lend = ex + K;        // its last command's end
  int* ccnt = lend + K;      // its continuation's commands
  int* cend = ccnt + K;      // where the continuation stopped
  int* clend = cend + K;     // its last command's end
  int* cidx = clend + K;     // the met walker's commands before cend
  int* pkind = cidx + K;     // pieces: list (k, or K + k: a continuation)
  int* pidx = pkind + 2 * K;           // first command
  int* pcnt = pidx + 2 * K;            // commands
  int* poff = pcnt + 2 * K;            // offset in the outputs
  int* panchor = poff + 2 * K;         // the anchor before it
  int* totals = panchor + 2 * K;       // pieces, commands, final anchor
  const int n = page_size(sizes, row, S);
  const size_t seg0 = static_cast<size_t>(row) * K;
  int32_t* plists = lists + seg0 * 6 * kCap;
  const int32_t* sorted = table + static_cast<size_t>(row) * 2 * S;
  load_page(pages, row, S, page);
  for (int i = tid; i < K * kSegWords; i += kThreads)
    marks[i] = marks_g[seg0 * kSegWords + i];
  for (int k = tid; k < K; k += kThreads) {
    cnt[k] = segs[(seg0 + k) * 4];
    ex[k] = segs[(seg0 + k) * 4 + 1];
    lend[k] = segs[(seg0 + k) * 4 + 2];
  }
  __syncthreads();
  Walker w;
  w.init(page, sorted, sorted + S, n, max_chain);
  // the continuations, a warp a walker
  for (int k = warp; k < K; k += kWarps) {
    const int x = ex[k];
    int y = n, c = 0, last = -1, idx = 0;
    if (k * kSeg < n && x < n) {
      JoinStop stop{marks, min((x / kSeg + 1) * kSeg, n)};
      ListEmit emit{plists + (static_cast<size_t>(k) * 6 + 3) * kCap, 0, -1};
      y = walk_from(w, x, stop, emit);
      c = emit.count;
      last = emit.last_end;
      if (y < n && bit_at(marks, y))
        idx = list_index(plists + static_cast<size_t>(y / kSeg) * 6 * kCap,
                         cnt[y / kSeg], y);
    }
    if (lane == 0) {
      ccnt[k] = c;
      cend[k] = y;
      clend[k] = last;
      cidx[k] = idx;
    }
  }
  __syncthreads();
  // the true walk, by warp 0
  if (warp == 0) {
    int np = 0;
    OutEmit out{ins + static_cast<size_t>(row) * max_cmds,
                cpy + static_cast<size_t>(row) * max_cmds,
                dist + static_cast<size_t>(row) * max_cmds, max_cmds, 0, 0};
    auto piece = [&](int kind, int first, int count) {
      if (lane == 0) {
        pkind[np] = kind;
        pidx[np] = first;
        pcnt[np] = count;
        poff[np] = out.nc;
        panchor[np] = out.anchor;
      }
      ++np;
      out.nc += count;
    };
    int k = 0, idx = 0;
    while (n > 0) {
      if (cnt[k] > idx) {
        piece(k, idx, cnt[k] - idx);
        out.anchor = lend[k];
      }
      if (ex[k] >= n) break;
      if (ccnt[k] > 0) {
        piece(K + k, 0, ccnt[k]);
        out.anchor = clend[k];
      }
      int y = cend[k];
      idx = cidx[k];
      if (y < n && !bit_at(marks, y)) {   // lost: walk on until a mark
        JoinStop stop{marks, n};
        y = walk_from(w, y, stop, out);
        if (y < n)
          idx = list_index(plists + static_cast<size_t>(y / kSeg) * 6 * kCap,
                           cnt[y / kSeg], y);
      }
      if (y >= n) break;
      k = y / kSeg;
    }
    if (lane == 0) {
      totals[0] = np;
      totals[1] = out.nc;
      totals[2] = out.anchor;
    }
  }
  __syncthreads();
  // the pieces to the outputs, a warp a piece
  const int np = totals[0];
  for (int p = warp; p < np; p += kWarps) {
    const int kind = pkind[p];
    const int32_t* list =
        plists + (static_cast<size_t>(kind % K) * 6 + 3 * (kind / K)) * kCap;
    const int first = pidx[p], count = pcnt[p], off = poff[p];
    for (int e = lane; e < count; e += 32) {
      const int i = first + e, o = off + e;
      const int prev = e == 0 ? panchor[p] : list[i - 1] + list[kCap + i - 1];
      if (o < max_cmds) {
        ins[static_cast<size_t>(row) * max_cmds + o] = list[i] - prev;
        cpy[static_cast<size_t>(row) * max_cmds + o] = list[kCap + i];
        dist[static_cast<size_t>(row) * max_cmds + o] = list[2 * kCap + i];
      }
    }
  }
  if (tid == 0) {
    ncmds[row] = totals[1] <= max_cmds ? totals[1] : -1;
    tail[row] = n - totals[2];
  }
}

// ---------------------------------------------------------------------------
// launch configuration
// ---------------------------------------------------------------------------

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return n;
}

size_t sort_smem(int S) {
  return S + kPad + sizeof(int) * (kWarps * kDigits + kDigits + kWarps);
}

size_t walk_smem(int S) { return S + kPad; }

size_t join_smem(int S) {
  const int K = segments(S);
  return S + kPad + sizeof(uint32_t) * K * kSegWords +
         sizeof(int) * (7 * K + 10 * K + 4);
}

int set_smem(const void* kernel, size_t bytes) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) cudaGetLastError();
  return static_cast<int>(e);
}

// Clusters of nc sort CTAs that the current device holds at once at page
// size S (0 when the query fails); the last page size's answers are kept.
int max_clusters(int S, int nc) {
  static int last_S = -1, known[kMaxCluster + 1];
  if (S != last_S) {
    for (int& c : known) c = -1;
    last_S = S;
  }
  if (known[nc] >= 0) return known[nc];
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nc * 64, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = sort_smem(S);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int c = 0;
  if (cudaOccupancyMaxActiveClusters(
          &c, reinterpret_cast<const void*>(sort_kernel), &cfg) !=
      cudaSuccess) {
    cudaGetLastError();
    c = 0;
  }
  known[nc] = c;
  return c;
}

// CTAs a page of the sort: the most of 8, 4 and 2 whose clusters all fit
// the card at once, one CTA an SM; else 1.
int sort_cluster(int P, int S) {
  const int sms = sm_count();
  for (int nc = kMaxCluster; nc > 1; nc /= 2)
    if (static_cast<long long>(P) * nc <= sms && P <= max_clusters(S, nc))
      return nc;
  return 1;
}

// Warps a walk CTA: the least of 4, 8, 16 and 32 that gives no more CTAs
// than the card has SMs (32 where none does).
int walk_warps(int P, int S) {
  const int K = segments(S), sms = sm_count();
  int W = 4;
  while (W < 32 && static_cast<long long>(P) * ((K + W - 1) / W) > sms)
    W *= 2;
  return W;
}

}  // namespace blg_rp

// The sort: pages uint8 [P, S] (16-byte aligned, S % 16 == 0), sizes int32
// [P]; writes table int32 [P, 2, S]: the positions by hash, then each
// position's slot word.
extern "C" int blg_ref_parse_sort(const void* pages, const void* sizes, int P,
                                  int S, void* table, void* stream) {
  using namespace blg_rp;
  if (P <= 0) return 0;
  const size_t smem = sort_smem(S);
  int e = set_smem(reinterpret_cast<const void*>(sort_kernel), smem);
  if (e) return e;
  const int nc = sort_cluster(P, S);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nc * P, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t le = cudaLaunchKernelEx(
      &cfg, sort_kernel, static_cast<const uint8_t*>(pages),
      static_cast<const int32_t*>(sizes), S, static_cast<int32_t*>(table));
  if (le != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(le);
  }
  return static_cast<int>(cudaGetLastError());
}

// The segment walkers over the sort's table: segs int32 [P, K, 4], marks
// int32 [P, K, 32], lists int32 [P, K, 2, 3, 256] (K = ceil(S / 1024)).
extern "C" int blg_ref_parse_walk(const void* pages, const void* sizes, int P,
                                  int S, int max_chain, const void* table,
                                  void* segs, void* marks, void* lists,
                                  void* stream) {
  using namespace blg_rp;
  if (P <= 0) return 0;
  const int W = walk_warps(P, S);
  const size_t smem = walk_smem(S);
  const int cpp = (segments(S) + W - 1) / W;
  const int e = set_smem(reinterpret_cast<const void*>(walk_kernel), smem);
  if (e) return e;
  walk_kernel<<<P * cpp, W * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(pages), static_cast<const int32_t*>(sizes),
      S, max_chain, cpp, static_cast<const int32_t*>(table),
      static_cast<int32_t*>(segs), static_cast<uint32_t*>(marks),
      static_cast<int32_t*>(lists));
  return static_cast<int>(cudaGetLastError());
}

// The join over the walkers' results: ins, cpy, dist int32 [P, max_cmds],
// ncmds and tail int32 [P] (ncmds -1 where a page needs more than max_cmds
// commands). Writes the continuations' lists into lists.
extern "C" int blg_ref_parse_join(const void* pages, const void* sizes, int P,
                                  int S, int max_chain, int max_cmds,
                                  const void* table, const void* segs,
                                  const void* marks, void* lists, void* ins,
                                  void* cpy, void* dist, void* ncmds,
                                  void* tail, void* stream) {
  using namespace blg_rp;
  if (P <= 0) return 0;
  const size_t smem = join_smem(S);
  const int e = set_smem(reinterpret_cast<const void*>(join_kernel), smem);
  if (e) return e;
  join_kernel<<<P, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(pages), static_cast<const int32_t*>(sizes),
      S, max_chain, max_cmds, static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(segs), static_cast<const uint32_t*>(marks),
      static_cast<int32_t*>(lists), static_cast<int32_t*>(ins),
      static_cast<int32_t*>(cpy), static_cast<int32_t*>(dist),
      static_cast<int32_t*>(ncmds), static_cast<int32_t*>(tail));
  return static_cast<int>(cudaGetLastError());
}
