// The matcher: greedy LZ77 commands, or the windowed DP's candidates, for
// a batch of pages.
//
// Replaces brotlig_tpu/ops/encode.py:142 (_scan_matches) with its two
// compiled callers, :339 (find_candidates) and :360 (find_commands): XLA
// programs, with no Pallas kernel. Plain versions: ops/encode.py::
// find_commands_plain and find_candidates_plain (the same matcher as
// eager torch ops, about 3,400 launches a q1 batch); wrapper:
// ops/match_kernel.py. The output equals the plain version's, int for int.
//
// Four kernels, six launches a call:
//   hist, scatter  the two passes (low key byte, then high) of a stable LSD
//           radix sort of each key family's (key, position) pairs, one
//           block a (page, family, tile of 4,096 pairs): hist counts the
//           tile's digits; scatter places each pair (the digit's start
//           from every tile's counts, the earlier tiles' pairs of that
//           digit, the earlier pairs of its tile, equal digits of a warp's
//           row ranked with one ballot a digit bit), reorders the tile by
//           digit in shared memory and writes it out in runs. Only
//           positions whose key covers bytes inside the page are sorted
//           (the plain version's tail keys past them never give a
//           length). The second pass writes each position's rank: rank r
//           - k with an equal key is then the k-th nearest earlier
//           position with that key, as in the plain version's stable sort.
//   probe   one block a (page, 4,096 positions), so that 8 pages fill the
//           card: the page prefix the block can reach in shared memory;
//           a position's probes read the sorted pairs just below its rank
//           (contiguous, no pointer chase), rank candidates by a common
//           prefix capped at the tier's words, keep the first strictly
//           longest, give the winner its full prefix up to 192 bytes, and
//           replace it by the distance-1 run where that is strictly
//           longer (runs from a suffix minimum over the block and a search
//           for the first break past it). find_candidates' near and 3-byte
//           slots are written here.
//   finish  one block a page: the chain extension (a match of exactly 192
//           bytes whose continuation at +192 holds a match at the same
//           distance joins it) by 192 threads, each walking one residue
//           class mod 192 downwards; then either slot 0 of the candidates,
//           or the greedy cover: each taken position's successor (the
//           first taken position at or after its end, from a two-level
//           bitmap) in shared memory, one thread walking the successors
//           from the first taken position, and the commands written by the
//           whole block.
//
// What bounds it on this card: the bytes are few (a page read, its
// commands or candidates written: ~8.4 MB for a 32-page q1 batch), so a
// call is bounded by its chains of dependent steps and by the sort's
// scattered traffic. The sort runs in tiles over every SM, its writes in
// runs of one digit; the probes run over blocks of positions, with their
// page prefix in shared memory and their pairs read contiguously; what
// stays sequential (a residue class's chain, the cover's walk: one
// successor load from shared memory a command, ~6,000 commands a q1 text
// page) stays in one block a page with its data in shared memory.
//
// Inputs: pages uint8 [P, S] (S a multiple of 4, at most 128 KiB, rows
// 4-byte aligned), in_sizes int32 [P] (clamped to [0, S]). Scratch (int32
// words): hist [P, F, 256, tiles], pairs [P, F, 2S] twice (64-bit (key,
// position) pairs), rank [P, F, S], lens and dists [P, S]; for the cover,
// the segment walkers' node lists [P, blg_match_nodes_ints(S)] and the
// successors [P, S] (used past 64 KiB pages, where they do not fit 16
// bits in shared memory).
// Outputs: ins, cpy, dist [P, max_cmds] and ncmds [P]; or cand_len,
// cand_dist [P, S, 8].
#include <cstdint>

#include <cuda_runtime.h>

namespace blg_match {
namespace {

constexpr uint32_t kHashMul = 0x1E35A7BDu;
constexpr uint32_t kHashMul8 = 0x9E3779B1u;
constexpr int kMinMatch = 4;
constexpr int kCapMax = 192;          // EXT_ROUNDS * 4 * MAX_MATCH_WORDS
constexpr int kSlots = 8;
constexpr int kSortThreads = 256;
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kTile = 4096;           // elements a sort block
constexpr int kWarpElems = kTile / kSortWarps;
constexpr int kTileWords = kTile / 4 + 2;   // page words a tile's keys read
constexpr int kDigits = 256;          // == kSortThreads: a thread a digit
constexpr int kUnroll = 4;            // rows of a warp's sort step
constexpr int kProbeThreads = 512;
constexpr int kChunk = 4096;          // positions a probe block
constexpr int kPerThread = kChunk / kProbeThreads;
constexpr int kFinishThreads = 1024;
constexpr int kWalkers = kCapMax;     // one a residue class mod 192
constexpr int kAhead = 8;             // a walker's loads in flight
constexpr int kSmallPage = 65536;     // successors fit 16 bits up to here
constexpr int kSegs = 64;             // the cover's walkers a page
constexpr int kChainGroups = kWalkers / 32;   // candidates: warps a page
constexpr uint16_t kNoStep = 0xFFFF;
constexpr unsigned kFull = 0xffffffffu;

// the key families: 4-byte, 8-byte and 3-byte keys; bytes a key covers
__device__ inline int fam_bytes(int f) {
  return f == 0 ? 4 : (f == 1 ? 8 : 3);
}

__device__ inline int clamp_limit(const int32_t* in_sizes, int page, int S) {
  return min(max(in_sizes[page], 0), S);
}

// the little-endian word of the page at byte p (w holds the page's words)
__device__ inline uint32_t word_at(const uint32_t* w, int p) {
  return __funnelshift_r(w[p >> 2], w[(p >> 2) + 1], (p & 3) * 8);
}

__device__ inline int byte_at(const uint32_t* w, int p) {
  return (w[p >> 2] >> ((p & 3) * 8)) & 255;
}

__device__ inline uint32_t fam_key(const uint32_t* w, int f, int p) {
  uint32_t h = word_at(w, p);
  if (f == 2) return ((h & 0xFFFFFFu) * kHashMul8) >> 16;
  h *= kHashMul;
  if (f == 1) h ^= word_at(w, p + 4) * kHashMul8;
  return h >> 16;
}

// common prefix of the suffixes at i and c < i, in bytes, up to
// min(maxb, rem): the plain version's word-by-word LCP capped at maxb and
// then at the room left in the page (words past the room never decide it)
__device__ inline int lcp(const uint32_t* w, int i, int c, int maxb, int rem) {
  const int lim = min(maxb, rem);
  for (int m = 0; m < lim; m += 4) {
    uint32_t x = word_at(w, i + m) ^ word_at(w, c + m);
    if (x) return min(m + ((__ffs(x) - 1) >> 3), lim);
  }
  return lim;
}

// the page's words [0, nload) into w, and two zero words after them
__device__ void load_words(uint32_t* w, const uint8_t* row, int nload,
                           int tid, int nthreads) {
  const uint32_t* src = reinterpret_cast<const uint32_t*>(row);
  for (int j = tid; j < nload; j += nthreads) w[j] = src[j];
  if (tid < 2) w[nload + tid] = 0;
}

// ---------------------------------------------------------------------------
// hist and scatter: the stable radix sort of each family's pairs
// ---------------------------------------------------------------------------

// the valid lanes of the warp whose 8-bit digit equals this lane's (a
// lane's own group when it is valid): one ballot a bit, each a single
// warp-wide instruction, where __match_any_sync serialises over the
// distinct values
__device__ inline unsigned digit_peers(uint32_t digit, bool valid) {
  unsigned peers = __ballot_sync(kFull, valid);
#pragma unroll
  for (int bit = 0; bit < 8; ++bit) {
    const bool set = (digit >> bit) & 1;
    const unsigned b = __ballot_sync(kFull, set);
    peers &= set ? b : ~b;
  }
  return peers;
}

// positions family f keys in a page: those whose key covers bytes inside
// it (the plain version's tail keys, past them, never give a length)
__device__ inline int keyed(const int32_t* in_sizes, int page, int S, int f) {
  return max(0, clamp_limit(in_sizes, page, S) - fam_bytes(f) + 1);
}

__host__ __device__ inline int sort_tiles(int S) {
  return (S + kTile - 1) / kTile;
}

// the exclusive prefix sum of v over the block's kSortThreads threads
// (sums: kSortWarps ints of shared memory)
__device__ int block_exclusive(int v, int* sums, int tid) {
  const int lane = tid & 31, wid = tid >> 5;
  int incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int x = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += x;
  }
  if (lane == 31) sums[wid] = incl;
  __syncthreads();
  if (wid == 0) {
    const int x = lane < kSortWarps ? sums[lane] : 0;
    int run = x;
#pragma unroll
    for (int off = 1; off < kSortWarps; off <<= 1) {
      const int y = __shfl_up_sync(kFull, run, off);
      if (lane >= off) run += y;
    }
    if (lane < kSortWarps) sums[lane] = run - x;
  }
  __syncthreads();
  const int out = incl - v + sums[wid];
  __syncthreads();
  return out;
}

// a lane's (key << 32 | position) pairs of kUnroll rows from element e on
// (rows 32 elements apart), up to e1: the first pass hashes them from the
// tile's page words wl (byte t0 first), the second reads its input
__device__ inline void tile_pairs(uint64_t* v, const uint32_t* wl, int t0,
                                  int f, int pass, const uint64_t* in, int e,
                                  int e1) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u, e += 32) {
    v[u] = 0;
    if (e < e1)
      v[u] = pass == 0 ? (static_cast<uint64_t>(fam_key(wl, f, e - t0))
                          << 32) | static_cast<uint32_t>(e)
                       : in[e];
  }
}

// the pass's 8-bit digit of a pair's key: low byte, then high byte
__device__ inline uint32_t pair_digit(uint64_t v, int pass) {
  return static_cast<uint32_t>(v >> (pass == 0 ? 32 : 40)) & 255;
}

// What the histogram and scatter blocks share: the (page, family) pf and
// tile of the block, the tile's elements [t0, t1), and, for the first
// pass, the page words its keys read (from byte t0) in wl.
struct Tile {
  int pf, tile, f, t0, t1;
};

__device__ Tile sort_tile(const uint8_t* pages, const int32_t* in_sizes,
                          int S, int nfam, int pass, uint32_t* wl, int tid) {
  const int T = sort_tiles(S);
  Tile t;
  t.pf = blockIdx.x / T;
  t.tile = blockIdx.x % T;
  t.f = t.pf % nfam;
  const int page = t.pf / nfam;
  t.t0 = t.tile * kTile;
  t.t1 = min(keyed(in_sizes, page, S, t.f), t.t0 + kTile);
  if (pass == 0) {
    const uint32_t* src = reinterpret_cast<const uint32_t*>(
        pages + static_cast<size_t>(page) * S);
    const int nw = min(kTileWords, (S - t.t0) >> 2);
    for (int j = tid; j < kTileWords + 2; j += kSortThreads)
      wl[j] = j < nw ? src[(t.t0 >> 2) + j] : 0;
  }
  return t;
}

// Counts of each digit over warp wid's rows of the tile (warp wid takes
// elements [t0 + 512 wid, t0 + 512 (wid + 1))) into cnt[wid][digit].
__device__ void warp_counts(const Tile& t, const uint32_t* wl, int pass,
                            const uint64_t* in, int* cnt, int tid) {
  const int lane = tid & 31, wid = tid >> 5;
  const int lo = t.t0 + wid * kWarpElems;
  const int hi = min(t.t1, lo + kWarpElems);
  for (int e0 = lo; e0 < hi; e0 += 32 * kUnroll) {
    uint64_t v[kUnroll];
    tile_pairs(v, wl, t.t0, t.f, pass, in, e0 + lane, hi);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool ok = e0 + 32 * u + lane < hi;
      const uint32_t digit = pair_digit(v[u], pass);
      const unsigned peers = digit_peers(digit, ok);
      if (ok && lane == __ffs(peers) - 1)
        cnt[wid * kDigits + digit] += __popc(peers);
      __syncwarp();
    }
  }
}

// hist: one block a (page, family, tile of 4,096 elements): the tile's
// count of each digit of the pass, into hist[pf][digit][tile]
__global__ void __launch_bounds__(kSortThreads)
    hist_kernel(const uint8_t* __restrict__ pages,
                const int32_t* __restrict__ in_sizes, int S, int nfam,
                int pass, const uint64_t* __restrict__ in,
                int32_t* __restrict__ hist) {
  extern __shared__ uint32_t smem[];
  const int tid = threadIdx.x;
  int* cnt = reinterpret_cast<int*>(smem);              // [warps][256]
  uint32_t* wl = reinterpret_cast<uint32_t*>(cnt + kSortWarps * kDigits);
  for (int j = tid; j < kSortWarps * kDigits; j += kSortThreads) cnt[j] = 0;
  const Tile t = sort_tile(pages, in_sizes, S, nfam, pass, wl, tid);
  __syncthreads();
  warp_counts(t, wl, pass, in + static_cast<size_t>(t.pf) * S, cnt, tid);
  __syncthreads();
  int sum = 0;
  for (int wv = 0; wv < kSortWarps; ++wv) sum += cnt[wv * kDigits + tid];
  hist[(static_cast<size_t>(t.pf) * kDigits + tid) * sort_tiles(S) +
       t.tile] = sum;
}

// scatter: one block a (page, family, tile): each element's place in the
// stable order of the pass (the digit's start over all tiles, the earlier
// tiles' elements of that digit, the earlier elements of this tile), the
// tile reordered by digit in shared memory and written out in runs. The
// second pass also writes each position's rank.
__global__ void __launch_bounds__(kSortThreads)
    scatter_kernel(const uint8_t* __restrict__ pages,
                   const int32_t* __restrict__ in_sizes, int S, int nfam,
                   int pass, const int32_t* __restrict__ hist,
                   const uint64_t* __restrict__ in,
                   uint64_t* __restrict__ out, int32_t* __restrict__ rank) {
  extern __shared__ uint32_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  uint64_t* buf = reinterpret_cast<uint64_t*>(smem);   // [kTile]
  int* cnt = reinterpret_cast<int*>(buf + kTile);      // [warps][256]
  int* tstart = cnt + kSortWarps * kDigits;            // [256]
  int* base = tstart + kDigits;                        // [256]
  int* sums = base + kDigits;                          // [warps]
  uint32_t* wl = reinterpret_cast<uint32_t*>(sums + kSortWarps);
  for (int j = tid; j < kSortWarps * kDigits; j += kSortThreads) cnt[j] = 0;
  const Tile t = sort_tile(pages, in_sizes, S, nfam, pass, wl, tid);
  if (t.t0 >= t.t1) return;   // the whole block: an empty tile
  const size_t row = static_cast<size_t>(t.pf) * S;
  const int T = sort_tiles(S);
  // the digit's first slot in the pass's output, from every tile's counts
  {
    const int32_t* h = hist + (static_cast<size_t>(t.pf) * kDigits + tid) * T;
    int total = 0, before = 0;
    for (int k = 0; k < T; ++k) {
      total += h[k];
      if (k < t.tile) before += h[k];
    }
    base[tid] = block_exclusive(total, sums, tid) + before;
  }
  warp_counts(t, wl, pass, in + row, cnt, tid);
  __syncthreads();
  {
    int run = 0;
    for (int wv = 0; wv < kSortWarps; ++wv) {
      const int c = cnt[wv * kDigits + tid];
      cnt[wv * kDigits + tid] = run;
      run += c;
    }
    const int start = block_exclusive(run, sums, tid);
    tstart[tid] = start;
    for (int wv = 0; wv < kSortWarps; ++wv) cnt[wv * kDigits + tid] += start;
  }
  __syncthreads();
  // each element to its slot in the tile, in the stable order
  const unsigned below = (1u << lane) - 1;
  const int lo = t.t0 + wid * kWarpElems;
  const int hi = min(t.t1, lo + kWarpElems);
  for (int e0 = lo; e0 < hi; e0 += 32 * kUnroll) {
    uint64_t v[kUnroll];
    tile_pairs(v, wl, t.t0, t.f, pass, in + row, e0 + lane, hi);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool ok = e0 + 32 * u + lane < hi;
      const uint32_t digit = pair_digit(v[u], pass);
      const unsigned peers = digit_peers(digit, ok);
      int slot = 0;
      if (ok) slot = cnt[wid * kDigits + digit] + __popc(peers & below);
      __syncwarp();
      if (ok && lane == __ffs(peers) - 1)
        cnt[wid * kDigits + digit] += __popc(peers);
      __syncwarp();
      if (ok) buf[slot] = v[u];
    }
  }
  __syncthreads();
  // the tile in slot order: runs of one digit go to consecutive places
  for (int s = tid; s < t.t1 - t.t0; s += kSortThreads) {
    const uint64_t v = buf[s];
    const uint32_t digit = pair_digit(v, pass);
    const int dst = base[digit] + s - tstart[digit];
    out[row + dst] = v;
    if (pass == 1) rank[row + static_cast<uint32_t>(v)] = dst;
  }
}

// ---------------------------------------------------------------------------
// probe: candidates, the winner's prefix and the runs, a block of positions
// ---------------------------------------------------------------------------

// Family F's probes of position p: the nearest earlier positions with its
// key (the pairs just below its rank r), ranked by a common prefix capped
// at maxb bytes and the room left; (fl, fd) the first strictly longest
// and its distance (0, 0 where there is none), and with near the first
// probes' lengths and distances (0 where the length is) in the family's
// slots of nl and nd. A position whose key reaches past the page has no
// probe (the plain version's tail keys).
template <int F>
__device__ inline void probe_family(const uint32_t* w, const uint64_t* sp,
                                    const int32_t* rank, int p, int limit,
                                    int rem, int maxb, bool near, int& fl,
                                    int& fd, int (&nl)[7], int (&nd)[7]) {
  constexpr int kProbes = F == 0 ? 16 : (F == 1 ? 4 : 2);
  constexpr int kNear = F == 0 ? 3 : 2;
  constexpr int kSlot = F == 0 ? 0 : (F == 1 ? 3 : 5);
  fl = 0;
  fd = 0;
  if (p + fam_bytes(F) > limit) return;
  const int r = rank[p];
  const uint32_t key = static_cast<uint32_t>(sp[r] >> 32);
#pragma unroll
  for (int k = 1; k <= kProbes; ++k) {
    if (k > r) break;
    const uint64_t v = sp[r - k];
    if (static_cast<uint32_t>(v >> 32) != key) break;
    const int c = static_cast<int>(static_cast<uint32_t>(v));
    const int ml = lcp(w, p, c, maxb, rem);
    if (near && k <= kNear) {
      nl[kSlot + k - 1] = ml;
      nd[kSlot + k - 1] = ml > 0 ? p - c : 0;
    }
    if (ml > fl) {
      fl = ml;
      fd = p - c;
    }
  }
}

__global__ void __launch_bounds__(kProbeThreads)
    probe_kernel(const uint8_t* __restrict__ pages,
                 const int32_t* __restrict__ in_sizes, int S, int nfam,
                 int rank_words, int cap,
                 const uint64_t* __restrict__ pairs,
                 const int32_t* __restrict__ rank, int32_t* __restrict__ lens,
                 int32_t* __restrict__ dists, int32_t* __restrict__ cand_len,
                 int32_t* __restrict__ cand_dist) {
  extern __shared__ uint32_t smem[];
  const int tid = threadIdx.x;
  const int nchunks = (S + kChunk - 1) / kChunk;
  const int page = blockIdx.x / nchunks;
  const int a = (blockIdx.x % nchunks) * kChunk;
  const int end = min(S, a + kChunk);
  const int limit = clamp_limit(in_sizes, page, S);
  const uint8_t* row = pages + static_cast<size_t>(page) * S;
  int* run = reinterpret_cast<int*>(smem);      // [kChunk]
  int* suf = run + kChunk;                      // [kProbeThreads]
  int* flip_end = suf + kProbeThreads;          // [1]
  uint32_t* w = reinterpret_cast<uint32_t*>(flip_end + 4);
  // the bytes a position of the block can reach: its winner's 192 bytes
  // and the word after them
  const int nload = min(S >> 2, (end + kCapMax + 8) / 4 + 1);
  load_words(w, row, nload, tid, kProbeThreads);
  if (tid == 0) *flip_end = S;
  __syncthreads();

  // ---- distance-1 runs: eq(p) = p < limit && byte p == byte p - 1 ----
  // the first position at or past the block's end where a run breaks
  // (reads the row itself: a run may reach past the loaded prefix)
  if (end < S) {
    for (int p0 = end;; p0 += kProbeThreads) {
      const int p = p0 + tid;
      const bool brk = p < S && (p >= limit || row[p] != row[p - 1]);
      if (brk) atomicMin(flip_end, p);
      if (__syncthreads_or(brk) || p0 + kProbeThreads >= S) break;
    }
  }
  __syncthreads();
  const int s0 = a + tid * kPerThread, s1 = min(end, s0 + kPerThread);
  int first = S;     // the first break in this thread's positions
  for (int p = s1 - 1; p >= s0; --p) {
    bool eq = p > 0 && p < limit && byte_at(w, p) == byte_at(w, p - 1);
    if (!eq) first = p;
  }
  suf[tid] = min(first, *flip_end);
  __syncthreads();
  for (int o = 1; o < kProbeThreads; o <<= 1) {
    int v = suf[tid];
    if (tid + o < kProbeThreads) v = min(v, suf[tid + o]);
    __syncthreads();
    suf[tid] = v;
    __syncthreads();
  }
  int nf = tid + 1 < kProbeThreads ? suf[tid + 1] : *flip_end;
  for (int p = s1 - 1; p >= s0; --p) {
    bool eq = p > 0 && p < limit && byte_at(w, p) == byte_at(w, p - 1);
    if (!eq) nf = p;
    run[p - a] = eq ? min(nf - p, max(limit - p, 0)) : 0;
  }
  __syncthreads();

  // ---- the probes, the winner, the run ----
  const bool cands = cand_len != nullptr;
  for (int p = a + tid; p < end; p += kProbeThreads) {
    const int rem = max(limit - p, 0);
    int best = 0, bdist = 0, fl, fd;
    // near candidates: 4-byte family 0-2, 8-byte 3-4, 3-byte 5-6
    int nl[7] = {0, 0, 0, 0, 0, 0, 0}, nd[7] = {0, 0, 0, 0, 0, 0, 0};
    const size_t base = static_cast<size_t>(page) * nfam * S;
    probe_family<0>(w, pairs + base, rank + base, p, limit, rem,
                    4 * rank_words, cands, best, bdist, nl, nd);
    probe_family<1>(w, pairs + base + S, rank + base + S, p, limit, rem,
                    4 * rank_words, cands, fl, fd, nl, nd);
    if (fl > best) {   // the 8-byte family replaces only when longer
      best = fl;
      bdist = fd;
    }
    if (cands)
      probe_family<2>(w, pairs + base + 2 * S, rank + base + 2 * S, p, limit,
                      rem, 8, true, fl, fd, nl, nd);
    int len = best > 0 ? lcp(w, p, p - bdist, kCapMax, rem) : 0;
    int dist = bdist;
    if (run[p - a] > len) {
      len = run[p - a];
      dist = 1;
    }
    const size_t at = static_cast<size_t>(page) * S + p;
    lens[at] = len;
    dists[at] = dist;
    if (cands) {   // a row in two 16-byte stores; slot 0's length is the
                   // finish kernel's
      int v[7];
#pragma unroll
      for (int j = 0; j < 5; ++j) {
        v[j] = min(min(nl[j], rem), cap);
        v[j] = v[j] >= kMinMatch ? v[j] : 0;
      }
#pragma unroll
      for (int j = 5; j < 7; ++j)
        v[j] = min(min(nl[j] >= 2 ? nl[j] : 0, rem), cap);
      int4* cl = reinterpret_cast<int4*>(cand_len + at * kSlots);
      int4* cd = reinterpret_cast<int4*>(cand_dist + at * kSlots);
      cl[0] = make_int4(0, v[0], v[1], v[2]);
      cl[1] = make_int4(v[3], v[4], v[5], v[6]);
      cd[0] = make_int4(dist, nd[0], nd[1], nd[2]);
      cd[1] = make_int4(nd[3], nd[4], nd[5], nd[6]);
    }
  }
}

// ---------------------------------------------------------------------------
// finish: the chain extension, then slot 0 or the greedy cover, a page
// ---------------------------------------------------------------------------

// the first taken position at or after j (S if none): bm holds a bit a
// position, l1 a bit a nonzero word of bm
__device__ int next_taken(const uint32_t* bm, const uint32_t* l1, int j,
                          int S) {
  if (j >= S) return S;
  const int nw = (S + 31) >> 5, nu = (nw + 31) >> 5;
  int wi = j >> 5;
  const uint32_t bits = bm[wi] & (kFull << (j & 31));
  if (bits) return (wi << 5) + __ffs(bits) - 1;
  if (++wi >= nw) return S;
  int ui = wi >> 5;
  uint32_t u = l1[ui] & (kFull << (wi & 31));
  while (!u) {
    if (++ui >= nu) return S;
    u = l1[ui];
  }
  wi = (ui << 5) + __ffs(u) - 1;
  return (wi << 5) + __ffs(bm[wi]) - 1;
}

// The chain of residue class c mod 192: positions c + 192 m, m downwards,
// carrying the pre-chain length and distance at +192, the links that
// follow from there and the length at the chain's end; emit(p, final
// length, distance) for each position.
template <typename Emit>
__device__ void chain_class(int c, int S, int limit, const int32_t* lp,
                            const int32_t* dp, Emit emit) {
  int la = 0, da = 0, ca = 0, ta = 0;
  for (int m = (S - 1 - c) / kCapMax; m >= 0; m -= kAhead) {
    int l[kAhead], d[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (m - k >= 0) {
        l[k] = lp[c + kCapMax * (m - k)];
        d[k] = dp[c + kCapMax * (m - k)];
      }
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (m - k < 0) break;
      const int p = c + kCapMax * (m - k);
      const bool cont = l[k] == kCapMax && da == d[k] && la > 0;
      const int cnt = cont ? ca + 1 : 0;
      const int term = cont ? ta : l[k];
      emit(p, min(kCapMax * cnt + term, max(limit - p, 0)), d[k]);
      la = l[k];
      da = d[k];
      ca = cnt;
      ta = term;
    }
  }
}

// the cover's segments: kSegs a page, their node lists' capacity
__host__ __device__ inline int seg_bytes(int S) {
  return (S + kSegs - 1) / kSegs;
}
__host__ __device__ inline int seg_cap(int S) { return seg_bytes(S) / 4 + 2; }

__global__ void __launch_bounds__(kFinishThreads)
    finish_kernel(const int32_t* __restrict__ in_sizes, int S, int max_cmds,
                  int cap, int32_t* __restrict__ lens,
                  const int32_t* __restrict__ dists, int32_t* __restrict__ step,
                  int32_t* __restrict__ nodes, int32_t* __restrict__ ins,
                  int32_t* __restrict__ cpy, int32_t* __restrict__ dist,
                  int32_t* __restrict__ ncmds,
                  int32_t* __restrict__ cand_len) {
  extern __shared__ uint32_t smem[];
  const int tid = threadIdx.x;
  if (cand_len != nullptr) {
    // the candidates: slot 0 of each position, a warp of classes a block
    const int page = blockIdx.x / kChainGroups;
    const int c = (blockIdx.x % kChainGroups) * 32 + tid;
    const int limit = clamp_limit(in_sizes, page, S);
    const size_t row = static_cast<size_t>(page) * S;
    if (c < S)
      chain_class(c, S, limit, lens + row, dists + row,
                  [&](int p, int fin, int) {
                    const int v = min(fin, cap);
                    cand_len[(row + p) * kSlots] = v >= kMinMatch ? v : 0;
                  });
    return;
  }
  const int page = blockIdx.x;
  const int limit = clamp_limit(in_sizes, page, S);
  const int nw = (S + 31) >> 5, nu = (nw + 31) >> 5;
  const int seg = seg_bytes(S), scap = seg_cap(S);
  uint32_t* bm = smem;                     // [nw] taken positions
  uint32_t* l1 = bm + nw;                  // [nu] nonzero words of bm
  uint32_t* onpath = l1 + nu;              // [nw] the segment walkers' nodes
  int* cnts = reinterpret_cast<int*>(onpath + nw);  // [kSegs] walker nodes
  int* exits = cnts + kSegs;               // [kSegs] walker's first past it
  int* pcount = exits + kSegs;             // [kSegs] nodes before the join
  int* join = pcount + kSegs;              // [kSegs] join node, or -1
  int* from = join + kSegs;                // [kSegs] join's walker index
  int* off = from + kSegs;                 // [kSegs + 1] first command
  int* pend = off + kSegs + 1;             // [kSegs] end before the segment
  int* count = pend + kSegs;               // [1] the commands kept
  uint16_t* step16 = reinterpret_cast<uint16_t*>(count + 4);  // [S], small
  const bool small = S <= kSmallPage;
  int32_t* lp = lens + static_cast<size_t>(page) * S;
  const int32_t* dp = dists + static_cast<size_t>(page) * S;
  int32_t* sg = step + static_cast<size_t>(page) * S;
  int32_t* walk = nodes + static_cast<size_t>(page) * 2 * kSegs * scap;
  int32_t* pre = walk + kSegs * scap;
  for (int j = tid; j < 2 * nw + nu; j += kFinishThreads) bm[j] = 0;
  __syncthreads();

  // ---- the chain, and the taken positions ----
  if (tid < kWalkers && tid < S)
    chain_class(tid, S, limit, lp, dp, [&](int p, int fin, int) {
      lp[p] = fin;
      if (fin >= kMinMatch && p + fin <= limit)
        atomicOr(&bm[p >> 5], 1u << (p & 31));
    });
  __syncthreads();
  for (int j = tid; j < nw; j += kFinishThreads)
    if (bm[j]) atomicOr(&l1[j >> 5], 1u << (j & 31));
  __syncthreads();

  // ---- each taken position's successor: the first taken position at or
  // after its end ----
  for (int p = tid; p < S; p += kFinishThreads) {
    if (!(bm[p >> 5] >> (p & 31) & 1)) continue;
    const int s = next_taken(bm, l1, p + lp[p], S);
    if (small)
      step16[p] = s < S ? static_cast<uint16_t>(s) : kNoStep;
    else
      sg[p] = s;
  }
  __syncthreads();
  auto succ = [&](int i) {
    if (!small) return static_cast<int>(sg[i]);
    const uint16_t s = step16[i];
    return s == kNoStep ? S : static_cast<int>(s);
  };

  // ---- the cover, in segments: walker k follows the successors from the
  // first taken position of its segment to the first past it, marking its
  // nodes; a path that reaches one of them follows the walker from there ----
  if (tid < kSegs) {
    const int hi = min(S, (tid + 1) * seg);
    int x = next_taken(bm, l1, tid * seg, S), n = 0;
    while (x < hi) {
      walk[tid * scap + n++] = x;
      atomicOr(&onpath[x >> 5], 1u << (x & 31));
      x = succ(x);
    }
    cnts[tid] = n;
    exits[tid] = x;
  }
  __syncthreads();
  // the true path, from the first taken position: through each segment
  // until it joins that segment's walker (at once where it enters at the
  // walker's start), then from the walker's exit
  if (tid == 0) {
    int t = next_taken(bm, l1, 0, S);
    for (int k = 0; k < kSegs; ++k) {
      const int hi = min(S, (k + 1) * seg);
      int p = 0;
      while (t < hi && !(onpath[t >> 5] >> (t & 31) & 1)) {
        pre[k * scap + p++] = t;
        t = succ(t);
      }
      pcount[k] = p;
      join[k] = t < hi ? t : -1;
      if (t < hi) t = exits[k];
    }
  }
  __syncthreads();
  // where each join falls in its walker's list: the walker's nodes before
  // it (its marks in the segment)
  if (tid < kSegs) {
    int j = 0;
    if (join[tid] >= 0) {
      const int lo = tid * seg, y = join[tid];
      for (int w = lo >> 5; y > lo && w <= (y - 1) >> 5; ++w) {
        uint32_t bits = onpath[w];
        if (w == lo >> 5) bits &= kFull << (lo & 31);
        if (w == (y - 1) >> 5) bits &= kFull >> (31 - ((y - 1) & 31));
        j += __popc(bits);
      }
      from[tid] = j;
    } else {
      from[tid] = cnts[tid];
    }
  }
  __syncthreads();
  auto node = [&](int k, int i) {
    return i < pcount[k] ? pre[k * scap + i]
                         : walk[k * scap + from[k] + i - pcount[k]];
  };
  if (tid == 0) {
    int total = 0, end = 0;
    for (int k = 0; k < kSegs; ++k) {
      off[k] = total;
      pend[k] = end;
      const int c = pcount[k] + cnts[k] - from[k];
      if (c > 0) {
        const int last = node(k, c - 1);
        end = last + lp[last];
      }
      total += c;
    }
    off[kSegs] = total;
    *count = min(total, max_cmds);
    ncmds[page] = *count;
  }
  __syncthreads();
  const int n = *count;
  const size_t row = static_cast<size_t>(page) * max_cmds;
  for (int o = tid; o < max_cmds; o += kFinishThreads) {
    int a = 0, b = 0, c = 0;
    if (o < n) {
      int lo = 0, hi = kSegs - 1;   // the last segment starting at or before o
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (off[mid] <= o) lo = mid; else hi = mid - 1;
      }
      const int i = o - off[lo];
      const int pos = node(lo, i);
      int prev_end = pend[lo];
      if (i > 0) {
        const int q = node(lo, i - 1);
        prev_end = q + lp[q];
      }
      a = pos - prev_end;
      b = lp[pos];
      c = dp[pos];
    }
    ins[row + o] = a;
    cpy[row + o] = b;
    dist[row + o] = c;
  }
}

// dynamic shared memory of each kernel, in bytes
long long hist_smem() {
  return 4LL * (kSortWarps * kDigits + kTileWords + 2);
}
long long scatter_smem() {
  return 8LL * kTile +
         4LL * (kSortWarps * kDigits + 2 * kDigits + kSortWarps +
                kTileWords + 2);
}
long long probe_smem(int S) {
  return 4LL * (kChunk + kProbeThreads + 4 + (S >> 2) + 2);
}
long long finish_smem(int S, bool cands) {
  if (cands) return 0;
  const long long nw = (S + 31) >> 5, nu = (nw + 31) >> 5;
  long long bytes = 4 * (2 * nw + nu + 7 * kSegs + 5);
  if (S <= kSmallPage) bytes += 2LL * S;
  return bytes;
}

template <typename K>
cudaError_t set_smem(K kernel, long long bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

int launch_error(cudaError_t e) {
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace blg_match

// Dynamic shared memory of the hist (0), scatter (1), probe (2) or finish
// kernel (3: the cover, 4: the candidates) at page size S, in bytes.
extern "C" long long blg_match_smem(int kernel, int S) {
  using namespace blg_match;
  switch (kernel) {
    case 0: return hist_smem();
    case 1: return scatter_smem();
    case 2: return probe_smem(S);
    default: return finish_smem(S, kernel == 4);
  }
}

// Tiles of 4,096 positions a page's sort takes (the hist array's last
// dimension).
extern "C" int blg_match_tiles(int S) { return blg_match::sort_tiles(S); }

// Launch the hist kernel of a sort pass: one block a (page, family,
// tile); nfam key families (2 for the cover, 3 for the candidates); in
// the first pass's output for pass 1 (unread in pass 0).
extern "C" int blg_match_hist(const void* pages, const void* in_sizes, int P,
                              int S, int nfam, int pass, const void* in,
                              void* hist, void* stream) {
  using namespace blg_match;
  if (P <= 0) return 0;
  cudaError_t e = set_smem(hist_kernel, hist_smem());
  if (e != cudaSuccess) return launch_error(e);
  hist_kernel<<<P * nfam * sort_tiles(S), kSortThreads, hist_smem(),
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(pages), static_cast<const int32_t*>(in_sizes),
      S, nfam, pass, static_cast<const uint64_t*>(in),
      static_cast<int32_t*>(hist));
  return launch_error(cudaSuccess);
}

// Launch the scatter kernel of a sort pass: pass 0 writes the pairs in
// low-byte order to out, pass 1 (reading them from in) the sorted pairs
// to out and each position's rank.
extern "C" int blg_match_scatter(const void* pages, const void* in_sizes,
                                 int P, int S, int nfam, int pass,
                                 const void* hist, const void* in, void* out,
                                 void* rank, void* stream) {
  using namespace blg_match;
  if (P <= 0) return 0;
  cudaError_t e = set_smem(scatter_kernel, scatter_smem());
  if (e != cudaSuccess) return launch_error(e);
  scatter_kernel<<<P * nfam * sort_tiles(S), kSortThreads, scatter_smem(),
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(pages), static_cast<const int32_t*>(in_sizes),
      S, nfam, pass, static_cast<const int32_t*>(hist),
      static_cast<const uint64_t*>(in), static_cast<uint64_t*>(out),
      static_cast<int32_t*>(rank));
  return launch_error(cudaSuccess);
}

// Launch the probe kernel: one block a (page, 4,096 positions). cand_len
// and cand_dist null for the cover.
extern "C" int blg_match_probe(const void* pages, const void* in_sizes, int P,
                               int S, int nfam, int rank_words, int cap,
                               const void* pairs, const void* rank, void* lens,
                               void* dists, void* cand_len, void* cand_dist,
                               void* stream) {
  using namespace blg_match;
  if (P <= 0) return 0;
  const long long smem = probe_smem(S);
  cudaError_t e = set_smem(probe_kernel, smem);
  if (e != cudaSuccess) return launch_error(e);
  const int nchunks = (S + kChunk - 1) / kChunk;
  probe_kernel<<<P * nchunks, kProbeThreads, smem,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(pages), static_cast<const int32_t*>(in_sizes),
      S, nfam, rank_words, cap, static_cast<const uint64_t*>(pairs),
      static_cast<const int32_t*>(rank), static_cast<int32_t*>(lens),
      static_cast<int32_t*>(dists), static_cast<int32_t*>(cand_len),
      static_cast<int32_t*>(cand_dist));
  return launch_error(cudaSuccess);
}

// Node lists of the cover's segment walkers, int32 words a page (the nodes
// scratch's last dimension).
extern "C" long long blg_match_nodes_ints(int S) {
  return 2LL * blg_match::kSegs * blg_match::seg_cap(S);
}

// Launch the finish kernel. For the cover, one block a page: step (int32
// [P, S], read past 64 KiB pages only), nodes [P, blg_match_nodes_ints],
// and the commands; for the candidates (cand_len non-null), a warp of
// residue classes a block, slot 0's length of each position.
extern "C" int blg_match_finish(const void* in_sizes, int P, int S,
                                int max_cmds, int cap, void* lens,
                                const void* dists, void* step, void* nodes,
                                void* ins, void* cpy, void* dist, void* ncmds,
                                void* cand_len, void* stream) {
  using namespace blg_match;
  if (P <= 0) return 0;
  const long long smem = finish_smem(S, cand_len != nullptr);
  cudaError_t e = set_smem(finish_kernel, smem);
  if (e != cudaSuccess) return launch_error(e);
  const bool cands = cand_len != nullptr;
  finish_kernel<<<cands ? P * kChainGroups : P, cands ? 32 : kFinishThreads,
                  smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(in_sizes), S, max_cmds, cap,
      static_cast<int32_t*>(lens), static_cast<const int32_t*>(dists),
      static_cast<int32_t*>(step), static_cast<int32_t*>(nodes),
      static_cast<int32_t*>(ins), static_cast<int32_t*>(cpy),
      static_cast<int32_t*>(dist), static_cast<int32_t*>(ncmds),
      static_cast<int32_t*>(cand_len));
  return launch_error(cudaSuccess);
}
