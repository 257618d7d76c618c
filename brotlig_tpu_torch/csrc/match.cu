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
// Two kernels, two launches a call:
//   sort_probe  a thread block cluster of 2, 4 or 8 CTAs a (page, key
//           family): the most whose CTAs fit the card's SMs (2 for the
//           32-page q1 batch: 64 clusters on 128 SMs; 8 for an 8-page q11
//           batch). Each CTA holds the page in shared memory.
//           A stable LSD radix sort of the positions the family keys
//           (those whose key covers bytes inside the page: the plain
//           version's tail keys never give a length), two 8-bit passes:
//           each warp counts the digits of a contiguous run of elements
//           (shared-memory atomics), the counts are scanned over the
//           cluster (each CTA reads every CTA's digit totals), and each
//           element goes to its slot (equal digits of a row ranked by one
//           ballot a digit bit) in the distributed shared memory of the
//           cluster: CTA r holds slots [r part, (r + 1) part). Up to 64 KiB
//           pages a slot is a uint16 position and its key is recomputed
//           from the page words; 128 KiB pages keep uint32 slots in device
//           scratch. Then the probes in sorted order: the CTA that holds
//           slot i probes it, and slot i's k-th probe is slot i - k while
//           its key is the same (a bin holds its positions in ascending
//           order, so that is the k-th nearest earlier position with the
//           key); neighbouring lanes read neighbouring slots, the 16 slots
//           below a CTA's part are copied in, four probes' slots load at
//           once, and the common prefix compares page words in shared
//           memory (the probed suffix's first 16 bytes in registers). A
//           probe that reaches the cap ends the family's probes. Each
//           position gets its family's first strictly longest probe and
//           that winner's full prefix up to 192 bytes, written once at p as
//           len << 24 | distance; for the candidates, the family's first
//           probes go the same way into a row of 8 words a position.
//   finish  a block a page (for the candidates' rows, up to 8 blocks a
//           page, each redoing the page's chain): the distance-1 runs (a
//           bitmap of the positions where no run continues, and the first
//           break past each word), the fold (family 0, then family 1 only
//           where its capped prefix is strictly longer, then the run where
//           strictly longer), each position's length in shared memory
//           (uint16 up to 64 KiB pages) and its chain link (a match of
//           exactly 192 bytes whose continuation at +192 holds a match at
//           the same distance) as one ballot a word; the chain extension,
//           each residue class mod 192 walked downwards in 5 segments that
//           pass their state on; then the candidates' rows, each written
//           once in two 16-byte stores an array, or the greedy cover: the
//           taken positions as one ballot a word, 64 walkers follow the
//           successors (the first taken position at or after a match's
//           end) through their segments, the true path joins them, and the
//           whole block writes the commands.
//
// What bounds it on this card: the bytes are few (a page read, its
// commands written: ~8.4 MB for a 32-page q1 batch), so a call is bounded
// by its sort passes, its probes' chains of dependent loads and the
// cover's walks; the candidates' 268 MB of rows on a 64-page batch also
// make the finish wait on device memory. The sort and the probes of a
// (page, family) stay on chip in the cluster; a family's result is one
// word a position; what stays sequential (the cover's walk) stays in one
// block a page with the lengths and node lists in shared memory.
//
// Inputs: pages uint8 [P, S] (S a multiple of 4, at most 128 KiB, rows
// 4-byte aligned), in_sizes int32 [P] (clamped to [0, S]). Scratch (int32
// words, blg_match_scratch_ints): the families' results [P, 2, S]; for the
// candidates the near probes [P, S, 8]; past 64 KiB pages also the sort's
// two slot arrays [P, F, 2, S], the lengths [P, S] and the cover's node
// lists.
// Outputs: ins, cpy, dist [P, max_cmds] and ncmds [P]; or cand_len,
// cand_dist [P, S, 8].
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace blg_match {
namespace {

constexpr uint32_t kHashMul = 0x1E35A7BDu;
constexpr uint32_t kHashMul8 = 0x9E3779B1u;
constexpr int kMinMatch = 4;
constexpr int kCapMax = 192;          // EXT_ROUNDS * 4 * MAX_MATCH_WORDS
constexpr int kSlots = 8;
constexpr int kMaxCluster = 8;        // CTAs a (page, family): 2, 4 or 8
constexpr int kThreads = 1024;        // both kernels
constexpr int kWarps = kThreads / 32;
constexpr int kDigits = 256;
constexpr int kUnroll = 4;            // rows of a warp's sort step
constexpr int kSmallPage = 65536;     // positions fit 16 bits up to here
constexpr int kFamilies = 2;          // families folded into the winner
constexpr int kLenShift = 24;         // a family's result: len << 24 | dist
constexpr uint32_t kDistMask = (1u << kLenShift) - 1;
constexpr int kWalkers = kCapMax;     // residue classes mod 192
constexpr int kLinks = kThreads / kWalkers;   // chain segments a class
constexpr int kSegs = 64;             // the cover's walkers a page
constexpr unsigned kFull = 0xffffffffu;

// the key families: 4-byte, 8-byte and 3-byte keys; bytes a key covers
__host__ __device__ inline int fam_bytes(int f) {
  return f == 0 ? 4 : (f == 1 ? 8 : 3);
}

__device__ inline int clamp_limit(const int32_t* in_sizes, int page, int S) {
  return min(max(in_sizes[page], 0), S);
}

// the little-endian word of the page at byte p (w holds the page's words)
__device__ inline uint32_t word_at(const uint32_t* w, int p) {
  return __funnelshift_r(w[p >> 2], w[(p >> 2) + 1], (p & 3) * 8);
}

__device__ inline uint32_t fam_key(const uint32_t* w, int f, int p) {
  uint32_t h = word_at(w, p);
  if (f == 2) return ((h & 0xFFFFFFu) * kHashMul8) >> 16;
  h *= kHashMul;
  if (f == 1) h ^= word_at(w, p + 4) * kHashMul8;
  return h >> 16;
}

// common prefix of the suffixes at i and c < i, in bytes, up to
// min(maxb, rem), counting from byte m0 (a multiple of 4 whose bytes
// before it are known equal): the plain version's word-by-word LCP capped
// at maxb and then at the room left in the page (words past the room
// never decide it)
__device__ inline int lcp(const uint32_t* w, int i, int c, int m0, int maxb,
                          int rem) {
  const int lim = min(maxb, rem);
  if (m0 >= lim) return lim;
  // each side's aligned words slide along: one load a side a step
  const int si = (i & 3) * 8, sc = (c & 3) * 8;
  int ai = (i + m0) >> 2, ac = (c + m0) >> 2;
  uint32_t i0 = w[ai], c0 = w[ac];
  for (int m = m0; m < lim; m += 4) {
    const uint32_t i1 = w[++ai], c1 = w[++ac];
    const uint32_t x =
        __funnelshift_r(i0, i1, si) ^ __funnelshift_r(c0, c1, sc);
    if (x) return min(m + ((__ffs(x) - 1) >> 3), lim);
    i0 = i1;
    c0 = c1;
  }
  return lim;
}

constexpr int kHead = 4;   // words of a probed suffix kept in registers
constexpr int kPresence = 3;   // bitmaps a page: the near rows' parts

// the first word of family f's presence bitmap (of nwb words) for its part
// of a page's near rows
__host__ __device__ inline size_t presence(int page, int f, int nwb) {
  return (static_cast<size_t>(page) * kPresence + f) * nwb;
}

// the words at bytes p, p + 4, ... of the page (the last read may pass
// the page's words: the room left caps what it decides)
__device__ inline void head_words(const uint32_t* w, int p,
                                  uint32_t (&h)[kHead]) {
  const int a = p >> 2, sh = (p & 3) * 8;
  uint32_t v[kHead + 1];
#pragma unroll
  for (int k = 0; k <= kHead; ++k) v[k] = w[a + k];
#pragma unroll
  for (int k = 0; k < kHead; ++k) h[k] = __funnelshift_r(v[k], v[k + 1], sh);
}

// lcp(w, i, c, 0, maxb, rem) with the suffix at i's first words in h: the
// candidate's words load at once, the rest slides on from byte 16
__device__ inline int lcp_head(const uint32_t* w, int i,
                               const uint32_t (&h)[kHead], int c, int maxb,
                               int rem) {
  const int lim = min(maxb, rem);
  uint32_t hc[kHead];
  head_words(w, c, hc);
#pragma unroll
  for (int k = 0; k < kHead; ++k) {
    if (4 * k >= lim) return lim;
    const uint32_t x = h[k] ^ hc[k];
    if (x) return min(4 * k + ((__ffs(x) - 1) >> 3), lim);
  }
  return lcp(w, i, c, 4 * kHead, maxb, rem);
}

// A slot array [0, S) split between a cluster's CTAs: CTA r holds slots
// [base, base + part) = [r part, (r + 1) part) in its shared memory at
// own, after kHalo slots that take the slots just below base; for 128 KiB
// pages the whole array is device scratch, at own - base.
template <typename Pos>
struct Split {
  Pos* own;
  int base, part, r;
  float inv;   // 1 / part, for the CTA of a slot
  bool chip;
  __device__ void put(cg::cluster_group& cluster, int s, Pos v) const {
    const int o = s - base;
    if (!chip || (o >= 0 && o < part)) {
      own[o] = v;
      return;
    }
    int t = __float2int_rz(static_cast<float>(s) * inv);
    t -= t * part > s;
    t += (t + 1) * part <= s;
    cluster.map_shared_rank(own, t)[s - t * part] = v;
  }
};

// ---------------------------------------------------------------------------
// sort_probe: the stable sort of a family's positions and the probes, a
// cluster of 2, 4 or 8 CTAs a (page, family)
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

// the exclusive prefix sum of v over the block's kThreads threads (sums:
// kWarps ints of shared memory)
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
    const int x = sums[lane];
    int run = x;
#pragma unroll
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

// What a (page, family) cluster's sort passes share: the page words, the
// family, the keyed positions [0, n), the cluster's CTAs, this CTA's rank
// and its part of the slots.
struct Sort {
  const uint32_t* w;
  int f, n, nc, r, part;
};

// element e of a pass (one of this CTA's): pass 0 sorts the positions
// [0, n) by the key's low byte, pass 1 the pass-0 order by its high byte
template <typename Pos>
__device__ inline void element(const Sort& s, int pass, const Split<Pos>& in,
                               int e, uint32_t& val, uint32_t& digit) {
  val = pass == 0 ? static_cast<uint32_t>(e)
                  : static_cast<uint32_t>(in.own[e - in.base]);
  const uint32_t key = fam_key(s.w, s.f, static_cast<int>(val));
  digit = pass == 0 ? key & 255 : key >> 8;
}

// One stable pass: this CTA's elements [r part, min(n, (r + 1) part)),
// warp wid a contiguous run of them, counted by digit into cnt[wid][digit];
// the digit's start over the cluster (every CTA's totals), the earlier
// CTAs' and warps' elements of the digit; each element to its slot of out
// (equal digits of a row ranked by one ballot a digit bit).
template <typename Pos>
__device__ void sort_pass(const Sort& s, int pass, const Split<Pos>& in,
                          const Split<Pos>& out, int* cnt, int* tot,
                          int* sums, cg::cluster_group& cluster, int tid) {
  const int lane = tid & 31, wid = tid >> 5;
  const int q = (s.part + kWarps - 1) / kWarps;
  const int lo = s.r * s.part + wid * q;
  const int hi = min(min(s.n, (s.r + 1) * s.part), lo + q);
  for (int j = tid; j < kWarps * kDigits; j += kThreads) cnt[j] = 0;
  __syncthreads();
  for (int e0 = lo; e0 < hi; e0 += 32 * kUnroll) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (e0 + 32 * u + lane < hi) {
        uint32_t val, dig;
        element(s, pass, in, e0 + 32 * u + lane, val, dig);
        atomicAdd(&cnt[wid * kDigits + dig], 1);
      }
    }
  }
  __syncthreads();
  if (tid < kDigits) {
    int run = 0;
    for (int wv = 0; wv < kWarps; ++wv) {
      const int c = cnt[wv * kDigits + tid];
      cnt[wv * kDigits + tid] = run;
      run += c;
    }
    tot[tid] = run;
  }
  cluster.sync();   // every CTA's digit totals
  int all = 0, before = 0;
  if (tid < kDigits) {
    for (int t = 0; t < s.nc; ++t) {
      const int v = t == s.r ? tot[tid] : cluster.map_shared_rank(tot, t)[tid];
      all += v;
      if (t < s.r) before += v;
    }
  }
  const int start = block_exclusive(tid < kDigits ? all : 0, sums, tid) +
                    before;
  if (tid < kDigits)
    for (int wv = 0; wv < kWarps; ++wv) cnt[wv * kDigits + tid] += start;
  __syncthreads();
  const unsigned below = (1u << lane) - 1;
  for (int e0 = lo; e0 < hi; e0 += 32 * kUnroll) {
    uint32_t val[kUnroll], dig[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      val[u] = dig[u] = 0;
      if (e0 + 32 * u + lane < hi)
        element(s, pass, in, e0 + 32 * u + lane, val[u], dig[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool ok = e0 + 32 * u + lane < hi;
      const unsigned peers = digit_peers(dig[u], ok);
      int slot = 0;
      if (ok) slot = cnt[wid * kDigits + dig[u]] + __popc(peers & below);
      __syncwarp();
      if (ok && lane == __ffs(peers) - 1)
        cnt[wid * kDigits + dig[u]] += __popc(peers);
      __syncwarp();
      if (ok) out.put(cluster, slot, static_cast<Pos>(val[u]));
    }
  }
  cluster.sync();   // every slot written, in every CTA
}

constexpr int kHalo = 16;   // slots below a CTA's own that its probes read
constexpr int kBatch = 4;   // probes whose slots load together

// Family F's probes of sorted slot i (Bp[j] the position at slot j, Kp[j]
// its key, for j from i - 16 to i), the warp's lanes on consecutive slots
// (valid: the slot is one of the CTA's keyed ones): the nearest earlier
// positions with its key are the slots just below it, ranked by a common
// prefix capped at maxb bytes (8 for the 3-byte family) and the room
// left; the first strictly longest wins. Writes the winner as len << 24 |
// distance at p (len its full prefix up to 192 bytes) for families 0 and
// 1, and with the candidates the family's first probes (prefix << 24 |
// distance, 0 where the prefix is) into p's row of near: family 0 at 0-2,
// 1 at 4-5, 2 at 6-7. Each is stored only where it is not 0 (the words
// over an array the cluster cleared, the rows' parts with p's bit set in
// a presence bitmap): on near-random pages most are 0, and their
// scattered stores were most of the kernel's time.
//
// Every lane takes its first probe together; probe k's prefix is then at
// least min(probe k - 1's, the first probe of the lane k - 1 below), the
// prefix of slot i - k + 1 against i - k (the suffixes at i, i - k + 1
// and i - k share it): where that reaches the cap the probe compares
// nothing, else it compares from there.
template <int F, typename Pos>
__device__ void probe_slot(const uint32_t* w, const Pos* Bp, const Pos* Kp,
                           int i, bool valid, int page, int S, int limit,
                           int maxb, uint32_t* __restrict__ res,
                           uint32_t* __restrict__ near,
                           uint32_t* __restrict__ bits) {
  constexpr int kProbes = F == 0 ? 16 : (F == 1 ? 4 : 2);
  constexpr int kNear = F == 0 ? 3 : 2;
  constexpr int kSlot = F == 0 ? 0 : (F == 1 ? 4 : 6);
  const int lane = threadIdx.x & 31;
  const int mb = F == 2 ? 8 : maxb;
  int p = 0, rem = 0, l1 = 0, c1 = 0;
  uint32_t key = 0, h[kHead];
  if (valid) {
    p = Bp[i];
    key = Kp[i];
    rem = limit - p;
    head_words(w, p, h);
    if (i >= 1 && Kp[i - 1] == key) {
      c1 = Bp[i - 1];
      l1 = lcp_head(w, p, h, c1, mb, rem);
    }
  }
  int below[kBatch - 1];   // the first probes of the lanes 1, 2, 3 below
#pragma unroll
  for (int u = 1; u < kBatch; ++u) {
    const int v = __shfl_up_sync(kFull, l1, u);
    below[u - 1] = lane >= u ? v : 0;
  }
  if (!valid) return;
  // probes past one that reaches the cap cannot be strictly longer: they
  // stop there, after the near slots' probes
  const int lim = min(mb, rem), last = near != nullptr ? kNear : 0;
  int fl = 0, fd = 0, prev = 0;
  uint32_t tail = 0;    // the best's word that ends at byte fl (fl >= 3)
  uint32_t nr[kNear];   // the near probes: prefix << 24 | distance
#pragma unroll
  for (int j = 0; j < kNear; ++j) nr[j] = 0;
  bool more = i >= 1 && Kp[i - 1] == key;
  if (more) {   // probe 1
    prev = l1;
    if (l1 > 0) {
      nr[0] = static_cast<uint32_t>(l1) << kLenShift |
              static_cast<uint32_t>(p - c1);
      fl = l1;
      fd = p - c1;
      if (fl >= 3 && fl < lim) tail = word_at(w, p + fl - 3);
    }
    if (fl == lim && 1 >= last) more = false;
  }
#pragma unroll
  for (int k0 = 2; k0 <= kProbes; k0 += kBatch) {
    if (!more) break;
    int c[kBatch];
    bool same[kBatch];
    // the batch's slots, loaded at once (none below the halo)
#pragma unroll
    for (int u = 0; u < kBatch && k0 + u <= kProbes; ++u) {
      const int j = max(i - k0 - u, 0);
      same[u] = i - k0 - u >= 0 && Kp[j] == key;
      c[u] = Bp[j];
    }
#pragma unroll
    for (int u = 0; u < kBatch && k0 + u <= kProbes; ++u) {
      const int k = k0 + u;
      if (!same[u]) {
        more = false;
        break;
      }
      // a probe can be strictly longer than the best only where its word
      // ending at byte fl matches: past the near slots, that word first
      if (k > last && fl >= 3 && word_at(w, c[u] + fl - 3) != tail) {
        prev = 0;
        continue;
      }
      const int lb = k <= kBatch ? min(prev, below[k - 2]) : 0;
      const int ml = lb >= lim ? lim
                     : lb >= 4 ? lcp(w, p, c[u], lb & ~3, mb, rem)
                               : lcp_head(w, p, h, c[u], mb, rem);
      prev = ml;
      if (k <= kNear && ml > 0)
        nr[k - 1] = static_cast<uint32_t>(ml) << kLenShift |
                    static_cast<uint32_t>(p - c[u]);
      if (ml > fl) {
        fl = ml;
        fd = p - c[u];
        if (fl >= 3 && fl < lim) tail = word_at(w, p + fl - 3);
      }
      if (fl == lim && k >= last) {
        more = false;
        break;
      }
    }
  }
  // only what is not 0 is stored: the families' words over a cleared
  // array, the near rows' parts with a bit in their presence bitmap
  if (F < 2 && fd > 0) {
    // the capped prefix fell short of the cap: it is the full one
    const int len = fl < mb ? fl : lcp(w, p, p - fd, mb, kCapMax, rem);
    res[(static_cast<size_t>(page) * kFamilies + F) * S + p] =
        static_cast<uint32_t>(len) << kLenShift | static_cast<uint32_t>(fd);
  }
  if (near != nullptr && (nr[0] | nr[1] | nr[kNear - 1])) {
    // the family's part of p's row, one store
    uint32_t* row = near + (static_cast<size_t>(page) * S + p) * kSlots + kSlot;
    if constexpr (F == 0)
      *reinterpret_cast<uint4*>(row) = make_uint4(nr[0], nr[1], nr[2], 0);
    else
      *reinterpret_cast<uint2*>(row) = make_uint2(nr[0], nr[1]);
    atomicOr(bits + presence(page, F, (S + 31) >> 5) + (p >> 5),
             1u << (p & 31));
  }
}

// the slots a CTA of a cluster of nc holds
__host__ __device__ inline int slot_part(int S, int nc) {
  return (S + nc - 1) / nc;
}

template <typename Pos>
__global__ void __launch_bounds__(kThreads, 1)
    sort_probe_kernel(const uint8_t* __restrict__ pages,
                      const int32_t* __restrict__ in_sizes, int S, int nfam,
                      int rank_words, uint32_t* __restrict__ res,
                      Pos* __restrict__ slots, uint32_t* __restrict__ near,
                      uint32_t* __restrict__ bits) {
  extern __shared__ __align__(16) uint32_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int nc = static_cast<int>(cluster.num_blocks());
  const int r = static_cast<int>(cluster.block_rank());
  const int pf = blockIdx.x / nc;
  const int page = pf / nfam, f = pf % nfam;
  const int limit = clamp_limit(in_sizes, page, S);
  const int part = slot_part(S, nc), base = r * part;
  constexpr bool kOnChip = sizeof(Pos) == 2;   // 16-bit slots: S <= 64 KiB
  uint32_t* w = smem;                                   // [S / 4 + 2]
  int* tot = reinterpret_cast<int*>(w + S / 4 + 2);     // [256]
  int* sums = tot + kDigits;                            // [warps]
  int* cnt = sums + kWarps;                             // [warps][256]
  // the slots, A (pass 0's order, then the sorted keys) and B (the sorted
  // positions): on chip, this CTA's part of each after kHalo slots that
  // take the ones just below it
  Split<Pos> A, B;
  if (kOnChip) {
    Pos* local = reinterpret_cast<Pos*>(cnt + kWarps * kDigits);
    A.own = local + kHalo;
    B.own = A.own + part + kHalo;
  } else {
    A.own = slots + static_cast<size_t>(pf) * 2 * S + base;
    B.own = A.own + S;
  }
  A.base = B.base = base;
  A.part = B.part = part;
  A.r = B.r = r;
  A.inv = B.inv = 1.0f / static_cast<float>(part);
  A.chip = B.chip = kOnChip;
  const uint32_t* src = reinterpret_cast<const uint32_t*>(
      pages + static_cast<size_t>(page) * S);
  for (int j = tid; j < S / 4; j += kThreads) w[j] = src[j];
  if (tid < 2) w[S / 4 + tid] = 0;
  {   // this (page, family)'s words and presence bitmap, cleared before
      // the first cluster barrier orders them ahead of the probes' stores
    const int nwb = (S + 31) >> 5;
    if (f < kFamilies)
      for (int j = r * kThreads + tid; j < S; j += nc * kThreads)
        res[(static_cast<size_t>(page) * kFamilies + f) * S + j] = 0;
    if (near != nullptr)
      for (int j = r * kThreads + tid; j < nwb; j += nc * kThreads)
        bits[presence(page, f, nwb) + j] = 0;
  }
  __syncthreads();

  const Sort s{w, f, max(0, limit - fam_bytes(f) + 1), nc, r, part};
  sort_pass(s, 0, A, A, cnt, tot, sums, cluster, tid);
  sort_pass(s, 1, A, B, cnt, tot, sums, cluster, tid);
  // the keys of this CTA's sorted slots, into A (free after pass 1)
  const int i1 = min(s.n, base + part);
  for (int i = base + tid; i < i1; i += kThreads)
    A.own[i - base] = static_cast<Pos>(fam_key(w, f, B.own[i - base]));
  cluster.sync();
  // slot j of either at Bp[j], Kp[j], for j from base - kHalo on
  const Pos* Bp = B.own - base;
  const Pos* Kp = A.own - base;
  if (kOnChip) {
    const int j = base - kHalo + tid;   // the halo's slots, from their CTAs
    if (tid < kHalo && j >= 0) {
      const int t = j / part;
      A.own[tid - kHalo] = cluster.map_shared_rank(A.own, t)[j - t * part];
      B.own[tid - kHalo] = cluster.map_shared_rank(B.own, t)[j - t * part];
    }
    __syncthreads();
  }

  const int maxb = 4 * rank_words;
  // each warp a run of 32 consecutive slots
  for (int i0 = base + (tid & ~31); i0 < i1; i0 += kThreads) {
    const int i = i0 + (tid & 31);
    if (f == 0)
      probe_slot<0>(w, Bp, Kp, i, i < i1, page, S, limit, maxb, res, near,
                    bits);
    else if (f == 1)
      probe_slot<1>(w, Bp, Kp, i, i < i1, page, S, limit, maxb, res, near,
                    bits);
    else
      probe_slot<2>(w, Bp, Kp, i, i < i1, page, S, limit, maxb, res, near,
                    bits);
  }
  cluster.sync();   // the other CTAs read this one's slots until here
}

// ---------------------------------------------------------------------------
// finish: the runs, the fold, the chain extension, then slot 0 or the
// greedy cover, a page
// ---------------------------------------------------------------------------

__device__ inline bool bit(const uint32_t* bm, int p) {
  return (bm[p >> 5] >> (p & 31)) & 1;
}

// The first set bit of bits at or after j (S if none): after[k] holds the
// first set bit past word k (0 for none: no bit past a word is bit 0).
template <typename Fin>
__device__ inline int next_set(const uint32_t* bits, const Fin* after, int j,
                               int S) {
  if (j >= S) return S;
  const uint32_t b = bits[j >> 5] & (kFull << (j & 31));
  if (b) return min(((j >> 5) << 5) + __ffs(b) - 1, S);
  const int a = static_cast<int>(after[j >> 5]);
  return a ? a : S;
}

// the minimum of v over the block's threads after this one (S for the
// last; sums: kWarps ints of shared memory)
__device__ int block_min_after(int v, int S, int* sums, int tid) {
  const int lane = tid & 31, wid = tid >> 5;
  int incl = v;   // the minimum over this lane and the warp's later lanes
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_down_sync(kFull, incl, off);
    if (lane + off < 32) incl = min(incl, y);
  }
  if (lane == 0) sums[wid] = incl;
  __syncthreads();
  if (wid == 0) {
    int run = sums[lane];
#pragma unroll
    for (int off = 1; off < kWarps; off <<= 1) {
      const int y = __shfl_down_sync(kFull, run, off);
      if (lane + off < kWarps) run = min(run, y);
    }
    sums[lane] = run;
  }
  __syncthreads();
  int out = __shfl_down_sync(kFull, incl, 1);
  if (lane == 31) out = S;
  if (wid + 1 < kWarps) out = min(out, sums[wid + 1]);
  __syncthreads();
  return out;
}

// after[k] for a bitmap of S bits: each thread a contiguous share of its
// words, the first set bit past each word from the minimum over the later
// shares
template <typename Fin>
__device__ void build_after(const uint32_t* bits, Fin* after, int S,
                            int* sums, int tid) {
  const int nw = (S + 31) >> 5;
  const int share = (nw + kThreads - 1) / kThreads;
  const int lo = min(nw, tid * share), hi = min(nw, lo + share);
  auto first = [&](int k) {
    return bits[k] ? min((k << 5) + __ffs(bits[k]) - 1, S) : S;
  };
  int m = S;
  for (int k = hi - 1; k >= lo; --k) m = min(m, first(k));
  int nxt = block_min_after(m, S, sums, tid);
  for (int k = hi - 1; k >= lo; --k) {
    after[k] = static_cast<Fin>(nxt < S ? nxt : 0);
    nxt = min(nxt, first(k));
  }
}

// What the finish block reads of a page: the families' results, the run
// breaks (a bit a position where no distance-1 run continues: p = 0, p at
// or past the page's size, or byte p != byte p - 1) with the first break
// past each word, and the fold's cap.
template <typename Fin>
struct Page {
  const uint32_t* res0;
  const uint32_t* res1;
  const uint32_t* brk;
  const Fin* brk_after;
  int S, limit, maxb;
};

// position p's length and distance before the chain: family 0's winner,
// family 1's only where its capped prefix is strictly longer, then the
// distance-1 run at p (to the next break) where it is strictly longer
template <typename Fin>
__device__ inline void fold(const Page<Fin>& g, int p, int& len, int& dist) {
  const uint32_t r0 = g.res0[p];   // 0 where family 0 has no key or probe
  const uint32_t r1 = g.res1[p];
  const int l0 = static_cast<int>(r0 >> kLenShift);
  const int l1 = static_cast<int>(r1 >> kLenShift);
  const bool second = min(l1, g.maxb) > min(l0, g.maxb);
  len = second ? l1 : l0;
  dist = static_cast<int>((second ? r1 : r0) & kDistMask);
  const int run =
      bit(g.brk, p) ? 0 : next_set(g.brk, g.brk_after, p, g.S) - p;
  if (run > len) {
    len = run;
    dist = 1;
  }
}

template <typename Fin>
__device__ inline int dist_at(const Page<Fin>& g, int p) {
  int len, dist;
  fold(g, p, len, dist);
  return dist;
}

// the cover's segments: kSegs a page, their node lists' capacity
__host__ __device__ inline int seg_bytes(int S) {
  return (S + kSegs - 1) / kSegs;
}
__host__ __device__ inline int seg_cap(int S) { return seg_bytes(S) / 4 + 2; }
// entries of a page's per-word arrays (a word a 32 positions), rounded up
// to keep what follows them aligned
__host__ __device__ inline int words_room(int S) {
  return (((S + 31) >> 5) + 3) & ~3;
}
// the node lists' room, in elements of 2 (up to 64 KiB pages) or 4 bytes:
// the lists, or the chain's segment records (4 ints a thread) before them
__host__ __device__ inline int node_room(int S, int elem) {
  const int lists = 2 * kSegs * seg_cap(S), records = 4 * kThreads * 4 / elem;
  return lists > records ? lists : records;
}

template <typename Fin>
__global__ void __launch_bounds__(kThreads, 1)
    finish_kernel(const uint8_t* __restrict__ pages,
                  const int32_t* __restrict__ in_sizes, int S, int parts,
                  int max_cmds, int cap, int maxb,
                  const uint32_t* __restrict__ res,
                  const uint32_t* __restrict__ near,
                  const uint32_t* __restrict__ bits, Fin* __restrict__ gfin,
                  Fin* __restrict__ gnodes, int32_t* __restrict__ ins,
                  int32_t* __restrict__ cpy, int32_t* __restrict__ dist,
                  int32_t* __restrict__ ncmds, int32_t* __restrict__ cand_len,
                  int32_t* __restrict__ cand_dist) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int page = blockIdx.x / parts, share = blockIdx.x % parts;
  const int limit = clamp_limit(in_sizes, page, S);
  const int nw = (S + 31) >> 5, nwa = words_room(S);
  const int seg = seg_bytes(S), scap = seg_cap(S);
  const bool cands = cand_len != nullptr;
  constexpr bool kOnChip = sizeof(Fin) == 2;   // S <= 64 KiB
  uint32_t* brk = smem;                    // [nwa] run breaks
  int* sums = reinterpret_cast<int*>(brk + nwa);   // [kWarps]
  int* cnts = sums + kWarps;               // [kSegs] walker nodes
  int* exits = cnts + kSegs;               // [kSegs] walker's first past it
  int* pcount = exits + kSegs;             // [kSegs] nodes before the join
  int* join = pcount + kSegs;              // [kSegs] join node, or -1
  int* from = join + kSegs;                // [kSegs] join's walker index
  int* off = from + kSegs;                 // [kSegs + 1] first command
  int* pend = off + kSegs + 1;             // [kSegs] end before the segment
  int* count = pend + kSegs;               // [3] the commands kept
  Fin* brk_after = reinterpret_cast<Fin*>(count + 3);   // [nwa]
  // fin: the lengths before and after the chain, [S]
  Fin* fin = kOnChip ? brk_after + nwa : gfin + static_cast<size_t>(page) * S;
  // the rest: for the cover the taken positions, the chain links (then
  // the segment walkers' nodes), the first taken position past each word
  // and the node lists ([kSegs][scap] the walkers' nodes, then the true
  // path's before each join; the chain's segment records before them);
  // for the candidates the chain links and records
  uint32_t* rest = reinterpret_cast<uint32_t*>(kOnChip ? fin + S : fin);
  if (!kOnChip) rest = reinterpret_cast<uint32_t*>(brk_after + nwa);
  uint32_t* bm = cands ? nullptr : rest;
  uint32_t* onpath = cands ? rest : rest + nwa;
  Fin* bm_after = reinterpret_cast<Fin*>(rest + 2 * nwa);
  Fin* walk = kOnChip ? bm_after + nwa
                      : gnodes + static_cast<size_t>(page) * node_room(S, 4);
  Fin* pre = walk + kSegs * scap;
  int* rec = cands && kOnChip ? reinterpret_cast<int*>(rest + nwa)
                              : reinterpret_cast<int*>(walk);
  const int nwb = (S + 31) >> 5;
  const Page<Fin> g{res + static_cast<size_t>(page) * kFamilies * S,
                    res + (static_cast<size_t>(page) * kFamilies + 1) * S,
                    brk, brk_after, S, limit, maxb};
  const size_t row = static_cast<size_t>(page) * S;

  // ---- the run breaks ----
  const uint32_t* src = reinterpret_cast<const uint32_t*>(pages + row);
  for (int j = tid; j < nw; j += kThreads) {
    const int p0 = j << 5;
    uint32_t prev = p0 > 0 ? src[(p0 >> 2) - 1] >> 24 : 0;
    uint32_t m = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int wi = (p0 >> 2) + k;
      const uint32_t v = wi < (S >> 2) ? src[wi] : 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int p = p0 + 4 * k + b;
        const uint32_t cur = (v >> (8 * b)) & 255;
        if (!(p >= 1 && p < limit && cur == prev)) m |= 1u << (4 * k + b);
        prev = cur;
      }
    }
    brk[j] = m;
  }
  __syncthreads();
  build_after(brk, brk_after, S, sums, tid);
  __syncthreads();

  // ---- the fold: each position's length before the chain, and the chain
  // links: a length of exactly 192 whose continuation at +192 has a length
  // and the same distance (a warp's 32 positions are one word of links) ----
  for (int p0 = tid; p0 - lane < S; p0 += 4 * kThreads) {
    int len[4], d[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (p0 + u * kThreads < S) fold(g, p0 + u * kThreads, len[u], d[u]);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int p = p0 + u * kThreads;
      bool link = false;
      if (p < S) {
        fin[p] = static_cast<Fin>(len[u]);
        if (len[u] == kCapMax && p + kCapMax < S) {
          int l2, d2;
          fold(g, p + kCapMax, l2, d2);
          link = l2 > 0 && d2 == d[u];
        }
      }
      const unsigned m = __ballot_sync(kFull, link);
      if (lane == 0 && p < S) onpath[p >> 5] = m;
    }
  }
  __syncthreads();

  // ---- the chain: residue class c mod 192 is the positions c + 192 m, a
  // link at p joins p's 192 bytes to what follows from p + 192: walked
  // downwards, a position's links to the chain's end (cnt) and the length
  // there (term). Each class in kLinks segments of m, one a thread: a
  // segment settles its positions below its first unlinked one, and
  // records how many above it wait for what comes in from the segment
  // above; one thread a class then passes the (cnt, term) down the
  // segments, and the waiting positions are settled. ----
  auto settle = [&](int p, int cnt, int term) {
    fin[p] = static_cast<Fin>(min(kCapMax * cnt + term, max(limit - p, 0)));
  };
  const int cls = tid % kWalkers, part = tid / kWalkers;
  const int nm = cls < S ? (S - 1 - cls) / kCapMax + 1 : 0;
  const int span = (nm + kLinks - 1) / kLinks;
  const int mlo = min(nm, part * span), mhi = min(nm, mlo + span);
  if (part < kLinks) {
    int lead = 0, cnt = 0, term = 0;
    bool known = false;
    for (int m = mhi - 1; m >= mlo; --m) {
      const int p = cls + kCapMax * m;
      const int l = static_cast<int>(fin[p]);
      if (!bit(onpath, p)) {
        known = true;
        cnt = 0;
        term = l;
      } else if (known) {
        ++cnt;
      } else {
        ++lead;
        continue;
      }
      settle(p, cnt, term);
    }
    rec[4 * tid] = lead;
    rec[4 * tid + 1] = cnt;
    rec[4 * tid + 2] = term;
    rec[4 * tid + 3] = known;
  }
  __syncthreads();
  if (tid < kWalkers) {   // (cnt, term) into each segment, from the top
    int cnt = 0, term = 0;
    for (int k = kLinks - 1; k >= 0; --k) {
      int* x = rec + 4 * (k * kWalkers + tid);
      const int lead = x[0], ocnt = x[1], oterm = x[2], known = x[3];
      x[1] = cnt;
      x[2] = term;
      if (known) {
        cnt = ocnt;
        term = oterm;
      } else {
        cnt += lead;
      }
    }
  }
  __syncthreads();
  if (part < kLinks && rec[4 * tid] > 0) {   // the waiting positions
    int cnt = rec[4 * tid + 1];
    const int term = rec[4 * tid + 2];
    for (int m = mhi - 1; m >= mhi - rec[4 * tid]; --m)
      settle(cls + kCapMax * m, ++cnt, term);
  }
  __syncthreads();

  if (cands) {
    // ---- the candidates' rows of this block's share, each written once:
    // slot 0 the chained length and the fold's distance; slots 1-7 the
    // families' near probes, gated and clipped to cap ----
    const int chunk = (S + parts - 1) / parts;
    for (int p = share * chunk + tid; p < min(S, (share + 1) * chunk);
         p += kThreads) {
      const uint32_t* nr = near + (row + p) * kSlots;
      const uint32_t* has = bits + presence(page, 0, nwb);
      const uint4 a = bit(has, p) ? *reinterpret_cast<const uint4*>(nr)
                                  : make_uint4(0, 0, 0, 0);
      const uint2 b = bit(has + nwb, p)
                          ? *reinterpret_cast<const uint2*>(nr + 4)
                          : make_uint2(0, 0);
      const uint2 c = bit(has + 2 * nwb, p)
                          ? *reinterpret_cast<const uint2*>(nr + 6)
                          : make_uint2(0, 0);
      const uint32_t v[kSlots - 1] = {a.x, a.y, a.z, b.x, b.y, c.x, c.y};
      int L[kSlots], D[kSlots];
      const int v0 = min(static_cast<int>(fin[p]), cap);
      L[0] = v0 >= kMinMatch ? v0 : 0;
      D[0] = dist_at(g, p);
#pragma unroll
      for (int j = 0; j < kSlots - 1; ++j) {
        const int ml = static_cast<int>(v[j] >> kLenShift);
        int x;
        if (j >= 5) {   // the 3-byte family's slots
          x = min(ml >= 2 ? ml : 0, cap);
        } else {
          x = min(ml, cap);
          x = x >= kMinMatch ? x : 0;
        }
        L[j + 1] = x;
        D[j + 1] = static_cast<int>(v[j] & kDistMask);
      }
      int4* cl = reinterpret_cast<int4*>(cand_len + (row + p) * kSlots);
      int4* cd = reinterpret_cast<int4*>(cand_dist + (row + p) * kSlots);
      cl[0] = make_int4(L[0], L[1], L[2], L[3]);
      cl[1] = make_int4(L[4], L[5], L[6], L[7]);
      cd[0] = make_int4(D[0], D[1], D[2], D[3]);
      cd[1] = make_int4(D[4], D[5], D[6], D[7]);
    }
    return;
  }
  // ---- the taken positions: a match of at least 4 bytes inside the page
  // (a warp a word, a lane a position) ----
  for (int j = wid; j < nw; j += kWarps) {
    const int p = (j << 5) + lane;
    bool taken = false;
    if (p < S) {
      const int fl = static_cast<int>(fin[p]);
      taken = fl >= kMinMatch && p + fl <= limit;
    }
    const unsigned m = __ballot_sync(kFull, taken);
    if (lane == 0) {
      bm[j] = m;
      onpath[j] = 0;
    }
  }
  __syncthreads();
  build_after(bm, bm_after, S, sums, tid);
  __syncthreads();
  // a taken position's successor: the first taken position at or after
  // its end
  auto succ = [&](int i) {
    return next_set(bm, bm_after, i + static_cast<int>(fin[i]), S);
  };

  // ---- the cover, in segments: walker k follows the successors from the
  // first taken position of its segment to the first past it, marking its
  // nodes; a path that reaches one of them follows the walker from there ----
  if (tid < kSegs) {
    const int hi = min(S, (tid + 1) * seg);
    int x = next_set(bm, bm_after, tid * seg, S), n = 0;
    while (x < hi) {
      walk[tid * scap + n++] = static_cast<Fin>(x);
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
    int t = next_set(bm, bm_after, 0, S);
    for (int k = 0; k < kSegs; ++k) {
      const int hi = min(S, (k + 1) * seg);
      int p = 0;
      while (t < hi && !bit(onpath, t)) {
        pre[k * scap + p++] = static_cast<Fin>(t);
        t = succ(t);
      }
      pcount[k] = p;
      join[k] = t < hi ? t : -1;
      if (t < hi) t = exits[k];
    }
  }
  __syncthreads();
  auto node = [&](int k, int i) {
    return static_cast<int>(i < pcount[k]
                                ? pre[k * scap + i]
                                : walk[k * scap + from[k] + i - pcount[k]]);
  };
  // where each join falls in its walker's list (the walker's marks in the
  // segment before it), the segment's commands, and the end of its last
  if (tid < kSegs) {
    int j = cnts[tid];
    if (join[tid] >= 0) {
      const int lo = tid * seg, y = join[tid];
      j = 0;
      for (int wv = lo >> 5; y > lo && wv <= (y - 1) >> 5; ++wv) {
        uint32_t bits = onpath[wv];
        if (wv == lo >> 5) bits &= kFull << (lo & 31);
        if (wv == (y - 1) >> 5) bits &= kFull >> (31 - ((y - 1) & 31));
        j += __popc(bits);
      }
    }
    from[tid] = j;
    const int c = pcount[tid] + cnts[tid] - j;
    off[tid] = c;
    if (c > 0) {
      const int last = node(tid, c - 1);
      pend[tid] = last + static_cast<int>(fin[last]);
    } else {
      pend[tid] = -1;
    }
  }
  __syncthreads();
  // the segments' first commands and the end before each (thread 0 over
  // the 64 counts)
  if (tid == 0) {
    int total = 0, end = 0;
    for (int k = 0; k < kSegs; ++k) {
      const int c = off[k], e = pend[k];
      off[k] = total;
      pend[k] = end;
      if (c > 0) end = e;
      total += c;
    }
    off[kSegs] = total;
    *count = min(total, max_cmds);
    ncmds[page] = *count;
  }
  __syncthreads();
  const int n = *count;
  const size_t orow = static_cast<size_t>(page) * max_cmds;
  for (int o = tid; o < max_cmds; o += kThreads) {
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
        prev_end = q + static_cast<int>(fin[q]);
      }
      a = pos - prev_end;
      b = static_cast<int>(fin[pos]);
      c = dist_at(g, pos);
    }
    ins[orow + o] = a;
    cpy[orow + o] = b;
    dist[orow + o] = c;
  }
}

// Where a call's scratch keeps what (int32 words): the families' results;
// for the candidates the near probes (a row of 8 words a position); the
// presence bitmaps; past 64 KiB pages the sort's slots, the lengths and
// the node lists.
struct Layout {
  long long res, near, bits, slots, fin, nodes, total;
};

Layout layout(int P, int S, int nfam) {
  const bool big = S > kSmallPage;
  const long long pos = static_cast<long long>(P) * S;
  Layout l{};
  l.res = 0;
  l.near = l.res + pos * kFamilies;
  l.bits = l.near + (nfam > kFamilies ? pos * kSlots : 0);
  l.slots = l.bits + static_cast<long long>(presence(P, 0, (S + 31) >> 5));
  l.fin = l.slots + (big ? pos * nfam * 2 : 0);
  l.nodes = l.fin + (big ? pos : 0);
  l.total = l.nodes + (big ? static_cast<long long>(P) * node_room(S, 4) : 0);
  return l;
}

// dynamic shared memory of each kernel, in bytes (sort_probe: a CTA of a
// cluster of nc)
long long sort_probe_smem(int S, int nc) {
  long long bytes = 4LL * (S / 4 + 2 + kDigits + kWarps + kWarps * kDigits);
  if (S <= kSmallPage)   // A's part and B's part, each after its halo
    bytes += 2LL * 2 * (slot_part(S, nc) + kHalo);
  return bytes;
}
long long finish_smem(int S) {
  const bool big = S > kSmallPage;
  const long long nwa = words_room(S), fin = big ? 4 : 2;
  const long long head = 4 * nwa + 4 * (kWarps + 7 * kSegs + 4) + fin * nwa +
                         (big ? 0 : fin * S);
  const long long cover =
      8 * nwa + fin * nwa + (big ? 0 : fin * node_room(S, 2));
  const long long cands = 4 * nwa + (big ? 0 : 16LL * kThreads);
  return head + (cover > cands ? cover : cands);
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return n;
}

// CTAs a (page, family) cluster: the most of 2, 4 and 8 whose CTAs, a
// cluster each (page, family), number no more than the card's SMs, each
// CTA's part at least the probes' halo (2 where none fits: the q1
// batch's 64 families take 128 SMs). A CTA takes an SM of its own (its
// shared memory), and the card places 66 clusters of 2, 30 of 4 and 15
// of 8 at once (blg_match_max_clusters), so an 8-page batch's 16
// clusters of 8 run as 15 and 1.
int cluster_size(int P, int S, int nfam) {
  const int sms = sm_count();
  int nc = 2;
  for (int c = 4; c <= kMaxCluster; c *= 2)
    if (static_cast<long long>(P) * nfam * c <= sms && S / c >= kHalo) nc = c;
  return nc;
}

// blocks a page of the finish kernel: for the candidates' rows (up to 64
// KiB pages) as many as fill the card, up to 8, each block redoing its
// page's chain; 1 for the cover
int finish_parts(int P, int S, bool cands) {
  if (!cands || S > kSmallPage) return 1;
  const int n = sm_count() / P;
  return n < 1 ? 1 : (n > 8 ? 8 : n);
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

template <typename Pos>
int launch_sort_probe(const void* pages, const void* in_sizes, int P, int S,
                      int nfam, int rank_words, int32_t* scratch,
                      cudaStream_t stream) {
  const int nc = cluster_size(P, S, nfam);
  const long long smem = sort_probe_smem(S, nc);
  cudaError_t e = set_smem(sort_probe_kernel<Pos>, smem);
  if (e != cudaSuccess) return launch_error(e);
  const Layout l = layout(P, S, nfam);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nc * P * nfam, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(
      &cfg, sort_probe_kernel<Pos>, static_cast<const uint8_t*>(pages),
      static_cast<const int32_t*>(in_sizes), S, nfam, rank_words,
      reinterpret_cast<uint32_t*>(scratch + l.res),
      S > kSmallPage ? reinterpret_cast<Pos*>(scratch + l.slots) : nullptr,
      nfam > kFamilies ? reinterpret_cast<uint32_t*>(scratch + l.near)
                       : nullptr,
      reinterpret_cast<uint32_t*>(scratch + l.bits));
  return launch_error(e);
}

template <typename Fin>
int launch_finish(const void* pages, const void* in_sizes, int P, int S,
                  int nfam, int max_cmds, int cap, int rank_words,
                  int32_t* scratch, void* ins, void* cpy, void* dist,
                  void* ncmds, void* cand_len, void* cand_dist,
                  cudaStream_t stream) {
  const long long smem = finish_smem(S);
  cudaError_t e = set_smem(finish_kernel<Fin>, smem);
  if (e != cudaSuccess) return launch_error(e);
  const Layout l = layout(P, S, nfam);
  const bool big = S > kSmallPage;
  const int parts = finish_parts(P, S, cand_len != nullptr);
  finish_kernel<Fin><<<P * parts, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(pages), static_cast<const int32_t*>(in_sizes),
      S, parts, max_cmds, cap, 4 * rank_words,
      reinterpret_cast<const uint32_t*>(scratch + l.res),
      nfam > kFamilies ? reinterpret_cast<const uint32_t*>(scratch + l.near)
                       : nullptr,
      reinterpret_cast<const uint32_t*>(scratch + l.bits),
      big ? reinterpret_cast<Fin*>(scratch + l.fin) : nullptr,
      big ? reinterpret_cast<Fin*>(scratch + l.nodes) : nullptr,
      static_cast<int32_t*>(ins), static_cast<int32_t*>(cpy),
      static_cast<int32_t*>(dist), static_cast<int32_t*>(ncmds),
      static_cast<int32_t*>(cand_len), static_cast<int32_t*>(cand_dist));
  return launch_error(cudaSuccess);
}

}  // namespace
}  // namespace blg_match

// Dynamic shared memory of the finish kernel at page size S, in bytes.
extern "C" long long blg_match_finish_smem(int S) {
  return blg_match::finish_smem(S);
}

// Blocks a page of the finish kernel for P pages of S bytes: the
// candidates' rows (cands 1) or the cover (cands 0).
extern "C" int blg_match_finish_parts(int P, int S, int cands) {
  return blg_match::finish_parts(P, S, cands != 0);
}

// CTAs a cluster of the sort_probe kernel for P pages of S bytes and nfam
// key families, and its dynamic shared memory a CTA.
extern "C" int blg_match_cluster_size(int P, int S, int nfam) {
  return blg_match::cluster_size(P, S, nfam);
}
extern "C" long long blg_match_sort_probe_smem(int S, int nc) {
  return blg_match::sort_probe_smem(S, nc);
}

// Clusters of nc CTAs of the sort_probe kernel that the current device
// holds at once at page size S (0 when the query fails).
extern "C" int blg_match_max_clusters(int S, int nc) {
  using namespace blg_match;
  const long long smem = sort_probe_smem(S, nc);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nc * 256, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  const bool big = S > kSmallPage;
  cudaError_t e = big ? set_smem(sort_probe_kernel<uint32_t>, smem)
                      : set_smem(sort_probe_kernel<uint16_t>, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveClusters(
        &n,
        big ? reinterpret_cast<const void*>(sort_probe_kernel<uint32_t>)
            : reinterpret_cast<const void*>(sort_probe_kernel<uint16_t>),
        &cfg);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return n;
}

// The int32 words of a call's scratch: nfam key families (2 for the cover,
// 3 for the candidates) over P pages of S bytes.
extern "C" long long blg_match_scratch_ints(int P, int S, int nfam) {
  return blg_match::layout(P, S, nfam).total;
}

// Launch the sort_probe kernel: a cluster of 2, 4 or 8 CTAs a (page,
// family) (blg_match_cluster_size); nfam 2 for the cover, 3 for the
// candidates.
extern "C" int blg_match_sort_probe(const void* pages, const void* in_sizes,
                                    int P, int S, int nfam, int rank_words,
                                    void* scratch, void* stream) {
  using namespace blg_match;
  if (P <= 0) return 0;
  int32_t* sc = static_cast<int32_t*>(scratch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return S > kSmallPage
             ? launch_sort_probe<uint32_t>(pages, in_sizes, P, S, nfam,
                                           rank_words, sc, st)
             : launch_sort_probe<uint16_t>(pages, in_sizes, P, S, nfam,
                                           rank_words, sc, st);
}

// Launch the finish kernel: the commands (ins, cpy, dist [P, max_cmds],
// ncmds [P]) for the cover, a block a page; the rows of cand_len and
// cand_dist [P, S, 8] (non-null, lengths clipped to cap) for the
// candidates, a page's rows split over the blocks that fill the card.
extern "C" int blg_match_finish(const void* pages, const void* in_sizes,
                                int P, int S, int nfam, int max_cmds, int cap,
                                int rank_words, void* scratch, void* ins,
                                void* cpy, void* dist, void* ncmds,
                                void* cand_len, void* cand_dist,
                                void* stream) {
  using namespace blg_match;
  if (P <= 0) return 0;
  int32_t* sc = static_cast<int32_t*>(scratch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return S > kSmallPage
             ? launch_finish<uint32_t>(pages, in_sizes, P, S, nfam, max_cmds,
                                       cap, rank_words, sc, ins, cpy, dist,
                                       ncmds, cand_len, cand_dist, st)
             : launch_finish<uint16_t>(pages, in_sizes, P, S, nfam, max_cmds,
                                       cap, rank_words, sc, ins, cpy, dist,
                                       ncmds, cand_len, cand_dist, st);
}
