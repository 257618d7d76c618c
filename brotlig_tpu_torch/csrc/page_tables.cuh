// The serializer's per-page statistics and prefix-code lengths (pack.cu):
// one thread block of kThreads threads a page computes, bit for bit, what
// ops/encode_pack.py::page_histograms and _choose_table give: the command
// starts and the tail, the exact distance ring before each command, the
// (npostfix, ndirect) grid search, the ring mode, the wire fields and the
// command / distance histograms, the literal cover and the literal
// histogram, and the three tables' code lengths (page_stats, the
// serializer's phases 0 to 5). pack.cu's head comment gives the design;
// the helpers below are its building blocks, and the q11 cost model's
// kernels (cost_model.cu) use them too.
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
constexpr int kInfoInts = 64 + kATot;  // pack.cu's per-page record
constexpr int kPhases = 11;           // its clock stamps (see page_stats)
constexpr int kTile = 4 * kThreads;   // commands a tile of the scans
constexpr int kSubHist = kWarps * kALit * 4;   // bytes of the literal
                                               // sub-histograms
constexpr int kFar = 1 << 28;         // grid-search distances at or past it
                                      // are left out, as in the plain sort

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
// What a page's phases 0 to 5 leave for the work after them.
struct PageStats {
  long long covered, tail;   // bytes the commands cover; the rest
  int ntotal, tail_code, npostfix, ndist, ndirect, nkeys, n_lits, most_freq;
  bool has_tail, keys_shared, offset_codes;
  uint8_t* lq;               // the literal queue, n_lits bytes
};

// Phases 0 to 5 of one page (block-wide; thread 0 stamps each phase's end
// into stamp[1..5]): the command starts into the scratch, the ring codes,
// the grid search, the ring mode, the wire fields (cmd4), the three
// histograms and the literal queue, then the code lengths in sm.lens and
// each table's mode, count, tsel and emission order. n is the page's
// command count, insz its size.
__device__ __forceinline__ PageStats page_stats(
    const uint8_t* pg, const int32_t* ins, const int32_t* cpy,
    const int32_t* dist, int n, int insz, int S, int page_size,
    const Layout& lay, int32_t* scr, unsigned char* reg, int region,
    int lq_shared, Smem& sm, long long* stamp) {
  const int tid = threadIdx.x;
  const int lane = lane_id();
  const int w = warp_id();
  int* starts = scr + lay.starts;
  int* pv = scr + lay.pv;
  int* ringc = scr + lay.ringc;
  int4* cmd4 = reinterpret_cast<int4*>(scr + lay.cmd4);
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
  PageStats st;
  st.covered = covered;
  st.tail = tail;
  st.ntotal = ntotal;
  st.tail_code = tail_code;
  st.npostfix = npostfix;
  st.ndist = ndist;
  st.ndirect = ndirect;
  st.nkeys = nkeys;
  st.n_lits = n_lits;
  st.most_freq = most_freq;
  st.has_tail = has_tail;
  st.keys_shared = keys_shared;
  st.offset_codes = offset_codes;
  st.lq = lq;
  return st;
}

// The dynamic shared memory of a launch of `kernel` (a kernel whose static
// shared memory is an Smem) on the current device: Rarr, then a region as
// large as the card allows up to what a page needs: the image (and the
// literal queue after it where both fit), or during the sort
// 4 * 2^ceil(log2 N) bytes of keys. Sets the bytes, the region and whether
// the literal queue is in it; returns a CUDA error or 0.
template <typename Kernel>
cudaError_t smem_plan(Kernel* kernel, int N, int S, int page_size,
                      long long* bytes, int* region, int* lq_shared) {
  int dev = 0, optin = 0;
  cudaFuncAttributes fa;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kernel);
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
