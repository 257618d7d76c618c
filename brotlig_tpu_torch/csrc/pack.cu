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
// What bounds it on this card: the serial parts of a page are chains a
// block runs alone; the bytes it moves (a page, its commands, the output)
// take microseconds. A batch of P pages occupies P of the 132 SMs. The
// per-page record's clock stamps (chip_smoke.py prints them) put most of
// a 64 KiB page's chain in the bit packing (one warp), the bitonic sort of
// the distances and the 16 grid points. The design keeps each step simple:
//   * per-command work (ring, fields, histograms) is spread over the
//     block's threads in contiguous chunks, with block scans for the
//     prefix sums (command starts, ring pushes, literal ranks);
//   * the histograms, code lengths and codes live in shared memory; the
//     stable orders of the plain version (count-descending ranks, the
//     sorted distances of the grid search) are a rank count and a bitonic
//     sort written here;
//   * lane s of warp 0 owns sub-stream s, the format's own round robin: it
//     appends its slots in order (table block, then each round's five
//     command fields and its literals) through a 64-bit accumulator into
//     its words, which live in device memory (Wst words a stream);
//   * costs are fixed point as in the plain version: each run's float64
//     term c * (log2 n - log2 c) + 6 is computed with the same libdevice
//     log2 and with rounded (non-fused) double operations, then rounded
//     half to even, so the sums equal the plain version's on the card.
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
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNbs = 32;
constexpr int kACmd = 728;
constexpr int kADst = 544;
constexpr int kALit = 256;
constexpr int kATot = kACmd + kADst + kALit;
constexpr int kSentinel = 704;
constexpr int kHW = 24;               // header words
constexpr int kInfoInts = 64 + kATot;  // the per-page record (see below)
constexpr int kInfoClocks = 52;       // its clock cycles a phase
constexpr int kPhases = 10;
constexpr int kFar = 1 << 28;         // grid-search distances at or past it
                                      // are left out, as in the plain sort

__constant__ int kClOrder[18] = {1, 2,  3,  4,  0,  5,  17, 6,  16,
                                 7, 8,  9,  10, 11, 12, 13, 14, 15};
__constant__ int kGridNd[4] = {0, 3, 8, 15};

__host__ __device__ inline long long up4(long long x) {
  return (x + 3) & ~3LL;
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

struct Smem {
  int hist[kATot];       // cmd | dst | lit
  int lens[kATot];
  unsigned code[kATot];  // canonical codes, bit-reversed
  int dh[2][kADst];      // ring-mode histograms
  int srt[kACmd];        // used symbols by count rank
  unsigned char items[kATot];
  short runs[kATot];
  int clh[3][18], cll[3][18];
  unsigned clc[3][18];
  int mode[3], cnt[3], tsel[3], emit[3][4], M[3];
  int s4[4], sym4[3][4], len4[3][4];   // a simple table's symbols
  long long red[kWarps];
  long long bits[kNbs];
  long long sbp[kNbs + 1];
  unsigned hw[kHW];
  long long hdr_bytes, pay_end;
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

// The least v over the threads after this one (INT_MAX for the last).
__device__ int block_next_min(int v, long long* red) {
  int* r = reinterpret_cast<int*>(red);
  const int lane = lane_id();
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_down_sync(kFull, x, o);
    if (lane + o < 32) x = min(x, y);
  }
  int in_warp = __shfl_down_sync(kFull, x, 1);
  if (lane == 31) in_warp = INT_MAX;
  if (lane == 0) r[warp_id()] = x;
  __syncthreads();
  int after = INT_MAX;
  for (int i = warp_id() + 1; i < kWarps; ++i) after = min(after, r[i]);
  __syncthreads();
  return min(in_warp, after);
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
  // count-descending ranks of the used symbols, ties by symbol
  for (int i = tid; i < A; i += kThreads) {
    const int h = hist[i];
    if (h <= 0) continue;
    int r = 0;
    for (int j = 0; j < A; ++j) {
      const int hj = hist[j];
      r += (hj > h) || (hj == h && j < i);
    }
    sm.srt[r] = i;
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
  for (int i = lane; i < A; i += 32) atomicAdd(&next[lens[i]], 1);
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

// One sub-stream's bit writer: slots appended in order, LSB first.
struct BitWriter {
  unsigned* words;
  int wst;
  unsigned long long acc = 0;
  int nacc = 0;
  int w = 0;
  long long bits = 0;

  __device__ void put(int nb, unsigned long long v) {
    if (nb <= 0) return;
    acc |= v << nacc;
    nacc += nb;
    bits += nb;
    if (nacc >= 32) {
      if (w < wst) words[w] = static_cast<unsigned>(acc);
      ++w;
      acc >>= 32;
      nacc -= 32;
    }
  }
  __device__ void flush() {
    if (nacc > 0 && w < wst) words[w] = static_cast<unsigned>(acc);
  }
};

__global__ void __launch_bounds__(kThreads)
    pack_kernel(const uint8_t* __restrict__ pages,
                const int32_t* __restrict__ in_sizes,
                const int32_t* __restrict__ ins_g,
                const int32_t* __restrict__ cpy_g,
                const int32_t* __restrict__ dist_g,
                const int32_t* __restrict__ ncmds_g,
                const int32_t* __restrict__ isdelta_g, int S, int N,
                int page_size, int max_cmds, uint8_t* __restrict__ out_g,
                int32_t* __restrict__ out_sizes, int32_t* __restrict__ scr_g) {
  __shared__ Smem sm;
  extern __shared__ long long rarr[];   // Rarr of each used round
  const int tid = threadIdx.x;
  const int lane = lane_id();
  const int page = blockIdx.x;
  const Layout lay(N, S, page_size);
  const int wst = lay.wst;
  int32_t* scr = scr_g + static_cast<size_t>(page) * lay.total;
  int* starts = scr + lay.starts;
  int* pv = scr + lay.pv;
  int* ringc = scr + lay.ringc;
  int4* cmd4 = reinterpret_cast<int4*>(scr + lay.cmd4);
  int* sortb = scr + lay.sortb;
  uint8_t* lq = reinterpret_cast<uint8_t*>(scr + lay.lq);
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

  for (int i = tid; i < kNbs * wst; i += kThreads) words[i] = 0u;
  for (int i = tid; i < kATot; i += kThreads) sm.hist[i] = 0;
  for (int i = tid; i < 2 * kADst; i += kThreads) (&sm.dh[0][0])[i] = 0;

  // ---- command starts over all N slots; the tail ----
  const int cn = (N + kThreads - 1) / kThreads;
  const int j0 = min(tid * cn, N), j1 = min(j0 + cn, N);
  long long cov = 0;
  for (int j = j0; j < j1; ++j)
    cov += static_cast<long long>(ins[j]) + cpy[j];
  long long covered;
  long long st = block_excl_scan(cov, &covered, sm.red);
  for (int j = j0; j < j1; ++j) {
    starts[j] = static_cast<int>(st);
    st += static_cast<long long>(ins[j]) + cpy[j];
  }
  const long long tail = insz - covered;
  const bool has_tail = tail > 0;
  const int ntotal = n + 1 + has_tail;

  // ---- exact ring state before each command (_ring_before) ----
  const int vn = (n + kThreads - 1) / kThreads;
  const int a0 = min(tid * vn, n), a1 = min(a0 + vn, n);
  auto is_copy = [&](int j) { return cpy[j] > 0 && dist[j] > 0; };
  auto ring0 = [&](int j) {
    return j == 0 ? 4 : (is_copy(j - 1) ? dist[j - 1] : 0);
  };
  int pushes = 0;
  for (int j = a0; j < a1; ++j)
    pushes += is_copy(j) && dist[j] != ring0(j);
  int npush;
  const int pex = block_excl_scan(pushes, &npush, sm.red);
  {
    int t = pex;
    for (int j = a0; j < a1; ++j) {
      const int r0 = ring0(j);
      if (is_copy(j) && dist[j] != r0) pv[t++] = r0;
    }
  }
  __syncthreads();
  auto pvx = [&](int i) {
    return i == 0 ? 16 : i == 1 ? 15 : i == 2 ? 11 : pv[i - 3];
  };
  int nkeys_local = 0;
  {
    int t = pex;
    for (int j = a0; j < a1; ++j) {
      const int r0 = ring0(j);
      const bool copy = is_copy(j);
      int rc = -1;
      if (copy) {
        const int d = dist[j];
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
        if (dist[j] != r0) ++t;
        nkeys_local += !(rc >= 0 && rc <= 3) && d < kFar;
      }
      ringc[j] = rc;
    }
  }

  // ---- the (npostfix, ndirect) grid search: the sorted distances that
  // are not exact ring hits, 16 grid points, the first minimum wins ----
  int nkeys;
  int kex = block_excl_scan(nkeys_local, &nkeys, sm.red);
  mark(1);                                       // starts, ring codes
  for (int j = a0; j < a1; ++j) {
    const int rc = ringc[j];
    if (is_copy(j) && !(rc >= 0 && rc <= 3) && dist[j] < kFar)
      sortb[kex++] = dist[j];
  }
  int m2 = 1;
  while (m2 < nkeys) m2 <<= 1;
  for (int i = nkeys + tid; i < m2; i += kThreads) sortb[i] = INT_MAX;
  __syncthreads();
  for (int k = 2; k <= m2; k <<= 1)
    for (int jj = k >> 1; jj > 0; jj >>= 1) {
      for (int i = tid; i < m2; i += kThreads) {
        const int ixj = i ^ jj;
        if (ixj > i) {
          const int a = sortb[i], b = sortb[ixj];
          if ((a > b) == ((i & k) == 0)) {
            sortb[i] = b;
            sortb[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  mark(2);                                       // the distance sort
  const double log2k = log2(static_cast<double>(max(nkeys, 1)));
  const int kc = (nkeys + kThreads - 1) / kThreads;
  const int i0 = min(tid * kc, nkeys), i1 = min(i0 + kc, nkeys);
  long long best_cost = LLONG_MAX;
  int best = 0;
  for (int g = 0; g < 16; ++g) {
    const int gnp = g >> 2, gnd = kGridNd[g & 3] << gnp;
    int first = INT_MAX, nb;
    long long nbs = 0;
    int prev = i0 > 0 ? dist_sym(sortb[i0 - 1], gnp, gnd, &nb) : -1;
    for (int i = i0; i < i1; ++i) {
      const int s = dist_sym(sortb[i], gnp, gnd, &nb);
      nbs += nb;
      if (first == INT_MAX && s < kADst && s != prev) first = i;
      prev = s;
    }
    int nx = block_next_min(first, sm.red);
    long long cost = 0;
    for (int i = i1 - 1; i >= i0; --i) {
      const int s = dist_sym(sortb[i], gnp, gnd, &nb);
      const int sp = i > 0 ? dist_sym(sortb[i - 1], gnp, gnd, &nb) : -1;
      if (s < kADst && s != sp) {
        cost += run_cost(min(nx, nkeys) - i, log2k);
        nx = i;
      }
    }
    cost = block_sum(cost, sm.red);
    nbs = block_sum(nbs, sm.red);
    const long long total = cost + (nbs << 16);
    if (total < best_cost) {
      best_cost = total;
      best = g;
    }
  }
  mark(3);                                       // the 16 grid points
  const int npostfix = best >> 2;
  const int ndist = kGridNd[best & 3];
  const int ndirect = ndist << npostfix;

  // ---- ring mode: exact hits only vs the offset codes too ----
  int nm = 0, ge[2] = {0, 0};
  long long nbk[2] = {0, 0};
  for (int j = a0; j < a1; ++j) {
    const int rc = ringc[j];
    if (!is_copy(j) || rc == 0) continue;
    ++nm;
    int dnb;
    const int ds = dist_sym(max(dist[j], 1), npostfix, ndirect, &dnb);
    const bool exact = rc >= 1 && rc <= 3;
    const int s0 = exact ? rc : ds, s1 = rc >= 0 ? rc : ds;
    nbk[0] += exact ? 0 : dnb;
    nbk[1] += rc >= 0 ? 0 : dnb;
    if (s0 < kADst) atomicAdd(&sm.dh[0][s0], 1);
    else ++ge[0];
    if (s1 < kADst) atomicAdd(&sm.dh[1][s1], 1);
    else ++ge[1];
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
  for (int j = a0; j < a1; ++j) {
    const int rc = ringc[j];
    const int in = ins[j], cp = cpy[j];
    const int sel = offset_codes ? rc : (rc >= 0 && rc <= 3 ? rc : -1);
    int dsym = sel, dnb = 0;
    long long dx = 0;
    if (sel < 0) encode_distance(max(dist[j], 1), npostfix, ndirect, &dsym,
                                 &dnb, &dx);
    const int ic = ins_code(in), cc = cpy_code(cp);
    const bool use_last = rc == 0 && ic < 8 && cc < 16;
    const int prefix = combine_codes(ic, cc, use_last);
    const bool sd = !use_last;
    if (prefix >= 0 && prefix < kACmd) atomicAdd(&sm.hist[prefix], 1);
    if (sd && dsym >= 0 && dsym < kADst)
      atomicAdd(&sm.hist[kACmd + dsym], 1);
    const int insx = in - insert_base(ic);
    const int cpyx = cc > 1 ? cp - copy_base(cc) : cp;
    cmd4[j] = make_int4(
        prefix | ((sd ? dsym : 0) << 10) | (static_cast<int>(sd) << 20) |
            (insert_extra(ic) << 21) | (copy_extra(cc) << 26),
        sd ? static_cast<int>(dx) : 0, insx | ((sd ? dnb : 0) << 24), cpyx);
  }
  const int tail_code = has_tail ? ins_code(static_cast<int>(tail)) : 0;
  if (tid == 0) {
    if (has_tail) atomicAdd(&sm.hist[kSentinel + tail_code], 1);
    atomicAdd(&sm.hist[kSentinel], 1);
  }

  // ---- literal cover: the insert regions and the tail, in page order ----
  const int pn = (S + kThreads - 1) / kThreads;
  const int p0 = min(tid * pn, S), p1 = min(p0 + pn, S);
  int c0 = 0;
  if (n > 0) {
    int lo = 0, hi = n - 1;   // last j < n with starts[j] <= p0
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (starts[mid] <= p0) lo = mid;
      else hi = mid - 1;
    }
    c0 = lo;
  }
  auto literal = [&](int p, int& c) {
    while (c + 1 < n && starts[c + 1] <= p) ++c;
    return (p < static_cast<long long>(starts[c]) + ins[c] || p >= covered) &&
           p < insz;
  };
  int nlit_local = 0;
  {
    int c = c0;
    for (int p = p0; p < p1; ++p)
      if (literal(p, c)) {
        ++nlit_local;
        atomicAdd(&sm.hist[kACmd + kADst + pg[p]], 1);
      }
  }
  int n_lits;
  {
    int q = block_excl_scan(nlit_local, &n_lits, sm.red);
    int c = c0;
    for (int p = p0; p < p1; ++p)
      if (literal(p, c)) lq[q++] = pg[p];
  }
  int mf = -1;
  for (int v = tid; v < kALit; v += kThreads)
    mf = max(mf, (sm.hist[kACmd + kADst + v] << 8) | (255 - v));
  const int most_freq = 255 - (block_max(mf, sm.red) & 255);
  mark(4);                   // ring mode, fields, histograms, literals

  // ---- the three prefix codes ----
  choose_table(0, kACmd, sm);
  choose_table(1, kADst, sm);
  choose_table(2, kALit, sm);
  mark(5);                                       // code lengths
  const int tbase[3] = {0, kACmd, kACmd + kADst};
  const int talpha[3] = {kACmd, kADst, kALit};
  const int w = warp_id();
  if (w < 3) {
    canonical_codes(sm.lens + tbase[w], talpha[w], sm.code + tbase[w],
                    sm.next[w]);
    const int M = rle_items(sm.lens + tbase[w], talpha[w],
                            sm.runs + tbase[w], sm.items + tbase[w]);
    if (lane < 18) sm.clh[w][lane] = 0;
    __syncwarp();
    for (int j = lane; j < M; j += 32)
      atomicAdd(&sm.clh[w][sm.items[tbase[w] + j] & 31], 1);
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
  __syncthreads();

  mark(7);                                       // round schedule
  // ---- bit packing: lane s of warp 0 writes sub-stream s ----
  if (w == 0) {
    const int s = lane;
    BitWriter bw{words + static_cast<size_t>(s) * wst, wst};
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
        bw.put(mode == 2 ? 6 : 6 + maxb, hv);
      }
      if (mode == 2 && s < 18) bw.put(5, sm.cll[T][kClOrder[s]]);
      if (mode == 1 && s >= 1 && s < sm.cnt[T]) bw.put(maxb, sm.emit[T][s]);
      if (mode == 2) {
        const int M = sm.M[T];
        const unsigned char* it = sm.items + tbase[T];
        for (int j = s; j < M; j += kNbs) {
          const int code = it[j] & 31, extra = it[j] >> 5;
          const int cl = sm.cll[T][code];
          const int width = code == 16 ? 2 : code == 17 ? 3 : 0;
          bw.put(cl + width,
                 sm.clc[T][code] |
                     (static_cast<unsigned long long>(extra) << cl));
        }
      }
    }
    const long long edyn = 6LL * R + (page_size + 64) / 32 + 2;
    const int* clen = sm.lens;
    const unsigned* ccode = sm.code;
    const int* dlen = sm.lens + kACmd;
    const unsigned* dcode = sm.code + kACmd;
    const int* llen = sm.lens + kACmd + kADst;
    const unsigned* lcode = sm.code + kACmd + kADst;
    long long e = 0, rprev = 0;
    for (int r = 0; r < nR && e < edyn; ++r) {
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
      for (int k = 0; k < 5; ++k, ++e)
        if (e < edyn) bw.put(fn[k], fv[k]);
      const long long rcur = rarr[r];
      const long long lits = max(rcur - rprev, 0LL);
      const long long cnt = (max(lits - s, 0LL) + 31) / 32;
      for (long long i = 0; i < cnt && e < edyn; ++i, ++e) {
        const long long j = rprev + i * kNbs + s;
        const int byte = j < n_lits ? lq[j] : most_freq;
        bw.put(llen[byte], lcode[byte]);
      }
      rprev = rcur;
    }
    bw.flush();
    sm.bits[s] = bw.bits;
  }
  __syncthreads();

  mark(8);                                       // bit packing
  // ---- page header and size table (the fixed point) ----
  if (tid == 0) {
    long long tot = 0, mn = LLONG_MAX;
    bool overflow = false;
    for (int s = 0; s < kNbs; ++s) {
      const long long sb = (sm.bits[s] + 7) / 8;
      tot += sb;
      mn = min(mn, sb);
      overflow |= sm.bits[s] > 32LL * wst;
    }
    int delta_bits = 1;
    for (int s = 0; s < kNbs; ++s)
      delta_bits = max(delta_bits, bitlen((sm.bits[s] + 7) / 8 - mn));
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
    for (int s = 0; s < kNbs; ++s)
      hput(delta_bits, (sm.bits[s] + 7) / 8 - mn);
    sm.sbp[0] = 0;
    for (int s = 0; s < kNbs; ++s)
      sm.sbp[s + 1] = sm.sbp[s] + (sm.bits[s] + 7) / 8;
    const long long out_total = hdr_bytes + (tot + 3) / 4 * 4;
    out_sizes[page] = overflow ? page_size + 1
                               : static_cast<int32_t>(out_total);
    sm.hdr_bytes = hdr_bytes;
    sm.pay_end = (tot + 3) / 4 * 4;
    // the per-page record (read back by a diagnosis, never by a route)
    info[0] = npostfix;
    info[1] = ndist;
    for (int T = 0; T < 3; ++T) {
      info[2 + T] = sm.mode[T];
      info[5 + T] = sm.cnt[T];
      info[8 + T] = sm.tsel[T];
    }
    info[14] = n_lits;
    info[15] = most_freq;
    info[16] = ntotal;
    info[17] = nkeys;
    info[18] = offset_codes;
    for (int s = 0; s < kNbs; ++s) info[19 + s] = static_cast<int>(sm.bits[s]);
    stamp[9] = clock64();                         // header
  }
  for (int i = tid; i < kATot; i += kThreads) info[64 + i] = sm.lens[i];
  __syncthreads();

  // ---- assembly: header words, then the streams, DWORD padded ----
  const long long hdr_bytes = sm.hdr_bytes;
  const long long pay_end = sm.pay_end;
  uint32_t* out = reinterpret_cast<uint32_t*>(
      out_g + static_cast<size_t>(page) * page_size);
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
        int lo = 0, hi = kNbs;          // last s in [0, 32] with sbp <= pay
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (sm.sbp[mid] <= pay) lo = mid;
          else hi = mid - 1;
        }
        const int s = min(lo, kNbs - 1);
        const long long in = pay - sm.sbp[s];
        const long long wi = min(max(s * static_cast<long long>(wst) +
                                         (in >> 2), 0LL),
                                 static_cast<long long>(kNbs) * wst - 1);
        byte = (words[wi] >> ((in & 3) * 8)) & 0xFF;
      }
      word |= byte << (8 * k);
    }
    out[q] = word;
  }
  __syncthreads();
  if (tid == 0) {
    stamp[kPhases] = clock64();                  // assembly
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

// Launch the serializer over P pages (one block a page).
extern "C" int blg_pack_pages(const void* pages, const void* in_sizes,
                              const void* ins, const void* cpy,
                              const void* dist, const void* ncmds,
                              const void* isdelta, int P, int S, int N,
                              int page_size, int max_cmds, void* out,
                              void* out_sizes, void* scratch, void* stream) {
  if (P <= 0) return 0;
  const int rounds = (N + 1) / blg_pack::kNbs + 1;
  const size_t smem = sizeof(long long) * static_cast<size_t>(rounds);
  const cudaError_t e = cudaFuncSetAttribute(
      blg_pack::pack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
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
      static_cast<uint8_t*>(out), static_cast<int32_t*>(out_sizes),
      static_cast<int32_t*>(scratch));
  return static_cast<int>(cudaGetLastError());
}
