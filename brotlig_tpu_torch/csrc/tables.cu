// Tables kernel: the three per-page prefix codes (commands 728 symbols,
// distances 544, literals 256) read from the 32 interleaved sub-streams,
// and their canonical range-search form, in the layout the fused decode
// and phase-A kernels read (page_round.cuh, load_page_codes).
//
// Replaces brotlig_tpu/ops/pallas_tables.py::make_tables_kernel (called by
// load_tables_pallas), the analogue of ReadSymbolCodeLengths
// (BrotliGCompute.hlsl:612-692), together with the XLA
// tables.build_search that pallas_decode.py's _tables_from_buf runs after
// it. Plain version: ops/tables_kernel.py::tables_plain (three chained
// ops/tables.py::load_table calls, build_search on each code, then
// state.pack_tables).
//
// A code is stored trivial, simple or complex; a complex code is a 9-bit
// code-length code followed by RLE items dealt round-robin over the
// streams (item g on stream g % 32). The three codes are read in series
// (each one's cursors start where the last one's ended), so a page is one
// serial chain, and a batch takes as long as its slowest page. What
// bounds it on this card: that chain's latency; its bytes (8 KB of stream
// words in, 6.7 KB of operands out a page) are nothing. The design keeps
// the chain off device memory and away from per-step warp scans:
//   - the first 64 words of the page's 32 streams (buffer rows 0-15, 8 KB)
//     are copied into shared memory with 16-byte loads; every bit read
//     after that is a shared load (words past them, which no valid page
//     reaches, come from device memory);
//   - the code-length code is built by the warp (ballot ranks over its 18
//     symbols) into a 512-entry table indexed by the raw 9-bit window, so
//     an RLE item is one shared load and a few ALU operations on a bit
//     reservoir;
//   - the items are reconciled with one pass per lane over a contiguous
//     block of items and one warp scan per table, not per item step;
//   - the canonical search build runs in a second warp, one table behind
//     the first: while warp 0 decodes code k+1, warp 1 counts code k's
//     lengths (a counter column per lane, scanned by length), runs the
//     16-step canonical recurrence and places every symbol by its rank,
//     writing limit/first/offset and the symbol dictionary straight out.
#include "lane_ops.cuh"

namespace blg {
namespace {

constexpr int kClCodes = 18;
constexpr int kClLutBits = 9;
constexpr int kTableWords = 64;          // ops/tables_kernel.py TABLE_WORDS
constexpr int kTableRows = kTableWords * kStreams / 128;   // 16 buffer rows
constexpr int kMaxSteps = (kAlphaIcp + kStreams - 1) / kStreams;  // 23
constexpr int kMaxItems = kMaxSteps * kStreams;
constexpr int kDictTotal = kAlphaIcp + kAlphaDst + kAlphaLit;
constexpr int kMetaPerTable = 3 * kLenSlots;   // limit, first, offset
constexpr int kCntStride = kStreams + 1;       // a counter row per length
constexpr int kThreads = 2 * kStreams;

static __constant__ int kSimpleFixed[4][4] = {
    {1, 1, 0, 0}, {1, 2, 2, 0}, {2, 2, 2, 2}, {1, 2, 3, 3}};
// kClInv[s]: the position of code-length symbol s in the storage order
// (1, 2, 3, 4, 0, 5, 17, 6, 16, 7, 8, ..., 15)
static __constant__ int kClInv[kClCodes] = {4,  0,  1,  2,  3,  5,
                                            7,  9,  10, 11, 12, 13,
                                            14, 15, 16, 17, 8,  6};

struct TablesSmem {
  int words[kTableWords * kStreams];   // flat w * 32 + s, as the buffer
  int lengths[kDictTotal];             // the three codes' lengths
  // warp 0: the code-length code and the speculative RLE items
  uint16_t cl_lut[1 << kClLutBits];    // sym | len << 5 | extra bits << 9
  int cl_dict[kClCodes];
  int cl_base[10];                     // offset[l] - first[l]
  int item[kMaxItems];                 // sym | extra << 8, item-major
  int hist[(kMaxSteps + 1) * kStreams];  // lane cursor before step t
  // warp 1: the search build
  int cnt[kLenSlots * kCntStride];     // per length, a counter per lane
  int offs[kLenSlots];
};

// Stream words of one page: the first nsm words of each stream from
// shared memory, the rest (which no valid page reaches) from device
// memory, zero past the buffer.
struct TableWords {
  const int* sm;
  Streams st;
  int nsm;

  __device__ __forceinline__ uint32_t word(int s, int w) const {
    if (w >= 0 && w < nsm) return static_cast<uint32_t>(sm[w * kStreams + s]);
    return st.word(s, w);
  }

  __device__ __forceinline__ uint32_t peek(int s, int bp, int n) const {
    if (n <= 0) return 0u;
    const int w = bp >> 5;
    const uint64_t v = static_cast<uint64_t>(word(s, w)) |
                       (static_cast<uint64_t>(word(s, w + 1)) << 32);
    return low_bits(static_cast<uint32_t>(v >> (bp & 31)), n);
  }
};

// A bit reservoir over one stream of TableWords (33..64 bits held at
// every peek), for the RLE loop: an item reads at most 12 bits.
struct TableBits {
  uint64_t buf;
  int nbits;
  int wnext;

  __device__ __forceinline__ void init(const TableWords& tw, int s, int bp) {
    const int w = bp >> 5;
    const uint64_t v = static_cast<uint64_t>(tw.word(s, w)) |
                       (static_cast<uint64_t>(tw.word(s, w + 1)) << 32);
    buf = v >> (bp & 31);
    nbits = 64 - (bp & 31);
    wnext = w + 2;
  }

  __device__ __forceinline__ void skip(const TableWords& tw, int s, int n) {
    buf >>= n;
    nbits -= n;
    if (nbits <= 32) {
      buf |= static_cast<uint64_t>(tw.word(s, wnext++)) << nbits;
      nbits += 32;
    }
  }
};

// The code-length code (build_search with max_len = table_bits = 9) from
// the 18 lengths, lane s holding symbol s's, as a lookup table of the raw
// 9-bit window. Warp 0 only; ends with __syncwarp().
__device__ void build_cl_lut(TablesSmem& sm, int lane, int len) {
  const int L = min(len, 9);
  const unsigned lt = (1u << lane) - 1u;
  int counts[10];
  unsigned mine = 0;
  counts[0] = 0;
#pragma unroll
  for (int l = 1; l < 10; ++l) {
    const unsigned b = __ballot_sync(kFull, lane < kClCodes && L == l);
    counts[l] = __popc(b);
    if (L == l) mine = b;
  }
  int first[10], lim[10], off[10];
  first[0] = 0;
  first[1] = 0;
#pragma unroll
  for (int l = 2; l < 10; ++l) first[l] = (first[l - 1] + counts[l - 1]) * 2;
  int acc = 0, my_off = 0;
#pragma unroll
  for (int l = 0; l < 10; ++l) {
    lim[l] = (first[l] + counts[l]) << (9 - l);
    off[l] = acc;
    if (L == l) my_off = acc;
    acc += counts[l];
    if (lane == l) sm.cl_base[l] = off[l] - first[l];
  }
  if (lane < kClCodes) sm.cl_dict[lane] = 0;
  __syncwarp();
  if (lane < kClCodes && len > 0)
    sm.cl_dict[my_off + __popc(mine & lt)] = lane;
  __syncwarp();
  for (int i = lane; i < (1 << kClLutBits); i += kStreams) {
    const int idx = rev9(static_cast<uint32_t>(i));
    int l = 1;
#pragma unroll
    for (int k = 1; k < 9; ++k) l += idx >= lim[k];
    const int code = idx >> (9 - l);
    const int sym =
        sm.cl_dict[min(max(sm.cl_base[l] + code, 0), kClCodes - 1)];
    const int eb = sym == 16 ? 2 : (sym == 17 ? 3 : 0);
    sm.cl_lut[i] = static_cast<uint16_t>(sym | (l << 5) | (eb << 9));
  }
  __syncwarp();
}

// Read one code of alphabet A (warp 0); bp is this lane's cursor in its
// stream. Writes the code lengths to len_out[0..A) in shared memory and
// returns the lane's cursor past the code; *triv gets the trivial symbol
// (or -1), read by every lane.
__device__ int read_code(const TableWords& tw, TablesSmem& sm, int lane,
                         int bp, int A, int* len_out, int* triv) {
  const int max_bits = 32 - __clz(A - 1);
  const int steps = (A + kStreams - 1) / kStreams;
  const int b0 = __shfl_sync(kFull, bp, 0);
  const int ttype = static_cast<int>(tw.peek(0, b0, 2));
  const bool m_triv = ttype == 0;
  const bool m_simp = ttype == 1;
  const bool m_cplx = ttype == 2;
  *triv = m_triv ? static_cast<int>(tw.peek(0, b0 + 6, max_bits)) : -1;
  const int nsym = static_cast<int>(tw.peek(0, b0 + 2, 2)) + 1;
  const int tsel = static_cast<int>(tw.peek(0, b0 + 4, 1));
  const int tbl_idx =
      min(max(nsym < 4 ? nsym - 2 : (tsel == 1 ? 3 : 2), 0), 3);
  const int nlen = static_cast<int>(tw.peek(0, b0 + 2, 4)) + 4;
  // lane i holds simple symbol i or code-length-code length i (storage
  // order); stream 0 reads them past the 6 shared header bits
  const int hdr = lane == 0 ? 6 : 0;
  const int sym_l = static_cast<int>(tw.peek(lane, bp + hdr, max_bits));
  const int clv_l = static_cast<int>(tw.peek(lane, bp + hdr, 5));

  int adv;
  if (lane == 0) {
    adv = (m_triv || m_simp || m_cplx ? 6 : 0) +
          (m_triv || m_simp ? max_bits : 0) + (m_cplx ? 5 : 0);
  } else {
    adv = (m_simp && lane < nsym ? max_bits : 0) +
          (m_cplx && lane < kClCodes && lane < nlen ? 5 : 0);
  }
  const int bp_hdr = bp + adv;

  if (!m_cplx) {                                 // warp-uniform
    int simple_sym[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) simple_sym[i] = __shfl_sync(kFull, sym_l, i);
    for (int t = lane; t < A; t += kStreams) len_out[t] = 0;
    __syncwarp();
    if (lane == 0 && m_simp) {
      for (int i = 0; i < 4 && i < nsym; ++i)   // a repeated symbol: last wins
        if (simple_sym[i] < A) len_out[simple_sym[i]] = kSimpleFixed[tbl_idx][i];
    }
    __syncwarp();
    return bp_hdr;
  }

  // the code-length code: lane s takes symbol s's length
  const int src = kClInv[min(lane, kClCodes - 1)];
  const int v = __shfl_sync(kFull, clv_l, src);
  build_cl_lut(sm, lane, lane < kClCodes && src < nlen ? v : 0);

  // speculative RLE decode of this lane's items (g = t * 32 + lane)
  TableBits br;
  br.init(tw, lane, bp_hdr);
  int rbp = bp_hdr;
  for (int t = 0; t < steps; ++t) {
    const int g = t * kStreams + lane;
    sm.hist[g] = rbp;
    const uint32_t win = low_bits(static_cast<uint32_t>(br.buf), 12);
    const int e = sm.cl_lut[win & ((1u << kClLutBits) - 1u)];
    const int sym = e & 31;
    const int l = (e >> 5) & 15;
    const int eb = e >> 9;
    sm.item[g] = sym | (static_cast<int>(low_bits(win >> l, eb)) << 8);
    br.skip(tw, lane, l + eb);
    rbp += l + eb;
  }
  sm.hist[steps * kStreams + lane] = rbp;
  __syncwarp();

  // reconcile in item order: lane s takes items [s*steps, (s+1)*steps)
  const int g0 = lane * steps;
  int runs = 0, key = -1;                        // key: g * 32 + literal
  for (int i = 0; i < steps; ++i) {
    const int it = sm.item[g0 + i];
    const int sym = it & 255;
    const bool lit = sym < 16;
    runs += lit ? 1 : (it >> 8) + 3;
    if (lit) key = (g0 + i) * 32 + sym;
  }
  const int incl = warp_incl_sum(runs, lane);
  const int tot = __shfl_sync(kFull, incl, kStreams - 1);
  const int pk = warp_excl_max(key, lane, -1);
  int prev = pk >= 0 ? (pk & 31) : 8;            // repeat-previous value
  int cum = incl - runs, below = 0;
  int last_val = 0;
  for (int i = 0; i < steps; ++i) {
    const int it = sm.item[g0 + i];
    const int sym = it & 255;
    const bool lit = sym < 16;
    const int run = lit ? 1 : (it >> 8) + 3;
    const int val = lit ? sym : (sym == 16 ? prev : 0);
    if (lit) prev = sym;
    // items up to the first whose run reaches A are real: expand them
    if (cum < A) {
      const int end = min(cum + run, A);
      for (int q = cum; q < end; ++q) len_out[q] = val;
    }
    cum += run;
    below += cum < A;
    last_val = val;
  }
  int g_last = below;                            // items with cum < A
#pragma unroll
  for (int d = 16; d >= 1; d >>= 1) g_last += __shfl_xor_sync(kFull, g_last, d);
  if (g_last >= steps * kStreams) {              // runs never reached A
    const int last = __shfl_sync(kFull, last_val, kStreams - 1);
    for (int q = tot + lane; q < A; q += kStreams) len_out[q] = last;
  }
  __syncwarp();

  // lane s consumed the real items s, s+32, ... <= g_last
  int n_s = g_last >= lane ? (g_last - lane) / kStreams + 1 : 0;
  n_s = min(n_s, steps);
  return sm.hist[n_s * kStreams + lane];
}

// build_search(lengths, 16, 15) of one code (warp 1): limit/first/offset
// to meta_out [3][17], the symbols in canonical (length, symbol) order to
// dict_out [A], unused slots 0.
__device__ void build_search(TablesSmem& sm, int lane, const int* lengths,
                             int A, int32_t* __restrict__ meta_out,
                             int32_t* __restrict__ dict_out) {
  const int K = (A + kStreams - 1) / kStreams;   // lane s: symbols [sK, sK+K)
  const int s0 = lane * K;
  const int s1 = min(s0 + K, A);
  for (int L = 0; L < kLenSlots; ++L) sm.cnt[L * kCntStride + lane] = 0;
  __syncwarp();
  for (int s = s0; s < s1; ++s) {
    const int len = lengths[s];
    if (len > 0) sm.cnt[min(len, kLenSlots - 1) * kCntStride + lane] += 1;
  }
  __syncwarp();
  // lane L: exclusive scan of its length's counters over the lanes
  int count = 0;
  if (lane < kLenSlots) {
    int* row = sm.cnt + lane * kCntStride;
    for (int j = 0; j < kStreams; ++j) {
      const int c = row[j];
      row[j] = count;
      count += c;
    }
  }
  if (lane == 0) count = 0;                      // counts[0] = 0
  int first = 0, f = 0, offset = 0, acc = 0, next_count = 0;
#pragma unroll
  for (int l = 0; l < kLenSlots; ++l) {
    const int c = __shfl_sync(kFull, count, l);
    if (l >= 2) f = (f + next_count) * 2;       // first[l]
    if (lane == l) {
      first = f;
      offset = acc;
    }
    next_count = c;
    acc += c;
  }
  const int total = acc;
  if (lane < kLenSlots) {
    // limit: (first + count) << (15 - l), 0 where the shift is negative
    meta_out[lane] = lane <= 15 ? (first + count) << (15 - lane) : 0;
    meta_out[kLenSlots + lane] = first;
    meta_out[2 * kLenSlots + lane] = offset;
    sm.offs[lane] = offset;
  }
  __syncwarp();
  for (int s = s0; s < s1; ++s) {
    const int len = lengths[s];
    if (len > 0) {
      const int L = min(len, kLenSlots - 1);
      int* c = sm.cnt + L * kCntStride + lane;
      dict_out[sm.offs[L] + *c] = s;
      *c += 1;
    }
  }
  for (int r = total + lane; r < A; r += kStreams) dict_out[r] = 0;
  __syncwarp();
}

__global__ void __launch_bounds__(kThreads)
    tables_kernel(const int32_t* __restrict__ buf3, int wc, int P,
                  int32_t* __restrict__ meta, int32_t* __restrict__ dicts,
                  int32_t* __restrict__ trivs, int32_t* __restrict__ bp_out) {
  __shared__ __align__(16) TablesSmem sm;
  const int p = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & (kStreams - 1);
  const bool decoder = tid < kStreams;
  const size_t pp = static_cast<size_t>(p);
  const int rows = min(kTableRows, wc);

  // buffer rows 0..rows-1 of this page: word w of stream s at w * 32 + s
  for (int i = tid; i < rows * 32; i += kThreads) {
    const int r = i >> 5;
    reinterpret_cast<int4*>(sm.words)[i] = __ldg(
        reinterpret_cast<const int4*>(buf3 + (static_cast<size_t>(r) * P + p) *
                                                 128) + (i & 31));
  }
  __syncthreads();
  const TableWords tw{sm.words, Streams{buf3, P, p, wc * 4},
                      rows * 128 / kStreams};

  const int alpha[3] = {kAlphaIcp, kAlphaDst, kAlphaLit};
  const int at[3] = {0, kAlphaIcp, kAlphaIcp + kAlphaDst};
  int bp = 0;
  // stage k: warp 0 reads code k, warp 1 builds code k-1's search form
#pragma unroll
  for (int k = 0; k <= 3; ++k) {
    if (decoder && k < 3) {
      int triv;
      bp = read_code(tw, sm, lane, bp, alpha[k], sm.lengths + at[k], &triv);
      if (lane == 0) trivs[pp * 3 + k] = triv;
    } else if (!decoder && k > 0) {
      build_search(sm, lane, sm.lengths + at[k - 1], alpha[k - 1],
                   meta + (pp * 3 + k - 1) * kMetaPerTable,
                   dicts + pp * kDictTotal + at[k - 1]);
    }
    __syncthreads();
  }
  if (decoder) bp_out[pp * kStreams + lane] = bp;
}

}  // namespace
}  // namespace blg

// buf3: [wc, P, 128] int32 staged pages. Out, int32: meta [P, 3, 3, 17]
// (limit, first, offset per code), dicts [P, 728+544+256] (the canonical
// symbol dictionaries), trivs [P, 3], bp [P, 32] (stream-local cursors
// past the tables).
extern "C" int blg_load_tables(const void* buf3, int wc, int P, void* meta,
                               void* dicts, void* trivs, void* bp,
                               void* stream) {
  if (P > 0) {
    blg::tables_kernel<<<P, blg::kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(buf3), wc, P,
        static_cast<int32_t*>(meta), static_cast<int32_t*>(dicts),
        static_cast<int32_t*>(trivs), static_cast<int32_t*>(bp));
  }
  return static_cast<int>(cudaGetLastError());
}
