// Device helpers shared by the tables kernel (tables.cu), the fused
// decode kernel (decode.cu) and the phase-A kernel (phase_a.cu): the
// counterpart of brotlig_tpu/ops/pallas_decode.py's _LaneOps, _rev15 and
// _mask_bits, and of ops/arith_lut.py.
//
// One warp decodes a page, and lane s of the warp owns sub-stream s: the
// 32 sub-streams of the format are the 32 lanes of the reference GPU
// decoder. Cross-lane steps (the sentinel lane, prefix sums, the distance
// ring) are warp shuffles and ballots.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace blg {

constexpr int kStreams = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kLenSlots = 17;        // limit/first/offset entries per code
constexpr int kSentinel = 704;       // NUM_COMMAND_SYMBOLS
constexpr int kAlphaIcp = 728;
constexpr int kAlphaDst = 544;
constexpr int kAlphaLit = 256;

// Sub-stream words of one page in the staged layout buf3[Wc][P][128]
// (native.stage_pages): word w of stream s sits at flat position w*32+s
// of the page's row. Words at or past wl read as zero.
struct Streams {
  const int32_t* buf;
  int P;
  int p;
  int wl;

  __device__ __forceinline__ uint32_t word(int s, int w) const {
    if (w < 0 || w >= wl) return 0u;
    const int flat = w * kStreams + s;
    return static_cast<uint32_t>(
        __ldg(buf + (static_cast<size_t>(flat >> 7) * P + p) * 128 +
              (flat & 127)));
  }

  // n (0..32) bits of stream s at its local bit position bp, LSB first.
  __device__ __forceinline__ uint32_t peek(int s, int bp, int n) const {
    if (n <= 0) return 0u;
    const int w = bp >> 5;
    const uint64_t v = static_cast<uint64_t>(word(s, w)) |
                       (static_cast<uint64_t>(word(s, w + 1)) << 32);
    const uint32_t x = static_cast<uint32_t>(v >> (bp & 31));
    return n >= 32 ? x : (x & ((1u << n) - 1u));
  }
};

// The words of one sub-stream s of a page: word w sits at chunk w >> 2,
// position (w & 3) * 32 + s of the chunk's 128-word row (the flat
// position w*32+s of Streams::word), so the lane keeps a pointer to its
// first word and the chunk stride and computes no 64-bit product per load.
struct LaneStream {
  const int32_t* base;   // word 0 of the stream
  size_t stride;         // P * 128: one chunk row to the next
  int wl;

  __device__ __forceinline__ LaneStream(const Streams& st, int s)
      : base(st.buf + static_cast<size_t>(st.p) * 128 + s),
        stride(static_cast<size_t>(st.P) * 128), wl(st.wl) {}

  __device__ __forceinline__ uint32_t word(int w) const {
    if (w < 0 || w >= wl) return 0u;
    return static_cast<uint32_t>(
        __ldg(base + (w >> 2) * stride + (w & 3) * kStreams));
  }
};

__device__ __forceinline__ uint32_t low_bits(uint32_t x, int n) {
  return n <= 0 ? 0u : (n >= 32 ? x : (x & ((1u << n) - 1u)));
}

// A bit reservoir over one lane's sub-stream, in registers: buf holds the
// stream's next nbits bits (LSB first, 33..64 of them between calls), and
// the word after them is already loaded into `pending`, so the load of a
// refill was issued one refill earlier and stays off the decode chain.
// Reads the same bits as Streams::peek at the same cursor (words at or
// past wl read as zero). The struct is plain registers: copying it saves
// a cursor, assigning it back rolls a speculative read back.
struct BitReader {
  uint64_t buf;
  int nbits;
  int wnext;          // index of the word held in `pending`
  uint32_t pending;

  __device__ __forceinline__ void init(const LaneStream& ls, int bp) {
    const int w = bp >> 5;
    const uint64_t v = static_cast<uint64_t>(ls.word(w)) |
                       (static_cast<uint64_t>(ls.word(w + 1)) << 32);
    buf = v >> (bp & 31);
    nbits = 64 - (bp & 31);
    wnext = w + 2;
    pending = ls.word(wnext);
  }

  // n (0..32) bits at the cursor
  __device__ __forceinline__ uint32_t peek(int n) const {
    return low_bits(static_cast<uint32_t>(buf), n);
  }

  // advance by n (0..32) bits, then refill up to one word
  __device__ __forceinline__ void skip(const LaneStream& ls, int n) {
    buf >>= n;
    nbits -= n;
    if (nbits <= 32) {
      buf |= static_cast<uint64_t>(pending) << nbits;
      nbits += 32;
      pending = ls.word(++wnext);
    }
  }

  __device__ __forceinline__ uint32_t take(const LaneStream& ls, int n) {
    const uint32_t v = peek(n);
    skip(ls, n);
    return v;
  }
};

__device__ __forceinline__ int rev15(uint32_t v) {
  return static_cast<int>(__brev(v) >> 17);
}

__device__ __forceinline__ int rev9(uint32_t v) {
  return static_cast<int>(__brev(v) >> 23);
}

// RFC 7932 insert/copy length codes 0..23 (format/lut.py).
static __constant__ int kInsertBase[24] = {
    0, 1, 2, 3, 4, 5, 6, 8, 10, 14, 18, 26, 34, 50, 66, 98, 130, 194, 322,
    578, 1090, 2114, 6210, 22594};
static __constant__ int kInsertExtra[24] = {
    0, 0, 0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 7, 8, 9, 10, 12, 14,
    24};
static __constant__ int kCopyBase[24] = {
    2, 3, 4, 5, 6, 7, 8, 9, 10, 12, 14, 18, 22, 30, 38, 54, 70, 102, 134,
    198, 326, 582, 1094, 2118};
static __constant__ int kCopyExtra[24] = {
    0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 7, 8, 9, 10, 24};

// The four tables above held one entry a lane (lanes >= 24 hold entry
// 23): looking up a per-lane code is one shuffle, where a constant-memory
// load serialises over the warp's distinct codes. Every lane of the warp
// must take part in the lookup.
struct LenTables {
  int ins_base, ins_extra, cpy_base, cpy_extra;

  __device__ __forceinline__ explicit LenTables(int lane) {
    const int i = min(lane, 23);
    ins_base = kInsertBase[i];
    ins_extra = kInsertExtra[i];
    cpy_base = kCopyBase[i];
    cpy_extra = kCopyExtra[i];
  }
};

// Command prefix 0..703 -> (insert code, copy code), RFC 7932 section 5.
__device__ __forceinline__ void split_command(int sym, int& ic, int& cc) {
  const int low_ins = (sym >> 3) & 7;
  const int low_cpy = sym & 7;
  if (sym < 128) {
    ic = low_ins;
    cc = low_cpy + (sym >= 64 ? 8 : 0);
    return;
  }
  const int cell = min(max((sym >> 6) - 2, 0), 8);
  const int ins_hi = ((76 >> cell) & 1) | (((416 >> cell) & 1) << 1);
  const int cpy_hi = ((138 >> cell) & 1) | (((336 >> cell) & 1) << 1);
  ic = (ins_hi << 3) | low_ins;
  cc = (cpy_hi << 3) | low_cpy;
}

// One canonical prefix code in range-search form (ops/tables.py::
// build_search): limit/first/offset by code length, the symbols in
// canonical order, and the trivial symbol (-1 if the code has none);
// lut is its first-level table (build_lut), where a kernel has one.
struct Huff {
  const int* lim;
  const int* first;
  const int* off;
  const int* dict;
  int A;
  int triv;
  const uint16_t* lut;
};

// Code length of a bit-reversed 15-bit window: 1 + #{l in 1..15 : idx >=
// limit[l]}. Monotone in idx for any limits, corrupt ones included.
__device__ __forceinline__ int code_len(const Huff& h, int idx) {
  int l = 1;
#pragma unroll
  for (int k = 1; k < 16; ++k) l += idx >= h.lim[k];
  return l;
}

__device__ __forceinline__ int code_sym(const Huff& h, int idx, int l) {
  const int code = l <= 15 ? (idx >> (15 - l)) : 0;
  const int rank = min(max(h.off[l] + code - h.first[l], 0), h.A - 1);
  return h.dict[rank];
}

// Decode one symbol from a 15-bit LSB-first window (ops/decode.py::
// _flat_decode_window): the range search.
__device__ __forceinline__ void decode_sym(const Huff& h, uint32_t win15,
                                           int& sym, int& len) {
  if (h.triv >= 0) {
    sym = h.triv;
    len = 0;
    return;
  }
  const int idx = rev15(win15);
  len = code_len(h, idx);
  sym = code_sym(h, idx, len);
}

// First-level lookup table: entry i answers every window whose low
// kLutBits bits are i, when the range search gives all of them one code
// of at most kLutBits bits (the length is monotone in the reversed
// window, so equal lengths at the two ends of the window's range decide
// it): symbol in bits 0..9, length in bits 10..14. Other entries carry
// kLutLong and the decode falls back to the range search, so the table
// changes no result, only the work per symbol.
constexpr int kLutBits = 10;
constexpr int kLutSize = 1 << kLutBits;
constexpr uint16_t kLutLong = 0x8000;

__device__ __forceinline__ void build_lut(const Huff& h, uint16_t* lut,
                                          int tid, int nthreads) {
  for (int i = tid; i < kLutSize; i += nthreads) {
    int sym = h.triv, len = 0;
    bool ok = true;
    if (h.triv < 0) {
      const int lo = rev15(static_cast<uint32_t>(i));
      const int hi = lo | ((1 << (15 - kLutBits)) - 1);
      len = code_len(h, lo);
      ok = len <= kLutBits && code_len(h, hi) == len;
      sym = ok ? code_sym(h, lo, len) : 0;
    }
    ok = ok && sym >= 0 && sym < 1024;
    lut[i] = ok ? static_cast<uint16_t>(sym | (len << 10)) : kLutLong;
  }
}

// Decode one symbol at the reader's cursor without advancing it.
__device__ __forceinline__ void peek_sym(const Huff& h, const BitReader& br,
                                         int& sym, int& len) {
  const uint32_t e = h.lut[br.peek(kLutBits)];
  if (e & kLutLong) {
    decode_sym(h, br.peek(15), sym, len);
  } else {
    sym = static_cast<int>(e & 1023u);
    len = static_cast<int>(e >> 10);
  }
}

__device__ __forceinline__ int warp_incl_sum(int v, int lane) {
#pragma unroll
  for (int d = 1; d < kStreams; d <<= 1) {
    const int t = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += t;
  }
  return v;
}

__device__ __forceinline__ int warp_excl_max(int v, int lane, int init) {
  int x = __shfl_up_sync(kFull, v, 1);
  if (lane < 1) x = init;
#pragma unroll
  for (int d = 1; d < kStreams; d <<= 1) {
    const int t = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x = max(x, t);
  }
  return x;
}

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int d = 16; d >= 1; d >>= 1) v = max(v, __shfl_xor_sync(kFull, v, d));
  return v;
}

}  // namespace blg
