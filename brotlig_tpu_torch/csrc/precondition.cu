// The BCn texture postprocess (delta decode, then decondition) and
// preprocess (condition, then delta encode), with every address in closed
// form.
//
// Replaces the JAX package's jitted region over map planes held on the
// device: brotlig_tpu/ops/precondition.py:109 (_delta_decode_device), :121
// (_gather_u8) and :127 (_delta_encode_device), which has no Pallas kernel.
// Plain versions: ops/precondition_kernel.py::postprocess_plain /
// preprocess_plain (the same closed form as int64 torch ops); wrappers:
// postprocess_cuda / preprocess_cuda there. No map plane is built,
// uploaded or kept: the geometry comes in one record of int64 words
// (ops/precondition_kernel.py::pack_geometry, the G_* offsets below),
// passed by value, and a page's delta flags in one byte a page (or null:
// every page).
//
// Byte i of the conditioned stream is original byte cond_map[i]
// (format/precondition.py::build_cond_map): sub-stream k by the
// sub-stream offsets, its block by q / sub_size, the mip by the mips' block
// offsets, row and column in that mip, the 2x2 swizzle undone exactly as
// build_cond_map writes it (remainder rows and columns stay unswizzled),
// then mip offset + row * pitch + col * block bytes + sub-block offset +
// q % sub_size. A sub-block piece (1 to 8 bytes) is contiguous on both
// sides, so the kernels move pieces, not bytes. A delta span is where a
// colour sub-stream meets a page (at most 4 a page, BC5); spans never
// cross a page.
//
// Each page of the conditioned stream is cut into kSlices slices of
// page / kSlices bytes, one thread block a slice (a page of 64 KiB on 8
// blocks, so that a texture of a few pages still fills the card's SMs),
// the block's width picked at launch from the slice and the grid
// (launch_threads):
//   * blg_postprocess runs a page on a thread block cluster of kSlices
//     CTAs. Each loads its slice into shared memory with 16-byte vector
//     loads; if the page is flagged, each span becomes its prefix sum
//     modulo 256, by a segmented scan: a lane takes 16 bytes, a packed
//     byte-wise prefix in four words by __vadd4, a warp scan of (start
//     seen, sum) pairs by shuffles, the warps' totals through shared
//     memory and the CTAs' totals through the cluster's distributed shared
//     memory (the scan's carry never leaves the chip; a slice inside one
//     span, the usual case, sums its elements by __dp4a). Then each piece
//     is written to its original address with the widest stores its
//     alignment allows, and the pitch padding, which no conditioned byte
//     covers, is written as 0 by the grid's warps, a row a warp.
//   * blg_preprocess gathers each piece of its slice (and the byte before
//     it) from its original address into shared memory, a thread kUnroll
//     pieces at a time so that their loads are in flight together (the
//     conditioned tail past the sub-streams is 0), writes the slice with
//     16-byte stores, and from the same shared copy the delta slice:
//     inside a flagged page's spans each byte less the byte before it,
//     modulo 256, each span's first byte kept. It needs no cluster.
// A thread's blocks grow within a sub-stream, so it keeps its mip's
// fields in registers (MipCursor) and divides by the width and the
// swizzle's groups a row by a multiply-high with the record's multipliers.
// What bounds them on this card: the bound is bytes (the postprocess
// reads and writes n bytes each, the preprocess reads n and writes 2n),
// but the time goes to the work a piece (an address, a load and a store
// of 1 to 8 bytes; BC1 has 3 pieces a block, BC5 6) and to the pieces'
// scattered writes: the postprocess's writes, and the preprocess's reads,
// are pieces at a block's stride (a sub-stream's consecutive blocks lie
// block bytes apart), whose partial sectors the L2 merges. Reads and the
// preprocess's writes are coalesced 16-byte vectors.
//
// Addresses are 64-bit: a legal texture reaches 2^15 x 2^15 blocks of 16
// bytes and 32 mips. Block indices fit 31 bits.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace blg_precond {
namespace {

namespace cg = cooperative_groups;

constexpr int kSlices = 8;        // thread blocks a page (a cluster's CTAs)
// threads a block: chosen at launch (launch_threads), at most kMaxThreads
constexpr int kMaxThreads = 1024, kMinThreads = 128;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kUnroll = 2;        // pieces a thread takes at a time
constexpr int kMaxSpans = 4;
constexpr unsigned kFull = 0xffffffffu;

// The geometry record (ops/precondition_kernel.py holds the same offsets).
enum {
  G_N, G_M, G_PAGE, G_BB, G_NSUB, G_NMIPS, G_SWIZZLE, G_NCOLOR, G_FORMAT,
  G_TBLOCKS, G_PADDED,
  G_SUB_SIZE = 11, G_SUB_OFF = 17, G_STREAM_OFF = 23, G_COLOR = 30,
  G_MIP = 34, G_MIP_FIELDS = 10, G_MAX_MIPS = 32,
  G_LEN = G_MIP + G_MIP_FIELDS * G_MAX_MIPS
};
// A mip's fields: width and height in blocks, pitch, byte offset, block
// offset, first row (rows of the mips before it), then the multipliers
// and shifts that divide by the width and by the swizzle's groups a row,
// max(width / 2, 1): q / d == (q * mul) >> shift for q < 2^31.
constexpr int M_WIDTH = 0, M_HEIGHT = 1, M_PITCH = 2, M_BYTES = 3,
              M_BLOCKS = 4, M_ROW = 5, M_WMUL = 6, M_WSHIFT = 7, M_GMUL = 8,
              M_GSHIFT = 9;

struct Geom {
  long long v[G_LEN];
};

// A thread's current mip and the fields its blocks' addresses need, in
// registers. A thread's blocks only grow within a sub-stream, so the
// cursor only moves forward.
struct MipCursor {
  int mip, next;                 // next: the next mip's first block
  unsigned start, w, wmul, wl, eff_w, eff_h, rem_w, grps, gmul, gl, pitch;
  long long bytes;

  __device__ void load(const Geom& g, int m) {
    const long long* mp = &g.v[G_MIP + m * G_MIP_FIELDS];
    mip = m;
    next = m + 1 < g.v[G_NMIPS] ? static_cast<int>(mp[G_MIP_FIELDS + M_BLOCKS])
                                : 0x7fffffff;
    start = static_cast<unsigned>(mp[M_BLOCKS]);
    w = static_cast<unsigned>(mp[M_WIDTH]);
    const unsigned h = static_cast<unsigned>(mp[M_HEIGHT]);
    wmul = static_cast<unsigned>(mp[M_WMUL]);
    wl = static_cast<unsigned>(mp[M_WSHIFT]) - 31;
    gmul = static_cast<unsigned>(mp[M_GMUL]);
    gl = static_cast<unsigned>(mp[M_GSHIFT]) - 31;
    pitch = static_cast<unsigned>(mp[M_PITCH]);
    bytes = mp[M_BYTES];
    rem_w = w & 1u;
    eff_w = w - rem_w;
    // no block is swizzled in a mip narrower or lower than 2 blocks
    eff_h = w >= 2 && h >= 2 && g.v[G_SWIZZLE] ? h - (h & 1u) : 0;
    grps = eff_w / 2 > 1u ? eff_w / 2 : 1u;
  }

  __device__ void seek(const Geom& g, int blk) {
    while (blk >= next) load(g, mip + 1);
  }

  // q / d for q < 2^31, by the record's multiplier and shift
  __device__ static unsigned divide(unsigned q, unsigned mul, unsigned l) {
    return __umulhi(q << 1, mul) >> l;
  }

  // The original address of block blk of this mip (its first byte),
  // the swizzle undone as build_cond_map writes it.
  __device__ long long address(int blk, unsigned bb) const {
    const unsigned b = static_cast<unsigned>(blk) - start;
    unsigned row = divide(b, wmul, wl), col = b - row * w;
    if (row < eff_h && col < eff_w) {
      const unsigned eff = b - row * rem_w;
      const unsigned grp = eff >> 2, in = eff & 3u;
      const unsigned gr = divide(grp, gmul, gl);
      row = 2 * gr + (in >> 1);
      col = 2 * (grp - gr * grps) + (in & 1u);
    }
    return bytes + static_cast<unsigned long long>(row) * pitch + col * bb;
  }
};

// The page's delta spans, page-local [s, e), in stream order.
__device__ int page_spans(const Geom& g, long long p0, int len, int* s,
                          int* e) {
  int ns = 0;
  const int nc = static_cast<int>(g.v[G_NCOLOR]);
  for (int c = 0; c < nc; ++c) {
    const int sub = static_cast<int>(g.v[G_COLOR + c]);
    const long long c0 = g.v[G_STREAM_OFF + sub];
    const long long c1 = g.v[G_STREAM_OFF + sub + 1];
    if (c0 < p0 + len && p0 < c1) {
      s[ns] = static_cast<int>(c0 > p0 ? c0 - p0 : 0);
      e[ns] = static_cast<int>(c1 < p0 + len ? c1 - p0 : len);
      ++ns;
    }
  }
  return ns;
}

// Bytes [a, a + 16) against the spans: bit j of `in` if byte a + j lies
// in a span, of `st` if a span starts there.
__device__ void element_masks(int a, int ns, const int* s, const int* e,
                              unsigned& in, unsigned& st) {
  in = 0;
  st = 0;
  for (int k = 0; k < ns; ++k) {
    const int lo = max(s[k], a), hi = min(e[k], a + 16);
    if (lo < hi) in |= ((1u << (hi - a)) - 1u) & ~((1u << (lo - a)) - 1u);
    if (s[k] >= a && s[k] < a + 16) st |= 1u << (s[k] - a);
  }
}

__device__ unsigned byte_of(const uint4& v, int j) {
  const unsigned w = j < 4 ? v.x : j < 8 ? v.y : j < 12 ? v.z : v.w;
  return (w >> (8 * (j & 3))) & 0xffu;
}

__device__ void set_byte(uint4& v, int j, unsigned b) {
  unsigned* w = j < 4 ? &v.x : j < 8 ? &v.y : j < 12 ? &v.z : &v.w;
  const int sh = 8 * (j & 3);
  *w = (*w & ~(0xffu << sh)) | (b << sh);
}

// Inclusive byte-wise prefix sums modulo 256 of 16 bytes.
__device__ uint4 byte_prefix(uint4 v) {
  unsigned p[4] = {v.x, v.y, v.z, v.w};
  unsigned carry = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    unsigned q = p[k];
    q = __vadd4(q, q << 8);
    q = __vadd4(q, q << 16);
    q = __vadd4(q, carry);
    carry = (q >> 24) * 0x01010101u;
    p[k] = q;
  }
  return make_uint4(p[0], p[1], p[2], p[3]);
}

// A scan element: bit 8 set if a span start was seen, bits 0-7 the sum
// modulo 256 since the last start (or since the first byte). `a` comes
// before `b`.
__device__ unsigned combine(unsigned a, unsigned b) {
  return (b & 0x100u) ? b : ((a & 0x100u) | ((a + b) & 0xffu));
}

__device__ unsigned warp_scan(unsigned v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned o = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v = combine(o, v);
  }
  return v;
}

// The sum of 16 bytes (at most 4080).
__device__ unsigned byte_sum(const uint4& v) {
  const unsigned ones = 0x01010101u;
  return __dp4a(v.x, ones, __dp4a(v.y, ones, __dp4a(v.z, ones,
                                                   __dp4a(v.w, ones, 0u))));
}

// 16 bytes' scan element, from their prefix P and start bits.
__device__ unsigned element_sum(const uint4& P, unsigned st) {
  const unsigned total = P.w >> 24;
  if (!st) return total;
  const int j0 = 31 - __clz(st);
  const unsigned before = j0 ? byte_of(P, j0 - 1) : 0u;
  return 0x100u | ((total - before) & 0xffu);
}

// The cluster barrier in two halves: a CTA arrives once it has started,
// and waits before it first writes to another CTA's shared memory (every
// CTA of the cluster must have started by then).
__device__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__device__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// A slice's delta decode: the slice's bytes [0, len) in shared memory lie
// at [off, off + len) of its page, whose spans (page-local) are s, e.
// Warp w takes a contiguous share of the 16-byte elements, 32 a round.
// Pass 1 sums each warp's share; the CTA's total goes into the shared
// memory of the cluster's later CTAs (the later slices of the page), so
// that CTA r carries in the totals of CTAs 0 to r - 1 after one cluster
// barrier; pass 2 rescans each share with the sum before it carried in.
// `red` is kMaxWarps + kSlices words of shared memory.
__device__ void delta_decode_slice(uint8_t* sm, int off, int len, int ns,
                                   const int* s, const int* e, unsigned* red,
                                   cg::cluster_group& cluster) {
  uint4* sm4 = reinterpret_cast<uint4*>(sm);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int nel = (len + 15) >> 4;
  const int share = ((nel + nwarps - 1) / nwarps + 31) & ~31;
  const int e0 = warp * share, e1 = min(e0 + share, nel);
  // the usual slice: whole elements inside one span that starts before it
  bool inside = (len & 15) == 0;
  if (inside) {
    inside = false;
    for (int k = 0; k < ns; ++k)
      inside |= s[k] < off && e[k] >= off + len;
  }
  unsigned total = 0;
  for (int base = e0; base < e1; base += 32) {
    const int el = base + lane;
    unsigned v = 0;
    if (el < e1 && inside) {
      v = byte_sum(sm4[el]) & 0xffu;
    } else if (el < e1) {
      unsigned in, st;
      element_masks(off + el * 16, ns, s, e, in, st);
      v = element_sum(byte_prefix(sm4[el]), st);
    }
    total = combine(total, __shfl_sync(kFull, warp_scan(v, lane), 31));
  }
  if (lane == 0) red[warp] = total;
  __syncthreads();
  cluster_wait();                 // every CTA of the cluster has started
  const unsigned r = cluster.block_rank();
  if (threadIdx.x == 0) {         // this CTA's total to the later CTAs
    unsigned cta = 0;
    for (int k = 0; k < nwarps; ++k) cta = combine(cta, red[k]);
    for (unsigned k = r + 1; k < kSlices; ++k)
      cluster.map_shared_rank(red + kMaxWarps, k)[r] = cta;
  }
  cluster.sync();                 // the earlier CTAs' totals have arrived
  unsigned carry = 0;
  for (unsigned k = 0; k < r; ++k) carry = combine(carry, red[kMaxWarps + k]);
  for (int k = 0; k < warp; ++k) carry = combine(carry, red[k]);
  for (int base = e0; base < e1; base += 32) {
    const int el = base + lane;
    unsigned v = 0, in = 0, st = 0;
    uint4 x = make_uint4(0, 0, 0, 0), P = x;
    if (el < e1) {
      if (inside)
        in = 0xffffu;
      else
        element_masks(off + el * 16, ns, s, e, in, st);
      x = sm4[el];
      P = byte_prefix(x);
      v = element_sum(P, st);
    }
    const unsigned inc = warp_scan(v, lane);
    unsigned excl = __shfl_up_sync(kFull, inc, 1);
    if (lane == 0) excl = 0;
    const unsigned c = combine(carry, excl) & 0xffu;
    if (el < e1 && in) {
      if (!st && in == 0xffffu) {
        const unsigned cc = c * 0x01010101u;
        x = make_uint4(__vadd4(P.x, cc), __vadd4(P.y, cc), __vadd4(P.z, cc),
                       __vadd4(P.w, cc));
      } else {
        unsigned acc = c;
        for (int j = 0; j < 16; ++j) {
          const unsigned b = byte_of(x, j);
          if ((st >> j) & 1u) acc = 0;
          acc = (acc + b) & 0xffu;
          if ((in >> j) & 1u) set_byte(x, j, acc);
        }
      }
      sm4[el] = x;
    }
    carry = combine(carry, __shfl_sync(kFull, inc, 31));
  }
}

// len bytes from global memory into shared memory, zero-filled to a
// multiple of 16 bytes.
__device__ void load_bytes(uint8_t* sm, const uint8_t* src, int len) {
  const int nvec = len >> 4;
  int k0 = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(sm);
#pragma unroll 4
    for (int k = threadIdx.x; k < nvec; k += blockDim.x) d4[k] = s4[k];
    k0 = nvec << 4;
  }
  for (int k = k0 + threadIdx.x; k < len; k += blockDim.x) sm[k] = src[k];
  const int end = (len + 15) & ~15;
  for (int k = len + threadIdx.x; k < end; k += blockDim.x) sm[k] = 0;
}

// len bytes of shared memory to global memory.
__device__ void store_bytes(uint8_t* dst, const uint8_t* sm, int len) {
  const int nvec = len >> 4;
  int k0 = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const uint4* s4 = reinterpret_cast<const uint4*>(sm);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
#pragma unroll 4
    for (int k = threadIdx.x; k < nvec; k += blockDim.x) d4[k] = s4[k];
    k0 = nvec << 4;
  }
  for (int k = k0 + threadIdx.x; k < len; k += blockDim.x) dst[k] = sm[k];
}

// A piece's bytes (at most 8) as one little-endian word, stored with the
// widest stores the destination's alignment allows.
__device__ void store_piece(uint8_t* dst, unsigned long long v, int len) {
  while (len > 0) {
    const uintptr_t ad = reinterpret_cast<uintptr_t>(dst);
    if (len == 8 && !(ad & 7)) {
      *reinterpret_cast<unsigned long long*>(dst) = v;
      return;
    }
    if (len >= 4 && !(ad & 3)) {
      *reinterpret_cast<unsigned*>(dst) = static_cast<unsigned>(v);
      dst += 4, len -= 4, v >>= 32;
    } else if (len >= 2 && !(ad & 1)) {
      *reinterpret_cast<unsigned short*>(dst) = static_cast<unsigned short>(v);
      dst += 2, len -= 2, v >>= 16;
    } else {
      *dst = static_cast<uint8_t>(v);
      dst += 1, len -= 1, v >>= 8;
    }
  }
}

// A piece's bytes (at most 8) into shared memory: one store where the
// piece is a whole aligned word.
__device__ void store_shared_piece(uint8_t* dst, unsigned long long v,
                                   int len) {
  const uintptr_t ad = reinterpret_cast<uintptr_t>(dst);
  if (len == 2 && !(ad & 1)) {
    *reinterpret_cast<unsigned short*>(dst) = static_cast<unsigned short>(v);
  } else if (len == 4 && !(ad & 3)) {
    *reinterpret_cast<unsigned*>(dst) = static_cast<unsigned>(v);
  } else if (len == 8 && !(ad & 7)) {
    *reinterpret_cast<unsigned long long*>(dst) = v;
  } else {
    for (int j = 0; j < len; ++j, v >>= 8) dst[j] = static_cast<uint8_t>(v);
  }
}

// A piece's bytes (at most 8) from global memory, read with the widest
// loads the source's alignment allows.
__device__ unsigned long long load_piece(const uint8_t* src, int len) {
  unsigned long long v = 0;
  int sh = 0;
  while (len > 0) {
    const uintptr_t ad = reinterpret_cast<uintptr_t>(src);
    if (len == 8 && !(ad & 7))
      return *reinterpret_cast<const unsigned long long*>(src);
    if (len >= 4 && !(ad & 3)) {
      v |= static_cast<unsigned long long>(
               *reinterpret_cast<const unsigned*>(src)) << sh;
      src += 4, len -= 4, sh += 32;
    } else if (len >= 2 && !(ad & 1)) {
      v |= static_cast<unsigned long long>(
               *reinterpret_cast<const unsigned short*>(src)) << sh;
      src += 2, len -= 2, sh += 16;
    } else {
      v |= static_cast<unsigned long long>(*src) << sh;
      src += 1, len -= 1, sh += 8;
    }
  }
  return v;
}

// The pieces of the conditioned bytes [a0, b0), positions relative to
// base (the range lies within 2^31 bytes of it): a piece is sub-stream k's
// block q, whose bytes [lo, hi) lie in the range, `at` the relative
// position of byte lo, `addr` the original address of byte lo. A thread
// takes kUnroll pieces a round (blocks q, q + blockDim.x, ...): pre(u, ...)
// runs for each of them first, then post(u, ...), so that the loads a
// caller issues in pre are in flight together.
template <typename Pre, typename Post>
__device__ void for_pieces(const Geom& g, long long base, long long a0,
                           long long b0, Pre pre, Post post) {
  const int nsub = static_cast<int>(g.v[G_NSUB]);
  for (int k = 0; k < nsub; ++k) {
    const long long s0 = g.v[G_STREAM_OFF + k], s1 = g.v[G_STREAM_OFF + k + 1];
    const long long a = s0 > a0 ? s0 : a0;
    const long long b = s1 < b0 ? s1 : b0;
    if (a >= b) continue;
    const int sz = static_cast<int>(g.v[G_SUB_SIZE + k]);
    const unsigned soff = static_cast<unsigned>(g.v[G_SUB_OFF + k]);
    const unsigned bb = static_cast<unsigned>(g.v[G_BB]);
    const int q0 = static_cast<int>((a - s0) / sz);
    const int q1 = static_cast<int>((b - 1 - s0) / sz);
    // relative positions: the range [ra, rb), block q0's first byte r0
    const int ra = static_cast<int>(a - base), rb = static_cast<int>(b - base);
    const int r0 =
        static_cast<int>(s0 + static_cast<long long>(q0) * sz - base);
    MipCursor mc;
    mc.load(g, 0);
    for (int qb = q0 + static_cast<int>(threadIdx.x); qb <= q1;
         qb += blockDim.x * kUnroll) {
      int lo[kUnroll], hi[kUnroll], at[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int q = qb + u * static_cast<int>(blockDim.x);
        lo[u] = hi[u] = at[u] = 0;
        if (q > q1) continue;
        const int start = r0 + (q - q0) * sz;
        lo[u] = ra > start ? ra - start : 0;
        hi[u] = rb - start < sz ? rb - start : sz;
        at[u] = start + lo[u];
        mc.seek(g, q);
        pre(u, at[u], mc.address(q, bb) + soff + lo[u], hi[u] - lo[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (hi[u] > lo[u]) post(u, at[u], hi[u] - lo[u]);
    }
  }
}

// A piece's bytes (at most 8) from shared memory as one little-endian
// word: one load where the piece is a whole aligned word.
__device__ unsigned long long load_shared_piece(const uint8_t* src, int len) {
  const uintptr_t ad = reinterpret_cast<uintptr_t>(src);
  if (len == 2 && !(ad & 1))
    return *reinterpret_cast<const unsigned short*>(src);
  if (len == 4 && !(ad & 3)) return *reinterpret_cast<const unsigned*>(src);
  if (len == 8 && !(ad & 7))
    return *reinterpret_cast<const unsigned long long*>(src);
  unsigned long long w = 0;
  for (int j = 0; j < len; ++j)
    w |= static_cast<unsigned long long>(src[j]) << (8 * j);
  return w;
}

// Zero the pitch padding of every row (a row a warp over the grid), and
// nothing where no mip has padding.
__device__ void zero_padding(const Geom& g, uint8_t* out) {
  if (!g.v[G_PADDED]) return;
  const int nm = static_cast<int>(g.v[G_NMIPS]);
  const long long* last = &g.v[G_MIP + (nm - 1) * G_MIP_FIELDS];
  const long long rows = last[M_ROW] + last[M_HEIGHT];
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const long long stride = static_cast<long long>(gridDim.x) * nwarps;
  int mip = 0;
  for (long long r = static_cast<long long>(blockIdx.x) * nwarps +
                     (threadIdx.x >> 5);
       r < rows; r += stride) {
    while (mip + 1 < nm && g.v[G_MIP + (mip + 1) * G_MIP_FIELDS + M_ROW] <= r)
      ++mip;
    const long long* mp = &g.v[G_MIP + mip * G_MIP_FIELDS];
    const long long used = mp[M_WIDTH] * g.v[G_BB];
    const long long pad = mp[M_PITCH] - used;
    uint8_t* row = out + mp[M_BYTES] + (r - mp[M_ROW]) * mp[M_PITCH] + used;
    for (long long j = lane; j < pad; j += 32) row[j] = 0;
  }
}

// This block's slice: its page's first byte p0 and length len, and the
// slice's bytes [off, off + slen) of the page.
struct Slice {
  long long p0;
  int len, off, slen;
};

__device__ Slice slice_of(const Geom& g) {
  Slice sl;
  const long long page = g.v[G_PAGE], n = g.v[G_N];
  sl.p0 = static_cast<long long>(blockIdx.x / kSlices) * page;
  sl.len = static_cast<int>(n - sl.p0 < page ? n - sl.p0 : page);
  const int part = static_cast<int>(page / kSlices);
  sl.off = static_cast<int>(blockIdx.x % kSlices) * part;
  sl.slen = max(0, min(part, sl.len - sl.off));
  return sl;
}

__global__ void __cluster_dims__(kSlices, 1, 1) __launch_bounds__(kMaxThreads)
postprocess_kernel(const __grid_constant__ Geom g, const uint8_t* x,
                   const uint8_t* flags, uint8_t* out) {
  extern __shared__ uint4 smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  uint8_t* sm = reinterpret_cast<uint8_t*>(smem_raw);
  const Slice sl = slice_of(g);
  unsigned* red = reinterpret_cast<unsigned*>(
      sm + g.v[G_PAGE] / kSlices);
  const long long at0 = sl.p0 + sl.off;        // the slice's first byte
  cluster_arrive_relaxed();
  load_bytes(sm, x + at0, sl.slen);
  __syncthreads();
  int s[kMaxSpans], e[kMaxSpans];
  const int ns = page_spans(g, sl.p0, sl.len, s, e);
  // uniform over the cluster: its CTAs share the page
  if (ns && (flags == nullptr || flags[blockIdx.x / kSlices])) {
    delta_decode_slice(sm, sl.off, sl.slen, ns, s, e, red, cluster);
    __syncthreads();
  } else {
    cluster_wait();
  }
  const long long m = g.v[G_M];
  unsigned long long v[kUnroll];
  uint8_t* dst[kUnroll];
  for_pieces(
      g, at0, at0, min(at0 + sl.slen, m),
      [&](int u, int at, long long addr, int len) {
        v[u] = load_shared_piece(sm + at, len);
        dst[u] = out + addr;
      },
      [&](int u, int, int len) { store_piece(dst[u], v[u], len); });
  zero_padding(g, out);
}

__global__ void __launch_bounds__(kMaxThreads)
preprocess_kernel(const __grid_constant__ Geom g, const uint8_t* x,
                  const uint8_t* flags, uint8_t* cond, uint8_t* delta) {
  extern __shared__ uint4 smem_raw[];
  // the byte before the slice at sm[15], the slice from sm[16]
  uint8_t* sm = reinterpret_cast<uint8_t*>(smem_raw);
  const Slice sl = slice_of(g);
  const long long at0 = sl.p0 + sl.off;
  const long long m = g.v[G_M];
  const long long a0 = sl.off ? at0 - 1 : at0;
  unsigned long long v[kUnroll];
  for_pieces(
      g, at0, a0, min(at0 + sl.slen, m),
      [&](int u, int, long long addr, int len) {
        v[u] = load_piece(x + addr, len);
      },
      [&](int u, int at, int len) {
        store_shared_piece(sm + 16 + at, v[u], len);
      });
  // the conditioned tail past the sub-streams is 0
  const int lc = static_cast<int>(max(0LL, min(m - at0, (long long)sl.slen)));
  const int end = (sl.slen + 15) & ~15;
  for (int j = lc + threadIdx.x; j < end; j += blockDim.x) sm[16 + j] = 0;
  __syncthreads();
  store_bytes(cond + at0, sm + 16, sl.slen);
  if (delta == nullptr) return;
  int s[kMaxSpans], e[kMaxSpans];
  const int ns = page_spans(g, sl.p0, sl.len, s, e);
  if (!ns || (flags != nullptr && !flags[blockIdx.x / kSlices])) {
    store_bytes(delta + at0, sm + 16, sl.slen);
    return;
  }
  const uint4* sm4 = reinterpret_cast<const uint4*>(sm + 16);
  const bool aligned = (reinterpret_cast<uintptr_t>(delta + at0) & 15) == 0;
  for (int el = threadIdx.x; el * 16 < sl.slen; el += blockDim.x) {
    const int a = el * 16;
    uint4 x4 = sm4[el];
    unsigned in, st;
    element_masks(sl.off + a, ns, s, e, in, st);
    const unsigned use = in & ~st;      // bytes that become differences
    if (use) {
      // a byte that becomes a difference is never the page's first
      const unsigned before = sm[15 + a];
      const uint4 prev = make_uint4((x4.x << 8) | before,
                                    (x4.y << 8) | (x4.x >> 24),
                                    (x4.z << 8) | (x4.y >> 24),
                                    (x4.w << 8) | (x4.z >> 24));
      const uint4 d = make_uint4(__vsub4(x4.x, prev.x), __vsub4(x4.y, prev.y),
                                 __vsub4(x4.z, prev.z), __vsub4(x4.w, prev.w));
      if (use == 0xffffu) {
        x4 = d;
      } else {
        // bit j of `use` spread to byte j of a word, times 0xff
        unsigned w[4] = {x4.x, x4.y, x4.z, x4.w};
        const unsigned dw[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const unsigned bits = (use >> (4 * k)) & 0xfu;
          const unsigned sel = ((bits * 0x00204081u) & 0x01010101u) * 0xffu;
          w[k] = (dw[k] & sel) | (w[k] & ~sel);
        }
        x4 = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    if (aligned && a + 16 <= sl.slen) {
      *reinterpret_cast<uint4*>(delta + at0 + a) = x4;
    } else {
      for (int j = 0; j < 16 && a + j < sl.slen; ++j)
        delta[at0 + a + j] = static_cast<uint8_t>(byte_of(x4, j));
    }
  }
}

bool load_geom(const long long* rec, Geom* g) {
  for (int k = 0; k < G_LEN; ++k) g->v[k] = rec[k];
  const long long page = g->v[G_PAGE];
  return page > 0 && page % (16 * kSlices) == 0 && page <= (1 << 17) &&
         g->v[G_NMIPS] >= 1 && g->v[G_NMIPS] <= G_MAX_MIPS;
}

// Thread blocks of a launch: kSlices a page.
long long blocks(const Geom& g) {
  return (g.v[G_N] + g.v[G_PAGE] - 1) / g.v[G_PAGE] * kSlices;
}

// Threads a block: one for 16 bytes of the slice (up to kMaxThreads),
// halved while the grid's threads pass one full load of the current
// device's SMs (2048 threads each), and no fewer than kMinThreads. A
// texture of few pages gets wide blocks; a large one, narrow blocks that
// fit more to an SM. (The rule follows builds at fixed widths from 128
// to 1024 timed on chip_smoke.py's textures on the H100.)
int launch_threads(long long grid, long long slice) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    sms = 1;
  int t = kMaxThreads;
  while (t > kMinThreads && (t > slice / 16 || grid * t > 2048LL * sms))
    t >>= 1;
  return t;
}

}  // namespace
}  // namespace blg_precond

// Delta decode (pages whose flag is set; flags null: every page) and
// decondition of the n-byte conditioned stream x into out (n bytes), a
// cluster of 8 blocks a page. geom is a host pointer to the record.
extern "C" int blg_postprocess(const long long* geom, const void* x,
                               const void* flags, void* out, void* stream) {
  using namespace blg_precond;
  Geom g;
  if (!load_geom(geom, &g)) return static_cast<int>(cudaErrorInvalidValue);
  const long long grid = blocks(g);
  if (grid <= 0) return 0;
  // the slice, then the warps' and the CTA's scan totals
  const int smem = static_cast<int>(g.v[G_PAGE] / kSlices) +
                   4 * (kMaxWarps + kSlices);
  const int threads = launch_threads(grid, g.v[G_PAGE] / kSlices);
  postprocess_kernel<<<static_cast<unsigned>(grid), threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      g, static_cast<const uint8_t*>(x), static_cast<const uint8_t*>(flags),
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Condition the n-byte texture x into cond and, where delta is not null,
// its delta encoding into delta (pages whose flag is set; flags null:
// every page), 8 blocks a page.
extern "C" int blg_preprocess(const long long* geom, const void* x,
                              const void* flags, void* cond, void* delta,
                              void* stream) {
  using namespace blg_precond;
  Geom g;
  if (!load_geom(geom, &g)) return static_cast<int>(cudaErrorInvalidValue);
  const long long grid = blocks(g);
  if (grid <= 0) return 0;
  const int smem = 16 + static_cast<int>(g.v[G_PAGE] / kSlices);
  const int threads = launch_threads(grid, g.v[G_PAGE] / kSlices);
  preprocess_kernel<<<static_cast<unsigned>(grid), threads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      g, static_cast<const uint8_t*>(x), static_cast<const uint8_t*>(flags),
      static_cast<uint8_t*>(cond), static_cast<uint8_t*>(delta));
  return static_cast<int>(cudaGetLastError());
}
