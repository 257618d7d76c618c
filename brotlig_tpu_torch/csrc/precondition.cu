// The BCn texture postprocess (delta decode, then decondition) and
// preprocess (condition, then delta encode), with every address in closed
// form.
//
// Replaces the JAX package's jitted region over map planes held on the
// device: brotlig_tpu/ops/precondition.py:109 (_delta_decode_device), :121
// (_gather_u8) and :127 (_delta_encode_device), which has no Pallas kernel.
// Plain versions: ops/precondition_kernel.py::postprocess_plain /
// preprocess_plain (the same closed form as int64 torch ops); wrappers:
// postprocess_cuda / preprocess_cuda there; the tile cut's plain twin is
// tile_plan there, the look-back's carries' lookback_carries. No map plane
// is built, uploaded or kept: the geometry comes in one record of int64
// words (ops/precondition_kernel.py::pack_geometry, the G_* offsets
// below), passed by value with the tile plan the host derives from it,
// and a page's delta flags in one byte a page (or null: every page).
//
// The unit of work is a row pair. In a mip of w x h blocks, conditioned
// blocks [2p w, 2p w + 2w) of every sub-stream are exactly original rows
// 2p and 2p + 1: the 2x2 swizzle (format/precondition.py::build_cond_map)
// moves blocks only inside such a pair and leaves the odd remainder column
// and the rows past the swizzled height in place. Inside a swizzled pair,
// original columns 2g, 2g + 1 of row 2p are the pair's conditioned blocks
// 4g, 4g + 1 and those of row 2p + 1 blocks 4g + 2, 4g + 3 (counted past
// row 2p's remainder block, which lies between the two halves). A tile is
// a run of whole row pairs (narrow mips: `per` pairs of kTile texture
// bytes at most, padding included) or a chunk of `per` column pairs of one
// row pair (wide mips); unswizzled pairs are cut row-major. So each
// sub-stream's part of a tile is one contiguous segment of the conditioned
// stream, and its texture part one contiguous range (narrow) or at most
// three row pieces (wide: row 2p's groups, row 2p + 1's groups with the
// remainder and the padding, row 2p's remainder and padding). Tiles follow
// the conditioned order, so they also follow it in every sub-stream.
//
// Both kernels run a persistent grid (at most kCtasPerSM CTAs an SM, as
// many as fit). A CTA is kThreads consumer threads and a producer warp,
// with a ring of kRing tile buffers in shared memory: the producer claims
// a tile, describes it (pieces, segments, the pages its colour segments
// meet) and fills a free buffer with 1-D bulk copies (cp.async.bulk,
// completing on an mbarrier; each range widened to 16-byte boundaries,
// which keeps every byte at its address modulo 16) while the consumers
// work the tile before it.
//   * blg_postprocess claims tiles in stream order from an atomic counter
//     (a tile is claimed only by a running CTA). Its colour
//     segments need the delta carry since their span's start (a span is
//     where a colour sub-stream meets a page, so the sums reset at page
//     starts and sub-stream starts): a decoupled look-back (Merrill and
//     Garland, "Single-pass Parallel Prefix Scan with Decoupled Look-back",
//     2016) over tiles, one status word a tile and colour holding the
//     segmented element (start seen, sum modulo 256). The producer, once a
//     tile's copies land, reduces each colour segment (a lane a run of
//     16-byte chunks, byte sums by __dp4a, a warp scan by shuffles),
//     publishes the aggregate, reads its predecessors' words 32 at a time
//     back to the first inclusive one, and leaves in the descriptor the
//     element before each consumer warp's chunks, the carry included. The
//     consumers then decode the segments in place in one pass (byte-wise
//     prefixes by __dp4a), assemble the texture: 16 output bytes a thread
//     (two BC1 blocks, or one block of 16 bytes) from two adjacent blocks
//     of each sub-stream segment by fixed byte permutes, stored with
//     16-byte vector stores straight to the texture where a piece is
//     aligned and has no padding, else through a staging buffer whose
//     pieces are stored with the pitch padding as 0. A colour segment that
//     no flagged page meets publishes at once and scans nothing.
//   * blg_preprocess is the mirror with no scan: tiles by the grid's
//     stride, the texture pieces loaded ahead, split in shared memory into
//     the sub-stream segments, then the conditioned segments stored and,
//     from the same copy, the delta segments (inside a flagged page's span
//     each byte less the byte before it, modulo 256, each span's first
//     byte kept; the producer loads the byte before each colour segment,
//     one closed-form load), and the conditioned tail past the sub-streams
//     as 0.
// The wrapper zeroes the look-back's words (and two counters) with torch;
// the last CTA to finish zeroes them again, so that a buffer serves
// consecutive launches. On request each CTA writes a record of clock
// cycles by phase (the consumers' wait for the producer, the producer's
// look-back, the consumers' delta scan, assembling or splitting,
// storing), its tiles and its total.
// What bounds them on this card: bytes (the postprocess reads and writes n
// bytes each, the preprocess reads n and writes 2n); both sides of every
// tile move as whole coalesced segments, and the permutes and scans stay
// in shared memory. Measured, each tile's chain of dependent phases
// (claim, describe, copies, look-back, scan, permute) bounds them more
// than bytes do (PERF.md).
//
// Addresses are 64-bit: a legal texture reaches 2^15 x 2^15 blocks of 16
// bytes and 32 mips. Block indices fit 31 bits. The tensors are 16-byte
// aligned (the wrappers check); a copy widened to 16-byte boundaries reads
// only 16-byte chunks that hold bytes of the stream.
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef BLG_PRECOND_TILE
#define BLG_PRECOND_TILE 16384
#endif
#ifndef BLG_PRECOND_RING
#define BLG_PRECOND_RING 2
#endif
#ifndef BLG_PRECOND_THREADS
#define BLG_PRECOND_THREADS 256
#endif
#ifndef BLG_PRECOND_CTAS
#define BLG_PRECOND_CTAS 4
#endif

namespace blg_precond {
namespace {

constexpr int kTile = BLG_PRECOND_TILE;   // texture bytes of a tile, at most
constexpr int kRing = BLG_PRECOND_RING;   // tile buffers in shared memory
constexpr int kThreads = BLG_PRECOND_THREADS;
constexpr int kWarps = kThreads / 32;
constexpr int kCtasPerSM = BLG_PRECOND_CTAS;
constexpr int kMaxSubs = 6, kMaxColors = 4, kPieces = 3;
// a tile's sub-stream segments (each with 16 bytes before and after), and
// its texture pieces (each with 16 after)
constexpr int kSlotBytes = kTile + 512;
constexpr int kStageBytes = kTile + 512;
constexpr unsigned kFull = 0xffffffffu;
// a look-back word: state in bits 30-31, the element in bits 0-8
constexpr unsigned kAggregate = 1u << 30, kInclusive = 2u << 30;
constexpr unsigned kElement = 0x1ffu, kStart = 0x100u;
// the per-CTA record (ops/precondition_kernel.py REC_* names the words)
constexpr int kRecWords = 7;
static_assert(kWarps >= kMaxColors && 32 % kWarps == 0,
              "a warp a colour looks back; the warps' shares start on lanes");
enum { R_LOAD, R_LOOKBACK, R_SCAN, R_MOVE, R_STORE, R_TILES, R_TOTAL };

// The geometry record (ops/precondition_kernel.py holds the same offsets).
enum {
  G_N, G_M, G_PAGE, G_BB, G_NSUB, G_NMIPS, G_SWIZZLE, G_NCOLOR, G_FORMAT,
  G_TBLOCKS, G_PADDED,
  G_SUB_SIZE = 11, G_SUB_OFF = 17, G_STREAM_OFF = 23, G_COLOR = 30,
  G_MIP = 34, G_MIP_FIELDS = 10, G_MAX_MIPS = 32,
  G_LEN = G_MIP + G_MIP_FIELDS * G_MAX_MIPS
};
// A mip's fields: width and height in blocks, pitch, byte offset, block
// offset, first row (the multipliers after them are not read here).
constexpr int M_WIDTH = 0, M_HEIGHT = 1, M_PITCH = 2, M_BYTES = 3,
              M_BLOCKS = 4;

struct Geom {
  long long v[G_LEN];
};

// A mip's share of the tiles: tile0 its first; narrow 1 when a tile is
// `per` whole row pairs, 0 when it is a chunk of `per` column pairs of one
// row pair, `chunks` chunks a pair (ops/precondition_kernel.py::tile_plan
// is the plain twin).
struct MipPlan {
  int tile0, narrow, per, chunks;
};

struct Params {
  Geom g;
  int ntiles, page_shift;         // log2 of the page size, or -1
  MipPlan mp[G_MAX_MIPS + 1];     // mp[nmips].tile0 == ntiles
};

// A texture piece: rows [row, row + rows) of the tile's mip, blocks
// [c0, c1) of each. Its bytes start at ga; the postprocess writes up to ge
// (the padding of its last row when it owns it), of which [ga, gst) is
// staged; the preprocess loads [ga, gld). Staged at st + (ga & 15);
// direct: the postprocess stores its units straight to the texture (16
// bytes of whole blocks each, 16-byte aligned, no padding to write).
struct Piece {
  int row, rows, c0, c1, st, units, upr, direct;
  long long ga, gst, ge, gld;
};

// A colour segment's pages: the first, pg0, starts at p0, the next at nb;
// bit i of fl is
// page pg0 + i's delta flag (every bit when no flags are given; `many`:
// past 32 pages, the flags are read from global memory); live: a flagged
// page meets the segment; start: a span starts at its first byte; carry:
// its first byte needs the carry (in a flagged page, no span start);
// before: the conditioned byte before it (the preprocess's).
struct Colour {
  long long p0, pg0, nb;
  unsigned fl;
  int many, live, start, carry, before;
};

// A tile: its mip's fields, its conditioned blocks [b0, b1), its pieces,
// its segment of each sub-stream, [gs, gs + len) of the stream, held at
// reg + 16 + (gs & 15) of a slot, and its colour segments' pages.
struct Desc {
  int tile, w, eff_w, eff_h, rem_w, np, zero, staged;
  long long b0, b1, pitch, bytes, mipblk;
  Piece pc[kPieces];
  long long gs[kMaxSubs];
  int len[kMaxSubs], reg[kMaxSubs];
  Colour col[kMaxColors];
  // the postprocess's scan element of each colour segment's bytes before
  // each consumer warp's chunks (chunks_per_thread), the carry included
  unsigned wpre[kMaxColors][kWarps];
};

// The sub-block split of each format the record can hold
// (format/constants.py BCN_GEOMETRY; any other format is one sub-stream of
// 1-byte blocks).
template <int BB, int S0, int S1 = 0, int S2 = 0, int S3 = 0, int S4 = 0,
          int S5 = 0>
struct Fmt {
  static constexpr int kBB = BB;
  static constexpr int kNSub =
      (S0 > 0) + (S1 > 0) + (S2 > 0) + (S3 > 0) + (S4 > 0) + (S5 > 0);
  // blocks a unit of work: two 8-byte blocks make 16 output bytes
  static constexpr int kUB = BB == 8 ? 2 : 1;
  __host__ __device__ static constexpr int size(int k) {
    return k == 0 ? S0 : k == 1 ? S1 : k == 2 ? S2 : k == 3 ? S3
           : k == 4 ? S4 : k == 5 ? S5 : 0;
  }
  __host__ __device__ static constexpr int off(int k) {
    return k <= 0 ? 0 : off(k - 1) + size(k - 1);
  }
};
using FmtBC1 = Fmt<8, 2, 2, 4>;
using FmtBC2 = Fmt<16, 8, 2, 2, 4>;
using FmtBC3 = Fmt<16, 1, 1, 6, 2, 2, 4>;
using FmtBC4 = Fmt<8, 1, 1, 6>;
using FmtBC5 = Fmt<16, 1, 1, 6, 1, 1, 6>;
using FmtRaw = Fmt<1, 1>;

// -- Hopper's bulk copies, mbarriers and relaxed global accesses ----------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar))
               : "memory");
}

// Arrive once and expect `bytes` of bulk copies on the barrier's phase.
__device__ __forceinline__ void bar_expect(unsigned long long* bar,
                                           unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_wait(unsigned long long* bar,
                                         unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Arrive once on the barrier, with no bytes.
__device__ __forceinline__ void bar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// The consumer threads' barrier (named barrier 1; the producer warp runs
// on).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"r"(kThreads) : "memory");
}

// Order this CTA's earlier shared-memory accesses before later bulk copies.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ unsigned load_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// -- end of Hopper's bulk copies, mbarriers and relaxed global accesses ---

__host__ __device__ __forceinline__ long long align_down(long long a) {
  return a & ~15LL;
}

__host__ __device__ __forceinline__ long long align_up(long long a) {
  return (a + 15) & ~15LL;
}

// -- The tile cut ---------------------------------------------------------

// The plan of tiles: a narrow mip (two rows with their padding fit kTile)
// takes `per` = kTile / (2 pitch) row pairs a tile; a wide one cuts each
// pair into chunks of `per` = kTile / (4 bb) column pairs. False when the
// tiles pass 2^31.
bool make_plan(const Geom& g, Params* p) {
  long long t = 0;
  const long long bb = g.v[G_BB];
  const int nm = static_cast<int>(g.v[G_NMIPS]);
  for (int m = 0; m < nm; ++m) {
    const long long* mp = &g.v[G_MIP + m * G_MIP_FIELDS];
    const long long w = mp[M_WIDTH], h = mp[M_HEIGHT], pitch = mp[M_PITCH];
    MipPlan& q = p->mp[m];
    q.tile0 = static_cast<int>(t);
    q.narrow = 1, q.per = 1, q.chunks = 1;
    if (w <= 0 || h <= 0) continue;
    const long long units = (h + 1) / 2;
    if (2 * pitch <= kTile) {
      q.per = static_cast<int>(kTile / (2 * pitch));
      t += (units + q.per - 1) / q.per;
    } else {
      q.narrow = 0;
      q.per = static_cast<int>(kTile / (4 * bb));
      const long long ncp = (w + 1) / 2;
      q.chunks = static_cast<int>((ncp + q.per - 1) / q.per);
      t += units * q.chunks;
    }
    if (t >= (1LL << 31)) return false;
  }
  p->mp[nm].tile0 = static_cast<int>(t);
  p->ntiles = static_cast<int>(t);
  const long long page = g.v[G_PAGE];
  p->page_shift = -1;
  for (int k = 0; k < 18; ++k)
    if (page == (1LL << k)) p->page_shift = k;
  return true;
}

__device__ void set_piece(Piece& pc, const Desc& d, int row, int rows,
                          int c0, int c1, bool pad, long long bb) {
  pc.row = row, pc.rows = rows, pc.c0 = c0, pc.c1 = c1;
  const long long start = d.bytes + static_cast<long long>(row) * d.pitch;
  pc.ga = start + c0 * bb;
  pc.gst = start + c1 * bb;
  pc.gld = pc.gst;
  pc.ge = pad ? start + d.pitch : pc.gst;
}

// The texture offset of conditioned block B's first byte (B in any mip).
__device__ long long cond_block_address(const Geom& g, long long B) {
  const int nm = static_cast<int>(g.v[G_NMIPS]);
  int m = 0;
  while (m + 1 < nm && g.v[G_MIP + (m + 1) * G_MIP_FIELDS + M_BLOCKS] <= B)
    ++m;
  const long long* mp = &g.v[G_MIP + m * G_MIP_FIELDS];
  // block indices fit 31 bits: 32-bit divisions
  const unsigned w = static_cast<unsigned>(mp[M_WIDTH]);
  const unsigned h = static_cast<unsigned>(mp[M_HEIGHT]);
  const unsigned b = static_cast<unsigned>(B - mp[M_BLOCKS]);
  unsigned row = b / w, col = b - row * w;
  if (g.v[G_SWIZZLE] && w >= 2 && h >= 2) {
    const unsigned rw = w & 1, ew = w - rw, eh = h - (h & 1);
    if (row < eh && col < ew) {
      const unsigned eff = b - row * rw, grp = eff >> 2, in = eff & 3;
      const unsigned grps = ew / 2, gr = grp / grps;
      row = 2 * gr + (in >> 1);
      col = 2 * (grp - gr * grps) + (in & 1);
    }
  }
  return mp[M_BYTES] + static_cast<long long>(row) * mp[M_PITCH] +
         static_cast<long long>(col) * g.v[G_BB];
}

// Tile t's descriptor but its colour segments' flags and bytes before
// (colour_pages fills those); one thread computes it.
__device__ void describe(const Params& P, int t, Desc& d) {
  const Geom& g = P.g;
  int m = 0;
  while (P.mp[m + 1].tile0 <= t) ++m;
  const long long* mp = &g.v[G_MIP + m * G_MIP_FIELDS];
  const long long bb = g.v[G_BB];
  d.tile = t;
  const int w = static_cast<int>(mp[M_WIDTH]);
  const int h = static_cast<int>(mp[M_HEIGHT]);
  d.w = w;
  d.pitch = mp[M_PITCH], d.bytes = mp[M_BYTES], d.mipblk = mp[M_BLOCKS];
  const bool swz = g.v[G_SWIZZLE] && w >= 2 && h >= 2;
  d.rem_w = w & 1;
  d.eff_w = w - d.rem_w;
  d.eff_h = swz ? h - (h & 1) : 0;
  d.zero = 0;
  const int u = t - P.mp[m].tile0, per = P.mp[m].per;
  long long l0, l1;                  // the tile's blocks in its mip
  if (P.mp[m].narrow) {
    const int r0 = 2 * u * per, r1 = min(r0 + 2 * per, h);
    l0 = static_cast<long long>(r0) * w, l1 = static_cast<long long>(r1) * w;
    d.np = 1;
    Piece& pc = d.pc[0];
    set_piece(pc, d, r0, r1 - r0, 0, w, true, bb);
    pc.gst = pc.ge = d.bytes + static_cast<long long>(r1) * d.pitch;
    pc.gld = d.bytes + static_cast<long long>(r1 - 1) * d.pitch + w * bb;
    d.zero = d.pitch > w * bb;       // its staged padding is zeroed
  } else {
    const int C = P.mp[m].chunks, p = u / C, i = u % C;
    const int r0 = 2 * p, nr = min(2, h - r0);
    const int ncp = (w + 1) / 2, j0 = i * per, j1 = min(j0 + per, ncp);
    const long long base = static_cast<long long>(r0) * w;
    d.np = 0;
    if (r0 + 1 < d.eff_h) {          // a swizzled pair
      const int ew = d.eff_w, rw = d.rem_w;
      auto cut = [&](long long e) { return e + (e >= ew ? rw : 0); };
      l0 = base + cut(4LL * j0);
      l1 = base + (j1 == ncp ? 2LL * w : cut(4LL * j1));
      if (2 * j0 < ew)
        set_piece(d.pc[d.np++], d, r0, 1, 2 * j0, min(2 * j1, ew), false, bb);
      set_piece(d.pc[d.np++], d, r0 + 1, 1, 2 * j0, min(2 * j1, w),
                j1 == ncp, bb);
      if (4 * j0 <= ew - 1 && ew - 1 < 4 * j1)
        set_piece(d.pc[d.np++], d, r0, 1, ew, w, true, bb);
    } else {                         // row-major: 4 per blocks a chunk
      const long long total = static_cast<long long>(nr) * w;
      const long long s = min(static_cast<long long>(i) * 4 * per, total);
      const long long e = min(s + 4LL * per, total);
      l0 = base + s, l1 = base + e;
      if (s < e) {
        const int rs = static_cast<int>(s / w);
        const long long end0 = static_cast<long long>(rs + 1) * w;
        set_piece(d.pc[d.np++], d, r0 + rs, 1, static_cast<int>(s - rs * w),
                  static_cast<int>(min(e, end0) - rs * static_cast<long long>(w)),
                  e >= end0, bb);
        if (e > end0)
          set_piece(d.pc[d.np++], d, r0 + rs + 1, 1, 0,
                    static_cast<int>(e - end0), e == end0 + w, bb);
      }
    }
  }
  d.b0 = d.mipblk + l0, d.b1 = d.mipblk + l1;
  const int ub = bb == 8 ? 2 : 1;      // blocks a unit (Fmt::kUB)
  int st = 0;
  d.staged = 0;
  for (int q = 0; q < d.np; ++q) {
    Piece& pc = d.pc[q];
    pc.st = st;
    pc.upr = (pc.c1 - pc.c0 + ub - 1) / ub;
    pc.units = pc.rows * pc.upr;
    const long long row_bytes = (pc.c1 - pc.c0) * bb;   // no padding in it
    pc.direct = (bb == 8 || bb == 16) && (pc.ga & 15) == 0 &&
                (row_bytes & 15) == 0 &&
                (pc.rows == 1 ? pc.ge - pc.ga == row_bytes
                              : d.pitch == row_bytes);
    d.staged |= !pc.direct;
    st += static_cast<int>(align_up((pc.ga & 15) + (pc.gst - pc.ga))) + 16;
  }
  const int nsub = static_cast<int>(g.v[G_NSUB]);
  int reg = 0;
  for (int k = 0; k < nsub; ++k) {
    const long long sz = g.v[G_SUB_SIZE + k];
    d.gs[k] = g.v[G_STREAM_OFF + k] + d.b0 * sz;
    d.len[k] = static_cast<int>((d.b1 - d.b0) * sz);
    d.reg[k] = reg;
    reg += 32 + static_cast<int>(align_up((d.gs[k] & 15) + d.len[k]));
  }
}

// The tile's colour segments' pages and flags (flags null: every page)
// and, with x, the conditioned byte before each (the preprocess's); a
// whole warp, after describe, the flags of 32 pages at a time.
__device__ void colour_pages(const Params& P, Desc& d, const uint8_t* flags,
                             const uint8_t* x) {
  const Geom& g = P.g;
  const int lane = threadIdx.x & 31;
  const long long page = g.v[G_PAGE];
  auto page_of = [&](long long a) {
    return P.page_shift >= 0 ? a >> P.page_shift : a / page;
  };
  const int nc = static_cast<int>(g.v[G_NCOLOR]);
  for (int c = 0; c < nc; ++c) {
    const int k = static_cast<int>(g.v[G_COLOR + c]);
    Colour& cl = d.col[c];
    const long long gs = d.gs[k], ge = gs + d.len[k];
    const long long pg0 = page_of(gs);
    const long long pages = ge > gs ? page_of(ge - 1) - pg0 + 1 : 0;
    unsigned fl = flags == nullptr ? ~0u : 0u;
    bool live = ge > gs && flags == nullptr;
    for (long long i = 0; flags != nullptr && i < pages; i += 32) {
      const unsigned f = __ballot_sync(
          kFull, i + lane < pages && flags[pg0 + i + lane] != 0);
      if (i == 0) fl = f;
      live |= f != 0;
    }
    const int before = x != nullptr && d.b0 > 0 && lane == c
                           ? x[cond_block_address(g, d.b0 - 1) +
                               g.v[G_SUB_OFF + k] + g.v[G_SUB_SIZE + k] - 1]
                           : 0;
    if (lane == 0) {
      cl.pg0 = pg0, cl.p0 = pg0 * page, cl.nb = cl.p0 + page;
      cl.many = flags != nullptr && pages > 32;
      cl.fl = fl, cl.live = live;
      cl.start = gs == g.v[G_STREAM_OFF + k] || gs == cl.p0;
      cl.carry = ge > gs && !cl.start && (fl & 1u);
    }
    if (lane == c) cl.before = before;
  }
}

// -- Moving bytes in shared memory ----------------------------------------

// N bytes at p (any alignment) as little-endian words; may read up to 4
// bytes past the end.
template <int N>
__device__ __forceinline__ void load_bytes(const uint8_t* p, unsigned* w) {
  constexpr int NW = (N + 3) / 4;
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if (N == 1) {
    w[0] = *p;
  } else if (N % 16 == 0 && (a & 15) == 0) {
#pragma unroll
    for (int i = 0; i < NW / 4; ++i) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[i];
      w[4 * i] = v.x, w[4 * i + 1] = v.y, w[4 * i + 2] = v.z,
      w[4 * i + 3] = v.w;
    }
  } else if ((a & 3) == 0) {
#pragma unroll
    for (int i = 0; i < NW; ++i) w[i] = reinterpret_cast<const unsigned*>(p)[i];
  } else {
    const unsigned* q = reinterpret_cast<const unsigned*>(a & ~uintptr_t(3));
    const unsigned sh = (a & 3) * 8;
    unsigned raw[NW + 1];
#pragma unroll
    for (int i = 0; i <= NW; ++i) raw[i] = q[i];
#pragma unroll
    for (int i = 0; i < NW; ++i) w[i] = __funnelshift_r(raw[i], raw[i + 1], sh);
  }
}

// N bytes of the words w to p (any alignment), the widest stores its
// alignment allows.
template <int N>
__device__ __forceinline__ void store_bytes(uint8_t* p, const unsigned* w) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if (N % 16 == 0 && (a & 15) == 0) {
#pragma unroll
    for (int i = 0; i < N / 16; ++i)
      reinterpret_cast<uint4*>(p)[i] =
          make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
  } else if (N % 8 == 0 && (a & 7) == 0) {
#pragma unroll
    for (int i = 0; i < N / 8; ++i)
      reinterpret_cast<uint2*>(p)[i] = make_uint2(w[2 * i], w[2 * i + 1]);
  } else if (N % 4 == 0 && (a & 3) == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) reinterpret_cast<unsigned*>(p)[i] = w[i];
  } else if (N % 2 == 0 && (a & 1) == 0) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i)
      reinterpret_cast<unsigned short*>(p)[i] =
          static_cast<unsigned short>(w[i >> 1] >> (16 * (i & 1)));
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i)
      p[i] = static_cast<uint8_t>(w[i >> 2] >> (8 * (i & 3)));
  }
}

// Byte o of `out` = byte i of `in` (o, i known at compile time).
__device__ __forceinline__ void put_byte(unsigned* out, int o,
                                         const unsigned* in, int i) {
  const unsigned p = o & 3;
  const unsigned sel = (0x3210u & ~(0xfu << (4 * p))) |
                       ((4u + (i & 3)) << (4 * p));
  out[o >> 2] = __byte_perm(out[o >> 2], in[i >> 2], sel);
}

// The UB blocks (tile-relative conditioned index rel, rel + 1, ...) as
// texture bytes: sub-stream K's run of UB * size(K) bytes from its
// segment, each byte to its place by a fixed permute.
template <class F, int UB, int K = 0>
__device__ __forceinline__ void gather(uint8_t* const* data, int rel,
                                       unsigned* out) {
  if constexpr (K < F::kNSub) {
    constexpr int S = F::size(K), N = UB * S;
    unsigned w[(N + 3) / 4];
    load_bytes<N>(data[K] + rel * S, w);
#pragma unroll
    for (int b = 0; b < UB; ++b)
#pragma unroll
      for (int j = 0; j < S; ++j)
        put_byte(out, b * F::kBB + F::off(K) + j, w, b * S + j);
    gather<F, UB, K + 1>(data, rel, out);
  }
}

// The mirror of gather: the UB blocks' texture bytes `in` into each
// sub-stream's segment.
template <class F, int UB, int K = 0>
__device__ __forceinline__ void scatter(uint8_t* const* data, int rel,
                                        const unsigned* in) {
  if constexpr (K < F::kNSub) {
    constexpr int S = F::size(K), N = UB * S;
    unsigned w[(N + 3) / 4];
#pragma unroll
    for (int i = 0; i < (N + 3) / 4; ++i) w[i] = 0;
#pragma unroll
    for (int b = 0; b < UB; ++b)
#pragma unroll
      for (int j = 0; j < S; ++j)
        put_byte(w, b * S + j, in, b * F::kBB + F::off(K) + j);
    store_bytes<N>(data[K] + rel * S, w);
    scatter<F, UB, K + 1>(data, rel, in);
  }
}

// Block (r, c) of a mip of width w as its index among the mip's
// conditioned blocks: the pair's groups, counted past row 2p's remainder
// block.
__device__ __forceinline__ long long mip_cond_of(int w, int eff_w, int eff_h,
                                                 int rem_w, int r, int c) {
  if (r < eff_h && c < eff_w) {
    int e = 4 * (c >> 1) + 2 * (r & 1) + (c & 1);
    e += e >= eff_w ? rem_w : 0;
    return static_cast<long long>(r & ~1) * w + e;
  }
  return static_cast<long long>(r) * w + c;
}

// Every unit of the tile's pieces: kPost, the texture bytes assembled from
// the segments into the staging, or straight into out for a direct piece;
// else the staged texture split into the segments. A unit is UB blocks of
// one row that are adjacent in the conditioned order too, or one block.
// The descriptor's fields are read into registers first: the stores below
// go to shared memory too.
template <class F, bool kPost>
__device__ void move_units(const Desc& d, uint8_t* stage,
                           uint8_t* const* data, uint8_t* out) {
  constexpr int BB = F::kBB, UB = F::kUB;
  const int np = d.np, w = d.w, eff_w = d.eff_w, eff_h = d.eff_h;
  const int rem_w = d.rem_w;
  const long long first = d.b0 - d.mipblk, bytes = d.bytes, pitch = d.pitch;
  for (int q = 0; q < np; ++q) {
    const Piece pc = d.pc[q];
    const long long base = align_down(pc.ga);
    const bool direct = kPost && pc.direct;
#pragma unroll 2
    for (int u = threadIdx.x; u < pc.units; u += kThreads) {
      const int rr = pc.rows == 1   ? 0
                     : pc.rows == 2 ? (u >= pc.upr)
                                    : u / pc.upr;
      const int r = pc.row + rr, c = pc.c0 + (u - rr * pc.upr) * UB;
      const long long tex = bytes + static_cast<long long>(r) * pitch +
                            static_cast<long long>(c) * BB;
      uint8_t* sp = direct ? out + tex
                           : stage + pc.st + static_cast<int>(tex - base);
      const int rel = static_cast<int>(
          mip_cond_of(w, eff_w, eff_h, rem_w, r, c) - first);
      if (UB == 2 && c + 1 < pc.c1) {
        unsigned v[4] = {0, 0, 0, 0};
        if (kPost) {
          gather<F, UB>(data, rel, v);
          store_bytes<16>(sp, v);
        } else {
          load_bytes<16>(sp, v);
          scatter<F, UB>(data, rel, v);
        }
      } else {
        unsigned v[(BB + 3) / 4] = {};
        if (kPost) {
          gather<F, 1>(data, rel, v);
          store_bytes<BB>(sp, v);
        } else {
          load_bytes<BB>(sp, v);
          scatter<F, 1>(data, rel, v);
        }
      }
    }
  }
}

// -- The delta scan -------------------------------------------------------

__device__ __forceinline__ unsigned byte_of(const uint4& v, int j) {
  const unsigned w = j < 4 ? v.x : j < 8 ? v.y : j < 12 ? v.z : v.w;
  return (w >> (8 * (j & 3))) & 0xffu;
}

__device__ __forceinline__ void set_byte(uint4& v, int j, unsigned b) {
  unsigned* w = j < 4 ? &v.x : j < 8 ? &v.y : j < 12 ? &v.z : &v.w;
  const int sh = 8 * (j & 3);
  *w = (*w & ~(0xffu << sh)) | (b << sh);
}

// Bit j of `bits` spread to byte j of each word, times 0xff.
__device__ __forceinline__ uint4 byte_mask(unsigned bits) {
  unsigned w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    w[k] = ((((bits >> (4 * k)) & 0xfu) * 0x00204081u) & 0x01010101u) * 0xffu;
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ uint4 and4(const uint4& a, const uint4& b) {
  return make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
}

// Inclusive byte-wise prefix sums modulo 256 of 16 bytes, c added to
// each: output byte j is the low byte of a __dp4a over the bytes up to j
// (the SIMD byte adds are not native on this card).
__device__ __forceinline__ uint4 byte_prefix(const uint4& v, unsigned c = 0) {
  constexpr unsigned ones = 0x01010101u;
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
  unsigned out[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const unsigned p0 = __dp4a(w[k] & 0xffu, ones, c);
    const unsigned p1 = __dp4a(w[k] & 0xffffu, ones, c);
    const unsigned p2 = __dp4a(w[k] & 0xffffffu, ones, c);
    const unsigned p3 = __dp4a(w[k], ones, c);
    out[k] = __byte_perm(__byte_perm(p0, p1, 0x0040),
                         __byte_perm(p2, p3, 0x0040), 0x5410);
    c = p3;
  }
  return make_uint4(out[0], out[1], out[2], out[3]);
}

// Byte-wise a - b modulo 256 of four bytes.
__device__ __forceinline__ unsigned sub_bytes(unsigned a, unsigned b) {
  return ((a | 0x80808080u) - (b & 0x7f7f7f7fu)) ^ ((a ^ ~b) & 0x80808080u);
}

// A scan element: bit 8 set if a span start was seen, bits 0-7 the sum
// modulo 256 since the last start (or since the first byte). `a` comes
// before `b`; 0 is the identity.
__device__ __forceinline__ unsigned combine(unsigned a, unsigned b) {
  return (b & kStart) ? b : ((a & kStart) | ((a + b) & 0xffu));
}

// 16 bytes' element from their prefix P and start bits.
__device__ __forceinline__ unsigned element_sum(const uint4& P, unsigned st) {
  const unsigned total = P.w >> 24;
  if (!st) return total;
  const int j0 = 31 - __clz(st);
  const unsigned before = j0 ? byte_of(P, j0 - 1) : 0u;
  return kStart | ((total - before) & 0xffu);
}

// A colour segment of the tile: [gs, ge) of the stream, its sub-stream's
// first byte s0, its first chunk's first byte base, and its pages.
struct Seg {
  long long gs, ge, s0, base;
  Colour cl;
};

// Colour c's segment of the tile.
__device__ __forceinline__ Seg colour_seg(const Geom& g, const Desc& d,
                                          int c) {
  const int k = static_cast<int>(g.v[G_COLOR + c]);
  Seg s;
  s.gs = d.gs[k], s.ge = d.gs[k] + d.len[k], s.s0 = g.v[G_STREAM_OFF + k];
  s.base = align_down(s.gs);
  s.cl = d.col[c];
  return s;
}

// 16-byte chunk e of the segment (from its 16-byte aligned start): bit j
// of `in` if byte j lies in the segment, of `st` if a span starts there,
// of `fl` if its page is flagged (flags: the kernel's, null for every
// page).
__device__ __forceinline__ void chunk_masks(const Seg& s, int e, int page,
                                            const uint8_t* flags,
                                            unsigned& in, unsigned& st,
                                            unsigned& fl) {
  const long long a = s.base + 16LL * e;
  const int lo = static_cast<int>(max(s.gs - a, 0LL));
  const int hi = static_cast<int>(min(s.ge - a, 16LL));
  in = hi > lo ? ((1u << hi) - 1u) & ~((1u << lo) - 1u) : 0u;
  // the chunk's page (relative to the segment's first) and the byte where
  // the next one starts (16: none)
  unsigned pg = 0;
  int bnd = a == s.cl.p0 ? 0 : 16;
  if (a + 16 > s.cl.nb) {
    const unsigned off = static_cast<unsigned>(a - s.cl.p0);
    pg = off / static_cast<unsigned>(page);
    const unsigned r = off - pg * static_cast<unsigned>(page);
    bnd = r ? page - static_cast<int>(r) : 0;
  }
  st = 0;
  if (bnd < 16) st |= 1u << bnd;
  if (s.s0 >= a && s.s0 < a + 16) st |= 1u << static_cast<int>(s.s0 - a);
  st &= in;
  if (flags == nullptr) {
    fl = 0xffffu;
    return;
  }
  // the chunk's page pg and, past bnd, the next one
  auto flagged = [&](unsigned q) {
    return s.cl.many ? __ldg(flags + s.cl.pg0 + q) != 0
                     : q < 32 && ((s.cl.fl >> q) & 1u);
  };
  const unsigned before = bnd < 16 && bnd > 0 ? (1u << bnd) - 1u : 0xffffu;
  fl = (in & before) && flagged(pg) ? before : 0u;
  if (bnd > 0 && bnd < 16 && (in >> bnd) && flagged(pg + 1))
    fl |= ~before & 0xffffu;
}

// Chunk e's element (bytes outside the segment count 0).
__device__ __forceinline__ unsigned chunk_element(const uint4& x,
                                                  unsigned in, unsigned st) {
  if (in == 0xffffu && !st) {
    const unsigned ones = 0x01010101u;
    return __dp4a(x.x, ones, __dp4a(x.y, ones, __dp4a(x.z, ones,
                                                      __dp4a(x.w, ones, 0u)))) &
           0xffu;
  }
  return element_sum(byte_prefix(and4(x, byte_mask(in))), st);
}

// The segment's colour index c, tile t: the look-back over the
// predecessors' words, 32 at a time, back to the first inclusive one;
// returns the carry (the element of every byte before the tile's segment
// since its span's start). Called by a whole warp.
__device__ unsigned look_back(const unsigned* status, int t, int c, int nc) {
  const int lane = threadIdx.x & 31;
  unsigned carry = 0;
  for (int top = t - 1;; top -= 32) {
    const int j = top - lane;
    unsigned s = 0;
    bool stop;
    for (;;) {
      s = j >= 0 ? load_relaxed(status + static_cast<long long>(j) * nc + c)
                 : (kInclusive | kStart);
      const unsigned incl = __ballot_sync(kFull, s & kInclusive);
      const unsigned ready = __ballot_sync(kFull, s != 0);
      const int first = incl ? __ffs(incl) - 1 : 31;
      const unsigned need = first == 31 ? kFull : (2u << first) - 1u;
      stop = incl != 0;
      if ((ready & need) == need) {
        if (lane > first) s = 0;    // past the first inclusive word
        break;
      }
    }
    // lane l holds tile top - l: combine from the highest lane down
    unsigned v = s & kElement;
#pragma unroll
    for (int dd = 1; dd < 32; dd <<= 1) {
      const unsigned o = __shfl_down_sync(kFull, v, dd);
      if (lane + dd < 32) v = combine(o, v);
    }
    carry = combine(__shfl_sync(kFull, v, 0), carry);
    if (stop) return carry;
  }
}


// Each consumer warp's share of a segment's nel chunks: [32 w per, 32 (w
// + 1) per), per = ceil(nel / kThreads) a thread.
__device__ __forceinline__ int chunks_per_thread(int nel) {
  return (nel + kThreads - 1) / kThreads;
}

// Colour c's elements over its segment in the slot (one warp, the
// producer's, once the tile's loads have landed): each consumer warp's
// share reduced in order, the prefixes before each share into the
// descriptor, the aggregate published as the tile's word and returned.
__device__ unsigned colour_aggregate(const Geom& g, Desc& d,
                                     const uint8_t* slot, unsigned* status,
                                     int c) {
  const int nc = static_cast<int>(g.v[G_NCOLOR]);
  const int page = static_cast<int>(g.v[G_PAGE]);
  const int lane = threadIdx.x & 31;
  const Seg s = colour_seg(g, d, c);
  unsigned* word = status + static_cast<long long>(d.tile) * nc + c;
  if (s.ge == s.gs) {
    // an empty segment passes the carry through
    if (lane == 0) store_relaxed(word, kAggregate);
    return 0;
  }
  if (!s.cl.live) {
    // no flagged page meets the segment: the carry is read only by bytes of
    // its successors in the page it ends in, which are not decoded, so it
    // stops their look-backs
    if (lane == 0) store_relaxed(word, kInclusive | kStart);
    return kStart;
  }
  const uint4* x4 = reinterpret_cast<const uint4*>(
      slot + d.reg[g.v[G_COLOR + c]] + 16);
  const int nel = static_cast<int>((align_up(s.ge) - s.base) >> 4);
  // lane l takes kWarps shares of a consumer thread, so that consumer warp
  // w's chunks start at lane 32 w / kWarps's
  const int per = chunks_per_thread(nel) * kWarps;
  const int e0 = min(nel, lane * per), e1 = min(nel, e0 + per);
  unsigned v = 0;
  for (int e = e0; e < e1; ++e) {
    unsigned in, st, fl;
    chunk_masks(s, e, page, nullptr, in, st, fl);
    v = combine(v, chunk_element(x4[e], in, st));
  }
#pragma unroll
  for (int dd = 1; dd < 32; dd <<= 1) {
    const unsigned o = __shfl_up_sync(kFull, v, dd);
    if (lane >= dd) v = combine(o, v);
  }
  const unsigned agg = __shfl_sync(kFull, v, 31);
  unsigned pre = __shfl_up_sync(kFull, v, 1);
  if (lane == 0) pre = 0;
  if (lane % (32 / kWarps) == 0) d.wpre[c][lane / (32 / kWarps)] = pre;
  if (lane == 0)
    store_relaxed(word, ((agg & kStart) ? kInclusive : kAggregate) | agg);
  return agg;
}

// Colour c's carry by the look-back (its aggregate agg published), the
// inclusive word published and the carry put into the consumer warps'
// prefixes. Returns the cycles spent waiting on the look-back.
__device__ long long colour_carry(const Geom& g, Desc& d, unsigned* status,
                                  int c, unsigned agg) {
  const int nc = static_cast<int>(g.v[G_NCOLOR]);
  const int lane = threadIdx.x & 31;
  const Colour& cl = d.col[c];
  if (!cl.live || !cl.carry) return 0;
  const long long t0 = clock64();
  const unsigned carry = look_back(status, d.tile, c, nc);
  const long long waited = clock64() - t0;
  if (lane == 0 && !(agg & kStart))
    store_relaxed(status + static_cast<long long>(d.tile) * nc + c,
                  kInclusive | combine(carry, agg));
  if (lane < kWarps) d.wpre[c][lane] = combine(carry, d.wpre[c][lane]);
  return waited;
}

// The tile's colour segments in the slot, delta decoded in place where
// their pages are flagged, each consumer warp from its prefix in the
// descriptor (consumer threads only; ends with them synchronised).
__device__ void decode_colours(const Geom& g, const Desc& d, uint8_t* slot,
                               const uint8_t* flags) {
  const int nc = static_cast<int>(g.v[G_NCOLOR]);
  const int page = static_cast<int>(g.v[G_PAGE]);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < kMaxColors; ++c) {
    if (c >= nc || !d.col[c].live) continue;
    const Seg s = colour_seg(g, d, c);
    uint4* x4 = reinterpret_cast<uint4*>(slot + d.reg[g.v[G_COLOR + c]] + 16);
    const int nel = static_cast<int>((align_up(s.ge) - s.base) >> 4);
    const int per = chunks_per_thread(nel);
    const int e0 = min(nel, static_cast<int>(threadIdx.x) * per);
    const int e1 = min(nel, e0 + per);
    unsigned v = 0;
    for (int e = e0; e < e1; ++e) {
      unsigned in, st, fl;
      chunk_masks(s, e, page, nullptr, in, st, fl);
      v = combine(v, chunk_element(x4[e], in, st));
    }
#pragma unroll
    for (int dd = 1; dd < 32; dd <<= 1) {
      const unsigned o = __shfl_up_sync(kFull, v, dd);
      if (lane >= dd) v = combine(o, v);
    }
    unsigned pre = __shfl_up_sync(kFull, v, 1);
    if (lane == 0) pre = 0;
    unsigned run = combine(d.wpre[c][warp], pre);
    for (int e = e0; e < e1; ++e) {
      unsigned in, st, fl;
      chunk_masks(s, e, page, flags, in, st, fl);
      uint4 x = x4[e];
      const unsigned el = chunk_element(x, in, st);
      const unsigned use = in & fl;
      if (use) {
        if (use == 0xffffu && !st) {
          x = byte_prefix(x, run & 0xffu);
        } else {
          unsigned acc = run & 0xffu;
          for (int j = 0; j < 16; ++j) {
            if (!((in >> j) & 1u)) continue;
            if ((st >> j) & 1u) acc = 0;
            acc = (acc + byte_of(x, j)) & 0xffu;
            if ((use >> j) & 1u) set_byte(x, j, acc);
          }
        }
        x4[e] = x;
      }
      run = combine(run, el);
    }
  }
  consumer_sync();
}

// -- Stores ---------------------------------------------------------------

// The postprocess's staged pieces from the staging to out: whole 16-byte
// chunks by vector stores, the pieces' first and last chunks byte by byte;
// bytes past the staged part (the padding of a wide piece) are 0.
__device__ void store_pieces(const Desc& d, const uint8_t* stage,
                             uint8_t* out) {
  const int np = d.np;
  for (int q = 0; q < np; ++q) {
    const Piece pc = d.pc[q];
    if (pc.direct) continue;
    const long long base = align_down(pc.ga);
    const int count = static_cast<int>((align_up(pc.ge) - base) >> 4);
#pragma unroll 2
    for (int e = threadIdx.x; e < count; e += kThreads) {
      const long long a = base + 16LL * e;
      const uint8_t* sp = stage + pc.st + 16 * e;
      if (a >= pc.ga && a + 16 <= pc.gst) {
        *reinterpret_cast<uint4*>(out + a) =
            *reinterpret_cast<const uint4*>(sp);
      } else if (a >= pc.gst && a + 16 <= pc.ge) {
        *reinterpret_cast<uint4*>(out + a) = make_uint4(0, 0, 0, 0);
      } else {
        for (int j = 0; j < 16; ++j) {
          const long long p = a + j;
          if (p >= pc.ga && p < pc.ge) out[p] = p < pc.gst ? sp[j] : 0;
        }
      }
    }
  }
}

// The preprocess's segments from shared memory to cond and delta (delta
// null: cond only).
__device__ void store_segments(const Geom& g, const Desc& d,
                               const uint8_t* area, const uint8_t* flags,
                               uint8_t* cond, uint8_t* delta) {
  const int nsub = static_cast<int>(g.v[G_NSUB]);
  const int nc = static_cast<int>(g.v[G_NCOLOR]);
  const int page = static_cast<int>(g.v[G_PAGE]);
  int count[kMaxSubs], total = 0;
#pragma unroll
  for (int k = 0; k < kMaxSubs; ++k) {
    count[k] = k < nsub && d.len[k] > 0
                   ? static_cast<int>((align_up(d.gs[k] + d.len[k]) -
                                       align_down(d.gs[k])) >> 4)
                   : 0;
    total += count[k];
  }
  for (int u = threadIdx.x; u < total; u += kThreads) {
    int k = 0, e = u;
    while (e >= count[k]) e -= count[k++];
    int c = 0;
    while (c < nc && g.v[G_COLOR + c] != k) ++c;
    const uint8_t* sp = area + d.reg[k] + 16 + 16 * e;
    const uint4 x = *reinterpret_cast<const uint4*>(sp);
    const long long a = align_down(d.gs[k]) + 16LL * e;
    const int lo = static_cast<int>(max(d.gs[k] - a, 0LL));
    const int hi = static_cast<int>(min(d.gs[k] + d.len[k] - a, 16LL));
    unsigned in = ((1u << hi) - 1u) & ~((1u << lo) - 1u);
    uint4 dx = x;
    if (c < nc && delta != nullptr) {
      const Seg s = colour_seg(g, d, c);
      unsigned st, fl;
      chunk_masks(s, e, page, flags, in, st, fl);
      const unsigned use = in & fl & ~st;      // bytes that become differences
      if (use) {
        // the byte before the chunk (the kernel put the byte before the
        // segment in front of it)
        const unsigned before = sp[-1];
        const uint4 prev = make_uint4(
            (x.x << 8) | before, __funnelshift_l(x.x, x.y, 8),
            __funnelshift_l(x.y, x.z, 8), __funnelshift_l(x.z, x.w, 8));
        const uint4 df =
            make_uint4(sub_bytes(x.x, prev.x), sub_bytes(x.y, prev.y),
                       sub_bytes(x.z, prev.z), sub_bytes(x.w, prev.w));
        const uint4 m = byte_mask(use);
        dx = make_uint4((df.x & m.x) | (x.x & ~m.x), (df.y & m.y) | (x.y & ~m.y),
                        (df.z & m.z) | (x.z & ~m.z), (df.w & m.w) | (x.w & ~m.w));
      }
    }
    if (in == 0xffffu) {
      *reinterpret_cast<uint4*>(cond + a) = x;
      if (delta) *reinterpret_cast<uint4*>(delta + a) = dx;
    } else {
      for (int j = lo; j < hi; ++j) {
        cond[a + j] = static_cast<uint8_t>(byte_of(x, j));
        if (delta) delta[a + j] = static_cast<uint8_t>(byte_of(dx, j));
      }
    }
  }
}

// [lo, hi) of p zeroed by the grid.
__device__ void zero_range(uint8_t* p, long long lo, long long hi) {
  if (p == nullptr || lo >= hi) return;
  const long long a0 = align_down(lo), nch = (align_up(hi) - a0) >> 4;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       e < nch; e += stride) {
    const long long a = a0 + 16 * e;
    if (a >= lo && a + 16 <= hi) {
      *reinterpret_cast<uint4*>(p + a) = make_uint4(0, 0, 0, 0);
    } else {
      for (long long b = max(a, lo); b < min(a + 16, hi); ++b) p[b] = 0;
    }
  }
}

__device__ __forceinline__ void zero_shared(uint8_t* p, int bytes) {
  for (int i = threadIdx.x; i < bytes / 16; i += kThreads)
    reinterpret_cast<uint4*>(p)[i] = make_uint4(0, 0, 0, 0);
}

// The segments' data pointers of a tile in a slot.
__device__ __forceinline__ void segment_pointers(const Geom& g, const Desc& d,
                                                 uint8_t* slot,
                                                 uint8_t** data) {
  const int nsub = static_cast<int>(g.v[G_NSUB]);
#pragma unroll
  for (int k = 0; k < kMaxSubs; ++k)
    data[k] = k < nsub ? slot + d.reg[k] + 16 + static_cast<int>(d.gs[k] & 15)
                       : slot;
}

// -- The kernels ----------------------------------------------------------
//
// A CTA is kThreads consumer threads and one producer warp. The producer's
// lane 0 claims the tiles, describes each into a ring slot once the
// consumers have released it (the slot's `empty` barrier) and starts its
// bulk copies (its `full` barrier); the consumers wait on `full`, work the
// tile with named barrier 1 between their phases, and release the slot.

struct Shared {
  Desc desc[kRing];
  // full: a slot's bulk copies landed; ready: its descriptor is complete
  // (the postprocess's: and its carries found); empty: the consumers are
  // done with it
  unsigned long long full[kRing], ready[kRing], empty[kRing];
  long long lookback;             // the producer's look-back cycles
  int last;
};

// Lane 0 of the producer: claim the tile of round i, once slot s is free,
// describe it and start its copies (d.tile -1: no tile is left).
template <bool kPost>
__device__ void issue_tile(const Params& P, Shared& sh, int s, int i,
                           uint8_t* buf, const uint8_t* x,
                           const uint8_t* flags, unsigned* work) {
  const int nsub = static_cast<int>(P.g.v[G_NSUB]);
  if (i >= kRing) bar_wait(&sh.empty[s], ((i / kRing) - 1) & 1);
  {
    // the postprocess takes every tile from the counter, so that a tile
    // is claimed only by a running CTA and a look-back never waits on a
    // CTA that has not started (even with other kernels on the card)
    const int t = kPost ? static_cast<int>(atomicAdd(work, 1u))
                        : static_cast<int>(blockIdx.x + i * gridDim.x);
    Desc& d = sh.desc[s];
    if (t >= P.ntiles) {
      d.tile = -1;
      return;
    }
    describe(P, t, d);
    fence_async_shared();
    unsigned total = 0;
    if (kPost) {
      for (int k = 0; k < nsub; ++k)
        if (d.len[k] > 0)
          total += static_cast<unsigned>(align_up(d.gs[k] + d.len[k]) -
                                         align_down(d.gs[k]));
      bar_expect(&sh.full[s], total);
      for (int k = 0; k < nsub; ++k) {
        if (d.len[k] <= 0) continue;
        const long long a = align_down(d.gs[k]);
        bulk_load(buf + d.reg[k] + 16, x + a,
                  static_cast<unsigned>(align_up(d.gs[k] + d.len[k]) - a),
                  &sh.full[s]);
      }
    } else {
      for (int q = 0; q < d.np; ++q)
        if (d.pc[q].gld > d.pc[q].ga)
          total += static_cast<unsigned>(align_up(d.pc[q].gld) -
                                         align_down(d.pc[q].ga));
      bar_expect(&sh.full[s], total);
      for (int q = 0; q < d.np; ++q) {
        const Piece& pc = d.pc[q];
        if (pc.gld <= pc.ga) continue;
        const long long a = align_down(pc.ga);
        bulk_load(buf + pc.st, x + a,
                  static_cast<unsigned>(align_up(pc.gld) - a), &sh.full[s]);
      }
    }
  }
}

// The producer warp: tiles from the counter work[0] (the postprocess,
// kPost) or by the grid's stride (the preprocess), the postprocess's
// sub-stream segments or the preprocess's texture pieces loaded into ring
// slots of slot_bytes; for the postprocess, once they land, each colour's
// aggregate published and its carry found by the look-back. Lane 0 claims,
// describes and starts the copies.
template <bool kPost>
__device__ void produce(const Params& P, Shared& sh, uint8_t* ring,
                        int slot_bytes, const uint8_t* x,
                        const uint8_t* flags, unsigned* work) {
  const int lane = threadIdx.x & 31;
  const int nc = static_cast<int>(P.g.v[G_NCOLOR]);
  long long waited = 0;
  for (int i = 0;; ++i) {
    const int s = i % kRing;
    Desc& d = sh.desc[s];
    if (lane == 0) issue_tile<kPost>(P, sh, s, i, ring + s * slot_bytes, x,
                                     flags, work);
    __syncwarp();
    if (d.tile < 0) {
      if (lane == 0) bar_arrive(&sh.ready[s]);
      break;
    }
    colour_pages(P, d, flags, kPost ? nullptr : x);
    __syncwarp();
    if (!kPost) {
      if (lane == 0) bar_arrive(&sh.ready[s]);
    } else {
      bar_wait(&sh.full[s], (i / kRing) & 1);
      // every colour's aggregate first, then their look-backs
      unsigned agg[kMaxColors];
#pragma unroll
      for (int c = 0; c < kMaxColors; ++c)
        agg[c] = c < nc ? colour_aggregate(P.g, d, ring + s * slot_bytes,
                                           work + 2, c)
                        : 0;
#pragma unroll
      for (int c = 0; c < kMaxColors; ++c)
        if (c < nc) waited += colour_carry(P.g, d, work + 2, c, agg[c]);
      __syncwarp();
      if (lane == 0) bar_arrive(&sh.ready[s]);
    }
  }
  if (lane == 0) sh.lookback = waited;
}

__device__ __forceinline__ void init_barriers(Shared& sh) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kRing; ++s) {
      bar_init(&sh.full[s]);
      bar_init(&sh.ready[s]);
      bar_init(&sh.empty[s]);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

template <class F>
__global__ void __launch_bounds__(kThreads + 32)
postprocess_kernel(const __grid_constant__ Params P, const uint8_t* x,
                   const uint8_t* flags, uint8_t* out, unsigned* work,
                   long long* rec) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ Shared sh;
  uint8_t* stage = smem + kRing * kSlotBytes;
  const Geom& g = P.g;
  unsigned* status = work + 2;
  const long long t_begin = clock64();
  init_barriers(sh);
  if (threadIdx.x >= kThreads) {
    produce<true>(P, sh, smem, kSlotBytes, x, flags, work);
  } else {
    long long cyc[kRecWords] = {0, 0, 0, 0, 0, 0, 0};
    for (int i = 0;; ++i) {
      const int s = i % kRing;
      long long t0 = clock64();
      bar_wait(&sh.ready[s], (i / kRing) & 1);
      consumer_sync();
      long long t1 = clock64();
      cyc[R_LOAD] += t1 - t0;
      const Desc& d = sh.desc[s];
      if (d.tile < 0) break;
      uint8_t* slot = smem + s * kSlotBytes;
      if (d.zero)
        zero_shared(stage, static_cast<int>(align_up(
                               (d.pc[0].ga & 15) + (d.pc[0].gst - d.pc[0].ga))));
      if (g.v[G_NCOLOR])
        decode_colours(g, d, slot, flags);
      else
        consumer_sync();
      t0 = clock64();
      cyc[R_SCAN] += t0 - t1;
      uint8_t* data[kMaxSubs];
      segment_pointers(g, d, slot, data);
      move_units<F, true>(d, stage, data, out);
      const int staged = d.staged;
      consumer_sync();
      t1 = clock64();
      cyc[R_MOVE] += t1 - t0;
      t0 = t1;
      if (staged) store_pieces(d, stage, out);
      consumer_sync();
      if (threadIdx.x == 0) bar_arrive(&sh.empty[s]);
      cyc[R_STORE] += clock64() - t0;
      cyc[R_TILES] += 1;
    }
    if (rec != nullptr && threadIdx.x == 0) {
      cyc[R_TOTAL] = clock64() - t_begin;
      for (int k = 0; k < kRecWords; ++k)
        if (k != R_LOOKBACK) rec[blockIdx.x * kRecWords + k] = cyc[k];
    }
  }
  // the last CTA to finish clears the look-back's words for the next launch
  __syncthreads();
  if (rec != nullptr && threadIdx.x == 0)
    rec[blockIdx.x * kRecWords + R_LOOKBACK] = sh.lookback;
  if (threadIdx.x == 0) {
    __threadfence();
    sh.last = atomicAdd(work + 1, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (sh.last) {
    __threadfence();
    const long long words =
        static_cast<long long>(P.ntiles) * g.v[G_NCOLOR];
    for (long long k = threadIdx.x; k < words; k += blockDim.x) status[k] = 0;
    if (threadIdx.x == 0) work[0] = 0, work[1] = 0;
  }
}

template <class F>
__global__ void __launch_bounds__(kThreads + 32)
preprocess_kernel(const __grid_constant__ Params P, const uint8_t* x,
                  const uint8_t* flags, uint8_t* cond, uint8_t* delta,
                  long long* rec) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ Shared sh;
  uint8_t* area = smem + kRing * kStageBytes;
  const Geom& g = P.g;
  const long long t_begin = clock64();
  init_barriers(sh);
  if (threadIdx.x >= kThreads) {
    produce<false>(P, sh, smem, kStageBytes, x, flags, nullptr);
  } else {
    long long cyc[kRecWords] = {0, 0, 0, 0, 0, 0, 0};
    const int nc = static_cast<int>(g.v[G_NCOLOR]);
    for (int i = 0;; ++i) {
      const int s = i % kRing;
      long long t0 = clock64();
      bar_wait(&sh.ready[s], (i / kRing) & 1);
      const Desc& d = sh.desc[s];
      if (d.tile < 0) break;
      bar_wait(&sh.full[s], (i / kRing) & 1);
      long long t1 = clock64();
      cyc[R_LOAD] += t1 - t0;
      uint8_t* data[kMaxSubs];
      segment_pointers(g, d, area, data);
      move_units<F, false>(d, smem + s * kStageBytes, data, nullptr);
      // the byte before each colour segment, in front of it
      if (static_cast<int>(threadIdx.x) < nc)
        data[g.v[G_COLOR + threadIdx.x]][-1] =
            static_cast<uint8_t>(d.col[threadIdx.x].before);
      consumer_sync();
      t0 = clock64();
      cyc[R_MOVE] += t0 - t1;
      store_segments(g, d, area, flags, cond, delta);
      consumer_sync();
      if (threadIdx.x == 0) bar_arrive(&sh.empty[s]);
      cyc[R_STORE] += clock64() - t0;
      cyc[R_TILES] += 1;
    }
    // the conditioned tail past the sub-streams is 0
    zero_range(cond, g.v[G_M], g.v[G_N]);
    zero_range(delta, g.v[G_M], g.v[G_N]);
    if (rec != nullptr && threadIdx.x == 0) {
      cyc[R_TOTAL] = clock64() - t_begin;
      for (int k = 0; k < kRecWords; ++k)
        rec[blockIdx.x * kRecWords + k] = cyc[k];
    }
  }
}

// -- Host side ------------------------------------------------------------

bool load_params(const long long* rec, Params* p) {
  for (int k = 0; k < G_LEN; ++k) p->g.v[k] = rec[k];
  const Geom& g = p->g;
  const long long page = g.v[G_PAGE];
  if (!(page > 0 && page % 128 == 0 && page <= (1 << 17) &&
        g.v[G_NMIPS] >= 1 && g.v[G_NMIPS] <= G_MAX_MIPS &&
        g.v[G_NSUB] >= 1 && g.v[G_NSUB] <= kMaxSubs &&
        g.v[G_NCOLOR] >= 0 && g.v[G_NCOLOR] <= kMaxColors))
    return false;
  return make_plan(g, p);
}

// The format's instantiation: 0-5 as FmtBC1..FmtRaw, -1 for none.
template <class F>
bool is_format(const Geom& g) {
  if (g.v[G_BB] != F::kBB || g.v[G_NSUB] != F::kNSub) return false;
  for (int k = 0; k < F::kNSub; ++k)
    if (g.v[G_SUB_SIZE + k] != F::size(k) || g.v[G_SUB_OFF + k] != F::off(k))
      return false;
  return true;
}

int format_of(const Geom& g) {
  if (is_format<FmtBC1>(g)) return 0;
  if (is_format<FmtBC2>(g)) return 1;
  if (is_format<FmtBC3>(g)) return 2;
  if (is_format<FmtBC4>(g)) return 3;
  if (is_format<FmtBC5>(g)) return 4;
  if (is_format<FmtRaw>(g)) return 5;
  return -1;
}

constexpr int kSmem = kRing * kSlotBytes + kStageBytes;

// The grid of a launch: the CTAs that fit the SMs at once (at most
// kCtasPerSM an SM), no more than the tiles.
// (The CTAs an SM are found, and the kernel's shared memory set, once a
// kernel and device.)
template <class F, bool kPost>
int grid_of(int ntiles) {
  const void* kernel =
      kPost ? reinterpret_cast<const void*>(postprocess_kernel<F>)
            : reinterpret_cast<const void*>(preprocess_kernel<F>);
  constexpr int kDevices = 64;
  static int ctas[kDevices];      // 0: not found yet
  int dev = 0, sms = 1, occ = 1;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    dev = 0, sms = 1;
  int* slot = dev < kDevices ? &ctas[dev] : nullptr;
  if (slot == nullptr || *slot == 0) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kSmem);
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &occ, kernel, kThreads + 32, kSmem) != cudaSuccess || occ < 1)
      occ = 1;
    occ = min(occ, kCtasPerSM);
    if (slot != nullptr) *slot = occ;
  } else {
    occ = *slot;
  }
  const long long grid = static_cast<long long>(sms) * occ;
  return static_cast<int>(max(1LL, min(grid, static_cast<long long>(ntiles))));
}

template <class F>
int post_launch(const Params& p, const void* x, const void* flags, void* out,
                void* work, void* rec, cudaStream_t stream, bool run) {
  const int grid = grid_of<F, true>(p.ntiles);
  if (!run) return grid;
  postprocess_kernel<F><<<grid, kThreads + 32, kSmem, stream>>>(
      p, static_cast<const uint8_t*>(x), static_cast<const uint8_t*>(flags),
      static_cast<uint8_t*>(out), static_cast<unsigned*>(work),
      static_cast<long long*>(rec));
  return static_cast<int>(cudaGetLastError());
}

template <class F>
int pre_launch(const Params& p, const void* x, const void* flags, void* cond,
               void* delta, void* rec, cudaStream_t stream, bool run) {
  const int grid = grid_of<F, false>(p.ntiles);
  if (!run) return grid;
  preprocess_kernel<F><<<grid, kThreads + 32, kSmem, stream>>>(
      p, static_cast<const uint8_t*>(x), static_cast<const uint8_t*>(flags),
      static_cast<uint8_t*>(cond), static_cast<uint8_t*>(delta),
      static_cast<long long*>(rec));
  return static_cast<int>(cudaGetLastError());
}

int post_dispatch(const Params& p, const void* x, const void* flags, void* out,
                  void* work, void* rec, cudaStream_t st, bool run) {
  switch (format_of(p.g)) {
    case 0: return post_launch<FmtBC1>(p, x, flags, out, work, rec, st, run);
    case 1: return post_launch<FmtBC2>(p, x, flags, out, work, rec, st, run);
    case 2: return post_launch<FmtBC3>(p, x, flags, out, work, rec, st, run);
    case 3: return post_launch<FmtBC4>(p, x, flags, out, work, rec, st, run);
    case 4: return post_launch<FmtBC5>(p, x, flags, out, work, rec, st, run);
    case 5: return post_launch<FmtRaw>(p, x, flags, out, work, rec, st, run);
    default: return run ? static_cast<int>(cudaErrorInvalidValue) : -1;
  }
}

int pre_dispatch(const Params& p, const void* x, const void* flags, void* cond,
                 void* delta, void* rec, cudaStream_t st, bool run) {
  switch (format_of(p.g)) {
    case 0: return pre_launch<FmtBC1>(p, x, flags, cond, delta, rec, st, run);
    case 1: return pre_launch<FmtBC2>(p, x, flags, cond, delta, rec, st, run);
    case 2: return pre_launch<FmtBC3>(p, x, flags, cond, delta, rec, st, run);
    case 3: return pre_launch<FmtBC4>(p, x, flags, cond, delta, rec, st, run);
    case 4: return pre_launch<FmtBC5>(p, x, flags, cond, delta, rec, st, run);
    case 5: return pre_launch<FmtRaw>(p, x, flags, cond, delta, rec, st, run);
    default: return run ? static_cast<int>(cudaErrorInvalidValue) : -1;
  }
}

}  // namespace
}  // namespace blg_precond

// Delta decode (pages whose flag is set; flags null: every page) and
// decondition of the n-byte conditioned stream x into out (n bytes). geom
// is a host pointer to the record; work, int32 [2 + tiles x colours]
// zeroed (blg_precond_tiles), the look-back's words, left zeroed; rec,
// when not null, int64 [grid, 7] (blg_precond_grid).
extern "C" int blg_postprocess(const long long* geom, const void* x,
                               const void* flags, void* out, void* work,
                               void* rec, void* stream) {
  using namespace blg_precond;
  Params p;
  if (!load_params(geom, &p)) return static_cast<int>(cudaErrorInvalidValue);
  if (p.ntiles <= 0) return 0;
  return post_dispatch(p, x, flags, out, work, rec,
                       static_cast<cudaStream_t>(stream), true);
}

// Condition the n-byte texture x into cond and, where delta is not null,
// its delta encoding into delta (pages whose flag is set; flags null:
// every page). rec as for blg_postprocess.
extern "C" int blg_preprocess(const long long* geom, const void* x,
                              const void* flags, void* cond, void* delta,
                              void* rec, void* stream) {
  using namespace blg_precond;
  Params p;
  if (!load_params(geom, &p)) return static_cast<int>(cudaErrorInvalidValue);
  if (p.ntiles <= 0) return 0;
  return pre_dispatch(p, x, flags, cond, delta, rec,
                      static_cast<cudaStream_t>(stream), true);
}

// The tiles of a geometry (-1: a record the kernels refuse).
extern "C" long long blg_precond_tiles(const long long* geom) {
  using namespace blg_precond;
  Params p;
  if (!load_params(geom, &p) || format_of(p.g) < 0) return -1;
  return p.ntiles;
}

// The CTAs of a launch on the current device: post 1 for the
// postprocess, 0 for the preprocess (-1: a record the kernels refuse).
extern "C" int blg_precond_grid(const long long* geom, int post) {
  using namespace blg_precond;
  Params p;
  if (!load_params(geom, &p) || p.ntiles <= 0) return -1;
  return post ? post_dispatch(p, nullptr, nullptr, nullptr, nullptr, nullptr,
                              nullptr, false)
              : pre_dispatch(p, nullptr, nullptr, nullptr, nullptr, nullptr,
                             nullptr, false);
}

// The texture bytes of a tile, at most (ops/precondition_kernel.py
// TILE_BYTES).
extern "C" int blg_precond_tile_bytes() { return blg_precond::kTile; }
