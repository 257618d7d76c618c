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
//
// Two launches a call:
//   * sort (a block of 1024 threads a page): the page in shared memory,
//     then a stable LSD radix sort of the positions 0..n-4 by hash (three
//     passes of 6, 6 and 5 bits; each pass counts its digits, then
//     scatters tiles of 1024 positions in order, a position's slot its
//     digit's base, the counts of the tile's earlier warps, and its rank
//     among its warp's lanes of the same digit by __match_any_sync). Then
//     each position's slot r in the sorted order and whether slot r - 1
//     holds the same hash, as one word r << 1 | flag. With the sort the
//     chain at q is slots r - 1, r - 2, ... while the hash is q's: the
//     walk reads 32 candidates in one coalesced load instead of chasing
//     links;
//   * walk (a warp a page, the page in shared memory): the walk above.
//     best(q) takes the chain 32 candidates at a time, one a lane; a lane
//     counts its common prefix with q four bytes a compare; the warp keeps
//     the longest (the nearest on a tie) by one __reduce_max_sync. Past
//     the first 32, a lane first compares the byte at the best length so
//     far (zlib's test: a candidate that differs there cannot be longer)
//     and counts only if it survives. The slot words of the next 32
//     positions sit in the lanes' registers, so a position with no chain
//     (most of an incompressible page) costs no memory access, and best(pos
//     + 1) is kept for the next step.
//
// What bounds it on this card: the walk's chain of dependent steps. The
// bytes (each page read once, its commands written once) take
// microseconds; a page's walk is sequential, each step one load of its
// candidates' slots and the compares, and a batch of P pages is P warps.
// A simple design that is right: the redesign of the walk (positions
// ahead of the walk's front evaluated speculatively by other warps, slots
// in shared memory) is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace blg_rp {

constexpr uint32_t kHashMul = 0x1E35A7BDu;
constexpr int kHashShift = 32 - 17;
constexpr int kSortThreads = 1024;
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kDigits = 64;               // a pass sorts 6 bits at most
constexpr int kPad = 16;                  // bytes past the page in smem
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

// The common prefix of positions a and b, at most limit bytes.
__device__ __forceinline__ int match_len(const uint8_t* page, int a, int b,
                                         int limit) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(page);
  int l = 0;
  while (l + 4 <= limit) {
    const uint32_t x = word_at(w, a + l) ^ word_at(w, b + l);
    if (x) return l + ((__ffs(x) - 1) >> 3);
    l += 4;
  }
  while (l < limit && page[a + l] == page[b + l]) ++l;
  return l;
}

// Row b of pages into shared memory, 16 bytes a thread a step; kPad zero
// bytes after it.
__device__ __forceinline__ void load_page(const uint8_t* pages, int S,
                                          uint8_t* page) {
  const uint4* src = reinterpret_cast<const uint4*>(
      pages + static_cast<size_t>(blockIdx.x) * S);
  uint4* dst = reinterpret_cast<uint4*>(page);
  for (int i = threadIdx.x; i < S / 16; i += blockDim.x) dst[i] = src[i];
  if (threadIdx.x < kPad / 16) dst[S / 16 + threadIdx.x] = make_uint4(0, 0, 0, 0);
}

__device__ __forceinline__ int page_size(const int32_t* sizes, int S) {
  const int n = sizes[blockIdx.x];
  return n < 0 ? 0 : (n > S ? S : n);
}

__global__ void __launch_bounds__(kSortThreads)
sort_kernel(const uint8_t* __restrict__ pages, const int32_t* __restrict__ sizes,
            int S, int32_t* __restrict__ scratch) {
  extern __shared__ uint4 smem_u4[];
  uint8_t* page = reinterpret_cast<uint8_t*>(smem_u4);
  int* wcount = reinterpret_cast<int*>(page + S + kPad);   // [warps][digits]
  int* base = wcount + kSortWarps * kDigits;                // [digits]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = page_size(sizes, S);
  const int m = n >= 4 ? n - 3 : 0;                         // hashed positions
  int32_t* A = scratch + static_cast<size_t>(blockIdx.x) * 2 * S;
  int32_t* B = A + S;
  load_page(pages, S, page);
  for (int i = tid; i < kSortWarps * kDigits; i += kSortThreads) wcount[i] = 0;
  const unsigned below = (1u << lane) - 1;
  // pass 0: identity -> A; pass 1: A -> B; pass 2: B -> A
  for (int pass = 0; pass < 3; ++pass) {
    const int shift = 6 * pass;
    const uint32_t mask = pass < 2 ? 63u : 31u;
    const int32_t* src = pass == 0 ? nullptr : (pass == 1 ? A : B);
    int32_t* dst = pass == 1 ? B : A;
    if (tid < kDigits) base[tid] = 0;
    __syncthreads();
    for (int t0 = 0; t0 < m; t0 += kSortThreads) {
      const int i = t0 + tid;
      const bool valid = i < m;
      const int p = valid ? (src ? src[i] : i) : 0;
      const int d = valid ? int((hash_at(page, p) >> shift) & mask)
                          : kDigits + lane;
      const unsigned same = __match_any_sync(kFull, d);
      if (valid && lane == 31 - __clz(same)) atomicAdd(&base[d], __popc(same));
    }
    __syncthreads();
    if (tid == 0) {
      int run = 0;
      for (int d = 0; d <= int(mask); ++d) {
        const int c = base[d];
        base[d] = run;
        run += c;
      }
    }
    __syncthreads();
    for (int t0 = 0; t0 < m; t0 += kSortThreads) {
      const int i = t0 + tid;
      const bool valid = i < m;
      const int p = valid ? (src ? src[i] : i) : 0;
      const int d = valid ? int((hash_at(page, p) >> shift) & mask)
                          : kDigits + lane;
      const unsigned same = __match_any_sync(kFull, d);
      if (valid && lane == 31 - __clz(same))
        wcount[warp * kDigits + d] = __popc(same);
      __syncthreads();
      if (tid <= int(mask)) {           // the digit's offsets, warp by warp
        int run = base[tid];
        for (int w = 0; w < kSortWarps; ++w) {
          const int c = wcount[w * kDigits + tid];
          wcount[w * kDigits + tid] = run;
          run += c;
        }
        base[tid] = run;
      }
      __syncthreads();
      if (valid) dst[wcount[warp * kDigits + d] + __popc(same & below)] = p;
      __syncthreads();
      for (int j = tid; j < kSortWarps * kDigits; j += kSortThreads)
        wcount[j] = 0;
      __syncthreads();
    }
  }
  // slot words: B[p] = r << 1 | (slot r - 1 holds p's hash)
  for (int r = tid; r < m; r += kSortThreads) {
    const int p = A[r];
    const bool chained = r > 0 && hash_at(page, A[r - 1]) == hash_at(page, p);
    B[p] = (r << 1) | int(chained);
  }
}

struct Walker {
  const uint8_t* page;
  const int32_t* sorted;      // positions by hash, stable
  const int32_t* slots;       // r << 1 | chained, by position
  int n, m, max_chain, lane;
  int wbase, wslot;           // the slot words of positions wbase + lane

  // best(q) = (length, distance), warp-uniform.
  __device__ int2 best(int q) {
    if (q + 4 > n || max_chain <= 0) return make_int2(0, 0);
    if (q < wbase || q >= wbase + 32) {
      wbase = q;
      wslot = q + lane < m ? slots[q + lane] : 0;
    }
    const int word = __shfl_sync(kFull, wslot, q - wbase);
    if (!(word & 1)) return make_int2(0, 0);
    const int r = word >> 1;
    const uint32_t hq = hash_at(page, q);
    const int limit = n - q;
    int best_len = 0, best_dist = 0;
    for (int k0 = 1; k0 <= max_chain && k0 <= r; k0 += 32) {
      const int k = k0 + lane;
      bool real = k <= max_chain && k <= r;
      const int c = real ? sorted[r - k] : 0;
      real = real && hash_at(page, c) == hq;
      const unsigned run = __ballot_sync(kFull, real);
      const int count = run == kFull ? 32 : __ffs(~run) - 1;
      int len = 0;
      if (lane < count &&
          (best_len == 0 || (best_len < limit &&
                             page[c + best_len] == page[q + best_len])))
        len = match_len(page, c, q, limit);
      const unsigned key = len >= 4 && len > best_len
                               ? (unsigned(len) << 5) | unsigned(31 - lane)
                               : 0u;
      const unsigned top = __reduce_max_sync(kFull, key);
      if (top) {
        best_len = int(top >> 5);
        best_dist = q - __shfl_sync(kFull, c, 31 - int(top & 31));
      }
      if (count < 32) break;
    }
    return make_int2(best_len, best_dist);
  }
};

__global__ void __launch_bounds__(32)
walk_kernel(const uint8_t* __restrict__ pages, const int32_t* __restrict__ sizes,
            int S, int max_chain, int max_cmds,
            const int32_t* __restrict__ scratch, int32_t* __restrict__ ins,
            int32_t* __restrict__ cpy, int32_t* __restrict__ dist,
            int32_t* __restrict__ ncmds, int32_t* __restrict__ tail) {
  extern __shared__ uint4 smem_u4[];
  uint8_t* page = reinterpret_cast<uint8_t*>(smem_u4);
  load_page(pages, S, page);
  __syncwarp();
  const int n = page_size(sizes, S);
  const size_t row = static_cast<size_t>(blockIdx.x);
  Walker w;
  w.page = page;
  w.sorted = scratch + row * 2 * S;
  w.slots = w.sorted + S;
  w.n = n;
  w.m = n >= 4 ? n - 3 : 0;
  w.max_chain = max_chain;
  w.lane = threadIdx.x;
  w.wbase = -64;
  w.wslot = 0;
  int32_t* ins_row = ins + row * max_cmds;
  int32_t* cpy_row = cpy + row * max_cmds;
  int32_t* dist_row = dist + row * max_cmds;
  int pos = 0, anchor = 0, nc = 0;
  int kept_q = -1;
  int2 kept = make_int2(0, 0);
  while (pos < n) {
    const int2 b = kept_q == pos ? kept : w.best(pos);
    if (b.x >= 4) {
      kept = pos + 1 < n ? w.best(pos + 1) : make_int2(0, 0);
      kept_q = pos + 1;
      if (kept.x > b.x + 1) {
        ++pos;
        continue;
      }
      if (threadIdx.x == 0 && nc < max_cmds) {
        ins_row[nc] = pos - anchor;
        cpy_row[nc] = b.x;
        dist_row[nc] = b.y;
      }
      ++nc;
      pos += b.x;
      anchor = pos;
    } else {
      ++pos;
    }
  }
  if (threadIdx.x == 0) {
    ncmds[row] = nc <= max_cmds ? nc : -1;
    tail[row] = n - anchor;
  }
}

// Dynamic shared memory of the sort launch and of the walk launch.
size_t sort_smem(int S) {
  return S + kPad + sizeof(int) * (kSortWarps + 1) * kDigits;
}

size_t walk_smem(int S) { return S + kPad; }

int set_smem(const void* kernel, size_t bytes) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) cudaGetLastError();
  return static_cast<int>(e);
}

}  // namespace blg_rp

// The sort: pages uint8 [P, S] (16-byte aligned, S % 16 == 0), sizes int32
// [P]; writes scratch int32 [P, 2, S]: the positions by hash, then each
// position's slot word.
extern "C" int blg_ref_parse_sort(const void* pages, const void* sizes, int P,
                                  int S, void* scratch, void* stream) {
  if (P <= 0) return 0;
  const size_t smem = blg_rp::sort_smem(S);
  const int e = blg_rp::set_smem(
      reinterpret_cast<const void*>(blg_rp::sort_kernel), smem);
  if (e) return e;
  blg_rp::sort_kernel<<<P, blg_rp::kSortThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(pages), static_cast<const int32_t*>(sizes),
      S, static_cast<int32_t*>(scratch));
  return static_cast<int>(cudaGetLastError());
}

// The walk over the sort's scratch: ins, cpy, dist int32 [P, max_cmds],
// ncmds and tail int32 [P] (ncmds -1 where a page needs more than
// max_cmds commands).
extern "C" int blg_ref_parse_walk(const void* pages, const void* sizes, int P,
                                  int S, int max_chain, int max_cmds,
                                  const void* scratch, void* ins, void* cpy,
                                  void* dist, void* ncmds, void* tail,
                                  void* stream) {
  if (P <= 0) return 0;
  const size_t smem = blg_rp::walk_smem(S);
  const int e = blg_rp::set_smem(
      reinterpret_cast<const void*>(blg_rp::walk_kernel), smem);
  if (e) return e;
  blg_rp::walk_kernel<<<P, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(pages), static_cast<const int32_t*>(sizes),
      S, max_chain, max_cmds, static_cast<const int32_t*>(scratch),
      static_cast<int32_t*>(ins), static_cast<int32_t*>(cpy),
      static_cast<int32_t*>(dist), static_cast<int32_t*>(ncmds),
      static_cast<int32_t*>(tail));
  return static_cast<int>(cudaGetLastError());
}
