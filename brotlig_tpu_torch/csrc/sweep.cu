// Chunk-sweep LZ77 kernel: the output bytes of a batch of pages from their
// command arrays and literal queues (what the phase-A kernel, phase_a.cu,
// stores), in groups of CW bytes.
//
// Replaces brotlig_tpu/ops/pallas_decode.py::make_phase_b_kernel (CW = 128)
// and make_phase_b_kernel_wide (CW = 512, 1024, 2048) as launched on their
// own by _phase_b_sweep on the two-phase route. Plain version:
// ops/sweep_kernel.py::sweep_plain (the pointer-doubling LZ77 of
// ops/decode.py::_phase_b).
//
// One block per page; the page is built in dynamic shared memory, left to
// right, one group of CW bytes at a time, and written out coalesced at the
// end. For byte pos of a group:
//   1. the covering command c is the last with st[c] <= pos: a binary
//      search over the page's sorted output starts, from the command that
//      covered the previous group's last byte (invalid commands carry the
//      start 1 << 29 and never win). It takes at most log2(N) steps, so it
//      cannot hang where the TPU kernels' windowed search retries without
//      bound (pallas_decode.py:941-982, 1035-1076, 1282);
//   2. an insert byte is literal lst[c] + pos - st[c] of the queue; a copy
//      byte with distance d reads cst[c] - d + (pos - cst[c]) mod d, which
//      always lies before cst[c]: a byte of an earlier group (final in
//      shared memory) or an earlier byte of this group;
//   3. chains inside the group resolve in at most log2(CW) rounds of
//      pointer doubling in shared memory.
// Bytes past the page's coverage are zero, as in the plain version. A
// corrupt page (the phase-A status flags it) gives wrong bytes but every
// index is clamped, so nothing is read or written out of bounds.
//
// What bounds it on this card: latency of the dependent loads in the
// search and of the block barriers per group (2 + 2 per doubling round),
// with one block per page. Wider groups pay fewer barriers per byte; CW =
// 128 pays the most.
#include <cstdint>

#include <cuda_runtime.h>

namespace blg {
namespace {

template <int CW>
struct SweepShape {
  static constexpr int kThreads = CW < 1024 ? CW : 1024;
  static constexpr int kPer = CW / kThreads;     // bytes per thread
  static constexpr int kRounds = CW == 128   ? 7
                                 : CW == 512  ? 9
                                 : CW == 1024 ? 10
                                              : 11;  // log2(CW)
};

template <int CW>
__global__ void __launch_bounds__(SweepShape<CW>::kThreads)
    sweep_kernel(const int32_t* __restrict__ st,
                 const int32_t* __restrict__ cst,
                 const int32_t* __restrict__ lst,
                 const int32_t* __restrict__ dist,
                 const int32_t* __restrict__ total,
                 const uint8_t* __restrict__ litq, int lit_w, int N, int S,
                 uint8_t* __restrict__ out) {
  using Sh = SweepShape<CW>;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* page = smem;                                      // S bytes
  int16_t* link = reinterpret_cast<int16_t*>(smem + S);      // CW
  uint8_t* val = smem + S + 2 * CW;                          // CW
  // the command covering a group's last byte, read by the next group
  // (two slots: a slot is rewritten only after its readers passed a barrier)
  __shared__ int s_lo[2];

  const int t = threadIdx.x;
  const size_t pp = blockIdx.x;
  const int32_t* pst = st + pp * N;
  const int32_t* pcst = cst + pp * N;
  const int32_t* plst = lst + pp * N;
  const int32_t* pdist = dist + pp * N;
  const uint8_t* pq = litq + pp * lit_w;
  const int tot = min(max(total[pp], 0), S);
  if (t == 0) s_lo[0] = 0;
  __syncthreads();

  for (int g0 = 0, slot = 0; g0 < tot; g0 += CW, slot ^= 1) {
    const int lo = s_lo[slot];
#pragma unroll
    for (int j = 0; j < Sh::kPer; ++j) {
      const int i = t + j * Sh::kThreads;
      const int pos = g0 + i;
      int lk = -1;
      uint8_t v = 0;
      if (pos < tot) {
        int a = lo, b = N;                       // st[a] <= pos < st[b]
        while (b - a > 1) {
          const int mid = (a + b) >> 1;
          if (__ldg(pst + mid) <= pos) a = mid; else b = mid;
        }
        const int s = __ldg(pst + a);
        const int cs = __ldg(pcst + a);
        if (pos < cs) {
          const int li = min(max(__ldg(plst + a) + pos - s, 0), lit_w - 1);
          v = __ldg(pq + li);
        } else {
          const int d = max(__ldg(pdist + a), 1);
          const int src = max(cs - d + (pos - cs) % d, 0);
          if (src >= g0 && src < pos) lk = src - g0;
          else if (src < g0) v = page[src];
        }
        if (i == CW - 1) s_lo[slot ^ 1] = a;
      }
      link[i] = static_cast<int16_t>(lk);
      val[i] = v;
    }
    __syncthreads();

    for (int r = 0; r < Sh::kRounds; ++r) {
      int nl[Sh::kPer];
      uint8_t nv[Sh::kPer];
      bool pending = false;
#pragma unroll
      for (int j = 0; j < Sh::kPer; ++j) {
        const int l = link[t + j * Sh::kThreads];
        nl[j] = l >= 0 ? link[l] : -1;
        nv[j] = l >= 0 ? val[l] : 0;
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < Sh::kPer; ++j) {
        const int i = t + j * Sh::kThreads;
        if (link[i] >= 0) {
          link[i] = static_cast<int16_t>(nl[j]);
          if (nl[j] < 0) val[i] = nv[j];
          pending |= nl[j] >= 0;
        }
      }
      if (!__syncthreads_or(pending)) break;
    }

#pragma unroll
    for (int j = 0; j < Sh::kPer; ++j) {
      const int i = t + j * Sh::kThreads;
      if (g0 + i < S) page[g0 + i] = val[i];
    }
    __syncthreads();
  }

  // bytes past the coverage are zero; then the page goes out in 16-byte
  // stores (S is a multiple of 16, the shared buffer 16-byte aligned)
  for (int j = tot + t; j < S; j += Sh::kThreads) page[j] = 0;
  __syncthreads();
  const uint4* src = reinterpret_cast<const uint4*>(page);
  uint4* dst = reinterpret_cast<uint4*>(out + pp * S);
  for (int j = t; j < S / 16; j += Sh::kThreads) dst[j] = src[j];
}

template <int CW>
int launch(const int32_t* st, const int32_t* cst, const int32_t* lst,
           const int32_t* dist, const int32_t* total, const uint8_t* litq,
           int lit_w, int P, int N, int S, uint8_t* out,
           cudaStream_t stream) {
  const int smem = S + 3 * CW;
  cudaError_t e = cudaFuncSetAttribute(
      sweep_kernel<CW>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  sweep_kernel<CW><<<P, SweepShape<CW>::kThreads, smem, stream>>>(
      st, cst, lst, dist, total, litq, lit_w, N, S, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace blg

// st, cst, lst, dist: [P, N] int32 output start, copy start, literal start
// and absolute distance of each command (st = 1 << 29 past the page's
// commands, sorted); total: [P] int32 bytes covered; litq: [P, lit_w]
// uint8 literal queues; out: [P, page_size] uint8. cw: 128, 512, 1024 or
// 2048, dividing page_size. Returns a cudaError_t (1, invalid value, for
// an unsupported cw).
extern "C" int blg_sweep(const void* st, const void* cst, const void* lst,
                         const void* dist, const void* total,
                         const void* litq, int lit_w, int P, int N,
                         int page_size, int cw, void* out, void* stream) {
  if (P <= 0) return 0;
  const auto* a = static_cast<const int32_t*>(st);
  const auto* b = static_cast<const int32_t*>(cst);
  const auto* c = static_cast<const int32_t*>(lst);
  const auto* d = static_cast<const int32_t*>(dist);
  const auto* n = static_cast<const int32_t*>(total);
  const auto* q = static_cast<const uint8_t*>(litq);
  auto* o = static_cast<uint8_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (cw) {
    case 128:
      return blg::launch<128>(a, b, c, d, n, q, lit_w, P, N, page_size, o, s);
    case 512:
      return blg::launch<512>(a, b, c, d, n, q, lit_w, P, N, page_size, o, s);
    case 1024:
      return blg::launch<1024>(a, b, c, d, n, q, lit_w, P, N, page_size, o,
                               s);
    case 2048:
      return blg::launch<2048>(a, b, c, d, n, q, lit_w, P, N, page_size, o,
                               s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
