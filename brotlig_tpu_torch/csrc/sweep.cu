// Chunk-sweep LZ77 kernel: the output bytes of a batch of pages from what
// the phase-A kernel (phase_a.cu) stores, each page's command fields and
// literal queue, in groups of CW bytes.
//
// Replaces brotlig_tpu/ops/pallas_decode.py::make_phase_b_kernel (CW = 128)
// and make_phase_b_kernel_wide (CW = 512, 1024, 2048) as launched on their
// own by _phase_b_sweep on the two-phase route, together with that
// function's XLA middle stage (commands past ncmds masked, output and
// literal starts by exclusive cumsum). Plain version:
// ops/sweep_kernel.py::sweep_plain (the pointer-doubling LZ77 of
// ops/decode.py::_phase_b); ops/sweep_kernel.py::middle_stage states the
// layout the prologue builds.
//
// One block per page; the page is built in dynamic shared memory, left to
// right, one group of CW bytes at a time, and written out coalesced at the
// end.
//   Prologue: each thread takes a contiguous run of the page's ncmds
//   commands; one block scan of their lengths and insert lengths gives
//   every command's output start, copy start and literal start, stored
//   with its distance as one 16-byte record to device-memory scratch. The
//   same pass marks, for each group, the command covering its first byte
//   (gfirst) and the queue index of its first literal (glit), in shared
//   memory. Nothing is read back to the host between phase A and here.
//   Per group: the group's commands (gfirst[g] .. gfirst[g+1], at most
//   CW/2 + 2 on a valid page, since every command but the last covers two
//   bytes or more) and its literals (at most CW, from glit[g] on) were
//   loaded into registers during the previous group and sit in shared
//   memory, so:
//   1. a byte's covering command is a binary search over those records in
//      shared memory (more commands than the stage holds, which only a
//      corrupt page gives, falls back to a bounded search in device
//      memory);
//   2. an insert byte is its literal, from the staged literals; a copy
//      byte with distance d reads cst - d + (pos - cst) mod d, a byte of an
//      earlier group (final in shared memory) or an earlier byte of this
//      group;
//   3. sources inside a warp's 32 bytes resolve by pointer jumping over
//      the lanes (5 shuffle steps, no barrier); only sources in an earlier
//      warp's bytes of the group take block-wide pointer doubling, skipped
//      when no byte needs it.
// Bytes past the page's coverage are zero, as in the plain version. A
// corrupt page (the phase-A status flags it) gives wrong bytes but every
// index is clamped and every loop bounded, so nothing is read or written
// out of bounds and nothing hangs.
//
// What bounds it on this card: a page is a serial chain of groups, and a
// batch takes as long as its slowest page. So no step of a group waits on
// device memory: its chain is a short shared-memory search, the lane jumps
// and two barriers, with the next group's loads in flight.
#include <cstdint>

#include <cuda_runtime.h>

namespace blg {
namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kFar = 1 << 29;      // saturation of starts: past any page
constexpr int kLenCap = 1 << 28;   // an insert or copy length, clamped

template <int CW>
struct SweepShape {
  static constexpr int kThreads = CW < 1024 ? CW : 1024;
  static constexpr int kPer = CW / kThreads;     // bytes per thread
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kCap = CW / 2 + 2;        // staged commands a group
  static constexpr int kStage = (kCap + kThreads - 1) / kThreads;
  static constexpr int kRounds = CW == 128   ? 7
                                 : CW == 512  ? 9
                                 : CW == 1024 ? 10
                                              : 11;  // log2(CW)
};

__device__ __forceinline__ int sat_add(int a, int b) {
  return min(a + b, kFar);   // a, b in [0, kFar]: no int overflow
}

template <int CW>
__global__ void __launch_bounds__(SweepShape<CW>::kThreads)
    sweep_kernel(const int32_t* __restrict__ ncmds,
                 const int32_t* __restrict__ ins,
                 const int32_t* __restrict__ cpy,
                 const int32_t* __restrict__ dist,
                 const uint8_t* __restrict__ litq, int lit_w, int N, int S,
                 int4* scratch, uint8_t* __restrict__ out) {
  using Sh = SweepShape<CW>;
  const int G = S / CW;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* page = smem;                                        // S
  int4* scmd = reinterpret_cast<int4*>(smem + S);              // kCap
  int* gfirst = reinterpret_cast<int*>(scmd + Sh::kCap);       // G + 2
  int* glit = gfirst + G + 2;                                  // G + 2
  int16_t* link = reinterpret_cast<int16_t*>(glit + G + 2);    // CW
  uint8_t* val = reinterpret_cast<uint8_t*>(link + CW);        // CW
  uint8_t* slit = val + CW;                                    // CW
  __shared__ int s_len[Sh::kWarps], s_ins[Sh::kWarps];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const size_t pp = blockIdx.x;
  const int32_t* pins = ins + pp * N;
  const int32_t* pcpy = cpy + pp * N;
  const int32_t* pdist = dist + pp * N;
  const uint8_t* pq = litq + pp * lit_w;
  int4* pcmd = scratch + pp * N;
  const int n = min(max(ncmds[pp], 0), N);

  // ---- prologue: command starts (block scan) and the group maps ----
  for (int g = t; g < G + 2; g += Sh::kThreads) {
    gfirst[g] = max(n - 1, 0);
    glit[g] = 0;
  }
  const int K = (n + Sh::kThreads - 1) / Sh::kThreads;
  const int c0 = min(t * K, n);
  const int c1 = min(c0 + K, n);
  int run_len = 0, run_ins = 0;
  for (int c = c0; c < c1; ++c) {
    const int a = min(max(pins[c], 0), kLenCap);
    const int b = min(max(pcpy[c], 0), kLenCap);
    run_len = sat_add(run_len, a + b);
    run_ins = sat_add(run_ins, a);
  }
  int il = run_len, ii = run_ins;                // warp inclusive scans
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int xl = __shfl_up_sync(kFullMask, il, d);
    const int xi = __shfl_up_sync(kFullMask, ii, d);
    if (lane >= d) {
      il = sat_add(il, xl);
      ii = sat_add(ii, xi);
    }
  }
  if (lane == 31) {
    s_len[warp] = il;
    s_ins[warp] = ii;
  }
  __syncthreads();
  if (warp == 0) {
    int wl = lane < Sh::kWarps ? s_len[lane] : 0;
    int wi = lane < Sh::kWarps ? s_ins[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int xl = __shfl_up_sync(kFullMask, wl, d);
      const int xi = __shfl_up_sync(kFullMask, wi, d);
      if (lane >= d) {
        wl = sat_add(wl, xl);
        wi = sat_add(wi, xi);
      }
    }
    if (lane < Sh::kWarps) {
      s_len[lane] = wl;
      s_ins[lane] = wi;
    }
  }
  __syncthreads();
  const int tot = min(s_len[Sh::kWarps - 1], S);
  int el = __shfl_up_sync(kFullMask, il, 1);
  int ei = __shfl_up_sync(kFullMask, ii, 1);
  if (lane == 0) el = ei = 0;
  int st = sat_add(warp > 0 ? s_len[warp - 1] : 0, el);
  int lst = sat_add(warp > 0 ? s_ins[warp - 1] : 0, ei);
  for (int c = c0; c < c1; ++c) {
    const int a = min(max(pins[c], 0), kLenCap);
    const int b = min(max(pcpy[c], 0), kLenCap);
    const int cs = sat_add(st, a);
    const int end = sat_add(cs, b);
    pcmd[c] = make_int4(st, cs, lst, pdist[c]);
    // the groups whose first byte this command covers
    const int stop = min(end, tot);
    for (int g = (st + CW - 1) / CW; g * CW < stop; ++g) {
      gfirst[g] = c;
      glit[g] = lst + min(g * CW - st, a);
    }
    st = end;
    lst = sat_add(lst, a);
  }
  __syncthreads();   // scratch and maps written; scratch read with __ldcg

  // ---- the groups ----
  int4 pre[Sh::kStage];
  uint8_t plit[Sh::kPer];
  // load group g's commands and literals into registers
  auto fetch = [&](int g) {
    const int f = gfirst[g];
    const int cnt = min(gfirst[g + 1] - f + 1, Sh::kCap);
    const int gl = glit[g];
#pragma unroll
    for (int m = 0; m < Sh::kStage; ++m) {
      const int k = t + m * Sh::kThreads;
      if (k < cnt) pre[m] = __ldcg(pcmd + f + k);
    }
#pragma unroll
    for (int j = 0; j < Sh::kPer; ++j)
      plit[j] = pq[min(max(gl + t + j * Sh::kThreads, 0), lit_w - 1)];
  };
  auto stage = [&](int g) {
    const int cnt = min(gfirst[g + 1] - gfirst[g] + 1, Sh::kCap);
#pragma unroll
    for (int m = 0; m < Sh::kStage; ++m) {
      const int k = t + m * Sh::kThreads;
      if (k < cnt) scmd[k] = pre[m];
    }
#pragma unroll
    for (int j = 0; j < Sh::kPer; ++j) slit[t + j * Sh::kThreads] = plit[j];
  };

  if (tot > 0) {
    fetch(0);
    stage(0);
  }
  __syncthreads();

  for (int g = 0, g0 = 0; g0 < tot; ++g, g0 += CW) {
    const bool more = g0 + CW < tot;
    if (more) fetch(g + 1);                      // lands during this group

    const int f = gfirst[g];
    const int cnt_all = gfirst[g + 1] - f + 1;
    const int cnt = min(cnt_all, Sh::kCap);
    const int gl = glit[g];
    int lk[Sh::kPer];
    int v[Sh::kPer];
    bool pending = false;
#pragma unroll
    for (int j = 0; j < Sh::kPer; ++j) {
      const int i = t + j * Sh::kThreads;
      const int pos = g0 + i;
      lk[j] = -1;
      v[j] = 0;
      if (pos < tot) {
        int a = 0, b = cnt;                      // scmd[a].x <= pos
        while (b - a > 1) {
          const int mid = (a + b) >> 1;
          if (scmd[mid].x <= pos) a = mid; else b = mid;
        }
        int4 c = scmd[a];
        if (cnt_all > cnt && a == cnt - 1) {     // a stage too small
          int lo = f + a, hi = n;
          while (hi - lo > 1) {
            const int mid = (lo + hi) >> 1;
            if (__ldcg(&pcmd[mid].x) <= pos) lo = mid; else hi = mid;
          }
          c = __ldcg(pcmd + lo);
        }
        if (pos < c.y) {
          const int li = min(max(c.z + pos - c.x, 0), lit_w - 1);
          const int k = li - gl;
          v[j] = k >= 0 && k < CW ? slit[k] : pq[li];
        } else {
          const int d = max(c.w, 1);
          const int src = max(c.y - d + (pos - c.y) % d, 0);
          if (src >= g0) lk[j] = src - g0;
          else v[j] = page[src];
        }
      }
      // sources among this warp's 32 bytes: pointer jumping over lanes
      const int wb = i & ~31;
#pragma unroll
      for (int s = 0; s < 5; ++s) {
        const bool in = lk[j] >= wb;
        const int from = in ? lk[j] - wb : lane;
        const int nl = __shfl_sync(kFullMask, lk[j], from);
        const int nv = __shfl_sync(kFullMask, v[j], from);
        if (in) {
          if (nl < 0) v[j] = nv;
          lk[j] = nl;
        }
      }
      link[i] = static_cast<int16_t>(lk[j]);
      val[i] = static_cast<uint8_t>(v[j]);
      pending |= lk[j] >= 0;
    }

    // sources in an earlier warp's bytes: block-wide pointer doubling
    if (__syncthreads_or(pending)) {
      for (int r = 0; r < Sh::kRounds; ++r) {
        int nl[Sh::kPer], nv[Sh::kPer];
#pragma unroll
        for (int j = 0; j < Sh::kPer; ++j) {
          nl[j] = lk[j] >= 0 ? link[lk[j]] : -1;
          nv[j] = lk[j] >= 0 ? val[lk[j]] : 0;
        }
        __syncthreads();
        pending = false;
#pragma unroll
        for (int j = 0; j < Sh::kPer; ++j) {
          const int i = t + j * Sh::kThreads;
          if (lk[j] >= 0) {
            if (nl[j] < 0) {
              v[j] = nv[j];
              val[i] = static_cast<uint8_t>(nv[j]);
            }
            lk[j] = nl[j];
            link[i] = static_cast<int16_t>(nl[j]);
            pending |= nl[j] >= 0;
          }
        }
        if (!__syncthreads_or(pending)) break;
      }
    }

#pragma unroll
    for (int j = 0; j < Sh::kPer; ++j) {
      const int pos = g0 + t + j * Sh::kThreads;
      if (pos < S) page[pos] = static_cast<uint8_t>(v[j]);
    }
    // every read of this group's stage happened before the first barrier
    if (more) stage(g + 1);
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
int launch(const int32_t* ncmds, const int32_t* ins, const int32_t* cpy,
           const int32_t* dist, const uint8_t* litq, int lit_w, int P, int N,
           int S, int4* scratch, uint8_t* out, cudaStream_t stream) {
  using Sh = SweepShape<CW>;
  const int smem = S + 16 * Sh::kCap + 8 * (S / CW + 2) + 4 * CW;
  cudaError_t e = cudaFuncSetAttribute(
      sweep_kernel<CW>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  sweep_kernel<CW><<<P, Sh::kThreads, smem, stream>>>(
      ncmds, ins, cpy, dist, litq, lit_w, N, S, scratch, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace blg

// ncmds: [P] int32; ins, cpy, dist: [P, N] int32 insert length, copy
// length and absolute distance of each command (read below ncmds only);
// litq: [P, lit_w] uint8 literal queues; scratch: [P, N, 4] int32 (the
// prologue's command records); out: [P, page_size] uint8. cw: 128, 512,
// 1024 or 2048, dividing page_size. Returns a cudaError_t (1, invalid
// value, for an unsupported cw).
extern "C" int blg_sweep(const void* ncmds, const void* ins, const void* cpy,
                         const void* dist, const void* litq, int lit_w, int P,
                         int N, int page_size, int cw, void* scratch,
                         void* out, void* stream) {
  if (P <= 0) return 0;
  const auto* nc = static_cast<const int32_t*>(ncmds);
  const auto* a = static_cast<const int32_t*>(ins);
  const auto* b = static_cast<const int32_t*>(cpy);
  const auto* d = static_cast<const int32_t*>(dist);
  const auto* q = static_cast<const uint8_t*>(litq);
  auto* sc = static_cast<int4*>(scratch);
  auto* o = static_cast<uint8_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (cw) {
    case 128:
      return blg::launch<128>(nc, a, b, d, q, lit_w, P, N, page_size, sc, o,
                              s);
    case 512:
      return blg::launch<512>(nc, a, b, d, q, lit_w, P, N, page_size, sc, o,
                              s);
    case 1024:
      return blg::launch<1024>(nc, a, b, d, q, lit_w, P, N, page_size, sc, o,
                               s);
    case 2048:
      return blg::launch<2048>(nc, a, b, d, q, lit_w, P, N, page_size, sc, o,
                               s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
