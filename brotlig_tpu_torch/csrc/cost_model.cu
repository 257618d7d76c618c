// The q11 cost model: the windowed DP's cost tables and candidate set from
// a previous parse's commands.
//
// Replaces brotlig_tpu/ops/parse_dp.py:71 (build_cost_model), which has no
// Pallas kernel: on the TPU, XLA compiles it into one jax.jit program.
// Plain version: ops/parse_dp.py::build_cost_model_plain (the same function
// as eager torch ops, ~3,000 launches a call); wrapper:
// ops/cost_kernel.py::build_cost_model_cuda. Two kernels, two launches a
// call (a third, unseen_check_kernel, only checks the unseen-symbol cost):
//
//   * cost_tables_kernel, one thread block a page: the serializer's own
//     statistics and code lengths, shared with pack.cu rather than copied
//     (page_stats in page_tables.cuh: command starts, the exact ring before
//     each command, the (npostfix, ndirect) grid search, the ring mode, the
//     histograms, the literal cover, the three tables' lengths), then the
//     half-bit symbol costs: a used symbol costs twice its code length, an
//     unused one round(2 * min(15, log2f(total) + pad)) (pad 2 for literals
//     and commands, 4 for distances; libdevice log2f and rintf, no fast
//     math, as torch's float32 log2 and round give on the card). It writes
//     jointEq / jointLq [P, 576] and, into the page's scratch, the literal
//     and distance cost tables, the ring before each command and after the
//     last one (N + 1 columns), and npostfix, ndirect, the command count and
//     the bytes the commands cover;
//   * cost_positions_kernel, blocks of kPosThreads positions of one page
//     over every SM: each position's literal cost, its covering command (a
//     binary search over the starts; at or past the covered bytes the ring
//     after the last command), the four ring-distance probes (a common
//     prefix of at most 16 bytes, counted to the page's size, kept from 2
//     bytes on), the 12 candidate slots (the 8 base slots copied, then the
//     4 ring slots) and each slot's distance cost: symbol plus extra bits
//     under the page's (npostfix, ndirect), 40 bits past the alphabet, or
//     the lowest ring code the distance takes against the inherited ring
//     where that is cheaper, with the ring-0 hit in the low bit.
//
// What bounds it on this card: the bytes. An iteration of the 8-page q11
// batch reads the base candidates (33.6 MB) and writes the three [P, S, 12]
// outputs (75.5 MB): ~34 us at 3.35 TB/s; the arithmetic is a few dozen
// integer operations a slot. The table kernel is a per-page chain (the
// serializer's first phases, a block a page), paced by its slowest page,
// not by bytes. The design keeps the chain as short as the serializer's
// (the shared phases run on all 16 warps with their data in shared memory)
// and gives the byte-heavy per-position work to a second kernel whose
// blocks of positions fill all 132 SMs from 8 pages on: each thread reads
// its 16 base values as four 16-byte loads and writes its 36 outputs as
// nine, with the page's two cost tables in shared memory.
//
// Inputs (int32 unless noted): pages uint8 [P, S], in_sizes [P], ins / cpy /
// dist [P, N] (zero past ncmds), ncmds [P], base_len / base_dist [P, S, 8].
// Outputs: litq [P, S], jointEq / jointLq [P, 576], cand_len / cand_dist /
// dpackq [P, S, 12]. Scratch: int32 [P, blg_cost_scratch_ints(N, S)]. The
// contract is the plain version's for commands whose lengths cover at most
// the page and page sizes at most S (what the matchers and the DP give).
#include "page_tables.cuh"

namespace blg_cost {
namespace {

using namespace blg_pack;

constexpr int kInfQ = (1 << 21) - 1;   // parse_dp.INF_Q
constexpr int kJoint = 24 * 24;        // (insert code, copy code) pairs
constexpr int kBase = 8;               // find_candidates' slots
constexpr int kSlots = kBase + 4;      // and the four ring probes
constexpr int kProbe = 16;             // bytes a ring probe compares
constexpr int kPosThreads = 256;
constexpr int kHdrInts = 4;            // n, covered, npostfix, ndirect

// A page's scratch, in int32 words: the serializer's layout (starts, ring
// pushes, keys, literal queue, ...), then the ring before each command
// (int4 [N + 1]), the page's header and its literal and distance costs.
struct CostLayout {
  long long ring, hdr, litq, dstq, total;
  __host__ __device__ CostLayout(int N, int S) {
    ring = Layout(N, S, S).total;
    hdr = ring + 4LL * (N + 1);
    litq = hdr + kHdrInts;
    dstq = litq + kALit;
    total = up4(dstq + kADst);
  }
};

// Half-bits of a symbol the previous parse did not use, in a table of
// `total` symbols: round(2 * min(15, log2f(total) + pad)), parse_dp's
// unseen_bits in float32.
__device__ __forceinline__ int unseen_q(int total, float pad) {
  const float bits = fminf(log2f(static_cast<float>(max(total, 1))) + pad,
                           15.0f);
  return static_cast<int>(rintf(2.0f * bits));
}

__global__ void __launch_bounds__(kThreads, 1)
    cost_tables_kernel(const uint8_t* __restrict__ pages,
                       const int32_t* __restrict__ in_sizes,
                       const int32_t* __restrict__ ins_g,
                       const int32_t* __restrict__ cpy_g,
                       const int32_t* __restrict__ dist_g,
                       const int32_t* __restrict__ ncmds_g, int S, int N,
                       int region, int lq_shared,
                       int32_t* __restrict__ joint_e,
                       int32_t* __restrict__ joint_l,
                       int32_t* __restrict__ scr_g) {
  __shared__ Smem sm;
  // the serializer's dynamic shared memory: Rarr (unused here), the region
  extern __shared__ __align__(16) unsigned char dyn[];
  unsigned char* reg = dyn + rarr_bytes(N);
  const int tid = threadIdx.x;
  const int page = blockIdx.x;
  const Layout lay(N, S, S);
  const CostLayout cl(N, S);
  int32_t* scr = scr_g + static_cast<size_t>(page) * cl.total;
  const size_t row = static_cast<size_t>(page) * N;
  const int n = min(max(ncmds_g[page], 0), N);
  long long stamp[kPhases + 1];
  const PageStats st = page_stats<true>(
      pages + static_cast<size_t>(page) * S, ins_g + row, cpy_g + row,
      dist_g + row, n, in_sizes[page], S, S, lay, scr, reg, region,
      lq_shared, sm, stamp, reinterpret_cast<int4*>(scr + cl.ring));

  // ---- the half-bit symbol costs (parse_dp's sym_cost, _half_bits) ----
  int tot[3] = {0, 0, 0};
  for (int i = tid; i < kATot; i += kThreads)
    tot[i < kACmd ? 0 : i < kACmd + kADst ? 1 : 2] += sm.hist[i];
  const int uq_cmd = unseen_q(block_sum(tot[0], sm.red), 2.0f);
  const int uq_dst = unseen_q(block_sum(tot[1], sm.red), 4.0f);
  const int uq_lit = unseen_q(block_sum(tot[2], sm.red), 2.0f);
  auto cost = [&](int i, int uq) {
    return sm.hist[i] > 0 ? 2 * sm.lens[i] : uq;
  };
  for (int i = tid; i < kALit; i += kThreads)
    scr[cl.litq + i] = cost(kACmd + kADst + i, uq_lit);
  for (int i = tid; i < kADst; i += kThreads)
    scr[cl.dstq + i] = cost(kACmd + i, uq_dst);
  const size_t jrow = static_cast<size_t>(page) * kJoint;
  for (int i = tid; i < kJoint; i += kThreads) {
    const int ic = i / 24, cc = i % 24;
    joint_e[jrow + i] = cost(combine_codes(ic, cc, false), uq_cmd);
    joint_l[jrow + i] = ic < 8 && cc < 16
                            ? cost(combine_codes(ic, cc, true), uq_cmd)
                            : kInfQ;
  }
  if (tid == 0) {
    int* hdr = scr + cl.hdr;
    hdr[0] = n;
    hdr[1] = static_cast<int>(min(st.covered, static_cast<long long>(S)));
    hdr[2] = st.npostfix;
    hdr[3] = st.ndirect;
  }
}

// The lowest ring code whose distance is d (d >= 1) against the ring
// (r0, r1, r2, r3), or -1: the exact hits, then r0 -+ 1..3, then r1 -+ 1..3.
__device__ __forceinline__ int ring_code(int d, int r0, int r1, int r2,
                                         int r3) {
  if (d == r0) return 0;
  if (d == r1) return 1;
  if (d == r2) return 2;
  if (d == r3) return 3;
  for (int k = 1; k <= 3; ++k) {
    if (d == r0 - k) return 2 + 2 * k;
    if (d == r0 + k) return 3 + 2 * k;
  }
  for (int k = 1; k <= 3; ++k) {
    if (d == r1 - k) return 8 + 2 * k;
    if (d == r1 + k) return 9 + 2 * k;
  }
  return -1;
}

__global__ void __launch_bounds__(kPosThreads)
    cost_positions_kernel(const uint8_t* __restrict__ pages,
                          const int32_t* __restrict__ in_sizes,
                          const int32_t* __restrict__ base_len,
                          const int32_t* __restrict__ base_dist, int S,
                          int N, const int32_t* __restrict__ scr_g,
                          int32_t* __restrict__ litq,
                          int32_t* __restrict__ cand_len,
                          int32_t* __restrict__ cand_dist,
                          int32_t* __restrict__ dpackq) {
  __shared__ int lit_c[kALit];
  __shared__ int dst_c[kADst];
  const int page = blockIdx.y;
  const CostLayout cl(N, S);
  const int32_t* scr = scr_g + static_cast<size_t>(page) * cl.total;
  for (int i = threadIdx.x; i < kALit; i += kPosThreads)
    lit_c[i] = scr[cl.litq + i];
  for (int i = threadIdx.x; i < kADst; i += kPosThreads)
    dst_c[i] = scr[cl.dstq + i];
  __syncthreads();
  const int pos = blockIdx.x * kPosThreads + threadIdx.x;
  if (pos >= S) return;
  const int n = scr[cl.hdr], covered = scr[cl.hdr + 1];
  const int npostfix = scr[cl.hdr + 2], ndirect = scr[cl.hdr + 3];
  const uint8_t* pg = pages + static_cast<size_t>(page) * S;
  const size_t at = static_cast<size_t>(page) * S + pos;
  litq[at] = lit_c[pg[pos]];

  // the covering command: the last start at or before pos; the bytes past
  // the commands take the ring after the last one (column n)
  int col = n;
  if (pos < covered) {
    const int32_t* starts = scr + Layout(N, S, S).starts;
    int lo = 0, hi = n - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (starts[mid] <= pos) lo = mid;
      else hi = mid - 1;
    }
    col = lo;
  }
  const int4 rg = reinterpret_cast<const int4*>(scr + cl.ring)[col];
  const int ring[4] = {rg.x, rg.y, rg.z, rg.w};

  int len[kSlots], dist[kSlots];
  const int4* bl = reinterpret_cast<const int4*>(base_len + at * kBase);
  const int4* bd = reinterpret_cast<const int4*>(base_dist + at * kBase);
  for (int h = 0; h < 2; ++h) {
    const int4 l4 = bl[h], d4 = bd[h];
    len[4 * h] = l4.x; len[4 * h + 1] = l4.y;
    len[4 * h + 2] = l4.z; len[4 * h + 3] = l4.w;
    dist[4 * h] = d4.x; dist[4 * h + 1] = d4.y;
    dist[4 * h + 2] = d4.z; dist[4 * h + 3] = d4.w;
  }
  // the ring probes: no byte at or past the page's size decides a length
  const int room = min(kProbe, min(in_sizes[page], S) - pos);
  for (int k = 0; k < 4; ++k) {
    const int r = ring[k];
    int m = 0;
    if (r >= 1 && pos - r >= 0) {
      const uint8_t* a = pg + pos;
      const uint8_t* b = pg + pos - r;
      while (m < room && a[m] == b[m]) ++m;
    }
    len[kBase + k] = m >= 2 ? m : 0;
    dist[kBase + k] = m >= 2 ? r : 0;
  }

  int packq[kSlots];
  for (int s = 0; s < kSlots; ++s) {
    int sym, nb;
    long long extra;
    encode_distance(max(dist[s], 1), npostfix, ndirect, &sym, &nb, &extra);
    int dq = (sym < kADst ? dst_c[sym] : 80) + 2 * nb;
    const int rsym = dist[s] >= 1
                         ? ring_code(dist[s], ring[0], ring[1], ring[2],
                                     ring[3])
                         : -1;
    if (rsym >= 0) dq = min(dq, dst_c[rsym]);
    packq[s] = (min(dq, kInfQ) << 1) | (rsym == 0);
  }
  int4* ol = reinterpret_cast<int4*>(cand_len + at * kSlots);
  int4* od = reinterpret_cast<int4*>(cand_dist + at * kSlots);
  int4* oq = reinterpret_cast<int4*>(dpackq + at * kSlots);
  for (int h = 0; h < kSlots / 4; ++h) {
    ol[h] = make_int4(len[4 * h], len[4 * h + 1], len[4 * h + 2],
                      len[4 * h + 3]);
    od[h] = make_int4(dist[4 * h], dist[4 * h + 1], dist[4 * h + 2],
                      dist[4 * h + 3]);
    oq[h] = make_int4(packq[4 * h], packq[4 * h + 1], packq[4 * h + 2],
                      packq[4 * h + 3]);
  }
}

// The unseen-symbol half-bits of the totals 1..n (a check of unseen_q
// against the plain version's float32 cost, run by the tests and
// chip_smoke.py, never by a route).
__global__ void unseen_check_kernel(int n, float pad, int32_t* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = unseen_q(i + 1, pad);
}

}  // namespace
}  // namespace blg_cost

// int32 words of scratch a page needs at (N, S).
extern "C" long long blg_cost_scratch_ints(int N, int S) {
  return blg_cost::CostLayout(N, S).total;
}

// Bytes of dynamic shared memory the table kernel takes at (N, S) on the
// current device, or -1 if the page size does not fit.
extern "C" long long blg_cost_smem(int N, int S) {
  long long bytes;
  int region, lq_shared;
  if (blg_pack::smem_plan(blg_cost::cost_tables_kernel, N, S, S, &bytes,
                          &region, &lq_shared) != cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  return bytes;
}

// Launch the table kernel over P pages (one block a page).
extern "C" int blg_cost_tables(const void* pages, const void* in_sizes,
                               const void* ins, const void* cpy,
                               const void* dist, const void* ncmds, int P,
                               int S, int N, void* joint_e, void* joint_l,
                               void* scratch, void* stream) {
  if (P <= 0) return 0;
  long long smem;
  int region, lq_shared;
  cudaError_t e = blg_pack::smem_plan(blg_cost::cost_tables_kernel, N, S, S,
                                      &smem, &region, &lq_shared);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(blg_cost::cost_tables_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  blg_cost::cost_tables_kernel<<<P, blg_pack::kThreads, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(pages),
      static_cast<const int32_t*>(in_sizes), static_cast<const int32_t*>(ins),
      static_cast<const int32_t*>(cpy), static_cast<const int32_t*>(dist),
      static_cast<const int32_t*>(ncmds), S, N, region, lq_shared,
      static_cast<int32_t*>(joint_e), static_cast<int32_t*>(joint_l),
      static_cast<int32_t*>(scratch));
  return static_cast<int>(cudaGetLastError());
}

// Launch the position kernel over P pages of S positions.
extern "C" int blg_cost_positions(const void* pages, const void* in_sizes,
                                  const void* base_len, const void* base_dist,
                                  int P, int S, int N, const void* scratch,
                                  void* litq, void* cand_len, void* cand_dist,
                                  void* dpackq, void* stream) {
  if (P <= 0 || S <= 0) return 0;
  const dim3 grid((S + blg_cost::kPosThreads - 1) / blg_cost::kPosThreads, P);
  blg_cost::cost_positions_kernel<<<grid, blg_cost::kPosThreads, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(pages),
      static_cast<const int32_t*>(in_sizes),
      static_cast<const int32_t*>(base_len),
      static_cast<const int32_t*>(base_dist), S, N,
      static_cast<const int32_t*>(scratch), static_cast<int32_t*>(litq),
      static_cast<int32_t*>(cand_len), static_cast<int32_t*>(cand_dist),
      static_cast<int32_t*>(dpackq));
  return static_cast<int>(cudaGetLastError());
}

// Write unseen_q(t, pad) for t = 1..n into out[0..n).
extern "C" int blg_cost_unseen_check(int n, float pad, void* out,
                                     void* stream) {
  if (n <= 0) return 0;
  blg_cost::unseen_check_kernel<<<(n + 255) / 256, 256, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      n, pad, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
