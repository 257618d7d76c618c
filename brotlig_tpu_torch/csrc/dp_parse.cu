// Windowed-DP optimal parse: dp[p], the least half-bits that encode the
// first p bytes of a page, with the backpointer length packed below it.
//
// Replaces the XLA lax.scan of brotlig_tpu/ops/parse_dp.py:234-404
// (dp_parse), which has no Pallas kernel: on the TPU, XLA fused the scan
// body into one device loop. Plain version: ops/parse_dp.py::dp_parse_plain
// (the same scan as a Python loop of torch ops); wrapper:
// ops/dp_kernel.py::dp_parse_cuda.
//
// One thread block a page, the whole block loop inside the launch. The
// page's state lives in shared memory as a ring of RS = W + B nodes (node
// n at slot (n + W) % RS): the W-deep window of finished nodes and the B
// cells of the block being solved, each with its dp value, its anchor
// (the last command end on its best path) and its insert code, and the
// K candidates (length, packed distance cost) of each node's byte. B new
// positions enter the ring per block, over the slots of the B nodes that
// leave the window.
//
// Per block, once (the terms that do not depend on dp, which the JAX
// scan recomputes every round):
//   * the bucket-base edges: for target cell t and bucket base length L,
//     the cheapest distance + copy-extra term over the candidates at the
//     source node that reach L, and whether one of them hits ring 0 (the
//     minimum over the candidates of min(x + a_k, INF) is min(x + min a_k,
//     INF), so the per-candidate terms reduce to one per (t, L));
//   * the full-length edges that land in this block: each candidate whose
//     source lies in the window and whose end lies in the block, with its
//     copy code and its distance + copy-extra term, in a list.
// Per round (R a block), then once more at the end:
//   * the literal closure, one warp: the block's literal costs' prefix sum
//     (once a block) and a shuffle min-scan of the packed value
//     ((dp - prefix + 4096) << 6) | source cell, so the argmin's anchor
//     comes along;
//   * the relaxes, all warps, into a shared copy of the block's dp by
//     atomicMin on the packed int: a warp per target over the bucket bases
//     (a lane per base, __reduce_min_sync), a thread per listed full edge;
//     min does not depend on the order, so the result is deterministic;
//   * the anchor update: a target whose dp fell ends a command there.
// All arithmetic is int32: costs saturate at INF_Q < 2^21, so every packed
// value is below 2^31. An edge whose cost saturates can never win (its
// packed value exceeds INF_Q << 10, which bounds every dp value), so it
// is not relaxed at all.
//
// Bound, at 8 pages of 64 KiB (the encoder's q11 batch), one cost-model
// iteration: by operations, 8 pages x 32,768 rounds x ~1.2e5 int ops
// ~ 3e10 at ~3e13 int32 lane-ops/s ~ 1 ms; by bytes, 8 x 65,536 x 100 B
// ~ 52 MB ~ 0.016 ms. What holds it back is the chain: 2048 blocks x
// (R + 1) dependent rounds a page, each a few barriers and shared-memory
// round trips, and only P thread blocks on 132 SMs. It stays far from its
// bound; that is a later redesign's work.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace blg_dp {
namespace {

constexpr int kLenBits = 10;
constexpr int kInfQ = (1 << 21) - 1;
constexpr int kInfC = kInfQ << kLenBits;
constexpr int kThreads = 256;
constexpr int kMaxB = 64;
constexpr int kMaxLens = 24;
constexpr int kJoint = 24 * 24;
constexpr unsigned kFull = 0xffffffffu;

// the DP's bucket bases (the JAX module's CPY_BASE); a base's copy code is
// its index
#define BLG_DP_BUCKET_BASES                                                  \
  {2,   3,   4,   5,   6,   7,   8,   9,   10,  12,  14,  18,                \
   22,  30,  38,  54,  70,  102, 134, 198, 262, 390, 518, 774}
constexpr int kBucketHost[kMaxLens] = BLG_DP_BUCKET_BASES;
__constant__ int kBucket[kMaxLens] = BLG_DP_BUCKET_BASES;
// RFC 7932 insert and copy length code bases
__constant__ int kInsBase[24] = {0,   1,   2,   3,   4,    5,    6,    8,
                                 10,  14,  18,  26,  34,   50,   66,   98,
                                 130, 194, 322, 578, 1090, 2114, 6210, 22594};
__constant__ int kCpyBase[24] = {2,  3,  4,  5,   6,   7,   8,   9,
                                 10, 12, 14, 18,  22,  30,  38,  54,
                                 70, 102, 134, 198, 326, 582, 1094, 2118};

__device__ __forceinline__ int ins_code(int v) {
  int c = 0;
#pragma unroll
  for (int i = 1; i < 24; ++i) c += v >= kInsBase[i];
  return c;
}

__device__ __forceinline__ int cpy_code(int v) {
  int c = 0;
#pragma unroll
  for (int i = 1; i < 24; ++i) c += v >= kCpyBase[i];
  return c;
}

// extra-bit widths by code (ops/arith_lut.py), doubled: half-bits
__device__ __forceinline__ int insert_extra_q(int c) {
  int v = c < 6 ? 0 : ((c - 6) >> 1) + 1;
  if (c >= 16) v = c - 10;
  if (c == 21) v = 12;
  if (c == 22) v = 14;
  if (c == 23) v = 24;
  return 2 * v;
}

__device__ __forceinline__ int copy_extra_q(int c) {
  int v = c < 8 ? 0 : ((c - 8) >> 1) + 1;
  if (c >= 18) v = c - 12;
  if (c == 23) v = 24;
  return 2 * v;
}

// The shared-memory layout, in ints; the same arithmetic on both sides.
struct Layout {
  int rs, k;
  int ring_len, ring_dpk, dp, anch, ic, je, jl, bpair, dpn, nfull, full;
  int ints;

  __host__ __device__ Layout(int W, int B, int K) : rs(W + B), k(K) {
    ring_len = 0;
    ring_dpk = ring_len + rs * K;
    dp = ring_dpk + rs * K;
    anch = dp + rs;
    ic = anch + rs;
    je = ic + rs;
    jl = je + kJoint;
    bpair = jl + kJoint;
    dpn = bpair + kMaxB * kMaxLens;
    nfull = dpn + kMaxB;
    full = (nfull + 1 + 3) & ~3;  // int2 entries, 16-byte aligned
    ints = full + 2 * rs * K;
  }
};

// The literal closure of the block's cells, by warp 0: lane l owns cells l
// and l + 32. A cell takes the cheapest literal run from the seed node
// (the block's left neighbour) or from an earlier cell where that beats
// its dp, and inherits the run's source anchor.
__device__ __forceinline__ void closure(int* dp, int* anch, int s0, int W,
                                        int RS, int B, const int (&A)[2],
                                        int lane) {
  const int seed_slot = (s0 + W) % RS;
  const int seed = dp[seed_slot] >> kLenBits;
  const int seed_anch = anch[seed_slot];
  int c[2], key[2];
  int carry = INT_MAX, prev_last = seed;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = lane + 32 * h;
    const bool valid = t < B;
    c[h] = valid ? dp[(s0 + 1 + t + W) % RS] >> kLenBits : 0;
    const int m = c[h] - A[h];
    const int up = __shfl_up_sync(kFull, m, 1);
    const int srcm = lane == 0 ? prev_last : up;
    int k = valid ? ((srcm + 4096) << 6) | t : INT_MAX;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, k, d);
      if (lane >= d) k = min(k, v);
    }
    key[h] = min(k, carry);
    carry = __shfl_sync(kFull, key[h], 31);
    prev_last = __shfl_sync(kFull, m, 31);
  }
  int val[2], an[2];
  bool take[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = lane + 32 * h;
    const int litc = min((key[h] >> 6) - 4096 + A[h], kInfQ);
    take[h] = t < B && litc < c[h];
    const int w = key[h] & 63;
    val[h] = litc << kLenBits;
    an[h] = take[h] ? (w == 0 ? seed_anch : anch[(s0 + w + W) % RS]) : 0;
  }
  __syncwarp();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (take[h]) {
      const int slot = (s0 + 1 + lane + 32 * h + W) % RS;
      dp[slot] = val[h];
      anch[slot] = an[h];
    }
  }
  __syncwarp();
}

// The insert code of each block cell's pending insert (node - anchor), by
// warp 0.
__device__ __forceinline__ void block_ic(const int* anch, int* ic, int s0,
                                         int W, int RS, int B, int lane) {
  for (int t = lane; t < B; t += 32) {
    const int node = s0 + 1 + t;
    const int slot = (node + W) % RS;
    ic[slot] = ins_code(min(max(node - anch[slot], 0), 1 << 22));
  }
}

__global__ void __launch_bounds__(kThreads)
    dp_parse_kernel(const int32_t* __restrict__ litq,
                    const int32_t* __restrict__ cand_len,
                    const int32_t* __restrict__ dpackq,
                    const int32_t* __restrict__ joint_e,
                    const int32_t* __restrict__ joint_l, int S, int K, int B,
                    int W, int R, int nL, int32_t* __restrict__ out) {
  extern __shared__ __align__(16) int smem[];
  const Layout lay(W, B, K);
  const int RS = lay.rs;
  int* ring_len = smem + lay.ring_len;
  int* ring_dpk = smem + lay.ring_dpk;
  int* dp = smem + lay.dp;
  int* anch = smem + lay.anch;
  int* ic = smem + lay.ic;
  int* je = smem + lay.je;
  int* jl = smem + lay.jl;
  int* bpair = smem + lay.bpair;
  int* dpn = smem + lay.dpn;
  int* nfull = smem + lay.nfull;
  int2* full = reinterpret_cast<int2*>(smem + lay.full);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = kThreads / 32;
  const size_t row = static_cast<size_t>(blockIdx.x) * S;
  const int32_t* cl = cand_len + row * K;
  const int32_t* dk = dpackq + row * K;
  const int32_t* lq = litq + row;
  int32_t* o = out + row;
  // lane l's bucket base and its copy-extra half-bits (warp relax)
  const int my_len = lane < nL ? kBucket[lane] : 0;
  const int my_cpyx = copy_extra_q(lane < 24 ? lane : 0);

  for (int i = tid; i < kJoint; i += kThreads) {
    je[i] = joint_e[blockIdx.x * kJoint + i];
    jl[i] = joint_l[blockIdx.x * kJoint + i];
  }
  // the first window: nodes 1-W..0 (node 0 costs 0, the rest are out of
  // reach), and the candidates of bytes 1-W..B (padding outside the page)
  for (int i = tid; i < RS * K; i += kThreads) {
    const int j = i / K;
    const int node = j + 1 - W;
    const int slot = (j + 1) % RS;
    const bool in = node >= 0 && node < S;
    const size_t at = static_cast<size_t>(node) * K + (i - j * K);
    ring_len[slot * K + i - j * K] = in ? cl[at] : 0;
    ring_dpk[slot * K + i - j * K] = in ? dk[at] : kInfQ << 1;
  }
  for (int j = tid; j < W; j += kThreads) {
    const int node = j + 1 - W;
    dp[j + 1] = node == 0 ? 0 : kInfC;
    anch[j + 1] = 0;
    ic[j + 1] = ins_code(max(node, 0));
  }
  __syncthreads();

  int A[2] = {0, 0};  // warp 0: the block's literal prefix sums
  for (int s0 = 0; s0 < S; s0 += B) {
    // ---- the block's cells enter the ring ----
    if (s0 > 0) {
      for (int i = tid; i < B * K; i += kThreads) {
        const int t = i / K;
        const int node = s0 + 1 + t;
        const int slot = (node + W) % RS;
        const bool in = node < S;
        const size_t at = static_cast<size_t>(node) * K + (i - t * K);
        ring_len[slot * K + i - t * K] = in ? cl[at] : 0;
        ring_dpk[slot * K + i - t * K] = in ? dk[at] : kInfQ << 1;
      }
    }
    for (int t = tid; t < B; t += kThreads) {
      const int slot = (s0 + 1 + t + W) % RS;
      dp[slot] = kInfC;
      anch[slot] = 0;
    }
    if (tid == 0) *nfull = 0;
    if (warp == 0) {
      int run = 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = lane + 32 * h;
        int v = t < B ? lq[s0 + t] : 0;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int u = __shfl_up_sync(kFull, v, d);
          if (lane >= d) v += u;
        }
        A[h] = v + run;
        run = __shfl_sync(kFull, A[h], 31);
      }
    }
    __syncthreads();

    // ---- the dp-free edge terms of this block ----
    for (int i = tid; i < B * nL; i += kThreads) {
      const int t = i / nL;
      const int l = i - t * nL;
      const int L = kBucket[l];
      const int slot = (s0 + 1 + t - L + W) % RS;
      const int cpyx = copy_extra_q(l);
      int best = kInfQ, r0 = 0;
      bool any = false;
      for (int k = 0; k < K; ++k) {
        if (ring_len[slot * K + k] >= L) {
          const int d = ring_dpk[slot * K + k];
          best = min(best, min((d >> 1) + cpyx, kInfQ));
          r0 |= d & 1;
          any = true;
        }
      }
      bpair[t * kMaxLens + l] = any ? (best << 1) | r0 : -1;
    }
    for (int base = 0; base < RS * K; base += kThreads) {
      const int i = base + tid;
      int L = 0, t = 0, slot = 0, k = 0;
      bool ok = false;
      if (i < RS * K) {
        const int j = i / K;  // window cell: node s0 + 1 + j - W
        k = i - j * K;
        slot = (s0 + 1 + j) % RS;
        L = ring_len[slot * K + k];
        t = j + L - W;
        ok = L >= 2 && t >= 0 && t < B;
      }
      const unsigned m = __ballot_sync(kFull, ok);
      int first = 0;
      if (lane == 0 && m) first = atomicAdd(nfull, __popc(m));
      first = __shfl_sync(kFull, first, 0);
      if (ok) {
        const int d = ring_dpk[slot * K + k];
        const int cc = cpy_code(L);
        const int rest = min((d >> 1) + copy_extra_q(cc), kInfQ);
        full[first + __popc(m & ((1u << lane) - 1u))] =
            make_int2(slot | (L << 11) | (t << 22),
                      rest | (cc << 21) | ((d & 1) << 26));
      }
    }
    __syncthreads();
    const int nf = *nfull;

    // ---- R rounds: closure, relax, anchors ----
    for (int r = 0; r < R; ++r) {
      if (warp == 0) {
        closure(dp, anch, s0, W, RS, B, A, lane);
        block_ic(anch, ic, s0, W, RS, B, lane);
        for (int t = lane; t < B; t += 32) dpn[t] = dp[(s0 + 1 + t + W) % RS];
      }
      __syncthreads();

      for (int t = warp; t < B; t += nwarps) {
        int comb = INT_MAX;
        const int bp = lane < nL ? bpair[t * kMaxLens + lane] : -1;
        if (bp >= 0) {
          const int slot = (s0 + 1 + t - my_len + W) % RS;
          const int c = ic[slot];
          const int head = (dp[slot] >> kLenBits) + insert_extra_q(c);
          const int j = c * 24 + lane;
          int tot = min(head + je[j] + (bp >> 1), kInfQ);
          if (bp & 1) tot = min(tot, min(head + jl[j] + my_cpyx, kInfQ));
          if (tot < kInfQ) comb = (tot << kLenBits) | my_len;
        }
        comb = __reduce_min_sync(kFull, comb);
        if (lane == 0 && comb != INT_MAX) atomicMin(&dpn[t], comb);
      }
      for (int i = tid; i < nf; i += kThreads) {
        const int2 e = full[i];
        const int slot = e.x & 2047;
        const int L = (e.x >> 11) & 2047;
        const int t = e.x >> 22;
        const int rest = e.y & kInfQ;
        const int cc = (e.y >> 21) & 31;
        const int c = ic[slot];
        const int head = (dp[slot] >> kLenBits) + insert_extra_q(c);
        const int j = c * 24 + cc;
        int f = min(head + je[j] + rest, kInfQ);
        if (e.y >> 26) f = min(f, min(head + jl[j] + copy_extra_q(cc), kInfQ));
        if (f < kInfQ) atomicMin(&dpn[t], (f << kLenBits) | L);
      }
      __syncthreads();

      if (warp == 0) {
        for (int t = lane; t < B; t += 32) {
          const int slot = (s0 + 1 + t + W) % RS;
          if (dpn[t] < dp[slot]) {
            dp[slot] = dpn[t];
            anch[slot] = s0 + 1 + t;
          }
        }
        __syncwarp();
      }
    }

    // ---- the final closure; the cells join the window ----
    if (warp == 0) {
      closure(dp, anch, s0, W, RS, B, A, lane);
      block_ic(anch, ic, s0, W, RS, B, lane);
      for (int t = lane; t < B; t += 32) o[s0 + t] = dp[(s0 + 1 + t + W) % RS];
    }
    __syncthreads();
  }
}

}  // namespace
}  // namespace blg_dp

// litq: [P, S] int32; cand_len, dpackq: [P, S, K] int32; joint_e, joint_l:
// [P, 576] int32 (ops/parse_dp.py::build_cost_model); B, W, R: block,
// window and rounds (S % B == 0, W % B == 0, W < 1024, B <= 63, checked
// by the wrapper); out: [P, S] int32, column p-1 = (dp[p] << 10) |
// from_len. Returns the launch's cudaGetLastError() (or the error of
// raising the kernel's shared-memory limit).
extern "C" int blg_dp_parse(const void* litq, const void* cand_len,
                            const void* dpackq, const void* joint_e,
                            const void* joint_l, int P, int S, int K, int B,
                            int W, int R, void* out, void* stream) {
  if (P <= 0) return 0;
  int nL = 0;
  for (int b : blg_dp::kBucketHost) nL += b <= W;
  const size_t smem = sizeof(int) * blg_dp::Layout(W, B, K).ints;
  const cudaError_t e = cudaFuncSetAttribute(
      blg_dp::dp_parse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  blg_dp::dp_parse_kernel<<<P, blg_dp::kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(litq), static_cast<const int32_t*>(cand_len),
      static_cast<const int32_t*>(dpackq),
      static_cast<const int32_t*>(joint_e),
      static_cast<const int32_t*>(joint_l), S, K, B, W, R, nL,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
