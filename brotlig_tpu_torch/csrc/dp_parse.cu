// Windowed-DP optimal parse: dp[p], the least half-bits that encode the
// first p bytes of a page, with the backpointer length packed below it.
//
// Replaces the XLA lax.scan of brotlig_tpu/ops/parse_dp.py:234-404
// (dp_parse), which has no Pallas kernel: on the TPU, XLA fused the scan
// body into one device loop. Plain version: ops/parse_dp.py::dp_parse_plain
// (the same scan as a Python loop of torch ops); wrapper:
// ops/dp_kernel.py::dp_parse_cuda. The schedule below is rendered in torch
// by tests/test_torch_dp_rounds.py::dp_parse_rounds.
//
// What bounds it on this card: the chain. A page is S / B blocks, each a
// sequence of dependent rounds (literal closure, match relaxes, anchor
// update) that no other page's work can shorten; the bytes it moves (one
// read of the candidates, one write of dp) take microseconds, and a batch
// of P pages occupies P of the 132 SMs. The design shortens each block's
// chain:
//   * rounds that stop at their fixed point: a round is a deterministic map
//     of the block's (dp, anchor) state and dp values only fall, so a round
//     in which no dp value fell (no closure take, no relax win) leaves the
//     state as it found it, and every later round and the final closure
//     would too. A block leaves its loop after that round; otherwise after
//     R rounds, and then runs the final closure;
//   * warp specialisation: two consumer warps run the rounds, warp 0 with
//     the block's cells in registers (lane l owns cells l and l + 32) for
//     the closure, the insert codes and the anchor update, both for the
//     relaxes, with two barriers of their own a round; ten producer warps
//     build block k + 1's dp-free terms into the second of two shared
//     buffers while the consumers run block k. Named barriers pass the
//     buffers (one "full" and one "empty" per buffer), so the consumers
//     never wait on the producers inside a block;
//   * the window's edges off the chain. Edges from a source before the
//     block have fixed costs while the block runs (the source's dp and
//     insert code are final) and cannot win after the block's first round
//     (dp only falls), so the first round relaxes them and later rounds
//     relax only the edges whose source is a cell of the block. Sources
//     older than the previous block are final when the producers build a
//     block (they wait for the buffer, so for the block before the
//     previous one to end): the producers reduce those edges to one packed
//     minimum a cell (M). The consumer's first round relaxes the previous
//     block's edges from a list; later rounds the block's own;
//   * each edge, bucket base or full length, is one int2 of dp-free terms
//     (source slot, target, length, distance + copy-extra half-bits, copy
//     code, no-ring-0 flag); the relax reads the source's head cost (dp +
//     insert-extra half-bits) and its insert code's joint-table row, both
//     kept per ring slot, branch-free, and takes the minimum by atomicMin
//     on the packed int, whose result does not depend on the order. A
//     full-length edge whose length is one of the first 20 bucket bases is
//     dominated by that bucket edge (same source, target, tag and joint
//     symbol; a distance term that is a minimum over a superset) and is
//     not listed;
//   * no division in the consumers' indexing: the block's cells sit at
//     consecutive ring slots (node n at slot (n + W - 1) mod RS, RS = W +
//     B), and the insert code is a closed form (ins_code), not 23
//     compares.
// The producers also read block k + 1's candidates and literal costs from
// device memory into registers as soon as its buffer is free, and write
// them into the ring once block k's terms are built: the rounds never read
// candidates, so the slots of the cells that leave the window are free
// then.
//
// What bounds it now: the producers' per-block passes (a scan of K
// candidates for each of the B x nL bucket-base edges, the full-length
// scan of the window, their barrier), which the consumers' rounds only
// just outrun; both sides are latency-bound on shared memory, with one
// thread block, twelve warps, an SM.
//
// All arithmetic is int32: costs saturate at INF_Q < 2^21, so every packed
// value is below 2^31. An edge whose cost saturates can never win (its
// packed value exceeds INF_Q << 10, which bounds every dp value), so
// relaxing it changes nothing.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace blg_dp {
namespace {

constexpr int kLenBits = 10;
constexpr int kInfQ = (1 << 21) - 1;
constexpr int kInfC = kInfQ << kLenBits;
constexpr int kConsumers = 64;              // warps 0 and 1
constexpr int kProducers = 320;             // warps 2 to 11
constexpr int kThreads = kConsumers + kProducers;
constexpr int kMaxB = 64;
constexpr int kMaxLens = 24;
constexpr int kJoint = 24 * 24;
constexpr unsigned kFull = 0xffffffffu;
// named barriers (0 is __syncthreads'): buffer b's terms are ready
// (kFullBar + b), buffer b is free again (kEmptyBar + b), the producer
// warps among themselves, and the two consumer warps
constexpr int kFullBar = 1;
constexpr int kEmptyBar = 3;
constexpr int kProdBar = 5;
constexpr int kConsBar = 6;

// the DP's bucket bases (the JAX module's CPY_BASE); a base's copy code is
// its index
#define BLG_DP_BUCKET_BASES                                                  \
  {2,   3,   4,   5,   6,   7,   8,   9,   10,  12,  14,  18,                \
   22,  30,  38,  54,  70,  102, 134, 198, 262, 390, 518, 774}
constexpr int kBucketHost[kMaxLens] = BLG_DP_BUCKET_BASES;
__constant__ int kBucket[kMaxLens] = BLG_DP_BUCKET_BASES;
// RFC 7932 copy length code bases
__constant__ int kCpyBase[24] = {2,  3,  4,  5,   6,   7,   8,   9,
                                 10, 12, 14, 18,  22,  30,  38,  54,
                                 70, 102, 134, 198, 326, 582, 1094, 2118};

// The insert code of 0 <= v <= 2^22 (the last RFC 7932 insert base <= v):
// v below 6; up to 257 two codes per power of two of v - 2; from 258 on,
// 17 plus the bases from 322 on that v reaches.
__device__ __forceinline__ int ins_code(int v) {
  const int x = max(v - 2, 4);
  const int nb = 31 - __clz(x);
  const int mid = 2 * nb + ((x >> (nb - 1)) & 1) + 2;
  const int big = 17 + (v >= 322) + (v >= 578) + (v >= 1090) + (v >= 2114) +
                  (v >= 6210) + (v >= 22594);
  return v < 6 ? v : (v < 258 ? mid : big);
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

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// The shared-memory layout, in ints; the same arithmetic on both sides.
// Per ring slot: the K candidates (candidate-major), the longest
// candidate, the head cost and the insert code's joint-table row. The
// joint tables, the consumers' relax targets, the next block's literal
// costs and the consumers' loop flag. Per buffer: the literal prefix sums
// A, the packed minimum M of the old window's edges, the list count (the
// previous block's edges in its low 16 bits, the block's own in its high
// 16) and the edge list (the previous block's edges from the front, the
// block's own from the back).
struct Layout {
  int rs, cap;
  int ring_len, ring_dpk, maxl, head, rowic, je, jlx, dpn, lit, go, buf;
  int buf_ints, ints;

  __host__ __device__ Layout(int W, int B, int K, int nL)
      : rs(W + B), cap(B * nL + 2 * B * K) {
    ring_len = 0;
    ring_dpk = ring_len + K * rs;
    maxl = ring_dpk + K * rs;
    head = maxl + rs;
    rowic = head + rs;
    je = rowic + rs;
    jlx = je + kJoint;
    dpn = jlx + kJoint;
    lit = dpn + kMaxB;
    go = lit + kMaxB;
    buf = (go + 1 + 3) & ~3;                   // 16-byte aligned
    buf_ints = 2 * kMaxB + 4 + 2 * cap;        // even: lists stay 8-aligned
    ints = buf + 2 * buf_ints;
  }
};

struct Smem {
  int* ring_len;
  int* ring_dpk;
  int* maxl;
  int* head;
  int* rowic;
  int* je;
  int* jlx;
  int* dpn;
  int* lit;
  int* go;  // the consumers' loop flag
  int* buf;
  int buf_ints, cap, rs;

  __device__ int* A(int b) const { return buf + b * buf_ints; }
  __device__ int* M(int b) const { return A(b) + kMaxB; }
  __device__ int* cnt(int b) const { return A(b) + 2 * kMaxB; }
  __device__ int2* list(int b) const {
    return reinterpret_cast<int2*>(A(b) + 2 * kMaxB + 4);
  }
};

// An edge's dp-free terms: x = source slot | target cell << 11 | length
// << 17; y = distance + copy-extra half-bits (saturated) | copy code << 21
// | no-ring-0 flag << 26.
__device__ __forceinline__ int2 edge(int slot, int L, int t, int rest,
                                     int cc, int r0) {
  return make_int2(slot | (t << 11) | (L << 17),
                   rest | (cc << 21) | ((r0 ^ 1) << 26));
}

__device__ __forceinline__ int edge_target(int2 e) { return (e.x >> 11) & 63; }

// The packed relax value of an edge, from its source's head cost and
// joint-table row, branch-free: the implicit-ring0 form (jlx: its joint
// symbol and copy extra bits) costs INF_Q more where no candidate hits
// ring 0. A value whose cost saturates is (INF_Q << 10) | length, above
// every dp value, so relaxing it changes nothing.
__device__ __forceinline__ int edge_value(int2 e, const Smem& sm) {
  const int slot = e.x & 2047;
  const int h = sm.head[slot];
  const int j = sm.rowic[slot] + ((e.y >> 21) & 31);
  const int f = min(min(h + sm.je[j] + (e.y & kInfQ),
                        h + sm.jlx[j] + (e.y >> 26) * kInfQ),
                    kInfQ);
  return (f << kLenBits) | (e.x >> 17);
}

// Whether a full-length edge of length L is dominated by the bucket-base
// edge of the same source: L is one of the first 20 bases (whose index is
// their RFC 7932 copy code) and within the window. The two share target,
// length tag and joint symbol; the bucket edge's distance term is the
// minimum over a superset of candidates and its ring-0 flag their OR, so
// the full edge can never win where the bucket edge did not.
__device__ __forceinline__ bool dominated(int L, int W) {
  bool base = L <= 10;
#pragma unroll
  for (int i = 9; i < 20; ++i) base |= L == kBucket[i];
  return base && L <= W;
}

// The list slots of a warp's edges, n of them on this lane, all from the
// previous block (own false: from the front of buffer b's list) or all
// from the block's own cells (own: from the back); one atomicAdd a warp on
// the buffer's count (the previous block's edges in its low 16 bits, the
// block's own in its high 16). Returns this lane's first slot as a count
// (front or back, by own).
__device__ __forceinline__ int claim(const Smem& sm, int b, int n, bool own,
                                     int lane) {
  const int v = own ? n << 16 : n;
  int incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int x = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += x;
  }
  const int total = __shfl_sync(kFull, incl, 31);
  int base = 0;
  if (lane == 0 && total) base = atomicAdd(sm.cnt(b), total);
  const int at = __shfl_sync(kFull, base, 0) + incl - v;
  return own ? at >> 16 : at & 0xffff;
}

__device__ __forceinline__ void put(const Smem& sm, int b, bool own, int at,
                                    int2 e) {
  sm.list(b)[own ? sm.cap - 1 - at : at] = e;
}

// An edge from an old source (before the previous block): relaxed into M
// now, its source's head cost and insert code being final.
__device__ __forceinline__ void relax_old(const Smem& sm, int b, int2 e) {
  atomicMin(&sm.M(b)[edge_target(e)], edge_value(e, sm));
}

// Block k + 1's candidates and literal costs, read from device memory into
// registers while block k's terms are built (nodes s0 + B + 1 on; padding
// outside the page): element i = ptid + kProducers * j of the block's B x
// K (node-major, as in device memory), at most kPrefetch of them a thread.
constexpr int kPrefetch = (kMaxB * 32 + kProducers - 1) / kProducers;

struct Prefetch {
  int len[kPrefetch], dpk[kPrefetch], lit;
};

__device__ __forceinline__ void prefetch(Prefetch& pf, const int32_t* cl,
                                         const int32_t* dk, const int32_t* lq,
                                         int s0, int S, int K, int B,
                                         int ptid) {
  const size_t at0 = static_cast<size_t>(s0 + B + 1) * K;
  const int in = min(S - (s0 + B + 1), B) * K;  // elements inside the page
#pragma unroll
  for (int j = 0; j < kPrefetch; ++j) {
    const int i = ptid + kProducers * j;
    pf.len[j] = i < in ? cl[at0 + i] : 0;
    pf.dpk[j] = i < in ? dk[at0 + i] : kInfQ << 1;
  }
  pf.lit = ptid < B ? lq[s0 + B + ptid] : 0;
}

// The prefetched block into the ring slots cs.. (candidate-major) and the
// literal costs; then, after a producer barrier, each cell's longest
// candidate.
__device__ __forceinline__ void unload(const Smem& sm, const Prefetch& pf,
                                       int cs, int K, int B, int ptid) {
  const int RS = sm.rs;
#pragma unroll
  for (int j = 0; j < kPrefetch; ++j) {
    const int i = ptid + kProducers * j;
    if (i < B * K) {
      const int t = i / K;
      const int at = (i - t * K) * RS + cs + t;
      sm.ring_len[at] = pf.len[j];
      sm.ring_dpk[at] = pf.dpk[j];
    }
  }
  if (ptid < B) sm.lit[ptid] = pf.lit;
  bar_sync(kProdBar, kProducers);
  for (int t = ptid; t < B; t += kProducers) {
    int m = 0;
    for (int c = 0; c < K; ++c) m = max(m, sm.ring_len[c * RS + cs + t]);
    sm.maxl[cs + t] = m;
  }
}

// The producer warps: for each block k, once its buffer is free, block k +
// 1's candidates and literal costs are read into registers; block k's
// literal prefix sums, its bucket-base and full-length edges (old ones
// into M, the rest listed) are built and handed to the consumers; then
// block k + 1's candidates go into the ring, over the cells that leave
// the window.
__device__ void produce(const Smem& sm, const int32_t* cl, const int32_t* dk,
                        const int32_t* lq, int S, int K, int B, int W,
                        int nL) {
  const int ptid = threadIdx.x - kConsumers;
  const int lane = ptid & 31;
  const int pwarp = ptid >> 5;
  const int RS = sm.rs;
  const int nb = S / B;
  int ws = 0;  // slot of the window's first node, s0 + 1 - W
  int cs = W;  // slot of the block's first cell, s0 + 1
  for (int k = 0; k < nb; ++k) {
    const int s0 = k * B;
    const int b = k & 1;
    if (k >= 2) bar_sync(kEmptyBar + b, kThreads);
    Prefetch pf;
    if (k + 1 < nb) prefetch(pf, cl, dk, lq, s0, S, K, B, ptid);

    for (int t = ptid; t < B; t += kProducers) sm.M(b)[t] = INT_MAX;
    if (ptid == 0) sm.cnt(b)[0] = 0;
    if (pwarp == 0) {
      const int* lit = sm.lit;
      int run = 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = lane + 32 * h;
        int v = t < B ? lit[t] : 0;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int u = __shfl_up_sync(kFull, v, d);
          if (lane >= d) v += u;
        }
        if (t < B) sm.A(b)[t] = v + run;
        run = __shfl_sync(kFull, v + run, 31);
      }
    }
    bar_sync(kProdBar, kProducers);

    for (int i0 = pwarp * 32; i0 < B * nL; i0 += kProducers) {
      // bucket-base edges: cell t from source cell u = t - L, the
      // cheapest candidate there that reaches L (min_k min(x + a_k, INF)
      // = min(x + min_k a_k, INF)) and whether one of them hits ring 0;
      // candidates four at a time, their loads issued together
      const int i = i0 + lane;
      const bool valid = i < B * nL;
      const int l = valid ? i / B : 0;
      const int t = valid ? i - l * B : 0;
      const int L = kBucket[l];
      const int u = t - L;
      const int slot = cs + u < 0 ? cs + u + RS : cs + u;
      const int cpyx = copy_extra_q(l);
      int best = kInfQ, r0 = 0;
      bool any = false;
      if (valid && sm.maxl[slot] >= L) {
        for (int c0 = 0; c0 < K; c0 += 4) {
          int len[4], d[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int c = min(c0 + q, K - 1);
            len[q] = c0 + q < K ? sm.ring_len[c * RS + slot] : 0;
            d[q] = sm.ring_dpk[c * RS + slot];
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (len[q] >= L) {
              best = min(best, min((d[q] >> 1) + cpyx, kInfQ));
              r0 |= d[q] & 1;
              any = true;
            }
          }
        }
      }
      const int2 e = edge(slot, L, t, best, l, r0);
      if (any && u < -B) relax_old(sm, b, e);
      const bool keep = any && u >= -B;
      const int at = claim(sm, b, keep, u >= 0, lane);
      if (keep) put(sm, b, u >= 0, at, e);
    }
    const int nsrc = W + B - 1;
    for (int j0 = pwarp * 32; j0 < nsrc; j0 += kProducers) {
      // full-length edges: each candidate of a source node u (window
      // cells and the block's own) whose end lands in the block and that
      // no bucket-base edge dominates; a lane a node, its landing
      // candidates as a bit mask, one slot claim a warp
      const int j = j0 + lane;
      const int u = j - W;
      const int slot = ws + j >= RS ? ws + j - RS : ws + j;
      const bool reach = j < nsrc && sm.maxl[slot] >= max(2, -u);
      if (!__any_sync(kFull, reach)) continue;
      unsigned lands = 0;
      if (reach) {
        for (int c = 0; c < K; ++c) {
          const int L = sm.ring_len[c * RS + slot];
          if (L >= 2 && u + L >= 0 && u + L < B && !dominated(L, W))
            lands |= 1u << c;
        }
      }
      const bool old = u < -B;
      const int at = claim(sm, b, old ? 0 : __popc(lands), u >= 0, lane);
      for (int n = 0; lands; lands &= lands - 1, ++n) {
        const int c = __ffs(lands) - 1;
        const int L = sm.ring_len[c * RS + slot];
        const int d = sm.ring_dpk[c * RS + slot];
        const int cc = cpy_code(L);
        const int2 e = edge(slot, L, u + L, min((d >> 1) + copy_extra_q(cc),
                                                kInfQ), cc, d & 1);
        if (old)
          relax_old(sm, b, e);
        else
          put(sm, b, u >= 0, at + n, e);
      }
    }
    bar_sync(kProdBar, kProducers);
    bar_arrive(kFullBar + b, kThreads);

    // block k + 1's candidates into the slots of the cells that leave the
    // window (the rounds never read candidates)
    const int cs1 = cs + B >= RS ? cs + B - RS : cs + B;
    if (k + 1 < nb) unload(sm, pf, cs1, K, B, ptid);
    ws = ws + B >= RS ? ws + B - RS : ws + B;
    cs = cs1;
  }
  for (int k = max(nb - 2, 0); k < nb; ++k)
    bar_sync(kEmptyBar + (k & 1), kThreads);
}

// The literal closure of the block's cells, in the consumer's registers
// (lane l owns cells l and l + 32): a cell takes the cheapest literal run
// from the seed node (the block's left neighbour) or from an earlier cell
// where that beats its dp, and inherits the run's source anchor. Returns
// whether this lane's cells took one.
template <int H>
__device__ __forceinline__ bool closure(int (&dp)[2], int (&an)[2],
                                        const int (&a)[2], int seed,
                                        int seed_anch, int B, int lane) {
  int c[2], key[2];
  int carry = INT_MAX, prev_last = seed;
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const int t = lane + 32 * h;
    c[h] = dp[h] >> kLenBits;
    const int m = c[h] - a[h];
    const int up = __shfl_up_sync(kFull, m, 1);
    const int srcm = lane == 0 ? prev_last : up;
    int k = t < B ? ((srcm + 4096) << 6) | t : INT_MAX;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, k, d);
      if (lane >= d) k = min(k, v);
    }
    key[h] = min(k, carry);
    carry = __shfl_sync(kFull, key[h], 31);
    prev_last = __shfl_sync(kFull, m, 31);
  }
  int nd[2], na[2];
  bool took = false;
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const int t = lane + 32 * h;
    const int litc = min((key[h] >> 6) - 4096 + a[h], kInfQ);
    const int w = key[h] & 63;  // 0: the seed; else cell w - 1
    const int a0 = __shfl_sync(kFull, an[0], (w - 1) & 31);
    const int a1 = H > 1 ? __shfl_sync(kFull, an[1], (w - 1) & 31) : 0;
    const bool take = t < B && litc < c[h];
    nd[h] = take ? litc << kLenBits : dp[h];
    na[h] = take ? (w == 0 ? seed_anch : (w > 32 ? a1 : a0)) : an[h];
    took |= take;
  }
#pragma unroll
  for (int h = 0; h < H; ++h) {
    dp[h] = nd[h];
    an[h] = na[h];
  }
  return took;
}

// The head cost and joint-table row of the block's cells, for the relaxes
// that read them as sources (and the producers, once the block is old).
template <int H>
__device__ __forceinline__ void publish(const Smem& sm, const int (&dp)[2],
                                        const int (&an)[2], int s0, int cs,
                                        int B, int insx, int lane) {
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const int t = lane + 32 * h;
    const int ic = ins_code(min(max(s0 + 1 + t - an[h], 0), 1 << 22));
    const int x = __shfl_sync(kFull, insx, ic);
    if (t < B) {
      sm.head[cs + t] = (dp[h] >> kLenBits) + x;
      sm.rowic[cs + t] = ic * 24;
    }
  }
}

// The relaxes of list[from, to) into dpn, spread over the consumer
// threads, kBatch edges a thread at a time: their loads are issued before
// the atomics, which the compiler may not move loads across. Past the end,
// an edge whose cost saturates.
constexpr int kBatch = 8;

__device__ __forceinline__ void relax(const Smem& sm, const int2* list,
                                      int from, int to, int ct) {
  for (int i0 = from + ct; i0 < to; i0 += kBatch * kConsumers) {
    int2 e[kBatch];
    int v[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q)
      e[q] = i0 + kConsumers * q < to ? list[i0 + kConsumers * q]
                                      : make_int2(0, kInfQ | 1 << 26);
#pragma unroll
    for (int q = 0; q < kBatch; ++q) v[q] = edge_value(e[q], sm);
#pragma unroll
    for (int q = 0; q < kBatch; ++q)
      atomicMin(&sm.dpn[edge_target(e[q])], v[q]);
  }
}

// The consumer warps: each block's rounds, until a round in which no dp
// value fell or R rounds; then the final closure where the block did not
// stop, and its dp values out. Warp 0 holds the cells (closure, insert
// codes, anchor update); both warps relax.
template <int H>
__device__ void consume(const Smem& sm, int32_t* o, int S, int B, int W,
                        int R, int32_t* rounds) {
  const int ct = threadIdx.x;
  const int lane = ct & 31;
  const bool cells = ct < 32;
  const int RS = sm.rs;
  const int nb = S / B;
  const int insx = insert_extra_q(lane < 24 ? lane : 0);
  int seed = 0, seed_anch = 0;  // node 0: dp 0, anchor 0
  int ran = 0;
  int cs = W;
  for (int k = 0; k < nb; ++k) {
    const int s0 = k * B;
    const int b = k & 1;
    bar_sync(kFullBar + b, kThreads);
    const int np = sm.cnt(b)[0] & 0xffff;
    const int ni = sm.cnt(b)[0] >> 16;
    const int2* list = sm.list(b);
    int a[2], dp[2], an[2], mo[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = lane + 32 * h;
      a[h] = h < H && t < B ? sm.A(b)[t] : 0;
      mo[h] = h < H && t < B ? sm.M(b)[t] : INT_MAX;
      dp[h] = kInfC;
      an[h] = 0;
    }
    bool live = true;
    bool fell = false;
    int r = 0;
    for (;; ++r) {
      // warp 0: the closure and the sources' terms, or the end of the loop
      if (cells) {
        const bool go = r < R && live;
        if (go) {
          fell = closure<H>(dp, an, a, seed, seed_anch, B, lane);
          publish<H>(sm, dp, an, s0, cs, B, insx, lane);
#pragma unroll
          for (int h = 0; h < H; ++h) {
            const int t = lane + 32 * h;
            if (t < B) sm.dpn[t] = r == 0 ? min(dp[h], mo[h]) : dp[h];
          }
        }
        if (lane == 0) *sm.go = go;
      }
      bar_sync(kConsBar, kConsumers);
      if (!*sm.go) break;
      if (r == 0) relax(sm, list, 0, np, ct);
      relax(sm, list, sm.cap - ni, sm.cap, ct);
      bar_sync(kConsBar, kConsumers);
      if (cells) {
#pragma unroll
        for (int h = 0; h < H; ++h) {
          const int t = lane + 32 * h;
          const int v = t < B ? sm.dpn[t] : INT_MAX;
          if (v < dp[h]) {
            dp[h] = v;
            an[h] = s0 + 1 + t;
            fell = true;
          }
        }
        live = __any_sync(kFull, fell);
      }
    }
    ran += r;
    if (cells) {
      if (live) {
        closure<H>(dp, an, a, seed, seed_anch, B, lane);
        publish<H>(sm, dp, an, s0, cs, B, insx, lane);
      }
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const int t = lane + 32 * h;
        if (t < B) o[s0 + t] = dp[h];
      }
      // the next block's seed, cell B - 1 (H is 2 exactly where B > 32)
      seed = __shfl_sync(kFull, dp[H - 1], (B - 1) & 31) >> kLenBits;
      seed_anch = __shfl_sync(kFull, an[H - 1], (B - 1) & 31);
    }
    bar_arrive(kEmptyBar + b, kThreads);
    cs = cs + B >= RS ? cs + B - RS : cs + B;
  }
  if (ct == 0 && rounds != nullptr) rounds[blockIdx.x] = ran;
}

template <int H>
__global__ void __launch_bounds__(kThreads, 1)
    dp_parse_kernel(const int32_t* __restrict__ litq,
                    const int32_t* __restrict__ cand_len,
                    const int32_t* __restrict__ dpackq,
                    const int32_t* __restrict__ joint_e,
                    const int32_t* __restrict__ joint_l, int S, int K, int B,
                    int W, int R, int nL, int32_t* __restrict__ out,
                    int32_t* __restrict__ rounds) {
  extern __shared__ __align__(16) int smem[];
  const Layout lay(W, B, K, nL);
  const int RS = lay.rs;
  const Smem sm{smem + lay.ring_len, smem + lay.ring_dpk, smem + lay.maxl,
                smem + lay.head,     smem + lay.rowic,    smem + lay.je,
                smem + lay.jlx,      smem + lay.dpn,      smem + lay.lit,
                smem + lay.go,       smem + lay.buf,      lay.buf_ints,
                lay.cap,             RS};
  const int tid = threadIdx.x;
  const size_t row = static_cast<size_t>(blockIdx.x) * S;
  const int32_t* cl = cand_len + row * K;
  const int32_t* dk = dpackq + row * K;
  const int32_t* lq = litq + row;

  for (int i = tid; i < kJoint; i += kThreads) {
    sm.je[i] = joint_e[blockIdx.x * kJoint + i];
    sm.jlx[i] = joint_l[blockIdx.x * kJoint + i] + copy_extra_q(i % 24);
  }
  // the first window and block 0: nodes 1-W..B at slots 0..RS-1 (node 0
  // costs 0, the rest before it are out of reach, insert code 0), with the
  // candidates of their bytes (padding outside the page); and block 0's
  // literal costs
  for (int i = tid; i < RS * K; i += kThreads) {
    const int j = i / K;
    const int c = i - j * K;
    const int node = j + 1 - W;
    const bool in = node >= 0 && node < S;
    const size_t at = static_cast<size_t>(node) * K + c;
    sm.ring_len[c * RS + j] = in ? cl[at] : 0;
    sm.ring_dpk[c * RS + j] = in ? dk[at] : kInfQ << 1;
  }
  for (int j = tid; j < RS; j += kThreads) {
    sm.head[j] = j + 1 - W == 0 ? 0 : kInfQ;
    sm.rowic[j] = 0;
  }
  for (int t = tid; t < B; t += kThreads) sm.lit[t] = lq[t];
  __syncthreads();
  for (int j = tid; j < RS; j += kThreads) {
    int m = 0;
    for (int c = 0; c < K; ++c) m = max(m, sm.ring_len[c * RS + j]);
    sm.maxl[j] = m;
  }
  __syncthreads();

  if (tid < kConsumers)
    consume<H>(sm, out + row, S, B, W, R, rounds);
  else
    produce(sm, cl, dk, lq, S, K, B, W, nL);
}

}  // namespace
}  // namespace blg_dp

// litq: [P, S] int32; cand_len, dpackq: [P, S, K] int32; joint_e, joint_l:
// [P, 576] int32 (ops/parse_dp.py::build_cost_model); B, W, R: block,
// window and rounds (S % B == 0, W % B == 0, W < 1024, B <= 63, checked
// by the wrapper); out: [P, S] int32, column p-1 = (dp[p] << 10) |
// from_len; rounds: [P] int32, the rounds each page ran summed over its
// blocks, or null. K <= 32 (checked by the wrapper). Returns the launch's
// cudaGetLastError() (or the error of raising the kernel's shared-memory
// limit).
extern "C" int blg_dp_parse(const void* litq, const void* cand_len,
                            const void* dpackq, const void* joint_e,
                            const void* joint_l, int P, int S, int K, int B,
                            int W, int R, void* out, void* rounds,
                            void* stream) {
  if (P <= 0) return 0;
  int nL = 0;
  for (int b : blg_dp::kBucketHost) nL += b <= W;
  const size_t smem = sizeof(int) * blg_dp::Layout(W, B, K, nL).ints;
  void (*kernel)(const int32_t*, const int32_t*, const int32_t*,
                 const int32_t*, const int32_t*, int, int, int, int, int,
                 int, int32_t*, int32_t*) =
      B > 32 ? blg_dp::dp_parse_kernel<2> : blg_dp::dp_parse_kernel<1>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  kernel<<<P, blg_dp::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(litq), static_cast<const int32_t*>(cand_len),
      static_cast<const int32_t*>(dpackq),
      static_cast<const int32_t*>(joint_e),
      static_cast<const int32_t*>(joint_l), S, K, B, W, R, nL,
      static_cast<int32_t*>(out), static_cast<int32_t*>(rounds));
  return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory, in bytes, that a launch at (W, B, K) asks for.
extern "C" int blg_dp_smem(int W, int B, int K) {
  int nL = 0;
  for (int b : blg_dp::kBucketHost) nL += b <= W;
  return static_cast<int>(sizeof(int) * blg_dp::Layout(W, B, K, nL).ints);
}
