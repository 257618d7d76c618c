// Fused page-decode kernel: commands, literals and the LZ77 copies of a
// batch of staged pages, from their prefix codes to the output bytes.
//
// Replaces brotlig_tpu/ops/pallas_decode.py::make_fused_kernel (called by
// decode_fused_from_buf), including the LZ sweep it runs inside,
// make_phase_b_kernel_wide. Plain version: the torch wavefront of
// ops/decode.py (ops/decode_kernel.py::decode_fused_plain).
//
// What bounds it on this card: latency. A page is a serial chain of
// command rounds and bit-serial Huffman decodes per lane; the bytes it
// moves (the compressed page in, the page out) take microseconds, and
// every page of a 256-page batch is resident at once, so the batch takes
// as long as its slowest page alone. The design shortens each page's
// chain and takes the copies off it:
//   * the page lives in dynamic shared memory at every legal page size
//     (64 KiB pages leave two blocks an SM, so a 256-page batch is
//     resident; 128 KiB pages one, which still measured faster on the H100
//     than keeping those pages in device memory) and leaves in coalesced
//     16-byte stores at the end; inserts and copies touch shared memory
//     only;
//   * two warps a page. Warp 0 runs the rounds of page_round.cuh and
//     writes each round's literals straight to their output positions: a
//     round's commands, so every insert's position, are known before its
//     literals are decoded, and the 32 literals of a group are consecutive,
//     so each lane's insert is a rank among the inserts that start in the
//     group (a bit mask by warp reduction), found before the literal is
//     decoded. Only the rounding surplus (prev_tail < 32 literals that
//     belong to the next round) waits in a 32-byte carry: no literal
//     queue exists. Warp 1 executes the copies from a ring of kDepth
//     round descriptors; named barriers (one "full" and one "empty" per
//     slot) pass the slots between the warps, so the decode of the next
//     rounds does not wait for the copies of this one;
//   * warp 1 takes a round's copy bytes 32 at a time, across as many
//     short copies as the window holds, rather than one copy after the
//     other (per-command steps made the copy warp the slower of the two
//     on pages of many short copies). Byte j of a copy at cstart with
//     distance d reads cstart - d + j % d, which lies before cstart;
//     within a window it may be a byte another lane writes now, and
//     pointer jumping over the lanes finds the final byte it equals.
//     Inserts (warp 0) and copies (warp 1) write disjoint bytes.
//
// Every loop is bounded: max_rounds command rounds, a literal count
// checked against page_size + 64 as the literal queue of the other routes,
// no stream word past wl, copies clamped at the page start, at most 5
// jumps a window; the copy warp leaves at the descriptor that ends the
// page. A page that breaks a bound gets the status bits it always got and
// the wrapper raises.
#include "page_round.cuh"

namespace blg {
namespace {

constexpr int kThreads = 2 * kStreams;   // decode warp + copy warp
constexpr int kDepth = 7;                // round descriptors in flight
constexpr int kFullBar = 1;              // named barriers 1..kDepth
constexpr int kEmptyBar = 1 + kDepth;    // and kDepth+1..2*kDepth

struct RoundDesc {
  int k;                   // commands of the round; -1 ends the page
  int pad[3];
  int4 cmd[kStreams];      // copy start, copy length, distance, -
};

struct DecodeSmem {
  CodeSmem codes;
  RoundDesc ring[kDepth];
  // warp 0, per round: output minus literal position of each insert of
  // length > 0, compacted, and the literals decoded for the next round
  int nzoff[kStreams];
  uint8_t carry[kStreams];
  // warp 1, per round: the copies of length > 0, compacted: start,
  // distance, and offset among the round's copy bytes
  int cs[kStreams];
  int cd[kStreams];
  int co[kStreams];
  int total;               // bytes the page's commands cover
  int ncmds;
  int status;
};

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(kThreads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(kThreads) : "memory");
}

// Warp 0: the page's rounds; literals into the page, copies to warp 1.
__device__ __forceinline__ void decode_rounds(
    const PageCodes& codes, const RoundCtx& cx, int bp0, int S,
    int max_rounds, uint8_t* page, DecodeSmem& sm) {
  const int lane = cx.lane;
  BitReader br;
  br.init(cx.ls, bp0);
  Ring ring;
  const int lit_cap = S + 64;
  int ncmds = 0, prev_tail = 0, qtail = 0, pos_tot = 0, status = 0;
  bool done = false;
  int r = 0;
  for (; r < max_rounds && !done; ++r) {  // all uniform
    const RoundCmds c = decode_round_cmds(codes, cx, br, ring);
    ncmds += c.k;
    const int held = prev_tail;   // literals decoded in earlier rounds
    const int rlit = round_literal_count(c.k, c.litcount, prev_tail);
    if (qtail + rlit > lit_cap || pos_tot + c.covtot > S) {
      status |= kStOverrun;
      break;
    }
    const int cst = pos_tot + c.excl_cov + c.insert_len;
    if (__any_sync(kFull, c.copy_len > 0 && (c.dist <= 0 || c.dist > cst)))
      status |= kStDistance;

    // ---- 4. literals to their output positions ----
    const bool nz = lane < c.k && c.insert_len > 0;
    const unsigned nzmask = __ballot_sync(kFull, nz);
    if (nz)
      sm.nzoff[__popc(nzmask & ((1u << lane) - 1u))] =
          pos_tot + c.excl_cov - c.excl_ins;
    const uint8_t carried = lane < held ? sm.carry[lane] : 0;
    __syncwarp();
    // round-local literals l = b + lane: the insert of literal l is the
    // last insert of length > 0 starting at or before it (its rank: those
    // starting at or before b, plus those starting inside the group up to
    // l, from a bit mask of the group's starts); literals from litcount on
    // go to the carry for the next round. The target depends on b alone,
    // so it is found before the literal is decoded, off the decode chain.
    auto target = [&](int b) {
      const int rel = c.excl_ins - b;
      const unsigned starts = __reduce_or_sync(
          kFull, nz && rel > 0 && rel < kStreams ? 1u << rel : 0u);
      const int rank = __popc(__ballot_sync(kFull, nz && rel <= 0)) - 1 +
                       __popc(starts & ((2u << lane) - 1u));
      const int l = b + lane;
      return l < c.litcount ? l + sm.nzoff[rank] : -1 - (l - c.litcount);
    };
    auto put = [&](int at, int s) {
      if (at >= 0)
        page[at] = static_cast<uint8_t>(s);
      else
        sm.carry[-1 - at] = static_cast<uint8_t>(s);
    };
    const int at0 = target(0);
    if (lane < held) put(at0, carried);
    for (int base = 0; base < rlit; base += kStreams) {  // uniform
      const int at = target(held + base);
      if (base + lane < rlit) put(at, decode_literal(codes.lit, cx, br));
    }

    // ---- 5. the round's copies to warp 1 ----
    const int slot = r % kDepth;
    if (r >= kDepth) bar_sync(kEmptyBar + slot);
    if (lane < c.k) sm.ring[slot].cmd[lane] = make_int4(cst, c.copy_len,
                                                        c.dist, 0);
    if (lane == 0) sm.ring[slot].k = c.k;
    bar_arrive(kFullBar + slot);
    __syncwarp();
    pos_tot += c.covtot;
    qtail += rlit;
    done = c.k < kStreams;
  }
  if (!done && !(status & kStOverrun)) status |= kStNoSentinel;

  // the descriptor that ends the page, then wait for the copies still in
  // flight (every named barrier completes before the block moves on)
  const int slot = r % kDepth;
  if (r >= kDepth) bar_sync(kEmptyBar + slot);
  if (lane == 0) {
    sm.ring[slot].k = -1;
    sm.total = pos_tot;
    sm.ncmds = ncmds;
    sm.status = status;
  }
  bar_arrive(kFullBar + slot);
  for (int q = max(r - kDepth + 1, 0); q < r; ++q)
    bar_sync(kEmptyBar + q % kDepth);
}

// Warp 1: each round's copies, 32 copy bytes at a time in command order
// (a window may span many short copies). Byte j of a copy at cs with
// distance d is byte x = cs - d + j % d of the page. Every position before
// the window's first byte is final, and so is an insert byte inside it;
// an x that one of the window's lanes writes now is followed to that
// lane, and the links to the lane whose x is final, by pointer jumping
// over the lanes (5 shuffle steps cover the 31 links a window can hold).
__device__ __forceinline__ void copy_rounds(int lane, int max_rounds,
                                            uint8_t* page, DecodeSmem& sm) {
  for (int r = 0; r <= max_rounds; ++r) {
    const int slot = r % kDepth;
    bar_sync(kFullBar + slot);
    const RoundDesc& d = sm.ring[slot];
    const int k = d.k;
    if (k < 0) break;
    const int4 cmd = lane < k ? d.cmd[lane] : make_int4(0, 0, 1, 0);
    // compact the copies of length > 0, with their offsets among the
    // round's copy bytes
    const bool has = cmd.y > 0;
    const unsigned hmask = __ballot_sync(kFull, has);
    const int nc = __popc(hmask);
    const int ci = __popc(hmask & ((1u << lane) - 1u));
    const int incl = warp_incl_sum(cmd.y, lane);
    const int total = __shfl_sync(kFull, incl, kStreams - 1);
    if (has) {
      sm.cs[ci] = cmd.x;
      sm.cd[ci] = max(cmd.z, 1);
      sm.co[ci] = incl - cmd.y;
    }
    __syncwarp();
    // the window [b, b + 32) of copy bytes: which copies start in it; a
    // lane keeps its copy's fields while it stays in the same copy, and
    // steps j % d on by 32 % d
    int c0 = 0;   // the copy holding byte b
    int pc = -1, pcs = 0, pcd = 1, pco = 0, m = 0;
    for (int b = 0; b < total; b += kStreams) {
      const int rel = has ? incl - cmd.y - b : -1;
      const unsigned starts = __reduce_or_sync(
          kFull, rel > 0 && rel < kStreams ? 1u << rel : 0u);
      const int t = b + lane;
      const int c = c0 + __popc(starts & ((2u << lane) - 1u));
      // page position of copy byte b: copy bytes before it are written,
      // and every position before it is final
      const int wpos = sm.cs[c0] + b - sm.co[c0];
      int pos = INT_MAX, x = -1;   // lanes past the round's copy bytes
      if (t < total) {
        if (c != pc) {
          pc = c;
          pcs = sm.cs[c];
          pcd = sm.cd[c];
          pco = sm.co[c];
          const int j = t - pco;
          m = j < pcd ? j : j % pcd;
        } else {
          m += pcd > kStreams ? kStreams : kStreams % pcd;
          if (m >= pcd) m -= pcd;
        }
        pos = pcs + t - pco;
        x = pcs - pcd + m;
      }
      // only a copy starting inside the window can read an earlier copy
      // byte of it (a copy reads before its own start)
      if (__any_sync(kFull, x >= wpos)) {
        // the lane writing position x (positions grow with the lane)
        int w = 0;
#pragma unroll
        for (int s = kStreams / 2; s > 0; s >>= 1) {
          const int pw = __shfl_sync(kFull, pos, w + s);
          if (pw <= x) w += s;
        }
        int to = __shfl_sync(kFull, pos, w) == x ? w : lane;
        // jump until every lane points at a lane whose x is final
        for (int s = 1; s < kStreams; s <<= 1) {
          const int next = __shfl_sync(kFull, to, to);
          if (!__any_sync(kFull, next != to)) break;
          to = next;
        }
        x = __shfl_sync(kFull, x, to);
      }
      if (t < total) page[pos] = page[max(x, 0)];
      __syncwarp();
      c0 = __shfl_sync(kFull, c, kStreams - 1);
      // a copy starting exactly at the next window's first byte
      if (c0 + 1 < nc && sm.co[c0 + 1] == b + kStreams) ++c0;
    }
    __syncwarp();
    bar_arrive(kEmptyBar + slot);
  }
}

__global__ void __launch_bounds__(kThreads)
    decode_kernel(const int32_t* __restrict__ buf3, int wc, int P,
                  const int32_t* __restrict__ npd,
                  const int32_t* __restrict__ bp0,
                  const int32_t* __restrict__ meta,
                  const int32_t* __restrict__ dicts,
                  const int32_t* __restrict__ trivs, int S, int max_rounds,
                  uint8_t* __restrict__ out, int32_t* __restrict__ ncmds_out,
                  int32_t* __restrict__ status_out) {
  extern __shared__ __align__(16) uint8_t page[];
  __shared__ DecodeSmem sm;
  const int p = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & (kStreams - 1);
  const size_t pp = static_cast<size_t>(p);
  const PageCodes codes =
      load_page_codes(meta, dicts, trivs, pp, tid, kThreads, sm.codes);

  if (tid < kStreams) {
    const RoundCtx cx{LaneStream(Streams{buf3, P, p, wc * 4}, lane),
                      LenTables(lane), lane, npd[pp * 4 + 0],
                      npd[pp * 4 + 1]};
    decode_rounds(codes, cx, bp0[pp * kStreams + lane], S, max_rounds, page,
                  sm);
  } else {
    copy_rounds(lane, max_rounds, page, sm);
  }
  __syncthreads();

  // bytes past the coverage are zero: zero up to the next 16 bytes, then
  // the page goes out in 16-byte stores (S is a multiple of 16, the shared
  // buffer 16-byte aligned)
  const int tot = sm.total;
  const int t16 = min((tot + 15) & ~15, S);
  for (int j = tot + tid; j < t16; j += kThreads) page[j] = 0;
  __syncthreads();
  const uint4* src = reinterpret_cast<const uint4*>(page);
  uint4* dst = reinterpret_cast<uint4*>(out + pp * S);
  for (int j = tid; j < S / 16; j += kThreads)
    dst[j] = j < t16 / 16 ? src[j] : make_uint4(0u, 0u, 0u, 0u);
  if (tid == 0) {
    ncmds_out[p] = sm.ncmds;
    status_out[p] = sm.status;
  }
}

int launch(const int32_t* buf3, int wc, int P, const int32_t* npd,
           const int32_t* bp0, const int32_t* meta, const int32_t* dicts,
           const int32_t* trivs, int S, int max_rounds, uint8_t* out,
           int32_t* ncmds, int32_t* status, cudaStream_t stream) {
  // the page in dynamic shared memory, above the 48 KB default
  const cudaError_t e = cudaFuncSetAttribute(
      decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S);
  if (e != cudaSuccess) return static_cast<int>(e);
  decode_kernel<<<P, kThreads, S, stream>>>(buf3, wc, P, npd, bp0, meta,
                                            dicts, trivs, S, max_rounds, out,
                                            ncmds, status);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace blg

// buf3: [wc, P, 128] int32 staged pages; npd: [P, 4] int32 (npostfix,
// ndirect, isdelta, 0); bp0: [P, 32] int32 cursors past the tables;
// meta: [P, 3, 3, 17] int32 limit/first/offset per code; dicts:
// [P, 728+544+256] int32 canonical symbol dictionaries; trivs: [P, 3]
// int32; out: [P, page_size] uint8; ncmds, status: [P] int32 out.
extern "C" int blg_decode_pages(const void* buf3, int wc, int P,
                                const void* npd, const void* bp0,
                                const void* meta, const void* dicts,
                                const void* trivs, int page_size,
                                int max_rounds, void* out, void* ncmds,
                                void* status, void* stream) {
  if (P <= 0) return 0;
  auto* a = static_cast<const int32_t*>(buf3);
  auto* n = static_cast<const int32_t*>(npd);
  auto* b = static_cast<const int32_t*>(bp0);
  auto* m = static_cast<const int32_t*>(meta);
  auto* d = static_cast<const int32_t*>(dicts);
  auto* t = static_cast<const int32_t*>(trivs);
  auto* o = static_cast<uint8_t*>(out);
  auto* nc = static_cast<int32_t*>(ncmds);
  auto* s = static_cast<int32_t*>(status);
  auto str = static_cast<cudaStream_t>(stream);
  return blg::launch(a, wc, P, n, b, m, d, t, page_size, max_rounds, o, nc,
                     s, str);
}
