// Phase-A kernel: the commands and literals of a batch of staged pages,
// stored for the sweep kernel (sweep.cu) instead of executed.
//
// Replaces brotlig_tpu/ops/pallas_decode.py::make_phase_a_kernel (called
// by phase_a_from_buf), the first kernel of the two-phase decode route.
// Plain version: ops/phase_a_kernel.py::phase_a_plain (the torch wavefront
// of ops/decode.py and its distance-ring resolution).
//
// One warp per page; lane s owns sub-stream s. Each round runs steps 1-4
// of page_round.cuh (commands, sentinel, distance ring, literals) as the
// fused kernel does, then stores the round's commands: lane i writes
// command r*32+i's insert length, copy length and ring-resolved absolute
// distance (32 consecutive ints per field, one coalesced store each). The
// literals go to the page's dense literal queue. A copy whose distance
// reaches before the page start sets the status bit the fused kernel
// sets when it executes it.
//
// Memory: the command arrays ([P, max_cmds] per field) and the literal
// queue ([P, page_size + 64]) are device-memory scratch the wrapper
// allocates at worst-case size, so nothing overflows. The TPU kernel's
// double-buffered DMA staging and its literal chunk-slot records have no
// counterpart. Every loop is bounded as in the fused kernel.
//
// What bounds it on this card: latency, as the fused kernel: a page is a
// serial chain of rounds and of bit-serial decodes per lane, its stores
// (12 bytes a command, a byte a literal) are fire-and-forget, and a batch
// takes as long as its slowest page alone (every page is resident). So
// the work is in the round of page_round.cuh, which K2 shares: the bit
// reservoir, the first-level symbol tables, the length-code tables held a
// lane each, and the branch-free ring scan each shorten that chain.
#include "page_round.cuh"

namespace blg {
namespace {

__global__ void __launch_bounds__(kStreams)
    phase_a_kernel(const int32_t* __restrict__ buf3, int wc, int P,
                   const int32_t* __restrict__ npd,
                   const int32_t* __restrict__ bp0,
                   const int32_t* __restrict__ meta,
                   const int32_t* __restrict__ dicts,
                   const int32_t* __restrict__ trivs, int S, int max_rounds,
                   int32_t* __restrict__ ins_out, int32_t* __restrict__ cpy_out,
                   int32_t* __restrict__ dist_out, uint8_t* __restrict__ litq,
                   int32_t* __restrict__ ncmds_out,
                   int32_t* __restrict__ status_out) {
  __shared__ CodeSmem sm;
  const int p = blockIdx.x;
  const int lane = threadIdx.x;
  const size_t pp = static_cast<size_t>(p);
  const PageCodes codes =
      load_page_codes(meta, dicts, trivs, pp, lane, kStreams, sm);

  const int npf = npd[pp * 4 + 0];
  const int ndir = npd[pp * 4 + 1];
  const RoundCtx cx{LaneStream(Streams{buf3, P, p, wc * 4}, lane),
                    LenTables(lane), lane, npf, ndir};
  const size_t row = pp * max_rounds * kStreams;
  uint8_t* pq = litq + pp * (S + 64);
  const int lit_cap = S + 64;

  BitReader br;
  br.init(cx.ls, bp0[pp * kStreams + lane]);
  Ring ring;
  int ncmds = 0, prev_tail = 0, qtail = 0, pos_tot = 0;
  int status = 0;
  bool done = false;

  for (int r = 0; r < max_rounds && !done; ++r) {  // all uniform
    const RoundCmds c = decode_round_cmds(codes, cx, br, ring);
    const size_t at = row + static_cast<size_t>(r) * kStreams + lane;
    ins_out[at] = c.insert_len;
    cpy_out[at] = c.copy_len;
    dist_out[at] = c.dist;
    ncmds += c.k;

    const int cst = pos_tot + c.excl_cov + c.insert_len;
    const bool bad = c.copy_len > 0 && (c.dist <= 0 || c.dist > cst);
    if (__any_sync(kFull, bad)) status |= kStDistance;

    const int rlit = round_literal_count(c.k, c.litcount, prev_tail);
    if (qtail + rlit > lit_cap || pos_tot + c.covtot > S) {
      status |= kStOverrun;
      break;
    }
    for (int j = lane; j < rlit; j += kStreams)
      pq[qtail + j] = static_cast<uint8_t>(decode_literal(codes.lit, cx, br));
    qtail += rlit;
    pos_tot += c.covtot;
    done = c.k < kStreams;
  }
  if (!done && !(status & kStOverrun)) status |= kStNoSentinel;
  if (lane == 0) {
    ncmds_out[p] = ncmds;
    status_out[p] = status;
  }
}

}  // namespace
}  // namespace blg

// buf3, npd, bp0, meta, dicts, trivs: as blg_decode_pages (decode.cu);
// ins, cpy, dist: [P, max_rounds * 32] int32 out, written up to each
// page's last round (command n of page p at p * max_rounds * 32 + n);
// litq: [P, page_size + 64] uint8 out, written up to the page's decoded
// literals; ncmds, status: [P] int32 out.
extern "C" int blg_phase_a(const void* buf3, int wc, int P, const void* npd,
                           const void* bp0, const void* meta,
                           const void* dicts, const void* trivs,
                           int page_size, int max_rounds, void* ins,
                           void* cpy, void* dist, void* litq, void* ncmds,
                           void* status, void* stream) {
  if (P > 0) {
    blg::phase_a_kernel<<<P, blg::kStreams, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(buf3), wc, P,
        static_cast<const int32_t*>(npd), static_cast<const int32_t*>(bp0),
        static_cast<const int32_t*>(meta), static_cast<const int32_t*>(dicts),
        static_cast<const int32_t*>(trivs), page_size, max_rounds,
        static_cast<int32_t*>(ins), static_cast<int32_t*>(cpy),
        static_cast<int32_t*>(dist), static_cast<uint8_t*>(litq),
        static_cast<int32_t*>(ncmds), static_cast<int32_t*>(status));
  }
  return static_cast<int>(cudaGetLastError());
}
