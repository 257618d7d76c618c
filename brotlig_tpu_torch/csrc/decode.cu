// Fused page-decode kernel: commands, literals and the LZ77 copies of a
// batch of staged pages, from their prefix codes to the output bytes.
//
// Replaces brotlig_tpu/ops/pallas_decode.py::make_fused_kernel (called by
// decode_fused_from_buf), including the LZ sweep it runs inside,
// make_phase_b_kernel_wide. Plain version: the torch wavefront of
// ops/decode.py (ops/decode_kernel.py::decode_fused_plain).
//
// One warp per page; lane s owns sub-stream s. Each round runs steps 1-4
// of page_round.cuh (commands, sentinel, distance ring, literals), then
//   5. executes the k commands in order with warp-wide copies: byte j
//      of a copy at cstart with distance d reads cstart - d + j % d, which
//      always lies before cstart, so one copy has no dependencies inside
//      itself (the reference's 32-byte wave copies, hlsl:1401-1419);
//      __syncwarp() orders each command after the ones before it.
// This computes what the TPU design splits into command planes and a
// covering-command sweep: the format fixes the bytes.
//
// Memory: the output page and the literal queue (page_size + 64 bytes)
// live in device-memory scratch the wrapper allocates at worst-case size,
// so no bucket can overflow and nothing is rerun. Every loop is bounded:
// max_rounds command rounds, a literal queue of page_size + 64, no stream
// word past wl, copies clamped at the page start. A page that breaks a
// bound gets a status bit and the wrapper raises.
//
// What bounds it on this card: latency. One warp per page, and Huffman
// decode is bit-serial per lane (dependent loads of stream words and table
// entries), so a batch of 256 pages keeps about two warps on each SM. This
// first version does nothing about that; it is correct first.
#include "page_round.cuh"

namespace blg {
namespace {

__global__ void __launch_bounds__(kStreams)
    decode_kernel(const int32_t* __restrict__ buf3, int wc, int P,
                  const int32_t* __restrict__ npd,
                  const int32_t* __restrict__ bp0,
                  const int32_t* __restrict__ meta,
                  const int32_t* __restrict__ dicts,
                  const int32_t* __restrict__ trivs, int S, int max_rounds,
                  uint8_t* __restrict__ out, uint8_t* __restrict__ litq,
                  int32_t* __restrict__ ncmds_out,
                  int32_t* __restrict__ status_out) {
  __shared__ int s_meta[3 * kMetaPerTable];
  __shared__ int s_dict[kDictTotal];
  const int p = blockIdx.x;
  const int lane = threadIdx.x;
  const size_t pp = static_cast<size_t>(p);
  const PageCodes codes =
      load_page_codes(meta, dicts, trivs, pp, lane, s_meta, s_dict);

  const int npf = npd[pp * 4 + 0];
  const int ndir = npd[pp * 4 + 1];
  const Streams st{buf3, P, p, wc * 4};
  uint8_t* pout = out + pp * S;
  uint8_t* pq = litq + pp * (S + 64);
  const int lit_cap = S + 64;

  int bp = bp0[pp * kStreams + lane];
  Ring ring;
  int ncmds = 0, prev_tail = 0, qtail = 0, pos_tot = 0, ins_tot = 0;
  int status = 0;
  bool done = false;

  for (int r = 0; r < max_rounds && !done; ++r) {  // all uniform
    const RoundCmds c = decode_round_cmds(codes, st, lane, npf, ndir, bp,
                                          ring);
    ncmds += c.k;

    // ---- 4. the round's literals ----
    const int rlit = round_literal_count(c.k, c.litcount, prev_tail);
    if (qtail + rlit > lit_cap || pos_tot + c.covtot > S) {
      status |= kStOverrun;
      break;
    }
    decode_round_literals(codes.lit, st, lane, rlit, bp, pq + qtail);
    qtail += rlit;
    __syncwarp();

    // ---- 5. the round's commands, in order ----
    for (int i = 0; i < c.k; ++i) {
      const int ins_i = __shfl_sync(kFull, c.insert_len, i);
      const int cpy_i = __shfl_sync(kFull, c.copy_len, i);
      const int dist_i = __shfl_sync(kFull, c.dist, i);
      const int wst = pos_tot + __shfl_sync(kFull, c.excl_cov, i);
      const int lst = ins_tot + __shfl_sync(kFull, c.excl_ins, i);
      for (int j = lane; j < ins_i; j += kStreams) pout[wst + j] = pq[lst + j];
      __syncwarp();
      if (cpy_i > 0) {
        const int cst = wst + ins_i;
        if (dist_i <= 0 || dist_i > cst) status |= kStDistance;
        const int d = max(dist_i, 1);
        for (int j = lane; j < cpy_i; j += kStreams) {
          const int src = cst - d + (j < d ? j : j % d);
          pout[cst + j] = pout[max(src, 0)];
        }
        __syncwarp();
      }
    }
    pos_tot += c.covtot;
    ins_tot += c.litcount;
    done = c.k < kStreams;
  }
  if (!done && !(status & kStOverrun)) status |= kStNoSentinel;

  for (int j = pos_tot + lane; j < S; j += kStreams) pout[j] = 0;
  if (lane == 0) {
    ncmds_out[p] = ncmds;
    status_out[p] = status;
  }
}

}  // namespace
}  // namespace blg

// buf3: [wc, P, 128] int32 staged pages; npd: [P, 4] int32 (npostfix,
// ndirect, isdelta, 0); bp0: [P, 32] int32 cursors past the tables;
// meta: [P, 3, 3, 17] int32 limit/first/offset per code; dicts:
// [P, 728+544+256] int32 canonical symbol dictionaries; trivs: [P, 3]
// int32; out: [P, page_size] uint8; litq: [P, page_size + 64] uint8
// scratch; ncmds, status: [P] int32 out.
extern "C" int blg_decode_pages(const void* buf3, int wc, int P,
                                const void* npd, const void* bp0,
                                const void* meta, const void* dicts,
                                const void* trivs, int page_size,
                                int max_rounds, void* out, void* litq,
                                void* ncmds, void* status, void* stream) {
  if (P > 0) {
    blg::decode_kernel<<<P, blg::kStreams, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(buf3), wc, P,
        static_cast<const int32_t*>(npd), static_cast<const int32_t*>(bp0),
        static_cast<const int32_t*>(meta), static_cast<const int32_t*>(dicts),
        static_cast<const int32_t*>(trivs), page_size, max_rounds,
        static_cast<uint8_t*>(out), static_cast<uint8_t*>(litq),
        static_cast<int32_t*>(ncmds), static_cast<int32_t*>(status));
  }
  return static_cast<int>(cudaGetLastError());
}
