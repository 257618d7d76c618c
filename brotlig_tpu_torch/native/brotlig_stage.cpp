// Host-side batch staging for the TPU decoder: parse each compressed
// page's header + self-describing size table (reference semantics:
// PageDecoder.cpp:83-121) and emit the word-round-robin interleaved
// buffer the Pallas kernels consume (word w of sub-stream s at flat
// position w*32+s, chunk-major [Wc, P, 128] int32 — the layout of
// ops/pallas_decode._interleave_streams).
//
// Doing this on the host replaces the XLA interleave gather (measured at
// ~22% of fused decode wall time, PERF.md round-3) with a memcpy-speed
// pass that also SHRINKS the host->device upload: the interleaved buffer
// is sized by the largest compressed stream (wl words/stream), not the
// uncompressed page size the old words staging padded to.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int kNumStreams = 32;

inline uint32_t BitLen(uint32_t v) {
  uint32_t r = 0;
  while (v) { ++r; v >>= 1; }
  return r;
}

// LSB-first bounded bit reader (reads past end yield zeros).
struct HdrReader {
  const uint8_t* data;
  uint64_t size;
  uint64_t bitpos = 0;
  uint32_t Read(uint32_t nbits) {
    if (!nbits) return 0;
    uint64_t w = 0;
    uint64_t byte = bitpos >> 3;
    uint64_t n = size > byte ? size - byte : 0;
    if (n > 8) n = 8;
    std::memcpy(&w, data + byte, n);  // little-endian
    w >>= (bitpos & 7);
    bitpos += nbits;
    return static_cast<uint32_t>(w) & ((1u << nbits) - 1);
  }
};

void StageOnePage(const uint8_t* src, uint64_t n, uint32_t p,
                  uint32_t num_pages, uint32_t wl, int32_t* buf3,
                  int32_t* npd) {
  uint64_t stream_bytes[kNumStreams] = {0};
  int32_t npostfix = 0, ndirect = 0, isdelta = 0;
  if (n >= 5) {
    HdrReader hdr{src, n};
    npostfix = static_cast<int32_t>(hdr.Read(2));
    ndirect = static_cast<int32_t>(hdr.Read(4)) << npostfix;
    isdelta = static_cast<int32_t>(hdr.Read(1));
    hdr.Read(1);  // reserved
    uint32_t r_avg = static_cast<uint32_t>((n + 31) / 32);
    uint32_t base_bits = BitLen(r_avg);
    uint32_t dlt_bits_bits = BitLen(BitLen(static_cast<uint32_t>(n - 1)));
    uint32_t base = hdr.Read(base_bits);
    uint32_t dlt_bits = hdr.Read(dlt_bits_bits);
    uint64_t header_bits = 8 + base_bits + dlt_bits_bits +
                           32ull * dlt_bits;
    header_bits = (header_bits + 31) / 32 * 32;
    uint64_t off = header_bits / 8;
    for (int s = 0; s < kNumStreams; ++s) {
      uint32_t d = hdr.Read(dlt_bits);
      stream_bytes[s] = off;
      off += base + d;
    }
  }
  npd[4ull * p + 0] = npostfix;
  npd[4ull * p + 1] = ndirect;
  npd[4ull * p + 2] = isdelta;
  npd[4ull * p + 3] = 0;

  // chunk c of the interleave holds words 4c+j (j = lane>>5) of stream
  // s = lane&31; rows are written contiguously (512B per chunk-page row)
  // while the 32 stream read pointers advance sequentially.
  uint32_t wc = wl * kNumStreams / 128;
  for (uint32_t c = 0; c < wc; ++c) {
    int32_t* row = buf3 + (static_cast<uint64_t>(c) * num_pages + p) * 128;
    for (int j = 0; j < 4; ++j) {
      uint64_t wbyte = 4ull * (4ull * c + j);
      for (int s = 0; s < kNumStreams; ++s) {
        uint64_t pos = stream_bytes[s] + wbyte;
        uint32_t v = 0;
        if (pos + 4 <= n) {
          std::memcpy(&v, src + pos, 4);  // little-endian
        } else if (pos < n) {
          std::memcpy(&v, src + pos, n - pos);
        }
        row[j * kNumStreams + s] = static_cast<int32_t>(v);
      }
    }
  }
}

}  // namespace

extern "C" {

// payload: container bytes; offsets/sizes: per-page byte ranges within
// payload; buf3: [wl*32/128, num_pages, 128] int32 out; npd:
// [num_pages, 4] int32 out (npostfix, ndirect, isdelta, 0).
// Returns 0 on success, 1 on out-of-range page bounds.
int blg_stage_pages(const uint8_t* payload, uint64_t payload_size,
                    const uint64_t* offsets, const uint64_t* sizes,
                    uint32_t num_pages, uint32_t wl, int32_t* buf3,
                    int32_t* npd, int num_threads) {
  if (wl % 4) return 1;
  for (uint32_t p = 0; p < num_pages; ++p) {
    if (offsets[p] + sizes[p] > payload_size) return 1;
  }
  if (num_threads <= 0) {
    unsigned hw = std::thread::hardware_concurrency();
    num_threads = hw ? static_cast<int>(hw) : 1;
  }
  if (num_threads > static_cast<int>(num_pages)) num_threads = num_pages;

  std::atomic<uint32_t> next{0};
  auto worker = [&]() {
    for (;;) {
      uint32_t p = next.fetch_add(1);
      if (p >= num_pages) return;
      StageOnePage(payload + offsets[p], sizes[p], p, num_pages, wl,
                   buf3, npd);
    }
  };
  if (num_threads <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(num_threads);
    for (int t = 0; t < num_threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return 0;
}

}  // extern "C"
