// Native CPU Brotli-G encoder: greedy-lazy LZ77 parse + optimal
// depth-limited Huffman (package-merge) + the exact Brotli-G page
// serialization (32-lane round-robin swizzle, self-describing size table).
//
// Fresh implementation against the format (SURVEY.md Appendix A; parity
// refs: src/encoder/PageEncoder.cpp, src/encoder/BrotligHuffman.cpp,
// src/common/BrotligSwizzler.cpp). Multithreaded page-parallel with an
// atomic work index like the reference worker pool (BrotligEncoder.cpp).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <array>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int kNumStreams = 32;
constexpr uint32_t kNumCommandSymbols = 704;
constexpr uint32_t kSentinel = 704;
constexpr uint32_t kCmdAlphabet = 728;
constexpr uint32_t kDistAlphabet = 544;
constexpr uint32_t kLitAlphabet = 256;
constexpr int kMaxDepth = 15;

constexpr uint32_t kInsBase[24] = {0, 1, 2, 3, 4, 5, 6, 8, 10, 14, 18, 26,
                                   34, 50, 66, 98, 130, 194, 322, 578,
                                   1090, 2114, 6210, 22594};
constexpr uint32_t kInsExtra[24] = {0, 0, 0, 0, 0, 0, 1, 1, 2, 2, 3, 3,
                                    4, 4, 5, 5, 6, 7, 8, 9, 10, 12, 14, 24};
constexpr uint32_t kCpyBase[24] = {2, 3, 4, 5, 6, 7, 8, 9, 10, 12, 14, 18,
                                   22, 30, 38, 54, 70, 102, 134, 198, 326,
                                   582, 1094, 2118};
constexpr uint32_t kCpyExtra[24] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 2, 2, 3,
                                    3, 4, 4, 5, 5, 6, 7, 8, 9, 10, 24};
constexpr int kClOrder[18] = {1, 2, 3, 4, 0, 5, 17, 6, 16,
                              7, 8, 9, 10, 11, 12, 13, 14, 15};

inline uint32_t BitLength(uint32_t x) { return x ? 32 - __builtin_clz(x) : 0; }

inline uint32_t ReverseBits(uint32_t v, uint32_t n) {
  uint32_t r = 0;
  for (uint32_t i = 0; i < n; ++i) {
    r = (r << 1) | (v & 1);
    v >>= 1;
  }
  return r;
}

uint32_t GetInsertCode(uint32_t len) {
  if (len < 6) return len;
  if (len < 130) {
    uint32_t nbits = BitLength(len - 2) - 2;
    return (nbits << 1) + ((len - 2) >> nbits) + 2;
  }
  if (len < 2114) return BitLength(len - 66) + 9;
  if (len < 6210) return 21;
  if (len < 22594) return 22;
  return 23;
}

uint32_t GetCopyCode(uint32_t len) {
  if (len < 10) return len - 2;
  if (len < 134) {
    uint32_t nbits = BitLength(len - 6) - 2;
    return (nbits << 1) + ((len - 6) >> nbits) + 4;
  }
  if (len < 2118) return BitLength(len - 70) + 11;
  return 23;
}

uint32_t CombineLengthCodes(uint32_t ins, uint32_t cpy, bool use_last) {
  uint32_t bits64 = (cpy & 7) | ((ins & 7) << 3);
  if (use_last && ins < 8 && cpy < 16)
    return cpy < 8 ? bits64 : (bits64 | 64);
  uint32_t offset = 2 * ((cpy >> 3) + 3 * (ins >> 3));
  offset = (offset << 5) + 0x40 + ((0x520D40 >> offset) & 0xC0);
  return offset | bits64;
}

// --- LSB bit writer ---------------------------------------------------------
struct BitWriter {
  std::vector<uint8_t> buf;
  size_t bitpos = 0;
  void Write(uint32_t nbits, uint64_t bits) {
    if (!nbits) return;
    size_t need = (bitpos + nbits + 7) / 8;
    if (need > buf.size()) buf.resize(need + 64, 0);
    bits &= (nbits >= 64) ? ~0ull : ((1ull << nbits) - 1);
    uint64_t acc = bits << (bitpos & 7);
    size_t idx = bitpos >> 3;
    size_t nbytes = ((bitpos & 7) + nbits + 7) / 8;
    for (size_t k = 0; k < nbytes; ++k) buf[idx + k] |= (acc >> (8 * k));
    bitpos += nbits;
  }
  size_t NBytes() const { return (bitpos + 7) / 8; }
  void AlignDword() {
    size_t rem = bitpos % 32;
    if (rem) Write(32 - rem, 0);
  }
};

// --- package-merge depth-limited code lengths -------------------------------
void PackageMerge(const uint32_t* hist, uint32_t n, int max_depth,
                  uint8_t* lens) {
  std::memset(lens, 0, n);
  std::vector<uint32_t> used;
  for (uint32_t i = 0; i < n; ++i)
    if (hist[i]) used.push_back(i);
  if (used.empty()) return;
  if (used.size() == 1) {
    lens[used[0]] = 1;
    return;
  }
  struct Item {
    uint64_t w;
    std::vector<uint32_t> leaves;  // leaf ids
  };
  std::vector<Item> leaves(used.size());
  for (size_t i = 0; i < used.size(); ++i)
    leaves[i] = {hist[used[i]], {static_cast<uint32_t>(i)}};
  auto byw = [](const Item& a, const Item& b) { return a.w < b.w; };
  std::vector<Item> prev;
  for (int d = 0; d < max_depth - 1; ++d) {
    std::vector<Item> items = leaves;
    items.insert(items.end(), prev.begin(), prev.end());
    std::stable_sort(items.begin(), items.end(), byw);
    prev.clear();
    for (size_t k = 0; k + 1 < items.size(); k += 2) {
      Item m{items[k].w + items[k + 1].w, items[k].leaves};
      m.leaves.insert(m.leaves.end(), items[k + 1].leaves.begin(),
                      items[k + 1].leaves.end());
      prev.push_back(std::move(m));
    }
  }
  std::vector<Item> items = leaves;
  items.insert(items.end(), prev.begin(), prev.end());
  std::stable_sort(items.begin(), items.end(), byw);
  std::vector<uint32_t> counts(used.size(), 0);
  size_t take = 2 * used.size() - 2;
  for (size_t k = 0; k < take && k < items.size(); ++k)
    for (uint32_t leaf : items[k].leaves) counts[leaf]++;
  for (size_t i = 0; i < used.size(); ++i)
    lens[used[i]] = static_cast<uint8_t>(counts[i]);
}

void CanonicalCodesLsb(const uint8_t* lens, uint32_t n, uint16_t* codes) {
  uint32_t blc[16] = {0};
  for (uint32_t i = 0; i < n; ++i) blc[lens[i]]++;
  blc[0] = 0;
  uint32_t next[17] = {0};
  for (int l = 1; l <= 15; ++l) next[l] = (next[l - 1] + blc[l - 1]) << 1;
  for (uint32_t i = 0; i < n; ++i) {
    if (!lens[i]) {
      codes[i] = 0;
      continue;
    }
    codes[i] = static_cast<uint16_t>(ReverseBits(next[lens[i]]++, lens[i]));
  }
}

// --- 32-lane swizzler -------------------------------------------------------
struct Swizzler {
  BitWriter lanes[kNumStreams];
  BitWriter header;
  int cur = 0;
  void Append(uint32_t n, uint64_t bits, bool sw = false) {
    lanes[cur].Write(n, bits);
    if (sw) Switch();
  }
  void Switch() { cur = (cur + 1) % kNumStreams; }
  void Reset() { cur = 0; }

  // size table + serialization (BrotligSwizzler.cpp:68-189 semantics)
  std::vector<uint8_t> Serialize() {
    size_t lens_b[kNumStreams], tot = 0, mn = SIZE_MAX;
    for (int i = 0; i < kNumStreams; ++i) {
      lens_b[i] = lanes[i].NBytes();
      tot += lens_b[i];
      mn = std::min(mn, lens_b[i]);
    }
    uint32_t delta_bits = 1;
    for (int i = 0; i < kNumStreams; ++i) {
      uint32_t off = static_cast<uint32_t>(lens_b[i] - mn);
      delta_bits = std::max(delta_bits, off ? BitLength(off) : 1u);
    }
    size_t hbits = header.bitpos;
    size_t est = ((hbits + 7) / 8 + 3) / 4 * 4 + tot;
    uint32_t base_bits = 0, dbs_bits = 0;
    for (;;) {
      uint32_t r_avg = static_cast<uint32_t>((est + 31) / 32);
      base_bits = BitLength(r_avg);
      dbs_bits = BitLength(BitLength(static_cast<uint32_t>(est - 1)));
      size_t nh = hbits + base_bits + dbs_bits + 32ull * delta_bits;
      size_t nest = ((nh + 7) / 8 + 3) / 4 * 4 + tot;
      uint32_t nr_avg = static_cast<uint32_t>((nest + 31) / 32);
      if (BitLength(static_cast<uint32_t>(nest - 1)) ==
              BitLength(static_cast<uint32_t>(est - 1)) &&
          BitLength(nr_avg) == base_bits)
        break;
      est = nest;
    }
    header.Write(base_bits, mn);
    header.Write(dbs_bits, delta_bits);
    for (int i = 0; i < kNumStreams; ++i)
      header.Write(delta_bits, lens_b[i] - mn);
    header.AlignDword();

    std::vector<uint8_t> out(header.buf.begin(),
                             header.buf.begin() + header.NBytes());
    for (int i = 0; i < kNumStreams; ++i)
      out.insert(out.end(), lanes[i].buf.begin(),
                 lanes[i].buf.begin() + lens_b[i]);
    while (out.size() % 4) out.push_back(0);
    return out;
  }
};

// --- Huffman table storage (BrotligHuffman.cpp:262-363 format) --------------
void StoreTable(const uint32_t* hist, uint32_t alphabet, Swizzler& w,
                uint16_t* codes, uint8_t* lens) {
  uint32_t max_bits = BitLength(alphabet - 1);
  std::vector<uint32_t> used;
  for (uint32_t i = 0; i < alphabet; ++i)
    if (hist[i]) used.push_back(i);

  std::memset(lens, 0, alphabet);
  std::memset(codes, 0, alphabet * sizeof(uint16_t));

  if (used.size() <= 1) {
    uint32_t sym = used.empty() ? 0 : used[0];
    w.Append(2, 0);
    w.Append(2, 1);
    w.Append(2, 0);
    w.Append(max_bits, sym, true);
    w.Reset();
    return;
  }

  PackageMerge(hist, alphabet, kMaxDepth, lens);
  CanonicalCodesLsb(lens, alphabet, codes);

  if (used.size() <= 4) {
    std::sort(used.begin(), used.end(), [&](uint32_t a, uint32_t b) {
      return lens[a] != lens[b] ? lens[a] < lens[b] : a < b;
    });
    w.Append(2, 1);
    w.Append(2, static_cast<uint32_t>(used.size()) - 1);
    if (used.size() == 4) {
      w.Append(1, lens[used[0]] == 1 ? 1 : 0);
      w.Append(1, 0);
    } else {
      w.Append(2, 0);
    }
    for (uint32_t s : used) w.Append(max_bits, s, true);
    w.Reset();
    return;
  }

  // complex: RLE of code lengths (BrotligUtils.cpp:76-228 run splitting)
  w.Append(2, 2);
  w.Append(4, 18 - 4);
  std::vector<uint8_t> rle, extra;
  {
    uint32_t prev = 8;
    uint32_t i = 0;
    while (i < alphabet) {
      uint8_t v = lens[i];
      uint32_t reps = 1;
      if (i == 0) {
        rle.push_back(v);
        extra.push_back(0);
      } else {
        uint32_t k = i + 1;
        while (k < alphabet && lens[k] == v) {
          ++reps;
          ++k;
        }
        uint32_t r = reps;
        if (v == 0) {
          if (r == 11) { rle.push_back(0); extra.push_back(0); --r; }
          if (r < 3) {
            while (r--) { rle.push_back(0); extra.push_back(0); }
          } else {
            for (;;) {
              uint32_t c = std::min(r, 10u);
              r -= c;
              rle.push_back(17);
              extra.push_back(static_cast<uint8_t>(c - 3));
              if (r < 3) break;
            }
            while (r--) { rle.push_back(0); extra.push_back(0); }
          }
        } else {
          if (prev != v) { rle.push_back(v); extra.push_back(0); --r; }
          if (r == 7) { rle.push_back(v); extra.push_back(0); --r; }
          if (r < 3) {
            while (r--) { rle.push_back(v); extra.push_back(0); }
          } else {
            for (;;) {
              uint32_t c = std::min(r, 6u);
              r -= c;
              rle.push_back(16);
              extra.push_back(static_cast<uint8_t>(c - 3));
              if (r < 3) break;
            }
            while (r--) { rle.push_back(v); extra.push_back(0); }
          }
        }
      }
      prev = v;
      i += reps;
    }
  }
  uint32_t rle_hist[18] = {0};
  for (uint8_t c : rle) rle_hist[c]++;
  uint8_t rle_lens[18];
  uint16_t rle_codes[18];
  PackageMerge(rle_hist, 18, 9, rle_lens);
  CanonicalCodesLsb(rle_lens, 18, rle_codes);
  for (int i = 0; i < 18; ++i) w.Append(5, rle_lens[kClOrder[i]], true);
  w.Reset();
  for (size_t i = 0; i < rle.size(); ++i) {
    uint8_t c = rle[i];
    w.Append(rle_lens[c], rle_codes[c]);
    if (c == 16)
      w.Append(2, extra[i], true);
    else if (c == 17)
      w.Append(3, extra[i], true);
    else
      w.Switch();
  }
  w.Reset();
}

// --- LZ77 greedy-lazy matcher ----------------------------------------------
struct Cmd {
  uint32_t ins, cpy, dist;
  uint32_t prefix;
  int32_t dsym;  // -1 = none stored
  uint32_t dbits, dval;
};

constexpr int kHashBits = 16;
constexpr uint32_t kHashMul = 0x1E35A7BDu;

void FindMatches(const uint8_t* d, uint32_t n, int max_chain,
                 std::vector<Cmd>& cmds, uint32_t& tail) {
  std::vector<int32_t> head(1 << kHashBits, -1);
  std::vector<int32_t> prev(n ? n : 1, -1);
  auto hash4 = [&](uint32_t pos) {
    uint32_t v;
    std::memcpy(&v, d + pos, 4);
    return (v * kHashMul) >> (32 - kHashBits);
  };
  auto insert = [&](uint32_t pos) {
    if (pos + 4 <= n) {
      uint32_t h = hash4(pos);
      prev[pos] = head[h];
      head[h] = static_cast<int32_t>(pos);
    }
  };
  auto best = [&](uint32_t pos, uint32_t& blen, uint32_t& bdist) {
    blen = 0;
    bdist = 0;
    if (pos + 4 > n) return;
    int32_t cand = head[hash4(pos)];
    int chain = max_chain;
    uint32_t limit = n - pos;
    while (cand >= 0 && chain-- > 0) {
      const uint8_t* a = d + cand;
      const uint8_t* b = d + pos;
      uint32_t l = 0;
      while (l < limit && a[l] == b[l]) ++l;
      if (l >= 4 && l > blen) {
        blen = l;
        bdist = pos - cand;
      }
      cand = prev[cand];
    }
  };

  uint32_t pos = 0, anchor = 0;
  while (pos < n) {
    uint32_t blen, bdist;
    best(pos, blen, bdist);
    if (blen >= 4) {
      insert(pos);
      uint32_t nlen = 0, ndist = 0;
      if (pos + 1 < n) best(pos + 1, nlen, ndist);
      if (nlen > blen + 1) {
        ++pos;
        continue;
      }
      cmds.push_back({pos - anchor, blen, bdist, 0, -1, 0, 0});
      uint32_t end = pos + blen;
      ++pos;
      while (pos < end) insert(pos++);
      anchor = end;
    } else {
      insert(pos++);
    }
  }
  tail = n - anchor;
}

void EncodeDistance(uint32_t dist, uint32_t npostfix, uint32_t ndirect,
                    uint32_t& sym, uint32_t& nbits, uint32_t& extra) {
  if (dist <= ndirect) {
    sym = 16 + dist - 1;
    nbits = 0;
    extra = 0;
    return;
  }
  uint32_t dd = dist - ndirect - 1;
  uint32_t postfix = dd & ((1u << npostfix) - 1);
  uint32_t hval = dd >> npostfix;
  nbits = BitLength(hval + 4) - 2;
  uint32_t b = ((hval + 4) >> nbits) & 1;
  extra = hval + 4 - ((2 + b) << nbits);
  sym = 16 + ndirect + (((2 * (nbits - 1) + b) << npostfix) | postfix);
}


// Ring short code for a distance, or UINT32_MAX. Codes 0-3 are exact ring
// hits; 4-15 are ring[0]/ring[1] +/- {1,2,3} (decode mapping
// PageDecoder.cpp:345-404): code 4+2k = ring[0]-(k+1), 5+2k = ring[0]+(k+1)
// for k<3, and 10..15 likewise against ring[1]. All cost zero extra bits.
static inline uint32_t RingShortCode(uint32_t dist, const uint32_t* ring) {
  if (dist == ring[0]) return 0;
  if (dist == ring[1]) return 1;
  if (dist == ring[2]) return 2;
  if (dist == ring[3]) return 3;
  for (uint32_t depth = 0; depth < 2; ++depth) {
    uint32_t base = ring[depth];
    for (uint32_t mag = 1; mag <= 3; ++mag) {
      uint32_t code = 4 + 6 * depth + 2 * (mag - 1);
      if (base >= mag && dist == base - mag) return code;      // even: -mag
      if (dist == base + mag) return code + 1;                 // odd: +mag
    }
  }
  return UINT32_MAX;
}

// Serialize one page from raw (ins,cpy,dist) commands covering a prefix of
// the page; the uncovered tail becomes the insert-only command. Returns an
// empty vector if the page should be stored raw.
std::vector<uint8_t> EncodePageFromCommands(const uint8_t* data, uint32_t n,
                                            bool is_last,
                                            std::vector<Cmd>& cmds,
                                            uint32_t tail,
                                            bool isdelta = false) {
  // compressibility gate (PageEncoder.cpp:60-85 semantics)
  {
    uint64_t nlits = tail;
    for (auto& c : cmds) nlits += c.ins;
    uint64_t ncmds = cmds.size() + (tail ? 1 : 0) + 1;
    if (n <= 2) return {};
    if (ncmds < (n >> 8) + 2 && nlits > 0.99 * n) {
      uint32_t h[256] = {0};
      uint32_t t = (n + 12) / 13;
      for (uint32_t i = 0; i < t; ++i) h[data[i * 13]]++;
      double total = t, bits = 0;
      for (int i = 0; i < 256; ++i)
        if (h[i]) bits -= h[i] * std::log2(h[i] / total);
      if (bits < total) bits = total;
      if (bits > n * 7.92 / 13.0) return {};
    }
  }

  // distance-parameter search (npostfix x ndirect grid), mirroring the
  // reference's per-page optimization (PageEncoder.cpp:324-377): pick the
  // (npostfix, ndirect) that minimizes entropy + extra bits of the
  // non-short distance symbols.
  uint32_t npostfix = 0, ndirect = 0;
  {
    // collect absolute distances of commands not hitting the ring
    std::vector<uint32_t> dists;
    uint32_t ring[4] = {4, 11, 15, 16};
    for (auto& c : cmds) {
      if (!c.cpy) continue;
      uint32_t sym = UINT32_MAX;
      if (c.dist == ring[0]) sym = 0;
      else if (c.dist == ring[1]) sym = 1;
      else if (c.dist == ring[2]) sym = 2;
      else if (c.dist == ring[3]) sym = 3;
      // offset hits (codes 4-15) stay in the search set: whether they
      // become short codes is decided after (np, nd) is fixed
      if (sym == UINT32_MAX) dists.push_back(c.dist);
      if (sym != 0) {
        ring[3] = ring[2]; ring[2] = ring[1]; ring[1] = ring[0];
        ring[0] = c.dist;
      }
    }
    double best_cost = 1e99;
    for (uint32_t np = 0; np <= 3; ++np) {
      for (uint32_t nd_msb = 0; nd_msb <= 15; ++nd_msb) {
        uint32_t nd = nd_msb << np;
        std::vector<uint32_t> h(kDistAlphabet, 0);
        uint64_t extra_bits = 0;
        bool ok = true;
        for (uint32_t d : dists) {
          uint32_t sym, nb, ex;
          EncodeDistance(d, np, nd, sym, nb, ex);
          if (sym >= kDistAlphabet) { ok = false; break; }
          h[sym]++;
          extra_bits += nb;
        }
        if (!ok) continue;
        double cost = static_cast<double>(extra_bits);
        double total = static_cast<double>(dists.size());
        for (uint32_t s = 0; s < kDistAlphabet; ++s)
          if (h[s]) {
            cost -= h[s] * std::log2(h[s] / total);
            cost += 6.0;  // table-storage cost per used symbol
          }
        if (cost < best_cost) {
          best_cost = cost;
          npostfix = np;
          ndirect = nd;
        }
      }
    }
  }

  // distance codes with ring semantics. Two candidate modes per page:
  // exact ring hits only (codes 0-3), or also the +/-{1,2,3} offset codes
  // 4-15 (zero extra bits but a wider histogram); the cheaper one by
  // exact Huffman cost wins (the reference gets this choice implicitly
  // from brotli's cost-model-driven distance cache, PageEncoder.cpp:87-147).
  uint64_t mode_cost[2];
  for (int mode = 0; mode < 2; ++mode) {
    uint32_t ring[4] = {4, 11, 15, 16};
    std::vector<uint32_t> hd_m(kDistAlphabet, 0);
    uint64_t extras = 0;
    for (auto& c : cmds) {
      if (!c.cpy) continue;
      uint32_t nbits = 0, extra = 0;
      uint32_t sym = RingShortCode(c.dist, ring);
      if (mode == 0 && sym != UINT32_MAX && sym > 3) sym = UINT32_MAX;
      if (sym == UINT32_MAX) {
        EncodeDistance(c.dist, npostfix, ndirect, sym, nbits, extra);
        extras += nbits;
      }
      uint32_t ic = GetInsertCode(c.ins), cc = GetCopyCode(c.cpy);
      if (!(sym == 0 && ic < 8 && cc < 16)) hd_m[sym]++;
      if (sym > 0) {
        ring[3] = ring[2]; ring[2] = ring[1]; ring[1] = ring[0];
        ring[0] = c.dist;
      }
    }
    std::vector<uint8_t> dl(kDistAlphabet);
    PackageMerge(hd_m.data(), kDistAlphabet, 15, dl.data());
    uint64_t bits = extras;
    for (uint32_t i = 0; i < kDistAlphabet; ++i)
      bits += static_cast<uint64_t>(hd_m[i]) * dl[i];
    mode_cost[mode] = bits;
  }
  bool use_offsets = mode_cost[1] < mode_cost[0];

  uint32_t ring[4] = {4, 11, 15, 16};
  for (auto& c : cmds) {
    uint32_t nbits = 0, extra = 0;
    uint32_t sym = RingShortCode(c.dist, ring);
    if (!use_offsets && sym != UINT32_MAX && sym > 3) sym = UINT32_MAX;
    if (sym == UINT32_MAX)
      EncodeDistance(c.dist, npostfix, ndirect, sym, nbits, extra);
    uint32_t ic = GetInsertCode(c.ins), cc = GetCopyCode(c.cpy);
    bool use_last = (sym == 0 && ic < 8 && cc < 16);
    c.prefix = CombineLengthCodes(ic, cc, use_last);
    c.dsym = use_last ? -1 : static_cast<int32_t>(sym);
    c.dbits = use_last ? 0 : nbits;
    c.dval = use_last ? 0 : extra;
    if (sym > 0 && sym != UINT32_MAX) {
      ring[3] = ring[2];
      ring[2] = ring[1];
      ring[1] = ring[0];
      ring[0] = c.dist;
    }
  }
  if (tail)
    cmds.push_back({tail, 0, 0, kNumCommandSymbols + GetInsertCode(tail),
                    -1, 0, 0});
  cmds.push_back({0, 0, 0, kSentinel, -1, 0, 0});

  // histograms + literal queue
  std::vector<uint32_t> hc(kCmdAlphabet, 0), hd(kDistAlphabet, 0),
      hl(kLitAlphabet, 0);
  std::vector<uint8_t> litq;
  litq.reserve(n);
  uint32_t pos = 0;
  for (auto& c : cmds) {
    hc[c.prefix]++;
    if (c.cpy && c.prefix >= 128 && c.prefix < kNumCommandSymbols &&
        c.dsym >= 0)
      hd[c.dsym]++;
    for (uint32_t i = 0; i < c.ins; ++i) {
      hl[data[pos]]++;
      litq.push_back(data[pos++]);
    }
    pos += c.cpy;
  }
  uint8_t most_freq =
      static_cast<uint8_t>(std::max_element(hl.begin(), hl.end()) -
                           hl.begin());

  Swizzler w;
  std::vector<uint16_t> ccodes(kCmdAlphabet), dcodes(kDistAlphabet),
      lcodes(kLitAlphabet);
  std::vector<uint8_t> clens(kCmdAlphabet), dlens(kDistAlphabet),
      llens(kLitAlphabet);
  StoreTable(hc.data(), kCmdAlphabet, w, ccodes.data(), clens.data());
  StoreTable(hd.data(), kDistAlphabet, w, dcodes.data(), dlens.data());
  StoreTable(hl.data(), kLitAlphabet, w, lcodes.data(), llens.data());

  // round-robin serialization (PageEncoder.cpp:475-540)
  size_t total = cmds.size();
  size_t nrounds = (total + kNumStreams - 1) / kNumStreams;
  size_t eff = std::min(total, static_cast<size_t>(kNumStreams));
  size_t prev_tail = 0, lq = 0, ci = 0;
  for (size_t r = 0; r < nrounds; ++r) {
    size_t litcount = 0;
    int bs = 0;
    while (bs < kNumStreams) {
      const Cmd& c = cmds[ci++];
      litcount += c.ins;
      w.Append(clens[c.prefix], ccodes[c.prefix]);
      if (c.prefix <= kNumCommandSymbols) {
        uint32_t ic = GetInsertCode(c.ins);
        uint32_t cc = c.cpy ? GetCopyCode(c.cpy) : 0;
        uint64_t iv = c.ins - kInsBase[ic];
        uint64_t cv = (cc > 1) ? c.cpy - kCpyBase[cc] : c.cpy;
        w.Append(kInsExtra[ic] + kCpyExtra[cc],
                 (cv << kInsExtra[ic]) | iv);
      } else {
        uint32_t ic = c.prefix - kNumCommandSymbols;
        w.Append(kInsExtra[ic], c.ins - kInsBase[ic]);
      }
      if (c.ins == 0 && c.cpy == 0) break;  // sentinel
      if (c.cpy && c.prefix >= 128 && c.prefix < kNumCommandSymbols) {
        w.Append(dlens[c.dsym], dcodes[c.dsym]);
        w.Append(c.dbits, c.dval);
      }
      ++bs;
      w.Switch();
    }
    w.Reset();

    size_t aclit = litcount > prev_tail ? litcount - prev_tail : 0;
    size_t mult = (aclit + eff - 1) / eff;
    size_t rlit = eff * mult;
    prev_tail = rlit + prev_tail - litcount;
    while (rlit--) {
      uint8_t b;
      if (lq >= litq.size()) {
        if (r + 1 < nrounds || is_last)
          b = most_freq;
        else
          break;
      } else {
        b = litq[lq++];
      }
      w.Append(llens[b], lcodes[b]);
      w.Switch();
    }
    w.Reset();
  }

  w.header.Write(2, npostfix);
  w.header.Write(4, ndirect >> npostfix);
  w.header.Write(1, isdelta ? 1 : 0);
  w.header.Write(1, 0);
  std::vector<uint8_t> out = w.Serialize();
  if (out.size() >= n) return {};
  return out;
}

// --- two-pass optimal parse (cost-model shortest path) ----------------------
//
// Pass 1: greedy parse -> histograms -> per-symbol bit costs. Pass 2:
// shortest path over (literal | match) transitions with those costs —
// the same idea as the reference's Zopfli backward references
// (SURVEY §2.11), built fresh around our cost model.

// Per-symbol bit costs derived from the previous pass, mirroring what the
// serializer will actually pay (the reference gets this from brotli's
// ZopfliCostModel over its histograms, PageEncoder.cpp:87-147):
//  - literal / distance costs: real package-merge code lengths
//  - command-symbol cost split by copy code and by implicit-ring0 vs
//    explicit distance (codes < 128 skip the distance symbol entirely)
//  - per-literal amortization of insert-code extra bits
struct CostModel {
  double litcost[256];
  double distcost[kDistAlphabet];
  double cmd_last[24];   // implicit-ring0 command symbol, by copy code
  double cmd_expl[24];   // explicit-distance command symbol, by copy code
  // exact joint command-symbol costs [use_last][ins code][copy code] —
  // the DP tracks each node's pending insert run (anchor), so relax can
  // price the REAL (ins, cpy) symbol + insert extra bits instead of the
  // insert-code expectation above (round-4; the expectation understated
  // long-insert text commands, part of the q11 text parse gap)
  double cmd_sym[2][24][24];
  double lit_step_extra;
  // distance parameterization the serializer will pick for this stream
  // (grid-searched over the previous pass's distances, round 5): pricing
  // relaxes with the REAL (npostfix, ndirect) instead of (0, 0) — short
  // distances under ndirect cost no extra bits, which makes short-copy
  // edges viable on stride-structured data
  uint32_t npostfix = 0, ndirect = 0;
};

void BuildCostModel(const uint8_t* d, uint32_t n,
                    const std::vector<Cmd>& cmds, uint32_t tail,
                    CostModel* cm) {
  uint32_t hl[256] = {0};
  std::vector<uint32_t> hd(kDistAlphabet, 0), hc(kCmdAlphabet, 0);
  uint32_t h_ic[24] = {0};
  uint64_t nl = tail, insert_extra = 0;
  uint32_t pos = 0;
  uint32_t ring[4] = {4, 11, 15, 16};
  // replay pass 1: ring symbols + the explicit-distance set (ring codes
  // do not depend on (npostfix, ndirect), so the grid search below can
  // run on the collected explicit distances alone)
  std::vector<std::pair<uint32_t, uint32_t>> replay;  // (ringsym, dist)
  replay.reserve(cmds.size());
  for (auto& c : cmds) {
    for (uint32_t i = 0; i < c.ins; ++i) hl[d[pos + i]]++;
    nl += c.ins;
    pos += c.ins + c.cpy;
    uint32_t ic = GetInsertCode(c.ins);
    insert_extra += kInsExtra[ic];
    h_ic[ic]++;
    if (!c.cpy) continue;
    uint32_t sym = RingShortCode(c.dist, ring);
    replay.push_back({sym, c.dist});
    if (sym != 0) {
      ring[3] = ring[2]; ring[2] = ring[1]; ring[1] = ring[0];
      ring[0] = c.dist;
    }
  }
  for (uint32_t i = tail ? n - tail : n; i < n; ++i) hl[d[i]]++;

  // (npostfix, ndirect) grid over the explicit distances — the same
  // search the serializer runs (EncodePageFromCommands), so relax prices
  // distances under the parameterization the stream will actually use
  {
    double best_cost = 1e99;
    uint32_t best_np = 0, best_nd = 0;
    for (uint32_t np = 0; np <= 3; ++np) {
      for (uint32_t nd_msb = 0; nd_msb <= 15; ++nd_msb) {
        uint32_t nd = nd_msb << np;
        std::vector<uint32_t> h(kDistAlphabet, 0);
        uint64_t extra_bits = 0;
        bool ok = true;
        for (auto& rp : replay) {
          if (rp.first != UINT32_MAX) continue;
          uint32_t sym, nb, ex;
          EncodeDistance(rp.second, np, nd, sym, nb, ex);
          if (sym >= kDistAlphabet) { ok = false; break; }
          h[sym]++;
          extra_bits += nb;
        }
        if (!ok) continue;
        double cost = static_cast<double>(extra_bits);
        double total = 0;
        for (uint32_t s = 0; s < kDistAlphabet; ++s) total += h[s];
        for (uint32_t s = 0; s < kDistAlphabet; ++s)
          if (h[s]) {
            cost -= h[s] * std::log2(h[s] / total);
            cost += 6.0;
          }
        if (cost < best_cost) {
          best_cost = cost;
          best_np = np;
          best_nd = nd;
        }
      }
    }
    cm->npostfix = best_np;
    cm->ndirect = best_nd;
  }

  // replay pass 2: symbol histograms under the chosen parameterization
  {
    size_t ri = 0;
    for (auto& c : cmds) {
      if (!c.cpy) continue;
      uint32_t sym = replay[ri].first;
      uint32_t dist = replay[ri].second;
      ++ri;
      if (sym == UINT32_MAX) {
        uint32_t nb, ex;
        EncodeDistance(dist, cm->npostfix, cm->ndirect, sym, nb, ex);
      }
      uint32_t ic = GetInsertCode(c.ins);
      uint32_t cc = GetCopyCode(c.cpy);
      bool use_last = (sym == 0 && ic < 8 && cc < 16);
      hc[CombineLengthCodes(ic, cc, use_last)]++;
      if (!use_last && sym < kDistAlphabet) hd[sym]++;
    }
  }

  // literal costs: actual depth-limited code lengths; unseen symbols get
  // an entropy-scale penalty (they would lengthen the stored table too)
  uint8_t ll[256];
  PackageMerge(hl, 256, kMaxDepth, ll);
  double tl = std::max<double>(nl, 1);
  for (int s = 0; s < 256; ++s)
    cm->litcost[s] = hl[s] ? ll[s]
                           : std::min(15.0, std::log2(tl) + 2);

  uint64_t ndist = 0;
  for (uint32_t s = 0; s < kDistAlphabet; ++s) ndist += hd[s];
  std::vector<uint8_t> dl(kDistAlphabet);
  PackageMerge(hd.data(), kDistAlphabet, kMaxDepth, dl.data());
  double td = std::max<double>(ndist, 1);
  for (uint32_t s = 0; s < kDistAlphabet; ++s)
    cm->distcost[s] = hd[s] ? dl[s]
                            : std::min(15.0, std::log2(td) + 4);

  // command-symbol costs: expected code length per copy code, weighting
  // the joint (ins, cpy) symbol over the page's insert-code distribution
  std::vector<uint8_t> cl(kCmdAlphabet);
  PackageMerge(hc.data(), kCmdAlphabet, kMaxDepth, cl.data());
  uint64_t ncmd = cmds.size() ? cmds.size() : 1;
  double unseen = std::min(15.0, std::log2(static_cast<double>(ncmd)) + 2);
  uint64_t tot_ic = 0;
  for (int ic = 0; ic < 24; ++ic) tot_ic += h_ic[ic];
  for (uint32_t cc = 0; cc < 24; ++cc) {
    double wl = 0, we = 0, sw = 0;
    for (uint32_t ic = 0; ic < 24; ++ic) {
      double w = tot_ic ? (h_ic[ic] + 0.1) : 1.0;
      uint32_t pe = CombineLengthCodes(ic, cc, false);
      we += w * (hc[pe] ? cl[pe] : unseen);
      if (ic < 8 && cc < 16) {
        uint32_t pl = CombineLengthCodes(ic, cc, true);
        wl += w * (hc[pl] ? cl[pl] : unseen);
      } else {
        wl += w * unseen;
      }
      sw += w;
    }
    cm->cmd_last[cc] = wl / sw;
    cm->cmd_expl[cc] = we / sw;
  }
  for (uint32_t ic = 0; ic < 24; ++ic) {
    for (uint32_t cc = 0; cc < 24; ++cc) {
      uint32_t pe = CombineLengthCodes(ic, cc, false);
      cm->cmd_sym[0][ic][cc] = hc[pe] ? cl[pe] : unseen;
      if (ic < 8 && cc < 16) {
        uint32_t pl = CombineLengthCodes(ic, cc, true);
        cm->cmd_sym[1][ic][cc] = hc[pl] ? cl[pl] : unseen;
      } else {
        cm->cmd_sym[1][ic][cc] = 1e30;  // not representable as last-dist
      }
    }
  }
  // spread insert extra bits over the literals that cause them (plus a
  // small constant so zero-extra pages still prefer matches slightly)
  cm->lit_step_extra = insert_extra / std::max<double>(nl, 1) + 0.05;
}

void ParseOptimalPass(const uint8_t* d, uint32_t n, int max_chain,
                      const CostModel& cm, bool ring_aware,
                      std::vector<Cmd>& out_cmds, uint32_t& out_tail) {
  const double* litcost = cm.litcost;
  const double* distcost = cm.distcost;
  const double lit_step_extra = cm.lit_step_extra;

  // binary tree over suffixes per 4-byte-hash bucket — the H10 hasher
  // class brotli's HQ Zopfli uses (the reference's q11 matchfinder,
  // PageEncoder.cpp:87-147): one combined insert+search walk per
  // position yields a best-length candidate ladder (closest distance
  // per improving length), strictly better candidate quality than a
  // hash chain at equal depth (round 5; replaced the 512-deep chain)
  constexpr int kBtHashBits = 18;
  std::vector<int32_t> head(1 << kBtHashBits, -1);
  std::vector<int32_t> bt(2ull * (n ? n : 1), -1);
  auto hash4 = [&](uint32_t pos) {
    uint32_t v;
    std::memcpy(&v, d + pos, 4);
    return (v * kHashMul) >> (32 - kBtHashBits);
  };
  auto bt_insert_search = [&](uint32_t i, uint32_t bestL0, bool emit,
                              auto&& on_match) {
    uint32_t h = hash4(i);
    int32_t cur = head[h];
    head[h] = static_cast<int32_t>(i);
    int32_t* pleft = &bt[2ull * i];       // suffixes < suffix(i)
    int32_t* pright = &bt[2ull * i + 1];  // suffixes > suffix(i)
    uint32_t lcpl = 0, lcpr = 0;          // lcp-skip (standard BT trick)
    uint32_t bestL = bestL0;
    int depth = 64;
    const uint8_t* b = d + i;
    const uint32_t limit = n - i;
    while (cur >= 0 && depth-- > 0) {
      const uint8_t* a = d + cur;
      uint32_t L = std::min(lcpl, lcpr);
      while (L < limit && a[L] == b[L]) ++L;
      if (emit && L > bestL) {
        on_match(i - static_cast<uint32_t>(cur), L);
        bestL = L;
      }
      if (L >= limit) {
        // b's whole suffix matched: no byte to order on; splice cur's
        // children in its place (cur drops out of the tree)
        *pleft = bt[2ull * cur];
        *pright = bt[2ull * cur + 1];
        return;
      }
      if (a[L] < b[L]) {
        *pleft = cur;
        pleft = &bt[2ull * cur + 1];
        cur = *pleft;
        lcpl = L;
      } else {
        *pright = cur;
        pright = &bt[2ull * cur];
        cur = *pright;
        lcpr = L;
      }
    }
    *pleft = -1;
    *pright = -1;
  };
  // most-recent position per 3-gram: len-2/3 copy candidates that the
  // 4-byte hash cannot see. Short copies at small distances pay once the
  // cost model prices distances under the real ndirect (round 5) — the
  // lever for stride-structured data where chance 3-gram repeats are
  // everywhere but 4-gram matches are rare
  std::vector<int32_t> head3(1 << 14, -1);
  std::vector<int32_t> prev3(n ? n : 1, -1);
  auto hash3 = [&](uint32_t pos) {
    uint32_t v = d[pos] | (d[pos + 1] << 8) | (d[pos + 2] << 16);
    return (v * kHashMul) >> (32 - 14);
  };

  // precompute distance-1 run lengths in O(n): run_d1[i] = longest L with
  // d[i..i+L) all equal to d[i-1]
  std::vector<uint32_t> run_d1(n + 1, 0);
  for (uint32_t i = n; i-- > 1;) {
    if (d[i] == d[i - 1])
      run_d1[i] = 1 + ((i + 1 < n && d[i + 1] == d[i]) ? run_d1[i + 1] : 0);
  }

  constexpr uint32_t kLcpCap = 1024;  // compare cap; longer via run path
  const double kInf = 1e30;
  std::vector<double> dp(n + 1, kInf);
  std::vector<uint32_t> from_len(n + 1, 0), from_dist(n + 1, 0);
  // approximate distance-cache state per node: the ring inherited from
  // the chosen predecessor (the reference gets this from brotli's Zopfli
  // node state; one ring per node is the standard approximation)
  std::vector<std::array<uint32_t, 4>> ringst(n + 1,
                                              {4u, 11u, 15u, 16u});
  // pending-insert anchor per node (last command end on the best path):
  // lets relax price the exact (ins, cpy) symbol + insert extra bits
  std::vector<uint32_t> anch(n + 1, 0);
  dp[0] = 0;
  for (uint32_t i = 0; i < n; ++i) {
    // literal step (insert extra bits are paid exactly at the command)
    double lc = dp[i] + litcost[d[i]];
    if (lc < dp[i + 1]) {
      dp[i + 1] = lc;
      from_len[i + 1] = 0;
      ringst[i + 1] = ringst[i];
      anch[i + 1] = anch[i];
    }
    uint32_t skip_to = 0;  // set by the long-match cutoff
    bool inserted_bt = false;
    if (i + 2 <= n) {
      auto relax = [&](uint32_t dist, uint32_t maxlen) {
        if (!dist || maxlen < 2) return;
        uint32_t rsym = ring_aware
                            ? RingShortCode(dist, ringst[i].data())
                            : UINT32_MAX;
        double dc;
        if (rsym != UINT32_MAX) {
          dc = distcost[rsym];
        } else {
          uint32_t sym, nb, ex;
          EncodeDistance(dist, cm.npostfix, cm.ndirect, sym, nb, ex);
          dc = (sym < kDistAlphabet ? distcost[sym] : 20.0) + nb;
        }
        std::array<uint32_t, 4> rnew = ringst[i];
        if (rsym != 0) {
          rnew = {dist, ringst[i][0], ringst[i][1], ringst[i][2]};
        }
        // exact command pricing: the pending insert run is known from
        // the node's anchor, so the real joint (ins, cpy) symbol and
        // both extra-bit fields are charged (round-4; replaces the
        // insert-code expectation)
        uint32_t ic2 = GetInsertCode(i - anch[i]);
        double icost = kInsExtra[ic2];
        const double* sym_e = cm.cmd_sym[0][ic2];
        const double* sym_l = cm.cmd_sym[1][ic2];
        // try the full length and the base length of each copy code bucket
        // (short lengths 2-3 included: a ring-hit len-2 copy beats two
        // literals whenever the command symbol is cheap)
        uint32_t lens[28];
        int nl2 = 0;
        lens[nl2++] = maxlen;
        for (int cc2 = 0; cc2 < 24 && kCpyBase[cc2] < maxlen; ++cc2)
          lens[nl2++] = kCpyBase[cc2];
        for (int t = 0; t < nl2; ++t) {
          uint32_t L = lens[t];
          uint32_t cc2 = GetCopyCode(L);
          double ccost;
          if (rsym == 0 && cc2 < 16)
            ccost = std::min(sym_l[cc2], sym_e[cc2] + dc);
          else
            ccost = sym_e[cc2] + dc;
          double cost = dp[i] + icost + ccost + kCpyExtra[cc2];
          if (cost < dp[i + L]) {
            dp[i + L] = cost;
            from_len[i + L] = L;
            from_dist[i + L] = dist;
            ringst[i + L] = rnew;
            anch[i + L] = i + L;
          }
        }
      };
      // ring probe: short copies at the inherited ring distances cost no
      // distance extra bits, so even len 2-3 can pay (brotli's Zopfli
      // checks its distance cache the same way)
      if (ring_aware) {
        // exact ring entries, plus the +/-{1,2,3} offsets of ring[0]
        // and ring[1] (short codes 4-15; zero extra bits) — brotli's
        // Zopfli probes its distance cache the same way
        uint32_t probes[10];
        int np3 = 0;
        probes[np3++] = ringst[i][0];
        probes[np3++] = ringst[i][1];
        probes[np3++] = ringst[i][2];
        probes[np3++] = ringst[i][3];
        for (uint32_t mag = 1; mag <= 3; ++mag) {
          if (ringst[i][0] > mag) probes[np3++] = ringst[i][0] - mag;
          probes[np3++] = ringst[i][0] + mag;
        }
        for (int k = 0; k < np3; ++k) {
          uint32_t dist = probes[k];
          if (!dist || dist > i) continue;
          const uint8_t* a = d + i - dist;
          const uint8_t* b = d + i;
          uint32_t limit = std::min(n - i, 16u);
          uint32_t L = 0;
          while (L < limit && a[L] == b[L]) ++L;
          if (L >= 2) relax(dist, L);
        }
      }
      // 3-gram probe: a short chain of recent occurrences; only
      // worthwhile when the distance is cheap (<= a few direct/short
      // symbols), which the relax cost model decides — the probe just
      // supplies edges the 4-byte hash cannot see
      if (i + 3 <= n) {
        int32_t c3 = head3[hash3(i)];
        const uint8_t* b = d + i;
        uint32_t best3 = 0;
        for (int ch3 = 0; ch3 < 16 && c3 >= 0 && i - c3 <= 65536; ++ch3) {
          const uint8_t* a = d + c3;
          uint32_t limit = std::min(n - i, 64u);
          uint32_t L = 0;
          while (L < limit && a[L] == b[L]) ++L;
          if (L >= 2 && L > best3) {
            relax(i - c3, L);
            best3 = L;
          }
          c3 = prev3[c3];
        }
      }
      uint32_t rl = std::min<uint32_t>(run_d1[i], n - i);
      relax(1, rl);
      uint32_t bestL = rl;
      // binary-tree candidates (search half of the combined op below):
      // inside a long run candidates add nothing the run lacks
      if (i + 4 <= n) {
        bt_insert_search(i, bestL, rl < 64,
                         [&](uint32_t dist, uint32_t L) {
                           relax(dist, L);
                           if (L > bestL) bestL = L;
                         });
        inserted_bt = true;
      }
      // very long matches are committed immediately (zopfli-style cutoff):
      // transitions from inside the covered span add ~nothing and cost n*L
      if (bestL >= 325) skip_to = i + bestL - 1;
    }
    if (!inserted_bt && i + 4 <= n)
      bt_insert_search(i, 0, false, [](uint32_t, uint32_t) {});
    if (i + 3 <= n) {
      uint32_t h3 = hash3(i);
      prev3[i] = head3[h3];
      head3[h3] = static_cast<int32_t>(i);
    }
    if (skip_to > i) {
      // sparse insertion across the skipped span
      for (uint32_t p2 = i + 8; p2 + 4 <= n && p2 < skip_to; p2 += 8) {
        bt_insert_search(p2, 0, false, [](uint32_t, uint32_t) {});
        uint32_t h3 = hash3(p2);
        prev3[p2] = head3[h3];
        head3[h3] = static_cast<int32_t>(p2);
      }
      i = skip_to;
    }
  }

  // backtrack: matches in reverse order (from_len==0 marks literal steps)
  std::vector<std::pair<uint32_t, std::pair<uint32_t, uint32_t>>> matches;
  uint32_t p = n;
  while (p > 0) {
    if (from_len[p] == 0) {
      --p;
      continue;
    }
    uint32_t L = from_len[p], dist = from_dist[p];
    matches.push_back({p - L, {L, dist}});
    p -= L;
  }
  std::reverse(matches.begin(), matches.end());
  out_cmds.clear();
  uint32_t pos = 0;
  for (auto& m : matches) {
    uint32_t start = m.first, L = m.second.first, dist = m.second.second;
    out_cmds.push_back({start - pos, L, dist, 0, -1, 0, 0});
    pos = start + L;
  }
  out_tail = n - pos;
}

bool ParseOptimal(const uint8_t* d, uint32_t n, int max_chain,
                  bool ring_aware, bool npnd_aware,
                  std::vector<Cmd>& out_cmds, uint32_t& out_tail) {
  // pass 0: greedy statistics; then iterate the cost model, like the
  // reference's Zopfli iterations (SURVEY §2.11). npnd_aware=false
  // forces (npostfix, ndirect) = (0, 0) pricing; returns whether any
  // iteration actually priced under a nonzero parameterization (callers
  // skip the redundant second variant when not).
  std::vector<Cmd> cur;
  uint32_t cur_tail = 0;
  FindMatches(d, n, max_chain, cur, cur_tail);
  CostModel cm;
  bool npnd_used = false;
  int iters = ring_aware ? 3 : 2;
  for (int it = 0; it < iters; ++it) {
    BuildCostModel(d, n, cur, cur_tail, &cm);
    if (!npnd_aware) {
      cm.npostfix = 0;
      cm.ndirect = 0;
    }
    npnd_used |= (cm.npostfix != 0 || cm.ndirect != 0);
    cur.clear();
    ParseOptimalPass(d, n, max_chain, cm, ring_aware, cur, cur_tail);
  }
  out_cmds = std::move(cur);
  out_tail = cur_tail;
  return npnd_used;
}

std::vector<uint8_t> EncodePage(const uint8_t* data, uint32_t n,
                                bool is_last, int max_chain, int quality,
                                std::vector<Cmd>* win_cmds = nullptr,
                                uint32_t* win_tail = nullptr) {
  std::vector<Cmd> cmds;
  uint32_t tail = 0;
  FindMatches(data, n, max_chain, cmds, tail);
  std::vector<Cmd> bcmds = cmds;
  uint32_t btail = tail;
  std::vector<uint8_t> greedy =
      EncodePageFromCommands(data, n, is_last, cmds, tail);
  if (quality < 10 || n < 64) {
    if (win_cmds) { *win_cmds = std::move(bcmds); *win_tail = btail; }
    return greedy;
  }
  // q11 searches deep chains, like the reference's HQ Zopfli hasher
  // (PageEncoder.cpp:87-147 wraps BrotliCreateHqZopfliBackwardReferences);
  // 256 -> 512 in round 4: -0.15% corpus for ~1.4x q11 wall time
  max_chain = std::max(max_chain, 512);
  // q11: cost-model optimal parses, best-of over the pricing variants —
  // ring-aware distances, and (round 5) whether relax prices distances
  // under the grid-searched (npostfix, ndirect) or under (0, 0). The
  // parameterized pricing wins on stride-structured data (short-distance
  // copies become viable) but can mislead the model on small streams, so
  // neither dominates; the second variant is skipped when the model
  // never picked a nonzero parameterization.
  std::vector<uint8_t> best = greedy;
  bool npnd_used = false;
  for (int v = 0; v < 2; ++v) {
    if (v == 1 && !npnd_used) break;
    std::vector<Cmd> ocmds;
    uint32_t otail = 0;
    npnd_used = ParseOptimal(data, n, max_chain, true, v == 0, ocmds,
                             otail) || npnd_used;
    std::vector<Cmd> ocopy = ocmds;
    std::vector<uint8_t> opt =
        EncodePageFromCommands(data, n, is_last, ocmds, otail);
    if (!opt.empty() && (best.empty() || opt.size() < best.size())) {
      best = std::move(opt);
      bcmds = std::move(ocopy);
      btail = otail;
    }
  }
  if (win_cmds) { *win_cmds = std::move(bcmds); *win_tail = btail; }
  return best;
}

}  // namespace

extern "C" {

// Serialize one page from externally-found commands (e.g. the TPU bulk
// matcher). The page is stored raw when not compressible (signalled by
// *out_size == n). Returns 0 on success.
int blg_encode_page_cmds(const uint8_t* data, uint64_t n, int is_last,
                         int isdelta, const uint32_t* ins,
                         const uint32_t* cpy, const uint32_t* dist,
                         uint64_t ncmds, uint8_t* dst, uint64_t cap,
                         uint64_t* out_size) {
  std::vector<Cmd> cmds;
  cmds.reserve(ncmds);
  uint64_t covered = 0;
  for (uint64_t i = 0; i < ncmds; ++i) {
    cmds.push_back({ins[i], cpy[i], dist[i], 0, -1, 0, 0});
    covered += ins[i] + cpy[i];
    if (covered > n) return 1;
    if (cpy[i] && (dist[i] == 0 || dist[i] > covered - cpy[i] ||
                   cpy[i] < 2))
      return 1;
  }
  uint32_t tail = static_cast<uint32_t>(n - covered);
  std::vector<uint8_t> comp = EncodePageFromCommands(
      data, static_cast<uint32_t>(n), is_last != 0, cmds, tail,
      isdelta != 0);
  if (comp.empty() || comp.size() >= n) {
    if (n > cap) return 3;
    std::memcpy(dst, data, n);
    *out_size = n;
    return 0;
  }
  if (comp.size() > cap) return 3;
  std::memcpy(dst, comp.data(), comp.size());
  *out_size = comp.size();
  return 0;
}

// Export the q11-winning command stream for one page (analysis/debug: lets
// Python compute entropy-ideal costs per section and compare parses).
// Returns 0 on success, 3 if cap is too small.
int blg_parse_page(const uint8_t* data, uint64_t n, int max_chain,
                   int quality, uint32_t* ins, uint32_t* cpy,
                   uint32_t* dist, uint64_t cap, uint64_t* ncmds,
                   uint64_t* tail) {
  std::vector<Cmd> cmds;
  uint32_t t = 0;
  EncodePage(data, static_cast<uint32_t>(n), true, max_chain, quality,
             &cmds, &t);
  if (cmds.size() > cap) return 3;
  for (size_t i = 0; i < cmds.size(); ++i) {
    ins[i] = cmds[i].ins;
    cpy[i] = cmds[i].cpy;
    dist[i] = cmds[i].dist;
  }
  *ncmds = cmds.size();
  *tail = t;
  return 0;
}

// Progress/abort callback: fb(msg_type, pages_done, pages_total) -> nonzero
// aborts the encode (the analog of BROTLIG_Feedback_Proc on the reference's
// worker pool, BrotligEncoder.cpp:402-409).
typedef int (*blg_feedback_fn)(int, uint32_t, uint32_t);

// Encode a whole container (no preconditioning). Returns 0 on success,
// 5 when the feedback callback requested an abort.
int blg_encode_ex(const uint8_t* src, uint64_t n, uint8_t* dst,
                  uint64_t dst_cap, uint64_t* out_size, uint32_t page_size,
                  int max_chain, int num_threads, int quality,
                  blg_feedback_fn feedback) {
  if (page_size < 32768 || page_size > 131072 ||
      (page_size & (page_size - 1)))
    return 1;
  uint32_t num_pages = static_cast<uint32_t>((n + page_size - 1) / page_size);
  if (num_pages > 65535) return 1;

  // header
  uint32_t last = static_cast<uint32_t>(n - uint64_t(n / page_size) * page_size);
  uint32_t psi = BitLength(page_size / 32768) - 1;
  if (dst_cap < 8) return 3;
  dst[0] = 5;
  dst[1] = 5 ^ 0xFF;
  dst[2] = num_pages & 0xFF;
  dst[3] = (num_pages >> 8) & 0xFF;
  uint32_t bits = psi | (last << 2);
  std::memcpy(dst + 4, &bits, 4);
  if (n == 0) {
    *out_size = 8;
    return 0;
  }

  std::vector<std::vector<uint8_t>> pages(num_pages);
  std::atomic<uint32_t> next{0};
  std::atomic<uint32_t> done{0};
  std::atomic<bool> abort_flag{false};
  auto worker = [&]() {
    for (;;) {
      uint32_t i = next.fetch_add(1);
      if (i >= num_pages || abort_flag.load(std::memory_order_relaxed))
        break;
      uint64_t off = uint64_t(i) * page_size;
      uint32_t pn = static_cast<uint32_t>(
          std::min<uint64_t>(page_size, n - off));
      bool is_last = (i == num_pages - 1);
      std::vector<uint8_t> comp =
          EncodePage(src + off, pn, is_last, max_chain, quality);
      if (comp.empty() || comp.size() >= pn)
        pages[i].assign(src + off, src + off + pn);  // raw
      else
        pages[i] = std::move(comp);
      uint32_t d = done.fetch_add(1) + 1;
      if (feedback && feedback(/*progress*/ 0, d, num_pages))
        abort_flag.store(true, std::memory_order_relaxed);
    }
  };
  int nt = num_threads > 0
               ? num_threads
               : static_cast<int>(std::thread::hardware_concurrency());
  nt = std::max(1, std::min(nt, 128));
  if (nt == 1 || num_pages < 2) {
    worker();
  } else {
    std::vector<std::thread> pool;
    for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  if (abort_flag.load()) return 5;

  // page table + payload
  uint64_t posn = 8 + 4ull * num_pages;
  if (posn > dst_cap) return 3;
  uint32_t* table = reinterpret_cast<uint32_t*>(dst + 8);
  uint64_t off = 0;
  for (uint32_t i = 0; i < num_pages; ++i) {
    table[i] = static_cast<uint32_t>(off);
    off += pages[i].size();
  }
  table[0] = static_cast<uint32_t>(pages[num_pages - 1].size());
  for (uint32_t i = 0; i < num_pages; ++i) {
    if (posn + pages[i].size() > dst_cap) return 3;
    std::memcpy(dst + posn, pages[i].data(), pages[i].size());
    posn += pages[i].size();
  }
  *out_size = posn;
  return 0;
}

// Back-compatible entry without a feedback callback.
int blg_encode(const uint8_t* src, uint64_t n, uint8_t* dst,
               uint64_t dst_cap, uint64_t* out_size, uint32_t page_size,
               int max_chain, int num_threads, int quality) {
  return blg_encode_ex(src, n, dst, dst_cap, out_size, page_size, max_chain,
                       num_threads, quality, nullptr);
}

}  // extern "C"
