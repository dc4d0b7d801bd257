// A Zstandard decoder (RFC 8878) and CRC-32C (Castagnoli), host code with a
// plain C interface, loaded by sdbc_tpu_torch/utils/zstd.py with ctypes.
//
// It reads what orbax / tensorstore write into a checkpoint: zstd frames
// around every zarr chunk and around OCDBT manifests and B-tree nodes, whose
// footers carry a CRC-32C.  It replaces no TPU kernel: checkpoint reading is
// host work, bound by the Huffman decode of the literals (bf16 and fp32
// weights compress mostly by entropy coding, with few matches), so the
// literal streams are decoded four at a time, interleaved, and the caller
// decodes many chunks on threads.
//
//   int64_t zstd_decompress(const uint8_t* src, size_t n,
//                           uint8_t* dst, size_t cap)
//       decodes every frame of src (concatenated frames; skippable frames
//       are passed over) into dst; returns the bytes written, or a negative
//       code (zstd_error_name) on any malformed input, a dictionary, a
//       checksum that differs or a dst too small.  Never writes past
//       dst + cap nor reads past src + n.
//   int64_t zstd_decompress_batch(size_t n, const uint8_t* const* src,
//                                 const size_t* len, uint8_t* const* dst,
//                                 const size_t* cap, int64_t* out)
//       zstd_decompress of n frames in turn, out[i] its result; returns the
//       number that failed (one call a batch: small chunks do not pay a
//       foreign call each).
//   int64_t zstd_content_size(const uint8_t* src, size_t n)
//       the sum of the frames' Frame_Content_Size fields; -1 when a frame
//       does not state it, another negative code on a malformed header.
//   uint32_t crc32c(const uint8_t* p, size_t n)
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -o libsdbc_zstd.so zstd_decode.cc
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <memory>

namespace {

using u8 = uint8_t;
using u16 = uint16_t;
using u32 = uint32_t;
using u64 = uint64_t;

enum : int {
  kCorrupt = -1,      // malformed data
  kTruncated = -2,    // the input ends inside a frame
  kDstTooSmall = -3,  // the output does not fit in cap
  kDictionary = -4,   // a dictionary id other than 0
  kChecksum = -5,     // the content checksum differs
  kBadMagic = -6,     // neither a zstd nor a skippable frame
  kReserved = -7,     // a reserved bit or block type set
};

struct Error {
  int code;
};

[[noreturn]] inline void fail(int code) { throw Error{code}; }
inline void check(bool ok, int code = kCorrupt) {
  if (!ok) fail(code);
}

inline u32 le16(const u8* p) { return p[0] | (u32(p[1]) << 8); }
inline u32 le24(const u8* p) { return le16(p) | (u32(p[2]) << 16); }
inline u32 le32(const u8* p) {
  u32 v;
  std::memcpy(&v, p, 4);
  return v;
}
inline u64 le64(const u8* p) {
  u64 v;
  std::memcpy(&v, p, 8);
  return v;
}
inline int highbit(u32 v) { return 31 - __builtin_clz(v); }  // v > 0

// ---------------------------------------------------------------------------
// XXH64 (the content checksum: its low 32 bits)

constexpr u64 P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
              P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
              P5 = 2870177450012600261ULL;

inline u64 rotl(u64 x, int r) { return (x << r) | (x >> (64 - r)); }
inline u64 xround(u64 acc, u64 in) { return rotl(acc + in * P2, 31) * P1; }
inline u64 xmerge(u64 acc, u64 v) { return (acc ^ xround(0, v)) * P1 + P4; }

u64 xxh64(const u8* p, size_t n) {
  const u8* end = p + n;
  u64 h;
  if (n >= 32) {
    u64 v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    for (; p + 32 <= end; p += 32) {
      v1 = xround(v1, le64(p));
      v2 = xround(v2, le64(p + 8));
      v3 = xround(v3, le64(p + 16));
      v4 = xround(v4, le64(p + 24));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xmerge(xmerge(xmerge(xmerge(h, v1), v2), v3), v4);
  } else {
    h = P5;
  }
  h += u64(n);
  for (; p + 8 <= end; p += 8) h = rotl(h ^ xround(0, le64(p)), 27) * P1 + P4;
  if (p + 4 <= end) {
    h = rotl(h ^ (u64(le32(p)) * P1), 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; ++p) h = rotl(h ^ (*p * P5), 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ---------------------------------------------------------------------------
// bit streams

// Random access to the bits of [src, src + len), bit 0 the lowest bit of
// src[0]; bits outside the buffer read as zero.  Reads of up to 56 bits.
struct Bits {
  const u8* src;
  size_t len;

  inline u64 get(int64_t pos, int n) const {
    if (n == 0) return 0;
    if (pos < 0) {
      int64_t hi = pos + n;
      return hi <= 0 ? 0 : get(0, int(hi)) << (-pos);
    }
    size_t byte = size_t(pos >> 3);
    u64 v = 0;
    if (byte + 8 <= len) {
      v = le64(src + byte);
    } else if (byte < len) {
      std::memcpy(&v, src + byte, len - byte);
    }
    return (v >> (pos & 7)) & ((u64(1) << n) - 1);
  }
};

// A stream read from its end: the last byte's highest set bit marks the
// start, the first bits read are the highest.  ``pos`` counts the bits
// still unread; reading past the start gives zeros and a negative pos.
struct BackBits {
  Bits bits;
  int64_t pos;

  BackBits(const u8* src, size_t len) : bits{src, len} {
    check(len > 0 && src[len - 1] != 0);
    pos = int64_t(len) * 8 - (8 - highbit(src[len - 1]));
  }
  inline u64 read(int n) {
    pos -= n;
    return bits.get(pos, n);
  }
  inline u64 peek(int n) const { return bits.get(pos - n, n); }
};

// ---------------------------------------------------------------------------
// FSE

constexpr int kMaxFseLog = 9;

struct FseEntry {
  u16 base;
  u8 symbol;
  u8 nbits;
};

struct FseTable {
  int log = -1;  // -1: no table
  FseEntry e[1 << kMaxFseLog];
};

// Builds the decoding table of normalized counts ``norm`` (-1: a symbol of
// probability "less than 1") over ``nsym`` symbols.
void fse_build(FseTable& t, const int16_t* norm, int nsym, int log) {
  const int size = 1 << log;
  u16 next[256];
  int high = size - 1;
  for (int s = 0; s < nsym; ++s) {
    if (norm[s] == -1) {
      t.e[high--].symbol = u8(s);
      next[s] = 1;
    }
  }
  const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  int pos = 0;
  for (int s = 0; s < nsym; ++s) {
    if (norm[s] <= 0) continue;
    next[s] = u16(norm[s]);
    for (int i = 0; i < norm[s]; ++i) {
      t.e[pos].symbol = u8(s);
      do {
        pos = (pos + step) & mask;
      } while (pos > high);
    }
  }
  check(pos == 0);
  for (int i = 0; i < size; ++i) {
    const u32 d = next[t.e[i].symbol]++;
    const int nb = log - highbit(d);
    t.e[i].nbits = u8(nb);
    t.e[i].base = u16((d << nb) - size);
  }
  t.log = log;
}

// Reads an FSE table description at [src, src + len): returns its bytes.
size_t fse_read(FseTable& t, const u8* src, size_t len, int max_log,
                int max_symbol) {
  Bits b{src, len};
  const int64_t total = int64_t(len) * 8;
  int64_t pos = 0;
  auto take = [&](int n) -> u32 {
    check(pos + n <= total, kCorrupt);
    u32 v = u32(b.get(pos, n));
    pos += n;
    return v;
  };
  const int log = int(take(4)) + 5;
  check(log <= max_log);
  int16_t norm[256];
  int remaining = 1 << log, s = 0;
  while (remaining > 0) {
    check(s <= max_symbol);
    const int nb = highbit(u32(remaining + 1)) + 1;
    check(pos + nb - 1 <= total);
    u32 val = u32(b.get(pos, nb));  // may look one bit past the end
    const u32 lower = (u32(1) << (nb - 1)) - 1;
    const u32 threshold = (u32(1) << nb) - 1 - u32(remaining + 1);
    if ((val & lower) < threshold) {
      val &= lower;
      pos += nb - 1;
    } else {
      check(pos + nb <= total);
      if (val > lower) val -= threshold;
      pos += nb;
    }
    const int p = int(val) - 1;
    remaining -= p < 0 ? -p : p;
    check(remaining >= 0);
    norm[s++] = int16_t(p);
    if (p == 0) {
      for (;;) {
        const u32 rep = take(2);
        for (u32 i = 0; i < rep; ++i) {
          check(s <= max_symbol);
          norm[s++] = 0;
        }
        if (rep != 3) break;
      }
    }
  }
  fse_build(t, norm, s, log);
  return size_t((pos + 7) >> 3);
}

void fse_rle(FseTable& t, u8 symbol) {
  t.e[0] = FseEntry{0, symbol, 0};
  t.log = 0;
}

// ---------------------------------------------------------------------------
// Huffman literals

constexpr int kMaxHufLog = 11;

struct HufTable {
  int log = 0;  // 0: no table
  u16 e[1 << kMaxHufLog];  // symbol | nbits << 8
};

// Reads a Huffman tree description: returns its bytes.
size_t huf_read(HufTable& t, const u8* src, size_t len) {
  check(len >= 1);
  u8 w[256];
  int nw;
  size_t used;
  const int hb = src[0];
  if (hb >= 128) {
    nw = hb - 127;
    used = 1 + size_t(nw + 1) / 2;
    check(used <= len);
    for (int i = 0; i < nw; ++i)
      w[i] = (i & 1) ? (src[1 + i / 2] & 15) : (src[1 + i / 2] >> 4);
  } else {
    used = 1 + size_t(hb);
    check(hb > 0 && used <= len);
    FseTable ft;
    const size_t hdr = fse_read(ft, src + 1, size_t(hb), 6, 255);
    check(hdr < size_t(hb));
    BackBits bb(src + 1 + hdr, size_t(hb) - hdr);
    const FseEntry* e = ft.e;
    u32 s1 = u32(bb.read(ft.log)), s2 = u32(bb.read(ft.log));
    nw = 0;
    // two states over one stream, alternating, until the stream is spent
    for (;;) {
      check(nw < 255);
      w[nw++] = e[s1].symbol;
      s1 = e[s1].base + u32(bb.read(e[s1].nbits));
      if (bb.pos < 0) {
        check(nw < 255);
        w[nw++] = e[s2].symbol;
        break;
      }
      check(nw < 255);
      w[nw++] = e[s2].symbol;
      s2 = e[s2].base + u32(bb.read(e[s2].nbits));
      if (bb.pos < 0) {
        check(nw < 255);
        w[nw++] = e[s1].symbol;
        break;
      }
    }
  }
  u32 sum = 0;
  for (int i = 0; i < nw; ++i) {
    check(w[i] <= kMaxHufLog);
    if (w[i]) sum += u32(1) << (w[i] - 1);
  }
  check(sum > 0);
  const int log = highbit(sum) + 1;
  check(log <= kMaxHufLog);
  const u32 left = (u32(1) << log) - sum;
  check((left & (left - 1)) == 0);  // the last weight completes a power of 2
  w[nw++] = u8(highbit(left) + 1);
  // codes: the longest first, in symbol order within a length
  int count[kMaxHufLog + 2] = {0};
  for (int i = 0; i < nw; ++i)
    if (w[i]) ++count[log + 1 - w[i]];
  u32 start[kMaxHufLog + 2];
  u32 at = 0;
  for (int nb = log; nb >= 1; --nb) {
    start[nb] = at;
    at += u32(count[nb]) << (log - nb);
  }
  check(at == (u32(1) << log));
  for (int i = 0; i < nw; ++i) {
    if (!w[i]) continue;
    const int nb = log + 1 - w[i];
    const u32 span = u32(1) << (log - nb);
    const u16 v = u16(i | (nb << 8));
    for (u32 k = 0; k < span; ++k) t.e[start[nb] + k] = v;
    start[nb] += span;
  }
  t.log = log;
  return used;
}

// One stream of ``n`` symbols.
void huf_stream(const HufTable& t, const u8* src, size_t len, u8* out,
                size_t n) {
  BackBits bb(src, len);
  const int log = t.log;
  for (size_t i = 0; i < n; ++i) {
    const u16 v = t.e[bb.peek(log)];
    out[i] = u8(v);
    bb.pos -= v >> 8;
  }
  check(bb.pos == 0);
}

// Four streams of ``n1`` symbols each but the last, interleaved.
void huf_four(const HufTable& t, const u8* const src[4],
              const size_t len[4], u8* out, size_t n1, size_t n4) {
  BackBits b0(src[0], len[0]), b1(src[1], len[1]), b2(src[2], len[2]),
      b3(src[3], len[3]);
  const int log = t.log;
  u8 *o0 = out, *o1 = out + n1, *o2 = out + 2 * n1, *o3 = out + 3 * n1;
  const size_t both = n1 < n4 ? n1 : n4;
  for (size_t i = 0; i < both; ++i) {
    const u16 v0 = t.e[b0.peek(log)], v1 = t.e[b1.peek(log)],
              v2 = t.e[b2.peek(log)], v3 = t.e[b3.peek(log)];
    o0[i] = u8(v0);
    o1[i] = u8(v1);
    o2[i] = u8(v2);
    o3[i] = u8(v3);
    b0.pos -= v0 >> 8;
    b1.pos -= v1 >> 8;
    b2.pos -= v2 >> 8;
    b3.pos -= v3 >> 8;
  }
  BackBits* bs[4] = {&b0, &b1, &b2, &b3};
  u8* os[4] = {o0, o1, o2, o3};
  for (int s = 0; s < 4; ++s) {
    const size_t n = s < 3 ? n1 : n4;
    for (size_t i = both; i < n; ++i) {
      const u16 v = t.e[bs[s]->peek(log)];
      os[s][i] = u8(v);
      bs[s]->pos -= v >> 8;
    }
    check(bs[s]->pos == 0);
  }
}

// ---------------------------------------------------------------------------
// sequences

constexpr u32 kLLBase[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,
                             9,  10, 11,  12,  13,  14,   15,   16,   18,
                             20, 22, 24,  28,  32,  40,   48,   64,   128,
                             256, 512, 1024, 2048, 4096, 8192, 16384, 32768,
                             65536};
constexpr u8 kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                            0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3,
                            4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
constexpr u32 kMLBase[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11, 12,  13,  14,   15,   16,
    17, 18, 19, 20, 21, 22, 23, 24, 25, 26,  27,  28,   29,   30,
    31, 32, 33, 34, 35, 37, 39, 41, 43, 47,  51,  59,   67,   83,
    99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
constexpr u8 kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                            0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                            0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                            5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
constexpr int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                                    2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                                    2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
constexpr int16_t kMLDefault[53] = {
    1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
constexpr int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1,
                                    1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                    1, 1, 1, 1, -1, -1, -1, -1, -1};

constexpr size_t kMaxBlock = 128 * 1024;

struct FrameState {
  HufTable huf;
  FseTable ll, of, ml;
  u64 rep[3] = {1, 4, 8};
  u8 lit[kMaxBlock];
};

// One of the three tables of a sequences section, by its mode: returns the
// bytes of its description.
size_t seq_table(FseTable& t, int mode, const u8* src, size_t len,
                 const int16_t* dflt, int ndflt, int dflt_log, int max_log,
                 int max_symbol) {
  switch (mode) {
    case 0:
      fse_build(t, dflt, ndflt, dflt_log);
      return 0;
    case 1:
      check(len >= 1);
      check(src[0] <= max_symbol);
      fse_rle(t, src[0]);
      return 1;
    case 2:
      return fse_read(t, src, len, max_log, max_symbol);
    default:
      check(t.log >= 0);  // repeat: the previous block's table
      return 0;
  }
}

// Copies ``n`` bytes from ``op - off`` to ``op`` (the ranges may overlap:
// the output repeats with period ``off``, so a copy from twice as far back
// is again the pattern, and each copy doubles what the next may take).
inline void match_copy(u8* op, size_t off, size_t n) {
  size_t dist = off;
  while (n) {
    const size_t k = n < dist ? n : dist;
    std::memcpy(op, op - dist, k);
    op += k;
    n -= k;
    dist += k;
  }
}

// Decodes a compressed block at [src, src + len) to ``op``; returns the
// bytes written.  ``frame`` is the frame's first output byte.
size_t block(FrameState& st, const u8* src, size_t len, u8* op,
             const u8* oend, const u8* frame, size_t block_max) {
  // literals section
  check(len >= 1);
  const int ltype = src[0] & 3, sf = (src[0] >> 2) & 3;
  const u8* lits;
  size_t nlit, at;
  if (ltype <= 1) {
    if ((sf & 1) == 0) {
      nlit = src[0] >> 3;
      at = 1;
    } else if (sf == 1) {
      check(len >= 2);
      nlit = (src[0] >> 4) | (size_t(src[1]) << 4);
      at = 2;
    } else {
      check(len >= 3);
      nlit = (src[0] >> 4) | (size_t(src[1]) << 4) | (size_t(src[2]) << 12);
      at = 3;
    }
    check(nlit <= block_max);
    if (ltype == 0) {
      check(at + nlit <= len);
      lits = src + at;
      at += nlit;
    } else {
      check(at + 1 <= len);
      std::memset(st.lit, src[at], nlit);
      lits = st.lit;
      at += 1;
    }
  } else {
    size_t csize;
    int nstreams = sf == 0 ? 1 : 4;
    if (sf <= 1) {
      check(len >= 3);
      const u32 h = le24(src);
      nlit = (h >> 4) & 0x3FF;
      csize = (h >> 14) & 0x3FF;
      at = 3;
    } else if (sf == 2) {
      check(len >= 4);
      const u32 h = le32(src);
      nlit = (h >> 4) & 0x3FFF;
      csize = h >> 18;
      at = 4;
    } else {
      check(len >= 5);
      const u64 h = le32(src) | (u64(src[4]) << 32);
      nlit = size_t((h >> 4) & 0x3FFFF);
      csize = size_t((h >> 22) & 0x3FFFF);
      at = 5;
    }
    check(nlit <= block_max && at + csize <= len);
    const u8* p = src + at;
    size_t plen = csize;
    if (ltype == 2) {
      const size_t used = huf_read(st.huf, p, plen);
      p += used;
      plen -= used;
    } else {
      check(st.huf.log > 0);  // treeless: the previous block's tree
    }
    if (nstreams == 1) {
      huf_stream(st.huf, p, plen, st.lit, nlit);
    } else {
      check(plen >= 6);
      const size_t l1 = le16(p), l2 = le16(p + 2), l3 = le16(p + 4);
      check(l1 + l2 + l3 + 6 <= plen);
      const size_t l4 = plen - 6 - l1 - l2 - l3;
      const u8* s[4] = {p + 6, p + 6 + l1, p + 6 + l1 + l2,
                        p + 6 + l1 + l2 + l3};
      const size_t ls[4] = {l1, l2, l3, l4};
      const size_t n1 = (nlit + 3) / 4;
      check(3 * n1 <= nlit);
      huf_four(st.huf, s, ls, st.lit, n1, nlit - 3 * n1);
    }
    lits = st.lit;
    at += csize;
  }
  // sequences section
  check(at < len);
  size_t nseq = src[at++];
  if (nseq >= 128) {
    if (nseq < 255) {
      check(at < len);
      nseq = ((nseq - 128) << 8) | src[at++];
    } else {
      check(at + 2 <= len);
      nseq = le16(src + at) + 0x7F00;
      at += 2;
    }
  }
  u8* const op0 = op;
  const u8* const lend = lits + nlit;
  if (nseq > 0) {
    check(at < len);
    const int modes = src[at++];
    check((modes & 3) == 0, kReserved);
    at += seq_table(st.ll, modes >> 6, src + at, len - at, kLLDefault, 36, 6,
                    9, 35);
    at += seq_table(st.of, (modes >> 4) & 3, src + at, len - at, kOFDefault,
                    29, 5, 8, 31);
    at += seq_table(st.ml, (modes >> 2) & 3, src + at, len - at, kMLDefault,
                    53, 6, 9, 52);
    check(at < len);
    BackBits bb(src + at, len - at);
    const FseEntry *ll = st.ll.e, *of = st.of.e, *ml = st.ml.e;
    u32 sll = u32(bb.read(st.ll.log)), sof = u32(bb.read(st.of.log)),
        sml = u32(bb.read(st.ml.log));
    u64* rep = st.rep;
    for (size_t i = 0; i < nseq; ++i) {
      const int ofc = of[sof].symbol, llc = ll[sll].symbol,
                mlc = ml[sml].symbol;
      const u64 ofv = (u64(1) << ofc) + bb.read(ofc);
      const size_t mlen = kMLBase[mlc] + size_t(bb.read(kMLBits[mlc]));
      const size_t llen = kLLBase[llc] + size_t(bb.read(kLLBits[llc]));
      if (i + 1 < nseq) {
        sll = ll[sll].base + u32(bb.read(ll[sll].nbits));
        sml = ml[sml].base + u32(bb.read(ml[sml].nbits));
        sof = of[sof].base + u32(bb.read(of[sof].nbits));
      }
      check(bb.pos >= 0);
      u64 off;
      if (ofv > 3) {
        off = ofv - 3;
        rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = off;
      } else {
        const int idx = int(ofv) - 1 + (llen == 0);
        if (idx == 0) {
          off = rep[0];
        } else {
          off = idx < 3 ? rep[idx] : rep[0] - 1;
          if (idx > 1) rep[2] = rep[1];
          rep[1] = rep[0];
          rep[0] = off;
        }
      }
      check(llen <= size_t(lend - lits));
      check(llen + mlen <= size_t(oend - op), kDstTooSmall);
      std::memcpy(op, lits, llen);
      op += llen;
      lits += llen;
      check(off > 0 && off <= u64(op - frame));
      match_copy(op, size_t(off), mlen);
      op += mlen;
    }
    check(bb.pos == 0);
  } else {
    check(at == len);
  }
  const size_t rest = size_t(lend - lits);
  check(rest <= size_t(oend - op), kDstTooSmall);
  std::memcpy(op, lits, rest);
  op += rest;
  check(size_t(op - op0) <= block_max);
  return size_t(op - op0);
}

struct Header {
  size_t size;        // header bytes after the magic number
  u64 window;
  int64_t content;    // -1: not stated
  bool checksum;
};

Header frame_header(const u8* src, size_t n) {
  check(n >= 1, kTruncated);
  const int fhd = src[0];
  const int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1,
            dict_flag = fhd & 3;
  check((fhd & 8) == 0, kReserved);
  Header h{1, 0, -1, bool((fhd >> 2) & 1)};
  if (!single) {
    check(h.size < n, kTruncated);
    const int wd = src[h.size++];
    const u64 base = u64(1) << (10 + (wd >> 3));
    h.window = base + (base >> 3) * u64(wd & 7);
  }
  static const int kDictBytes[4] = {0, 1, 2, 4};
  const int db = kDictBytes[dict_flag];
  check(h.size + db <= n, kTruncated);
  u32 dict = 0;
  for (int i = 0; i < db; ++i) dict |= u32(src[h.size + i]) << (8 * i);
  check(dict == 0, kDictionary);
  h.size += db;
  const int fb = fcs_flag == 0 ? single : 1 << fcs_flag;
  check(h.size + fb <= n, kTruncated);
  if (fb) {
    u64 v = 0;
    for (int i = 0; i < fb; ++i) v |= u64(src[h.size + i]) << (8 * i);
    if (fb == 2) v += 256;
    h.content = int64_t(v);
    h.size += fb;
  }
  if (single) h.window = u64(h.content);
  return h;
}

// One frame after its magic number: returns the input bytes it took.
size_t frame(FrameState& st, const u8* src, size_t n, u8* dst, size_t cap,
             size_t* out) {
  const Header h = frame_header(src, n);
  size_t ip = h.size;
  const size_t block_max = h.window < kMaxBlock ? size_t(h.window) : kMaxBlock;
  st.huf.log = 0;
  st.ll.log = st.of.log = st.ml.log = -1;
  st.rep[0] = 1;
  st.rep[1] = 4;
  st.rep[2] = 8;
  u8* op = dst;
  u8* const oend = dst + cap;
  for (;;) {
    check(ip + 3 <= n, kTruncated);
    const u32 bh = le24(src + ip);
    ip += 3;
    const int type = (bh >> 1) & 3;
    const size_t size = bh >> 3;
    switch (type) {
      case 0:
        check(size <= block_max);
        check(ip + size <= n, kTruncated);
        check(size <= size_t(oend - op), kDstTooSmall);
        std::memcpy(op, src + ip, size);
        op += size;
        ip += size;
        break;
      case 1:
        check(size <= block_max);
        check(ip + 1 <= n, kTruncated);
        check(size <= size_t(oend - op), kDstTooSmall);
        std::memset(op, src[ip], size);
        op += size;
        ip += 1;
        break;
      case 2:
        check(size <= block_max);
        check(ip + size <= n, kTruncated);
        op += block(st, src + ip, size, op, oend, dst, block_max);
        ip += size;
        break;
      default:
        fail(kReserved);
    }
    if (bh & 1) break;
  }
  const size_t produced = size_t(op - dst);
  if (h.content >= 0) check(u64(h.content) == produced);
  if (h.checksum) {
    check(ip + 4 <= n, kTruncated);
    check(u32(xxh64(dst, produced)) == le32(src + ip), kChecksum);
    ip += 4;
  }
  *out = produced;
  return ip;
}

constexpr u32 kMagic = 0xFD2FB528u;

bool skippable(u32 magic) { return (magic & 0xFFFFFFF0u) == 0x184D2A50u; }

int64_t decompress(const u8* src, size_t n, u8* dst, size_t cap) {
  check(n >= 4, kTruncated);
  // one state a thread, kept: a frame's tables and literal buffer are
  // reset by frame() (a fresh 140 KB allocation a call would cost more
  // than a small chunk's decode)
  thread_local std::unique_ptr<FrameState> state;
  if (!state) state.reset(new FrameState);
  FrameState* const st = state.get();
  size_t ip = 0, op = 0;
  while (ip < n) {
    check(ip + 4 <= n, kTruncated);
    const u32 magic = le32(src + ip);
    ip += 4;
    if (skippable(magic)) {
      check(ip + 4 <= n, kTruncated);
      const size_t skip = le32(src + ip);
      check(skip <= n - ip - 4, kTruncated);
      ip += 4 + skip;
      continue;
    }
    check(magic == kMagic, kBadMagic);
    size_t out = 0;
    ip += frame(*st, src + ip, n - ip, dst + op, cap - op, &out);
    op += out;
  }
  return int64_t(op);
}

int64_t content_size(const u8* src, size_t n) {
  size_t ip = 0;
  int64_t total = 0;
  check(n >= 4, kTruncated);
  while (ip < n) {
    check(ip + 4 <= n, kTruncated);
    const u32 magic = le32(src + ip);
    ip += 4;
    if (skippable(magic)) {
      check(ip + 4 <= n, kTruncated);
      const size_t skip = le32(src + ip);
      check(skip <= n - ip - 4, kTruncated);
      ip += 4 + skip;
      continue;
    }
    check(magic == kMagic, kBadMagic);
    const Header h = frame_header(src + ip, n - ip);
    if (h.content < 0) return -1;
    total += h.content;
    ip += h.size;
    // walk the blocks to the next frame
    for (;;) {
      check(ip + 3 <= n, kTruncated);
      const u32 bh = le24(src + ip);
      ip += 3;
      const int type = (bh >> 1) & 3;
      check(type != 3, kReserved);
      const size_t size = type == 1 ? 1 : bh >> 3;
      check(size <= n - ip, kTruncated);
      ip += size;
      if (bh & 1) break;
    }
    if (h.checksum) {
      check(ip + 4 <= n, kTruncated);
      ip += 4;
    }
  }
  return total;
}

// ---------------------------------------------------------------------------
// CRC-32C, reflected polynomial 0x82F63B78, slicing by 8

struct Crc32cTables {
  u32 t[8][256];
  Crc32cTables() {
    for (u32 i = 0; i < 256; ++i) {
      u32 c = i;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
      t[0][i] = c;
    }
    for (u32 i = 0; i < 256; ++i)
      for (int s = 1; s < 8; ++s)
        t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
  }
};

const Crc32cTables kCrc;

}  // namespace

extern "C" {

int64_t zstd_decompress(const uint8_t* src, size_t n, uint8_t* dst,
                        size_t cap) {
  try {
    return decompress(src, n, dst, cap);
  } catch (const Error& e) {
    return e.code;
  } catch (...) {
    return kCorrupt;
  }
}

int64_t zstd_content_size(const uint8_t* src, size_t n) {
  try {
    return content_size(src, n);
  } catch (const Error& e) {
    return e.code;
  } catch (...) {
    return kCorrupt;
  }
}

int64_t zstd_decompress_batch(size_t n, const uint8_t* const* src,
                              const size_t* len, uint8_t* const* dst,
                              const size_t* cap, int64_t* out) {
  int64_t failed = 0;
  for (size_t i = 0; i < n; ++i) {
    out[i] = zstd_decompress(src[i], len[i], dst[i], cap[i]);
    failed += out[i] < 0;
  }
  return failed;
}

const char* zstd_error_name(int64_t code) {
  switch (code) {
    case kCorrupt: return "corrupt data";
    case kTruncated: return "truncated input";
    case kDstTooSmall: return "output larger than its stated size";
    case kDictionary: return "a dictionary id other than 0";
    case kChecksum: return "content checksum mismatch";
    case kBadMagic: return "not a zstd frame";
    case kReserved: return "a reserved field set";
    default: return "unknown error";
  }
}

uint32_t crc32c(const uint8_t* p, size_t n) {
  const auto& t = kCrc.t;
  u32 c = 0xFFFFFFFFu;
  for (; n >= 8; n -= 8, p += 8) {
    const u64 v = le64(p) ^ c;
    c = t[7][v & 0xFF] ^ t[6][(v >> 8) & 0xFF] ^ t[5][(v >> 16) & 0xFF] ^
        t[4][(v >> 24) & 0xFF] ^ t[3][(v >> 32) & 0xFF] ^
        t[2][(v >> 40) & 0xFF] ^ t[1][(v >> 48) & 0xFF] ^ t[0][v >> 56];
  }
  for (; n; --n, ++p) c = (c >> 8) ^ t[0][(c ^ *p) & 0xFF];
  return c ^ 0xFFFFFFFFu;
}

}  // extern "C"
