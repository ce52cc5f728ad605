// Native host-side JPEG entropy codec for imagekit_tpu.
//
// The serial stages of JPEG that cannot vectorise onto the TPU live here
// (SURVEY.md §7 "hard parts"): Huffman entropy decoding of baseline scans
// and Huffman entropy encoding of quantised coefficients. The parallel
// math (dequant+IDCT, chroma resampling, colour conversion, fDCT+quant)
// runs on device; this library also ships a fast host IDCT so the decoder
// can emit YCbCr planes directly (1.5 bytes/pixel for 4:2:0 — half the
// host->device bytes of RGB).
//
// Replaces (TPU-native split of) the `image` crate's JPEG codec used by the
// reference at src/transform.rs:27-43 and src/transform.rs:121-128.
//
// C ABI only; loaded via ctypes (no pybind11 in this environment).

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cstdlib>
#include <cmath>
#include <vector>

#if defined(__AVX2__)
#include <immintrin.h>
#elif defined(__SSE2__) || defined(_M_X64)
#include <emmintrin.h>
#endif

#define IK_EXPORT extern "C" __attribute__((visibility("default")))

namespace {

// ---------------------------------------------------------------------------
// Error codes
// ---------------------------------------------------------------------------
enum IkErr {
  IK_OK = 0,
  IK_ERR_TRUNCATED = -1,
  IK_ERR_BAD_MARKER = -2,
  IK_ERR_UNSUPPORTED = -3,   // progressive/arithmetic/12-bit etc.
  IK_ERR_BAD_HUFFMAN = -4,
  IK_ERR_BAD_DIMENSIONS = -5,
  IK_ERR_INTERNAL = -6,
  IK_ERR_BUFFER_TOO_SMALL = -7,
};

// ---------------------------------------------------------------------------
// Shared tables
// ---------------------------------------------------------------------------
static const uint8_t kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// Standard Annex K Huffman tables (used by the encoder).
static const uint8_t kDcLumaBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
static const uint8_t kDcLumaVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
static const uint8_t kDcChromaBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
static const uint8_t kDcChromaVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
static const uint8_t kAcLumaBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
static const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
static const uint8_t kAcChromaBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
static const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// ---------------------------------------------------------------------------
// Huffman decode table: 8-bit fast lookup + canonical slow path
// ---------------------------------------------------------------------------
struct HuffTable {
  bool present = false;
  // fast path: first 8 bits -> (symbol, length) or miss
  uint8_t fast_sym[256];
  uint8_t fast_len[256];  // 0 = miss
  uint8_t fast_s[256];    // payload (receive/extend) bits of the symbol
  // slow path (canonical):
  int32_t maxcode[18];    // largest code of length l (-1 if none)
  int32_t valptr[18];
  int32_t mincode[18];
  uint8_t vals[256];
  int nvals = 0;

  int Build(const uint8_t bits[17], const uint8_t* values, int nvalues) {
    nvals = nvalues;
    if (nvalues > 256) return IK_ERR_BAD_HUFFMAN;
    std::memcpy(vals, values, nvalues);
    // generate code lengths/codes
    int code = 0, k = 0;
    uint16_t codes[256];
    uint8_t lens[256];
    for (int l = 1; l <= 16; ++l) {
      for (int i = 0; i < bits[l]; ++i) {
        if (k >= nvalues) return IK_ERR_BAD_HUFFMAN;
        codes[k] = static_cast<uint16_t>(code);
        lens[k] = static_cast<uint8_t>(l);
        ++code;
        ++k;
      }
      if (code >= (1 << l) && l < 16 && bits[l + 1] > 0) {
        // overfull check happens implicitly below
      }
      code <<= 1;
    }
    if (k != nvalues) return IK_ERR_BAD_HUFFMAN;
    // slow tables
    k = 0;
    code = 0;
    for (int l = 1; l <= 16; ++l) {
      if (bits[l]) {
        valptr[l] = k;
        mincode[l] = code;
        k += bits[l];
        code += bits[l];
        maxcode[l] = code - 1;
      } else {
        maxcode[l] = -1;
      }
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    // fast table
    std::memset(fast_len, 0, sizeof(fast_len));
    for (int i = 0; i < nvalues; ++i) {
      if (lens[i] <= 8) {
        int shift = 8 - lens[i];
        int start = codes[i] << shift;
        for (int j = 0; j < (1 << shift); ++j) {
          fast_sym[start + j] = vals[i];
          fast_len[start + j] = lens[i];
          // payload size: low nibble, except ZRL (0xF0) which has none.
          // (For a DC table a 0xF0 symbol is invalid input; the caller
          // rejects the symbol before the payload matters.)
          fast_s[start + j] = vals[i] == 0xF0 ? 0 : (vals[i] & 15);
        }
      }
    }
    present = true;
    return IK_OK;
  }
};

// ---------------------------------------------------------------------------
// Bit reader with 0xFF00 unstuffing and marker detection
// ---------------------------------------------------------------------------
struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t bitbuf = 0;
  int bitcnt = 0;
  bool hit_marker = false;  // saw a real marker (e.g. EOI/RSTn boundary)
  uint8_t marker = 0;

  void Init(const uint8_t* data, const uint8_t* data_end) {
    p = data;
    end = data_end;
    bitbuf = 0;
    bitcnt = 0;
    hit_marker = false;
    marker = 0;
  }

  // refill to >=33 bits (one huffman code <=16 bits + magnitude <=16 bits)
  inline void Refill() {
    // fast path: 4 raw bytes with no 0xFF anywhere -> append 32 bits at once
    while (bitcnt <= 32) {
      if (p + 4 <= end) {
        uint32_t x;
        std::memcpy(&x, p, 4);
        // detect any 0xFF byte: zero-byte trick on x ^ 0xFFFFFFFF
        uint32_t v = x ^ 0xFFFFFFFFu;
        if (((v - 0x01010101u) & ~v & 0x80808080u) == 0) {
          uint32_t be = __builtin_bswap32(x);
          bitbuf |= uint64_t(be) << (32 - bitcnt);
          bitcnt += 32;
          p += 4;
          continue;
        }
      }
      // slow path: one byte with unstuffing/marker handling
      if (p >= end) {
        bitbuf |= uint64_t(0xFF) << (56 - bitcnt);
        bitcnt += 8;
        continue;
      }
      uint8_t b = *p;
      if (b == 0xFF) {
        if (p + 1 < end && p[1] == 0x00) {
          p += 2;  // stuffed byte
        } else {
          // real marker: stop consuming, pad with 1s
          if (!hit_marker && p + 1 < end) {
            hit_marker = true;
            marker = p[1];
          }
          bitbuf |= uint64_t(0xFF) << (56 - bitcnt);
          bitcnt += 8;
          continue;
        }
      } else {
        ++p;
      }
      bitbuf |= uint64_t(b) << (56 - bitcnt);
      bitcnt += 8;
    }
  }

  inline int Peek(int n) { return static_cast<int>(bitbuf >> (64 - n)); }
  inline void Skip(int n) {
    bitbuf <<= n;
    bitcnt -= n;
  }
  inline int Get(int n) {
    if (n == 0) return 0;
    int v = Peek(n);
    Skip(n);
    return v;
  }

  inline int DecodeHuff(const HuffTable& t) {
    Refill();
    int look = Peek(8);
    if (t.fast_len[look]) {
      int sym = t.fast_sym[look];
      Skip(t.fast_len[look]);
      return sym;
    }
    // slow: walk lengths 9..16
    int code = Peek(16);
    for (int l = 9; l <= 16; ++l) {
      int c = code >> (16 - l);
      if (t.maxcode[l] >= 0 && c <= t.maxcode[l]) {
        Skip(l);
        return t.vals[t.valptr[l] + (c - t.mincode[l])];
      }
    }
    return -1;
  }

  // Fused decode: one Huffman symbol AND its extended magnitude payload in
  // a single refill/shift sequence (libjpeg-turbo's HUFF_DECODE_FAST
  // shape). The payload length is the symbol's low nibble; for symbols
  // whose low nibble is not a payload size (e.g. ZRL 0xF0 has none) the
  // speculative extraction is never consumed by the caller but the skip
  // amount must still exclude it — hence payload extraction only when the
  // caller's convention (s = sym & 15, s>0 means payload) holds, which is
  // true for every baseline DC/AC symbol. Max consumption 8+15 < 33
  // refilled bits on the fast path; the slow path falls back to Receive.
  inline int DecodeHuffVal(const HuffTable& t, int* val) {
    Refill();
    const int look = Peek(8);
    const int cl = t.fast_len[look];
    if (cl) {
      const int sym = t.fast_sym[look];
      const int s = t.fast_s[look];
      // branchless payload extract + extend; s may be 0 (EOB/ZRL), hence
      // the double shift (63-s then 1) and the (s-1)&31 guard — both
      // degenerate to v=0 and a zero subtraction
      int v = static_cast<int>(((bitbuf << cl) >> (63 - s)) >> 1);
      Skip(cl + s);
      v -= (1 - ((v >> ((s - 1) & 31)) & 1)) * ((1 << s) - 1);
      *val = v;
      return sym;
    }
    const int code = Peek(16);
    for (int l = 9; l <= 16; ++l) {
      const int c = code >> (16 - l);
      if (t.maxcode[l] >= 0 && c <= t.maxcode[l]) {
        Skip(l);
        const int sym = t.vals[t.valptr[l] + (c - t.mincode[l])];
        const int s = sym & 15;
        *val = (s && sym != 0xF0) ? Receive(s) : 0;
        return sym;
      }
    }
    *val = 0;
    return -1;
  }

  // JPEG "receive and extend": n-bit magnitude to signed value.
  // Invariant: always called right after DecodeHuff, which refilled to
  // >=33 bits and consumed <=16 — so >=17 bits remain, no refill needed.
  inline int Receive(int n) {
    if (n == 0) return 0;
    int v = Get(n);
    // extend: v - (2^n - 1) when the sign bit is clear (avoid the UB of
    // left-shifting a negative value; caught by UBSan)
    if (v < (1 << (n - 1))) v -= (1 << n) - 1;
    return v;
  }

  // align to byte boundary and resync after restart marker
  void RestartSync() {
    // drop partial bits; scan forward for RSTn marker in the raw stream
    bitbuf = 0;
    bitcnt = 0;
    hit_marker = false;
    while (p + 1 < end) {
      if (p[0] == 0xFF && p[1] >= 0xD0 && p[1] <= 0xD7) {
        p += 2;
        return;
      }
      ++p;
    }
    p = end;
  }
};

// Nonzero mask of a 64-coefficient block: bit k set iff blk[k] != 0.
#if defined(__AVX2__)
inline uint64_t NzMask64(const int16_t* blk) {
  const __m256i zero = _mm256_setzero_si256();
  uint64_t m = 0;
  for (int g = 0; g < 2; ++g) {
    const __m256i a = _mm256_loadu_si256(
        reinterpret_cast<const __m256i*>(blk + g * 32));
    const __m256i b = _mm256_loadu_si256(
        reinterpret_cast<const __m256i*>(blk + g * 32 + 16));
    __m256i packed = _mm256_packs_epi16(_mm256_cmpeq_epi16(a, zero),
                                        _mm256_cmpeq_epi16(b, zero));
    packed = _mm256_permute4x64_epi64(packed, 0xD8);
    const uint32_t zm = static_cast<uint32_t>(_mm256_movemask_epi8(packed));
    m |= static_cast<uint64_t>(~zm) << (g * 32);
  }
  return m;
}
#else
inline uint64_t NzMask64(const int16_t* blk) {
  uint64_t m = 0;
  for (int k = 0; k < 64; ++k)
    m |= static_cast<uint64_t>(blk[k] != 0) << k;
  return m;
}
#endif

// ---------------------------------------------------------------------------
// Parsed JPEG structure
// ---------------------------------------------------------------------------
struct Component {
  int id = 0;
  int h = 1, v = 1;     // sampling factors
  int tq = 0;           // quant table index
  int td = 0, ta = 0;   // huffman table indices (from SOS)
  int width = 0, height = 0;        // actual sample dims
  int blocks_w = 0, blocks_h = 0;   // block dims padded to MCU
  int pred = 0;                     // DC predictor
};

struct ScanInfo {
  int ns = 0;
  int ci[4] = {0, 0, 0, 0};  // component indices in this scan
  int Ss = 0, Se = 63, Ah = 0, Al = 0;
};

struct Decoder {
  const uint8_t* data;
  size_t len;
  int width = 0, height = 0;
  int ncomp = 0;
  int hmax = 1, vmax = 1;
  int restart_interval = 0;
  bool progressive = false;
  // natural order; zero-initialised so a scan referencing a table that was
  // never defined by a DQT segment dequantises to zero instead of reading
  // indeterminate stack memory (ADVICE.md round 1)
  uint16_t qtab[4][64] = {};
  HuffTable dc[4], ac[4];
  Component comp[4];
  const uint8_t* scan_start = nullptr;
  // progressive: coefficients accumulate across scans into these planes
  // (layout [by][bx][64] natural order, MCU-padded dims)
  int16_t* store[4] = {nullptr, nullptr, nullptr, nullptr};
  bool any_scan = false;

  inline int16_t* BlockPtr(int c, int bx, int by) {
    return store[c] + (static_cast<size_t>(by) * comp[c].blocks_w + bx) * 64;
  }

  int Parse() {
    const uint8_t* p = data;
    const uint8_t* end = data + len;
    if (len < 4 || p[0] != 0xFF || p[1] != 0xD8) return IK_ERR_BAD_MARKER;
    p += 2;
    while (p + 2 <= end) {
      if (p[0] != 0xFF) {
        if (getenv("IK_DEBUG"))
          fprintf(stderr, "[ik] not a marker at offset %zd: %02x %02x\n",
                  p - data, p[0], p[1]);
        return IK_ERR_BAD_MARKER;
      }
      uint8_t m = p[1];
      p += 2;
      if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7)) continue;  // no payload
      if (m == 0xD9)  // EOI: valid end for a fully-decoded progressive image
        return (progressive && any_scan) ? IK_OK : IK_ERR_TRUNCATED;
      if (p + 2 > end) return IK_ERR_TRUNCATED;
      int seglen = (p[0] << 8) | p[1];
      if (seglen < 2 || p + seglen > end) return IK_ERR_TRUNCATED;
      const uint8_t* seg = p + 2;
      int segrem = seglen - 2;
      switch (m) {
        case 0xDB: {  // DQT
          while (segrem > 0) {
            int pq = seg[0] >> 4, tq = seg[0] & 15;
            ++seg;
            --segrem;
            if (tq > 3) return IK_ERR_BAD_MARKER;
            if (pq == 0) {
              if (segrem < 64) return IK_ERR_TRUNCATED;
              for (int i = 0; i < 64; ++i) qtab[tq][kZigzag[i]] = seg[i];
              seg += 64;
              segrem -= 64;
            } else {
              if (segrem < 128) return IK_ERR_TRUNCATED;
              for (int i = 0; i < 64; ++i)
                qtab[tq][kZigzag[i]] = (seg[2 * i] << 8) | seg[2 * i + 1];
              seg += 128;
              segrem -= 128;
            }
          }
          break;
        }
        case 0xC4: {  // DHT
          while (segrem >= 17) {
            int tc = seg[0] >> 4, th = seg[0] & 15;
            if (th > 3) return IK_ERR_BAD_MARKER;
            uint8_t bits[17] = {0};
            int total = 0;
            for (int l = 1; l <= 16; ++l) {
              bits[l] = seg[l];
              total += bits[l];
            }
            if (segrem < 17 + total) return IK_ERR_TRUNCATED;
            int rc = (tc == 0 ? dc[th] : ac[th]).Build(bits, seg + 17, total);
            if (rc != IK_OK) return rc;
            seg += 17 + total;
            segrem -= 17 + total;
          }
          break;
        }
        case 0xC2:  // SOF2 progressive (decoded scan-by-scan below)
          progressive = true;
          [[fallthrough]];
        case 0xC0:
        case 0xC1: {  // SOF0/1 baseline
          if (segrem < 6) return IK_ERR_TRUNCATED;
          if (seg[0] != 8) return IK_ERR_UNSUPPORTED;  // 8-bit only
          height = (seg[1] << 8) | seg[2];
          width = (seg[3] << 8) | seg[4];
          ncomp = seg[5];
          if (width <= 0 || height <= 0) return IK_ERR_BAD_DIMENSIONS;
          if (ncomp != 1 && ncomp != 3) return IK_ERR_UNSUPPORTED;
          if (segrem < 6 + 3 * ncomp) return IK_ERR_TRUNCATED;
          for (int c = 0; c < ncomp; ++c) {
            comp[c].id = seg[6 + 3 * c];
            comp[c].h = seg[7 + 3 * c] >> 4;
            comp[c].v = seg[7 + 3 * c] & 15;
            comp[c].tq = seg[8 + 3 * c];
            // tq indexes qtab[4]; T.81 allows 0..3 only
            if (comp[c].tq > 3) return IK_ERR_BAD_MARKER;
            if (comp[c].h < 1 || comp[c].h > 4 || comp[c].v < 1 || comp[c].v > 4)
              return IK_ERR_UNSUPPORTED;
            hmax = comp[c].h > hmax ? comp[c].h : hmax;
            vmax = comp[c].v > vmax ? comp[c].v : vmax;
          }
          for (int c = 0; c < ncomp; ++c) {
            comp[c].width = (width * comp[c].h + hmax - 1) / hmax;
            comp[c].height = (height * comp[c].v + vmax - 1) / vmax;
            int mcux = (width + 8 * hmax - 1) / (8 * hmax);
            int mcuy = (height + 8 * vmax - 1) / (8 * vmax);
            comp[c].blocks_w = mcux * comp[c].h;
            comp[c].blocks_h = mcuy * comp[c].v;
          }
          break;
        }
        case 0xC3:
        case 0xC5:
        case 0xC6:
        case 0xC7:
        case 0xC9:
        case 0xCA:
        case 0xCB:
        case 0xCD:
        case 0xCE:
        case 0xCF:
          return IK_ERR_UNSUPPORTED;
        case 0xDD: {  // DRI
          if (segrem < 2) return IK_ERR_TRUNCATED;
          restart_interval = (seg[0] << 8) | seg[1];
          break;
        }
        case 0xDA: {  // SOS
          if (segrem < 1) return IK_ERR_TRUNCATED;
          ScanInfo si;
          si.ns = seg[0];
          if (si.ns < 1 || si.ns > 4) return IK_ERR_BAD_MARKER;
          if (segrem < 1 + 2 * si.ns + 3) return IK_ERR_TRUNCATED;
          for (int s = 0; s < si.ns; ++s) {
            int cid = seg[1 + 2 * s];
            int tabs = seg[2 + 2 * s];
            // table ids index HuffTable dc[4]/ac[4]; T.81 allows 0..3 only
            if ((tabs >> 4) > 3 || (tabs & 15) > 3) return IK_ERR_BAD_MARKER;
            int found = -1;
            for (int c = 0; c < ncomp; ++c) {
              if (comp[c].id == cid) {
                comp[c].td = tabs >> 4;
                comp[c].ta = tabs & 15;
                found = c;
              }
            }
            if (found < 0) {
              if (getenv("IK_DEBUG")) fprintf(stderr, "[ik] SOS unknown comp id %d\n", cid);
              return IK_ERR_BAD_MARKER;
            }
            si.ci[s] = found;
          }
          const uint8_t* sp = seg + 1 + 2 * si.ns;
          si.Ss = sp[0];
          si.Se = sp[1];
          si.Ah = sp[2] >> 4;
          si.Al = sp[2] & 15;
          // spectral band indexes kZigzag[64] (T.81: 0 <= Ss <= Se <= 63)
          if (si.Ss > 63 || si.Se > 63 || si.Ss > si.Se)
            return IK_ERR_BAD_MARKER;
          if (!progressive) {
            if (si.ns != ncomp) return IK_ERR_UNSUPPORTED;
            scan_start = p + seglen;
            return IK_OK;  // caller runs the baseline scan decoder
          }
          if (store[0] == nullptr) {
            // header-only parse: info complete at first SOS
            scan_start = p + seglen;
            return IK_OK;
          }
          BitReader br;
          br.Init(p + seglen, data + len);
          int rc2 = DecodeProgressiveScan(si, br);
          if (rc2 != IK_OK) return rc2;
          any_scan = true;
          // continue parsing from wherever the entropy data ended
          p = br.p;
          while (p + 1 < end && !(p[0] == 0xFF && p[1] != 0x00 &&
                                  !(p[1] >= 0xD0 && p[1] <= 0xD7)))
            ++p;
          continue;
        }
        default:
          break;  // APPn/COM: skip
      }
      p += seglen;
    }
    return IK_ERR_TRUNCATED;
  }

  // One progressive scan (T.81 G.2): DC/AC, first/refinement, interleaved
  // (DC only) or single-component with its own block geometry.
  int DecodeProgressiveScan(const ScanInfo& si, BitReader& br) {
    int eobrun = 0;
    if (si.ns == 1) {
      int c = si.ci[0];
      Component& C = comp[c];
      int bw = (C.width + 7) / 8;
      int bh = (C.height + 7) / 8;
      int count = 0;
      C.pred = 0;
      const bool ac_first = si.Ss != 0 && si.Ah == 0;
      const int total = bw * bh;
      int i = 0;
      while (i < total) {
        if (restart_interval && count == restart_interval) {
          br.RestartSync();
          count = 0;
          C.pred = 0;
          eobrun = 0;
        }
        if (ac_first && eobrun > 0) {
          // An EOB run in a first AC scan leaves whole blocks untouched:
          // consume it wholesale instead of one call per block (early
          // scans carry runs thousands of blocks long). Bounded by the
          // restart boundary, which resets the run.
          int n = eobrun < total - i ? eobrun : total - i;
          if (restart_interval && n > restart_interval - count)
            n = restart_interval - count;
          eobrun -= n;
          count += n;
          i += n;
          continue;
        }
        int rc = DecodeBlockProgressive(si, br, C,
                                        BlockPtr(c, i % bw, i / bw), eobrun);
        if (rc != IK_OK) return rc;
        ++count;
        ++i;
      }
      return IK_OK;
    }
    // interleaved: DC scans only (Ss must be 0 per spec)
    if (si.Ss != 0) {
      if (getenv("IK_DEBUG")) fprintf(stderr, "[ik] interleaved AC scan\n");
      return IK_ERR_BAD_MARKER;
    }
    int mcux = (width + 8 * hmax - 1) / (8 * hmax);
    int mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int s = 0; s < si.ns; ++s) comp[si.ci[s]].pred = 0;
    int count = 0;
    for (int my = 0; my < mcuy; ++my) {
      for (int mx = 0; mx < mcux; ++mx) {
        if (restart_interval && count == restart_interval) {
          br.RestartSync();
          count = 0;
          for (int s = 0; s < si.ns; ++s) comp[si.ci[s]].pred = 0;
          eobrun = 0;
        }
        for (int s = 0; s < si.ns; ++s) {
          int c = si.ci[s];
          Component& C = comp[c];
          for (int v = 0; v < C.v; ++v) {
            for (int h = 0; h < C.h; ++h) {
              int rc = DecodeBlockProgressive(
                  si, br, C, BlockPtr(c, mx * C.h + h, my * C.v + v), eobrun);
              if (rc != IK_OK) return rc;
            }
          }
        }
        ++count;
      }
    }
    return IK_OK;
  }

  int DecodeBlockProgressive(const ScanInfo& si, BitReader& br, Component& C,
                             int16_t* blk, int& eobrun) {
    if (si.Ss == 0) {  // DC
      if (si.Ah == 0) {
        const HuffTable& dct = dc[C.td];
        if (!dct.present) return IK_ERR_BAD_HUFFMAN;
        int diff;
        int t = br.DecodeHuffVal(dct, &diff);
        if (t < 0 || t > 15) return IK_ERR_BAD_HUFFMAN;
        C.pred += diff;
        blk[0] = static_cast<int16_t>(C.pred << si.Al);
      } else {  // DC refinement: one bit
        br.Refill();
        if (br.Get(1)) blk[0] = static_cast<int16_t>(blk[0] | (1 << si.Al));
      }
      return IK_OK;
    }
    const HuffTable& act = ac[C.ta];
    if (!act.present) return IK_ERR_BAD_HUFFMAN;
    if (si.Ah == 0) {  // AC first pass
      if (eobrun > 0) {
        --eobrun;
        return IK_OK;
      }
      int k = si.Ss;
      while (k <= si.Se) {
        int val;
        int rs = br.DecodeHuffVal(act, &val);
        if (rs < 0) return IK_ERR_BAD_HUFFMAN;
        int r = rs >> 4, sbits = rs & 15;
        if (sbits == 0) {
          if (r == 15) {
            k += 16;  // ZRL
            continue;
          }
          eobrun = (1 << r) - 1;
          if (r) {
            br.Refill();
            eobrun += br.Get(r);
          }
          break;
        }
        k += r;
        if (k > si.Se) return IK_ERR_BAD_HUFFMAN;
        // progressive blocks stay in ZIGZAG order until FinalizeProgressive
        // (linear refinement walks; one reorder at the end)
        blk[k] = static_cast<int16_t>(val * (1 << si.Al));
        ++k;
      }
      return IK_OK;
    }
    // AC refinement (T.81 G.2.2 / libjpeg decode_mcu_AC_refine shape)
    const int p1 = 1 << si.Al;
    const int m1 = -(1 << si.Al);
    int k = si.Ss;
    if (eobrun == 0) {
      while (k <= si.Se) {
        int rs = br.DecodeHuff(act);
        if (rs < 0) return IK_ERR_BAD_HUFFMAN;
        int r = rs >> 4, sbits = rs & 15;
        int newval = 0;
        if (sbits == 0) {
          if (r != 15) {
            eobrun = 1 << r;
            if (r) {
              br.Refill();
              eobrun += br.Get(r);
            }
            break;
          }
          // r == 15: advance over 16 zero-history coefficients
        } else {
          if (sbits != 1) return IK_ERR_BAD_HUFFMAN;
          br.Refill();
          newval = br.Get(1) ? p1 : m1;
        }
        while (k <= si.Se) {
          int16_t* cp = blk + k;
          if (*cp != 0) {
            br.Refill();
            if (br.Get(1) && (*cp & p1) == 0)
              *cp = static_cast<int16_t>(*cp + ((*cp >= 0) ? p1 : m1));
          } else {
            if (r == 0) {
              if (newval) *cp = static_cast<int16_t>(newval);
              ++k;
              break;
            }
            --r;
          }
          ++k;
        }
      }
    }
    if (eobrun > 0) {
      // correction bits only for HISTORY-nonzero positions in [k, Se];
      // positions >= k are untouched by this call's run loop, so a mask
      // taken now is exact — iterate set bits instead of all ~55 slots
      // (most refinement blocks sit inside an EOB run with few nonzeros)
      const uint64_t range =
          k > si.Se ? 0
                    : (si.Se == 63 ? ~0ull : ((1ull << (si.Se + 1)) - 1)) &
                          ~((1ull << k) - 1);
      uint64_t m = range ? NzMask64(blk) & range : 0;
      while (m) {
        int16_t* cp = blk + __builtin_ctzll(m);
        m &= m - 1;
        br.Refill();
        if (br.Get(1) && (*cp & p1) == 0)
          *cp = static_cast<int16_t>(*cp + ((*cp >= 0) ? p1 : m1));
      }
      --eobrun;
    }
    return IK_OK;
  }

  // Progressive scans accumulate blocks in zigzag order (linear spectral
  // walks, cache-friendly refinement); one scatter to natural order here.
  void FinalizeProgressive() {
    int16_t tmp[64];
    for (int c = 0; c < ncomp; ++c) {
      if (!store[c]) continue;
      const size_t nblk =
          static_cast<size_t>(comp[c].blocks_w) * comp[c].blocks_h;
      for (size_t b = 0; b < nblk; ++b) {
        int16_t* blk = store[c] + b * 64;
        for (int k = 0; k < 64; ++k) tmp[kZigzag[k]] = blk[k];
        std::memcpy(blk, tmp, sizeof(tmp));
      }
    }
  }

  // Decode the interleaved scan. For each decoded block, call sink(c, bx, by, blk)
  // where blk is the 64-coefficient block in NATURAL order, still quantised.
  template <typename Sink>
  int DecodeScan(Sink&& sink) {
    BitReader br;
    br.Init(scan_start, data + len);
    int mcux = (width + 8 * hmax - 1) / (8 * hmax);
    int mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int c = 0; c < ncomp; ++c) comp[c].pred = 0;
    int mcu_count = 0;
    int16_t blk[64];
    for (int my = 0; my < mcuy; ++my) {
      for (int mx = 0; mx < mcux; ++mx) {
        if (restart_interval && mcu_count == restart_interval) {
          br.RestartSync();
          mcu_count = 0;
          for (int c = 0; c < ncomp; ++c) comp[c].pred = 0;
        }
        for (int c = 0; c < ncomp; ++c) {
          const HuffTable& dct = dc[comp[c].td];
          const HuffTable& act = ac[comp[c].ta];
          if (!dct.present || !act.present) return IK_ERR_BAD_HUFFMAN;
          for (int v = 0; v < comp[c].v; ++v) {
            for (int h = 0; h < comp[c].h; ++h) {
              std::memset(blk, 0, sizeof(blk));
              int diff;
              int t = br.DecodeHuffVal(dct, &diff);
              if (t < 0 || t > 15) return IK_ERR_BAD_HUFFMAN;
              comp[c].pred += diff;
              blk[0] = static_cast<int16_t>(comp[c].pred);
              int k = 1;
              while (k < 64) {
                int v;
                int rs = br.DecodeHuffVal(act, &v);
                if (rs < 0) return IK_ERR_BAD_HUFFMAN;
                int r = rs >> 4, s = rs & 15;
                if (s == 0) {
                  if (r == 15) {
                    k += 16;  // ZRL
                    continue;
                  }
                  break;  // EOB
                }
                k += r;
                if (k > 63) return IK_ERR_BAD_HUFFMAN;
                blk[kZigzag[k]] = static_cast<int16_t>(v);
                ++k;
              }
              sink(c, mx * comp[c].h + h, my * comp[c].v + v, blk);
            }
          }
        }
        ++mcu_count;
      }
    }
    return IK_OK;
  }
};

// ---------------------------------------------------------------------------
// Fast float IDCT (AAN), 8x8, with dequantisation folded into scale factors
// ---------------------------------------------------------------------------
struct IdctTable {
  float scaled[64];  // qtab * aan scale, natural order
  void Build(const uint16_t* q) {
    static const double aan[8] = {1.0, 1.387039845, 1.306562965, 1.175875602,
                                  1.0, 0.785694958, 0.541196100, 0.275899379};
    for (int y = 0; y < 8; ++y)
      for (int x = 0; x < 8; ++x)
        scaled[y * 8 + x] =
            static_cast<float>(q[y * 8 + x] * aan[y] * aan[x] * 0.125);
  }
};

inline void Idct8x8(const int16_t* blk, const IdctTable& t, float* out /*64*/) {
  float tmp[64];
  // columns
  for (int x = 0; x < 8; ++x) {
    const int16_t* in = blk + x;
    const float* sc = t.scaled + x;
    float s0 = in[0 * 8] * sc[0 * 8], s1 = in[1 * 8] * sc[1 * 8],
          s2 = in[2 * 8] * sc[2 * 8], s3 = in[3 * 8] * sc[3 * 8],
          s4 = in[4 * 8] * sc[4 * 8], s5 = in[5 * 8] * sc[5 * 8],
          s6 = in[6 * 8] * sc[6 * 8], s7 = in[7 * 8] * sc[7 * 8];
    // even part
    float p2 = s2, p3 = s6;
    float p1 = (p2 + p3) * 0.5411961f;
    float t2 = p1 + p3 * -1.3065630f;
    float t3 = p1 + p2 * 0.7653669f;
    p2 = s0;
    p3 = s4;
    float t0 = p2 + p3, t1 = p2 - p3;
    float x0 = t0 + t3, x3 = t0 - t3, x1 = t1 + t2, x2 = t1 - t2;
    // odd part
    t0 = s7;
    t1 = s5;
    t2 = s3;
    t3 = s1;
    p3 = t0 + t2;
    float p4 = t1 + t3;
    p1 = t0 + t3;
    p2 = t1 + t2;
    float p5 = (p3 + p4) * 1.1758756f;
    t0 *= 0.2986103f;
    t1 *= 2.0531320f;
    t2 *= 3.0727282f;
    t3 *= 1.5013211f;
    p1 = p5 + p1 * -0.8999762f;
    p2 = p5 + p2 * -2.5629154f;
    p3 *= -1.9615706f;
    p4 *= -0.3901806f;
    t3 += p1 + p4;
    t2 += p2 + p3;
    t1 += p2 + p4;
    t0 += p1 + p3;
    float* o = tmp + x;
    o[0 * 8] = x0 + t3;
    o[7 * 8] = x0 - t3;
    o[1 * 8] = x1 + t2;
    o[6 * 8] = x1 - t2;
    o[2 * 8] = x2 + t1;
    o[5 * 8] = x2 - t1;
    o[3 * 8] = x3 + t0;
    o[4 * 8] = x3 - t0;
  }
  // rows
  for (int y = 0; y < 8; ++y) {
    float* in = tmp + y * 8;
    float s0 = in[0], s1 = in[1], s2 = in[2], s3 = in[3], s4 = in[4],
          s5 = in[5], s6 = in[6], s7 = in[7];
    float p2 = s2, p3 = s6;
    float p1 = (p2 + p3) * 0.5411961f;
    float t2 = p1 + p3 * -1.3065630f;
    float t3 = p1 + p2 * 0.7653669f;
    p2 = s0;
    p3 = s4;
    float t0 = p2 + p3, t1 = p2 - p3;
    float x0 = t0 + t3, x3 = t0 - t3, x1 = t1 + t2, x2 = t1 - t2;
    t0 = s7;
    t1 = s5;
    t2 = s3;
    t3 = s1;
    p3 = t0 + t2;
    float p4 = t1 + t3;
    p1 = t0 + t3;
    p2 = t1 + t2;
    float p5 = (p3 + p4) * 1.1758756f;
    t0 *= 0.2986103f;
    t1 *= 2.0531320f;
    t2 *= 3.0727282f;
    t3 *= 1.5013211f;
    p1 = p5 + p1 * -0.8999762f;
    p2 = p5 + p2 * -2.5629154f;
    p3 *= -1.9615706f;
    p4 *= -0.3901806f;
    t3 += p1 + p4;
    t2 += p2 + p3;
    t1 += p2 + p4;
    t0 += p1 + p3;
    float* o = out + y * 8;
    o[0] = x0 + t3;
    o[7] = x0 - t3;
    o[1] = x1 + t2;
    o[6] = x1 - t2;
    o[2] = x2 + t1;
    o[5] = x2 - t1;
    o[3] = x3 + t0;
    o[4] = x3 - t0;
  }
}

inline uint8_t ClampPixel(float v) {
  int i = static_cast<int>(v + 128.5f);
  if (i < 0) return 0;
  if (i > 255) return 255;
  return static_cast<uint8_t>(i);
}

// ---------------------------------------------------------------------------
// Bit writer + Huffman encode
// ---------------------------------------------------------------------------
struct HuffEncTable {
  uint16_t code[256];
  uint8_t size[256];
  void Build(const uint8_t bits[17], const uint8_t* vals) {
    int k = 0, c = 0;
    for (int l = 1; l <= 16; ++l) {
      for (int i = 0; i < bits[l]; ++i) {
        code[vals[k]] = static_cast<uint16_t>(c);
        size[vals[k]] = static_cast<uint8_t>(l);
        ++c;
        ++k;
      }
      c <<= 1;
    }
  }
};

struct BitWriter {
  uint8_t* out;
  size_t cap;
  size_t n = 0;
  uint64_t buf = 0;  // bits accumulate at the top
  int cnt = 0;
  bool overflow = false;

  inline void PutByte(uint8_t b) {
    if (n >= cap) {
      overflow = true;
      return;
    }
    out[n++] = b;
  }
  // drain whole bytes from the accumulator, stuffing 0x00 after 0xFF
  inline void Drain() {
    while (cnt >= 8) {
      uint8_t b = static_cast<uint8_t>(buf >> 56);
      buf <<= 8;
      cnt -= 8;
      if (n + 2 > cap) {
        overflow = true;
        return;
      }
      out[n++] = b;
      if (b == 0xFF) out[n++] = 0x00;
    }
  }
  inline void Put(uint32_t bits, int nbits) {
    buf |= uint64_t(bits & ((1u << nbits) - 1)) << (64 - cnt - nbits);
    cnt += nbits;
    if (cnt >= 32) Drain();
  }
  void Flush() {
    Drain();
    if (cnt > 0) {
      uint8_t b = static_cast<uint8_t>(
          (buf >> 56) | ((1u << (8 - cnt)) - 1));
      PutByte(b);
      if (b == 0xFF) PutByte(0x00);
      cnt = 0;
      buf = 0;
    }
  }
};

inline int Magnitude(int v) {
  unsigned a = static_cast<unsigned>(v < 0 ? -v : v);
  return a ? 32 - __builtin_clz(a) : 0;
}

// Optimal Huffman table from symbol frequencies — the JPEG Annex K.2
// procedure (merge the two least-frequent chains, histogram code sizes,
// fold lengths >16 down, drop the reserved all-ones code point). Same
// algorithm libjpeg's optimize_coding runs; beats the Annex K.3 standard
// tables by 5-15% on typical photos.
void BuildOptimalHuff(const uint32_t freq_in[256], uint8_t bits_out[17],
                      uint8_t* vals, int* nvals) {
  uint64_t freq[257];
  int codesize[257] = {0};
  int others[257];
  for (int i = 0; i < 257; ++i) others[i] = -1;
  for (int i = 0; i < 256; ++i) freq[i] = freq_in[i];
  freq[256] = 1;  // reserved: guarantees no real symbol gets all-ones

  for (;;) {
    int c1 = -1, c2 = -1;
    uint64_t v = ~0ull;
    for (int i = 0; i <= 256; ++i)
      if (freq[i] && freq[i] <= v) {
        v = freq[i];
        c1 = i;
      }
    v = ~0ull;
    for (int i = 0; i <= 256; ++i)
      if (freq[i] && freq[i] <= v && i != c1) {
        v = freq[i];
        c2 = i;
      }
    if (c2 < 0) break;
    freq[c1] += freq[c2];
    freq[c2] = 0;
    ++codesize[c1];
    while (others[c1] >= 0) {
      c1 = others[c1];
      ++codesize[c1];
    }
    others[c1] = c2;
    ++codesize[c2];
    while (others[c2] >= 0) {
      c2 = others[c2];
      ++codesize[c2];
    }
  }

  int bits[33] = {0};
  for (int i = 0; i <= 256; ++i)
    if (codesize[i]) ++bits[codesize[i] > 32 ? 32 : codesize[i]];
  // fold code lengths longer than 16 (Annex K.2 "Adjust_BITS")
  for (int i = 32; i > 16; --i) {
    while (bits[i] > 0) {
      int j = i - 2;
      while (bits[j] == 0) --j;
      bits[i] -= 2;
      bits[i - 1] += 1;
      bits[j + 1] += 2;
      bits[j] -= 1;
    }
  }
  int i = 16;
  while (bits[i] == 0) --i;
  bits[i] -= 1;  // remove the reserved code point
  for (int l = 1; l <= 16; ++l) bits_out[l] = static_cast<uint8_t>(bits[l]);
  bits_out[0] = 0;

  int n = 0;
  for (int len = 1; len <= 32; ++len)
    for (int s = 0; s < 256; ++s)
      if (codesize[s] == len) vals[n++] = static_cast<uint8_t>(s);
  *nvals = n;
}

}  // namespace

// ===========================================================================
// C API
// ===========================================================================

// Parsed header info for the Python side.
struct IkJpegInfo {
  int32_t width;
  int32_t height;
  int32_t ncomp;
  int32_t hmax, vmax;
  int32_t comp_h[4];       // sampling factors
  int32_t comp_v[4];
  int32_t comp_width[4];   // true sample dims
  int32_t comp_height[4];
  int32_t blocks_w[4];     // padded block dims
  int32_t blocks_h[4];
  int32_t comp_tq[4];      // per-component quant-table selector (SOF Tq_i)
  int32_t progressive;     // 1 -> unsupported here, use fallback
};

IK_EXPORT int ik_jpeg_parse(const uint8_t* data, size_t len, IkJpegInfo* info) {
  Decoder d;
  d.data = data;
  d.len = len;
  int rc = d.Parse();  // header-only: stops at the first SOS
  if (rc != IK_OK) return rc;
  info->width = d.width;
  info->height = d.height;
  info->ncomp = d.ncomp;
  info->hmax = d.hmax;
  info->vmax = d.vmax;
  for (int c = 0; c < d.ncomp; ++c) {
    info->comp_h[c] = d.comp[c].h;
    info->comp_v[c] = d.comp[c].v;
    info->comp_width[c] = d.comp[c].width;
    info->comp_height[c] = d.comp[c].height;
    info->blocks_w[c] = d.comp[c].blocks_w;
    info->blocks_h[c] = d.comp[c].blocks_h;
    info->comp_tq[c] = d.comp[c].tq;
  }
  info->progressive = d.progressive ? 1 : 0;
  return IK_OK;
}

IK_EXPORT int ik_jpeg_decode_coeffs(const uint8_t* data, size_t len,
                                    int16_t** coeffs, uint16_t* qtabs_out);

// Decode to full-resolution component sample planes (Huffman + host IDCT).
// planes[c] must hold blocks_w*8 x blocks_h*8 bytes (stride = blocks_w*8).
IK_EXPORT int ik_jpeg_decode_planes(const uint8_t* data, size_t len,
                                    uint8_t** planes) {
  Decoder d;
  d.data = data;
  d.len = len;
  {
    // peek the header to know whether this is progressive (and dims)
    Decoder probe;
    probe.data = data;
    probe.len = len;
    int prc = probe.Parse();
    if (prc != IK_OK) return prc;
    if (probe.progressive) {
      std::vector<std::vector<int16_t>> bufs(probe.ncomp);
      int16_t* ptrs[4] = {nullptr, nullptr, nullptr, nullptr};
      for (int c = 0; c < probe.ncomp; ++c) {
        bufs[c].assign(
            static_cast<size_t>(probe.comp[c].blocks_w) *
                probe.comp[c].blocks_h * 64,
            0);
        ptrs[c] = bufs[c].data();
      }
      uint16_t qtabs[4 * 64];
      int rc = ik_jpeg_decode_coeffs(data, len, ptrs, qtabs);
      if (rc != IK_OK) return rc;
      IdctTable idct[4];
      for (int c = 0; c < probe.ncomp; ++c)
        idct[c].Build(probe.qtab[probe.comp[c].tq]);
      float px[64];
      for (int c = 0; c < probe.ncomp; ++c) {
        int bw = probe.comp[c].blocks_w, bh = probe.comp[c].blocks_h;
        int stride = bw * 8;
        for (int by = 0; by < bh; ++by) {
          for (int bx = 0; bx < bw; ++bx) {
            Idct8x8(ptrs[c] + (static_cast<size_t>(by) * bw + bx) * 64,
                    idct[c], px);
            uint8_t* dst = planes[c] + (by * 8) * stride + bx * 8;
            for (int y = 0; y < 8; ++y) {
              uint8_t* row = dst + y * stride;
              const float* src = px + y * 8;
              for (int x = 0; x < 8; ++x) row[x] = ClampPixel(src[x]);
            }
          }
        }
      }
      return IK_OK;
    }
  }
  int rc = d.Parse();
  if (rc != IK_OK) return rc;
  IdctTable idct[4];
  for (int c = 0; c < d.ncomp; ++c) idct[c].Build(d.qtab[d.comp[c].tq]);
  float px[64];
  rc = d.DecodeScan([&](int c, int bx, int by, const int16_t* blk) {
    Idct8x8(blk, idct[c], px);
    int stride = d.comp[c].blocks_w * 8;
    uint8_t* dst = planes[c] + (by * 8) * stride + bx * 8;
    for (int y = 0; y < 8; ++y) {
      uint8_t* row = dst + y * stride;
      const float* src = px + y * 8;
      for (int x = 0; x < 8; ++x) row[x] = ClampPixel(src[x]);
    }
  });
  return rc;
}

// Decode to quantised DCT coefficient planes (entropy only; device does the
// rest). coeffs[c] must hold blocks_w*blocks_h*64 int16 values, laid out
// block-row-major: [by][bx][64] in natural order. qtabs_out: 4x64 natural.
IK_EXPORT int ik_jpeg_decode_coeffs(const uint8_t* data, size_t len,
                                    int16_t** coeffs, uint16_t* qtabs_out) {
  Decoder d;
  d.data = data;
  d.len = len;
  for (int c = 0; c < 4; ++c) d.store[c] = coeffs ? coeffs[c] : nullptr;
  // caller-provided planes must start zeroed for progressive accumulation;
  // the Python side allocates with np.zeros
  int rc = d.Parse();
  if (rc != IK_OK) return rc;
  for (int t = 0; t < 4; ++t)
    std::memcpy(qtabs_out + t * 64, d.qtab[t], 64 * sizeof(uint16_t));
  if (d.progressive) {  // scans decoded inside Parse, in zigzag order
    d.FinalizeProgressive();
    return IK_OK;
  }
  rc = d.DecodeScan([&](int c, int bx, int by, const int16_t* blk) {
    int16_t* dst = coeffs[c] + (static_cast<size_t>(by) * d.comp[c].blocks_w + bx) * 64;
    std::memcpy(dst, blk, 64 * sizeof(int16_t));
  });
  return rc;
}

// Decode to LOW-FREQUENCY coefficient blocks: only the KxK top-left
// (natural-order) coefficients of every block are stored, laid out
// [by][bx][K*K]. The device applies a K-point scaled IDCT, producing a
// K/8-scale plane directly — for thumbnail-class downscales this cuts the
// host->device coefficient upload by (8/K)^2 (16x at K=2) and the IDCT
// FLOPs likewise, with the discarded frequencies being exactly the ones the
// Lanczos downsample would have removed (>=55 dB vs the full path at the
// target resolution; see tests/test_dct.py). Baseline scans sink truncated
// blocks directly; progressive scans accumulate full blocks in scratch and
// truncate on copy-out.
IK_EXPORT int ik_jpeg_decode_coeffs_lowfreq(const uint8_t* data, size_t len,
                                            int K, int16_t** coeffs,
                                            uint16_t* qtabs_out) {
  if (K < 1 || K > 8) return IK_ERR_UNSUPPORTED;
  Decoder d;
  d.data = data;
  d.len = len;
  {
    Decoder probe;
    probe.data = data;
    probe.len = len;
    int prc = probe.Parse();  // header-only for baseline; progressive needs
    if (prc != IK_OK) return prc;
    if (probe.progressive) {
      std::vector<std::vector<int16_t>> bufs(probe.ncomp);
      int16_t* ptrs[4] = {nullptr, nullptr, nullptr, nullptr};
      for (int c = 0; c < probe.ncomp; ++c) {
        bufs[c].assign(static_cast<size_t>(probe.comp[c].blocks_w) *
                           probe.comp[c].blocks_h * 64,
                       0);
        ptrs[c] = bufs[c].data();
      }
      int rc = ik_jpeg_decode_coeffs(data, len, ptrs, qtabs_out);
      if (rc != IK_OK) return rc;
      for (int c = 0; c < probe.ncomp; ++c) {
        const int bw = probe.comp[c].blocks_w, bh = probe.comp[c].blocks_h;
        for (int by = 0; by < bh; ++by) {
          for (int bx = 0; bx < bw; ++bx) {
            const int16_t* src =
                ptrs[c] + (static_cast<size_t>(by) * bw + bx) * 64;
            int16_t* dst =
                coeffs[c] + (static_cast<size_t>(by) * bw + bx) * K * K;
            for (int u = 0; u < K; ++u)
              for (int v = 0; v < K; ++v) dst[u * K + v] = src[u * 8 + v];
          }
        }
      }
      return IK_OK;
    }
  }
  int rc = d.Parse();
  if (rc != IK_OK) return rc;
  for (int t = 0; t < 4; ++t)
    std::memcpy(qtabs_out + t * 64, d.qtab[t], 64 * sizeof(uint16_t));
  const int KK = K;
  rc = d.DecodeScan([&](int c, int bx, int by, const int16_t* blk) {
    int16_t* dst =
        coeffs[c] +
        (static_cast<size_t>(by) * d.comp[c].blocks_w + bx) * KK * KK;
    for (int u = 0; u < KK; ++u)
      for (int v = 0; v < KK; ++v) dst[u * KK + v] = blk[u * 8 + v];
  });
  return rc;
}

// Low-frequency decode with the SPLIT INT8 TRANSPORT — the wire-size lever
// for serving over a bandwidth-limited host<->TPU link. Per block:
//   dc[c][by*bw+bx]                      int16 DC level (unchanged)
//   ac[c][(by*bw+bx)*(K*K-1) + n]        int8 AC level, natural KxK order
//                                        minus position (0,0), clamped to
//                                        [-128, 127]
// Levels outside int8 append (comp, flat_ac_index, residual) to `esc`
// (residual = level - clamped, so the device reconstructs exactly with a
// scatter-add after widening). *esc_count returns the TOTAL escapes seen;
// entries past esc_cap are counted but not stored — callers treat
// *esc_count > esc_cap as "use the int16 transport for this image".
// At serving qualities AC levels rarely exceed 127 (quantisers >= 4), so
// the upload shrinks ~2x vs the int16 layout at identical decoded pixels.
IK_EXPORT int ik_jpeg_decode_coeffs_lowfreq_i8(const uint8_t* data, size_t len,
                                               int K, int16_t** dc, int8_t** ac,
                                               int32_t* esc, int32_t esc_cap,
                                               int32_t* esc_count,
                                               uint16_t* qtabs_out) {
  if (K < 2 || K > 8) return IK_ERR_UNSUPPORTED;  // K=1 has no AC lanes
  const int NA = K * K - 1;
  int32_t nesc = 0;
  auto esc_append = [&](int c, size_t bi, int lane, int val, int clamped) {
    if (nesc < esc_cap) {
      esc[nesc * 3 + 0] = c;
      esc[nesc * 3 + 1] = static_cast<int32_t>(bi) * NA + lane;
      esc[nesc * 3 + 2] = val - clamped;
    }
    ++nesc;
  };
  auto sink_block = [&](int c, size_t bi, const int16_t* blk /*8x8 natural*/) {
    dc[c][bi] = blk[0];
    int8_t* adst = ac[c] + bi * NA;
#if defined(__SSE2__) || defined(_M_X64)
    if (K == 8) {
      // K=8 keeps all 63 AC lanes: saturating pack IS the clamp; escapes
      // (widened-back != original) surface via movemask and stay a rare
      // scalar tail. This path must match the int16 decode's cost — the
      // scalar loop doubled full-res entropy time.
      alignas(16) int8_t tmp[64];
      const __m128i c127 = _mm_set1_epi16(127);
      const __m128i cm128 = _mm_set1_epi16(-128);
      __m128i any = _mm_setzero_si128();
      for (int i = 0; i < 64; i += 16) {
        __m128i a =
            _mm_loadu_si128(reinterpret_cast<const __m128i*>(blk + i));
        __m128i b =
            _mm_loadu_si128(reinterpret_cast<const __m128i*>(blk + i + 8));
        // the DC lane ships int16 and never escapes — a large DC must not
        // trigger the scalar rescan (it would on most photos)
        __m128i achk = i == 0 ? _mm_insert_epi16(a, 0, 0) : a;
        any = _mm_or_si128(
            any, _mm_or_si128(_mm_cmpgt_epi16(achk, c127),
                              _mm_cmpgt_epi16(cm128, achk)));
        any = _mm_or_si128(
            any, _mm_or_si128(_mm_cmpgt_epi16(b, c127),
                              _mm_cmpgt_epi16(cm128, b)));
        _mm_store_si128(reinterpret_cast<__m128i*>(tmp + i),
                        _mm_packs_epi16(a, b));
      }
      std::memcpy(adst, tmp + 1, 63);
      if (_mm_movemask_epi8(any)) {  // rare: some lane saturated (DC ok)
        for (int lane = 1; lane < 64; ++lane) {
          const int val = blk[lane];
          if (val < -128 || val > 127)
            esc_append(c, bi, lane - 1, val, tmp[lane]);
        }
      }
      return;
    }
#endif
    int n = 0;
    for (int u = 0; u < K; ++u) {
      for (int v = (u ? 0 : 1); v < K; ++v) {
        int val = blk[u * 8 + v];
        int clamped = val < -128 ? -128 : (val > 127 ? 127 : val);
        if (val != clamped) esc_append(c, bi, n, val, clamped);
        adst[n++] = static_cast<int8_t>(clamped);
      }
    }
  };
  Decoder d;
  d.data = data;
  d.len = len;
  {
    Decoder probe;
    probe.data = data;
    probe.len = len;
    int prc = probe.Parse();
    if (prc != IK_OK) return prc;
    for (int c = 0; c < probe.ncomp; ++c) {
      // flat_ac_index must fit int32 (bounded in practice by the
      // decompression-bomb ceiling, but keep the invariant explicit)
      const int64_t total = static_cast<int64_t>(probe.comp[c].blocks_w) *
                            probe.comp[c].blocks_h * NA;
      if (total > INT32_MAX) return IK_ERR_UNSUPPORTED;
    }
    if (probe.progressive) {  // full decode to scratch, then truncate+split
      std::vector<std::vector<int16_t>> bufs(probe.ncomp);
      int16_t* ptrs[4] = {nullptr, nullptr, nullptr, nullptr};
      for (int c = 0; c < probe.ncomp; ++c) {
        bufs[c].assign(static_cast<size_t>(probe.comp[c].blocks_w) *
                           probe.comp[c].blocks_h * 64,
                       0);
        ptrs[c] = bufs[c].data();
      }
      int rc = ik_jpeg_decode_coeffs(data, len, ptrs, qtabs_out);
      if (rc != IK_OK) return rc;
      for (int c = 0; c < probe.ncomp; ++c) {
        const size_t nblk = static_cast<size_t>(probe.comp[c].blocks_w) *
                            probe.comp[c].blocks_h;
        for (size_t bi = 0; bi < nblk; ++bi)
          sink_block(c, bi, ptrs[c] + bi * 64);
      }
      *esc_count = nesc;
      return IK_OK;
    }
  }
  int rc = d.Parse();
  if (rc != IK_OK) return rc;
  for (int t = 0; t < 4; ++t)
    std::memcpy(qtabs_out + t * 64, d.qtab[t], 64 * sizeof(uint16_t));
  rc = d.DecodeScan([&](int c, int bx, int by, const int16_t* blk) {
    sink_block(c, static_cast<size_t>(by) * d.comp[c].blocks_w + bx, blk);
  });
  *esc_count = nesc;
  return rc;
}

// Encode a baseline JFIF JPEG from quantised coefficient planes.
// comp layout mirrors the decoder: coeffs[c] is [by][bx][64] natural order,
// sampling given by samp_h/samp_v arrays; qtab_luma/chroma natural order.
// Returns bytes written, or a negative IkErr.
IK_EXPORT int64_t ik_jpeg_encode(const int16_t** coeffs, int ncomp, int width,
                                 int height, const int32_t* samp_h,
                                 const int32_t* samp_v,
                                 const uint16_t* qtab_luma,
                                 const uint16_t* qtab_chroma, uint8_t* out,
                                 size_t out_cap) {
  if (ncomp != 1 && ncomp != 3) return IK_ERR_UNSUPPORTED;
  int hmax = 1, vmax = 1;
  for (int c = 0; c < ncomp; ++c) {
    if (samp_h[c] < 1 || samp_h[c] > 2 || samp_v[c] < 1 || samp_v[c] > 2)
      return IK_ERR_UNSUPPORTED;
    hmax = samp_h[c] > hmax ? samp_h[c] : hmax;
    vmax = samp_v[c] > vmax ? samp_v[c] : vmax;
  }
  int mcux = (width + 8 * hmax - 1) / (8 * hmax);
  int mcuy = (height + 8 * vmax - 1) / (8 * vmax);

  BitWriter w{out, out_cap};
  auto Seg = [&](std::initializer_list<uint8_t> bytes) {
    for (uint8_t b : bytes) w.PutByte(b);
  };
  auto U16 = [&](int v) {
    w.PutByte(static_cast<uint8_t>(v >> 8));
    w.PutByte(static_cast<uint8_t>(v & 0xFF));
  };

  Seg({0xFF, 0xD8});  // SOI
  // APP0 JFIF
  Seg({0xFF, 0xE0});
  U16(16);
  Seg({'J', 'F', 'I', 'F', 0, 1, 1, 0});
  U16(1);
  U16(1);
  Seg({0, 0});
  // DQT (zigzag order on the wire)
  auto WriteDqt = [&](int id, const uint16_t* q) {
    Seg({0xFF, 0xDB});
    U16(67);
    w.PutByte(static_cast<uint8_t>(id));
    for (int i = 0; i < 64; ++i)
      w.PutByte(static_cast<uint8_t>(q[kZigzag[i]] > 255 ? 255 : q[kZigzag[i]]));
  };
  WriteDqt(0, qtab_luma);
  if (ncomp == 3) WriteDqt(1, qtab_chroma);
  // SOF0
  Seg({0xFF, 0xC0});
  U16(8 + 3 * ncomp);
  w.PutByte(8);
  U16(height);
  U16(width);
  w.PutByte(static_cast<uint8_t>(ncomp));
  for (int c = 0; c < ncomp; ++c) {
    w.PutByte(static_cast<uint8_t>(c + 1));
    w.PutByte(static_cast<uint8_t>((samp_h[c] << 4) | samp_v[c]));
    w.PutByte(c == 0 ? 0 : 1);
  }
  int blocks_w[4];
  for (int c = 0; c < ncomp; ++c) blocks_w[c] = mcux * samp_h[c];

  // Shared MCU walk: dc_op(class, symbol, payload_bits, n) and
  // ac_op(class, symbol, payload_bits, n) run once per emitted Huffman
  // symbol — the statistics pass counts symbols, the write pass looks up
  // the optimised code and writes both the code and the payload.
  auto walk = [&](auto&& dc_op, auto&& ac_op) {
    int pred[4] = {0, 0, 0, 0};
    for (int my = 0; my < mcuy; ++my) {
      for (int mx = 0; mx < mcux; ++mx) {
        for (int c = 0; c < ncomp; ++c) {
          const int cls = c == 0 ? 0 : 1;
          for (int v = 0; v < samp_v[c]; ++v) {
            for (int h = 0; h < samp_h[c]; ++h) {
              int bx = mx * samp_h[c] + h;
              int by = my * samp_v[c] + v;
              const int16_t* blk =
                  coeffs[c] +
                  (static_cast<size_t>(by) * blocks_w[c] + bx) * 64;
              // DC
              int diff = blk[0] - pred[c];
              pred[c] = blk[0];
              int n = Magnitude(diff);
              dc_op(cls, n, diff < 0 ? diff - 1 + (1 << n) : diff, n);
              // AC: gather into zigzag order with a nonzero bitmask, then
              // iterate only the set bits (ctz run-skipping) — typical
              // blocks have <10 nonzero coefficients out of 63
              int16_t zz[64];
              uint64_t nzmask = 0;
              for (int k = 1; k < 64; ++k) {
                int16_t vv = blk[kZigzag[k]];
                zz[k] = vv;
                nzmask |= static_cast<uint64_t>(vv != 0) << k;
              }
              if (nzmask == 0) {
                ac_op(cls, 0x00, 0, 0);  // EOB
              } else {
                int last = 63 - __builtin_clzll(nzmask);
                int k = 1;
                while (k <= last) {
                  int next = __builtin_ctzll(nzmask >> k) + k;
                  int run = next - k;
                  while (run > 15) {
                    ac_op(cls, 0xF0, 0, 0);  // ZRL
                    run -= 16;
                  }
                  int val = zz[next];
                  int s = Magnitude(val);
                  ac_op(cls, (run << 4) | s,
                        val < 0 ? val - 1 + (1 << s) : val, s);
                  k = next + 1;
                }
                if (last < 63) ac_op(cls, 0x00, 0, 0);  // EOB
              }
            }
          }
        }
      }
    }
  };

  // pass 1: symbol statistics -> optimal per-image Huffman tables
  static_assert(sizeof(uint32_t) == 4, "");
  uint32_t fdc[2][256] = {}, fac[2][256] = {};
  walk([&](int cls, int sym, uint32_t, int) { ++fdc[cls][sym]; },
       [&](int cls, int sym, uint32_t, int) { ++fac[cls][sym]; });

  uint8_t dc_bits[2][17], dc_vals[2][256], ac_bits[2][17], ac_vals[2][256];
  int dc_n[2], ac_n[2];
  const int nclasses = ncomp == 3 ? 2 : 1;
  for (int cls = 0; cls < nclasses; ++cls) {
    BuildOptimalHuff(fdc[cls], dc_bits[cls], dc_vals[cls], &dc_n[cls]);
    BuildOptimalHuff(fac[cls], ac_bits[cls], ac_vals[cls], &ac_n[cls]);
  }

  // DHT (optimised tables)
  auto WriteDht = [&](int cls, int id, const uint8_t bits[17],
                      const uint8_t* vals, int total) {
    Seg({0xFF, 0xC4});
    U16(2 + 1 + 16 + total);
    w.PutByte(static_cast<uint8_t>((cls << 4) | id));
    for (int l = 1; l <= 16; ++l) w.PutByte(bits[l]);
    for (int i = 0; i < total; ++i) w.PutByte(vals[i]);
  };
  WriteDht(0, 0, dc_bits[0], dc_vals[0], dc_n[0]);
  WriteDht(1, 0, ac_bits[0], ac_vals[0], ac_n[0]);
  if (ncomp == 3) {
    WriteDht(0, 1, dc_bits[1], dc_vals[1], dc_n[1]);
    WriteDht(1, 1, ac_bits[1], ac_vals[1], ac_n[1]);
  }
  // SOS
  Seg({0xFF, 0xDA});
  U16(6 + 2 * ncomp);
  w.PutByte(static_cast<uint8_t>(ncomp));
  for (int c = 0; c < ncomp; ++c) {
    w.PutByte(static_cast<uint8_t>(c + 1));
    w.PutByte(c == 0 ? 0x00 : 0x11);
  }
  Seg({0, 63, 0});

  HuffEncTable dct[2], act[2];
  for (int cls = 0; cls < nclasses; ++cls) {
    dct[cls].Build(dc_bits[cls], dc_vals[cls]);
    act[cls].Build(ac_bits[cls], ac_vals[cls]);
  }

  // pass 2: entropy-coded data with the optimised tables
  walk(
      [&](int cls, int sym, uint32_t payload, int n) {
        w.Put(dct[cls].code[sym], dct[cls].size[sym]);
        if (n) w.Put(payload, n);
      },
      [&](int cls, int sym, uint32_t payload, int n) {
        w.Put(act[cls].code[sym], act[cls].size[sym]);
        if (n) w.Put(payload, n);
      });
  w.Flush();
  w.PutByte(0xFF);
  w.PutByte(0xD9);  // EOI
  if (w.overflow) return IK_ERR_BUFFER_TOO_SMALL;
  return static_cast<int64_t>(w.n);
}

IK_EXPORT int ik_native_version() { return 1; }
