// VP8 (WebP lossy) keyframe decoder — completes the native WebP story
// (encoder in vp8_encode.cpp): the reference's `image` crate decodes WebP
// sources natively (src/transform.rs:27-43); this is the TPU build's host
// entropy/reconstruction stage for them, feeding pixels to the batched
// device resize.
//
// Implements the full keyframe feature set per RFC 6386: segmentation (map
// + quant/filter features), loop-filter deltas, up to 8 token partitions,
// coefficient probability updates, all intra modes including B_PRED 4x4
// sub-modes, and the normative normal/simple loop filters. Lossless (VP8L)
// streams are handled by the companion native decoder (vp8l_decode.cpp);
// extended containers (VP8X/alpha/animation frame 0) are composed by the
// Python container layer (codecs/vp8.py) — NO WebP class falls back to
// the host library.
//
// Exactness: decoding our own encoder's output with the loop filter off
// reproduces the encoder's reconstruction bit-for-bit (shared normative
// inverse transforms in vp8_common.h); the filter path is validated against
// libwebp's decoder on grayscale streams where the RGB conversion is an
// invertible per-pixel LUT (tests/test_vp8_decode.py).

#include <cstdint>
#include <cstring>
#include <vector>

#if defined(__AVX2__)
#include <immintrin.h>
#endif

#include "vp8_common.h"
#include "vp8_tables.h"

#ifndef IK_EXPORT
#define IK_EXPORT extern "C" __attribute__((visibility("default")))
#endif

namespace {

using ikvp8::Clip255;
using ikvp8::ClampQ;
using ikvp8::Idct4x4;
using ikvp8::PredictB;
using ikvp8::PredictI16OrChroma;
using ikvp8::InvWht4x4;
using ikvp8::Quantizers;
using ikvp8::SetupQuantDeltas;

constexpr int VD_OK = 0;
constexpr int VD_TRUNCATED = -1;
constexpr int VD_BAD_MAGIC = -2;
constexpr int VD_UNSUPPORTED = -3;
constexpr int VD_BAD_DATA = -4;
constexpr int VD_BUFFER = -7;

// ---------------------------------------------------------------------------
// Boolean decoder (RFC 6386 §7.2)
// ---------------------------------------------------------------------------
// Boolean (range) decoder, 64-bit formulation: `v` keeps the arithmetic
// window in its top 8 bits with up to 56 lookahead stream bits below.
// The bit decision `value >= split<<8` of the byte-at-a-time formulation
// depends only on the 8-bit window (the lookahead is strictly below the
// subtrahend), so widening the lookahead is exact; renormalisation becomes
// one clz shift and refills pull 4 raw bytes at a time (VP8 partitions
// carry no marker stuffing). Past-end bytes read as zero, as before.
struct BoolDec {
  const uint8_t* buf = nullptr;
  size_t len = 0, pos = 0;  // pos = bytes PRELOADED into v (may pass len)
  uint64_t v = 0;
  int filled = 0;  // live bits in v, counted from the MSB
  uint32_t range = 255;

  void Init(const uint8_t* b, size_t n) {
    buf = b;
    len = n;
    pos = 0;
    v = 0;
    for (int i = 0; i < 8; ++i) {
      v = (v << 8) | (pos < len ? buf[pos] : 0);
      ++pos;
    }
    filled = 64;
    range = 255;
  }

  inline void Refill() {
    if (pos + 4 <= len && filled <= 32) {
      uint32_t x;
      std::memcpy(&x, buf + pos, 4);
      v |= static_cast<uint64_t>(__builtin_bswap32(x)) << (32 - filled);
      filled += 32;
      pos += 4;
      return;
    }
    while (filled <= 56) {
      v |= static_cast<uint64_t>(pos < len ? buf[pos] : 0) << (56 - filled);
      ++pos;
      filled += 8;
    }
  }

  inline int GetBit(int prob) {
    const uint32_t split =
        1 + (((range - 1) * static_cast<uint32_t>(prob)) >> 8);
    const uint64_t SPLIT = static_cast<uint64_t>(split) << 56;
    int ret;
    if (v >= SPLIT) {
      ret = 1;
      range -= split;
      v -= SPLIT;
    } else {
      ret = 0;
      range = split;
    }
    if (range < 128) {
      const int shift = __builtin_clz(range) - 24;
      range <<= shift;
      v <<= shift;
      filled -= shift;
      if (filled < 16) Refill();
    }
    return ret;
  }

  uint32_t GetLiteral(int bits) {
    uint32_t out = 0;
    for (int i = 0; i < bits; ++i) out = (out << 1) | GetBit(128);
    return out;
  }

  int GetSigned(int bits) {
    const int out = static_cast<int>(GetLiteral(bits));
    return GetBit(128) ? -out : out;
  }

  // gross overread guard: bytes actually consumed out of the window
  bool Exhausted() const {
    return pos - static_cast<size_t>(filled >> 3) > len + 8;
  }
};

// ---------------------------------------------------------------------------
// Mode / tree constants (RFC 6386 §8.2, §11)
// ---------------------------------------------------------------------------
// I16/chroma modes: 0=DC 1=V 2=H 3=TM, 4=B_PRED (luma only).
// B modes: 0=B_DC 1=B_TM 2=B_VE 3=B_HE 4=B_LD 5=B_RD 6=B_VR 7=B_VL 8=B_HD 9=B_HU

int ReadKfYMode(BoolDec& d) {
  if (!d.GetBit(145)) return 4;  // B_PRED
  if (!d.GetBit(156)) return d.GetBit(163) ? 1 : 0;  // DC / V
  return d.GetBit(128) ? 3 : 2;                      // H / TM
}

int ReadUvMode(BoolDec& d) {
  if (!d.GetBit(142)) return 0;
  if (!d.GetBit(114)) return 1;
  return d.GetBit(183) ? 3 : 2;
}

// bmode_tree (RFC 6386 §8.2) with probs from kKfBModeProbs[above][left]
int ReadBMode(BoolDec& d, const uint8_t* p) {
  if (!d.GetBit(p[0])) return 0;   // B_DC
  if (!d.GetBit(p[1])) return 1;   // B_TM
  if (!d.GetBit(p[2])) return 2;   // B_VE
  if (!d.GetBit(p[3])) {
    if (!d.GetBit(p[4])) return 3;  // B_HE
    return d.GetBit(p[5]) ? 6 : 5;  // B_VR / B_RD
  }
  if (!d.GetBit(p[6])) return 4;    // B_LD
  if (!d.GetBit(p[7])) return 7;    // B_VL
  return d.GetBit(p[8]) ? 9 : 8;    // B_HU / B_HD
}

// map I16 luma modes to b-modes for sub-mode prediction contexts (§11.3)
inline int I16ToBMode(int m) {
  static const int kMap[4] = {0 /*B_DC*/, 2 /*B_VE*/, 3 /*B_HE*/, 1 /*B_TM*/};
  return kMap[m];
}

// coefficient bands and zigzag (shared constants with the encoder)
const uint8_t kBands[16] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7};
const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};

const uint8_t kCat1[] = {159};
const uint8_t kCat2[] = {165, 145};
const uint8_t kCat3[] = {173, 148, 140};
const uint8_t kCat4[] = {176, 155, 140, 135};
const uint8_t kCat5[] = {180, 157, 141, 134, 130};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129};
struct Cat {
  int base;
  int bits;
  const uint8_t* probs;
};
const Cat kCats[6] = {{5, 1, kCat1},  {7, 2, kCat2},  {11, 3, kCat3},
                      {19, 4, kCat4}, {35, 5, kCat5}, {67, 11, kCat6}};

// ---------------------------------------------------------------------------
// Frame state
// ---------------------------------------------------------------------------
struct MbInfo {
  uint8_t segment = 0;
  uint8_t skip = 0;
  uint8_t ymode = 0;   // 0..3 I16, 4 = B_PRED
  uint8_t uvmode = 0;
  uint8_t bmodes[16] = {0};
};

struct Header {
  int width = 0, height = 0, mbw = 0, mbh = 0;
  bool seg_enabled = false, seg_update_map = false, seg_abs = false;
  uint8_t seg_tree_probs[3] = {255, 255, 255};
  int seg_q[4] = {0, 0, 0, 0};
  int seg_lf[4] = {0, 0, 0, 0};
  int filter_type = 0, filter_level = 0, sharpness = 0;
  bool lf_delta_enabled = false;
  int ref_lf_deltas[4] = {0, 0, 0, 0};
  int mode_lf_deltas[4] = {0, 0, 0, 0};
  int num_parts = 1;
  int qindex = 0, y1dc_d = 0, y2dc_d = 0, y2ac_d = 0, uvdc_d = 0, uvac_d = 0;
  uint8_t coeff_probs[4][8][3][11];
  bool no_skip = false;
  uint8_t prob_skip_false = 0;
};

int ParseHeader(BoolDec& d, Header* h) {
  d.GetLiteral(1);  // color_space
  d.GetLiteral(1);  // clamping_type
  h->seg_enabled = d.GetBit(128);
  if (h->seg_enabled) {
    h->seg_update_map = d.GetBit(128);
    const bool update_data = d.GetBit(128);
    if (update_data) {
      h->seg_abs = d.GetBit(128);
      for (int i = 0; i < 4; ++i)
        if (d.GetBit(128)) h->seg_q[i] = d.GetSigned(7);
      for (int i = 0; i < 4; ++i)
        if (d.GetBit(128)) h->seg_lf[i] = d.GetSigned(6);
    }
    if (h->seg_update_map) {
      for (int i = 0; i < 3; ++i)
        h->seg_tree_probs[i] =
            d.GetBit(128) ? static_cast<uint8_t>(d.GetLiteral(8)) : 255;
    }
  }
  h->filter_type = static_cast<int>(d.GetLiteral(1));
  h->filter_level = static_cast<int>(d.GetLiteral(6));
  h->sharpness = static_cast<int>(d.GetLiteral(3));
  h->lf_delta_enabled = d.GetBit(128);
  if (h->lf_delta_enabled) {
    if (d.GetBit(128)) {  // update
      for (int i = 0; i < 4; ++i)
        if (d.GetBit(128)) h->ref_lf_deltas[i] = d.GetSigned(6);
      for (int i = 0; i < 4; ++i)
        if (d.GetBit(128)) h->mode_lf_deltas[i] = d.GetSigned(6);
    }
  }
  h->num_parts = 1 << d.GetLiteral(2);
  h->qindex = static_cast<int>(d.GetLiteral(7));
  auto delta = [&d]() { return d.GetBit(128) ? d.GetSigned(4) : 0; };
  h->y1dc_d = delta();
  h->y2dc_d = delta();
  h->y2ac_d = delta();
  h->uvdc_d = delta();
  h->uvac_d = delta();
  d.GetBit(128);  // refresh_entropy_probs (irrelevant for stills)
  std::memcpy(h->coeff_probs, kCoeffProbs, sizeof(kCoeffProbs));
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int p = 0; p < 11; ++p)
          if (d.GetBit(kCoeffUpdateProbs[t][b][c][p]))
            h->coeff_probs[t][b][c][p] =
                static_cast<uint8_t>(d.GetLiteral(8));
  h->no_skip = d.GetBit(128);
  if (h->no_skip)
    h->prob_skip_false = static_cast<uint8_t>(d.GetLiteral(8));
  return d.Exhausted() ? VD_TRUNCATED : VD_OK;
}

// ---------------------------------------------------------------------------
// Token decoding (RFC 6386 §13)
// ---------------------------------------------------------------------------
// Returns the count of decoded coefficients ("last nonzero + 1"-ish; 0 means
// the block is empty). coef: 16 values in NATURAL order.
int DecodeBlock(BoolDec& d, const uint8_t probs[8][3][11], int16_t* coef,
                int first, int ctx, const ikvp8::QuantPair& q) {
  std::memset(coef, 0, 16 * sizeof(int16_t));
  // Enregistered bool-decoder state for the hot token loop: `coef` stores
  // and the refill's byte loads defeat alias analysis on the BoolDec
  // fields, forcing reloads per bit; locals keep everything in registers.
  const uint8_t* const buf = d.buf;
  const size_t len = d.len;
  size_t pos = d.pos;
  uint64_t bv = d.v;
  int filled = d.filled;
  uint32_t range = d.range;
  auto getbit = [&](int prob) -> int {
    const uint32_t split =
        1 + (((range - 1) * static_cast<uint32_t>(prob)) >> 8);
    const uint64_t SPLIT = static_cast<uint64_t>(split) << 56;
    // branchless decision (the bit value is true entropy — a branch here
    // mispredicts constantly) + unconditional clz renorm (range >= 128
    // gives shift 0)
    const int ret = bv >= SPLIT;
    bv -= ret ? SPLIT : 0;
    range = ret ? range - split : split;
    const int shift = __builtin_clz(range) - 24;
    range <<= shift;
    bv <<= shift;
    filled -= shift;
    if (filled < 16) {
      if (pos + 4 <= len && filled <= 32) {
        uint32_t x;
        std::memcpy(&x, buf + pos, 4);
        bv |= static_cast<uint64_t>(__builtin_bswap32(x)) << (32 - filled);
        filled += 32;
        pos += 4;
      } else {
        while (filled <= 56) {
          bv |= static_cast<uint64_t>(pos < len ? buf[pos] : 0)
                << (56 - filled);
          ++pos;
          filled += 8;
        }
      }
    }
    return ret;
  };

  int n = first;
  int c = ctx;
  int nonzero = 0;
  while (n < 16) {
    const uint8_t* p = probs[kBands[n]][c];
    if (!getbit(p[0])) break;  // EOB
  not_eob:
    if (!getbit(p[1])) {  // DCT_0: no EOB flag follows a zero token
      ++n;
      if (n >= 16) break;
      c = 0;
      p = probs[kBands[n]][0];
      goto not_eob;
    }
    int a;
    if (!getbit(p[2])) {
      a = 1;
      c = 1;
    } else {
      c = 2;
      if (!getbit(p[3])) {
        if (!getbit(p[4])) {
          a = 2;
        } else {
          a = getbit(p[5]) ? 4 : 3;
        }
      } else {
        int cat;
        if (!getbit(p[6])) {
          cat = getbit(p[7]) ? 1 : 0;
        } else {
          if (!getbit(p[8])) {
            cat = getbit(p[9]) ? 3 : 2;
          } else {
            cat = getbit(p[10]) ? 5 : 4;
          }
        }
        const Cat& cc = kCats[cat];
        int rem = 0;
        for (int b = 0; b < cc.bits; ++b)
          rem = (rem << 1) | getbit(cc.probs[b]);
        a = cc.base + rem;
      }
    }
    const int v = getbit(128) ? -a : a;
    const int pos_n = kZigzag[n];
    coef[pos_n] = static_cast<int16_t>(v * (pos_n == 0 ? q.dc : q.ac));
    nonzero = n + 1;
    ++n;
  }
  d.pos = pos;
  d.v = bv;
  d.filled = filled;
  d.range = range;
  return nonzero;
}

// ---------------------------------------------------------------------------
// Loop filter (RFC 6386 §15), normal + simple.
// ---------------------------------------------------------------------------
inline int Sclamp(int v) { return v < -128 ? -128 : (v > 127 ? 127 : v); }
inline int S(uint8_t v) { return static_cast<int>(v) - 128; }
inline uint8_t U(int v) { return static_cast<uint8_t>(Sclamp(v) + 128); }

struct Px {
  uint8_t* p;  // pointer to Q0
  int step;    // distance between adjacent pixels across the edge
  int q(int i) const { return S(p[i * step]); }
  int pp(int i) const { return S(p[-(i + 1) * step]); }
  void set_q(int i, int v) { p[i * step] = U(v); }
  void set_p(int i, int v) { p[-(i + 1) * step] = U(v); }
};

inline int CommonAdjust(bool use_outer, Px& e) {
  const int P1 = e.pp(1), P0 = e.pp(0), Q0 = e.q(0), Q1 = e.q(1);
  int a = Sclamp((use_outer ? Sclamp(P1 - Q1) : 0) + 3 * (Q0 - P0));
  const int F = Sclamp(a + 4) >> 3;
  const int E = Sclamp(a + 3) >> 3;
  e.set_q(0, Q0 - F);
  e.set_p(0, P0 + E);
  return F;
}

inline bool FilterMask(const Px& e, int interior, int edge_limit) {
  const int P3 = e.pp(3), P2 = e.pp(2), P1 = e.pp(1), P0 = e.pp(0);
  const int Q0 = e.q(0), Q1 = e.q(1), Q2 = e.q(2), Q3 = e.q(3);
  auto ab = [](int v) { return v < 0 ? -v : v; };
  return (ab(P0 - Q0) * 2 + ab(P1 - Q1) / 2) <= edge_limit &&
         ab(P3 - P2) <= interior && ab(P2 - P1) <= interior &&
         ab(P1 - P0) <= interior && ab(Q3 - Q2) <= interior &&
         ab(Q2 - Q1) <= interior && ab(Q1 - Q0) <= interior;
}

inline bool Hev(const Px& e, int thresh) {
  auto ab = [](int v) { return v < 0 ? -v : v; };
  return ab(e.pp(1) - e.pp(0)) > thresh || ab(e.q(1) - e.q(0)) > thresh;
}

void SubblockFilter(Px e, int hev_t, int interior, int edge_limit) {
  if (!FilterMask(e, interior, edge_limit)) return;
  const bool hev = Hev(e, hev_t);
  int a = CommonAdjust(hev, e);
  if (!hev) {
    a = (a + 1) >> 1;
    e.set_q(1, e.q(1) - a);
    e.set_p(1, e.pp(1) + a);
  }
}

void MbFilter(Px e, int hev_t, int interior, int edge_limit) {
  if (!FilterMask(e, interior, edge_limit)) return;
  if (Hev(e, hev_t)) {
    CommonAdjust(true, e);
    return;
  }
  const int w = Sclamp(Sclamp(e.pp(1) - e.q(1)) + 3 * (e.q(0) - e.pp(0)));
  int a = Sclamp((27 * w + 63) >> 7);
  e.set_q(0, e.q(0) - a);
  e.set_p(0, e.pp(0) + a);
  a = Sclamp((18 * w + 63) >> 7);
  e.set_q(1, e.q(1) - a);
  e.set_p(1, e.pp(1) + a);
  a = Sclamp((9 * w + 63) >> 7);
  e.set_q(2, e.q(2) - a);
  e.set_p(2, e.pp(2) + a);
}

#if defined(__AVX2__)
// SIMD horizontal-edge filtering: 16 pixel columns at once in epi16 with
// explicit [-128,127] clamps — the exact integer semantics of the scalar
// Px path (S/Sclamp/U), pinned by the bit-exact-vs-libwebp tests. One call
// covers a 16-wide luma edge (two 8-byte halves of one row) or a U+V pair
// (same geometry and parameters, different planes). Vertical edges stay on
// the scalar path; the driver preserves the normative edge order.
inline __m256i LfClamp(__m256i v) {
  return _mm256_max_epi16(_mm256_min_epi16(v, _mm256_set1_epi16(127)),
                          _mm256_set1_epi16(-128));
}

inline __m256i LfLoad(const uint8_t* a, const uint8_t* b) {
  const __m128i lo = _mm_loadl_epi64(reinterpret_cast<const __m128i*>(a));
  const __m128i hi = _mm_loadl_epi64(reinterpret_cast<const __m128i*>(b));
  return _mm256_sub_epi16(_mm256_cvtepu8_epi16(_mm_unpacklo_epi64(lo, hi)),
                          _mm256_set1_epi16(128));
}

inline void LfStore(uint8_t* a, uint8_t* b, __m256i v) {
  v = _mm256_add_epi16(LfClamp(v), _mm256_set1_epi16(128));
  const __m256i packed = _mm256_packus_epi16(v, v);
  _mm_storel_epi64(reinterpret_cast<__m128i*>(a),
                   _mm256_castsi256_si128(packed));
  _mm_storel_epi64(reinterpret_cast<__m128i*>(b),
                   _mm256_extracti128_si256(packed, 1));
}

// pa/pb: the two 8-byte segments of the Q0 row (strides sa/sb).
// macroblock=true applies MbFilter semantics, false SubblockFilter.
void FilterEdgeH(uint8_t* pa, int sa, uint8_t* pb, int sb, bool macroblock,
                 int hev_t, int interior, int edge_limit) {
  const __m256i zero = _mm256_setzero_si256();
  __m256i r[8];  // p3 p2 p1 p0 q0 q1 q2 q3
  for (int i = 0; i < 8; ++i)
    r[i] = LfLoad(pa + (i - 4) * sa, pb + (i - 4) * sb);
  const __m256i p3 = r[0], p2 = r[1], p1 = r[2], p0 = r[3];
  const __m256i q0 = r[4], q1 = r[5], q2 = r[6], q3 = r[7];
  const __m256i vI = _mm256_set1_epi16(static_cast<short>(interior));
  auto le = [&](__m256i x, __m256i lim) {  // |x| <= lim, per lane
    return _mm256_cmpeq_epi16(_mm256_cmpgt_epi16(_mm256_abs_epi16(x), lim),
                              zero);
  };
  const __m256i d0 = _mm256_abs_epi16(_mm256_sub_epi16(p0, q0));
  const __m256i d1 = _mm256_abs_epi16(_mm256_sub_epi16(p1, q1));
  const __m256i sum = _mm256_add_epi16(_mm256_slli_epi16(d0, 1),
                                       _mm256_srli_epi16(d1, 1));
  __m256i mask = _mm256_cmpeq_epi16(
      _mm256_cmpgt_epi16(sum, _mm256_set1_epi16(static_cast<short>(edge_limit))),
      zero);
  mask = _mm256_and_si256(mask, le(_mm256_sub_epi16(p3, p2), vI));
  mask = _mm256_and_si256(mask, le(_mm256_sub_epi16(p2, p1), vI));
  mask = _mm256_and_si256(mask, le(_mm256_sub_epi16(p1, p0), vI));
  mask = _mm256_and_si256(mask, le(_mm256_sub_epi16(q3, q2), vI));
  mask = _mm256_and_si256(mask, le(_mm256_sub_epi16(q2, q1), vI));
  mask = _mm256_and_si256(mask, le(_mm256_sub_epi16(q1, q0), vI));
  if (_mm256_testz_si256(mask, mask)) return;
  const __m256i vH = _mm256_set1_epi16(static_cast<short>(hev_t));
  const __m256i hev = _mm256_or_si256(
      _mm256_cmpgt_epi16(_mm256_abs_epi16(_mm256_sub_epi16(p1, p0)), vH),
      _mm256_cmpgt_epi16(_mm256_abs_epi16(_mm256_sub_epi16(q1, q0)), vH));
  const __m256i outer = LfClamp(_mm256_sub_epi16(p1, q1));
  const __m256i step3 = _mm256_mullo_epi16(
      _mm256_sub_epi16(q0, p0), _mm256_set1_epi16(3));
  if (macroblock) {
    // w is shared by both branches (MbFilter uses the outer tap always)
    const __m256i w = LfClamp(_mm256_add_epi16(outer, step3));
    // hev lanes: common adjust on p0/q0 only
    const __m256i Fh = _mm256_srai_epi16(
        LfClamp(_mm256_add_epi16(w, _mm256_set1_epi16(4))), 3);
    const __m256i Eh = _mm256_srai_epi16(
        LfClamp(_mm256_add_epi16(w, _mm256_set1_epi16(3))), 3);
    // !hev lanes: 27/18/9 taps
    auto tap = [&](int mulc) {
      return LfClamp(_mm256_srai_epi16(
          _mm256_add_epi16(
              _mm256_mullo_epi16(w, _mm256_set1_epi16(static_cast<short>(mulc))),
              _mm256_set1_epi16(63)),
          7));
    };
    const __m256i a27 = tap(27), a18 = tap(18), a9 = tap(9);
    auto blend = [&](__m256i orig, __m256i hev_v, __m256i nhev_v) {
      const __m256i nv = _mm256_blendv_epi8(nhev_v, hev_v, hev);
      return _mm256_blendv_epi8(orig, nv, mask);
    };
    const __m256i q0n = blend(q0, _mm256_sub_epi16(q0, Fh),
                              _mm256_sub_epi16(q0, a27));
    const __m256i p0n = blend(p0, _mm256_add_epi16(p0, Eh),
                              _mm256_add_epi16(p0, a27));
    const __m256i q1n = blend(q1, q1, _mm256_sub_epi16(q1, a18));
    const __m256i p1n = blend(p1, p1, _mm256_add_epi16(p1, a18));
    const __m256i q2n = blend(q2, q2, _mm256_sub_epi16(q2, a9));
    const __m256i p2n = blend(p2, p2, _mm256_add_epi16(p2, a9));
    LfStore(pa - 3 * sa, pb - 3 * sb, p2n);
    LfStore(pa - 2 * sa, pb - 2 * sb, p1n);
    LfStore(pa - 1 * sa, pb - 1 * sb, p0n);
    LfStore(pa, pb, q0n);
    LfStore(pa + 1 * sa, pb + 1 * sb, q1n);
    LfStore(pa + 2 * sa, pb + 2 * sb, q2n);
  } else {
    // subblock: outer tap only on hev lanes
    const __m256i a = LfClamp(_mm256_add_epi16(
        _mm256_and_si256(outer, hev), step3));
    const __m256i F = _mm256_srai_epi16(
        LfClamp(_mm256_add_epi16(a, _mm256_set1_epi16(4))), 3);
    const __m256i E = _mm256_srai_epi16(
        LfClamp(_mm256_add_epi16(a, _mm256_set1_epi16(3))), 3);
    const __m256i a2 = _mm256_andnot_si256(
        hev,
        _mm256_srai_epi16(_mm256_add_epi16(F, _mm256_set1_epi16(1)), 1));
    auto apply = [&](__m256i orig, __m256i nv) {
      return _mm256_blendv_epi8(orig, nv, mask);
    };
    LfStore(pa - 2 * sa, pb - 2 * sb,
            apply(p1, _mm256_add_epi16(p1, a2)));
    LfStore(pa - 1 * sa, pb - 1 * sb, apply(p0, _mm256_add_epi16(p0, E)));
    LfStore(pa, pb, apply(q0, _mm256_sub_epi16(q0, F)));
    LfStore(pa + 1 * sa, pb + 1 * sb, apply(q1, _mm256_sub_epi16(q1, a2)));
  }
}
#endif  // __AVX2__

void SimpleSegment(Px e, int edge_limit) {
  auto ab = [](int v) { return v < 0 ? -v : v; };
  if ((ab(e.pp(0) - e.q(0)) * 2 + ab(e.pp(1) - e.q(1)) / 2) <= edge_limit)
    CommonAdjust(true, e);
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------
struct IkVp8Info {
  int32_t width, height;
};

namespace {

// locate the "VP8 " chunk inside a RIFF WebP container; returns
// VD_UNSUPPORTED for VP8L/VP8X (alpha/animation/lossless -> host library)
int FindVp8Chunk(const uint8_t* d, size_t len, const uint8_t** frame,
                 size_t* frame_len) {
  if (len < 20 || std::memcmp(d, "RIFF", 4) != 0 ||
      std::memcmp(d + 8, "WEBP", 4) != 0)
    return VD_BAD_MAGIC;
  size_t pos = 12;
  while (pos + 8 <= len) {
    const uint32_t sz = d[pos + 4] | (d[pos + 5] << 8) | (d[pos + 6] << 16) |
                        (static_cast<uint32_t>(d[pos + 7]) << 24);
    if (std::memcmp(d + pos, "VP8 ", 4) == 0) {
      if (pos + 8 + sz > len) return VD_TRUNCATED;
      *frame = d + pos + 8;
      *frame_len = sz;
      return VD_OK;
    }
    if (std::memcmp(d + pos, "VP8L", 4) == 0 ||
        std::memcmp(d + pos, "VP8X", 4) == 0)
      return VD_UNSUPPORTED;  // lossless / extended features
    pos += 8 + sz + (sz & 1);
  }
  return VD_BAD_DATA;
}

struct FrameGeom {
  int width, height, mbw, mbh;
  const uint8_t* p1;
  size_t p1_len;
  const uint8_t* rest;  // partition-size table + token partitions
  size_t rest_len;
};

int ParseFrameTag(const uint8_t* f, size_t len, FrameGeom* g) {
  if (len < 10) return VD_TRUNCATED;
  const uint32_t tag = f[0] | (f[1] << 8) | (f[2] << 16);
  if (tag & 1) return VD_UNSUPPORTED;  // interframe: not a still
  const uint32_t p1size = tag >> 5;
  if (f[3] != 0x9d || f[4] != 0x01 || f[5] != 0x2a) return VD_BAD_DATA;
  g->width = (f[6] | (f[7] << 8)) & 0x3fff;
  g->height = (f[8] | (f[9] << 8)) & 0x3fff;
  if (g->width <= 0 || g->height <= 0) return VD_BAD_DATA;
  g->mbw = (g->width + 15) / 16;
  g->mbh = (g->height + 15) / 16;
  if (10 + p1size > len) return VD_TRUNCATED;
  g->p1 = f + 10;
  g->p1_len = p1size;
  g->rest = f + 10 + p1size;
  g->rest_len = len - 10 - p1size;
  return VD_OK;
}

}  // namespace

IK_EXPORT int ik_webp_parse(const uint8_t* d, size_t len, IkVp8Info* out) {
  const uint8_t* f;
  size_t flen;
  int rc = FindVp8Chunk(d, len, &f, &flen);
  if (rc != VD_OK) return rc;
  FrameGeom g;
  rc = ParseFrameTag(f, flen, &g);
  out->width = g.width;
  out->height = g.height;
  return rc;
}

// Decode a lossy WebP into caller YUV 4:2:0 planes. y: stride ystride,
// (mbh*16) rows usable; u/v: stride cstride. Caller crops to width/height
// and (w+1)/2 x (h+1)/2.
IK_EXPORT int ik_webp_decode_yuv(const uint8_t* d, size_t len, uint8_t* yout,
                                 int ystride, uint8_t* uout, uint8_t* vout,
                                 int cstride) {
  const uint8_t* f;
  size_t flen;
  int rc = FindVp8Chunk(d, len, &f, &flen);
  if (rc != VD_OK) return rc;
  FrameGeom g;
  rc = ParseFrameTag(f, flen, &g);
  if (rc != VD_OK) return rc;

  BoolDec hd;
  hd.Init(g.p1, g.p1_len);
  Header h;
  h.width = g.width;
  h.height = g.height;
  h.mbw = g.mbw;
  h.mbh = g.mbh;
  rc = ParseHeader(hd, &h);
  if (rc != VD_OK) return rc;

  // token partitions
  BoolDec parts[8];
  {
    const int np = h.num_parts;
    if (np < 1 || np > 8) return VD_BAD_DATA;
    const uint8_t* p = g.rest;
    size_t rem = g.rest_len;
    const size_t table = static_cast<size_t>(3) * (np - 1);
    if (rem < table) return VD_TRUNCATED;
    const uint8_t* data = p + table;
    rem -= table;
    for (int i = 0; i < np; ++i) {
      size_t sz;
      if (i < np - 1) {
        sz = p[i * 3] | (p[i * 3 + 1] << 8) |
             (static_cast<size_t>(p[i * 3 + 2]) << 16);
        if (sz > rem) return VD_TRUNCATED;
      } else {
        sz = rem;
      }
      parts[i].Init(data, sz);
      data += sz;
      rem -= sz;
    }
  }

  // per-segment dequantisers
  Quantizers segq[4];
  for (int s = 0; s < 4; ++s) {
    int qi = h.qindex;
    if (h.seg_enabled) qi = h.seg_abs ? h.seg_q[s] : qi + h.seg_q[s];
    qi = ClampQ(qi);
    segq[s] = SetupQuantDeltas(qi, h.y1dc_d, h.y2dc_d, h.y2ac_d, h.uvdc_d,
                               h.uvac_d);
  }

  const int mbw = g.mbw, mbh = g.mbh;
  const int W = mbw * 16, H = mbh * 16, CW = mbw * 8, CH = mbh * 8;

  // ---- mode parsing (all in partition 1, before any tokens) ----
  std::vector<MbInfo> mbs(static_cast<size_t>(mbw) * mbh);
  {
    // b-mode context rows (above), seeded B_DC outside the frame
    std::vector<uint8_t> above_modes(static_cast<size_t>(mbw) * 4, 0);
    uint8_t left_modes[4];
    for (int my = 0; my < mbh; ++my) {
      left_modes[0] = left_modes[1] = left_modes[2] = left_modes[3] = 0;
      for (int mx = 0; mx < mbw; ++mx) {
        MbInfo& mb = mbs[static_cast<size_t>(my) * mbw + mx];
        if (h.seg_enabled && h.seg_update_map) {
          // mb_segment_tree (RFC §10)
          if (!hd.GetBit(h.seg_tree_probs[0]))
            mb.segment = hd.GetBit(h.seg_tree_probs[1]) ? 1 : 0;
          else
            mb.segment = hd.GetBit(h.seg_tree_probs[2]) ? 3 : 2;
        }
        if (h.no_skip) mb.skip = hd.GetBit(h.prob_skip_false);
        mb.ymode = static_cast<uint8_t>(ReadKfYMode(hd));
        if (mb.ymode == 4) {  // B_PRED: 16 sub-modes with above/left ctx
          for (int sb = 0; sb < 16; ++sb) {
            const int sx = sb & 3, sy = sb >> 2;
            const int am = sy == 0 ? above_modes[mx * 4 + sx]
                                   : mb.bmodes[sb - 4];
            const int lm = sx == 0 ? left_modes[sy] : mb.bmodes[sb - 1];
            mb.bmodes[sb] =
                static_cast<uint8_t>(ReadBMode(hd, kKfBModeProbs[am][lm]));
          }
        } else {
          const uint8_t bm = static_cast<uint8_t>(I16ToBMode(mb.ymode));
          for (int i = 0; i < 16; ++i) mb.bmodes[i] = bm;
        }
        for (int i = 0; i < 4; ++i) {
          above_modes[mx * 4 + i] = mb.bmodes[12 + i];
          left_modes[i] = mb.bmodes[i * 4 + 3];
        }
        mb.uvmode = static_cast<uint8_t>(ReadUvMode(hd));
      }
    }
    if (hd.Exhausted()) return VD_TRUNCATED;
  }

  // ---- reconstruction planes with prediction borders ----
  // luma: (1 + H) rows x (1 + W + 4) cols; chroma: (1 + CH) x (1 + CW)
  const int ls = 1 + W + 4;
  const int cs = 1 + CW;
  std::vector<uint8_t> ybuf(static_cast<size_t>(1 + H) * ls, 129);
  std::vector<uint8_t> ubuf(static_cast<size_t>(1 + CH) * cs, 129);
  std::vector<uint8_t> vbuf(static_cast<size_t>(1 + CH) * cs, 129);
  std::memset(ybuf.data(), 127, ls);  // top border row (incl. corner + AR)
  std::memset(ubuf.data(), 127, cs);
  std::memset(vbuf.data(), 127, cs);
  uint8_t* Y = ybuf.data() + ls + 1;
  uint8_t* Ub = ubuf.data() + cs + 1;
  uint8_t* Vb = vbuf.data() + cs + 1;

  // token contexts
  std::vector<uint8_t> a_y(static_cast<size_t>(mbw) * 4, 0),
      a_u(static_cast<size_t>(mbw) * 2, 0),
      a_v(static_cast<size_t>(mbw) * 2, 0), a_y2(mbw, 0);
  uint8_t l_y[4], l_u[2], l_v[2], l_y2;

  // per-MB "has non-zero coefficients" for the loop filter
  std::vector<uint8_t> mb_has_coeff(mbs.size(), 0);

  int16_t coef[25][16];
  int px[16];

  for (int my = 0; my < mbh; ++my) {
    BoolDec& td = parts[my % h.num_parts];
    std::memset(l_y, 0, 4);
    std::memset(l_u, 0, 2);
    std::memset(l_v, 0, 2);
    l_y2 = 0;
    for (int mx = 0; mx < mbw; ++mx) {
      MbInfo& mb = mbs[static_cast<size_t>(my) * mbw + mx];
      const Quantizers& q = segq[mb.segment];
      const bool bpred = mb.ymode == 4;
      bool any_nz = false;
      std::memset(coef, 0, sizeof(coef));

      if (mb.skip) {
        for (int i = 0; i < 4; ++i) a_y[mx * 4 + i] = l_y[i] = 0;
        for (int i = 0; i < 2; ++i) {
          a_u[mx * 2 + i] = l_u[i] = 0;
          a_v[mx * 2 + i] = l_v[i] = 0;
        }
        if (!bpred) a_y2[mx] = l_y2 = 0;
      } else {
        // y2 first for I16
        int y2_nz = 0;
        if (!bpred) {
          const int ctx = a_y2[mx] + l_y2;
          y2_nz = DecodeBlock(td, h.coeff_probs[1], coef[24], 0, ctx, q.y2);
          a_y2[mx] = l_y2 = y2_nz ? 1 : 0;
          if (y2_nz) any_nz = true;
        }
        const int plane = bpred ? 3 : 0;
        const int first = bpred ? 0 : 1;
        for (int sb = 0; sb < 16; ++sb) {
          const int sx = sb & 3, sy = sb >> 2;
          const int ctx = a_y[mx * 4 + sx] + l_y[sy];
          const int nz =
              DecodeBlock(td, h.coeff_probs[plane], coef[sb], first, ctx,
                          q.y1);
          a_y[mx * 4 + sx] = l_y[sy] = nz ? 1 : 0;
          if (nz) any_nz = true;
        }
        for (int pl = 0; pl < 2; ++pl) {
          uint8_t* ac = pl ? a_v.data() : a_u.data();
          uint8_t* lc = pl ? l_v : l_u;
          for (int sb = 0; sb < 4; ++sb) {
            const int sx = sb & 1, sy = sb >> 1;
            const int ctx = ac[mx * 2 + sx] + lc[sy];
            const int nz = DecodeBlock(td, h.coeff_probs[2],
                                       coef[16 + pl * 4 + sb], 0, ctx, q.uv);
            ac[mx * 2 + sx] = lc[sy] = nz ? 1 : 0;
            if (nz) any_nz = true;
          }
        }
        // scatter Y2 -> per-block DC (inverse WHT on dequantised values)
        if (!bpred) {
          int dcout[16];
          InvWht4x4(coef[24], dcout);
          for (int sb = 0; sb < 16; ++sb)
            coef[sb][0] = static_cast<int16_t>(dcout[sb]);
        }
      }
      mb_has_coeff[static_cast<size_t>(my) * mbw + mx] = any_nz || bpred;

      // ---- reconstruct ----
      const int pxl = mx * 16, pyl = my * 16;
      if (!bpred) {
        PredictI16OrChroma(Y, ls, pxl, pyl, 16, mb.ymode, my > 0, mx > 0);
        for (int sb = 0; sb < 16; ++sb) {
          const int bx = pxl + (sb & 3) * 4, by = pyl + (sb >> 2) * 4;
          // all-zero residual is a no-op; cheap skip
          bool z = true;
          for (int i = 0; i < 16 && z; ++i) z = coef[sb][i] == 0;
          if (z) continue;
          ikvp8::IdctAdd4x4(coef[sb], Y + by * ls + bx, ls);
        }
      } else {
        // sub-block prediction + residual, sequential
        for (int sb = 0; sb < 16; ++sb) {
          const int bx = pxl + (sb & 3) * 4, by = pyl + (sb >> 2) * 4;
          uint8_t* o = Y + by * ls + bx;
          uint8_t A[8], L[4];
          const uint8_t* arow = Y + (by - 1) * ls + bx;
          std::memcpy(A, arow, 4);
          // above-right: interior blocks read the adjacent decoded row;
          // right-edge sub-blocks read the row above the MB (stale-read
          // rule), which the +4 luma border columns make safe at the frame
          // edge (127 on row -1, replicated rows elsewhere)
          if ((sb & 3) < 3 || sb < 4) {
            std::memcpy(A + 4, arow + 4, 4);
          } else {
            const uint8_t* mbrow = Y + (pyl - 1) * ls + pxl + 16;
            std::memcpy(A + 4, mbrow, 4);
          }
          for (int i = 0; i < 4; ++i) L[i] = o[i * ls - 1];
          const int AL = arow[-1];
          PredictB(o, ls, mb.bmodes[sb], A, L, AL);
          bool z = true;
          for (int i = 0; i < 16 && z; ++i) z = coef[sb][i] == 0;
          if (!z) {
            ikvp8::IdctAdd4x4(coef[sb], o, ls);
          }
        }
      }
      // chroma
      const int cpx = mx * 8, cpy = my * 8;
      PredictI16OrChroma(Ub, cs, cpx, cpy, 8, mb.uvmode, my > 0, mx > 0);
      PredictI16OrChroma(Vb, cs, cpx, cpy, 8, mb.uvmode, my > 0, mx > 0);
      for (int pl = 0; pl < 2; ++pl) {
        uint8_t* P = pl ? Vb : Ub;
        for (int sb = 0; sb < 4; ++sb) {
          const int16_t* cf = coef[16 + pl * 4 + sb];
          bool z = true;
          for (int i = 0; i < 16 && z; ++i) z = cf[i] == 0;
          if (z) continue;
          const int bx = cpx + (sb & 1) * 4, by = cpy + (sb >> 1) * 4;
          ikvp8::IdctAdd4x4(cf, P + by * cs + bx, cs);
        }
      }
    }
    // extend the right border for next row's above-right reads
    for (int yy = my * 16; yy < my * 16 + 16; ++yy) {
      uint8_t* row = Y + yy * ls;
      std::memset(row + W, row[W - 1], 4);
    }
  }

  // ---- loop filter ----
  if (h.filter_level > 0) {
    for (int my = 0; my < mbh; ++my) {
      for (int mx = 0; mx < mbw; ++mx) {
        const MbInfo& mb = mbs[static_cast<size_t>(my) * mbw + mx];
        int level = h.filter_level;
        if (h.seg_enabled)
          level = h.seg_abs ? h.seg_lf[mb.segment]
                            : level + h.seg_lf[mb.segment];
        if (h.lf_delta_enabled) {
          level += h.ref_lf_deltas[0];  // keyframe: INTRA ref
          if (mb.ymode == 4) level += h.mode_lf_deltas[0];
        }
        if (level < 0) level = 0;
        if (level > 63) level = 63;
        if (level == 0) continue;

        int interior = level;
        if (h.sharpness) {
          interior >>= h.sharpness > 4 ? 2 : 1;
          if (interior > 9 - h.sharpness) interior = 9 - h.sharpness;
        }
        if (interior < 1) interior = 1;
        const int mb_lim = ((level + 2) * 2) + interior;
        const int sub_lim = (level * 2) + interior;
        int hev_t = 0;
        if (level >= 40)
          hev_t = 2;
        else if (level >= 15)
          hev_t = 1;
        const bool inner =
            mb_has_coeff[static_cast<size_t>(my) * mbw + mx] != 0;
        const int pxl = mx * 16, pyl = my * 16;
        const int cpx = mx * 8, cpy = my * 8;

        if (h.filter_type == 0) {  // normal
          if (mx > 0) {
            for (int yy = 0; yy < 16; ++yy)
              MbFilter({Y + (pyl + yy) * ls + pxl, 1}, hev_t, interior, mb_lim);
            for (int yy = 0; yy < 8; ++yy) {
              MbFilter({Ub + (cpy + yy) * cs + cpx, 1}, hev_t, interior, mb_lim);
              MbFilter({Vb + (cpy + yy) * cs + cpx, 1}, hev_t, interior, mb_lim);
            }
          }
          if (inner) {
            for (int e = 4; e < 16; e += 4)
              for (int yy = 0; yy < 16; ++yy)
                SubblockFilter({Y + (pyl + yy) * ls + pxl + e, 1}, hev_t,
                               interior, sub_lim);
            for (int yy = 0; yy < 8; ++yy) {
              SubblockFilter({Ub + (cpy + yy) * cs + cpx + 4, 1}, hev_t,
                             interior, sub_lim);
              SubblockFilter({Vb + (cpy + yy) * cs + cpx + 4, 1}, hev_t,
                             interior, sub_lim);
            }
          }
#if defined(__AVX2__)
          if (my > 0) {
            uint8_t* yr = Y + pyl * ls + pxl;
            FilterEdgeH(yr, ls, yr + 8, ls, true, hev_t, interior, mb_lim);
            FilterEdgeH(Ub + cpy * cs + cpx, cs, Vb + cpy * cs + cpx, cs,
                        true, hev_t, interior, mb_lim);
          }
          if (inner) {
            for (int e = 4; e < 16; e += 4) {
              uint8_t* yr = Y + (pyl + e) * ls + pxl;
              FilterEdgeH(yr, ls, yr + 8, ls, false, hev_t, interior,
                          sub_lim);
            }
            FilterEdgeH(Ub + (cpy + 4) * cs + cpx, cs,
                        Vb + (cpy + 4) * cs + cpx, cs, false, hev_t,
                        interior, sub_lim);
          }
#else
          if (my > 0) {
            for (int xx = 0; xx < 16; ++xx)
              MbFilter({Y + pyl * ls + pxl + xx, ls}, hev_t, interior, mb_lim);
            for (int xx = 0; xx < 8; ++xx) {
              MbFilter({Ub + cpy * cs + cpx + xx, cs}, hev_t, interior, mb_lim);
              MbFilter({Vb + cpy * cs + cpx + xx, cs}, hev_t, interior, mb_lim);
            }
          }
          if (inner) {
            for (int e = 4; e < 16; e += 4)
              for (int xx = 0; xx < 16; ++xx)
                SubblockFilter({Y + (pyl + e) * ls + pxl + xx, ls}, hev_t,
                               interior, sub_lim);
            for (int xx = 0; xx < 8; ++xx) {
              SubblockFilter({Ub + (cpy + 4) * cs + cpx + xx, cs}, hev_t,
                             interior, sub_lim);
              SubblockFilter({Vb + (cpy + 4) * cs + cpx + xx, cs}, hev_t,
                             interior, sub_lim);
            }
          }
#endif
        } else {  // simple: luma only
          if (mx > 0)
            for (int yy = 0; yy < 16; ++yy)
              SimpleSegment({Y + (pyl + yy) * ls + pxl, 1}, mb_lim);
          if (inner)
            for (int e = 4; e < 16; e += 4)
              for (int yy = 0; yy < 16; ++yy)
                SimpleSegment({Y + (pyl + yy) * ls + pxl + e, 1}, sub_lim);
          if (my > 0)
            for (int xx = 0; xx < 16; ++xx)
              SimpleSegment({Y + pyl * ls + pxl + xx, ls}, mb_lim);
          if (inner)
            for (int e = 4; e < 16; e += 4)
              for (int xx = 0; xx < 16; ++xx)
                SimpleSegment({Y + (pyl + e) * ls + pxl + xx, ls}, sub_lim);
        }
      }
    }
  }

  // ---- copy out ----
  for (int yy = 0; yy < H; ++yy)
    std::memcpy(yout + static_cast<size_t>(yy) * ystride, Y + yy * ls, W);
  for (int yy = 0; yy < CH; ++yy) {
    std::memcpy(uout + static_cast<size_t>(yy) * cstride, Ub + yy * cs, CW);
    std::memcpy(vout + static_cast<size_t>(yy) * cstride, Vb + yy * cs, CW);
  }
  return VD_OK;
}

IK_EXPORT int ik_vp8_decode_version() { return 1; }
