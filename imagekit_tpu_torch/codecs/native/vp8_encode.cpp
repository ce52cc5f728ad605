// VP8 (WebP lossy) keyframe encoder — the host entropy half of the
// TPU-native WebP encode split (SURVEY.md §2.2: "TPU Pallas: fDCT/quantize +
// chroma subsampling; host C++: VP8 bitstream + arithmetic coding";
// reference encode arm: src/transform.rs:129-137 via libwebp).
//
// Input: YUV 4:2:0 planes (the device produces these — RGB->YUV and chroma
// subsampling run batched on TPU, see ops/color.py). This encoder performs
// the serial, reconstruction-dependent stages that cannot batch on device:
// intra prediction from reconstructed neighbours, 4x4 forward DCT/WHT of the
// prediction residual, quantisation, and boolean arithmetic coding of the
// token stream (RFC 6386).
//
// Scope: I16 (DC/V/H/TM) AND B_PRED 4x4 luma modes with full-RD sub-mode
// selection (quantised-residual distortion + exact token/mode tree bits,
// round 3 — closed the per-cell size gaps vs libwebp on structured
// content), 8x8 chroma modes, macroblock skip coding, quantiser-scaled
// loop-filter level signalling, content-adaptive trellis quantisation
// (auto: K=15 at q>=~85, K=5 in the q<=~65 mid band on busy content
// only, OFF on smooth gradients and at the q80 serving default), and
// segmentation (RFC 6386 §9.3/§10 adaptive quantisation — feature
// complete + decoder-validated; the auto amplitude is 0 because the
// parity corpora measured no per-MB-map win, env IMAGEKIT_VP8_SEG_AMP
// enables it). Single token partition. Measured vs libwebp:
// docs/PARITY_REPORT.md — every cell <= 1.0x size at >= -0.03 dB except
// noise q95 (+4% at -0.004 dB, documented), ~1.5x faster at q80.
//
// Standard constant tables (token probs, update probs, quantiser lookups)
// are in vp8_tables.h, extracted from the system libvpx/libwebp binaries and
// cross-validated between those two independent implementations
// (tools/extract_vp8_tables.py).

#include <algorithm>
#include <array>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

#if defined(__AVX2__)
#define IK_VP8_SIMD 1
#include <immintrin.h>
#endif

#include "vp8_common.h"
#include "vp8_tables.h"

#ifndef IK_EXPORT
#define IK_EXPORT extern "C" __attribute__((visibility("default")))
#endif

namespace {

using ikvp8::Clip255;
using ikvp8::Idct4x4;
using ikvp8::InvWht4x4;
using ikvp8::QuantPair;
using ikvp8::Quantizers;
using ikvp8::ClampQ;
using ikvp8::SetupQuant;

// ---------------------------------------------------------------------------
// Boolean (range) encoder — RFC 6386 §7. The decoder-side algorithm is
// normative; this is the standard matching encoder with carry propagation.
// ---------------------------------------------------------------------------
struct BoolEnc {
  std::vector<uint8_t> buf;
  uint32_t lowvalue = 0;
  uint32_t range = 255;
  int count = -24;

  void PutBit(int bit, int prob) {
    const uint32_t split = 1 + (((range - 1) * static_cast<uint32_t>(prob)) >> 8);
    if (bit) {
      lowvalue += split;
      range -= split;
    } else {
      range = split;
    }
    // renormalise in one step (range >= 1 always; target range >= 128)
    int shift =
        range < 128 ? __builtin_clz(static_cast<uint32_t>(range)) - 24 : 0;
    range <<= shift;
    count += shift;
    if (count >= 0) {
      const int offset = shift - count;
      if ((lowvalue << (offset - 1)) & 0x80000000u) {
        // propagate carry into already-emitted bytes
        int x = static_cast<int>(buf.size()) - 1;
        while (x >= 0 && buf[x] == 0xff) {
          buf[x] = 0;
          --x;
        }
        if (x >= 0) buf[x] += 1;
      }
      buf.push_back(static_cast<uint8_t>((lowvalue >> (24 - offset)) & 0xff));
      lowvalue <<= offset;
      lowvalue &= 0xffffff;
      shift = count;
      count -= 8;
    }
    lowvalue <<= shift;
  }

  void PutLiteral(uint32_t v, int bits) {
    for (int b = bits - 1; b >= 0; --b) PutBit((v >> b) & 1, 128);
  }

  // flag+magnitude+sign encoding used by quantiser deltas (RFC 6386 §9.6)
  void PutZeroDelta() { PutBit(0, 128); }
  void PutDelta(int v) {
    if (v == 0) {
      PutBit(0, 128);
      return;
    }
    PutBit(1, 128);
    PutLiteral(static_cast<uint32_t>(v < 0 ? -v : v), 4);
    PutBit(v < 0 ? 1 : 0, 128);
  }

  void Stop() {
    for (int i = 0; i < 32; ++i) PutBit(0, 128);
  }
};

// Keyframe mode trees (RFC 6386 §8.2, §11.2):
//   kf_ymode_tree  = {-B_PRED, 2, 4, 6, -DC, -V, -H, -TM}, probs {145,156,163,128}
//   uv_mode_tree   = {-DC, 2, -V, 4, -H, -TM},             probs {142,114,183}
// Mode numbering used throughout: 0=DC 1=V 2=H 3=TM.

// coefficient position -> probability band (RFC 6386 §13.3)
const uint8_t kBands[16] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7};
// 4x4 zigzag scan order (RFC 6386 §14.4? — standard)
const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};

// Extra-bit probabilities per token category (RFC 6386 §13.2)
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
const Cat kCats[6] = {{5, 1, kCat1},  {7, 2, kCat2},   {11, 3, kCat3},
                      {19, 4, kCat4}, {35, 5, kCat5},  {67, 11, kCat6}};

void PutYMode(BoolEnc& e, int mode) {  // kf_ymode_tree paths
  if (mode == 4) {  // B_PRED
    e.PutBit(0, 145);
    return;
  }
  e.PutBit(1, 145);
  switch (mode) {
    case 0: e.PutBit(0, 156); e.PutBit(0, 163); break;  // DC
    case 1: e.PutBit(0, 156); e.PutBit(1, 163); break;  // V
    case 2: e.PutBit(1, 156); e.PutBit(0, 128); break;  // H
    default: e.PutBit(1, 156); e.PutBit(1, 128); break;  // TM
  }
}

// bmode_tree writer — exact mirror of the decoder's ReadBMode
void PutBMode(BoolEnc& e, const uint8_t* p, int m) {
  switch (m) {
    case 0: e.PutBit(0, p[0]); break;                                 // B_DC
    case 1: e.PutBit(1, p[0]); e.PutBit(0, p[1]); break;              // B_TM
    case 2: e.PutBit(1, p[0]); e.PutBit(1, p[1]); e.PutBit(0, p[2]); break;
    case 3:  // B_HE
      e.PutBit(1, p[0]); e.PutBit(1, p[1]); e.PutBit(1, p[2]);
      e.PutBit(0, p[3]); e.PutBit(0, p[4]);
      break;
    case 5:  // B_RD
      e.PutBit(1, p[0]); e.PutBit(1, p[1]); e.PutBit(1, p[2]);
      e.PutBit(0, p[3]); e.PutBit(1, p[4]); e.PutBit(0, p[5]);
      break;
    case 6:  // B_VR
      e.PutBit(1, p[0]); e.PutBit(1, p[1]); e.PutBit(1, p[2]);
      e.PutBit(0, p[3]); e.PutBit(1, p[4]); e.PutBit(1, p[5]);
      break;
    case 4:  // B_LD
      e.PutBit(1, p[0]); e.PutBit(1, p[1]); e.PutBit(1, p[2]);
      e.PutBit(1, p[3]); e.PutBit(0, p[6]);
      break;
    case 7:  // B_VL
      e.PutBit(1, p[0]); e.PutBit(1, p[1]); e.PutBit(1, p[2]);
      e.PutBit(1, p[3]); e.PutBit(1, p[6]); e.PutBit(0, p[7]);
      break;
    case 8:  // B_HD
      e.PutBit(1, p[0]); e.PutBit(1, p[1]); e.PutBit(1, p[2]);
      e.PutBit(1, p[3]); e.PutBit(1, p[6]); e.PutBit(1, p[7]);
      e.PutBit(0, p[8]);
      break;
    default:  // B_HU
      e.PutBit(1, p[0]); e.PutBit(1, p[1]); e.PutBit(1, p[2]);
      e.PutBit(1, p[3]); e.PutBit(1, p[6]); e.PutBit(1, p[7]);
      e.PutBit(1, p[8]);
      break;
  }
}

inline int BitCost(int bit, int p);  // defined with the token-cost tables

// Exact tree cost (1/256-bit units) of coding sub-mode m under the
// context probability set p — mirrors PutBMode's paths. Used by the
// B_PRED sub-mode RD decision: on structured content several modes
// often predict near-equally and the context-coded mode bits (cheap
// when agreeing with neighbours) decide, exactly the term an SSE-only
// rank ignores.
int CostBMode(const uint8_t* p, int m) {
  int c;  // forward declaration keeps each case a plain expression
  switch (m) {
    case 0: return BitCost(0, p[0]);
    case 1: return BitCost(1, p[0]) + BitCost(0, p[1]);
    case 2: return BitCost(1, p[0]) + BitCost(1, p[1]) + BitCost(0, p[2]);
    default:
      c = BitCost(1, p[0]) + BitCost(1, p[1]) + BitCost(1, p[2]);
      break;
  }
  switch (m) {
    case 3: return c + BitCost(0, p[3]) + BitCost(0, p[4]);
    case 5:
      return c + BitCost(0, p[3]) + BitCost(1, p[4]) + BitCost(0, p[5]);
    case 6:
      return c + BitCost(0, p[3]) + BitCost(1, p[4]) + BitCost(1, p[5]);
    case 4: return c + BitCost(1, p[3]) + BitCost(0, p[6]);
    case 7:
      return c + BitCost(1, p[3]) + BitCost(1, p[6]) + BitCost(0, p[7]);
    case 8:
      return c + BitCost(1, p[3]) + BitCost(1, p[6]) + BitCost(1, p[7]) +
             BitCost(0, p[8]);
    default:
      return c + BitCost(1, p[3]) + BitCost(1, p[6]) + BitCost(1, p[7]) +
             BitCost(1, p[8]);
  }
}

// map I16 luma modes to b-modes for sub-mode contexts (decoder mirror)
inline int I16ToBMode(int m) {
  static const int kMap[4] = {0, 2, 3, 1};
  return kMap[m];
}

void PutUvMode(BoolEnc& e, int mode) {  // uv_mode_tree paths
  switch (mode) {
    case 0: e.PutBit(0, 142); break;                                  // DC
    case 1: e.PutBit(1, 142); e.PutBit(0, 114); break;                // V
    case 2: e.PutBit(1, 142); e.PutBit(1, 114); e.PutBit(0, 183); break;  // H
    default: e.PutBit(1, 142); e.PutBit(1, 114); e.PutBit(1, 183); break;  // TM
  }
}

// ---------------------------------------------------------------------------
// Transforms. The INVERSE transforms are normative (RFC 6386 §14.3-14.5) and
// must match the decoder bit-exactly — reconstruction here IS what the
// decoder will display (loop filter level 0). The forward transforms are the
// encoder's free choice; these are the standard fixed-point inverses' pairs.
// ---------------------------------------------------------------------------

void Fdct4x4Scalar(const int16_t* in, int16_t* out) {  // 4x4 residual, row-major
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int16_t* ip = in + i * 4;
    const int a1 = (ip[0] + ip[3]) * 8;
    const int b1 = (ip[1] + ip[2]) * 8;
    const int c1 = (ip[1] - ip[2]) * 8;
    const int d1 = (ip[0] - ip[3]) * 8;
    tmp[i * 4 + 0] = a1 + b1;
    tmp[i * 4 + 2] = a1 - b1;
    tmp[i * 4 + 1] = (c1 * 2217 + d1 * 5352 + 14500) >> 12;
    tmp[i * 4 + 3] = (d1 * 2217 - c1 * 5352 + 7500) >> 12;
  }
  for (int i = 0; i < 4; ++i) {
    const int a1 = tmp[0 + i] + tmp[12 + i];
    const int b1 = tmp[4 + i] + tmp[8 + i];
    const int c1 = tmp[4 + i] - tmp[8 + i];
    const int d1 = tmp[0 + i] - tmp[12 + i];
    out[0 + i] = static_cast<int16_t>((a1 + b1 + 7) >> 4);
    out[8 + i] = static_cast<int16_t>((a1 - b1 + 7) >> 4);
    out[4 + i] =
        static_cast<int16_t>(((c1 * 2217 + d1 * 5352 + 12000) >> 16) + (d1 != 0));
    out[12 + i] = static_cast<int16_t>((d1 * 2217 - c1 * 5352 + 51000) >> 16);
  }
}

#ifdef IK_VP8_SIMD
// Same integer arithmetic as Fdct4x4Scalar, vectorised across the four
// rows (4-lane epi32, two 4x4 transposes). Every op is exact: adds, mullo,
// arithmetic shifts; the scalar casts never overflow int16 so packs'
// saturation is a no-op. Bitstream-identity is pinned by the roundtrip
// exactness tests and the byte-identical trellis-off regression.
inline void Fdct4x4(const int16_t* in, int16_t* out) {
  const __m128i zero = _mm_setzero_si128();
  const __m128i ones = _mm_set1_epi32(1);
  const __m128i k2217 = _mm_set1_epi32(2217);
  const __m128i k5352 = _mm_set1_epi32(5352);
  __m128i c0 = _mm_cvtepi16_epi32(
      _mm_loadl_epi64(reinterpret_cast<const __m128i*>(in + 0)));
  __m128i c1 = _mm_cvtepi16_epi32(
      _mm_loadl_epi64(reinterpret_cast<const __m128i*>(in + 4)));
  __m128i c2 = _mm_cvtepi16_epi32(
      _mm_loadl_epi64(reinterpret_cast<const __m128i*>(in + 8)));
  __m128i c3 = _mm_cvtepi16_epi32(
      _mm_loadl_epi64(reinterpret_cast<const __m128i*>(in + 12)));
  auto transpose = [](__m128i& a, __m128i& b, __m128i& c, __m128i& d) {
    const __m128i t0 = _mm_unpacklo_epi32(a, b);
    const __m128i t1 = _mm_unpacklo_epi32(c, d);
    const __m128i t2 = _mm_unpackhi_epi32(a, b);
    const __m128i t3 = _mm_unpackhi_epi32(c, d);
    a = _mm_unpacklo_epi64(t0, t1);
    b = _mm_unpackhi_epi64(t0, t1);
    c = _mm_unpacklo_epi64(t2, t3);
    d = _mm_unpackhi_epi64(t2, t3);
  };
  transpose(c0, c1, c2, c3);  // c_k = column k over the four rows
  // row pass (vector lane = row index)
  __m128i a1 = _mm_slli_epi32(_mm_add_epi32(c0, c3), 3);
  __m128i b1 = _mm_slli_epi32(_mm_add_epi32(c1, c2), 3);
  __m128i cc = _mm_slli_epi32(_mm_sub_epi32(c1, c2), 3);
  __m128i d1 = _mm_slli_epi32(_mm_sub_epi32(c0, c3), 3);
  __m128i t0 = _mm_add_epi32(a1, b1);
  __m128i t2 = _mm_sub_epi32(a1, b1);
  __m128i t1 = _mm_srai_epi32(
      _mm_add_epi32(_mm_add_epi32(_mm_mullo_epi32(cc, k2217),
                                  _mm_mullo_epi32(d1, k5352)),
                    _mm_set1_epi32(14500)),
      12);
  __m128i t3 = _mm_srai_epi32(
      _mm_add_epi32(_mm_sub_epi32(_mm_mullo_epi32(d1, k2217),
                                  _mm_mullo_epi32(cc, k5352)),
                    _mm_set1_epi32(7500)),
      12);
  transpose(t0, t1, t2, t3);  // t_r = tmp row r
  // column pass (vector lane = column index)
  a1 = _mm_add_epi32(t0, t3);
  b1 = _mm_add_epi32(t1, t2);
  cc = _mm_sub_epi32(t1, t2);
  d1 = _mm_sub_epi32(t0, t3);
  const __m128i o0 =
      _mm_srai_epi32(_mm_add_epi32(_mm_add_epi32(a1, b1), _mm_set1_epi32(7)), 4);
  const __m128i o2 =
      _mm_srai_epi32(_mm_add_epi32(_mm_sub_epi32(a1, b1), _mm_set1_epi32(7)), 4);
  const __m128i d_nz = _mm_add_epi32(ones, _mm_cmpeq_epi32(d1, zero));
  const __m128i o1 = _mm_add_epi32(
      _mm_srai_epi32(
          _mm_add_epi32(_mm_add_epi32(_mm_mullo_epi32(cc, k2217),
                                      _mm_mullo_epi32(d1, k5352)),
                        _mm_set1_epi32(12000)),
          16),
      d_nz);
  const __m128i o3 = _mm_srai_epi32(
      _mm_add_epi32(_mm_sub_epi32(_mm_mullo_epi32(d1, k2217),
                                  _mm_mullo_epi32(cc, k5352)),
                    _mm_set1_epi32(51000)),
      16);
  _mm_storeu_si128(reinterpret_cast<__m128i*>(out), _mm_packs_epi32(o0, o1));
  _mm_storeu_si128(reinterpret_cast<__m128i*>(out + 8),
                   _mm_packs_epi32(o2, o3));
}
#else
inline void Fdct4x4(const int16_t* in, int16_t* out) {
  Fdct4x4Scalar(in, out);
}
#endif

// Forward Walsh-Hadamard over the 16 luma DC values.
void Wht4x4(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a1 = (in[i * 4 + 0] + in[i * 4 + 2]) * 4;
    const int d1 = (in[i * 4 + 1] + in[i * 4 + 3]) * 4;
    const int c1 = (in[i * 4 + 1] - in[i * 4 + 3]) * 4;
    const int b1 = (in[i * 4 + 0] - in[i * 4 + 2]) * 4;
    tmp[i * 4 + 0] = a1 + d1 + (a1 != 0);
    tmp[i * 4 + 1] = b1 + c1;
    tmp[i * 4 + 2] = b1 - c1;
    tmp[i * 4 + 3] = a1 - d1;
  }
  for (int i = 0; i < 4; ++i) {
    const int a1 = tmp[0 + i] + tmp[8 + i];
    const int d1 = tmp[4 + i] + tmp[12 + i];
    const int c1 = tmp[4 + i] - tmp[12 + i];
    const int b1 = tmp[0 + i] - tmp[8 + i];
    int a2 = a1 + d1;
    int b2 = b1 + c1;
    int c2 = b1 - c1;
    int d2 = a1 - d1;
    a2 += a2 < 0;
    b2 += b2 < 0;
    c2 += c2 < 0;
    d2 += d2 < 0;
    out[0 + i] = static_cast<int16_t>((a2 + 3) >> 3);
    out[4 + i] = static_cast<int16_t>((b2 + 3) >> 3);
    out[8 + i] = static_cast<int16_t>((c2 + 3) >> 3);
    out[12 + i] = static_cast<int16_t>((d2 + 3) >> 3);
  }
}

// libwebp quality->compression (quant.c, sns_strength=0): qindex =
// 127 * (1 - QualityToCompression(q/100)).
int QualityToQIndex(int quality) {
  const double c = quality / 100.0;
  const double linear_c = (c < 0.75) ? c * (2.0 / 3.0) : 2.0 * c - 1.0;
  const double v = std::pow(linear_c, 1.0 / 3.0);
  int qi = static_cast<int>(127.0 * (1.0 - v) + 0.5);
  return ClampQ(qi);
}

// Quantise one coefficient: nearest-ish rounding with a smaller AC bias
// (plain nearest over-spends bits on noise; this mirrors libwebp's bias
// split without its full RD trellis). Biases in 1/16ths of q.
#ifndef IK_VP8_DC_BIAS16
#define IK_VP8_DC_BIAS16 8
#endif
#ifndef IK_VP8_AC_BIAS16
#define IK_VP8_AC_BIAS16 6
#endif
inline int16_t Quantize(int v, int q, bool is_dc) {
  const int a = v < 0 ? -v : v;
  const int bias =
      (q * (is_dc ? IK_VP8_DC_BIAS16 : IK_VP8_AC_BIAS16)) >> 4;
  int out = (a + bias) / q;
  if (out > 2047) out = 2047;  // token cat6 ceiling
  return static_cast<int16_t>(v < 0 ? -out : out);
}

// ---------------------------------------------------------------------------
// Trellis-lite quantisation (per-coefficient rate/distortion pruning).
//
// Plain biased quantisation spends bits on coefficients whose token cost
// exceeds their distortion value — worst at high quality on text-like
// content, where libwebp's trellis kept a size edge. This is a small
// Viterbi pass over the 16 zigzag positions of one block: per position the
// candidate levels are {nearest, nearest-1, 0}; the DP state is the VP8
// token context (0 = previous zero, 1 = previous |level| 1, 2 = bigger),
// which is all the token tree's probability selection depends on beyond
// the (known) band. Rates are exact token-tree costs under the pass's
// CostModel: the spec defaults on the first analysis pass (the
// frame-adapted tables of §13.4 are only known after levels are chosen),
// and the pass-1-fitted tables on the optional second pass (TwoPassEnv),
// which makes level choices agree with the probabilities the header
// actually signals. EOB placement falls out of the DP: ending the block at
// position i is scored as path cost + the EOB bit + the distortion of
// zeroing the tail.
//
// Distortion is measured in the transform domain (squared dequantisation
// error); the forward/inverse transform pair is uniformly scaled at 2x
// orthonormal, so transform-domain SSE is 4x pixel-domain SSE for every
// frequency and the constant folds into lambda. Score units: 256*D +
// lambda*R with R in 1/256-bit units, making lambda "transform-domain
// distortion per bit" — calibrated as a percentage of q_ac^2
// (IMAGEKIT_VP8_TRELLIS_K, percent; 0 disables the trellis).
// ---------------------------------------------------------------------------

// cost of coding `bit` under probability `p`, in 1/256-bit units
inline int BitCost(int bit, int p) {
  static const auto kCost = [] {
    std::array<int, 256> t{};
    for (int i = 1; i < 256; ++i)
      t[i] = static_cast<int>(-std::log2(i / 256.0) * 256.0 + 0.5);
    t[0] = t[1];
    return t;
  }();
  return kCost[bit ? 255 - p : p];
}

// Token-tree cost of coding magnitude a (>= 1) under probability set P[11],
// excluding the not-EOB flag (node 0), including the sign bit. Mirrors
// CodeBlock's tree walk exactly.
inline int TokenCostNonzero(const uint8_t* P, int a) {
  int cost = BitCost(1, P[1]);
  if (a == 1) return cost + BitCost(0, P[2]) + 256;
  cost += BitCost(1, P[2]);
  if (a <= 4) {
    cost += BitCost(0, P[3]);
    if (a == 2) {
      cost += BitCost(0, P[4]);
    } else {
      cost += BitCost(1, P[4]) + BitCost(a == 4 ? 1 : 0, P[5]);
    }
  } else {
    cost += BitCost(1, P[3]);
    int cat;
    if (a <= 10) {
      cost += BitCost(0, P[6]);
      cat = (a <= 6) ? 0 : 1;
      cost += BitCost(cat, P[7]);
    } else {
      cost += BitCost(1, P[6]);
      if (a <= 34) {
        cost += BitCost(0, P[8]);
        cat = (a <= 18) ? 2 : 3;
        cost += BitCost(cat == 3 ? 1 : 0, P[9]);
      } else {
        cost += BitCost(1, P[8]);
        cat = (a <= 66) ? 4 : 5;
        cost += BitCost(cat == 5 ? 1 : 0, P[10]);
      }
    }
    const Cat& cc = kCats[cat];
    const int rem = a - cc.base;
    for (int b = cc.bits - 1; b >= 0; --b)
      cost += BitCost((rem >> b) & 1, cc.probs[cc.bits - 1 - b]);
  }
  return cost + 256;  // sign (prob 128)
}

using CoeffProbs = uint8_t[4][8][3][11];

// Memoised nonzero-token costs under one probability table set (magnitudes
// >= 68 fall back to the tree walk; cat6 extra bits vary per level).
struct NzCostTable {
  int32_t c[4][8][3][68];
  explicit NzCostTable(const CoeffProbs& P) {
    for (int p = 0; p < 4; ++p)
      for (int b = 0; b < 8; ++b)
        for (int x = 0; x < 3; ++x) {
          c[p][b][x][0] = 0;
          for (int l = 1; l < 68; ++l)
            c[p][b][x][l] = TokenCostNonzero(P[p][b][x], l);
        }
  }
};

// Probability tables the RATE ESTIMATES run under (the bitstream's tables
// are chosen separately, by AdaptCoeffProbs). Pass 1 estimates under the
// spec defaults; the optional second analysis pass re-estimates under the
// pass-1-fitted tables so level and mode choices agree with the
// probabilities the frame header will actually signal (libwebp couples
// its level costs to its recorded stats the same way).
struct CostModel {
  const CoeffProbs* probs;
  const NzCostTable* nzc;
};

inline const CostModel& DefaultCostModel() {
  static const NzCostTable t(kCoeffProbs);
  static const CostModel m{&kCoeffProbs, &t};
  return m;
}

inline int NzCost(const CostModel& cm, int plane, int band, int ctx, int a) {
  return a < 68 ? cm.nzc->c[plane][band][ctx][a]
                : TokenCostNonzero((*cm.probs)[plane][band][ctx], a);
}

// RD score of an already-quantised block under the default tables:
// 256 * transform-domain distortion + lambda * token bits (1/256 units).
// The B_PRED sub-mode search ranks candidate modes with this — the full
// rate/distortion of the residual each mode actually leaves, instead of
// the prediction-SSE proxy that ignores how the residual CODES.
// Exact token-tree bits (1/256-bit units) of an already-quantised block
// under the default tables, entry context ctx0. The real cost the
// magnitude-bucket RateProxy only approximated.
int TokenBits256(const CostModel& cm, const int16_t* lvl_nat, int first,
                 int plane, int ctx0) {
  const auto& PL = (*cm.probs)[plane];
  int last = -1;
  for (int i = first; i < 16; ++i)
    if (lvl_nat[kZigzag[i]]) last = i;
  if (last < first)  // all-zero: one EOB under the outer context
    return BitCost(0, PL[kBands[first]][ctx0][0]);
  int r = 0;
  int c = ctx0;
  bool eobflag = true;  // EOB is chargeable except right after a zero token
  for (int i = first; i <= last; ++i) {
    const int band = kBands[i];
    const int l = std::abs(lvl_nat[kZigzag[i]]);
    const uint8_t* P = PL[band][c];
    if (eobflag) r += BitCost(1, P[0]);
    r += l == 0 ? BitCost(0, P[1]) : NzCost(cm, plane, band, c, l);
    eobflag = l != 0;
    c = l == 0 ? 0 : (l > 1 ? 2 : 1);
  }
  if (last < 15) r += BitCost(0, PL[kBands[last + 1]][c][0]);
  return r;
}

int64_t QuantizedBlockScore(const CostModel& cm, const int16_t* coef_nat,
                            const int16_t* lvl_nat, int plane, int first,
                            int ctx0, int qdc, int qac, int64_t lambda) {
  int64_t d = 0;
  for (int i = first; i < 16; ++i) {
    const int zi = kZigzag[i];
    const int64_t e =
        coef_nat[zi] -
        static_cast<int64_t>(lvl_nat[zi]) * (i == 0 ? qdc : qac);
    d += e * e;
  }
  return 256 * d + lambda * TokenBits256(cm, lvl_nat, first, plane, ctx0);
}

// RD-quantise one block. coef_nat: transform output, natural order.
// Writes zigzag positions [first, 16) of out_nat (natural order); the
// caller owns positions < first. Returns true iff any level is nonzero.
bool TrellisQuantBlock(const CostModel& cm, const int16_t* coef_nat,
                       int plane, int first, int ctx0, int qdc, int qac,
                       int64_t lambda, int16_t* out_nat) {
  int za[16];      // |coefficient| in zigzag order
  bool zneg[16];
  int q[16];
  int64_t sufd[17];  // suffix distortion of zeroing positions [i, 16)
  sufd[16] = 0;
  int nmax = first - 1;  // last position whose nearest level is nonzero
  for (int i = 15; i >= first; --i) {
    const int v = coef_nat[kZigzag[i]];
    za[i] = v < 0 ? -v : v;
    zneg[i] = v < 0;
    q[i] = (i == 0) ? qdc : qac;
    sufd[i] = sufd[i + 1] + static_cast<int64_t>(za[i]) * za[i];
    if (nmax < i && 2 * za[i] >= q[i]) nmax = i;
  }
  if (nmax < first) {  // nearest level is 0 everywhere: all-zero is forced
    for (int i = first; i < 16; ++i) out_nat[kZigzag[i]] = 0;
    return false;
  }

  const auto& PL = (*cm.probs)[plane];
  constexpr int64_t kInf = INT64_MAX / 4;
  int64_t dp[3] = {kInf, kInf, kInf};
  int16_t bt_l[16][3];  // chosen magnitude per (position, out-context)
  int8_t bt_c[16][3];   // predecessor context
  int64_t best_end = kInf;
  int end_i = -1, end_c = 0;

  // positions past nmax only offer zero candidates, and a path that codes
  // zeros there can never terminate later — never optimal, so stop at nmax
  for (int i = first; i <= nmax; ++i) {
    const int band = kBands[i];
    const int a = za[i];
    const int qq = q[i];
    int lh = (2 * a + qq) / (2 * qq);  // nearest level
    if (lh > 2047) lh = 2047;
    int cands[3];
    int nc = 0;
    cands[nc++] = lh;
    if (lh > 0) cands[nc++] = lh - 1;
    // zeroing a level >= 3 is never RD-optimal at these lambdas; skipping
    // the explicit 0 candidate there saves a third of the DP work
    if (lh == 2) cands[nc++] = 0;
    int64_t ndp[3] = {kInf, kInf, kInf};
    int16_t nl[3] = {0, 0, 0};
    int8_t npc[3] = {0, 0, 0};
    for (int s = (i == first ? -1 : 0); s < (i == first ? 0 : 3); ++s) {
      int64_t base;
      int cin;
      bool eobflag;
      if (s < 0) {  // virtual initial state: outer context, EOB chargeable
        base = 0;
        cin = ctx0;
        eobflag = true;
      } else {
        base = dp[s];
        if (base >= kInf) continue;
        cin = s;
        eobflag = (s != 0);  // a zero token is never followed by EOB
      }
      const uint8_t* P = PL[band][cin];
      const int64_t flag_r = eobflag ? BitCost(1, P[0]) : 0;
      for (int k = 0; k < nc; ++k) {
        const int l = cands[k];
        const int64_t e = a - static_cast<int64_t>(l) * qq;
        const int64_t r =
            flag_r +
            (l == 0 ? BitCost(0, P[1]) : NzCost(cm, plane, band, cin, l));
        const int64_t sc = base + 256 * e * e + lambda * r;
        const int cout = (l == 0) ? 0 : (l > 1 ? 2 : 1);
        if (sc < ndp[cout]) {
          ndp[cout] = sc;
          nl[cout] = static_cast<int16_t>(l);
          npc[cout] = static_cast<int8_t>(s);
        }
      }
    }
    for (int c = 0; c < 3; ++c) {
      dp[c] = ndp[c];
      bt_l[i][c] = nl[c];
      bt_c[i][c] = npc[c];
      if (c > 0 && ndp[c] < kInf) {  // block may end here (last token nonzero)
        int64_t es = ndp[c] + 256 * sufd[i + 1];
        if (i < 15) es += lambda * BitCost(0, PL[kBands[i + 1]][c][0]);
        if (es < best_end) {
          best_end = es;
          end_i = i;
          end_c = c;
        }
      }
    }
  }

  // all-zero block: a single EOB under the outer context
  const int64_t zero_score =
      256 * sufd[first] + lambda * BitCost(0, PL[kBands[first]][ctx0][0]);
  if (zero_score <= best_end) {
    for (int i = first; i < 16; ++i) out_nat[kZigzag[i]] = 0;
    return false;
  }

  for (int i = 15; i > end_i; --i) out_nat[kZigzag[i]] = 0;
  int c = end_c;
  for (int i = end_i; i >= first; --i) {
    const int l = bt_l[i][c];
    out_nat[kZigzag[i]] = static_cast<int16_t>(zneg[i] ? -l : l);
    c = bt_c[i][c];
  }
  return true;
}

// Trellis strength: lambda = K% of q_ac^2 per bit. K=0 disables. The env
// knob IMAGEKIT_VP8_TRELLIS_K forces one K at every quality; unset/"auto"
// selects per quantiser (see TrellisKFor). -1 = auto sentinel.
int TrellisKEnv() {
  static const int k = [] {
    const char* e = getenv("IMAGEKIT_VP8_TRELLIS_K");
    if (!e || !*e || strcmp(e, "auto") == 0) return -1;
    return atoi(e);
  }();
  return k;
}

// Auto policy, calibrated against libwebp on photo/text/noise corpora
// (tools/calibrate_trellis.py): at high quality (qindex <= 15, q >= ~85)
// K=15 closes the round-2 size gap — measured 0.18-0.81x libwebp's bytes
// at -0.2..-0.8 dB, far above libwebp's RD curve (matching our size costs
// libwebp several dB). Everywhere else it stays OFF: at low quality the
// PSNR cost is image-dependent and can exceed 1 dB (distortion scales q²
// while λ∝q² overweights rate on detailed content), and the serving
// default q80 is the throughput-critical path where trellis would trade
// 0.3+ dB and ~27% encode CPU against the "q means libwebp-q quality"
// contract.
int TrellisKFor(int qindex, double mean_alpha, double flat_frac) {
  const int k = TrellisKEnv();
  if (k >= 0) return k;
  if (qindex <= 15) {
    // High-quality band, content-graded (tools/calibrate_segments.py):
    // - bimodal busy+flat content (text class: mean activity high AND
    //   >=15% flat 4x4 blocks): K=0 — near-lossless trellis
    //   misallocates across hard edges (0.942x/+0.18 dB vs
    //   0.958x/-0.73 dB at K=15);
    // - smooth gradients (mean < 15.5): K=7 — K=15 lands BELOW
    //   libwebp's RD curve there (0.726x at -1.72 dB ~= -0.17 dB at
    //   equal size) while K=7 sits above it (0.806x at -0.73 dB ~=
    //   +0.4 dB at equal size);
    // - busy unimodal content (detail/noise): K=15, the round-2 value.
    if (mean_alpha >= 15.5 && flat_frac >= 0.15) return 0;
    if (mean_alpha < 15.5) return 7;
    return 15;
  }
  // Mid-band (q <= ~65): K=5 on BUSY content only — measured 0.86-0.99x
  // libwebp at <=0.03 dB cost on detail/text/noise, while smooth
  // gradients (mean alpha < ~15) lose 0.5-1.8 dB to any mid-q trellis
  // and stay on the deadzone quantiser. q80 (qindex ~20-29), the
  // throughput-critical serving default, keeps the non-trellis path.
  if (qindex >= 30 && mean_alpha >= 15.5) return 5;
  return 0;
}

// Two-pass probability-coupled RD (IMAGEKIT_VP8_TWO_PASS): -1 = auto
// (on whenever the adaptive trellis is active — the bands where level
// choice is rate-sensitive and encode time already trades against size),
// 0 = off, 1 = force on at every quality. When on, the analysis loop runs
// twice: once under the default tables, then again with every rate
// estimate (trellis levels, B_PRED sub-mode RD) re-costed under the
// tables fitted to the first pass's token statistics, so the choices and
// the §13.4 header probabilities agree. Auto never fires at the pinned
// serving default q80 (TrellisKFor returns 0 there).
int TwoPassEnv() {
  static const int v = [] {
    const char* e = getenv("IMAGEKIT_VP8_TWO_PASS");
    if (!e || !*e || strcmp(e, "auto") == 0) return -1;
    return atoi(e);
  }();
  return v;
}
// Max fitted-cost re-analysis passes (0 = single pass, classic). The loop
// also exits early once the stop-now size estimate improves <0.1%/pass.
// Auto: only where the adaptive trellis is on (level choice is
// rate-sensitive there and encode time already trades against size) —
// cap 6 in the high band (quality-critical, converges slowest on
// noise-like content: measured ~0.3-0.5%/pass through pass 6), cap 3 in
// the mid band (gains plateau by pass 3; bounds the per-request CPU at
// user-chosen mid quality). ~+10-12 ms per pass per 77 kpix frame.
int TwoPassFor(int trellis_k, int qindex) {
  const int v = TwoPassEnv();
  if (v >= 0) return v;
  if (trellis_k <= 0) return 0;
  return qindex <= 15 ? 6 : 3;
}

// Loop-filter strength: level = qindex * scale >> 6. The default tracks
// libwebp's strength heuristic on the parity corpora
// (tools/calibrate_segments.py sweep); IMAGEKIT_VP8_FILTER_SCALE
// overrides for calibration runs. Deblocking is decoder-side only for a
// still (in-frame intra prediction reads UNFILTERED reconstruction), so
// the level costs the encoder nothing.
int FilterScaleEnv() {
  static const int s = [] {
    const char* e = getenv("IMAGEKIT_VP8_FILTER_SCALE");
    if (!e || !*e) return 48;
    return atoi(e);
  }();
  return s;
}

// ---------------------------------------------------------------------------
// Segmentation (adaptive quantisation) — RFC 6386 §9.3/§10. The analogue
// of libwebp's SNS segments: per-MB activity drives up to 4 segments with
// ABSOLUTE per-segment quantisers spread around the frame quantiser, so
// bits migrate between flat and busy regions instead of one q fitting
// nobody (libwebp enables this by default; round-2 parity cells that
// trailed it — text/detail — were exactly the bimodal-content ones).
// ---------------------------------------------------------------------------
struct SegPlan {
  int count = 1;  // 1 = segmentation off
  uint8_t tree_probs[3] = {255, 255, 255};
  int qi[4] = {0, 0, 0, 0};  // absolute qindex per segment
  std::vector<uint8_t> map;  // per-MB segment id (raster), empty when off
  double mean_alpha = 0.0;   // mean per-MB log2 activity (content class
                             // for the adaptive trellis policy)
  double flat_frac = 0.0;    // fraction of essentially-flat 4x4 luma
                             // blocks (bimodal-content detector: text has
                             // BOTH flat gaps and busy strokes)
};

// Amplitude in percent of qindex across the activity spread; sign picks
// the direction (positive = busier MBs coarser, the masking direction).
// INT32_MIN = auto policy (calibrated, tools/calibrate_segments.py).
int SegAmpEnv() {
  static const int a = [] {
    const char* e = getenv("IMAGEKIT_VP8_SEG_AMP");
    if (!e || !*e || strcmp(e, "auto") == 0) return INT32_MIN;
    return atoi(e);
  }();
  return a;
}

#ifndef IK_VP8_LAMBDA_NUM_DEFAULT
#define IK_VP8_LAMBDA_NUM_DEFAULT 4
#endif
// Mode-decision calibration knobs (defaults = the shipped policy; env
// overrides exist for tools/calibrate_segments.py sweeps only).
int LambdaNumEnv() {
  static const int v = [] {
    const char* e = getenv("IMAGEKIT_VP8_LAMBDA_NUM");
    return e && *e ? atoi(e) : IK_VP8_LAMBDA_NUM_DEFAULT;
  }();
  return v;
}
int I4GateEnv() {
  static const int v = [] {
    const char* e = getenv("IMAGEKIT_VP8_I4_GATE");
    return e && *e ? atoi(e) : 20;
  }();
  return v;
}
int ModeRdMultEnv() {  // sub-mode RD lambda in 1/16ths of the frame lambda
  static const int v = [] {
    const char* e = getenv("IMAGEKIT_VP8_MODE_RD_MULT");
    return e && *e ? atoi(e) : 4;
  }();
  return v;
}
int I4RdModesEnv() {  // B_PRED sub-modes given the full RD treatment
  // The 10-mode full-RD rank (fdct+quantise+token-cost each) is ~80%
  // of whole-frame encode time on busy content (gprof, round 4). A
  // prediction-SSE + mode-bits pre-rank prunes the candidates.
  // 0 (default) = ADAPTIVE: full-RD every mode whose pre-rank is
  // within I4RdSpanEnv()/64 of the best — near-ties (directional
  // ambiguity, text) keep a near-exhaustive search, cleanly-separated
  // content (photo, noise) prunes hard. N = fixed top-N; >=10 =
  // exhaustive (bit-identical to rounds 1-3). Calibration:
  // docs/PARITY_REPORT.md "B_PRED shortlist".
  static const int v = [] {
    const char* e = getenv("IMAGEKIT_VP8_I4_RD_MODES");
    if (!e || !*e) return 0;
    const int n = atoi(e);
    return n < 0 ? 0 : n;
  }();
  return v;
}
int I4RdSpanEnv() {  // adaptive shortlist span, 64ths of the best rank
  static const int v = [] {
    const char* e = getenv("IMAGEKIT_VP8_I4_RD_SPAN");
    const int n = e && *e ? atoi(e) : 192;  // 3.0x — calibrated round 4
    return n < 64 ? 64 : n;
  }();
  return v;
}
int I4BiasPctEnv() {  // near-lossless I16-rate inflation, percent
  static const int v = [] {
    const char* e = getenv("IMAGEKIT_VP8_I4_BIAS_PCT");
    return e && *e ? atoi(e) : -1;  // -1 = auto policy
  }();
  return v;
}

SegPlan AnalyzeSegments(const uint8_t* sy, int W, int mbw, int mbh,
                        int qindex) {
  SegPlan plan;
  for (int i = 0; i < 4; ++i) plan.qi[i] = qindex;
  const int env = SegAmpEnv();
  // Auto policy: OFF — a calibrated negative, closed in two rounds.
  // Round 3: no PSNR-at-size win on the parity corpora, whose "text"
  // is bimodal WITHIN macroblocks (a per-MB map cannot help). Round 4
  // (VERDICT r3 #6): an MB-SCALE bimodal corpus (page/magazine/chart/
  // screenshot mixes of whole-region flat vs busy) swept amp -60..60
  // at q30-50 against the encoder's own amp=0 RD ladder — chart, the
  // textbook case, is NEGATIVE at every amplitude (map bits with no
  // quality to buy: flat regions are already near-free) and the only
  // large positive cells appear at BOTH amp signs, i.e. RD-curve
  // interpolation artifacts, not segmentation wins
  // (tools/calibrate_segments.py --sweep seg_mixed,
  // docs/PARITY_REPORT.md "VP8 segmentation" section). The feature is
  // complete and decoder-validated (tests force it on via
  // IMAGEKIT_VP8_SEG_AMP) and the per-MB activity analysis below feeds
  // the content-adaptive trellis policy either way.
  const int amp = env == INT32_MIN ? 0 : env;

  const int n = mbw * mbh;
  std::vector<float> alpha(static_cast<size_t>(n));
  float amin = 1e30f, amax = -1e30f;
  double asum = 0.0;
  int64_t flat_subblocks = 0;
  for (int my = 0; my < mbh; ++my)
    for (int mx = 0; mx < mbw; ++mx) {
      // activity = sum of 4x4 luma variances (x16): cheap, monotone in
      // the AC energy the quantiser actually meets
      int64_t act = 0;
      const uint8_t* mb = sy + static_cast<size_t>(my) * 16 * W + mx * 16;
      for (int sb = 0; sb < 16; ++sb) {
        const uint8_t* p = mb + (sb >> 2) * 4 * W + (sb & 3) * 4;
        int s = 0, s2 = 0;
        for (int y = 0; y < 4; ++y)
          for (int x = 0; x < 4; ++x) {
            const int v = p[y * W + x];
            s += v;
            s2 += v * v;
          }
        const int var16 = 16 * s2 - s * s;
        act += var16;
        if (var16 < 16 * 16) flat_subblocks += 1;
      }
      const float a = std::log2f(1.0f + static_cast<float>(act));
      alpha[static_cast<size_t>(my) * mbw + mx] = a;
      asum += a;
      amin = a < amin ? a : amin;
      amax = a > amax ? a : amax;
    }
  plan.mean_alpha = asum / n;
  plan.flat_frac = static_cast<double>(flat_subblocks) / (16.0 * n);
  if (amp == 0) return plan;
  if (amax - amin < 3.0f) return plan;  // unimodal: uniform q fits

  // 1-D k-means, 4 centers seeded evenly across the observed range
  float c[4];
  for (int i = 0; i < 4; ++i)
    c[i] = amin + (amax - amin) * (2 * i + 1) / 8.0f;
  std::vector<uint8_t> assign(static_cast<size_t>(n));
  for (int it = 0; it < 8; ++it) {
    double sum[4] = {0, 0, 0, 0};
    int cnt[4] = {0, 0, 0, 0};
    for (int i = 0; i < n; ++i) {
      int best = 0;
      float bd = 1e30f;
      for (int s = 0; s < 4; ++s) {
        const float d = alpha[i] - c[s];
        const float dd = d * d;
        if (dd < bd) {
          bd = dd;
          best = s;
        }
      }
      assign[i] = static_cast<uint8_t>(best);
      sum[best] += alpha[i];
      ++cnt[best];
    }
    for (int s = 0; s < 4; ++s)
      if (cnt[s]) c[s] = static_cast<float>(sum[s] / cnt[s]);
  }

  // per-segment qindex: spread around the BIT-weighted centre (weight =
  // alpha, a proxy for each segment's share of the bitstream) so the
  // total rate stays roughly constant as q shifts between segments
  double wsum = 0, wtot = 0;
  int cnt[4] = {0, 0, 0, 0};
  for (int i = 0; i < n; ++i) {
    wsum += static_cast<double>(alpha[i]) * alpha[i];
    wtot += alpha[i];
    ++cnt[assign[i]];
  }
  const double centre = wtot > 0 ? wsum / wtot : 0.5 * (amin + amax);
  const double halfspan =
      std::max(centre - amin, static_cast<double>(amax) - centre) + 1e-6;
  bool distinct = false;
  for (int s = 0; s < 4; ++s) {
    const double t = (c[s] - centre) / halfspan;  // [-1, 1]
    int qi = qindex +
             static_cast<int>(std::lround(amp / 100.0 * qindex * t));
    if (qi < 1) qi = 1;
    plan.qi[s] = ClampQ(qi);
    if (plan.qi[s] != qindex) distinct = true;
  }
  if (!distinct) return plan;

  // segment-map tree probabilities from the histogram (GetBit(p) takes
  // the 0-branch with probability p/256; clamp to the coder's 1..255)
  auto prob = [](int zero, int total) {
    if (total == 0) return 255;
    int p = (255 * zero + total / 2) / total;
    return p < 1 ? 1 : (p > 255 ? 255 : p);
  };
  plan.tree_probs[0] = static_cast<uint8_t>(prob(cnt[0] + cnt[1], n));
  plan.tree_probs[1] =
      static_cast<uint8_t>(prob(cnt[0], cnt[0] + cnt[1]));
  plan.tree_probs[2] =
      static_cast<uint8_t>(prob(cnt[2], cnt[2] + cnt[3]));
  plan.count = 4;
  plan.map = std::move(assign);
  return plan;
}

// ---------------------------------------------------------------------------
// Per-macroblock data produced by the analysis/reconstruction pass.
// ---------------------------------------------------------------------------
struct MbData {
  uint8_t ymode;   // 0=DC 1=V 2=H 3=TM, 4=B_PRED
  uint8_t uvmode;  // 0..3
  uint8_t skip;    // every coded block quantised to zero
  uint8_t segment; // adaptive-quantisation segment id (0 when seg off)
  uint8_t bmodes[16];  // B_PRED sub-modes (I16: mapped equivalents)
  // Quantised levels in ZIGZAG order with the last-nonzero index cached:
  // the token loop walks each block twice (stats + write), so the
  // natural->zigzag gather and trailing-zero scan happen once, in pass 1.
  int16_t y2[16];      // WHT coefficients (I16 only)
  int16_t y[16][16];   // I16: AC only (index 0 zero); B_PRED: full
  int16_t uv[8][16];   // 4 U then 4 V blocks
  int8_t y2_n;         // last nonzero zigzag index, -1 if none
  int8_t y_n[16];
  int8_t uv_n[8];
};

// Gather natural-order levels into zigzag order; returns the last nonzero
// zigzag index (-1/first-1 if none). Positions < first are zeroed.
inline int ToZigzag(const int16_t* nat, int first, int16_t* zz) {
  int n = -1;
  for (int i = 0; i < first; ++i) zz[i] = 0;
  for (int i = first; i < 16; ++i) {
    zz[i] = nat[kZigzag[i]];
    if (zz[i]) n = i;
  }
  return n;
}

int64_t SseRegion(const uint8_t* a, int as, const uint8_t* b, int bs,
                  int size) {
  int64_t sse = 0;
  for (int y = 0; y < size; ++y)
    for (int x = 0; x < size; ++x) {
      const int d = a[y * as + x] - b[y * bs + x];
      sse += d * d;
    }
  return sse;
}

// ---------------------------------------------------------------------------
// SIMD mode-search helpers (ROADMAP #3). The scalar predictors in
// vp8_common.h remain the single source of truth for RECONSTRUCTION; these
// only rank candidate modes by SSE, computing each prediction on the fly in
// registers (exact integer semantics, so the chosen mode is identical to
// the scalar search). Scalar fallbacks keep non-AVX2 builds working.
// ---------------------------------------------------------------------------
#ifdef IK_VP8_SIMD
inline int HSum256(__m256i v) {  // 8 x int32 -> int
  __m128i s = _mm_add_epi32(_mm256_castsi256_si128(v),
                            _mm256_extracti128_si256(v, 1));
  s = _mm_add_epi32(s, _mm_srli_si128(s, 8));
  s = _mm_add_epi32(s, _mm_srli_si128(s, 4));
  return _mm_cvtsi128_si32(s);
}

inline int HSum128(__m128i s) {  // 4 x int32 -> int
  s = _mm_add_epi32(s, _mm_srli_si128(s, 8));
  s = _mm_add_epi32(s, _mm_srli_si128(s, 4));
  return _mm_cvtsi128_si32(s);
}
#endif

// SSE between two contiguous 4x4 blocks (16 bytes each).
inline int Sse4x4Packed(const uint8_t* a, const uint8_t* b) {
#ifdef IK_VP8_SIMD
  const __m256i da =
      _mm256_cvtepu8_epi16(_mm_loadu_si128(reinterpret_cast<const __m128i*>(a)));
  const __m256i db =
      _mm256_cvtepu8_epi16(_mm_loadu_si128(reinterpret_cast<const __m128i*>(b)));
  const __m256i d = _mm256_sub_epi16(da, db);
  return HSum256(_mm256_madd_epi16(d, d));
#else
  int sse = 0;
  for (int i = 0; i < 16; ++i) {
    const int d = a[i] - b[i];
    sse += d * d;
  }
  return sse;
#endif
}

// SSE of each of the four whole-block prediction modes (DC/V/H/TM, the
// PredictI16OrChroma set with identical border semantics) against the
// source region, without materialising the predictions. `plane` carries the
// reconstruction borders; its interior at (px,py) is scratch the caller is
// about to overwrite anyway (the scalar fallback predicts into it).
void PredSse4Modes(const uint8_t* src, int ss, uint8_t* plane, int stride,
                   int px, int py, int size, bool have_above, bool have_left,
                   int64_t sse[4]) {
  const uint8_t* above = plane + (py - 1) * stride + px;
  const uint8_t* leftp = plane + py * stride + px - 1;
  const int al = above[-1];
  int dc;
  if (have_above || have_left) {
    int sum = 0;
    const int shift =
        (size == 16 ? 4 : 3) + ((have_above && have_left) ? 1 : 0);
    if (have_above)
      for (int i = 0; i < size; ++i) sum += above[i];
    if (have_left)
      for (int i = 0; i < size; ++i) sum += leftp[i * stride];
    dc = (sum + (1 << (shift - 1))) >> shift;
  } else {
    dc = 128;
  }
#ifdef IK_VP8_SIMD
  if (size == 16) {
    const __m256i vA = _mm256_cvtepu8_epi16(
        _mm_loadu_si128(reinterpret_cast<const __m128i*>(above)));
    const __m256i vDC = _mm256_set1_epi16(static_cast<short>(dc));
    const __m256i vZero = _mm256_setzero_si256();
    const __m256i v255 = _mm256_set1_epi16(255);
    __m256i aDC = vZero, aV = vZero, aH = vZero, aTM = vZero;
    for (int y = 0; y < 16; ++y) {
      const __m256i s = _mm256_cvtepu8_epi16(
          _mm_loadu_si128(reinterpret_cast<const __m128i*>(src + y * ss)));
      const int l = leftp[y * stride];
      const __m256i vL = _mm256_set1_epi16(static_cast<short>(l));
      __m256i d = _mm256_sub_epi16(s, vDC);
      aDC = _mm256_add_epi32(aDC, _mm256_madd_epi16(d, d));
      d = _mm256_sub_epi16(s, vA);
      aV = _mm256_add_epi32(aV, _mm256_madd_epi16(d, d));
      d = _mm256_sub_epi16(s, vL);
      aH = _mm256_add_epi32(aH, _mm256_madd_epi16(d, d));
      __m256i p = _mm256_add_epi16(vA, _mm256_set1_epi16(static_cast<short>(l - al)));
      p = _mm256_min_epi16(_mm256_max_epi16(p, vZero), v255);
      d = _mm256_sub_epi16(s, p);
      aTM = _mm256_add_epi32(aTM, _mm256_madd_epi16(d, d));
    }
    sse[0] = HSum256(aDC);
    sse[1] = HSum256(aV);
    sse[2] = HSum256(aH);
    sse[3] = HSum256(aTM);
    return;
  }
  if (size == 8) {
    const __m128i vA = _mm_cvtepu8_epi16(
        _mm_loadl_epi64(reinterpret_cast<const __m128i*>(above)));
    const __m128i vDC = _mm_set1_epi16(static_cast<short>(dc));
    const __m128i vZero = _mm_setzero_si128();
    const __m128i v255 = _mm_set1_epi16(255);
    __m128i aDC = vZero, aV = vZero, aH = vZero, aTM = vZero;
    for (int y = 0; y < 8; ++y) {
      const __m128i s = _mm_cvtepu8_epi16(
          _mm_loadl_epi64(reinterpret_cast<const __m128i*>(src + y * ss)));
      const int l = leftp[y * stride];
      const __m128i vL = _mm_set1_epi16(static_cast<short>(l));
      __m128i d = _mm_sub_epi16(s, vDC);
      aDC = _mm_add_epi32(aDC, _mm_madd_epi16(d, d));
      d = _mm_sub_epi16(s, vA);
      aV = _mm_add_epi32(aV, _mm_madd_epi16(d, d));
      d = _mm_sub_epi16(s, vL);
      aH = _mm_add_epi32(aH, _mm_madd_epi16(d, d));
      __m128i p = _mm_add_epi16(vA, _mm_set1_epi16(static_cast<short>(l - al)));
      p = _mm_min_epi16(_mm_max_epi16(p, vZero), v255);
      d = _mm_sub_epi16(s, p);
      aTM = _mm_add_epi32(aTM, _mm_madd_epi16(d, d));
    }
    sse[0] = HSum128(aDC);
    sse[1] = HSum128(aV);
    sse[2] = HSum128(aH);
    sse[3] = HSum128(aTM);
    return;
  }
#endif
  // scalar fallback: materialise each mode into the plane interior (the
  // caller re-predicts the winner immediately, as the pre-SIMD code did)
  for (int m = 0; m < 4; ++m) {
    ikvp8::PredictI16OrChroma(plane, stride, px, py, size, m, have_above,
                              have_left);
    sse[m] = SseRegion(src, ss, plane + py * stride + px, stride, size);
  }
}

// token-rate proxy in bits-ish units over QUANTISED levels (RD decisions)
inline int RateProxy(const int16_t* lvl, int first) {
  int r = 1;  // EOB
  for (int i = first; i < 16; ++i) {
    int a = lvl[i] < 0 ? -lvl[i] : lvl[i];
    if (!a) continue;
    r += 3 + (a > 1 ? 2 : 0) + (a > 4 ? 3 : 0) + (a > 10 ? 3 : 0);
  }
  return r;
}

// ---------------------------------------------------------------------------
// Token coding, abstracted over a sink so one tree walk serves both the
// statistics pass (tally branch decisions per probability slot) and the
// bitstream pass (write with the frame's adapted tables). Per-frame
// coefficient probability updates are RFC 6386 §13.4: at high quality the
// defaults are far off and adapting them is where libwebp's size edge was.
// ---------------------------------------------------------------------------
struct TokenStats {
  uint32_t cnt[4][8][3][11][2] = {};
};

struct WriteSink {
  BoolEnc& e;
  const CoeffProbs& probs;
  inline void Node(int bit, int plane, int band, int c, int node) {
    e.PutBit(bit, probs[plane][band][c][node]);
  }
  inline void Fixed(int bit, uint8_t prob) { e.PutBit(bit, prob); }
};

struct StatSink {
  TokenStats& s;
  inline void Node(int bit, int plane, int band, int c, int node) {
    ++s.cnt[plane][band][c][node][bit];
  }
  inline void Fixed(int, uint8_t) {}
};

// plane types: 0 = Y after Y2 (first coeff 1), 1 = Y2, 2 = chroma, 3 = B_PRED Y
// zz: levels in zigzag order; n: last nonzero zigzag index (< first if none)
template <class Sink>
void CodeBlock(Sink& sk, const int16_t* zz, int n, int plane, int first,
               int ctx) {
  int i = first;
  bool prev_zero = false;
  int c = ctx;
  while (i <= n) {
    const int v = zz[i];
    const int a = v < 0 ? -v : v;
    const int band = kBands[i];
    if (!prev_zero) sk.Node(1, plane, band, c, 0);  // not EOB
    if (a == 0) {
      sk.Node(0, plane, band, c, 1);
      prev_zero = true;
      c = 0;
      ++i;
      continue;
    }
    sk.Node(1, plane, band, c, 1);
    if (a == 1) {
      sk.Node(0, plane, band, c, 2);
    } else {
      sk.Node(1, plane, band, c, 2);
      if (a <= 4) {
        sk.Node(0, plane, band, c, 3);
        if (a == 2) {
          sk.Node(0, plane, band, c, 4);
        } else {
          sk.Node(1, plane, band, c, 4);
          sk.Node(a == 4 ? 1 : 0, plane, band, c, 5);
        }
      } else {
        sk.Node(1, plane, band, c, 3);
        int cat;
        if (a <= 10) {
          sk.Node(0, plane, band, c, 6);
          cat = (a <= 6) ? 0 : 1;
          sk.Node(cat, plane, band, c, 7);
        } else {
          sk.Node(1, plane, band, c, 6);
          if (a <= 34) {
            sk.Node(0, plane, band, c, 8);
            cat = (a <= 18) ? 2 : 3;
            sk.Node(cat == 3 ? 1 : 0, plane, band, c, 9);
          } else {
            sk.Node(1, plane, band, c, 8);
            cat = (a <= 66) ? 4 : 5;
            sk.Node(cat == 5 ? 1 : 0, plane, band, c, 10);
          }
        }
        const Cat& cc = kCats[cat];
        const int rem = a - cc.base;
        for (int b = cc.bits - 1; b >= 0; --b)
          sk.Fixed((rem >> b) & 1, cc.probs[cc.bits - 1 - b]);
      }
    }
    sk.Fixed(v < 0 ? 1 : 0, 128);  // sign
    prev_zero = false;
    c = (a > 1) ? 2 : 1;
    ++i;
  }
  if (n < 15) {
    // EOB is legal here: the token at position n (if any) was nonzero
    const int pos = (n < first) ? first : n + 1;
    sk.Node(0, plane, kBands[pos], c, 0);
  }
}

// One macroblock's token coding (replicates the decoder's nonzero-context
// tracking). Shared by the statistics tally (interleaved into pass 1, which
// visits MBs in the same raster order as the bitstream) and the write pass.
// ay/au/av/ay2: above-context rows (per MB column); ly/lu/lv/ly2: left
// contexts, reset by the caller at each MB row start.
template <class Sink>
inline void TokenizeMb(Sink& sink, const MbData& mb, int mbx, uint8_t* ay,
                       uint8_t* au, uint8_t* av, uint8_t* ay2, uint8_t* ly,
                       uint8_t* lu, uint8_t* lv, uint8_t& ly2) {
  const bool bpred = mb.ymode == 4;
  if (mb.skip) {
    for (int i = 0; i < 4; ++i) ay[mbx * 4 + i] = ly[i] = 0;
    for (int i = 0; i < 2; ++i) {
      au[mbx * 2 + i] = lu[i] = 0;
      av[mbx * 2 + i] = lv[i] = 0;
    }
    if (!bpred) ay2[mbx] = ly2 = 0;
    return;
  }
  if (!bpred) {
    CodeBlock(sink, mb.y2, mb.y2_n, 1, 0, ay2[mbx] + ly2);
    const uint8_t nz = mb.y2_n >= 0 ? 1 : 0;
    ay2[mbx] = ly2 = nz;
  }
  const int plane = bpred ? 3 : 0;
  const int first = bpred ? 0 : 1;
  for (int sb = 0; sb < 16; ++sb) {
    const int sx = sb & 3, sy_ = sb >> 2;
    CodeBlock(sink, mb.y[sb], mb.y_n[sb], plane, first,
              ay[mbx * 4 + sx] + ly[sy_]);
    const uint8_t nz = mb.y_n[sb] >= first ? 1 : 0;
    ay[mbx * 4 + sx] = nz;
    ly[sy_] = nz;
  }
  for (int pl = 0; pl < 2; ++pl) {
    uint8_t* ac = pl ? av : au;
    uint8_t* lc = pl ? lv : lu;
    for (int sb = 0; sb < 4; ++sb) {
      const int sx = sb & 1, sy_ = sb >> 1;
      CodeBlock(sink, mb.uv[pl * 4 + sb], mb.uv_n[pl * 4 + sb], 2, 0,
                ac[mbx * 2 + sx] + lc[sy_]);
      const uint8_t nz = mb.uv_n[pl * 4 + sb] >= 0 ? 1 : 0;
      ac[mbx * 2 + sx] = nz;
      lc[sy_] = nz;
    }
  }
}

// Pick per-slot probability updates that pay for their own signalling
// (flag bit under kCoeffUpdateProbs + 8-bit literal).
void AdaptCoeffProbs(const TokenStats& st, CoeffProbs& probs,
                     bool updated[4][8][3][11]) {
  std::memcpy(probs, kCoeffProbs, sizeof(CoeffProbs));
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int n = 0; n < 11; ++n) {
          updated[t][b][c][n] = false;
          const uint32_t c0 = st.cnt[t][b][c][n][0];
          const uint32_t c1 = st.cnt[t][b][c][n][1];
          if (c0 + c1 == 0) continue;
          const int oldp = kCoeffProbs[t][b][c][n];
          int newp = static_cast<int>(
              (255ull * c0 + (c0 + c1) / 2) / (c0 + c1));
          if (newp < 1) newp = 1;
          if (newp > 255) newp = 255;
          if (newp == oldp) continue;
          const int64_t save =
              static_cast<int64_t>(c0) * (BitCost(0, oldp) - BitCost(0, newp)) +
              static_cast<int64_t>(c1) * (BitCost(1, oldp) - BitCost(1, newp));
          const int up = kCoeffUpdateProbs[t][b][c][n];
          const int64_t signal =
              8 * 256 + BitCost(1, up) - BitCost(0, up);
          if (save > signal) {
            probs[t][b][c][n] = static_cast<uint8_t>(newp);
            updated[t][b][c][n] = true;
          }
        }
}

// Price the tallied token decisions under the tables AdaptCoeffProbs
// would signal for them (plus the 8-bit update literals): the stop-now
// partition-2 size estimate for an analysis pass. Used by the multi-pass
// RD loop to keep the best pass — comparable across passes because every
// pass's choices are priced under their own best achievable tables.
int64_t TokenBitsEstimate(const TokenStats& st) {
  CoeffProbs p;
  bool upd[4][8][3][11];
  AdaptCoeffProbs(st, p, upd);
  int64_t bits = 0;
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int n = 0; n < 11; ++n) {
          if (upd[t][b][c][n]) bits += 8 * 256;
          const uint32_t c0 = st.cnt[t][b][c][n][0];
          const uint32_t c1 = st.cnt[t][b][c][n][1];
          if (c0 + c1 == 0) continue;
          bits += static_cast<int64_t>(c0) * BitCost(0, p[t][b][c][n]) +
                  static_cast<int64_t>(c1) * BitCost(1, p[t][b][c][n]);
        }
  return bits;
}

}  // namespace

namespace {

// Encodes YUV 4:2:0 planes into a complete WebP (RIFF) file.
// flags bit0: force loop-filter level 0 (makes the internal reconstruction
// equal decoder output exactly — used by the round-trip exactness tests).
// recon_* (nullable): receive the padded reconstruction planes, strides
// mbw*16 / mbw*8.
int64_t EncodeImpl(const uint8_t* ysrc, const uint8_t* usrc,
                   const uint8_t* vsrc, int width, int height, int ystride,
                   int cstride, int quality, uint8_t* out, size_t out_cap,
                   int flags, uint8_t* recon_y, uint8_t* recon_u,
                   uint8_t* recon_v) {
  if (width <= 0 || height <= 0 || width > 16383 || height > 16383) return -5;
  const int mbw = (width + 15) / 16;
  const int mbh = (height + 15) / 16;
  const int W = mbw * 16, H = mbh * 16;
  const int CW = W / 2, CH = H / 2;
  const int cw = (width + 1) / 2, ch = (height + 1) / 2;

  // --- padded source planes (edge replication, libwebp convention) ---
  std::vector<uint8_t> sy(static_cast<size_t>(W) * H), su(static_cast<size_t>(CW) * CH),
      sv(static_cast<size_t>(CW) * CH);
  for (int y = 0; y < H; ++y) {
    const int yy = y < height ? y : height - 1;
    uint8_t* row = sy.data() + static_cast<size_t>(y) * W;
    std::memcpy(row, ysrc + static_cast<size_t>(yy) * ystride, width);
    std::memset(row + width, row[width - 1], W - width);
  }
  for (int y = 0; y < CH; ++y) {
    const int yy = y < ch ? y : ch - 1;
    uint8_t* ru = su.data() + static_cast<size_t>(y) * CW;
    uint8_t* rv = sv.data() + static_cast<size_t>(y) * CW;
    std::memcpy(ru, usrc + static_cast<size_t>(yy) * cstride, cw);
    std::memcpy(rv, vsrc + static_cast<size_t>(yy) * cstride, cw);
    std::memset(ru + cw, ru[cw - 1], CW - cw);
    std::memset(rv + cw, rv[cw - 1], CW - cw);
  }

  // --- reconstruction planes with decoder-identical prediction borders:
  // 1-px top row 127 (incl. corner), 1-px left col 129, and 4 extra luma
  // columns on the right for B_PRED "above-right" reads (replicated per MB
  // row exactly like the decoder) ---
  const int ls = 1 + W + 4;
  const int cs = 1 + CW;
  std::vector<uint8_t> ybuf(static_cast<size_t>(1 + H) * ls, 129);
  std::vector<uint8_t> ubuf(static_cast<size_t>(1 + CH) * cs, 129);
  std::vector<uint8_t> vbuf(static_cast<size_t>(1 + CH) * cs, 129);
  std::memset(ybuf.data(), 127, ls);
  std::memset(ubuf.data(), 127, cs);
  std::memset(vbuf.data(), 127, cs);
  uint8_t* RY = ybuf.data() + ls + 1;
  uint8_t* RU = ubuf.data() + cs + 1;
  uint8_t* RV = vbuf.data() + cs + 1;

  const int qindex = QualityToQIndex(quality);
// Chroma quantiser deltas (finer UV quantisation, like libwebp's
// uv_alpha-driven dq_uv): the measured PSNR gap vs libwebp was almost
// entirely chroma. Scaled with the quantiser so the byte cost stays
// proportional (a fixed -8 saturates chroma to qindex 0 at high
// quality). Signalled in the frame header (RFC 6386 §9.6).
  // Chroma quantiser deltas scale to 0 via IMAGEKIT_VP8_UV_DELTA_PCT
  // (calibration knob; 100 = shipped policy, 0 = no deltas)
  const int uvp = [] {
    static const int v = [] {
      const char* e = getenv("IMAGEKIT_VP8_UV_DELTA_PCT");
      return e && *e ? atoi(e) : 100;
    }();
    return v;
  }();
  const int uv_dc_delta = -(qindex >= 24 ? 8 : qindex / 3) * uvp / 100;
  const int uv_ac_delta = -(qindex >= 24 ? 4 : qindex / 6) * uvp / 100;
  int filter_level = (qindex * FilterScaleEnv()) >> 6;
  if (filter_level > 63) filter_level = 63;
  if (flags & 1) filter_level = 0;

  // --- segmentation (adaptive quantisation): per-MB activity -> up to 4
  // segments with absolute qindexes; per-segment quantisers/lambdas below
  const SegPlan seg = AnalyzeSegments(sy.data(), W, mbw, mbh, qindex);
  const int tk =
      (flags & 2) ? 0
                  : TrellisKFor(qindex, seg.mean_alpha, seg.flat_frac);
  Quantizers segQ[4];
  int64_t seg_lambda_y[4], seg_lambda_uv[4], seg_i4_gate[4];
  double seg_lambda_rd[4];
  int seg_lf[4];
  for (int s = 0; s < 4; ++s) {
    segQ[s] = ikvp8::SetupQuantDeltas(seg.qi[s], 0, 0, 0, uv_dc_delta,
                                      uv_ac_delta);
    // trellis lambdas (transform-domain distortion per bit; see
    // TrellisQuantBlock)
    seg_lambda_y[s] =
        tk > 0
            ? (static_cast<int64_t>(tk) * segQ[s].y1.ac * segQ[s].y1.ac) / 100
            : -1;
    seg_lambda_uv[s] =
        tk > 0
            ? (static_cast<int64_t>(tk) * segQ[s].uv.ac * segQ[s].uv.ac) / 100
            : -1;
    // RD lambda for the I16-vs-B_PRED decision, scaled with the quantiser
    // (distortion is SSE in pixel^2; rate proxy is bits-ish)
    seg_lambda_rd[s] = LambdaNumEnv() *
                       static_cast<double>(segQ[s].y1.ac) * segQ[s].y1.ac /
                       16.0;
    // only try B_PRED when I16 leaves real energy on the table
    seg_i4_gate[s] =
        static_cast<int64_t>(I4GateEnv()) * segQ[s].y1.ac * segQ[s].y1.ac;
    // with segmentation + abs feature data the decoder takes the per-MB
    // filter level FROM THE SEGMENT (vp8_decode.cpp:925), so each
    // segment must carry its own quantiser-scaled level
    seg_lf[s] = flags & 1 ? 0 : (seg.qi[s] * FilterScaleEnv()) >> 6;
    if (seg_lf[s] > 63) seg_lf[s] = 63;
  }

  std::vector<MbData> mbs(static_cast<size_t>(mbw) * mbh);

  // Token statistics are tallied inline at the end of each MB (pass 1
  // visits MBs in bitstream raster order, so the nonzero contexts below
  // are exactly the write pass's) — saves a whole second token walk.
  TokenStats stats;

  // ---------------- analysis pass: transform / reconstruct ----------------
  // Runs once under the default-table cost model; when two-pass RD is
  // active (TwoPassEnv), a second time with every rate estimate re-costed
  // under the tables fitted to the first run's statistics. Each run resets
  // the reconstruction borders, token statistics, and nonzero contexts to
  // frame-start state and fully overwrites `mbs`.
  //
  // lscale10: token-bit lambda scale in 1/1024ths. Fitted tables price the
  // same tokens in FEWER bits, so an unscaled lambda would drift the
  // operating point up the rate axis (measured: +2..7% size for ~0 dB on
  // smooth/detail). Scaling lambda by bits_default/bits_fitted over the
  // pass-1 stats keeps the RD slope fixed, so the second pass changes
  // RANKING (which coefficients/modes survive) rather than the rate target.
  auto run_analysis = [&](const CostModel& cm, int64_t lscale10) {
  std::fill(ybuf.begin(), ybuf.end(), static_cast<uint8_t>(129));
  std::fill(ubuf.begin(), ubuf.end(), static_cast<uint8_t>(129));
  std::fill(vbuf.begin(), vbuf.end(), static_cast<uint8_t>(129));
  std::memset(ybuf.data(), 127, ls);
  std::memset(ubuf.data(), 127, cs);
  std::memset(vbuf.data(), 127, cs);
  stats = TokenStats{};
  StatSink stat_sink{stats};
  std::vector<uint8_t> s_ay(static_cast<size_t>(mbw) * 4, 0);
  std::vector<uint8_t> s_au(static_cast<size_t>(mbw) * 2, 0);
  std::vector<uint8_t> s_av(static_cast<size_t>(mbw) * 2, 0);
  std::vector<uint8_t> s_ay2(mbw, 0);
  uint8_t s_ly[4], s_lu[2], s_lv[2], s_ly2;

  int16_t res[16], coef[16], dcs[16];
  int pix[16];
  uint8_t best16[256], b8u[64], b8v[64];
  uint8_t recon16[256];
  int16_t dq[16];

  for (int mby = 0; mby < mbh; ++mby) {
    std::memset(s_ly, 0, 4);
    std::memset(s_lu, 0, 2);
    std::memset(s_lv, 0, 2);
    s_ly2 = 0;
    for (int mbx = 0; mbx < mbw; ++mbx) {
      MbData& mb = mbs[static_cast<size_t>(mby) * mbw + mbx];
      mb.segment = seg.map.empty()
                       ? 0
                       : seg.map[static_cast<size_t>(mby) * mbw + mbx];
      const Quantizers& Q = segQ[mb.segment];
      const int64_t lambda_y = seg_lambda_y[mb.segment] < 0
                                   ? -1
                                   : (seg_lambda_y[mb.segment] * lscale10) >> 10;
      const int64_t lambda_uv =
          seg_lambda_uv[mb.segment] < 0
              ? -1
              : (seg_lambda_uv[mb.segment] * lscale10) >> 10;
      const double lambda = seg_lambda_rd[mb.segment];
      const int64_t i4_gate = seg_i4_gate[mb.segment];
      const int px = mbx * 16, py = mby * 16;
      const int cpx = mbx * 8, cpy = mby * 8;
      const uint8_t* src = sy.data() + static_cast<size_t>(py) * W + px;

      // --- I16 candidate: pick prediction by SSE (borders give the exact
      // decoder semantics at frame edges), then transform/quant/recon into
      // a scratch block ---
      int64_t best = -1;
      int bestmode = 0;
      int64_t sse4[4];
      PredSse4Modes(src, W, RY, ls, px, py, 16, mby > 0, mbx > 0, sse4);
      for (int m = 0; m < 4; ++m) {
        if (best < 0 || sse4[m] < best) {
          best = sse4[m];
          bestmode = m;
        }
      }
      ikvp8::PredictI16OrChroma(RY, ls, px, py, 16, bestmode, mby > 0, mbx > 0);
      for (int y = 0; y < 16; ++y)
        std::memcpy(best16 + y * 16, RY + (py + y) * ls + px, 16);

      int16_t y16[16][16], y2c[16];
      int rate16 = 4;  // ymode bits
      bool nz16 = false;
      // trellis context: in-MB nonzero neighbours (MB-external ones would
      // only change the first token's table; approximated as zero)
      uint8_t tnza[4] = {0, 0, 0, 0}, tnzl[4] = {0, 0, 0, 0};
      for (int sb = 0; sb < 16; ++sb) {
        const int bx = (sb & 3) * 4, by = (sb >> 2) * 4;
        for (int y = 0; y < 4; ++y)
          for (int x = 0; x < 4; ++x)
            res[y * 4 + x] = static_cast<int16_t>(
                src[static_cast<size_t>(by + y) * W + bx + x] -
                best16[(by + y) * 16 + bx + x]);
        Fdct4x4(res, coef);
        dcs[sb] = coef[0];
        y16[sb][0] = 0;
        bool nzb = false;
        if (lambda_y >= 0) {
          nzb = TrellisQuantBlock(cm, coef, 0, 1, tnza[sb & 3] + tnzl[sb >> 2],
                                  Q.y1.dc, Q.y1.ac, lambda_y, y16[sb]);
        } else {
          for (int i = 1; i < 16; ++i) {
            y16[sb][i] = Quantize(coef[i], Q.y1.ac, false);
            if (y16[sb][i]) nzb = true;
          }
        }
        tnza[sb & 3] = tnzl[sb >> 2] = nzb ? 1 : 0;
        nz16 |= nzb;
        rate16 += RateProxy(y16[sb], 1);
      }
      Wht4x4(dcs, coef);
      for (int i = 0; i < 16; ++i) {
        y2c[i] = Quantize(coef[i], i == 0 ? Q.y2.dc : Q.y2.ac, i == 0);
        if (y2c[i]) nz16 = true;
      }
      rate16 += RateProxy(y2c, 0);
      for (int i = 0; i < 16; ++i)
        dq[i] = static_cast<int16_t>(y2c[i] * (i == 0 ? Q.y2.dc : Q.y2.ac));
      int dcout[16];
      InvWht4x4(dq, dcout);
      for (int sb = 0; sb < 16; ++sb) {
        const int bx = (sb & 3) * 4, by = (sb >> 2) * 4;
        dq[0] = static_cast<int16_t>(dcout[sb]);
        for (int i = 1; i < 16; ++i)
          dq[i] = static_cast<int16_t>(y16[sb][i] * Q.y1.ac);
        Idct4x4(dq, pix);
        for (int y = 0; y < 4; ++y)
          for (int x = 0; x < 4; ++x)
            recon16[(by + y) * 16 + bx + x] = Clip255(
                pix[y * 4 + x] + best16[(by + y) * 16 + bx + x]);
      }
      const int64_t dist16 = SseRegion(src, W, recon16, 16, 16);

      // --- B_PRED candidate (gated): per-sub-block best of the 10 modes,
      // encoded sequentially in a local tile so neighbours are the true
      // reconstruction; wins on structured content where one 16x16
      // predictor can't follow edges ---
      bool use_b = false;
      uint8_t tile[17 * 21];
      int16_t yb[16][16];
      uint8_t bmodes[16];
      // gate on PREDICTION error (post-recon distortion is always near the
      // quantisation floor — the I16/B_PRED difference shows up as rate)
      if (best > i4_gate) {
        for (int r = -1; r < 16; ++r)
          std::memcpy(tile + (r + 1) * 21, RY + (py + r) * ls + px - 1, 21);
        int64_t dist_b = 0;
        int rate_b = 2;  // B_PRED ymode bit + change
        uint8_t bnza[4] = {0, 0, 0, 0}, bnzl[4] = {0, 0, 0, 0};
        for (int sb = 0; sb < 16; ++sb) {
          const int bx = (sb & 3) * 4, by = (sb >> 2) * 4;
          uint8_t* o = tile + (1 + by) * 21 + 1 + bx;
          uint8_t A[8], L[4];
          const uint8_t* arow = o - 21;
          std::memcpy(A, arow, 4);
          if ((sb & 3) < 3 || sb < 4) {
            std::memcpy(A + 4, arow + 4, 4);
          } else {
            std::memcpy(A + 4, tile + 1 + 16, 4);  // row above the MB
          }
          for (int i = 0; i < 4; ++i) L[i] = o[i * 21 - 1];
          const int AL = arow[-1];
          const uint8_t* bsrc = src + static_cast<size_t>(by) * W + bx;
          uint8_t s16[16];  // source block packed once for the 10-mode rank
          for (int r = 0; r < 4; ++r)
            std::memcpy(s16 + r * 4, bsrc + static_cast<size_t>(r) * W, 4);
          // context modes for the RD mode-bit term: the true neighbour
          // sub-modes (this MB's already-chosen blocks; adjacent MBs'
          // final modes, I16 ones mapped — identical to the write pass)
          const int sx_ = sb & 3, sy_ = sb >> 2;
          int am = 0, lm = 0;
          if (sy_ > 0) {
            am = bmodes[sb - 4];
          } else if (mby > 0) {
            am = mbs[static_cast<size_t>(mby - 1) * mbw + mbx]
                     .bmodes[12 + sx_];
          }
          if (sx_ > 0) {
            lm = bmodes[sb - 1];
          } else if (mbx > 0) {
            lm = mbs[static_cast<size_t>(mby) * mbw + mbx - 1]
                     .bmodes[sy_ * 4 + 3];
          }
          const uint8_t* mp = kKfBModeProbs[am][lm];
          // Full RD per candidate mode: quantise each mode's residual and
          // score 256*transform-domain distortion + lambda*(token bits +
          // context mode bits) — the terms the old prediction-SSE rank
          // ignored (how the residual CODES, and that neighbour-agreeing
          // modes are near-free). The transform-vs-pixel domain gain is
          // folded into the calibrated selection lambda.
          const int64_t sel_lambda =
              (static_cast<int64_t>(Q.y1.ac) * Q.y1.ac * ModeRdMultEnv() /
               64 * lscale10) >> 10;
          const int bctx = bnza[sb & 3] + bnzl[sb >> 2];
          int16_t mres[16], mcoef[16], mlvl[16];
          int64_t bb = -1;
          int bm = 0, bmcost = 0;
          // Shortlist before the full-RD rank: fdct+quantise+token-cost
          // on all 10 modes is ~80% of whole-frame encode time on busy
          // content (gprof, round 4). Prediction SSE ranks the same
          // objective at the quantisation floor (the fdct is orthogonal
          // up to a fixed gain, so residual energy orders identically
          // in either domain); the sel_lambda*mode-bits term keeps
          // near-ties ordered like the full score. Pre-rank ordering
          // errors concentrate in NEAR-TIES, so the default policy is
          // adaptive: full-RD every mode within I4RdSpanEnv()/64 of the
          // best pre-rank — on directionally-ambiguous content (text)
          // that is near-exhaustive, on photo/noise it prunes to ~2-4
          // candidates. Fixed top-N via IMAGEKIT_VP8_I4_RD_MODES;
          // candidates are visited in ascending mode order so >=10
          // reproduces the exhaustive loop bit-for-bit.
          const int nrd0 = I4RdModesEnv();
          const int nrd = nrd0 > 10 ? 10 : nrd0;
          uint8_t pmode[10][16];
          int64_t prank[10];
          for (int m = 0; m < 10; ++m) {
            ikvp8::PredictB(pmode[m], 4, m, A, L, AL);
            const int64_t s = Sse4x4Packed(s16, pmode[m]);
            // 16x: the fdct's fixed transform gain, matching the
            // 256*transform-SSE scale the full score uses
            prank[m] = 256 * 16 * s + sel_lambda * CostBMode(mp, m);
          }
          bool chosen[10] = {};
          if (nrd == 0) {  // adaptive span around the best pre-rank
            int64_t pmin = prank[0];
            for (int m = 1; m < 10; ++m)
              if (prank[m] < pmin) pmin = prank[m];
            const int64_t cut = (pmin * I4RdSpanEnv()) / 64;
            for (int m = 0; m < 10; ++m) chosen[m] = prank[m] <= cut;
          } else {
            for (int pick = 0; pick < nrd; ++pick) {
              int best_m = -1;
              for (int m = 0; m < 10; ++m)
                if (!chosen[m] &&
                    (best_m < 0 || prank[m] < prank[best_m]))
                  best_m = m;
              chosen[best_m] = true;
            }
          }
          for (int m = 0; m < 10; ++m) {
            if (!chosen[m]) continue;
            for (int i = 0; i < 16; ++i)
              mres[i] = static_cast<int16_t>(s16[i] - pmode[m][i]);
            Fdct4x4(mres, mcoef);
            for (int i = 0; i < 16; ++i)
              mlvl[i] =
                  Quantize(mcoef[i], i == 0 ? Q.y1.dc : Q.y1.ac, i == 0);
            const int mc = CostBMode(mp, m);
            const int64_t score =
                QuantizedBlockScore(cm, mcoef, mlvl, 3, 0, bctx, Q.y1.dc,
                                    Q.y1.ac, sel_lambda) +
                sel_lambda * mc;
            if (bb < 0 || score < bb) {
              bb = score;
              bm = m;
              bmcost = mc;
            }
          }
          bmodes[sb] = static_cast<uint8_t>(bm);
          ikvp8::PredictB(o, 21, bm, A, L, AL);
          for (int y = 0; y < 4; ++y)
            for (int x = 0; x < 4; ++x)
              res[y * 4 + x] =
                  static_cast<int16_t>(bsrc[y * W + x] - o[y * 21 + x]);
          Fdct4x4(res, coef);
          if (lambda_y >= 0) {
            const bool nzb =
                TrellisQuantBlock(cm, coef, 3, 0, bnza[sb & 3] + bnzl[sb >> 2],
                                  Q.y1.dc, Q.y1.ac, lambda_y, yb[sb]);
            bnza[sb & 3] = bnzl[sb >> 2] = nzb ? 1 : 0;
          } else {
            bool nzb = false;
            for (int i = 0; i < 16; ++i) {
              yb[sb][i] =
                  Quantize(coef[i], i == 0 ? Q.y1.dc : Q.y1.ac, i == 0);
              if (yb[sb][i]) nzb = true;
            }
            bnza[sb & 3] = bnzl[sb >> 2] = nzb ? 1 : 0;
          }
          rate_b += RateProxy(yb[sb], 0) + (bmcost >> 8);  // + sub-mode bits
          for (int i = 0; i < 16; ++i)
            dq[i] =
                static_cast<int16_t>(yb[sb][i] * (i == 0 ? Q.y1.dc : Q.y1.ac));
          Idct4x4(dq, pix);
          for (int y = 0; y < 4; ++y)
            for (int x = 0; x < 4; ++x)
              o[y * 21 + x] = Clip255(pix[y * 4 + x] + o[y * 21 + x]);
          dist_b += SseRegion(bsrc, W, o, 21, 4);
        }
        // Mode-plane uniformity experiments (stream dissection vs
        // libwebp, noise q95): libwebp codes that corpus 100% B_PRED at
        // 74.0 KB; our best uniform choice (all-I16, 74.9 KB) and our
        // per-MB-optimal mix (76.8 KB) both trail it, and neither a
        // rate bias nor forced uniformity (77.1 KB all-B_PRED) closes
        // the residual ~1.3% — it lives in per-level coding efficiency,
        // not the mode mix. The knob stays for calibration; the auto
        // policy applies NO bias.
        const int i4b = I4BiasPctEnv();
        const double r16_bias = 1.0 + (i4b >= 0 ? i4b : 0) / 100.0;
        use_b =
            dist_b + lambda * rate_b < dist16 + lambda * rate16 * r16_bias;
        if (use_b) {
          for (int y = 0; y < 16; ++y)
            std::memcpy(RY + (py + y) * ls + px, tile + (y + 1) * 21 + 1, 16);
          mb.ymode = 4;
          std::memcpy(mb.bmodes, bmodes, 16);
          for (int sb = 0; sb < 16; ++sb)
            mb.y_n[sb] = static_cast<int8_t>(ToZigzag(yb[sb], 0, mb.y[sb]));
          std::memset(mb.y2, 0, sizeof(mb.y2));
          mb.y2_n = -1;
        }
      }
      bool any_nz = false;
      if (!use_b) {
        for (int y = 0; y < 16; ++y)
          std::memcpy(RY + (py + y) * ls + px, recon16 + y * 16, 16);
        mb.ymode = static_cast<uint8_t>(bestmode);
        const uint8_t bm = static_cast<uint8_t>(I16ToBMode(bestmode));
        std::memset(mb.bmodes, bm, 16);
        for (int sb = 0; sb < 16; ++sb)
          mb.y_n[sb] = static_cast<int8_t>(ToZigzag(y16[sb], 1, mb.y[sb]));
        mb.y2_n = static_cast<int8_t>(ToZigzag(y2c, 0, mb.y2));
        any_nz = nz16;
      } else {
        for (int sb = 0; sb < 16 && !any_nz; ++sb)
          any_nz = mb.y_n[sb] >= 0;
      }

      // --- chroma: mode by prediction SSE, transform/recon in place ---
      best = -1;
      bestmode = 0;
      {
        int64_t sseu[4], ssev[4];
        PredSse4Modes(su.data() + static_cast<size_t>(cpy) * CW + cpx, CW, RU,
                      cs, cpx, cpy, 8, mby > 0, mbx > 0, sseu);
        PredSse4Modes(sv.data() + static_cast<size_t>(cpy) * CW + cpx, CW, RV,
                      cs, cpx, cpy, 8, mby > 0, mbx > 0, ssev);
        for (int m = 0; m < 4; ++m) {
          const int64_t sse = sseu[m] + ssev[m];
          if (best < 0 || sse < best) {
            best = sse;
            bestmode = m;
          }
        }
      }
      mb.uvmode = static_cast<uint8_t>(bestmode);
      ikvp8::PredictI16OrChroma(RU, cs, cpx, cpy, 8, bestmode, mby > 0, mbx > 0);
      ikvp8::PredictI16OrChroma(RV, cs, cpx, cpy, 8, bestmode, mby > 0, mbx > 0);
      for (int y = 0; y < 8; ++y) {
        std::memcpy(b8u + y * 8, RU + (cpy + y) * cs + cpx, 8);
        std::memcpy(b8v + y * 8, RV + (cpy + y) * cs + cpx, 8);
      }

      const uint8_t* splanes[2] = {su.data(), sv.data()};
      uint8_t* rplanes[2] = {RU, RV};
      const uint8_t* preds[2] = {b8u, b8v};
      for (int pl = 0; pl < 2; ++pl) {
        uint8_t cnza[2] = {0, 0}, cnzl[2] = {0, 0};
        for (int sb = 0; sb < 4; ++sb) {
          const int bx = (sb & 1) * 4, by = (sb >> 1) * 4;
          for (int y = 0; y < 4; ++y)
            for (int x = 0; x < 4; ++x)
              res[y * 4 + x] = static_cast<int16_t>(
                  splanes[pl][static_cast<size_t>(cpy + by + y) * CW + cpx +
                              bx + x] -
                  preds[pl][(by + y) * 8 + bx + x]);
          Fdct4x4(res, coef);
          int16_t qc[16];
          if (lambda_uv >= 0) {
            const bool nzb =
                TrellisQuantBlock(cm, coef, 2, 0, cnza[sb & 1] + cnzl[sb >> 1],
                                  Q.uv.dc, Q.uv.ac, lambda_uv, qc);
            cnza[sb & 1] = cnzl[sb >> 1] = nzb ? 1 : 0;
            if (nzb) any_nz = true;
          } else {
            bool nzb = false;
            for (int i = 0; i < 16; ++i) {
              qc[i] = Quantize(coef[i], i == 0 ? Q.uv.dc : Q.uv.ac, i == 0);
              if (qc[i]) nzb = true;
            }
            cnza[sb & 1] = cnzl[sb >> 1] = nzb ? 1 : 0;
            if (nzb) any_nz = true;
          }
          mb.uv_n[pl * 4 + sb] =
              static_cast<int8_t>(ToZigzag(qc, 0, mb.uv[pl * 4 + sb]));
          for (int i = 0; i < 16; ++i)
            dq[i] = static_cast<int16_t>(qc[i] * (i == 0 ? Q.uv.dc : Q.uv.ac));
          Idct4x4(dq, pix);
          for (int y = 0; y < 4; ++y)
            for (int x = 0; x < 4; ++x)
              rplanes[pl][static_cast<size_t>(cpy + by + y) * cs + cpx + bx +
                          x] =
                  Clip255(pix[y * 4 + x] + preds[pl][(by + y) * 8 + bx + x]);
        }
      }
      mb.skip = any_nz ? 0 : 1;
      TokenizeMb(stat_sink, mb, mbx, s_ay.data(), s_au.data(), s_av.data(),
                 s_ay2.data(), s_ly, s_lu, s_lv, s_ly2);
    }
    // extend the right luma border for next row's above-right reads
    // (decoder mirror)
    for (int yy = mby * 16; yy < mby * 16 + 16; ++yy) {
      uint8_t* row = RY + yy * ls;
      std::memset(row + W, row[W - 1], 4);
    }
  }
  };  // run_analysis

  run_analysis(DefaultCostModel(), 1024);

  // Exact partition-1 side-information bits (1/256 units) of the current
  // analysis state: segment ids, skip flags (under their own fitted skip
  // probability), and the context-coded ymode/bmode/uvmode trees — the
  // frame-level cost a per-MB rate proxy cannot see (mode-probability
  // dilution, docs/ROADMAP.md item 10). Mirrors the partition-1 writer's
  // walk exactly.
  auto side_bits = [&]() -> int64_t {
    auto ymode_cost = [](int m) {
      switch (m) {
        case 4: return BitCost(0, 145);
        case 0: return BitCost(1, 145) + BitCost(0, 156) + BitCost(0, 163);
        case 1: return BitCost(1, 145) + BitCost(0, 156) + BitCost(1, 163);
        case 2: return BitCost(1, 145) + BitCost(1, 156) + BitCost(0, 128);
        default: return BitCost(1, 145) + BitCost(1, 156) + BitCost(1, 128);
      }
    };
    auto uv_cost = [](int m) {
      switch (m) {
        case 0: return BitCost(0, 142);
        case 1: return BitCost(1, 142) + BitCost(0, 114);
        case 2: return BitCost(1, 142) + BitCost(1, 114) + BitCost(0, 183);
        default: return BitCost(1, 142) + BitCost(1, 114) + BitCost(1, 183);
      }
    };
    const int nmb_all = mbw * mbh;
    int nsk = 0;
    for (const auto& mb : mbs) nsk += mb.skip;
    int psf = 255 - (255 * nsk) / nmb_all;
    if (psf < 1) psf = 1;
    if (psf > 255) psf = 255;
    int64_t bits = 0;
    std::vector<uint8_t> abm(static_cast<size_t>(mbw) * 4, 0);
    uint8_t lbm[4];
    for (int mby = 0; mby < mbh; ++mby) {
      std::memset(lbm, 0, 4);
      for (int mbx = 0; mbx < mbw; ++mbx) {
        const MbData& mb = mbs[static_cast<size_t>(mby) * mbw + mbx];
        if (seg.count > 1) {
          const int s = mb.segment;
          bits += (s < 2) ? BitCost(0, seg.tree_probs[0]) +
                                BitCost(s & 1, seg.tree_probs[1])
                          : BitCost(1, seg.tree_probs[0]) +
                                BitCost(s & 1, seg.tree_probs[2]);
        }
        bits += BitCost(mb.skip, psf);
        bits += ymode_cost(mb.ymode);
        if (mb.ymode == 4) {
          for (int sb = 0; sb < 16; ++sb) {
            const int sx = sb & 3, sy_ = sb >> 2;
            const int am = sy_ == 0 ? abm[mbx * 4 + sx] : mb.bmodes[sb - 4];
            const int lm = sx == 0 ? lbm[sy_] : mb.bmodes[sb - 1];
            bits += CostBMode(kKfBModeProbs[am][lm], mb.bmodes[sb]);
          }
        }
        for (int i = 0; i < 4; ++i) {
          abm[mbx * 4 + i] = mb.bmodes[12 + i];
          lbm[i] = mb.bmodes[i * 4 + 3];
        }
        bits += uv_cost(mb.uvmode);
      }
    }
    return bits;
  };

  // Multi-pass probability-coupled RD: re-analyse under tables fitted to
  // the previous pass's statistics, keep the pass whose total estimated
  // frame bits (tokens under own fit + exact partition-1 side info) is
  // smallest, stop when a pass stops improving the estimate. Keeping the
  // BEST pass (not the last) makes the loop monotone: content whose
  // refit feedback oscillates (near-random coefficients at mid quality)
  // costs one wasted pass and keeps its single-pass result.
  const int max_extra = TwoPassFor(tk, qindex);
  if (max_extra > 0) {
    struct PassSnap {
      std::vector<MbData> mbs;
      TokenStats stats;
      std::vector<uint8_t> y, u, v;
    };
    int64_t best_est = TokenBitsEstimate(stats) + side_bits();
    int64_t prev_est = best_est;
    PassSnap best{mbs, stats, ybuf, ubuf, vbuf};
    for (int extra = 0; extra < max_extra; ++extra) {
      CoeffProbs fitted;
      bool fit_upd[4][8][3][11];
      AdaptCoeffProbs(stats, fitted, fit_upd);
      // Keep the RD slope: price the current decisions under the default
      // and fitted tables and scale the next pass's lambda by the bit
      // ratio (fitted tables code the same tokens in fewer bits; see
      // run_analysis's lscale10 note).
      int64_t bits_def = 0, bits_fit = 0;
      for (int t = 0; t < 4; ++t)
        for (int b = 0; b < 8; ++b)
          for (int c = 0; c < 3; ++c)
            for (int n = 0; n < 11; ++n) {
              const uint32_t c0 = stats.cnt[t][b][c][n][0];
              const uint32_t c1 = stats.cnt[t][b][c][n][1];
              if (c0 + c1 == 0) continue;
              bits_def += static_cast<int64_t>(c0) *
                              BitCost(0, kCoeffProbs[t][b][c][n]) +
                          static_cast<int64_t>(c1) *
                              BitCost(1, kCoeffProbs[t][b][c][n]);
              bits_fit +=
                  static_cast<int64_t>(c0) * BitCost(0, fitted[t][b][c][n]) +
                  static_cast<int64_t>(c1) * BitCost(1, fitted[t][b][c][n]);
            }
      const int64_t lscale10 =
          bits_fit > 0 ? (bits_def * 1024 + bits_fit / 2) / bits_fit : 1024;
      const NzCostTable fitted_nzc(fitted);
      const CostModel cm_fitted{&fitted, &fitted_nzc};
      run_analysis(cm_fitted, lscale10);
      const int64_t est = TokenBitsEstimate(stats) + side_bits();
      if (est < best_est) {
        best_est = est;
        best = PassSnap{mbs, stats, ybuf, ubuf, vbuf};
      }
      if (est * 1000 >= prev_est * 999) break;  // converged / not improving
      prev_est = est;
    }
    mbs = std::move(best.mbs);
    stats = best.stats;
    ybuf = std::move(best.y);
    ubuf = std::move(best.u);
    vbuf = std::move(best.v);
    RY = ybuf.data() + ls + 1;
    RU = ubuf.data() + cs + 1;
    RV = vbuf.data() + cs + 1;
  }

  // ---------------- skip probability ----------------
  int nskip = 0;
  for (const auto& mb : mbs) nskip += mb.skip;
  const int nmb = mbw * mbh;
  int prob_skip_false = 255 - (255 * nskip) / nmb;
  if (prob_skip_false < 1) prob_skip_false = 1;
  if (prob_skip_false > 255) prob_skip_false = 255;

  // ---------------- token write loop (stats were tallied in pass 1) ----
  auto for_each_token = [&](auto&& sink) {
    std::vector<uint8_t> ay(static_cast<size_t>(mbw) * 4, 0);
    std::vector<uint8_t> au(static_cast<size_t>(mbw) * 2, 0);
    std::vector<uint8_t> av(static_cast<size_t>(mbw) * 2, 0);
    std::vector<uint8_t> ay2(mbw, 0);
    uint8_t ly[4], lu[2], lv[2], ly2;
    for (int mby = 0; mby < mbh; ++mby) {
      std::memset(ly, 0, 4);
      std::memset(lu, 0, 2);
      std::memset(lv, 0, 2);
      ly2 = 0;
      for (int mbx = 0; mbx < mbw; ++mbx)
        TokenizeMb(sink, mbs[static_cast<size_t>(mby) * mbw + mbx], mbx,
                   ay.data(), au.data(), av.data(), ay2.data(), ly, lu, lv,
                   ly2);
    }
  };

  // ---------------- adapted probability tables ----------
  CoeffProbs frame_probs;
  bool prob_updated[4][8][3][11];
  AdaptCoeffProbs(stats, frame_probs, prob_updated);

  // ---------------- pass 2: write partitions ----------------
  BoolEnc p1, p2;
  // frame header (RFC 6386 §9.2-9.11, keyframe)
  p1.PutLiteral(0, 1);  // color_space
  p1.PutLiteral(0, 1);  // clamping_type
  if (seg.count > 1) {  // segmentation (RFC 6386 §9.3): abs quantiser +
    p1.PutBit(1, 128);  //   abs filter level per segment, map updated
    p1.PutBit(1, 128);  // update_mb_segmentation_map
    p1.PutBit(1, 128);  // update_segment_feature_data
    p1.PutBit(1, 128);  // abs values
    for (int s = 0; s < 4; ++s) {  // quantizer feature
      p1.PutBit(1, 128);
      p1.PutLiteral(static_cast<uint32_t>(seg.qi[s]), 7);
      p1.PutBit(0, 128);  // sign (qindex >= 0)
    }
    for (int s = 0; s < 4; ++s) {  // loop-filter feature (abs: the
      p1.PutBit(1, 128);           // decoder takes level from the segment)
      p1.PutLiteral(static_cast<uint32_t>(seg_lf[s]), 6);
      p1.PutBit(0, 128);
    }
    for (int i = 0; i < 3; ++i) {  // segment-map tree probabilities
      p1.PutBit(1, 128);
      p1.PutLiteral(seg.tree_probs[i], 8);
    }
  } else {
    p1.PutBit(0, 128);  // segmentation_enabled
  }
  p1.PutBit(0, 128);    // filter_type: normal (full) loop filter
  // In-frame intra prediction reads UNFILTERED reconstruction, so the loop
  // filter level only changes what the decoder displays — enabling
  // deblocking here costs the encoder nothing. Level scales with the
  // quantiser like libwebp's filter-strength heuristic.
  p1.PutLiteral(static_cast<uint32_t>(filter_level), 6);
  p1.PutLiteral(0, 3);  // sharpness
  p1.PutBit(0, 128);    // loop_filter_adj_enabled
  p1.PutLiteral(0, 2);  // log2(token partitions) = 0 -> 1 partition
  p1.PutLiteral(static_cast<uint32_t>(qindex), 7);  // y_ac_qi
  p1.PutZeroDelta();    // y1 dc delta
  p1.PutZeroDelta();    // y2 dc delta
  p1.PutZeroDelta();    // y2 ac delta
  p1.PutDelta(uv_dc_delta);  // uv dc delta
  p1.PutDelta(uv_ac_delta);  // uv ac delta
  p1.PutBit(0, 128);    // refresh_entropy_probs
  // token probability updates (RFC 6386 §13.4): signal the slots whose
  // adapted value pays for its own 8-bit literal
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int pth = 0; pth < 11; ++pth) {
          if (prob_updated[t][b][c][pth]) {
            p1.PutBit(1, kCoeffUpdateProbs[t][b][c][pth]);
            p1.PutLiteral(frame_probs[t][b][c][pth], 8);
          } else {
            p1.PutBit(0, kCoeffUpdateProbs[t][b][c][pth]);
          }
        }
  p1.PutBit(1, 128);  // mb_no_coeff_skip
  p1.PutLiteral(static_cast<uint32_t>(prob_skip_false), 8);

  // per-MB modes into partition 1 (sub-mode prediction contexts mirror the
  // decoder; B_DC outside the frame)
  std::vector<uint8_t> above_bm(static_cast<size_t>(mbw) * 4, 0);
  uint8_t left_bm[4];
  for (int mby = 0; mby < mbh; ++mby) {
    std::memset(left_bm, 0, 4);
    for (int mbx = 0; mbx < mbw; ++mbx) {
      const MbData& mb = mbs[static_cast<size_t>(mby) * mbw + mbx];
      const bool bpred = mb.ymode == 4;
      if (seg.count > 1) {
        // mb_segment_tree (RFC §10): id precedes the skip flag
        const int s = mb.segment;
        if (s < 2) {
          p1.PutBit(0, seg.tree_probs[0]);
          p1.PutBit(s & 1, seg.tree_probs[1]);
        } else {
          p1.PutBit(1, seg.tree_probs[0]);
          p1.PutBit(s & 1, seg.tree_probs[2]);
        }
      }
      p1.PutBit(mb.skip, prob_skip_false);
      PutYMode(p1, mb.ymode);
      if (bpred) {
        for (int sb = 0; sb < 16; ++sb) {
          const int sx = sb & 3, sy_ = sb >> 2;
          const int am =
              sy_ == 0 ? above_bm[mbx * 4 + sx] : mb.bmodes[sb - 4];
          const int lm = sx == 0 ? left_bm[sy_] : mb.bmodes[sb - 1];
          PutBMode(p1, kKfBModeProbs[am][lm], mb.bmodes[sb]);
        }
      }
      for (int i = 0; i < 4; ++i) {
        above_bm[mbx * 4 + i] = mb.bmodes[12 + i];
        left_bm[i] = mb.bmodes[i * 4 + 3];
      }
      PutUvMode(p1, mb.uvmode);
    }
  }

  // tokens into partition 2, with the frame-adapted tables
  WriteSink write_sink{p2, frame_probs};
  for_each_token(write_sink);
  p1.Stop();
  p2.Stop();

  // ---------------- assemble frame + RIFF container ----------------
  const size_t p1size = p1.buf.size();
  const size_t vp8_size = 10 + p1size + p2.buf.size();
  const size_t chunk = vp8_size + (vp8_size & 1);
  const size_t total = 12 + 8 + chunk;
  if (out_cap < total) return -7;

  uint8_t* o = out;
  auto put32 = [&o](uint32_t v) {
    o[0] = v & 0xff;
    o[1] = (v >> 8) & 0xff;
    o[2] = (v >> 16) & 0xff;
    o[3] = (v >> 24) & 0xff;
    o += 4;
  };
  std::memcpy(o, "RIFF", 4);
  o += 4;
  put32(static_cast<uint32_t>(4 + 8 + chunk));
  std::memcpy(o, "WEBP", 4);
  o += 4;
  std::memcpy(o, "VP8 ", 4);
  o += 4;
  put32(static_cast<uint32_t>(vp8_size));
  // frame tag: keyframe(0) | version(0) | show_frame(1) | p1 size
  const uint32_t tag =
      0 | (0 << 1) | (1 << 4) | (static_cast<uint32_t>(p1size) << 5);
  o[0] = tag & 0xff;
  o[1] = (tag >> 8) & 0xff;
  o[2] = (tag >> 16) & 0xff;
  o += 3;
  o[0] = 0x9d;
  o[1] = 0x01;
  o[2] = 0x2a;
  o += 3;
  o[0] = width & 0xff;
  o[1] = (width >> 8) & 0x3f;  // scale 0
  o += 2;
  o[0] = height & 0xff;
  o[1] = (height >> 8) & 0x3f;
  o += 2;
  std::memcpy(o, p1.buf.data(), p1size);
  o += p1size;
  std::memcpy(o, p2.buf.data(), p2.buf.size());
  o += p2.buf.size();
  if (vp8_size & 1) *o++ = 0;  // RIFF pad

  if (recon_y)
    for (int yy = 0; yy < H; ++yy)
      std::memcpy(recon_y + static_cast<size_t>(yy) * W, RY + yy * ls, W);
  if (recon_u)
    for (int yy = 0; yy < CH; ++yy)
      std::memcpy(recon_u + static_cast<size_t>(yy) * CW, RU + yy * cs, CW);
  if (recon_v)
    for (int yy = 0; yy < CH; ++yy)
      std::memcpy(recon_v + static_cast<size_t>(yy) * CW, RV + yy * cs, CW);
  return static_cast<int64_t>(o - out);
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------
IK_EXPORT int64_t ik_vp8_encode(const uint8_t* ysrc, const uint8_t* usrc,
                                const uint8_t* vsrc, int width, int height,
                                int ystride, int cstride, int quality,
                                uint8_t* out, size_t out_cap) {
  return EncodeImpl(ysrc, usrc, vsrc, width, height, ystride, cstride,
                    quality, out, out_cap, 0, nullptr, nullptr, nullptr);
}

// Extended entry for tests/tools: flags bit0 = loop filter off, bit1 =
// trellis quantisation off; recon planes (nullable) sized mbw*16 x mbh*16
// and mbw*8 x mbh*8.
IK_EXPORT int64_t ik_vp8_encode_ex(const uint8_t* ysrc, const uint8_t* usrc,
                                   const uint8_t* vsrc, int width, int height,
                                   int ystride, int cstride, int quality,
                                   uint8_t* out, size_t out_cap, int flags,
                                   uint8_t* recon_y, uint8_t* recon_u,
                                   uint8_t* recon_v) {
  return EncodeImpl(ysrc, usrc, vsrc, width, height, ystride, cstride,
                    quality, out, out_cap, flags, recon_y, recon_u, recon_v);
}

IK_EXPORT int ik_vp8_version() { return 2; }
