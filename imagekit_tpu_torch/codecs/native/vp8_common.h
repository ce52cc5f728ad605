// Shared VP8 fixed-point primitives: the NORMATIVE inverse transforms
// (RFC 6386 §14.3-14.5) and quantiser setup used by both the encoder
// (vp8_encode.cpp) and the decoder (vp8_decode.cpp). The encoder's
// reconstruction must equal decoder output bit-exactly, so there is
// exactly one implementation of each.
#ifndef IK_VP8_COMMON_H_
#define IK_VP8_COMMON_H_

#include <cstdint>
#include <cstring>

#if defined(__SSE4_1__)
#include <smmintrin.h>
#endif

#include "vp8_tables.h"

namespace ikvp8 {

inline uint8_t Clip255(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

constexpr int kSinPi8Sqrt2 = 35468;
constexpr int kCosPi8Sqrt2Minus1 = 20091;

// Inverse DCT (RFC 6386 §14.4), 4x4 coefficients -> residual.
inline void Idct4x4(const int16_t* in, int* out /*16*/) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a1 = in[i] + in[8 + i];
    const int b1 = in[i] - in[8 + i];
    int t1 = (in[4 + i] * kSinPi8Sqrt2) >> 16;
    int t2 = in[12 + i] + ((in[12 + i] * kCosPi8Sqrt2Minus1) >> 16);
    const int c1 = t1 - t2;
    t1 = in[4 + i] + ((in[4 + i] * kCosPi8Sqrt2Minus1) >> 16);
    t2 = (in[12 + i] * kSinPi8Sqrt2) >> 16;
    const int d1 = t1 + t2;
    tmp[0 + i] = a1 + d1;
    tmp[12 + i] = a1 - d1;
    tmp[4 + i] = b1 + c1;
    tmp[8 + i] = b1 - c1;
  }
  for (int i = 0; i < 4; ++i) {
    const int a1 = tmp[i * 4 + 0] + tmp[i * 4 + 2];
    const int b1 = tmp[i * 4 + 0] - tmp[i * 4 + 2];
    int t1 = (tmp[i * 4 + 1] * kSinPi8Sqrt2) >> 16;
    int t2 = tmp[i * 4 + 3] + ((tmp[i * 4 + 3] * kCosPi8Sqrt2Minus1) >> 16);
    const int c1 = t1 - t2;
    t1 = tmp[i * 4 + 1] + ((tmp[i * 4 + 1] * kCosPi8Sqrt2Minus1) >> 16);
    t2 = (tmp[i * 4 + 3] * kSinPi8Sqrt2) >> 16;
    const int d1 = t1 + t2;
    out[i * 4 + 0] = (a1 + d1 + 4) >> 3;
    out[i * 4 + 3] = (a1 - d1 + 4) >> 3;
    out[i * 4 + 1] = (b1 + c1 + 4) >> 3;
    out[i * 4 + 2] = (b1 - c1 + 4) >> 3;
  }
}

// Fused inverse DCT + add-to-prediction + clip: dst (stride `stride`)
// holds the prediction and receives the reconstruction in place. The SIMD
// path reproduces Idct4x4's integer arithmetic exactly (same epi32 adds,
// mullo and arithmetic shifts; packs+packus saturation equals Clip255 for
// every int32 input), so decoder bit-exactness is preserved — pinned by
// the bit-exact-vs-libwebp tests.
#if defined(__SSE4_1__)
inline void IdctAdd4x4(const int16_t* in, uint8_t* dst, int stride) {
  const __m128i kC = _mm_set1_epi32(kCosPi8Sqrt2Minus1);
  const __m128i kS = _mm_set1_epi32(kSinPi8Sqrt2);
  auto mulshift = [](__m128i v, __m128i k) {
    return _mm_srai_epi32(_mm_mullo_epi32(v, k), 16);
  };
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
  __m128i r0 = _mm_cvtepi16_epi32(
      _mm_loadl_epi64(reinterpret_cast<const __m128i*>(in)));
  __m128i r1 = _mm_cvtepi16_epi32(
      _mm_loadl_epi64(reinterpret_cast<const __m128i*>(in + 4)));
  __m128i r2 = _mm_cvtepi16_epi32(
      _mm_loadl_epi64(reinterpret_cast<const __m128i*>(in + 8)));
  __m128i r3 = _mm_cvtepi16_epi32(
      _mm_loadl_epi64(reinterpret_cast<const __m128i*>(in + 12)));
  // column pass (lane = column index)
  __m128i a1 = _mm_add_epi32(r0, r2);
  __m128i b1 = _mm_sub_epi32(r0, r2);
  __m128i c1 = _mm_sub_epi32(mulshift(r1, kS),
                             _mm_add_epi32(r3, mulshift(r3, kC)));
  __m128i d1 = _mm_add_epi32(_mm_add_epi32(r1, mulshift(r1, kC)),
                             mulshift(r3, kS));
  __m128i m0 = _mm_add_epi32(a1, d1);
  __m128i m3 = _mm_sub_epi32(a1, d1);
  __m128i m1 = _mm_add_epi32(b1, c1);
  __m128i m2 = _mm_sub_epi32(b1, c1);
  transpose(m0, m1, m2, m3);  // lane = row index
  // row pass
  a1 = _mm_add_epi32(m0, m2);
  b1 = _mm_sub_epi32(m0, m2);
  c1 = _mm_sub_epi32(mulshift(m1, kS),
                     _mm_add_epi32(m3, mulshift(m3, kC)));
  d1 = _mm_add_epi32(_mm_add_epi32(m1, mulshift(m1, kC)),
                     mulshift(m3, kS));
  const __m128i k4 = _mm_set1_epi32(4);
  __m128i o0 = _mm_srai_epi32(_mm_add_epi32(_mm_add_epi32(a1, d1), k4), 3);
  __m128i o3 = _mm_srai_epi32(_mm_add_epi32(_mm_sub_epi32(a1, d1), k4), 3);
  __m128i o1 = _mm_srai_epi32(_mm_add_epi32(_mm_add_epi32(b1, c1), k4), 3);
  __m128i o2 = _mm_srai_epi32(_mm_add_epi32(_mm_sub_epi32(b1, c1), k4), 3);
  transpose(o0, o1, o2, o3);  // lane = column index, ok = output row k
  const __m128i rows[4] = {o0, o1, o2, o3};
  for (int r = 0; r < 4; ++r) {
    uint8_t* d = dst + static_cast<size_t>(r) * stride;
    uint32_t px;
    std::memcpy(&px, d, 4);
    const __m128i p = _mm_cvtepu8_epi32(_mm_cvtsi32_si128(static_cast<int>(px)));
    __m128i s = _mm_add_epi32(rows[r], p);
    s = _mm_packus_epi16(_mm_packs_epi32(s, s), s);
    const int out = _mm_cvtsi128_si32(s);
    std::memcpy(d, &out, 4);
  }
}
#else
inline void IdctAdd4x4(const int16_t* in, uint8_t* dst, int stride) {
  int px[16];
  Idct4x4(in, px);
  for (int y = 0; y < 4; ++y)
    for (int x = 0; x < 4; ++x) {
      uint8_t* t = dst + static_cast<size_t>(y) * stride + x;
      *t = Clip255(*t + px[y * 4 + x]);
    }
}
#endif

// Inverse WHT (RFC 6386 §14.3) — scatters the 16 luma DC values.
inline void InvWht4x4(const int16_t* in, int* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a1 = in[0 + i] + in[12 + i];
    const int b1 = in[4 + i] + in[8 + i];
    const int c1 = in[4 + i] - in[8 + i];
    const int d1 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a1 + b1;
    tmp[4 + i] = c1 + d1;
    tmp[8 + i] = a1 - b1;
    tmp[12 + i] = d1 - c1;
  }
  for (int i = 0; i < 4; ++i) {
    const int a1 = tmp[i * 4 + 0] + tmp[i * 4 + 3];
    const int b1 = tmp[i * 4 + 1] + tmp[i * 4 + 2];
    const int c1 = tmp[i * 4 + 1] - tmp[i * 4 + 2];
    const int d1 = tmp[i * 4 + 0] - tmp[i * 4 + 3];
    const int a2 = a1 + b1 + 3;
    const int b2 = c1 + d1;
    const int c2 = a1 - b1;
    const int d2 = d1 - c1;
    out[i * 4 + 0] = a2 >> 3;
    out[i * 4 + 1] = (b2 + 3) >> 3;
    out[i * 4 + 2] = (c2 + 3) >> 3;
    out[i * 4 + 3] = (d2 + 3) >> 3;
  }
}

struct QuantPair {
  uint16_t dc, ac;
};
struct Quantizers {
  QuantPair y1, y2, uv;
};

inline int ClampQ(int v) { return v < 0 ? 0 : (v > 127 ? 127 : v); }

// Dequantiser values for a (possibly delta-adjusted) base index
// (RFC 6386 §14.1). Deltas are per-plane-type index offsets.
inline Quantizers SetupQuantDeltas(int qindex, int y1dc_d, int y2dc_d,
                                   int y2ac_d, int uvdc_d, int uvac_d) {
  Quantizers q;
  q.y1.dc = kDcQLookup[ClampQ(qindex + y1dc_d)];
  q.y1.ac = kAcQLookup[ClampQ(qindex)];
  q.y2.dc = static_cast<uint16_t>(kDcQLookup[ClampQ(qindex + y2dc_d)] * 2);
  {
    int v = (kAcQLookup[ClampQ(qindex + y2ac_d)] * 155) / 100;
    if (v < 8) v = 8;
    q.y2.ac = static_cast<uint16_t>(v);
  }
  {
    int v = kDcQLookup[ClampQ(qindex + uvdc_d)];
    if (v > 132) v = 132;  // chroma DC clamp (RFC 6386 §14.1)
    q.uv.dc = static_cast<uint16_t>(v);
  }
  q.uv.ac = kAcQLookup[ClampQ(qindex + uvac_d)];
  return q;
}

inline Quantizers SetupQuant(int qindex) {
  return SetupQuantDeltas(qindex, 0, 0, 0, 0, 0);
}

// 4x4 sub-block prediction (§12.3). A: 8 above pixels (4 + 4 above-right),
// L: 4 left pixels, AL: above-left. Formulas are the normative per-pixel
// definitions (written out position by position).
inline void PredictB(uint8_t* o, int os, int mode, const uint8_t* A,
              const uint8_t* L, int AL) {
  auto a3 = [](int a, int b, int c) {
    return static_cast<uint8_t>((a + 2 * b + c + 2) >> 2);
  };
  auto a2 = [](int a, int b) { return static_cast<uint8_t>((a + b + 1) >> 1); };
  auto D = [&](int y, int x) -> uint8_t& { return o[y * os + x]; };
  switch (mode) {
    case 0: {  // B_DC: above4 + left4 (borders included for sub-blocks)
      int sum = 4;
      for (int i = 0; i < 4; ++i) sum += A[i] + L[i];
      const int dc = sum >> 3;
      for (int y = 0; y < 4; ++y) std::memset(o + y * os, dc, 4);
      break;
    }
    case 1:  // B_TM
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) D(y, x) = Clip255(L[y] + A[x] - AL);
      break;
    case 2: {  // B_VE
      const uint8_t r[4] = {a3(AL, A[0], A[1]), a3(A[0], A[1], A[2]),
                            a3(A[1], A[2], A[3]), a3(A[2], A[3], A[4])};
      for (int y = 0; y < 4; ++y) std::memcpy(o + y * os, r, 4);
      break;
    }
    case 3: {  // B_HE
      const uint8_t r[4] = {a3(AL, L[0], L[1]), a3(L[0], L[1], L[2]),
                            a3(L[1], L[2], L[3]), a3(L[2], L[3], L[3])};
      for (int y = 0; y < 4; ++y) std::memset(o + y * os, r[y], 4);
      break;
    }
    case 4:  // B_LD (down-left)
      D(0, 0) = a3(A[0], A[1], A[2]);
      D(0, 1) = D(1, 0) = a3(A[1], A[2], A[3]);
      D(0, 2) = D(1, 1) = D(2, 0) = a3(A[2], A[3], A[4]);
      D(0, 3) = D(1, 2) = D(2, 1) = D(3, 0) = a3(A[3], A[4], A[5]);
      D(1, 3) = D(2, 2) = D(3, 1) = a3(A[4], A[5], A[6]);
      D(2, 3) = D(3, 2) = a3(A[5], A[6], A[7]);
      D(3, 3) = a3(A[6], A[7], A[7]);
      break;
    case 5:  // B_RD (down-right)
      D(3, 0) = a3(L[3], L[2], L[1]);
      D(3, 1) = D(2, 0) = a3(L[2], L[1], L[0]);
      D(3, 2) = D(2, 1) = D(1, 0) = a3(L[1], L[0], AL);
      D(3, 3) = D(2, 2) = D(1, 1) = D(0, 0) = a3(L[0], AL, A[0]);
      D(2, 3) = D(1, 2) = D(0, 1) = a3(AL, A[0], A[1]);
      D(1, 3) = D(0, 2) = a3(A[0], A[1], A[2]);
      D(0, 3) = a3(A[1], A[2], A[3]);
      break;
    case 6:  // B_VR (vertical-right)
      D(0, 0) = D(2, 1) = a2(AL, A[0]);
      D(0, 1) = D(2, 2) = a2(A[0], A[1]);
      D(0, 2) = D(2, 3) = a2(A[1], A[2]);
      D(0, 3) = a2(A[2], A[3]);
      D(1, 0) = D(3, 1) = a3(L[0], AL, A[0]);
      D(1, 1) = D(3, 2) = a3(AL, A[0], A[1]);
      D(1, 2) = D(3, 3) = a3(A[0], A[1], A[2]);
      D(1, 3) = a3(A[1], A[2], A[3]);
      D(2, 0) = a3(L[1], L[0], AL);
      D(3, 0) = a3(L[2], L[1], L[0]);
      break;
    case 7:  // B_VL (vertical-left)
      D(0, 0) = a2(A[0], A[1]);
      D(1, 0) = a3(A[0], A[1], A[2]);
      D(2, 0) = D(0, 1) = a2(A[1], A[2]);
      D(1, 1) = D(3, 0) = a3(A[1], A[2], A[3]);
      D(2, 1) = D(0, 2) = a2(A[2], A[3]);
      D(3, 1) = D(1, 2) = a3(A[2], A[3], A[4]);
      D(2, 2) = D(0, 3) = a2(A[3], A[4]);
      D(3, 2) = D(1, 3) = a3(A[3], A[4], A[5]);
      D(2, 3) = a3(A[4], A[5], A[6]);
      D(3, 3) = a3(A[5], A[6], A[7]);
      break;
    case 8:  // B_HD (horizontal-down)
      D(0, 0) = D(1, 2) = a2(AL, L[0]);
      D(0, 1) = D(1, 3) = a3(A[0], AL, L[0]);
      D(0, 2) = a3(A[1], A[0], AL);
      D(0, 3) = a3(A[2], A[1], A[0]);
      D(1, 0) = D(2, 2) = a2(L[0], L[1]);
      D(1, 1) = D(2, 3) = a3(AL, L[0], L[1]);
      D(2, 0) = D(3, 2) = a2(L[1], L[2]);
      D(2, 1) = D(3, 3) = a3(L[0], L[1], L[2]);
      D(3, 0) = a2(L[2], L[3]);
      D(3, 1) = a3(L[1], L[2], L[3]);
      break;
    default:  // B_HU (horizontal-up)
      D(0, 0) = a2(L[0], L[1]);
      D(0, 1) = a3(L[0], L[1], L[2]);
      D(0, 2) = D(1, 0) = a2(L[1], L[2]);
      D(0, 3) = D(1, 1) = a3(L[1], L[2], L[3]);
      D(1, 2) = D(2, 0) = a2(L[2], L[3]);
      D(1, 3) = D(2, 1) = a3(L[2], L[3], L[3]);
      D(2, 2) = D(2, 3) = D(3, 0) = D(3, 1) = D(3, 2) = D(3, 3) = L[3];
      break;
  }
}


// ---------------------------------------------------------------------------
// Intra prediction (RFC 6386 §12). Planes carry a 1-px top/left border:
// data origin at (1, 1); row 0 = 127 (with corner 127), col 0 = 129. Luma
// additionally keeps 4 extra columns on the right for "above-right" reads.
// ---------------------------------------------------------------------------
inline void PredictDc(uint8_t* o, int os, const uint8_t* above, const uint8_t* left,
               int ls, int size, bool have_above, bool have_left) {
  int dc, shift;
  if (have_above || have_left) {
    int sum = 0;
    int total = 0;
    if (have_above) {
      for (int i = 0; i < size; ++i) sum += above[i];
      total += size;
    }
    if (have_left) {
      for (int i = 0; i < size; ++i) sum += left[i * ls];
      total += size;
    }
    shift = (size == 16 ? 4 : 3) + (have_above && have_left ? 1 : 0);
    dc = (sum + (1 << (shift - 1))) >> shift;
    (void)total;
  } else {
    dc = 128;
  }
  for (int y = 0; y < size; ++y) std::memset(o + y * os, dc, size);
}

inline void PredictI16OrChroma(uint8_t* plane, int stride, int px, int py, int size,
                        int mode, bool have_above, bool have_left) {
  uint8_t* o = plane + py * stride + px;
  const uint8_t* above = o - stride;
  const uint8_t* left = o - 1;
  switch (mode) {
    case 0:
      PredictDc(o, stride, above, left, stride, size, have_above, have_left);
      break;
    case 1:  // V
      for (int y = 0; y < size; ++y) std::memcpy(o + y * stride, above, size);
      break;
    case 2:  // H
      for (int y = 0; y < size; ++y)
        std::memset(o + y * stride, left[y * stride], size);
      break;
    default: {  // TM
      const int al = above[-1];
      for (int y = 0; y < size; ++y)
        for (int x = 0; x < size; ++x)
          o[y * stride + x] = Clip255(left[y * stride] + above[x] - al);
      break;
    }
  }
}


}  // namespace ikvp8

#endif  // IK_VP8_COMMON_H_
