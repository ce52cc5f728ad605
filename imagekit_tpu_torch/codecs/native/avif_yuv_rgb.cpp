// YUV -> 8-bit RGB(A) of an AVIF's decoded planes, as libavif 1.3.0's
// avifImageYUVToRGB gives it to Pillow's AVIF plugin (_avif.c: depth 8,
// RGB, or RGBA where the file has alpha, AVIF_CHROMA_UPSAMPLING_AUTOMATIC),
// step for step and byte for byte. The reference decodes every AVIF that
// its native path declines (no nclx, a matrix other than BT.601 / BT.709,
// premultiplied alpha, grids) with Pillow, whose wheel holds libavif 1.3.0
// and, inside it, libyuv; the port has neither.
//
// libavif takes one of two paths:
//
//   (a) libyuv's, where a YuvConstants table covers the matrix and range
//       (avifGetLibYUVConstants: BT.601 incl. unspecified and BT.470BG,
//       BT.709 and BT.2020 NCL, chroma-derived NCL of BT.709 / BT.601 /
//       BT.2020 primaries, the identity matrix of a 4:0:0 picture as
//       BT.601) and a conversion function the picture's depth, layout and
//       output (getLibYUVConversionFunction):
//         - 8 bits: I4xxToRGB24Matrix(Filter) / I4xxAlphaToARGBMatrix
//           (Filter): 16-bit fixed point rows (YuvPixel), chroma of 4:2:0
//           and 4:2:2 upsampled by ScaleRowUp2_Linear / _Bilinear (the
//           "Any" wrappers' edges included);
//         - 10 and 12 bits to RGB, 12-bit 4:2:2 and 4:4:4 to RGBA: each
//           sample shifted down to 8 bits first (avifImageDownshiftTo8bpc,
//           Convert16To8Plane), then the 8-bit rows;
//         - 10 bits to RGBA: I010 / I210 / I410 AlphaToARGBMatrix(Filter)
//           (chroma upsampled at 16 bits, YuvPixel10, alpha >> 2);
//         - 12-bit 4:2:0 to RGBA: I012ToARGBMatrix (nearest chroma,
//           YuvPixel12), alpha by avifReformatAlpha;
//         - 4:0:0 to RGBA: I400ToARGBMatrix (luma shifted to 8 bits);
//           4:0:0 to RGB has no libyuv function;
//   (b) its own, everywhere else, in float: the lookup tables of
//       avifCreateYUVToRGBLookUpTables, kr / kb of avifCalcYUVCoefficients
//       (the nclx primaries' for chroma-derived NCL), identity, YCgCo and
//       Y'CbCr formulas, 9-3-3-1 bilinear chroma of
//       avifImageYUVAnyToRGBAnySlow for 4:2:0 and 4:2:2, and the
//       (uint8_t)(0.5f + x * 255.0f) store; YCgCo-Re (matrix 16, 10-bit
//       full range) on integers. The build compiles this file
//       with -ffp-contract=off, and each expression keeps libavif's order.
//
// Premultiplied alpha (a 'prem' reference) is unmultiplied by libyuv's
// ARGBUnattenuate after the libyuv path and libavif's fast paths, and in
// float, pixel by pixel, inside the slow path (4:2:0 and 4:2:2, and the
// identity, YCgCo and YCgCo-Re matrices but on 8-bit full-range 4:4:4). A
// limited-range alpha plane comes to this file already full range
// (avifLimitedToFullY, in the binding). The matrices libavif refuses
// (avifPrepareReformatState: 3, 10, 11, 13, 14, 17 and above, YCgCo and
// YCgCo-Re at limited range, YCgCo-Re at another depth than 10, identity
// outside 4:4:4 and 4:0:0) answer IK_YUVRGB_REFUSED, the
// caller's "Conversion from YUV failed: Reformat failed".
//
// Every output row depends on its own luma row and at most two chroma
// rows, so rows are converted in bands on threads; the result is the same
// at any thread count.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#define IK_EXPORT extern "C" __attribute__((visibility("default")))

namespace {

enum { IK_YUVRGB_OK = 0, IK_YUVRGB_REFUSED = -1, IK_YUVRGB_BAD = -2 };
enum { I400 = 0, I420 = 1, I422 = 2, I444 = 3 };

// libyuv's YUVCONSTANTSBODY inputs: YG, YB, UB, UG, VG, VR (row_common.cc;
// UB held at 128 for the limited-range tables, as built without
// LIBYUV_UNLIMITED_DATA).
struct Yc {
  int yg, yb, ub, ug, vg, vr;
};
constexpr Yc kI601{18997, -1160, 128, 25, 52, 102};
constexpr Yc kJPEG{16320, 32, 113, 22, 46, 90};
constexpr Yc kH709{18997, -1160, 128, 14, 34, 115};
constexpr Yc kF709{16320, 32, 119, 12, 30, 101};
constexpr Yc k2020{19003, -1160, 128, 12, 42, 107};
constexpr Yc kV2020{16320, 32, 120, 11, 37, 94};

}  // namespace

// The call's arguments (avif_yuv_rgb.py's ctypes mirror of this struct).
struct IkYuvRgb {
  int32_t width, height;
  int32_t depth;       // 8, 10 or 12
  int32_t layout;      // I400 .. I444
  int32_t full_range;  // of the colour planes
  int32_t matrix, primaries;
  int32_t premultiplied;
  int32_t threads;     // 0: one a core
  const void* y;       // uint8_t (8-bit) or uint16_t samples
  const void* u;
  const void* v;
  const void* a;       // full-range alpha at the same depth, or null
  int64_t y_stride, uv_stride, a_stride;  // in samples
};

namespace {

inline uint8_t clamp255(int v) {
  return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
}

// The constants libavif hands to libyuv, or null (avifGetLibYUVConstants).
const Yc* libyuv_constants(const IkYuvRgb& p) {
  int m = p.matrix;
  if (p.layout == I400 && m == 0) m = 6;  // identity on 4:0:0 as BT.601
  int family = 0;  // 1 BT.709, 6 BT.601, 9 BT.2020
  switch (m) {
    case 1: family = 1; break;
    case 2: case 5: case 6: family = 6; break;
    case 9: family = 9; break;
    case 12:
      switch (p.primaries) {
        case 1: case 2: family = 1; break;
        case 5: case 6: family = 6; break;
        case 9: family = 9; break;
        default: break;
      }
      break;
    default: break;
  }
  if (family == 1) return p.full_range ? &kF709 : &kH709;
  if (family == 6) return p.full_range ? &kJPEG : &kI601;
  if (family == 9) return p.full_range ? &kV2020 : &k2020;
  return nullptr;
}

// YuvPixel: luma at 16 bits (y * 0x0101 for 8-bit samples), chroma 8-bit.
inline void yuv_pixel(uint32_t y16, int u, int v, const Yc& k, uint8_t* px) {
  int y1 = (int)((uint32_t)(y16 * (uint32_t)k.yg) >> 16) + k.yb;
  u -= 128;
  v -= 128;
  px[0] = clamp255((y1 + v * k.vr) >> 6);
  px[1] = clamp255((y1 - (u * k.ug + v * k.vg)) >> 6);
  px[2] = clamp255((y1 + u * k.ub) >> 6);
}

// ScaleRowUp2_Linear_Any: a chroma row doubled to w samples.
template <typename T>
void up_linear(const T* s, int w, int* d) {
  d[0] = s[0];
  int work = (w - 1) & ~1;
  for (int x = 0; x < work / 2; ++x) {
    d[1 + 2 * x] = (3 * s[x] + s[x + 1] + 2) >> 2;
    d[2 + 2 * x] = (s[x] + 3 * s[x + 1] + 2) >> 2;
  }
  d[w - 1] = s[(w - 1) / 2];
}

// One of ScaleRowUp2_Bilinear_Any's two rows: near is the chroma row
// weighted 3 vertically, far the one weighted 1.
template <typename T>
void up_bilinear(const T* near, const T* far, int w, int* d) {
  d[0] = (3 * near[0] + far[0] + 2) >> 2;
  int work = (w - 1) & ~1;
  for (int x = 0; x < work / 2; ++x) {
    d[1 + 2 * x] = (near[x] * 9 + near[x + 1] * 3 + far[x] * 3 + far[x + 1]
                    + 8) >> 4;
    d[2 + 2 * x] = (near[x] * 3 + near[x + 1] * 9 + far[x] + far[x + 1] * 3
                    + 8) >> 4;
  }
  int m = (w - 1) / 2;
  d[w - 1] = (3 * near[m] + far[m] + 2) >> 2;
}

// Chroma of output row r on the luma grid, as libyuv's
// I420ToARGBMatrixBilinear / I422ToARGBMatrixLinear reach it: row 0 and
// (for an even height) the last row linear from one chroma row, the rows
// between in pairs from two.
template <typename T>
void chroma_row(const T* c, int64_t stride, int layout, int w, int h, int r,
                int* d) {
  if (layout == I444) {
    const T* s = c + r * stride;
    for (int x = 0; x < w; ++x) d[x] = s[x];
  } else if (layout == I422) {
    up_linear(c + r * stride, w, d);
  } else if (r == 0) {
    up_linear(c, w, d);
  } else if (r & 1) {
    int j = (r - 1) >> 1;
    if (r == h - 1)
      up_linear(c + j * stride, w, d);
    else
      up_bilinear(c + j * stride, c + (j + 1) * stride, w, d);
  } else {
    int j = r >> 1;
    up_bilinear(c + j * stride, c + (j - 1) * stride, w, d);
  }
}

struct Job {
  const IkYuvRgb& p;
  uint8_t* out;
  int ch;  // 3 or 4
};

// ---------------------------------------------------------------------------
// (a) libyuv

// 8-bit samples (or samples shifted down to 8 bits by the caller).
void rows_libyuv8(const Job& j, const Yc& k, const uint8_t* y,
                  const uint8_t* u, const uint8_t* v, const uint8_t* a,
                  int64_t ys, int64_t cs, int64_t as, int r0, int r1) {
  const IkYuvRgb& p = j.p;
  int w = p.width;
  std::vector<int> U(w), V(w);
  for (int r = r0; r < r1; ++r) {
    chroma_row(u, cs, p.layout, w, p.height, r, U.data());
    chroma_row(v, cs, p.layout, w, p.height, r, V.data());
    const uint8_t* yr = y + r * ys;
    uint8_t* o = j.out + (int64_t)r * w * j.ch;
    for (int x = 0; x < w; ++x, o += j.ch) {
      yuv_pixel(yr[x] * 0x0101u, U[x], V[x], k, o);
      if (j.ch == 4) o[3] = a[r * as + x];
    }
  }
}

// I400ToARGBMatrix's YPixel.
void rows_i400(const Job& j, const Yc& k, const uint8_t* y, int64_t ys,
               int r0, int r1) {
  int w = j.p.width;
  for (int r = r0; r < r1; ++r) {
    const uint8_t* yr = y + r * ys;
    uint8_t* o = j.out + (int64_t)r * w * j.ch;
    for (int x = 0; x < w; ++x, o += j.ch) {
      uint32_t y1 = (uint32_t)(yr[x] * 0x0101u * (uint32_t)k.yg) >> 16;
      o[0] = o[1] = o[2] = clamp255(((int)y1 + k.yb) >> 6);
    }
  }
}

// I010/I210/I410 AlphaToARGBMatrix(Filter) and I012ToARGBMatrix: luma at
// 16 bits ((y << 6) | (y >> 4) for 10 bits, (y << 4) | (y >> 8) for 12),
// chroma upsampled at the samples' depth (bilinear for 10 bits, nearest
// for 12) and then shifted to 8 bits.
void rows_libyuv16(const Job& j, const Yc& k, int r0, int r1) {
  const IkYuvRgb& p = j.p;
  int w = p.width, s = p.depth - 8;
  const uint16_t* y = (const uint16_t*)p.y;
  const uint16_t* u = (const uint16_t*)p.u;
  const uint16_t* v = (const uint16_t*)p.v;
  std::vector<int> U(w), V(w);
  for (int r = r0; r < r1; ++r) {
    if (p.depth == 10) {
      chroma_row(u, p.uv_stride, p.layout, w, p.height, r, U.data());
      chroma_row(v, p.uv_stride, p.layout, w, p.height, r, V.data());
    } else {  // nearest (4:2:0 only takes this row)
      const uint16_t* ur = u + (r >> 1) * p.uv_stride;
      const uint16_t* vr = v + (r >> 1) * p.uv_stride;
      for (int x = 0; x < w; ++x) {
        U[x] = ur[x >> 1];
        V[x] = vr[x >> 1];
      }
    }
    const uint16_t* yr = y + r * p.y_stride;
    uint8_t* o = j.out + (int64_t)r * w * j.ch;
    for (int x = 0; x < w; ++x, o += j.ch) {
      uint32_t yy = yr[x];
      uint32_t y16 = p.depth == 10 ? (yy << 6) | (yy >> 4)
                                   : (yy << 4) | (yy >> 8);
      yuv_pixel(y16, clamp255(U[x] >> s), clamp255(V[x] >> s), k, o);
    }
  }
}

// ---------------------------------------------------------------------------
// (b) libavif's own, in float

struct FloatState {
  std::vector<float> tY, tUV;
  int mode;  // 0 Y'CbCr coefficients, 1 identity, 2 YCgCo, 3 YCgCo-Re
  float kr, kg, kb;
  uint16_t max;
};

// avifColorPrimariesGetValues (BT.709's where the table has no entry).
void primaries_xy(int cp, float v[8]) {
  static const struct {
    int cp;
    float v[8];
  } table[] = {
      {1, {0.64f, 0.33f, 0.3f, 0.6f, 0.15f, 0.06f, 0.3127f, 0.329f}},
      {4, {0.67f, 0.33f, 0.21f, 0.71f, 0.14f, 0.08f, 0.310f, 0.316f}},
      {5, {0.64f, 0.33f, 0.29f, 0.60f, 0.15f, 0.06f, 0.3127f, 0.3290f}},
      {6, {0.630f, 0.340f, 0.310f, 0.595f, 0.155f, 0.070f, 0.3127f,
           0.3290f}},
      {7, {0.630f, 0.340f, 0.310f, 0.595f, 0.155f, 0.070f, 0.3127f,
           0.3290f}},
      {8, {0.681f, 0.319f, 0.243f, 0.692f, 0.145f, 0.049f, 0.310f, 0.316f}},
      {9, {0.708f, 0.292f, 0.170f, 0.797f, 0.131f, 0.046f, 0.3127f,
           0.3290f}},
      {10, {1.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f, 0.3333f, 0.3333f}},
      {11, {0.680f, 0.320f, 0.265f, 0.690f, 0.150f, 0.060f, 0.314f,
            0.351f}},
      {12, {0.680f, 0.320f, 0.265f, 0.690f, 0.150f, 0.060f, 0.3127f,
            0.3290f}},
      {22, {0.630f, 0.340f, 0.295f, 0.605f, 0.155f, 0.077f, 0.3127f,
            0.3290f}},
  };
  for (const auto& t : table)
    if (t.cp == cp) {
      std::memcpy(v, t.v, sizeof t.v);
      return;
    }
  std::memcpy(v, table[0].v, sizeof table[0].v);
}

// avifCalcYUVCoefficients (colr.c), BT.601's where no table row applies
// (matrix 15, which libavif converts all the same).
void yuv_coefficients(int matrix, int primaries, float* kr, float* kg,
                      float* kb) {
  float r = 0.299f, b = 0.114f;
  switch (matrix) {
    case 1: r = 0.2126f; b = 0.0722f; break;
    case 4: r = 0.30f; b = 0.11f; break;
    case 5: r = 0.299f; b = 0.114f; break;
    case 6: r = 0.299f; b = 0.144f; break;  // libavif's table, as it is
    case 7: r = 0.212f; b = 0.087f; break;
    case 9: r = 0.2627f; b = 0.0593f; break;
    case 12: {
      float p[8];
      primaries_xy(primaries, p);
      const float rX = p[0], rY = p[1], gX = p[2], gY = p[3], bX = p[4],
                  bY = p[5], wX = p[6], wY = p[7];
      const float rZ = 1.0f - (rX + rY);
      const float gZ = 1.0f - (gX + gY);
      const float bZ = 1.0f - (bX + bY);
      const float wZ = 1.0f - (wX + wY);
      r = (rY * (wX * (gY * bZ - bY * gZ) + wY * (bX * gZ - gX * bZ) +
                 wZ * (gX * bY - bX * gY))) /
          (wY * (rX * (gY * bZ - bY * gZ) + gX * (bY * rZ - rY * bZ) +
                 bX * (rY * gZ - gY * rZ)));
      b = (bY * (wX * (rY * gZ - gY * rZ) + wY * (gX * rZ - rX * gZ) +
                 wZ * (rX * gY - gX * rY))) /
          (wY * (rX * (gY * bZ - bY * gZ) + gX * (bY * rZ - rY * bZ) +
                 bX * (rY * gZ - gY * rZ)));
      break;
    }
    default: break;
  }
  *kr = r;
  *kb = b;
  *kg = 1.0f - r - b;
}

FloatState float_state(const IkYuvRgb& p) {
  FloatState st;
  st.mode = p.matrix == 0 ? 1 : p.matrix == 8 ? 2 : p.matrix == 16 ? 3 : 0;
  st.max = (uint16_t)((1 << p.depth) - 1);
  float biasY, rangeY, rangeUV;
  if (!p.full_range) {
    biasY = (float)(16 << (p.depth - 8));
    rangeY = (float)(219 << (p.depth - 8));
    rangeUV = (float)(224 << (p.depth - 8));
  } else {
    biasY = 0.0f;
    rangeY = (float)st.max;
    rangeUV = rangeY;
  }
  float biasUV = (float)(1 << (p.depth - 1));
  int n = 1 << p.depth;
  st.tY.resize(n);
  st.tUV.resize(n);
  for (int cp = 0; cp < n; ++cp) {
    st.tY[cp] = ((float)cp - biasY) / rangeY;
    st.tUV[cp] = st.mode == 1 ? st.tY[cp] : ((float)cp - biasUV) / rangeUV;
  }
  st.kr = st.kg = st.kb = 0.0f;
  if (st.mode == 0) yuv_coefficients(p.matrix, p.primaries, &st.kr, &st.kg,
                                     &st.kb);
  return st;
}

template <typename T>
void rows_float(const Job& j, const FloatState& st, bool unmultiply, int r0,
                int r1) {
  const IkYuvRgb& p = j.p;
  const T* Yp = (const T*)p.y;
  const T* Up = (const T*)p.u;
  const T* Vp = (const T*)p.v;
  const T* Ap = (const T*)p.a;
  const int w = p.width, h = p.height;
  const bool color = p.layout != I400;
  const int sx = (p.layout == I420 || p.layout == I422) ? 1 : 0;
  const int sy = p.layout == I420 ? 1 : 0;
  const float kr = st.kr, kg = st.kg, kb = st.kb;
  const float* tY = st.tY.data();
  const float* tUV = st.tUV.data();
  const uint16_t mx = st.max;
  auto at = [&](const T* plane, int64_t stride, int row, int col) {
    return tUV[std::min<uint16_t>(plane[row * stride + col], mx)];
  };
  for (int jr = r0; jr < r1; ++jr) {
    const int uvJ = color ? jr >> sy : 0;
    uint8_t* o = j.out + (int64_t)jr * w * j.ch;
    for (int i = 0; i < w; ++i, o += j.ch) {
      float Y = tY[std::min<uint16_t>(Yp[jr * p.y_stride + i], mx)];
      float Cb = 0.5f, Cr = 0.5f;
      if (color) {
        const int uvI = i >> sx;
        if (p.layout == I444) {
          Cb = at(Up, p.uv_stride, uvJ, uvI);
          Cr = at(Vp, p.uv_stride, uvJ, uvI);
        } else {
          int adjCol, adjRow;
          if (i == 0 || (i == w - 1 && (i % 2) != 0))
            adjCol = 0;
          else
            adjCol = (i % 2) != 0 ? 1 : -1;
          if (jr == 0 || (jr == h - 1 && (jr % 2) != 0) ||
              p.layout == I422)
            adjRow = 0;
          else
            adjRow = (jr % 2) != 0 ? 1 : -1;
          Cb = (at(Up, p.uv_stride, uvJ, uvI) * (9.0f / 16.0f)) +
               (at(Up, p.uv_stride, uvJ, uvI + adjCol) * (3.0f / 16.0f)) +
               (at(Up, p.uv_stride, uvJ + adjRow, uvI) * (3.0f / 16.0f)) +
               (at(Up, p.uv_stride, uvJ + adjRow, uvI + adjCol) *
                (1.0f / 16.0f));
          Cr = (at(Vp, p.uv_stride, uvJ, uvI) * (9.0f / 16.0f)) +
               (at(Vp, p.uv_stride, uvJ, uvI + adjCol) * (3.0f / 16.0f)) +
               (at(Vp, p.uv_stride, uvJ + adjRow, uvI) * (3.0f / 16.0f)) +
               (at(Vp, p.uv_stride, uvJ + adjRow, uvI + adjCol) *
                (1.0f / 16.0f));
        }
      }
      float R, G, B;
      if (!color) {
        R = G = B = Y;
      } else if (st.mode == 1) {
        G = Y;
        B = Cb;
        R = Cr;
      } else if (st.mode == 2) {
        const float t = Y - Cb;
        G = Y + Cb;
        B = t - Cr;
        R = t + Cr;
      } else if (st.mode == 3) {
        // YCgCo-Re (H.273 formulas 58-61) on integers, 8-bit RGB from
        // 10-bit samples: B is clamped before R is formed from it
        const int YY = std::min<uint16_t>(Yp[jr * p.y_stride + i], mx);
        const int Cg = (int)std::floor(Cb * (float)mx + 0.5f);
        const int Co = (int)std::floor(Cr * (float)mx + 0.5f);
        const int t = YY - (Cg >> 1);
        const int g = std::min(std::max(t + Cg, 0), 255);
        const int b = std::min(std::max(t - (Co >> 1), 0), 255);
        const int r = std::min(std::max(b + Co, 0), 255);
        G = (float)g / 255.0f;
        B = (float)b / 255.0f;
        R = (float)r / 255.0f;
      } else {
        R = Y + (2 * (1 - kr)) * Cr;
        B = Y + (2 * (1 - kb)) * Cb;
        G = Y - ((2 * ((kr * (1 - kr) * Cr) + (kb * (1 - kb) * Cb))) / kg);
      }
      float Rc = std::min(std::max(R, 0.0f), 1.0f);
      float Gc = std::min(std::max(G, 0.0f), 1.0f);
      float Bc = std::min(std::max(B, 0.0f), 1.0f);
      if (unmultiply) {
        const uint16_t unormA = std::min<uint16_t>(Ap[jr * p.a_stride + i],
                                                   mx);
        const float A = unormA / ((float)mx);
        const float Ac = std::min(std::max(A, 0.0f), 1.0f);
        if (Ac == 0.0f) {
          Rc = Gc = Bc = 0.0f;
        } else if (Ac < 1.0f) {
          Rc /= Ac;
          Gc /= Ac;
          Bc /= Ac;
          Rc = std::min(Rc, 1.0f);
          Gc = std::min(Gc, 1.0f);
          Bc = std::min(Bc, 1.0f);
        }
      }
      o[0] = (uint8_t)(0.5f + (Rc * 255.0f));
      o[1] = (uint8_t)(0.5f + (Gc * 255.0f));
      o[2] = (uint8_t)(0.5f + (Bc * 255.0f));
    }
  }
}

// avifReformatAlpha into 8 bits: a copy, or 0.5f + a / max * 255.
template <typename T>
void rows_alpha(const Job& j, int r0, int r1) {
  const IkYuvRgb& p = j.p;
  const T* Ap = (const T*)p.a;
  const int mx = (1 << p.depth) - 1;
  const float maxF = (float)mx;
  for (int r = r0; r < r1; ++r) {
    uint8_t* o = j.out + (int64_t)r * p.width * 4 + 3;
    for (int x = 0; x < p.width; ++x, o += 4) {
      int a = std::min<int>(Ap[r * p.a_stride + x], mx);
      if (p.depth == 8) {
        *o = (uint8_t)a;
      } else {
        const float alphaF = (float)a / maxF;
        int d = (int)(0.5f + (alphaF * 255.0f));
        *o = (uint8_t)std::min(std::max(d, 0), 255);
      }
    }
  }
}

// libyuv's ARGBUnattenuate (the x86 rows' arithmetic): 8.8 reciprocals
// of fixed_invtbl8, the colour widened to 16 bits before the multiply
// (pmulhuw), packed with signed saturation (packuswb): a product past
// 32767, which only alpha 1 gives, comes out 0.
void rows_unattenuate(const Job& j, int r0, int r1) {
  for (int r = r0; r < r1; ++r) {
    uint8_t* o = j.out + (int64_t)r * j.p.width * 4;
    for (int x = 0; x < j.p.width; ++x, o += 4) {
      uint32_t a = o[3];
      uint32_t ia = a == 0 ? 0 : a == 1 ? 0xffff : a == 255 ? 0x100
                                                             : 0x10000 / a;
      for (int c = 0; c < 3; ++c) {
        uint32_t f = o[c];
        uint32_t v = ((f | (f << 8)) * ia) >> 16;
        o[c] = (uint8_t)(v > 32767 ? 0 : v > 255 ? 255 : v);
      }
    }
  }
}

// fn(r0, r1) over bands of 32 rows, on up to p.threads threads (0: one a
// core), this one included.
template <typename F>
void bands(const IkYuvRgb& p, F fn) {
  int most = p.threads;
  if (most <= 0) most = std::max(1u, std::thread::hardware_concurrency());
  const int rows_per = 32;
  const int n = (p.height + rows_per - 1) / rows_per;
  int workers = std::min(n, most);
  std::atomic<int> next{0};
  auto work = [&]() {
    for (int i; (i = next.fetch_add(1)) < n;)
      fn(i * rows_per, std::min(p.height, (i + 1) * rows_per));
  };
  std::vector<std::thread> pool;
  for (int i = 1; i < workers; ++i) pool.emplace_back(work);
  work();
  for (std::thread& t : pool) t.join();
}

// Convert16To8Plane(scale = 1 << (24 - depth)): v >> (depth - 8).
void downshift(const uint16_t* src, int64_t stride, int w, int h, int s,
               std::vector<uint8_t>& dst) {
  dst.resize((size_t)w * h);
  for (int r = 0; r < h; ++r)
    for (int x = 0; x < w; ++x)
      dst[(size_t)r * w + x] = clamp255(src[r * stride + x] >> s);
}

bool refused(const IkYuvRgb& p) {
  const int m = p.matrix;
  if (m == 3 || m == 10 || m == 11 || m == 13 || m == 14 || m >= 17)
    return true;
  if ((m == 8 || m == 16) && !p.full_range) return true;
  if (m == 16 && p.depth != 10) return true;  // YCgCo-Re: RGB depth + 2
  if (m == 0 && p.layout != I444 && p.layout != I400) return true;
  return false;
}

int convert(const IkYuvRgb& p, uint8_t* out) {
  if (p.width <= 0 || p.height <= 0 || !p.y ||
      (p.depth != 8 && p.depth != 10 && p.depth != 12) || p.layout < 0 ||
      p.layout > 3 || (p.layout != I400 && (!p.u || !p.v)) ||
      (p.premultiplied && !p.a))
    return IK_YUVRGB_BAD;
  if (refused(p)) return IK_YUVRGB_REFUSED;
  const bool alpha = p.a != nullptr;
  Job j{p, out, alpha ? 4 : 3};
  const int w = p.width, h = p.height;
  const int cw = p.layout == I444 ? w : (w + 1) / 2;
  const int chh = p.layout == I420 ? (h + 1) / 2 : h;
  const Yc* k = libyuv_constants(p);
  bool unattenuate = false;
  if (k && p.layout == I400 && alpha) {
    // I400ToARGBMatrix, then the alpha plane
    std::vector<uint8_t> y8;
    const uint8_t* y = (const uint8_t*)p.y;
    int64_t ys = p.y_stride;
    if (p.depth > 8) {
      downshift((const uint16_t*)p.y, p.y_stride, w, h, p.depth - 8, y8);
      y = y8.data();
      ys = w;
    }
    bands(p, [&](int r0, int r1) {
      rows_i400(j, *k, y, ys, r0, r1);
      if (p.depth == 8) rows_alpha<uint8_t>(j, r0, r1);
      else rows_alpha<uint16_t>(j, r0, r1);
    });
    unattenuate = p.premultiplied;
  } else if (k && p.layout != I400 && p.depth == 10 && alpha) {
    bands(p, [&](int r0, int r1) {
      rows_libyuv16(j, *k, r0, r1);
      const uint16_t* a = (const uint16_t*)p.a;
      for (int r = r0; r < r1; ++r)
        for (int x = 0; x < w; ++x)
          out[((int64_t)r * w + x) * 4 + 3] = clamp255(a[r * p.a_stride + x]
                                                       >> 2);
    });
    unattenuate = p.premultiplied;
  } else if (k && p.layout == I420 && p.depth == 12 && alpha) {
    bands(p, [&](int r0, int r1) {
      rows_libyuv16(j, *k, r0, r1);
      rows_alpha<uint16_t>(j, r0, r1);
    });
    unattenuate = p.premultiplied;
  } else if (k && p.layout != I400) {
    // 8-bit rows, on samples shifted to 8 bits where they are deeper
    std::vector<uint8_t> y8, u8, v8, a8;
    const uint8_t *y = (const uint8_t*)p.y, *u = (const uint8_t*)p.u,
                  *v = (const uint8_t*)p.v, *a = (const uint8_t*)p.a;
    int64_t ys = p.y_stride, cs = p.uv_stride, as = p.a_stride;
    if (p.depth > 8) {
      const int s = p.depth - 8;
      downshift((const uint16_t*)p.y, p.y_stride, w, h, s, y8);
      downshift((const uint16_t*)p.u, p.uv_stride, cw, chh, s, u8);
      downshift((const uint16_t*)p.v, p.uv_stride, cw, chh, s, v8);
      y = y8.data();
      u = u8.data();
      v = v8.data();
      ys = w;
      cs = cw;
      if (alpha) {
        downshift((const uint16_t*)p.a, p.a_stride, w, h, s, a8);
        a = a8.data();
        as = w;
      }
    }
    bands(p, [&](int r0, int r1) {
      rows_libyuv8(j, *k, y, u, v, a, ys, cs, as, r0, r1);
    });
    unattenuate = p.premultiplied;
  } else {
    FloatState st = float_state(p);
    // libavif's fast paths (Y'CbCr of 4:4:4 and 4:0:0, identity of 8-bit
    // full-range 4:4:4) leave premultiplied alpha to ARGBUnattenuate; its
    // slow path unmultiplies in float itself
    const bool fast =
        (st.mode == 0 && (p.layout == I444 || p.layout == I400)) ||
        (st.mode == 1 && p.depth == 8 && p.layout == I444 && p.full_range);
    const bool slow = !fast;
    const bool inline_unmultiply = slow && p.premultiplied;
    bands(p, [&](int r0, int r1) {
      if (alpha) {
        if (p.depth == 8) rows_alpha<uint8_t>(j, r0, r1);
        else rows_alpha<uint16_t>(j, r0, r1);
      }
      if (p.depth == 8)
        rows_float<uint8_t>(j, st, inline_unmultiply, r0, r1);
      else
        rows_float<uint16_t>(j, st, inline_unmultiply, r0, r1);
    });
    unattenuate = p.premultiplied && !slow;
  }
  if (unattenuate)
    bands(p, [&](int r0, int r1) { rows_unattenuate(j, r0, r1); });
  return IK_YUVRGB_OK;
}

}  // namespace

IK_EXPORT int ik_yuvrgb_args_size() { return (int)sizeof(IkYuvRgb); }

// The picture of ``args`` into ``out`` (height x width x 3, or x 4 with
// an alpha plane): IK_YUVRGB_OK, IK_YUVRGB_REFUSED for a matrix libavif
// refuses, IK_YUVRGB_BAD for arguments out of range.
IK_EXPORT int ik_yuvrgb_convert(const IkYuvRgb* args, uint8_t* out) {
  if (!args || !out) return IK_YUVRGB_BAD;
  return convert(*args, out);
}

