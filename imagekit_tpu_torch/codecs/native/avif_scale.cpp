// One plane of an AVIF item rescaled to its 'ispe' as libavif 1.3.0's
// avifImageScaleWithLimit rescales it for Pillow: libyuv's ScalePlane
// (8-bit samples) or ScalePlane_12 (10 and 12 bits) with kFilterBox, step
// for step and byte for byte. The reference decodes such an item (its
// stream is not the size its ispe says) with Pillow, whose libavif has
// libyuv inside; the port has neither.
//
// ScalePlane first reduces the filter (ScaleFilterReduce): box stays box
// only where both axes shrink below a half; otherwise bilinear, which
// becomes linear where the height is kept or shrinks by three (or the
// source is one row), and linear becomes none where the width is kept or
// shrinks by three. Then it takes one of these paths, by the ratio:
//
//   copy                 the same size;
//   vertical             the same width: InterpolateRow between two rows;
//   3/4, 1/2, 3/8, 1/4   both axes by that ratio: fixed-weight rows
//                        (ScalePlaneDown34 / Down2 / Down38 / Down4);
//   box                  both axes below a half: the mean of each source
//                        box (ScaleAddRow, ScaleAddCols*, 16.16 steps);
//   2x up                (w + 1) / 2 and (h + 1) / 2 of the target:
//                        9-3-3-1 rows (ScaleRowUp2_Bilinear), or 3-1
//                        where only the width doubles (ScaleRowUp2_Linear);
//   bilinear up          columns filtered first (ScaleFilterCols), then
//                        two of those rows blended (InterpolateRow);
//   bilinear down        two source rows blended first, then columns;
//   simple               point sampling.
//
// The 8-bit rows are those of the x86 build Pillow's wheel carries (SSSE3
// and AVX2): ScaleFilterCols blends with 7-bit fractions ((f >> 9), + 64,
// >> 7) where the 16-bit one blends with 16-bit fractions; the 3/4 rows
// and the 2-row 3/8 row of SSSE3 average the two source rows first
// (pavgb, then a 3-1 weighting as pavgb(s, pavgb(s, t))) and filter
// across after, where libyuv's C rows filter across first: the SSSE3 rows
// run over the largest multiple of 24 (3/4) or 6 (3/8) output samples, the
// C rows over the rest (libyuv's _Any_ wrappers). Every other 8-bit SIMD
// row libyuv takes there computes what its C row computes.
//
// Every output row is computed from its own index alone (the steps of a
// path are a function of the row), so bands of rows run on threads; the
// result is the same at any thread count.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#define IK_EXPORT extern "C" __attribute__((visibility("default")))

namespace {

enum Filter { kNone = 0, kLinear = 1, kBilinear = 2, kBox = 3 };

inline int fixed_div(int num, int div) {
  return (int)(((int64_t)num << 16) / div);
}
inline int fixed_div1(int num, int div) {
  return (int)((((int64_t)num << 16) - 0x00010001) / (div - 1));
}
inline int center_start(int dx, int s) {
  return dx < 0 ? -((-dx >> 1) + s) : ((dx >> 1) + s);
}
inline int min1(int x) { return x < 1 ? 1 : x; }

Filter reduce_filter(int sw, int sh, int dw, int dh, Filter f) {
  if (f == kBox && (dw * 2 >= sw || dh * 2 >= sh)) f = kBilinear;
  if (f == kBilinear) {
    if (sh == 1) f = kLinear;
    if (dh == sh || dh * 3 == sh) f = kLinear;
    if (sw == 1) f = kNone;
  }
  if (f == kLinear) {
    if (sw == 1) f = kNone;
    if (dw == sw || dw * 3 == sw) f = kNone;
  }
  return f;
}

// ScaleSlope: the 16.16 start and step of each axis
void slope(int sw, int sh, int dw, int dh, Filter f, int* x, int* y, int* dx,
           int* dy) {
  if (dw == 1 && sw >= 32768) dw = sw;
  if (dh == 1 && sh >= 32768) dh = sh;
  if (f == kBox) {
    *dx = fixed_div(sw, dw);
    *dy = fixed_div(sh, dh);
    *x = 0;
    *y = 0;
  } else if (f == kBilinear || f == kLinear) {
    if (dw <= sw) {
      *dx = fixed_div(sw, dw);
      *x = center_start(*dx, -32768);
    } else if (sw > 1 && dw > 1) {
      *dx = fixed_div1(sw, dw);
      *x = 0;
    }
    if (f == kLinear) {
      *dy = fixed_div(sh, dh);
      *y = *dy >> 1;
    } else if (dh <= sh) {
      *dy = fixed_div(sh, dh);
      *y = center_start(*dy, -32768);
    } else if (sh > 1 && dh > 1) {
      *dy = fixed_div1(sh, dh);
      *y = 0;
    }
  } else {
    *dx = fixed_div(sw, dw);
    *dy = fixed_div(sh, dh);
    *x = center_start(*dx, 0);
    *y = center_start(*dy, 0);
  }
}

template <typename T>
struct Scaler {
  const T* src;
  int64_t ss;  // source stride, samples
  int sw, sh;
  T* dst;
  int64_t ds;
  int dw, dh;
  int cw, ch;  // the top-left crop of the scaled plane that is written
  Filter f = kBox;
  static constexpr bool k8 = sizeof(T) == 1;

  const T* row(int i) const { return src + (int64_t)i * ss; }
  // a source row index clamped to the plane
  const T* crow(int i) const { return row(std::min(std::max(i, 0), sh - 1)); }

  // InterpolateRow: (a * (256 - f) + b * f + 128) >> 8; f 0 copies, f 128
  // averages (HalfRow); the SSSE3 / AVX2 8-bit rows compute the same
  static void interpolate(T* d, const T* a, const T* b, int n, int f) {
    if (f == 0) {
      memcpy(d, a, n * sizeof(T));
      return;
    }
    if (f == 128) {
      for (int i = 0; i < n; ++i) d[i] = (T)((a[i] + b[i] + 1) >> 1);
      return;
    }
    int f0 = 256 - f;
    for (int i = 0; i < n; ++i)
      d[i] = (T)((a[i] * f0 + b[i] * f + 128) >> 8);
  }

  static inline T blend(int a, int b, int x) {
    if (k8) return (T)(a + ((((x & 0xffff) >> 9) * (b - a) + 0x40) >> 7));
    return (T)(a + (int)(((int64_t)(x & 0xffff) * ((int64_t)b - a) + 0x8000)
                         >> 16));
  }

  // ScaleFilterCols over a row of `n` samples (b clamped at the end: its
  // weight is 0 wherever libyuv reads one past the row)
  static void filter_cols(T* d, const T* s, int n, int dwid, int x, int dx) {
    for (int j = 0; j < dwid; ++j, x += dx) {
      int xi = x >> 16;
      int a = s[xi], b = s[std::min(xi + 1, n - 1)];
      d[j] = blend(a, b, x);
    }
  }

  // -- the paths, one output row each -----------------------------------

  void vertical_row(T* d, int j, int y0, int dy) const {
    const int max_y = sh > 1 ? ((sh - 1) << 16) - 1 : 0;
    int64_t y = std::min<int64_t>((int64_t)y0 + (int64_t)j * dy, max_y);
    int yi = (int)(y >> 16);
    int yf = f != kNone ? (int)((y >> 8) & 255) : 0;
    interpolate(d, row(yi), crow(yi + 1), dw, yf);
  }

  // ScaleRowDown2Box / ScaleRowDown2Linear / ScaleRowDown2 (point: the
  // odd sample of the odd row)
  void down2_row(T* d, int j) const {
    const T* s = row(2 * j);
    const T* t = row(2 * j + 1);
    for (int i = 0; i < dw; ++i) {
      if (f == kNone)
        d[i] = t[2 * i + 1];
      else if (f == kLinear)
        d[i] = (T)((s[2 * i] + s[2 * i + 1] + 1) >> 1);
      else
        d[i] = (T)((s[2 * i] + s[2 * i + 1] + t[2 * i] + t[2 * i + 1] + 2)
                   >> 2);
    }
  }

  void down4_row(T* d, int j) const {
    if (f == kNone) {
      const T* s = row(4 * j + 2);
      for (int i = 0; i < dw; ++i) d[i] = s[4 * i + 2];
      return;
    }
    for (int i = 0; i < dw; ++i) {
      uint32_t sum = 0;
      for (int r = 0; r < 4; ++r)
        for (int c = 0; c < 4; ++c) sum += row(4 * j + r)[4 * i + c];
      d[i] = (T)((sum + 8) >> 4);
    }
  }

  // 3/4: 4 samples to 3 along a row; `kind` 0 weights row s 3 to row t's
  // 1, kind 1 weights them 1 to 1
  void down34(T* d, const T* s, const T* t, int kind) const {
    int simd = k8 ? dw - dw % 24 : 0;
    for (int x = 0; x < dw; x += 3) {
      const T* a = s + x / 3 * 4;
      const T* b = t + x / 3 * 4;
      if (f == kNone) {
        d[x] = a[0];
        d[x + 1] = a[1];
        d[x + 2] = a[3];
        continue;
      }
      if (x < simd) {  // SSSE3: rows first (pavgb), then across
        int r[4];
        for (int k = 0; k < 4; ++k) {
          int m = (a[k] + b[k] + 1) >> 1;
          r[k] = kind == 0 ? (a[k] + m + 1) >> 1 : m;
        }
        d[x] = (T)((3 * r[0] + r[1] + 2) >> 2);
        d[x + 1] = (T)((2 * r[1] + 2 * r[2] + 2) >> 2);
        d[x + 2] = (T)((r[2] + 3 * r[3] + 2) >> 2);
        continue;
      }
      T a0 = (T)((a[0] * 3 + a[1] + 2) >> 2);
      T a1 = (T)((a[1] + a[2] + 1) >> 1);
      T a2 = (T)((a[2] + a[3] * 3 + 2) >> 2);
      T b0 = (T)((b[0] * 3 + b[1] + 2) >> 2);
      T b1 = (T)((b[1] + b[2] + 1) >> 1);
      T b2 = (T)((b[2] + b[3] * 3 + 2) >> 2);
      if (kind == 0) {
        d[x] = (T)((a0 * 3 + b0 + 2) >> 2);
        d[x + 1] = (T)((a1 * 3 + b1 + 2) >> 2);
        d[x + 2] = (T)((a2 * 3 + b2 + 2) >> 2);
      } else {
        d[x] = (T)((a0 + b0 + 1) >> 1);
        d[x + 1] = (T)((a1 + b1 + 1) >> 1);
        d[x + 2] = (T)((a2 + b2 + 1) >> 1);
      }
    }
  }

  // ScalePlaneDown34's rows: three output rows of each four source rows,
  // the last one or two unfiltered down (stride 0)
  void down34_row(T* d, int j) const {
    int groups = dh >= 3 ? (dh - 3) / 3 + 1 : 0;  // `y < dst_height - 2`
    int g = j / 3, k = j % 3;
    bool vf = f != kLinear;  // filter_stride 0 under the linear filter
    if (g < groups) {
      int base = 4 * g;
      if (k == 0)
        down34(d, row(base), vf ? row(base + 1) : row(base), 0);
      else if (k == 1)
        down34(d, row(base + 1), vf ? row(base + 2) : row(base + 1), 1);
      else
        down34(d, row(base + 3), vf ? row(base + 2) : row(base + 3), 0);
      return;
    }
    int base = 4 * groups;
    if (dh % 3 == 2) {
      if (k == 0)
        down34(d, crow(base), vf ? crow(base + 1) : crow(base), 0);
      else
        down34(d, crow(base + 1), crow(base + 1), 1);
    } else {
      down34(d, crow(base), crow(base), 0);
    }
  }

  // 3/8: 8 samples to 3 along a row, over `rows` rows (3 or 2)
  void down38(T* d, const T* s, int64_t st, int rows) const {
    int simd = k8 && rows == 2 ? dw - dw % 6 : 0;
    for (int x = 0; x < dw; x += 3) {
      const T* p = s + x / 3 * 8;
      if (f == kNone) {
        d[x] = p[0];
        d[x + 1] = p[3];
        d[x + 2] = p[6];
        continue;
      }
      if (x < simd) {  // SSSE3: rows averaged first (pavgb)
        int r[8];
        for (int k = 0; k < 8; ++k) r[k] = (p[k] + p[st + k] + 1) >> 1;
        d[x] = (T)(((uint32_t)(r[0] + r[1] + r[2]) * (65536 / 3)) >> 16);
        d[x + 1] = (T)(((uint32_t)(r[3] + r[4] + r[5]) * (65536 / 3)) >> 16);
        d[x + 2] = (T)(((uint32_t)(r[6] + r[7]) * (65536 / 2)) >> 16);
        continue;
      }
      uint32_t s0 = 0, s1 = 0, s2 = 0;
      for (int r = 0; r < rows; ++r) {
        const T* q = p + r * st;
        s0 += q[0] + q[1] + q[2];
        s1 += q[3] + q[4] + q[5];
        s2 += q[6] + q[7];
      }
      uint32_t n3 = 3u * rows, n2 = 2u * rows;
      d[x] = (T)((s0 * (65536u / n3)) >> 16);
      d[x + 1] = (T)((s1 * (65536u / n3)) >> 16);
      d[x + 2] = (T)((s2 * (65536u / n2)) >> 16);
    }
  }

  void down38_row(T* d, int j, std::vector<T>& tmp) const {
    int groups = dh >= 3 ? (dh - 3) / 3 + 1 : 0;
    int g = j / 3, k = j % 3;
    bool vf = f != kLinear;
    auto rows_at = [&](int first, int n, bool filtered) {
      // the n rows from `first`, each clamped to the plane, or one row
      // n times where the stride is 0
      int w = (int)ss;
      tmp.resize((size_t)3 * w);
      for (int r = 0; r < n; ++r)
        memcpy(&tmp[(size_t)r * w], crow(filtered ? first + r : first),
               w * sizeof(T));
      down38(d, tmp.data(), w, n);
    };
    if (g < groups) {
      int base = 8 * g + 3 * k;
      rows_at(base, k < 2 ? 3 : 2, vf);
      return;
    }
    int base = 8 * groups;
    if (dh % 3 == 2) {
      if (k == 0)
        rows_at(base, 3, vf);
      else
        rows_at(base + 3, 3, false);
    } else {
      rows_at(base, 3, false);
    }
  }

  // ScalePlaneBox
  void box_row(T* d, int j, int dx, int dy, std::vector<uint32_t>& acc) const {
    const int64_t max_y = (int64_t)sh << 16;
    int64_t y = std::min<int64_t>((int64_t)j * dy, max_y);
    int iy = (int)(y >> 16);
    int64_t y1 = std::min<int64_t>(y + dy, max_y);
    int bh = min1((int)(y1 >> 16) - iy);
    acc.assign(sw, 0);
    for (int k = 0; k < bh; ++k) {
      const T* s = row(iy + k);
      for (int i = 0; i < sw; ++i) acc[i] += s[i];
    }
    int x = 0;
    if (dx & 0xffff) {  // ScaleAddCols2
      int minbw = dx >> 16;
      int tbl[2] = {65536 / (min1(minbw) * bh), 65536 / (min1(minbw + 1) * bh)};
      for (int i = 0; i < dw; ++i) {
        int ix = x >> 16;
        x += dx;
        int bw = min1((x >> 16) - ix);
        uint32_t sum = 0;
        for (int k = 0; k < bw; ++k) sum += acc[ix + k];
        d[i] = (T)((sum * (uint32_t)tbl[bw - minbw]) >> 16);
      }
    } else {  // ScaleAddCols1 (and Cols0, the same at one sample a box)
      int bw = min1(dx >> 16);
      int scale = 65536 / (bw * bh);
      for (int i = 0; i < dw; ++i) {
        uint32_t sum = 0;
        for (int k = 0; k < bw; ++k) sum += acc[i * bw + k];
        d[i] = (T)((sum * (uint32_t)scale) >> 16);
      }
    }
  }

  // ScaleRowUp2_Bilinear's Any wrapper over rows s (nearer) and t
  void up2_bilinear(T* d, const T* s, const T* t) const {
    d[0] = (T)((3 * s[0] + t[0] + 2) >> 2);
    int work = (dw - 1) & ~1;
    for (int x = 0; x < work / 2; ++x) {
      d[1 + 2 * x] =
          (T)((s[x] * 9 + s[x + 1] * 3 + t[x] * 3 + t[x + 1] + 8) >> 4);
      d[2 + 2 * x] =
          (T)((s[x] * 3 + s[x + 1] * 9 + t[x] + t[x + 1] * 3 + 8) >> 4);
    }
    int si = (dw - 1) / 2;  // the last sample, at either parity
    d[dw - 1] = (T)((3 * s[si] + t[si] + 2) >> 2);
  }

  void up2_bilinear_row(T* d, int j) const {
    if (j == 0) return up2_bilinear(d, row(0), row(0));
    int x = (j - 1) / 2;
    if (x < sh - 1) {
      if ((j - 1) % 2 == 0) return up2_bilinear(d, row(x), row(x + 1));
      return up2_bilinear(d, row(x + 1), row(x));
    }
    up2_bilinear(d, row(sh - 1), row(sh - 1));  // the last, even height
  }

  void up2_linear_row(T* d, int j) const {
    const T* s;
    if (dh == 1) {
      s = row((sh - 1) / 2);
    } else {
      int dy = fixed_div(sh - 1, dh - 1);
      int64_t y = (1 << 15) - 1 + (int64_t)j * dy;
      s = row((int)(y >> 16));
    }
    d[0] = s[0];
    int work = (dw - 1) & ~1;
    for (int x = 0; x < work / 2; ++x) {
      d[1 + 2 * x] = (T)((s[x] * 3 + s[x + 1] + 2) >> 2);
      d[2 + 2 * x] = (T)((s[x] + s[x + 1] * 3 + 2) >> 2);
    }
    d[dw - 1] = s[(dw - 1) / 2];
  }

  // ScalePlaneBilinearUp: each source row's columns filtered, then two of
  // them blended
  void bilinear_up_row(T* d, int j, int x, int y0, int dx, int dy,
                       std::vector<T>& tmp) const {
    const int max_y = (sh - 1) << 16;
    int64_t y = (int64_t)y0 + (int64_t)j * dy;
    if (y > max_y) y = max_y;
    int yi = (int)(y >> 16);
    tmp.resize((size_t)2 * dw);
    T* a = tmp.data();
    T* b = a + dw;
    filter_cols(a, row(yi), sw, dw, x, dx);
    if (f == kLinear) {
      memcpy(d, a, dw * sizeof(T));
      return;
    }
    filter_cols(b, row(std::min(yi + 1, sh - 1)), sw, dw, x, dx);
    interpolate(d, a, b, dw, (int)((y >> 8) & 255));
  }

  // ScalePlaneBilinearDown: two source rows blended, then the columns
  void bilinear_down_row(T* d, int j, int x, int y0, int dx, int dy,
                         std::vector<T>& tmp) const {
    const int64_t max_y = (int64_t)(sh - 1) << 16;
    int64_t y = std::min<int64_t>((int64_t)y0 + (int64_t)j * dy, max_y);
    int yi = (int)(y >> 16);
    if (f == kLinear) return filter_cols(d, row(yi), sw, dw, x, dx);
    tmp.resize(sw);
    interpolate(tmp.data(), row(yi), crow(yi + 1), sw, (int)((y >> 8) & 255));
    filter_cols(d, tmp.data(), sw, dw, x, dx);
  }

  void simple_row(T* d, int j, int x, int y0, int dx, int dy) const {
    const T* s = row((int)(((int64_t)y0 + (int64_t)j * dy) >> 16));
    for (int i = 0; i < dw; ++i, x += dx) d[i] = s[x >> 16];
  }

  void run(int threads) {
    f = reduce_filter(sw, sh, dw, dh, kBox);
    int x = 0, y = 0, dx = 0, dy = 0;
    enum { COPY, VERT, D34, D2, D38, D4, BOX, UP2L, UP2B, BUP, BDOWN,
           SIMPLE } path;
    if (dw == sw && dh == sh) {
      path = COPY;
    } else if (dw == sw && f != kBox) {
      path = VERT;
      if (dh <= sh) {
        dy = fixed_div(sh, dh);
        y = center_start(dy, -32768);
      } else if (sh > 1 && dh > 1) {
        dy = fixed_div1(sh, dh);
      }
    } else if (dw <= sw && dh <= sh && 4 * dw == 3 * sw && 4 * dh == 3 * sh) {
      path = D34;
    } else if (dw <= sw && dh <= sh && 2 * dw == sw && 2 * dh == sh) {
      path = D2;
    } else if (dw <= sw && dh <= sh && 8 * dw == 3 * sw &&
               8 * dh == 3 * sh) {
      path = D38;
    } else if (dw <= sw && dh <= sh && 4 * dw == sw && 4 * dh == sh &&
               (f == kBox || f == kNone)) {
      path = D4;
    } else if (f == kBox && dh * 2 < sh) {
      path = BOX;
      slope(sw, sh, dw, dh, kBox, &x, &y, &dx, &dy);
    } else if ((dw + 1) / 2 == sw && f == kLinear) {
      path = UP2L;
    } else if ((dh + 1) / 2 == sh && (dw + 1) / 2 == sw &&
               (f == kBilinear || f == kBox)) {
      path = UP2B;
    } else if (f != kNone && dh > sh) {
      path = BUP;
      slope(sw, sh, dw, dh, f, &x, &y, &dx, &dy);
    } else if (f != kNone) {
      path = BDOWN;
      slope(sw, sh, dw, dh, f, &x, &y, &dx, &dy);
    } else {
      path = SIMPLE;
      slope(sw, sh, dw, dh, kNone, &x, &y, &dx, &dy);
    }
    // a row of the crop: written in place where the crop is the whole
    // width, else through a row of the scaled width
    T* const out = dst;
    const int64_t out_stride = ds;
    auto one = [&](int j, std::vector<T>& tmp, std::vector<uint32_t>& acc,
                   std::vector<T>& line) {
      T* d = out + j * out_stride;
      if (cw < dw) {
        line.resize(dw);
        d = line.data();
      }
      switch (path) {
        case COPY:
          memcpy(d, row(j), dw * sizeof(T));
          break;
        case VERT: vertical_row(d, j, y, dy); break;
        case D34: down34_row(d, j); break;
        case D2: down2_row(d, j); break;
        case D38: down38_row(d, j, tmp); break;
        case D4: down4_row(d, j); break;
        case BOX: box_row(d, j, dx, dy, acc); break;
        case UP2L: up2_linear_row(d, j); break;
        case UP2B: up2_bilinear_row(d, j); break;
        case BUP: bilinear_up_row(d, j, x, y, dx, dy, tmp); break;
        case BDOWN: bilinear_down_row(d, j, x, y, dx, dy, tmp); break;
        case SIMPLE: simple_row(d, j, x, y, dx, dy); break;
      }
      if (cw < dw) memcpy(out + j * out_stride, line.data(), cw * sizeof(T));
    };
    const int band = 32;
    int bands = (ch + band - 1) / band;
    int most = threads > 0 ? threads
                           : (int)std::max(1u, std::thread::hardware_concurrency());
    // a band is worth a thread from about 64k output samples on
    int workers = std::min(bands, std::max(1, (int)((int64_t)cw * ch >> 16)));
    workers = std::min(workers, most);
    std::atomic<int> next{0};
    auto work = [&]() {
      std::vector<T> tmp, line;
      std::vector<uint32_t> acc;
      for (int b; (b = next.fetch_add(1)) < bands;)
        for (int j = b * band; j < std::min(ch, (b + 1) * band); ++j)
          one(j, tmp, acc, line);
    };
    std::vector<std::thread> pool;
    for (int i = 1; i < workers; ++i) pool.emplace_back(work);
    work();
    for (std::thread& t : pool) t.join();
  }
};

}  // namespace

// Scales one plane of `bytes` (1: uint8_t, 2: uint16_t of 10 or 12 bits)
// samples from sw x sh to dw x dh as libyuv's ScalePlane / ScalePlane_12
// with kFilterBox, and writes the top-left cw x ch of the result (the
// whole plane where they are dw and dh: a grid crops its last cells, and a
// crop never needs the scaled plane whole); strides in samples; `threads`
// 0 for one a core. Returns 0, or -1 for sizes libavif never passes (a
// side of 0 or past 32768, a crop beyond the plane, a stride shorter than
// its row).
IK_EXPORT int ik_avif_scale_plane(const void* src, int64_t src_stride, int sw,
                                  int sh, void* dst, int64_t dst_stride,
                                  int dw, int dh, int cw, int ch, int bytes,
                                  int threads) {
  if (sw <= 0 || sh <= 0 || dw <= 0 || dh <= 0 || sw > 32768 || sh > 32768 ||
      dw > 32768 || dh > 32768 || cw <= 0 || ch <= 0 || cw > dw || ch > dh ||
      src_stride < sw || dst_stride < cw || (bytes != 1 && bytes != 2))
    return -1;
  if (bytes == 1) {
    Scaler<uint8_t> s{(const uint8_t*)src, src_stride, sw, sh, (uint8_t*)dst,
                      dst_stride, dw, dh, cw, ch};
    s.run(threads);
  } else {
    Scaler<uint16_t> s{(const uint16_t*)src, src_stride, sw, sh,
                       (uint16_t*)dst, dst_stride, dw, dh, cw, ch};
    s.run(threads);
  }
  return 0;
}
