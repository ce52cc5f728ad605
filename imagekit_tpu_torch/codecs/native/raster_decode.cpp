// QOI and BCn (DXT1/3/5, BC5) decodes of the port, C ABI for ctypes.
//
// The reference decodes QOI and DDS sources with Pillow
// (imagekit_tpu/codecs/pil_backend.py); the port has no Pillow, so these
// are its own, written to give Pillow 12's pixels: QoiImagePlugin.py's
// decoder (index slots start as (0, 0, 0, 0), the previous pixel as
// (0, 0, 0, 255), a run past the last pixel is cut) and libImaging's
// BcnDecode.c (565 endpoints widened by bit replication, the 1/3 and 2/3
// colours and the BC3 alpha ramps in integer arithmetic truncated toward
// zero, BC1's three-colour mode with a transparent black fourth index,
// BC2 and BC3 colour blocks always in four-colour mode, BC5's blue 0).
// The serial inner loops live here; headers are parsed in Python
// (codecs/qoi.py, codecs/dds.py).

#include <cstddef>
#include <cstdint>
#include <cstring>

#define IK_EXPORT extern "C" __attribute__((visibility("default")))

namespace {

enum { kOk = 0, kTruncated = -1, kBadArgs = -2 };

// ---------------------------------------------------------------------------
// QOI
// ---------------------------------------------------------------------------

inline int QoiHash(const uint8_t* p) {
  return (p[0] * 3 + p[1] * 5 + p[2] * 7 + p[3] * 11) % 64;
}

// ---------------------------------------------------------------------------
// BCn
// ---------------------------------------------------------------------------

struct Rgba {
  uint8_t r, g, b, a;
};

inline Rgba Decode565(uint16_t x) {
  Rgba c;
  int r = (x & 0xf800) >> 8;
  r |= r >> 5;
  int g = (x & 0x7e0) >> 3;
  g |= g >> 6;
  int b = (x & 0x1f) << 3;
  b |= b >> 5;
  c.r = static_cast<uint8_t>(r);
  c.g = static_cast<uint8_t>(g);
  c.b = static_cast<uint8_t>(b);
  c.a = 0xff;
  return c;
}

inline uint16_t Le16(const uint8_t* p) {
  return static_cast<uint16_t>(p[0] | (p[1] << 8));
}

inline uint32_t Le32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) |
         (static_cast<uint32_t>(p[3]) << 24);
}

// The colour half of a BC1/2/3 block: 16 texels in row-major order.
void Bc1Color(Rgba* dst, const uint8_t* src, bool separate_alpha) {
  const uint16_t c0 = Le16(src), c1 = Le16(src + 2);
  const uint32_t lut = Le32(src + 4);
  Rgba p[4];
  p[0] = Decode565(c0);
  p[1] = Decode565(c1);
  const int r0 = p[0].r, g0 = p[0].g, b0 = p[0].b;
  const int r1 = p[1].r, g1 = p[1].g, b1 = p[1].b;
  if (c0 > c1 || separate_alpha) {
    p[2] = {static_cast<uint8_t>((2 * r0 + r1) / 3),
            static_cast<uint8_t>((2 * g0 + g1) / 3),
            static_cast<uint8_t>((2 * b0 + b1) / 3), 0xff};
    p[3] = {static_cast<uint8_t>((r0 + 2 * r1) / 3),
            static_cast<uint8_t>((g0 + 2 * g1) / 3),
            static_cast<uint8_t>((b0 + 2 * b1) / 3), 0xff};
  } else {
    p[2] = {static_cast<uint8_t>((r0 + r1) / 2),
            static_cast<uint8_t>((g0 + g1) / 2),
            static_cast<uint8_t>((b0 + b1) / 2), 0xff};
    p[3] = {0, 0, 0, 0};
  }
  for (int n = 0; n < 16; ++n) dst[n] = p[3 & (lut >> (2 * n))];
}

// A BC3 alpha block (also each channel of BC5) into byte `o` of 16 texels
// `stride` bytes apart.
void Bc3Alpha(uint8_t* dst, const uint8_t* src, int stride, int o) {
  const int a0 = src[0], a1 = src[1];
  uint8_t a[8];
  a[0] = static_cast<uint8_t>(a0);
  a[1] = static_cast<uint8_t>(a1);
  if (a0 > a1) {
    for (int i = 1; i < 7; ++i)
      a[i + 1] = static_cast<uint8_t>(((7 - i) * a0 + i * a1) / 7);
  } else {
    for (int i = 1; i < 5; ++i)
      a[i + 1] = static_cast<uint8_t>(((5 - i) * a0 + i * a1) / 5);
    a[6] = 0;
    a[7] = 0xff;
  }
  const uint32_t lut1 = src[2] | (src[3] << 8) | (src[4] << 16);
  const uint32_t lut2 = src[5] | (src[6] << 8) | (src[7] << 16);
  for (int n = 0; n < 8; ++n) dst[stride * n + o] = a[7 & (lut1 >> (3 * n))];
  for (int n = 0; n < 8; ++n)
    dst[stride * (8 + n) + o] = a[7 & (lut2 >> (3 * n))];
}

void DecodeBlock(int n, const uint8_t* src, Rgba* col) {
  switch (n) {
    case 1:
      Bc1Color(col, src, false);
      break;
    case 2:
      Bc1Color(col, src + 8, true);
      for (int i = 0; i < 16; ++i) {
        const int bit = i * 4;
        const int av = 0xf & (src[bit >> 3] >> (bit & 7));
        col[i].a = static_cast<uint8_t>((av << 4) | av);
      }
      break;
    case 3:
      Bc1Color(col, src + 8, true);
      Bc3Alpha(reinterpret_cast<uint8_t*>(col), src, sizeof(Rgba), 3);
      break;
    default:  // 5
      std::memset(col, 0, 16 * sizeof(Rgba));
      Bc3Alpha(reinterpret_cast<uint8_t*>(col), src, sizeof(Rgba), 0);
      Bc3Alpha(reinterpret_cast<uint8_t*>(col), src + 8, sizeof(Rgba), 1);
      break;
  }
}

}  // namespace

// QOI chunks from `d` (the bytes after the 14-byte header) -> w*h pixels of
// `ch` (3 or 4) channels. kTruncated where the chunks end first.
IK_EXPORT int ik_qoi_decode(const uint8_t* d, size_t len, int w, int h, int ch,
                            uint8_t* out) {
  if (w <= 0 || h <= 0 || (ch != 3 && ch != 4)) return kBadArgs;
  uint8_t index[64][4];
  std::memset(index, 0, sizeof(index));
  uint8_t px[4] = {0, 0, 0, 255};
  const size_t total = static_cast<size_t>(w) * h;
  size_t pos = 0, n = 0;
  while (n < total) {
    if (pos >= len) return kTruncated;
    const uint8_t b = d[pos++];
    if (b == 0xfe) {  // QOI_OP_RGB
      if (pos + 3 > len) return kTruncated;
      px[0] = d[pos];
      px[1] = d[pos + 1];
      px[2] = d[pos + 2];
      pos += 3;
    } else if (b == 0xff) {  // QOI_OP_RGBA
      if (pos + 4 > len) return kTruncated;
      std::memcpy(px, d + pos, 4);
      pos += 4;
    } else if ((b >> 6) == 0) {  // QOI_OP_INDEX
      std::memcpy(px, index[b & 0x3f], 4);
    } else if ((b >> 6) == 1) {  // QOI_OP_DIFF
      px[0] = static_cast<uint8_t>(px[0] + ((b >> 4) & 3) - 2);
      px[1] = static_cast<uint8_t>(px[1] + ((b >> 2) & 3) - 2);
      px[2] = static_cast<uint8_t>(px[2] + (b & 3) - 2);
    } else if ((b >> 6) == 2) {  // QOI_OP_LUMA
      if (pos >= len) return kTruncated;
      const uint8_t b2 = d[pos++];
      const int dg = (b & 0x3f) - 32;
      px[0] = static_cast<uint8_t>(px[0] + dg + ((b2 >> 4) & 0xf) - 8);
      px[1] = static_cast<uint8_t>(px[1] + dg);
      px[2] = static_cast<uint8_t>(px[2] + dg + (b2 & 0xf) - 8);
    } else {  // QOI_OP_RUN: the previous pixel again, no index update
      size_t run = (b & 0x3f) + 1;
      if (run > total - n) run = total - n;
      for (size_t i = 0; i < run; ++i, ++n) std::memcpy(out + n * ch, px, ch);
      continue;
    }
    std::memcpy(index[QoiHash(px)], px, 4);
    std::memcpy(out + n * ch, px, ch);
    ++n;
  }
  return kOk;
}

// BCn blocks (n = 1 DXT1, 2 DXT3, 3 DXT5, 5 BC5) of a w x h texture ->
// RGBA (n = 1..3) or RGB (n = 5) pixels, the blocks past the right and
// bottom edges cut. kTruncated where the data holds fewer blocks.
IK_EXPORT int ik_bcn_decode(const uint8_t* d, size_t len, int w, int h, int n,
                            uint8_t* out) {
  if (w <= 0 || h <= 0 || (n != 1 && n != 2 && n != 3 && n != 5))
    return kBadArgs;
  const int block = n == 1 ? 8 : 16;
  const int ch = n == 5 ? 3 : 4;
  const size_t bw = (static_cast<size_t>(w) + 3) / 4;
  const size_t bh = (static_cast<size_t>(h) + 3) / 4;
  if (len < bw * bh * block) return kTruncated;
  Rgba col[16];
  for (size_t by = 0; by < bh; ++by) {
    for (size_t bx = 0; bx < bw; ++bx) {
      DecodeBlock(n, d + (by * bw + bx) * block, col);
      for (int j = 0; j < 4; ++j) {
        const size_t y = by * 4 + j;
        if (y >= static_cast<size_t>(h)) break;
        for (int i = 0; i < 4; ++i) {
          const size_t x = bx * 4 + i;
          if (x >= static_cast<size_t>(w)) break;
          std::memcpy(out + (y * w + x) * ch, &col[j * 4 + i], ch);
        }
      }
    }
  }
  return kOk;
}
