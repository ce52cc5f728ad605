// BMP layouts of the port that the pinned decoder refuses, C ABI for ctypes.
//
// misc_decode.cpp (a copy of the reference's, pinned byte-equal) decodes
// BITMAPINFOHEADER and later BMPs in BI_RGB at 1/4/8/24/32 bpp and RLE4/8;
// it refuses the rest with -3, and the reference then decodes the file with
// Pillow. This decoder is the port's own, for that case only, written to
// give Pillow 12's BmpImagePlugin pixels:
//
//   - BITMAPCOREHEADER (12 bytes: 16-bit sides, 3-byte palette entries);
//   - 16 bpp BI_RGB (BGR;15), and BI_BITFIELDS in exactly the mask sets
//     Pillow maps to a raw mode: 16 bpp 5-6-5 and 5-5-5, 24 bpp BGR, and
//     the eight 32 bpp sets (BGRX, XBGR, BGXR, ABGR, RGBA, BGRA, BGAR, and
//     all-zero masks read as BGRA). The masks are the three DWORDs after a
//     40-byte header, or fields of a header of 52 bytes or more (the alpha
//     mask from 56 bytes on; a 52-byte header's alpha mask is taken as 0).
//     5- and 6-bit fields widen as Pillow's unpackers do: v * 255 / 31 and
//     v * 255 / 63, truncated.
//
//   - a 4 bpp palette of the grays 0-15, which Pillow reads as 8-bit L:
//     each row's first bytes, a byte a pixel, where the row's stride holds
//     the width; a wider image its raw decoder refuses ("codec
//     configuration error", -10).
//
// Output is RGB, or RGBA where Pillow reads an alpha channel. What Pillow
// refuses (another header size, a depth other than 1/4/8/16/24/32, a mask
// set it does not know, compressions above 3) is an error, not -3; RLE,
// the pinned decoder's, is -3. Every read is bounded by the data: a
// palette or pixel array that runs past the end is refused before any
// pixel is written.
//
// The exported names are ik_bmpx_*: the loader links every native source
// into one library.

#include <cstddef>
#include <cstdint>

#define IK_EXPORT extern "C" __attribute__((visibility("default")))

namespace {

enum {
  kOk = 0,
  kTruncated = -1,
  kBadMagic = -2,
  kUnsupported = -3,
  kBadData = -4,
  kBuffer = -7,
  kCodecConfig = -10,  // Pillow's raw decoder refuses the row layout
};

inline uint32_t U16(const uint8_t* p) { return p[0] | (p[1] << 8); }
inline uint32_t U32(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | (static_cast<uint32_t>(p[3]) << 24);
}

// A 32 bpp raw mode as the byte of each channel in a pixel (-1: none).
struct Bytes4 {
  uint32_t r, g, b, a;  // masks
  int8_t ri, gi, bi, ai;
};

// Pillow's SUPPORTED[32] / MASK_MODES, in its order.
const Bytes4 kMasks32[] = {
    {0xFF0000, 0xFF00, 0xFF, 0x0, 2, 1, 0, -1},                // BGRX
    {0xFF000000, 0xFF0000, 0xFF00, 0x0, 3, 2, 1, -1},          // XBGR
    {0xFF000000, 0xFF00, 0xFF, 0x0, 3, 1, 0, -1},              // BGXR
    {0xFF000000, 0xFF0000, 0xFF00, 0xFF, 3, 2, 1, 0},          // ABGR
    {0xFF, 0xFF00, 0xFF0000, 0xFF000000, 0, 1, 2, 3},          // RGBA
    {0xFF0000, 0xFF00, 0xFF, 0xFF000000, 2, 1, 0, 3},          // BGRA
    {0xFF000000, 0xFF00, 0xFF, 0xFF0000, 3, 1, 0, 2},          // BGAR
    {0x0, 0x0, 0x0, 0x0, 2, 1, 0, 3},                          // BGRA
};

enum Kind { kPalette, kBgr15, kBgr16, kBgr24, kBytes32, kGray8 };

struct Bmp {
  uint32_t width = 0, height = 0;
  bool top_down = false;
  int bits = 0;
  Kind kind = kPalette;
  int8_t ch[4] = {2, 1, 0, -1};  // 32 bpp: byte of R, G, B, A
  const uint8_t* palette = nullptr;
  int pad = 4;  // bytes a palette entry
  uint32_t colors = 0;
  size_t pix = 0, stride = 0;
  int channels = 3;
};

int Parse(const uint8_t* d, size_t len, Bmp* b) {
  if (len < 18) return kTruncated;
  if (d[0] != 'B' || d[1] != 'M') return kBadMagic;
  size_t offset = U32(d + 10);
  const uint32_t hsz = U32(d + 14);
  if (hsz < 4 || 14 + static_cast<size_t>(hsz) > len) return kTruncated;
  size_t after = 14 + hsz;  // where Pillow's reader stands after the header
  uint32_t comp = 0, colors = 0;
  uint32_t rm = 0, gm = 0, bm = 0, am = 0;
  if (hsz == 12) {
    b->width = U16(d + 18);
    b->height = U16(d + 20);
    b->bits = static_cast<int>(U16(d + 24));
    b->pad = 3;
  } else if (hsz == 40 || hsz == 52 || hsz == 56 || hsz == 64 ||
             hsz == 108 || hsz == 124) {
    b->top_down = d[25] == 0xFF;  // Pillow's y_flip: the height's top byte
    b->width = U32(d + 18);
    b->height = b->top_down ? 0u - U32(d + 22) : U32(d + 22);
    b->bits = static_cast<int>(U16(d + 28));
    comp = U32(d + 30);
    colors = U32(d + 46);
    if (comp == 3) {
      if (hsz >= 52) {
        rm = U32(d + 54);
        gm = U32(d + 58);
        bm = U32(d + 62);
        am = hsz >= 56 ? U32(d + 66) : 0;
      } else {  // three DWORDs after a 40-byte header
        if (after + 12 > len) return kTruncated;
        rm = U32(d + 54);
        gm = U32(d + 58);
        bm = U32(d + 62);
        after += 12;
      }
    }
  } else {
    return kBadData;  // "Unsupported BMP header type"
  }
  if (b->width == 0 || b->height == 0 || b->width > (1u << 24) ||
      b->height > (1u << 24))
    return kBadData;
  const int bits = b->bits;
  if (colors == 0) colors = bits < 32 ? 1u << bits : 0;
  if (offset == 14 + hsz && bits <= 8) offset += 4 * static_cast<size_t>(colors);
  if (bits != 1 && bits != 4 && bits != 8 && bits != 16 && bits != 24 &&
      bits != 32)
    return kBadData;  // "Unsupported BMP pixel depth"
  if (comp == 3) {
    if (bits == 32) {
      int hit = -1;
      for (int i = 0; i < 8 && hit < 0; ++i)
        if (kMasks32[i].r == rm && kMasks32[i].g == gm &&
            kMasks32[i].b == bm && kMasks32[i].a == am)
          hit = i;
      if (hit < 0) return kBadData;  // "Unsupported BMP bitfields layout"
      const Bytes4& m = kMasks32[hit];
      b->ch[0] = m.ri;
      b->ch[1] = m.gi;
      b->ch[2] = m.bi;
      b->ch[3] = m.ai;
      b->kind = kBytes32;
    } else if (bits == 24 && rm == 0xFF0000 && gm == 0xFF00 && bm == 0xFF) {
      b->kind = kBgr24;
    } else if (bits == 16 && rm == 0xF800 && gm == 0x7E0 && bm == 0x1F) {
      b->kind = kBgr16;
    } else if (bits == 16 && rm == 0x7C00 && gm == 0x3E0 && bm == 0x1F) {
      b->kind = kBgr15;
    } else {
      return kBadData;  // "Unsupported BMP bitfields layout"
    }
  } else if (comp == 0) {
    b->kind = bits == 16   ? kBgr15
              : bits == 24 ? kBgr24
              : bits == 32 ? kBytes32
                           : kPalette;
  } else if (comp == 1 || comp == 2) {
    return kUnsupported;  // RLE: the pinned decoder's
  } else {
    return kBadData;  // "Unsupported BMP compression"
  }
  b->channels = b->kind == kBytes32 && b->ch[3] >= 0 ? 4 : 3;
  if (b->kind == kPalette) {
    if (colors == 0 || colors > 65536) return kBadData;
    if (after + static_cast<size_t>(b->pad) * colors > len) return kTruncated;
    b->palette = d + after;
    b->colors = colors;
    // Pillow drops an all-gray palette: "1" for two entries (0, 255), "L"
    // for the grays 0..n-1. Both read as the palette lookup, except L at
    // 4 bpp, which Pillow unpacks as 8-bit samples.
    bool gray = true;
    for (uint32_t i = 0; i < colors && gray; ++i) {
      const uint32_t v = colors == 2 ? (i ? 255 : 0) : i;
      const uint8_t* e = b->palette + b->pad * i;
      gray = e[0] == v && e[1] == v && e[2] == v;
    }
    if (gray && colors != 2 && bits == 4) b->kind = kGray8;
  }
  b->stride = ((static_cast<size_t>(b->width) * bits + 31) >> 3) & ~size_t{3};
  if (b->kind == kGray8 && b->width > b->stride) return kCodecConfig;
  b->pix = offset ? offset : after;
  if (b->pix > len || b->stride * b->height > len - b->pix) return kTruncated;
  return kOk;
}

inline uint8_t Widen(uint32_t v, uint32_t max) {
  return static_cast<uint8_t>(v * 255 / max);
}

}  // namespace

struct IkBmpxInfo {  // the layout of misc_decode.cpp's IkMiscInfo
  int32_t width, height, channels;
};

IK_EXPORT int ik_bmpx_parse(const uint8_t* d, size_t len, IkBmpxInfo* out) {
  Bmp b;
  const int rc = Parse(d, len, &b);
  out->width = static_cast<int32_t>(b.width);
  out->height = static_cast<int32_t>(b.height);
  out->channels = b.channels;
  return rc;
}

IK_EXPORT int ik_bmpx_decode(const uint8_t* d, size_t len, uint8_t* out,
                             size_t out_cap) {
  Bmp b;
  const int rc = Parse(d, len, &b);
  if (rc != kOk) return rc;
  const size_t W = b.width, H = b.height, oc = b.channels;
  if (out_cap < W * H * oc) return kBuffer;
  for (size_t y = 0; y < H; ++y) {
    const uint8_t* s = d + b.pix + (b.top_down ? y : H - 1 - y) * b.stride;
    uint8_t* o = out + y * W * oc;
    for (size_t x = 0; x < W; ++x, o += oc) {
      switch (b.kind) {
        case kPalette: {
          const int per = 8 / b.bits;
          const uint32_t i =
              (s[x / per] >> (8 - b.bits * (x % per + 1))) & ((1u << b.bits) - 1);
          if (i >= b.colors) return kBadData;  // an index past the palette
          const uint8_t* e = b.palette + b.pad * i;
          o[0] = e[2];
          o[1] = e[1];
          o[2] = e[0];
          break;
        }
        case kBgr15: {
          const uint32_t p = U16(s + 2 * x);
          o[0] = Widen((p >> 10) & 31, 31);
          o[1] = Widen((p >> 5) & 31, 31);
          o[2] = Widen(p & 31, 31);
          break;
        }
        case kBgr16: {
          const uint32_t p = U16(s + 2 * x);
          o[0] = Widen((p >> 11) & 31, 31);
          o[1] = Widen((p >> 5) & 63, 63);
          o[2] = Widen(p & 31, 31);
          break;
        }
        case kBgr24:
          o[0] = s[3 * x + 2];
          o[1] = s[3 * x + 1];
          o[2] = s[3 * x];
          break;
        case kBytes32:
          for (size_t c = 0; c < oc; ++c) o[c] = s[4 * x + b.ch[c]];
          break;
        case kGray8:
          o[0] = o[1] = o[2] = s[x];
          break;
      }
    }
  }
  return kOk;
}
