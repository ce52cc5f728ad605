// Native GIF and BMP decode: the remaining small source formats of the
// reference's `image` crate decode arm (src/transform.rs:27-43). Both are
// host entropy/unpack stages feeding the batched device resize; outputs
// match the host-library backend's mode expansion (RGB, or RGBA when the
// source carries transparency).
//
// Scope (else return IK_MISC_UNSUPPORTED and callers fall back to PIL):
// - GIF: 87a/89a, first frame, LZW, global/local palettes, interlace,
//   GCE transparency (-> RGBA).
// - BMP: BITMAPINFOHEADER-or-later, uncompressed 24/32bpp and 8bpp
//   palette, bottom-up or top-down rows.

#include <cstdint>
#include <cstring>
#include <vector>

#ifndef IK_EXPORT
#define IK_EXPORT extern "C" __attribute__((visibility("default")))
#endif

namespace {

constexpr int IK_MISC_OK = 0;
constexpr int IK_MISC_TRUNCATED = -1;
constexpr int IK_MISC_BAD_MAGIC = -2;
constexpr int IK_MISC_UNSUPPORTED = -3;
constexpr int IK_MISC_BAD_DATA = -4;
constexpr int IK_MISC_BUFFER = -7;

inline uint16_t U16le(const uint8_t* p) { return p[0] | (p[1] << 8); }
inline uint32_t U32le(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | (static_cast<uint32_t>(p[3]) << 24);
}

// ---------------------------------------------------------------------------
// GIF
// ---------------------------------------------------------------------------
struct GifState {
  int width = 0, height = 0;
  int channels = 3;
  // first frame geometry
  int fx = 0, fy = 0, fw = 0, fh = 0;
  bool interlaced = false;
  int transparent = -1;  // palette index or -1
  const uint8_t* palette = nullptr;  // active palette (local wins)
  int palette_size = 0;
  size_t data_pos = 0;  // offset of LZW min-code-size byte
  uint8_t background = 0;
};

int GifParse(const uint8_t* d, size_t len, GifState* st) {
  if (len < 13) return IK_MISC_TRUNCATED;
  if (std::memcmp(d, "GIF87a", 6) != 0 && std::memcmp(d, "GIF89a", 6) != 0)
    return IK_MISC_BAD_MAGIC;
  st->width = U16le(d + 6);
  st->height = U16le(d + 8);
  if (st->width <= 0 || st->height <= 0) return IK_MISC_BAD_DATA;
  const uint8_t flags = d[10];
  st->background = d[11];
  size_t pos = 13;
  const uint8_t* gpal = nullptr;
  int gpal_n = 0;
  if (flags & 0x80) {
    gpal_n = 2 << (flags & 7);
    gpal = d + pos;
    pos += static_cast<size_t>(gpal_n) * 3;
    if (pos > len) return IK_MISC_TRUNCATED;
  }
  st->palette = gpal;
  st->palette_size = gpal_n;

  while (pos < len) {
    const uint8_t b = d[pos++];
    if (b == 0x3B) return IK_MISC_BAD_DATA;  // trailer before any image
    if (b == 0x21) {  // extension
      if (pos >= len) return IK_MISC_TRUNCATED;
      const uint8_t label = d[pos++];
      if (label == 0xF9) {  // graphic control
        if (pos + 6 > len) return IK_MISC_TRUNCATED;
        const uint8_t sz = d[pos];
        if (sz >= 4 && (d[pos + 1] & 1)) st->transparent = d[pos + 4];
      }
      // skip sub-blocks
      while (pos < len) {
        const uint8_t sz = d[pos++];
        if (sz == 0) break;
        pos += sz;
      }
      if (pos > len) return IK_MISC_TRUNCATED;
      continue;
    }
    if (b == 0x2C) {  // image descriptor: first frame
      if (pos + 9 > len) return IK_MISC_TRUNCATED;
      st->fx = U16le(d + pos);
      st->fy = U16le(d + pos + 2);
      st->fw = U16le(d + pos + 4);
      st->fh = U16le(d + pos + 6);
      const uint8_t iflags = d[pos + 8];
      pos += 9;
      st->interlaced = (iflags & 0x40) != 0;
      if (iflags & 0x80) {
        const int n = 2 << (iflags & 7);
        if (pos + static_cast<size_t>(n) * 3 > len) return IK_MISC_TRUNCATED;
        st->palette = d + pos;
        st->palette_size = n;
        pos += static_cast<size_t>(n) * 3;
      }
      if (st->palette == nullptr || st->fw <= 0 || st->fh <= 0)
        return IK_MISC_BAD_DATA;
      if (st->fx + st->fw > st->width || st->fy + st->fh > st->height)
        return IK_MISC_BAD_DATA;
      st->data_pos = pos;
      st->channels = st->transparent >= 0 ? 4 : 3;
      return IK_MISC_OK;
    }
    return IK_MISC_BAD_DATA;
  }
  return IK_MISC_TRUNCATED;
}

// LZW decode of the image data sub-blocks into per-pixel palette indices.
int GifLzw(const uint8_t* d, size_t len, size_t pos, size_t npix,
           std::vector<uint8_t>* out) {
  if (pos >= len) return IK_MISC_TRUNCATED;
  const int min_code = d[pos++];
  if (min_code < 2 || min_code > 11) return IK_MISC_BAD_DATA;
  const int clear = 1 << min_code;
  const int eoi = clear + 1;

  // dictionary as (prefix, suffix) pairs; first[] caches each string's
  // first character for the KwKwK case
  const int kMax = 4096;
  std::vector<int16_t> prefix(kMax, -1);
  std::vector<uint8_t> suffix(kMax), first(kMax);
  for (int i = 0; i < clear; ++i) {
    suffix[i] = static_cast<uint8_t>(i);
    first[i] = static_cast<uint8_t>(i);
  }
  int next = eoi + 1, width = min_code + 1, prev = -1;

  out->clear();
  out->reserve(npix);
  uint32_t bits = 0;
  int nbits = 0;
  size_t block_rem = 0;
  std::vector<uint8_t> stack;
  stack.reserve(kMax);

  auto emit = [&](int code) {  // push string for a KNOWN code, return first char
    stack.clear();
    int cur = code;
    while (cur > eoi) {
      stack.push_back(suffix[cur]);
      cur = prefix[cur];
    }
    stack.push_back(suffix[cur]);
    for (size_t i = stack.size(); i > 0 && out->size() < npix; --i)
      out->push_back(stack[i - 1]);
    return first[code];
  };

  while (out->size() < npix) {
    while (nbits < width) {
      if (block_rem == 0) {
        if (pos >= len) return IK_MISC_TRUNCATED;
        block_rem = d[pos++];
        if (block_rem == 0) return IK_MISC_TRUNCATED;  // ran out of data
      } else {
        if (pos >= len) return IK_MISC_TRUNCATED;
        bits |= static_cast<uint32_t>(d[pos++]) << nbits;
        nbits += 8;
        --block_rem;
      }
    }
    const int code = bits & ((1 << width) - 1);
    bits >>= width;
    nbits -= width;

    if (code == clear) {
      next = eoi + 1;
      width = min_code + 1;
      prev = -1;
      continue;
    }
    if (code == eoi) break;
    if (code == next && prev >= 0) {
      // KwKwK: string(prev) + first(prev), defining it in the same step
      if (next >= kMax) return IK_MISC_BAD_DATA;
      prefix[next] = static_cast<int16_t>(prev);
      suffix[next] = first[prev];
      first[next] = first[prev];
      ++next;
      emit(code);
      if (next == (1 << width) && width < 12) ++width;
      prev = code;
      continue;
    }
    if (code >= next || (code >= clear && code <= eoi))
      return IK_MISC_BAD_DATA;
    const uint8_t fc = emit(code);
    if (prev >= 0 && next < kMax) {
      prefix[next] = static_cast<int16_t>(prev);
      suffix[next] = fc;
      first[next] = first[prev];
      ++next;
      if (next == (1 << width) && width < 12) ++width;
    }
    prev = code;
  }
  if (out->size() < npix) return IK_MISC_TRUNCATED;
  return IK_MISC_OK;
}

}  // namespace

struct IkMiscInfo {
  int32_t width, height, channels;
};

IK_EXPORT int ik_gif_parse(const uint8_t* d, size_t len, IkMiscInfo* out) {
  GifState st;
  const int rc = GifParse(d, len, &st);
  out->width = st.width;
  out->height = st.height;
  out->channels = st.channels;
  return rc;
}

IK_EXPORT int ik_gif_decode(const uint8_t* d, size_t len, uint8_t* out,
                            size_t out_cap) {
  GifState st;
  int rc = GifParse(d, len, &st);
  if (rc != IK_MISC_OK) return rc;
  const int oc = st.channels;
  const size_t need = static_cast<size_t>(st.width) * st.height * oc;
  if (out_cap < need) return IK_MISC_BUFFER;

  std::vector<uint8_t> idx;
  rc = GifLzw(d, len, st.data_pos, static_cast<size_t>(st.fw) * st.fh, &idx);
  if (rc != IK_MISC_OK) return rc;

  // canvas background: the host library renders the first frame onto the
  // logical screen; fill with the background colour (transparent -> 0s)
  if (oc == 4) {
    std::memset(out, 0, need);
  } else {
    uint8_t bg[3] = {0, 0, 0};
    if (st.background < st.palette_size) {
      const uint8_t* e =
          st.palette + 3 * st.background;  // background uses global palette
      bg[0] = e[0];
      bg[1] = e[1];
      bg[2] = e[2];
    }
    for (size_t i = 0; i < static_cast<size_t>(st.width) * st.height; ++i) {
      out[i * 3 + 0] = bg[0];
      out[i * 3 + 1] = bg[1];
      out[i * 3 + 2] = bg[2];
    }
  }

  // interlace pass ordering; per-pass row counts are ceil((fh-y0)/dy):
  // pass1 ceil(fh/8), pass2 ceil((fh-4)/8) = (fh+3)/8,
  // pass3 ceil((fh-2)/4) = (fh+1)/4, pass4 the rest
  auto row_of = [&](int i) {
    if (!st.interlaced) return i;
    int r = i;
    if (r < (st.fh + 7) / 8) return r * 8;
    r -= (st.fh + 7) / 8;
    if (r < (st.fh + 3) / 8) return r * 8 + 4;
    r -= (st.fh + 3) / 8;
    if (r < (st.fh + 1) / 4) return r * 4 + 2;
    r -= (st.fh + 1) / 4;
    return r * 2 + 1;
  };

  for (int i = 0; i < st.fh; ++i) {
    const int y = st.fy + row_of(i);
    if (y < st.fy || y >= st.fy + st.fh) return IK_MISC_BAD_DATA;
    const uint8_t* src = idx.data() + static_cast<size_t>(i) * st.fw;
    uint8_t* dst = out + (static_cast<size_t>(y) * st.width + st.fx) * oc;
    for (int x = 0; x < st.fw; ++x) {
      const int pi = src[x];
      if (pi >= st.palette_size) return IK_MISC_BAD_DATA;
      const uint8_t* e = st.palette + 3 * pi;
      if (oc == 4) {
        // keep the palette RGB under alpha=0 (host-library behaviour —
        // downstream encoders that drop alpha see the same pixels)
        dst[x * 4 + 0] = e[0];
        dst[x * 4 + 1] = e[1];
        dst[x * 4 + 2] = e[2];
        dst[x * 4 + 3] = pi == st.transparent ? 0 : 255;
      } else {
        dst[x * 3 + 0] = e[0];
        dst[x * 3 + 1] = e[1];
        dst[x * 3 + 2] = e[2];
      }
    }
  }
  return IK_MISC_OK;
}

// ---------------------------------------------------------------------------
// BMP
// ---------------------------------------------------------------------------
namespace {

struct BmpState {
  int width = 0, height = 0;  // height sign-corrected
  bool top_down = false;
  int bpp = 0;
  int comp = 0;  // 0=BI_RGB, 1=BI_RLE8, 2=BI_RLE4
  size_t pix_off = 0;
  const uint8_t* palette = nullptr;  // BGRA entries
  int palette_size = 0;
  int channels = 3;
};

int BmpParse(const uint8_t* d, size_t len, BmpState* st) {
  if (len < 54) return IK_MISC_TRUNCATED;
  if (d[0] != 'B' || d[1] != 'M') return IK_MISC_BAD_MAGIC;
  st->pix_off = U32le(d + 10);
  const uint32_t hsz = U32le(d + 14);
  if (hsz < 40) return IK_MISC_UNSUPPORTED;  // no BITMAPCOREHEADER support
  const int32_t w = static_cast<int32_t>(U32le(d + 18));
  const int32_t h = static_cast<int32_t>(U32le(d + 22));
  st->width = w;
  st->height = h < 0 ? -h : h;
  st->top_down = h < 0;
  if (U16le(d + 26) != 1) return IK_MISC_BAD_DATA;  // planes
  st->bpp = U16le(d + 28);
  const uint32_t comp = U32le(d + 30);
  if (st->width <= 0 || st->height <= 0 || st->width > (1 << 24))
    return IK_MISC_BAD_DATA;
  // BI_RGB, BI_RLE8 (8bpp) and BI_RLE4 (4bpp). comp 3 = bitfields used by
  // some 32bpp writers; the common 8888 layout would decode, but be
  // conservative and fall back.
  st->comp = static_cast<int>(comp);
  if (comp > 2) return IK_MISC_UNSUPPORTED;
  if (comp == 1 && st->bpp != 8) return IK_MISC_BAD_DATA;
  if (comp == 2 && st->bpp != 4) return IK_MISC_BAD_DATA;
  if (st->bpp <= 8) {
    if (st->bpp != 1 && st->bpp != 4 && st->bpp != 8)
      return IK_MISC_UNSUPPORTED;
    uint32_t ncol = U32le(d + 46);
    if (ncol == 0) ncol = 1u << st->bpp;
    if (ncol > 256) return IK_MISC_BAD_DATA;
    if (14 + hsz + ncol * 4 > len) return IK_MISC_TRUNCATED;
    st->palette = d + 14 + hsz;
    st->palette_size = static_cast<int>(ncol);
  } else if (st->bpp != 24 && st->bpp != 32) {
    return IK_MISC_UNSUPPORTED;
  }
  st->channels = 3;  // BI_RGB 32bpp alpha is conventionally ignored (PIL: RGB)
  if (comp == 0) {
    const size_t stride =
        ((static_cast<size_t>(st->width) * st->bpp + 7) / 8 + 3) & ~3ull;
    if (st->pix_off + stride * st->height > len) return IK_MISC_TRUNCATED;
  } else {
    if (st->top_down) return IK_MISC_BAD_DATA;  // RLE is bottom-up only
    if (st->pix_off >= len) return IK_MISC_TRUNCATED;
  }
  return IK_MISC_OK;
}

// BI_RLE8 / BI_RLE4 -> palette-index plane (bottom-up source order is
// handled by the caller's row mapping; indices land in image order here).
int BmpRleDecode(const uint8_t* src, size_t n, int w, int h, int bpp,
                 std::vector<uint8_t>* idx) {
  idx->assign(static_cast<size_t>(w) * h, 0);
  size_t pos = 0;
  int x = 0, y = h - 1;  // RLE streams are bottom-up
  auto put = [&](uint8_t v) {
    if (x < w && y >= 0) (*idx)[static_cast<size_t>(y) * w + x] = v;
    ++x;
  };
  while (pos + 2 <= n) {
    const uint8_t cnt = src[pos], val = src[pos + 1];
    pos += 2;
    if (cnt > 0) {  // run
      for (int i = 0; i < cnt; ++i)
        put(bpp == 8 ? val
                     : static_cast<uint8_t>((i & 1) ? val & 0xf : val >> 4));
    } else if (val == 0) {  // end of line
      x = 0;
      --y;
      if (y < -1) return IK_MISC_BAD_DATA;
    } else if (val == 1) {  // end of bitmap
      return IK_MISC_OK;
    } else if (val == 2) {  // delta: skipped pixels keep palette index 0
      if (pos + 2 > n) return IK_MISC_TRUNCATED;
      x += src[pos];
      y -= src[pos + 1];
      pos += 2;
      if (y < 0) return IK_MISC_BAD_DATA;
    } else {  // absolute mode: `val` literal indices, word-aligned
      const int count = val;
      const size_t bytes =
          bpp == 8 ? static_cast<size_t>(count)
                   : (static_cast<size_t>(count) + 1) / 2;
      const size_t padded = (bytes + 1) & ~1ull;
      if (pos + padded > n) return IK_MISC_TRUNCATED;
      for (int i = 0; i < count; ++i) {
        const uint8_t b = src[pos + (bpp == 8 ? i : i / 2)];
        put(bpp == 8 ? b
                     : static_cast<uint8_t>((i & 1) ? b & 0xf : b >> 4));
      }
      pos += padded;
    }
  }
  return IK_MISC_OK;  // stream ended without EOF marker: tolerated
}

}  // namespace

IK_EXPORT int ik_bmp_parse(const uint8_t* d, size_t len, IkMiscInfo* out) {
  BmpState st;
  const int rc = BmpParse(d, len, &st);
  out->width = st.width;
  out->height = st.height;
  out->channels = st.channels;
  return rc;
}

IK_EXPORT int ik_bmp_decode(const uint8_t* d, size_t len, uint8_t* out,
                            size_t out_cap) {
  BmpState st;
  const int rc = BmpParse(d, len, &st);
  if (rc != IK_MISC_OK) return rc;
  const size_t need = static_cast<size_t>(st.width) * st.height * 3;
  if (out_cap < need) return IK_MISC_BUFFER;

  auto expand_index = [&](int pi, uint8_t* dst3) -> int {
    if (pi >= st.palette_size) return IK_MISC_BAD_DATA;
    const uint8_t* e = st.palette + 4 * pi;
    dst3[0] = e[2];
    dst3[1] = e[1];
    dst3[2] = e[0];
    return IK_MISC_OK;
  };

  if (st.comp != 0) {  // RLE8 / RLE4
    std::vector<uint8_t> idx;
    const int rc2 = BmpRleDecode(d + st.pix_off, len - st.pix_off, st.width,
                                 st.height, st.bpp, &idx);
    if (rc2 != IK_MISC_OK) return rc2;
    for (size_t i = 0; i < idx.size(); ++i) {
      const int rc3 = expand_index(idx[i], out + i * 3);
      if (rc3 != IK_MISC_OK) return rc3;
    }
    return IK_MISC_OK;
  }

  const size_t stride =
      ((static_cast<size_t>(st.width) * st.bpp + 7) / 8 + 3) & ~3ull;
  for (int y = 0; y < st.height; ++y) {
    const int sy = st.top_down ? y : st.height - 1 - y;
    const uint8_t* src = d + st.pix_off + static_cast<size_t>(sy) * stride;
    uint8_t* dst = out + static_cast<size_t>(y) * st.width * 3;
    if (st.bpp == 24) {
      for (int x = 0; x < st.width; ++x) {  // BGR -> RGB
        dst[x * 3 + 0] = src[x * 3 + 2];
        dst[x * 3 + 1] = src[x * 3 + 1];
        dst[x * 3 + 2] = src[x * 3 + 0];
      }
    } else if (st.bpp == 32) {
      for (int x = 0; x < st.width; ++x) {  // BGRX -> RGB
        dst[x * 3 + 0] = src[x * 4 + 2];
        dst[x * 3 + 1] = src[x * 4 + 1];
        dst[x * 3 + 2] = src[x * 4 + 0];
      }
    } else if (st.bpp == 8) {  // 8bpp palette (BGRA entries)
      for (int x = 0; x < st.width; ++x) {
        const int rc2 = expand_index(src[x], dst + x * 3);
        if (rc2 != IK_MISC_OK) return rc2;
      }
    } else {  // 1/4bpp palette, MSB-first packing
      const int per = 8 / st.bpp;
      const int mask = (1 << st.bpp) - 1;
      for (int x = 0; x < st.width; ++x) {
        const int shift = 8 - st.bpp * (1 + (x % per));
        const int pi = (src[x / per] >> shift) & mask;
        const int rc2 = expand_index(pi, dst + x * 3);
        if (rc2 != IK_MISC_OK) return rc2;
      }
    }
  }
  return IK_MISC_OK;
}

IK_EXPORT int ik_misc_version() { return 1; }
