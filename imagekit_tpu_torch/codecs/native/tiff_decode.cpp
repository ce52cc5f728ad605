// Native baseline-TIFF decode: IFD parse, strip assembly, TIFF-variant
// LZW and PackBits decompression, horizontal-differencing predictor, and
// gray/palette/RGB(A) expansion — the host entropy stage of the TIFF
// source path (reference decode arm: src/transform.rs:27-43 via the
// `image` crate, which bundles a baseline TIFF decoder).
//
// Scope: 8-bit samples, chunky (PlanarConfiguration=1), strip-organised,
// Compression 1 (none) / 5 (LZW) / 8+32946 (Deflate) / 32773 (PackBits), Photometric 0/1
// (grayscale) / 2 (RGB[A]) / 3 (palette). Tiled, planar, 16-bit or other
// compressions return IK_TIFF_UNSUPPORTED and callers fall back to the
// host library decoder.

#include <cstdint>
#include <cstring>
#include <vector>

#include <zlib.h>

#ifndef IK_EXPORT
#define IK_EXPORT extern "C" __attribute__((visibility("default")))
#endif

namespace {

constexpr int IK_TIFF_OK = 0;
constexpr int IK_TIFF_TRUNCATED = -1;
constexpr int IK_TIFF_BAD_MAGIC = -2;
constexpr int IK_TIFF_UNSUPPORTED = -3;
constexpr int IK_TIFF_BAD_DATA = -4;
constexpr int IK_TIFF_BAD_DIMS = -5;
constexpr int IK_TIFF_BUFFER = -7;

struct Reader {
  const uint8_t* d = nullptr;
  size_t len = 0;
  bool le = true;  // little-endian ("II")

  uint16_t U16(size_t off) const {
    if (off + 2 > len) return 0;
    return le ? static_cast<uint16_t>(d[off] | (d[off + 1] << 8))
              : static_cast<uint16_t>((d[off] << 8) | d[off + 1]);
  }
  uint32_t U32(size_t off) const {
    if (off + 4 > len) return 0;
    return le ? (d[off] | (d[off + 1] << 8) | (d[off + 2] << 16) |
                 (static_cast<uint32_t>(d[off + 3]) << 24))
              : ((static_cast<uint32_t>(d[off]) << 24) | (d[off + 1] << 16) |
                 (d[off + 2] << 8) | d[off + 3]);
  }
};

// One parsed IFD entry's values (as u32; SHORT/LONG/BYTE supported).
struct Entry {
  uint16_t type = 0;
  uint32_t count = 0;
  size_t value_off = 0;  // offset of the value data in the file
};

struct TiffInfo {
  uint32_t width = 0, height = 0;
  int compression = 1, photometric = 1, spp = 1, predictor = 1;
  int planar = 1;
  int depth = 8;           // bits per sample (8 or 16, uniform)
  bool le = true;          // file byte order (for 16-bit samples)
  int extra_alpha = 0;     // one unassociated/associated alpha sample
  bool palette = false;
  std::vector<uint8_t> colormap;  // 3*256 RGB bytes (high byte of u16)
  std::vector<uint32_t> strip_offsets, strip_counts;
  uint32_t rows_per_strip = 0;
  // tile organisation (tags 322-325); tiled == !tile_offsets.empty()
  uint32_t tile_w = 0, tile_h = 0;
  std::vector<uint32_t> tile_offsets, tile_counts;
};

int TypeSize(uint16_t t) {
  switch (t) {
    case 1: case 2: case 6: case 7: return 1;   // BYTE/ASCII/SBYTE/UNDEF
    case 3: case 8: return 2;                   // SHORT
    case 4: case 9: case 11: return 4;          // LONG/FLOAT
    case 5: case 10: case 12: return 8;         // RATIONAL/DOUBLE
    default: return 0;
  }
}

uint32_t EntryValue(const Reader& r, const Entry& e, uint32_t idx) {
  const int sz = TypeSize(e.type);
  const size_t off = e.value_off + static_cast<size_t>(idx) * sz;
  if (sz == 1) return off < r.len ? r.d[off] : 0;
  if (sz == 2) return r.U16(off);
  return r.U32(off);
}

int ParseTiff(const uint8_t* data, size_t len, TiffInfo* info) {
  Reader r{data, len, true};
  if (len < 8) return IK_TIFF_TRUNCATED;
  if (data[0] == 'I' && data[1] == 'I') {
    r.le = true;
  } else if (data[0] == 'M' && data[1] == 'M') {
    r.le = false;
  } else {
    return IK_TIFF_BAD_MAGIC;
  }
  if (r.U16(2) != 42) return IK_TIFF_BAD_MAGIC;
  const uint32_t ifd = r.U32(4);
  if (ifd + 2 > len) return IK_TIFF_TRUNCATED;
  const uint16_t n = r.U16(ifd);
  if (ifd + 2 + 12u * n > len) return IK_TIFF_TRUNCATED;

  Entry strip_off_e, strip_cnt_e, bps_e, extra_e;
  Entry tile_off_e, tile_cnt_e;
  for (uint16_t i = 0; i < n; ++i) {
    const size_t e = ifd + 2 + 12u * i;
    const uint16_t tag = r.U16(e);
    Entry ent;
    ent.type = r.U16(e + 2);
    ent.count = r.U32(e + 4);
    const int sz = TypeSize(ent.type);
    if (sz == 0) continue;
    const size_t total = static_cast<size_t>(sz) * ent.count;
    ent.value_off = total <= 4 ? e + 8 : r.U32(e + 8);
    if (ent.value_off + total > len) return IK_TIFF_TRUNCATED;
    switch (tag) {
      case 256: info->width = EntryValue(r, ent, 0); break;
      case 257: info->height = EntryValue(r, ent, 0); break;
      case 258: bps_e = ent; break;
      case 259: info->compression = EntryValue(r, ent, 0); break;
      case 262: info->photometric = EntryValue(r, ent, 0); break;
      case 273: strip_off_e = ent; break;
      case 277: info->spp = EntryValue(r, ent, 0); break;
      case 278: info->rows_per_strip = EntryValue(r, ent, 0); break;
      case 279: strip_cnt_e = ent; break;
      case 284: info->planar = EntryValue(r, ent, 0); break;
      case 317: info->predictor = EntryValue(r, ent, 0); break;
      case 320: {  // ColorMap: 3 * 2^bps u16s, R then G then B planes
        info->palette = true;
        const uint32_t per = ent.count / 3;
        if (per == 0 || per > 256) return IK_TIFF_UNSUPPORTED;
        info->colormap.assign(3 * 256, 0);
        for (uint32_t c = 0; c < 3; ++c)
          for (uint32_t j = 0; j < per; ++j)
            info->colormap[c * 256 + j] = static_cast<uint8_t>(
                EntryValue(r, ent, c * per + j) >> 8);
        break;
      }
      case 322: info->tile_w = EntryValue(r, ent, 0); break;
      case 323: info->tile_h = EntryValue(r, ent, 0); break;
      case 324: tile_off_e = ent; break;
      case 325: tile_cnt_e = ent; break;
      case 338: extra_e = ent; break;
      default: break;
    }
  }
  if (info->width == 0 || info->height == 0) return IK_TIFF_BAD_DIMS;
  if (info->width > (1u << 24) || info->height > (1u << 24))
    return IK_TIFF_BAD_DIMS;
  if (info->planar != 1 && info->planar != 2) return IK_TIFF_UNSUPPORTED;
  if (info->planar == 2 && info->spp == 1) info->planar = 1;  // same layout
  if (info->compression != 1 && info->compression != 5 &&
      info->compression != 8 && info->compression != 32946 &&
      info->compression != 32773)
    return IK_TIFF_UNSUPPORTED;
  if (info->photometric > 3) return IK_TIFF_UNSUPPORTED;
  if (info->predictor != 1 && info->predictor != 2)
    return IK_TIFF_UNSUPPORTED;
  // samples must be uniformly 8- or 16-bit (16-bit converts by high byte,
  // the reference's to_rgb8 semantics — same policy as the PNG decoder)
  info->le = r.le;
  if (bps_e.count > 0) {
    const uint32_t d0 = EntryValue(r, bps_e, 0);
    if (d0 != 8 && d0 != 16) return IK_TIFF_UNSUPPORTED;
    for (uint32_t i = 1; i < bps_e.count; ++i)
      if (EntryValue(r, bps_e, i) != d0) return IK_TIFF_UNSUPPORTED;
    info->depth = static_cast<int>(d0);
  }
  if (info->depth == 16 && info->photometric == 3)
    return IK_TIFF_UNSUPPORTED;  // 16-bit palette: fall back
  if (tile_off_e.count > 0) {  // tiled organisation (tags 322-325)
    // TIFF 6.0: tile dims must be multiples of 16
    if (info->tile_w == 0 || info->tile_h == 0 ||
        (info->tile_w & 15) || (info->tile_h & 15))
      return IK_TIFF_BAD_DATA;
    const uint64_t tx = (info->width + info->tile_w - 1) / info->tile_w;
    const uint64_t ty = (info->height + info->tile_h - 1) / info->tile_h;
    // planar tiles: one full tile grid per component, grouped by plane
    const uint64_t ntiles =
        tx * ty * (info->planar == 2 ? info->spp : 1);
    if (tile_cnt_e.count != tile_off_e.count || tile_off_e.count != ntiles)
      return IK_TIFF_BAD_DATA;
    info->tile_offsets.resize(tile_off_e.count);
    info->tile_counts.resize(tile_cnt_e.count);
    for (uint32_t i = 0; i < tile_off_e.count; ++i) {
      info->tile_offsets[i] = EntryValue(r, tile_off_e, i);
      info->tile_counts[i] = EntryValue(r, tile_cnt_e, i);
      if (static_cast<size_t>(info->tile_offsets[i]) +
              info->tile_counts[i] > len)
        return IK_TIFF_TRUNCATED;
    }
  } else {
    if (strip_off_e.count == 0 || strip_cnt_e.count != strip_off_e.count)
      return IK_TIFF_BAD_DATA;
    info->strip_offsets.resize(strip_off_e.count);
    info->strip_counts.resize(strip_cnt_e.count);
    for (uint32_t i = 0; i < strip_off_e.count; ++i) {
      info->strip_offsets[i] = EntryValue(r, strip_off_e, i);
      info->strip_counts[i] = EntryValue(r, strip_cnt_e, i);
      if (static_cast<size_t>(info->strip_offsets[i]) +
              info->strip_counts[i] > len)
        return IK_TIFF_TRUNCATED;
    }
  }
  if (info->rows_per_strip == 0 ||
      info->rows_per_strip > info->height)
    info->rows_per_strip = info->height;
  // sanity: photometric/spp consistency
  if (info->photometric == 2) {
    if (info->spp < 3) return IK_TIFF_BAD_DATA;
    if (info->spp > 4) return IK_TIFF_UNSUPPORTED;
    info->extra_alpha = info->spp == 4 ? 1 : 0;
    if (extra_e.count >= 1) {
      const uint32_t kind = EntryValue(r, extra_e, 0);
      if (kind != 1 && kind != 2 && kind != 0) return IK_TIFF_UNSUPPORTED;
    }
  } else {
    if (info->spp != 1) return IK_TIFF_UNSUPPORTED;
    if (info->photometric == 3 && !info->palette) return IK_TIFF_BAD_DATA;
  }
  return IK_TIFF_OK;
}

// TIFF-variant LZW (MSB-first codes, early-change) -> exactly `want` bytes.
int LzwDecode(const uint8_t* src, size_t n, uint8_t* dst, size_t want) {
  constexpr int kClear = 256, kEoi = 257, kFirst = 258;
  std::vector<int> prefix(4096, -1);
  std::vector<uint8_t> suffix(4096, 0);
  std::vector<uint8_t> stack(4096);
  int next = kFirst, width = 9;
  uint32_t acc = 0;
  int nbits = 0;
  size_t pos = 0, out = 0;
  int prev = -1;

  auto emit = [&](int code, int* first_byte) -> int {
    size_t sp = 0;
    while (code >= kFirst) {
      if (sp >= stack.size() || prefix[code] < 0) return IK_TIFF_BAD_DATA;
      stack[sp++] = suffix[code];
      code = prefix[code];
    }
    if (code >= 256) return IK_TIFF_BAD_DATA;
    *first_byte = code;
    if (out + 1 + sp > want) return IK_TIFF_BAD_DATA;
    dst[out++] = static_cast<uint8_t>(code);
    while (sp > 0) dst[out++] = stack[--sp];
    return IK_TIFF_OK;
  };

  while (out < want) {
    while (nbits < width) {
      if (pos >= n) return IK_TIFF_TRUNCATED;
      acc = (acc << 8) | src[pos++];
      nbits += 8;
    }
    const int code = static_cast<int>((acc >> (nbits - width)) &
                                      ((1u << width) - 1));
    nbits -= width;
    if (code == kEoi) break;
    if (code == kClear) {
      next = kFirst;
      width = 9;
      prev = -1;
      continue;
    }
    int first = 0;
    if (prev < 0) {
      if (code >= kFirst) return IK_TIFF_BAD_DATA;
      const int rc = emit(code, &first);
      if (rc != IK_TIFF_OK) return rc;
    } else {
      if (code < next) {
        const int rc = emit(code, &first);
        if (rc != IK_TIFF_OK) return rc;
        if (next < 4096) {
          prefix[next] = prev;
          suffix[next] = static_cast<uint8_t>(first);
          ++next;
        }
      } else if (code == next && next < 4096) {  // KwKwK
        // new entry = prev's string + its own first byte; add it first,
        // then emit it (the code refers to the entry being defined)
        int walk = prev;
        while (walk >= kFirst) walk = prefix[walk];
        prefix[next] = prev;
        suffix[next] = static_cast<uint8_t>(walk);
        ++next;
        const int rc = emit(code, &first);
        if (rc != IK_TIFF_OK) return rc;
      } else {
        return IK_TIFF_BAD_DATA;
      }
    }
    prev = code;
    // early change: TIFF bumps the code width one code early
    if (next == (1 << width) - 1 && width < 12) ++width;
  }
  return out == want ? IK_TIFF_OK : IK_TIFF_TRUNCATED;
}

// Deflate (compression 8 "Adobe" / 32946 legacy): a plain zlib stream
// per strip/tile, inflated to exactly `want` bytes.
int ZipDecode(const uint8_t* src, size_t n, uint8_t* dst, size_t want) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return IK_TIFF_BAD_DATA;
  zs.next_in = const_cast<uint8_t*>(src);
  zs.avail_in = static_cast<uInt>(n);
  zs.next_out = dst;
  zs.avail_out = static_cast<uInt>(want);
  const int rc = inflate(&zs, Z_FINISH);
  const size_t got = want - zs.avail_out;
  inflateEnd(&zs);
  if (got != want) return IK_TIFF_TRUNCATED;
  if (rc != Z_STREAM_END && rc != Z_OK && rc != Z_BUF_ERROR)
    return IK_TIFF_BAD_DATA;
  return IK_TIFF_OK;
}

int PackBitsDecode(const uint8_t* src, size_t n, uint8_t* dst, size_t want) {
  size_t pos = 0, out = 0;
  while (out < want) {
    if (pos >= n) return IK_TIFF_TRUNCATED;
    const int8_t ctl = static_cast<int8_t>(src[pos++]);
    if (ctl >= 0) {
      const size_t cnt = static_cast<size_t>(ctl) + 1;
      if (pos + cnt > n || out + cnt > want) return IK_TIFF_BAD_DATA;
      std::memcpy(dst + out, src + pos, cnt);
      pos += cnt;
      out += cnt;
    } else if (ctl != -128) {
      const size_t cnt = static_cast<size_t>(-ctl) + 1;
      if (out + cnt > want) return IK_TIFF_BAD_DATA;
      std::memset(dst + out, src[pos], cnt);
      ++pos;
      out += cnt;
    }
  }
  return IK_TIFF_OK;
}

}  // namespace

struct IkTiffInfo {
  int32_t width, height, channels;
};

IK_EXPORT int ik_tiff_parse(const uint8_t* data, size_t len,
                            IkTiffInfo* out) {
  TiffInfo info;
  const int rc = ParseTiff(data, len, &info);
  out->width = static_cast<int32_t>(info.width);
  out->height = static_cast<int32_t>(info.height);
  out->channels = info.extra_alpha ? 4 : 3;
  return rc;
}

IK_EXPORT int ik_tiff_decode(const uint8_t* data, size_t len, uint8_t* out,
                             size_t out_cap) {
  TiffInfo info;
  int rc = ParseTiff(data, len, &info);
  if (rc != IK_TIFF_OK) return rc;
  const size_t W = info.width, H = info.height;
  const int spp = info.spp;
  const int oc = info.extra_alpha ? 4 : 3;
  if (out_cap < W * H * static_cast<size_t>(oc)) return IK_TIFF_BUFFER;

  const int sbytes = info.depth / 8;
  const size_t row = W * spp * sbytes;
  std::vector<uint8_t> pixels(row * H);

  auto decompress = [&](const uint8_t* src, size_t src_n, uint8_t* dst,
                        size_t want) -> int {
    switch (info.compression) {
      case 1:
        if (src_n < want) return IK_TIFF_TRUNCATED;
        std::memcpy(dst, src, want);
        return IK_TIFF_OK;
      case 5:
        return LzwDecode(src, src_n, dst, want);
      case 8:
      case 32946:
        return ZipDecode(src, src_n, dst, want);
      default:
        return PackBitsDecode(src, src_n, dst, want);
    }
  };
  // horizontal differencing predictor inverts per row, per sample lane
  // (16-bit lanes add as 16-bit words in file byte order); it is defined
  // for (and applied by libtiff/PIL only under) LZW-class codecs — the
  // tag is ignored on uncompressed/PackBits data
  auto unfilter = [&](uint8_t* base, size_t rows, size_t rowlen,
                      int nlanes) {
    if (info.predictor != 2 ||
        (info.compression != 5 && info.compression != 8 &&
         info.compression != 32946))
      return;
    for (size_t yy = 0; yy < rows; ++yy) {
      uint8_t* r = base + yy * rowlen;
      if (sbytes == 1) {
        for (size_t i = nlanes; i < rowlen; ++i) r[i] += r[i - nlanes];
      } else {
        const size_t lane = static_cast<size_t>(nlanes) * 2;
        for (size_t i = lane; i < rowlen; i += 2) {
          uint32_t prev, cur;
          if (info.le) {
            prev = r[i - lane] | (r[i - lane + 1] << 8);
            cur = (r[i] | (r[i + 1] << 8)) + prev;
            r[i] = cur & 0xff;
            r[i + 1] = (cur >> 8) & 0xff;
          } else {
            prev = (r[i - lane] << 8) | r[i - lane + 1];
            cur = (((r[i] << 8) | r[i + 1]) + prev) & 0xffff;
            r[i] = (cur >> 8) & 0xff;
            r[i + 1] = cur & 0xff;
          }
        }
      }
    }
  };

  if (!info.tile_offsets.empty()) {
    // tiles decode at full padded tile geometry, then place clipped;
    // planar tiles carry one component each (grid repeated per plane)
    const int tile_spp = info.planar == 2 ? 1 : spp;
    const size_t tw = info.tile_w, th = info.tile_h;
    const size_t trow = tw * tile_spp * sbytes;
    const size_t tx = (W + tw - 1) / tw;
    const size_t per_plane = info.tile_offsets.size() /
                             (info.planar == 2 ? spp : 1);
    std::vector<uint8_t> tbuf(trow * th);
    for (size_t t = 0; t < info.tile_offsets.size(); ++t) {
      rc = decompress(data + info.tile_offsets[t], info.tile_counts[t],
                      tbuf.data(), tbuf.size());
      if (rc != IK_TIFF_OK) return rc;
      unfilter(tbuf.data(), th, trow, tile_spp);
      const size_t g = t % per_plane;           // position in the grid
      const int c = static_cast<int>(t / per_plane);  // component (planar)
      const size_t ox = (g % tx) * tw, oy = (g / tx) * th;
      const size_t cols = tw < W - ox ? tw : W - ox;
      const size_t rows2 = th < H - oy ? th : H - oy;
      if (info.planar == 2) {
        for (size_t yy = 0; yy < rows2; ++yy) {
          const uint8_t* srow = tbuf.data() + yy * trow;
          uint8_t* drow = pixels.data() + (oy + yy) * row;
          for (size_t x = 0; x < cols; ++x)
            for (int b = 0; b < sbytes; ++b)
              drow[((ox + x) * spp + c) * sbytes + b] =
                  srow[x * sbytes + b];
        }
      } else {
        for (size_t yy = 0; yy < rows2; ++yy)
          std::memcpy(
              pixels.data() + (oy + yy) * row + ox * spp * sbytes,
              tbuf.data() + yy * trow, cols * spp * sbytes);
      }
    }
  } else if (info.planar == 2) {
    // planar strips: all of component 0's strips, then component 1's, ...
    const size_t prow = W * sbytes;
    const size_t spp_strips =
        (H + info.rows_per_strip - 1) / info.rows_per_strip;
    if (info.strip_offsets.size() !=
        spp_strips * static_cast<size_t>(spp))
      return IK_TIFF_BAD_DATA;
    std::vector<uint8_t> plane(prow * H);
    for (int c = 0; c < spp; ++c) {
      size_t y0 = 0;
      for (size_t s = 0; s < spp_strips; ++s) {
        const size_t rows =
            y0 + info.rows_per_strip <= H ? info.rows_per_strip : H - y0;
        const size_t si = static_cast<size_t>(c) * spp_strips + s;
        uint8_t* dst = plane.data() + y0 * prow;
        rc = decompress(data + info.strip_offsets[si],
                        info.strip_counts[si], dst, rows * prow);
        if (rc != IK_TIFF_OK) return rc;
        unfilter(dst, rows, prow, 1);
        y0 += rows;
      }
      // interleave this component into the chunky pixel buffer
      for (size_t i = 0; i < W * H; ++i)
        for (int b = 0; b < sbytes; ++b)
          pixels[(i * spp + c) * sbytes + b] = plane[i * sbytes + b];
    }
  } else {
    size_t y0 = 0;
    for (size_t s = 0; s < info.strip_offsets.size(); ++s) {
      const size_t rows =
          y0 + info.rows_per_strip <= H ? info.rows_per_strip : H - y0;
      if (rows == 0) break;
      uint8_t* dst = pixels.data() + y0 * row;
      rc = decompress(data + info.strip_offsets[s], info.strip_counts[s],
                      dst, rows * row);
      if (rc != IK_TIFF_OK) return rc;
      unfilter(dst, rows, row, spp);
      y0 += rows;
    }
    if (y0 < H) return IK_TIFF_TRUNCATED;
  }

  // 16-bit -> 8-bit by high byte, in place (row layout shrinks)
  if (sbytes == 2) {
    const int hi = info.le ? 1 : 0;
    for (size_t y = 0; y < H; ++y) {
      const uint8_t* srow = pixels.data() + y * row;
      uint8_t* drow = pixels.data() + y * W * spp;
      for (size_t i = 0; i < W * static_cast<size_t>(spp); ++i)
        drow[i] = srow[i * 2 + hi];
    }
  }
  const size_t row8 = W * spp;

  // expand to RGB(A)
  for (size_t y = 0; y < H; ++y) {
    const uint8_t* src = pixels.data() + y * row8;
    uint8_t* dst = out + y * W * oc;
    switch (info.photometric) {
      case 0:  // white-is-zero grayscale
        for (size_t x = 0; x < W; ++x) {
          const uint8_t g = static_cast<uint8_t>(255 - src[x]);
          dst[x * 3 + 0] = g;
          dst[x * 3 + 1] = g;
          dst[x * 3 + 2] = g;
        }
        break;
      case 1:  // black-is-zero grayscale
        for (size_t x = 0; x < W; ++x) {
          const uint8_t g = src[x];
          dst[x * 3 + 0] = g;
          dst[x * 3 + 1] = g;
          dst[x * 3 + 2] = g;
        }
        break;
      case 2:  // RGB / RGBA passthrough
        std::memcpy(dst, src, W * spp);
        break;
      case 3:  // palette (ColorMap high bytes)
        for (size_t x = 0; x < W; ++x) {
          const uint8_t i = src[x];
          dst[x * 3 + 0] = info.colormap[i];
          dst[x * 3 + 1] = info.colormap[256 + i];
          dst[x * 3 + 2] = info.colormap[512 + i];
        }
        break;
    }
  }
  return IK_TIFF_OK;
}

IK_EXPORT int ik_tiff_version() { return 1; }
