// TIFF layouts of the port that the pinned decoder refuses, C ABI for ctypes.
//
// tiff_decode.cpp (a copy of the reference's, pinned byte-equal) decodes
// 8- and 16-bit gray, palette and RGB(A) TIFFs in none, LZW, deflate and
// PackBits; it refuses the rest with -3, and the reference then decodes the
// file with Pillow (libtiff for every compressed layout). This decoder is
// the port's own, for that case only, written to give Pillow 12's pixels:
//
//   - bilevel (photometric 0 WhiteIsZero, 1 BlackIsZero; 1 bit) in none,
//     PackBits, LZW, deflate, CCITT modified Huffman (2), T.4 Group 3 1-D
//     and 2-D (3, any T4Options fill) and T.6 Group 4 (4);
//   - 2- and 4-bit gray (Pillow's L;2 x85, L;4 x17, inverted for
//     WhiteIsZero) and 1-, 2- and 4-bit palette (the ColorMap's high
//     bytes), in the four byte-oriented compressions;
//   - those in FillOrder 2: each byte's bits reversed before any
//     decompression, as libtiff does;
//   - 32-bit gray: float (SampleFormat 3, photometric 0 or 1, Pillow's F)
//     and signed or little-endian unsigned integers (Pillow's I), as
//     Pillow's convert("RGB") makes a byte of them (Gray32), in the
//     byte-oriented compressions with either predictor (2, or 3 for
//     floats); a big-endian file's samples through libtiff come out
//     byte-swapped, as Pillow reads them;
//   - CMYK (photometric 5, 4 samples of 8 bits, chunky or planar, strips
//     or tiles, the pinned copy's compressions and predictor; of 16 bits,
//     chunky, the high byte of each as Pillow's CMYK;16L/B; of 8 bits with
//     one or two unspecified extra samples, chunky, dropped): written out
//     as the four inks as stored; the caller turns them to RGB with
//     Pillow's cmyk2rgb (ops/color.py::cmyk_to_rgb on inverted planes);
//   - gray and palette with unassociated alpha (Pillow's LA and PA:
//     photometric 1 or 3, 8-bit, 2 samples, ExtraSamples 2, chunky, the
//     pinned copy's compressions and predictor): written out as RGBA.
//
// JPEG-compressed TIFFs (compression 7, 8-bit, strips or tiles: YCbCr with
// YCbCrSubSampling of 1 or 2 on each axis, chunky; RGB, RGB with one extra
// sample (unspecified, associated or unassociated alpha), gray and CMYK,
// chunky or planar; gray with alpha, chunky) are not
// decoded here: ik_tiffx_jpeg_segments returns their segment grid, each
// segment's byte range and the JPEGTables' range, and
// ik_tiffx_jpeg_parse_many and ik_tiffx_jpeg_decode_many entropy-decode a
// page's segments in two calls, each segment an independent JPEG as
// libtiff makes it (spliced onto the tables in one scratch buffer, a
// segment at a time, and its levels copied to its place in the page's
// planes), through the pinned decoder (jpeg_entropy.cpp) and the one for
// two and four components (jpeg4_decode.cpp), which the loader links
// beside this file. libtiff reads the tables once; a splice copies them for
// each segment, so a JPEGTables longer than kMaxTables, and a page whose
// splices would copy more than kSpliceFactor times the file (overlapping
// segments, or many over large tables), are refused as corrupt.
//
// Old-style JPEG TIFFs (compression 6, which Pillow reads as YCbCr through
// libtiff: three 8-bit samples, chunky, baseline) are one JPEG stream a
// page, which ik_tiffx_ojpeg_stream assembles as libtiff does
// (OldJpegStream): the JPEGInterchangeFormat stream, the strip's own, or
// the tables-in-tags form's; the same two calls decode it as one segment.
//
// Tags take Pillow's defaults where they are missing: BitsPerSample 1,
// PhotometricInterpretation 0, SamplesPerPixel 1 (3 for an old-style
// JPEG). A file whose layout has no mode in Pillow's reader (PillowKeys:
// a 16-bit palette, a 12-bit JPEG, CMYK with alpha, FillOrder 2 beyond
// gray and palette, float samples of 16 or 64 bits, ...) is -8, as is one
// Pillow's read fails on (YCbCr without compression, which its raw reader
// runs out of; planar YCbCr JPEG and planar CMYK with extra samples): the
// reference answers those as corrupt. Everything else (CIELab, YCbCr
// compressed without JPEG, YCbCrSubSampling 4, planar 16-bit CMYK, an
// old-style JPEG of one sample or assembled from several strips, other
// compressions, Orientation 5-8) is -3. Corrupt data is an error; so is a
// CCITT row whose runs overshoot its width, which libtiff pads with a
// warning: every write is bounded by its row before it is made.
//
// The LZW, deflate and PackBits decoders are copies of tiff_decode.cpp's,
// which keeps them in an anonymous namespace. The exported names are
// ik_tiffx_*: the loader links every native source into one library.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

#include <zlib.h>

#define IK_EXPORT extern "C" __attribute__((visibility("default")))

namespace {

constexpr int kOk = 0;
constexpr int kTruncated = -1;
constexpr int kBadMagic = -2;
constexpr int kUnsupported = -3;
constexpr int kBadData = -4;
constexpr int kBadDims = -5;
constexpr int kBuffer = -7;
// A layout Pillow refuses (its reader has no mode for it, or its read of
// the strips fails): the reference answers it as corrupt data
constexpr int kRefused = -8;

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
  // A RATIONAL as libtiff reads one into a float: num / den in float, 0
  // for a denominator of 0
  float Rational(size_t off) const {
    const uint32_t num = U32(off), den = U32(off + 4);
    return den == 0 ? 0.0f : static_cast<float>(num) / static_cast<float>(den);
  }
};

struct Entry {
  uint16_t type = 0;
  uint32_t count = 0;
  size_t value_off = 0;
};

int TypeSize(uint16_t t) {
  switch (t) {
    case 1: case 2: case 6: case 7: return 1;
    case 3: case 8: return 2;
    case 4: case 9: case 11: return 4;
    case 5: case 10: case 12: return 8;
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

struct Tiff {
  uint32_t width = 0, height = 0;
  int compression = 1, photometric = 0, spp = 1, predictor = 1, planar = 1;
  int bits = 1;
  int fill = 1;    // FillOrder
  int format = 1;  // SampleFormat: one value for every sample
  bool le = true;
  uint32_t t4 = 0;  // T4Options
  std::vector<uint8_t> colormap;  // per R, then per G, then per B
  uint32_t colors = 0;
  std::vector<uint32_t> offsets, counts;
  uint32_t rows_per_strip = 0;
  uint32_t tile_w = 0, tile_h = 0;
  bool tiled = false;
  bool alpha = false;  // the image has alpha (LA, PA; RGBA and LA JPEG)
  int extra = -1;      // the one ExtraSamples value, -1 for none
  // JPEG (compression 7): YCbCrSubSampling (0 where the tag is missing:
  // libtiff then takes the first segment's sampling) and JPEGTables
  int sub_h = 0, sub_v = 0;
  size_t tables_off = 0, tables_len = 0;
  // old-style JPEG (compression 6): JPEGInterchangeFormat and its length
  // as libtiff corrects them, JPEGProc, JPEGRestartInterval and the tables
  // in tags (one offset a component each)
  uint64_t jif_off = 0, jif_len = 0;
  int jpeg_proc = 1;
  uint32_t restart = 0;
  Entry qtabs_e, dctabs_e, actabs_e;
  // YCbCrCoefficients and ReferenceBlackWhite, libtiff's defaults
  float luma[3] = {0.299f, 0.587f, 0.114f};
  float refbw[6] = {0.0f, 255.0f, 128.0f, 255.0f, 128.0f, 255.0f};
  // YCbCr without compression: what Pillow's read leaves unread where it
  // runs out of the file (RawYccLeft); -1 for none
  int64_t unread = -1;
};

constexpr int kOldJpeg = 6, kJpeg = 7;
// Four DQT and four DHT segments take under 2.5 kB
constexpr uint64_t kMaxTables = 1 << 16;
// The Annex K Huffman tables the caller may splice ahead of a segment's own
constexpr uint64_t kStdDhtLen = 420;
constexpr uint64_t kSpliceFactor = 64;

bool Ccitt(int c) { return c == 2 || c == 3 || c == 4; }

// The layouts of the header comment with JPEG compression, 8 bits (libtiff's
// libjpeg takes no other precision), chunky or planar: photometric 6 (3
// samples; planar Pillow refuses), 2 (3, or 4 with one extra sample), 1 (1,
// or 2 with alpha, chunky) or 5 (4).
int CheckJpeg(const Tiff& t) {
  if (t.bits != 8) return kRefused;  // "Improper JPEG data precision"
  switch (t.photometric) {
    case 6:
      if (t.planar != 1) return kRefused;  // Pillow: "decoder error -2"
      if (t.spp != 3 || t.sub_h > 2 || t.sub_v > 2) return kUnsupported;
      return kOk;
    case 2:
      if (t.spp == 3) return kOk;
      return t.spp == 4 && t.extra >= 0 && t.extra <= 2 ? kOk
                                                         : kUnsupported;
    case 1:  // Pillow reads a planar gray + alpha page's alpha as 0
      return t.spp == 1 || (t.spp == 2 && t.alpha && t.planar == 1)
                 ? kOk : kUnsupported;
    case 5: return t.spp == 4 ? kOk : kUnsupported;
    default: return kUnsupported;
  }
}

// -- the modes Pillow's TIFF reader has ----------------------------------------

// A key of TiffImagePlugin.OPEN_INFO: (byte orders, photometric,
// SampleFormat, FillOrder, BitsPerSample, ExtraSamples); byte orders bit 0
// for "II", bit 1 for "MM". Pillow refuses a file whose key is not one of
// these before it reads a strip ("cannot identify image file").
struct PillowKey {
  uint8_t orders, photo, format, fill, n;
  uint8_t bps[6];
  uint8_t nx;
  uint16_t extra[3];
};

const PillowKey kPillowKeys[] = {
    {3, 0, 1, 1, 1, {1}, 0, {}},
    {3, 0, 1, 1, 1, {2}, 0, {}},
    {3, 0, 1, 1, 1, {4}, 0, {}},
    {3, 0, 1, 1, 1, {8}, 0, {}},
    {1, 0, 1, 1, 1, {16}, 0, {}},
    {3, 0, 1, 2, 1, {1}, 0, {}},
    {3, 0, 1, 2, 1, {2}, 0, {}},
    {3, 0, 1, 2, 1, {4}, 0, {}},
    {3, 0, 1, 2, 1, {8}, 0, {}},
    {3, 0, 3, 1, 1, {32}, 0, {}},
    {3, 1, 1, 1, 1, {1}, 0, {}},
    {3, 1, 1, 1, 1, {2}, 0, {}},
    {3, 1, 1, 1, 1, {4}, 0, {}},
    {3, 1, 1, 1, 1, {8}, 0, {}},
    {3, 1, 1, 1, 2, {8, 8}, 1, {2}},
    {1, 1, 1, 1, 1, {12}, 0, {}},
    {3, 1, 1, 1, 1, {16}, 0, {}},
    {1, 1, 1, 1, 1, {32}, 0, {}},
    {3, 1, 1, 2, 1, {1}, 0, {}},
    {3, 1, 1, 2, 1, {2}, 0, {}},
    {3, 1, 1, 2, 1, {4}, 0, {}},
    {3, 1, 1, 2, 1, {8}, 0, {}},
    {1, 1, 1, 2, 1, {16}, 0, {}},
    {3, 1, 2, 1, 1, {8}, 0, {}},
    {3, 1, 2, 1, 1, {16}, 0, {}},
    {3, 1, 2, 1, 1, {32}, 0, {}},
    {3, 1, 3, 1, 1, {32}, 0, {}},
    {3, 2, 1, 1, 3, {8, 8, 8}, 0, {}},
    {3, 2, 1, 1, 4, {8, 8, 8, 8}, 0, {}},
    {3, 2, 1, 1, 4, {8, 8, 8, 8}, 1, {0}},
    {3, 2, 1, 1, 4, {8, 8, 8, 8}, 1, {1}},
    {3, 2, 1, 1, 4, {8, 8, 8, 8}, 1, {2}},
    {3, 2, 1, 1, 4, {8, 8, 8, 8}, 1, {999}},
    {3, 2, 1, 1, 5, {8, 8, 8, 8, 8}, 2, {0, 0}},
    {3, 2, 1, 1, 5, {8, 8, 8, 8, 8}, 2, {1, 0}},
    {3, 2, 1, 1, 5, {8, 8, 8, 8, 8}, 2, {2, 0}},
    {3, 2, 1, 1, 6, {8, 8, 8, 8, 8, 8}, 3, {0, 0, 0}},
    {3, 2, 1, 1, 6, {8, 8, 8, 8, 8, 8}, 3, {1, 0, 0}},
    {3, 2, 1, 1, 6, {8, 8, 8, 8, 8, 8}, 3, {2, 0, 0}},
    {3, 2, 1, 1, 3, {16, 16, 16}, 0, {}},
    {3, 2, 1, 1, 4, {16, 16, 16, 16}, 0, {}},
    {3, 2, 1, 1, 4, {16, 16, 16, 16}, 1, {0}},
    {3, 2, 1, 1, 4, {16, 16, 16, 16}, 1, {1}},
    {3, 2, 1, 1, 4, {16, 16, 16, 16}, 1, {2}},
    {3, 2, 1, 2, 3, {8, 8, 8}, 0, {}},
    {3, 3, 1, 1, 1, {1}, 0, {}},
    {3, 3, 1, 1, 1, {2}, 0, {}},
    {3, 3, 1, 1, 1, {4}, 0, {}},
    {3, 3, 1, 1, 1, {8}, 0, {}},
    {3, 3, 1, 1, 2, {8, 8}, 1, {0}},
    {3, 3, 1, 1, 2, {8, 8}, 1, {2}},
    {3, 3, 1, 2, 1, {1}, 0, {}},
    {3, 3, 1, 2, 1, {2}, 0, {}},
    {3, 3, 1, 2, 1, {4}, 0, {}},
    {3, 3, 1, 2, 1, {8}, 0, {}},
    {3, 5, 1, 1, 4, {8, 8, 8, 8}, 0, {}},
    {3, 5, 1, 1, 5, {8, 8, 8, 8, 8}, 1, {0}},
    {3, 5, 1, 1, 6, {8, 8, 8, 8, 8, 8}, 2, {0, 0}},
    {3, 5, 1, 1, 4, {16, 16, 16, 16}, 0, {}},
    {3, 6, 1, 1, 1, {8}, 0, {}},
    {3, 6, 1, 1, 3, {8, 8, 8}, 0, {}},
    {3, 8, 1, 1, 3, {8, 8, 8}, 0, {}},
};

// Whether Pillow has a mode for the key. `format` is 0 where the
// SampleFormat values differ (Pillow keeps them all; no key has several).
bool PillowReads(bool le, int photo, int format, int fill, int n,
                 const uint32_t* bps, int nx, const uint32_t* extra) {
  for (const PillowKey& k : kPillowKeys) {
    if (!((k.orders >> (le ? 0 : 1)) & 1) || k.photo != photo ||
        k.format != format || k.fill != fill || k.n != n || k.nx != nx)
      continue;
    bool same = true;
    for (int i = 0; i < n && same; ++i) same = k.bps[i] == bps[i];
    for (int i = 0; i < nx && same; ++i) same = k.extra[i] == extra[i];
    if (same) return true;
  }
  return false;
}

int64_t RawYccLeft(size_t len, const Tiff& t);

int Parse(const uint8_t* data, size_t len, Tiff* t) {
  Reader r{data, len, true};
  if (len < 8) return kTruncated;
  if (data[0] == 'I' && data[1] == 'I') {
    r.le = true;
  } else if (data[0] == 'M' && data[1] == 'M') {
    r.le = false;
  } else {
    return kBadMagic;
  }
  t->le = r.le;
  if (r.U16(2) != 42) return kBadMagic;
  const uint32_t ifd = r.U32(4);
  if (static_cast<size_t>(ifd) + 2 > len) return kTruncated;
  const uint16_t n = r.U16(ifd);
  if (ifd + 2 + 12u * n > len) return kTruncated;

  Entry off_e, cnt_e, bps_e, extra_e, fmt_e, cmap_e, tables_e, sub_e;
  Entry spp_e, luma_e, refbw_e;
  bool tiles = false;
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
    if (ent.value_off + total > len) return kTruncated;
    switch (tag) {
      case 256: t->width = EntryValue(r, ent, 0); break;
      case 257: t->height = EntryValue(r, ent, 0); break;
      case 258: bps_e = ent; break;
      case 259: t->compression = EntryValue(r, ent, 0); break;
      case 262: t->photometric = EntryValue(r, ent, 0); break;
      case 266: t->fill = static_cast<int>(EntryValue(r, ent, 0)); break;
      case 273: if (!tiles) off_e = ent; break;
      case 274:  // Orientation: Pillow swaps the size of 5-8
        if (EntryValue(r, ent, 0) >= 5) return kUnsupported;
        break;
      case 277: spp_e = ent; break;
      case 278: t->rows_per_strip = EntryValue(r, ent, 0); break;
      case 279: if (!tiles) cnt_e = ent; break;
      case 284: t->planar = EntryValue(r, ent, 0); break;
      case 292: t->t4 = EntryValue(r, ent, 0); break;
      case 293:  // T6Options: bit 1 is uncompressed mode
        if (EntryValue(r, ent, 0) & 2) return kUnsupported;
        break;
      case 317: t->predictor = EntryValue(r, ent, 0); break;
      case 320: cmap_e = ent; break;
      case 322: t->tile_w = EntryValue(r, ent, 0); break;
      case 323: t->tile_h = EntryValue(r, ent, 0); break;
      case 324: off_e = ent; tiles = true; break;
      case 325: cnt_e = ent; break;
      case 338: extra_e = ent; break;
      case 339: fmt_e = ent; break;
      case 347: tables_e = ent; break;
      case 512: t->jpeg_proc = static_cast<int>(EntryValue(r, ent, 0)); break;
      case 513: t->jif_off = EntryValue(r, ent, 0); break;
      case 514: t->jif_len = EntryValue(r, ent, 0); break;
      case 515: t->restart = EntryValue(r, ent, 0); break;
      case 519: t->qtabs_e = ent; break;
      case 520: t->dctabs_e = ent; break;
      case 521: t->actabs_e = ent; break;
      case 529: luma_e = ent; break;
      case 530: sub_e = ent; break;
      case 532: refbw_e = ent; break;
      default: break;
    }
  }
  if (t->width == 0 || t->height == 0) return kBadDims;
  if (t->width > (1u << 24) || t->height > (1u << 24)) return kBadDims;
  if (t->planar != 1 && t->planar != 2) return kUnsupported;
  const int c = t->compression;
  if (c != 1 && c != 5 && c != 8 && c != 32946 && c != 32773 && !Ccitt(c) &&
      c != kJpeg && c != kOldJpeg)
    return kUnsupported;
  if (t->predictor < 1 || t->predictor > 3) return kUnsupported;
  if (Ccitt(c) && (t->t4 & 2)) return kUnsupported;  // uncompressed mode
  // Pillow's reading of the tags: an old-style JPEG is YCbCr whatever its
  // photometric; SamplesPerPixel 3 where an old-style JPEG of RGB or YCbCr
  // has none, else 1; BitsPerSample (1 where missing) cut to the samples,
  // or one value for every sample; a count short of the samples, or more
  // samples than any of its modes, is refused
  if (c == kOldJpeg) t->photometric = 6;
  const int p = t->photometric;
  t->spp = spp_e.count > 0 ? static_cast<int>(EntryValue(r, spp_e, 0))
           : c == kOldJpeg && (p == 2 || p == 6) ? 3 : 1;
  if (t->spp < 1 || t->spp > 6) return kRefused;
  uint32_t bps[6], nb = bps_e.count > 0 ? bps_e.count : 1;
  if (nb > static_cast<uint32_t>(t->spp)) nb = t->spp;
  for (uint32_t i = 0; i < nb; ++i)
    bps[i] = bps_e.count > 0 ? EntryValue(r, bps_e, i) : 1;
  if (nb == 1)
    for (; nb < static_cast<uint32_t>(t->spp); ++nb) bps[nb] = bps[0];
  if (nb != static_cast<uint32_t>(t->spp))
    return kBadData;  // "unknown data organization"
  t->bits = static_cast<int>(bps[0]);
  // SampleFormat: one value, or several that are all 1, stand for every
  // sample; several others match no mode of Pillow's
  t->format = fmt_e.count > 0 ? static_cast<int>(EntryValue(r, fmt_e, 0)) : 1;
  for (uint32_t i = 1; i < fmt_e.count; ++i)
    if (EntryValue(r, fmt_e, i) != 1 || t->format != 1) t->format = 0;
  uint32_t extra[3] = {0, 0, 0};
  const uint32_t nx = extra_e.count;
  for (uint32_t i = 0; i < nx && i < 3; ++i)
    extra[i] = EntryValue(r, extra_e, i);
  if (nx > 3 || !PillowReads(r.le, p, t->format, t->fill,
                             static_cast<int>(nb), bps,
                             static_cast<int>(nx), extra))
    return kRefused;
  // the layouts of the header comment, else -3
  if (nx == 1) t->extra = static_cast<int>(extra[0]);
  t->alpha = t->extra == 2 || (t->extra == 1 && c == kJpeg);
  const int b = t->bits;
  bool raw_ycc = false;
  if (c == kJpeg) {
    if (sub_e.count >= 2) {
      t->sub_h = static_cast<int>(EntryValue(r, sub_e, 0));
      t->sub_v = static_cast<int>(EntryValue(r, sub_e, 1));
      if (t->sub_h < 1 || t->sub_v < 1) return kBadData;
    }
    const int rc = CheckJpeg(*t);
    if (rc != kOk) return rc;
    if (tables_e.count > 0) {  // a count of 0 is no tables
      t->tables_off = tables_e.value_off;
      t->tables_len = tables_e.count * TypeSize(tables_e.type);
    }
  } else if (c == kOldJpeg) {
    // three 8-bit samples, chunky, baseline (JPEGProc 1)
    if (t->spp != 3 || b != 8 || t->planar != 1 || t->jpeg_proc != 1)
      return kUnsupported;
    if (sub_e.count >= 2) {  // the tables-in-tags form's frame
      t->sub_h = static_cast<int>(EntryValue(r, sub_e, 0));
      t->sub_v = static_cast<int>(EntryValue(r, sub_e, 1));
    } else {
      t->sub_h = t->sub_v = 2;
    }
    if (t->sub_h < 1 || t->sub_h > 2 || t->sub_v < 1 || t->sub_v > 2)
      return kUnsupported;
    for (uint32_t i = 0; i < 3 && i < luma_e.count; ++i)
      t->luma[i] = luma_e.type == 5 ? r.Rational(luma_e.value_off + 8 * i)
                                    : static_cast<float>(
                                          EntryValue(r, luma_e, i));
    for (uint32_t i = 0; i < 6 && i < refbw_e.count; ++i)
      t->refbw[i] = refbw_e.type == 5
                        ? r.Rational(refbw_e.value_off + 8 * i)
                        : static_cast<float>(EntryValue(r, refbw_e, i));
    // libtiff: an interchange format past the file is none; a length of 0,
    // or past the file, runs to its end
    if (t->jif_off >= len) t->jif_off = 0;
    if (t->jif_off == 0) {
      t->jif_len = 0;
    } else if (t->jif_len == 0 || t->jif_len > len - t->jif_off) {
      t->jif_len = len - t->jif_off;
    }
  } else if (t->alpha) {  // Pillow's LA and PA
    if ((p != 1 && p != 3) || t->spp != 2 || b != 8 || t->planar != 1)
      return kUnsupported;
    if (p == 3) {
      if (cmap_e.count < 3 * 256u) return kBadData;
      t->colors = cmap_e.count / 3;
      if (t->colors > 65536) return kBadData;
      t->colormap.resize(3 * static_cast<size_t>(t->colors));
      for (uint32_t j = 0; j < 3 * t->colors; ++j)
        t->colormap[j] = static_cast<uint8_t>(EntryValue(r, cmap_e, j) >> 8);
    }
  } else if (p == 0 || p == 1) {
    if (t->spp != 1) return kUnsupported;
    if (Ccitt(c) && b != 1) return kBadData;  // libtiff: 1 bit for fax
    // 1-, 2- and 4-bit gray; 32-bit float and integer gray (Pillow's F and
    // I), the key having checked their photometric and format
    if (b != 1 && b != 2 && b != 4 && b != 32) return kUnsupported;
  } else if (p == 3) {
    if (t->spp != 1 || Ccitt(c)) return kUnsupported;
    if (b != 1 && b != 2 && b != 4) return kUnsupported;
    if (cmap_e.count < 3) return kBadData;
    t->colors = cmap_e.count / 3;
    if (t->colors > 65536) return kBadData;
    t->colormap.resize(3 * static_cast<size_t>(t->colors));
    for (uint32_t j = 0; j < 3 * t->colors; ++j)
      t->colormap[j] = static_cast<uint8_t>(EntryValue(r, cmap_e, j) >> 8);
  } else if (p == 5) {
    if (Ccitt(c)) return kUnsupported;
    // 8 bits, chunky or planar; 16 bits, chunky (Pillow reads a planar
    // one's planes as 8-bit bands); 8 bits with one or two extra samples,
    // chunky (a planar one's extra band Pillow cannot read)
    if (t->spp > 4 && t->planar == 2) return kRefused;
    if (b == 16 && t->planar == 2) return kUnsupported;
  } else if (p == 6) {
    // YCbCr without JPEG: Pillow's raw reader takes RGBX, four bytes a
    // pixel, from three, and runs out of the file (RawYccLeft, once the
    // strips are read); libtiff decodes the other compressions, which are
    // not ported
    if (c != 1) return kUnsupported;
    raw_ycc = true;
  } else {
    return kUnsupported;
  }
  if (t->planar == 2 && t->spp == 1) t->planar = 1;  // the same layout
  const bool filtered = c == 5 || c == 8 || c == 32946;
  // libtiff's horizontal differencing takes 8 bits and more only; its
  // floating-point differencing, floats only
  if (filtered && ((t->predictor == 2 && b < 8) ||
                   (t->predictor == 3 && t->format != 3)))
    return kBadData;
  const size_t planes = t->planar == 2 ? t->spp : 1;
  size_t want;
  if (tiles) {
    if (t->tile_w == 0 || t->tile_h == 0 || (t->tile_w & 15) ||
        (t->tile_h & 15))
      return kBadData;
    want = ((t->width + t->tile_w - 1) / t->tile_w) *
           static_cast<size_t>((t->height + t->tile_h - 1) / t->tile_h) *
           planes;
  } else {
    if (t->rows_per_strip == 0 || t->rows_per_strip > t->height)
      t->rows_per_strip = t->height;
    want = ((t->height + t->rows_per_strip - 1) / t->rows_per_strip) *
           static_cast<size_t>(planes);
  }
  if (off_e.count == 0 || cnt_e.count != off_e.count || off_e.count != want)
    return kBadData;
  t->tiled = tiles;
  t->offsets.resize(off_e.count);
  t->counts.resize(off_e.count);
  for (uint32_t i = 0; i < off_e.count; ++i) {
    t->offsets[i] = EntryValue(r, off_e, i);
    t->counts[i] = EntryValue(r, cnt_e, i);
    if (static_cast<size_t>(t->offsets[i]) + t->counts[i] > len)
      return kTruncated;
  }
  if (c == kJpeg) {  // what the splices of the header comment copy
    if (t->tables_len > kMaxTables) return kBadData;
    uint64_t spliced = 0;
    for (uint32_t cnt : t->counts) spliced += cnt + t->tables_len + kStdDhtLen;
    if (spliced > kSpliceFactor * static_cast<uint64_t>(len))
      return kBadData;
  }
  // a read that fits the file Pillow makes, of the wrong pixels: not ported
  if (raw_ycc) {
    t->unread = RawYccLeft(len, *t);
    return t->unread >= 0 ? kRefused : kUnsupported;
  }
  return kOk;
}

// -- the byte-oriented decompressors (copies of tiff_decode.cpp's) ---------

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
      if (sp >= stack.size() || prefix[code] < 0) return kBadData;
      stack[sp++] = suffix[code];
      code = prefix[code];
    }
    if (code >= 256) return kBadData;
    *first_byte = code;
    if (out + 1 + sp > want) return kBadData;
    dst[out++] = static_cast<uint8_t>(code);
    while (sp > 0) dst[out++] = stack[--sp];
    return kOk;
  };

  while (out < want) {
    while (nbits < width) {
      if (pos >= n) return kTruncated;
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
      if (code >= kFirst) return kBadData;
      const int rc = emit(code, &first);
      if (rc != kOk) return rc;
    } else {
      if (code < next) {
        const int rc = emit(code, &first);
        if (rc != kOk) return rc;
        if (next < 4096) {
          prefix[next] = prev;
          suffix[next] = static_cast<uint8_t>(first);
          ++next;
        }
      } else if (code == next && next < 4096) {  // KwKwK
        int walk = prev;
        while (walk >= kFirst) walk = prefix[walk];
        prefix[next] = prev;
        suffix[next] = static_cast<uint8_t>(walk);
        ++next;
        const int rc = emit(code, &first);
        if (rc != kOk) return rc;
      } else {
        return kBadData;
      }
    }
    prev = code;
    if (next == (1 << width) - 1 && width < 12) ++width;
  }
  return out == want ? kOk : kTruncated;
}

int ZipDecode(const uint8_t* src, size_t n, uint8_t* dst, size_t want) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return kBadData;
  zs.next_in = const_cast<uint8_t*>(src);
  zs.avail_in = static_cast<uInt>(n);
  zs.next_out = dst;
  zs.avail_out = static_cast<uInt>(want);
  const int rc = inflate(&zs, Z_FINISH);
  const size_t got = want - zs.avail_out;
  inflateEnd(&zs);
  if (got != want) return kTruncated;
  if (rc != Z_STREAM_END && rc != Z_OK && rc != Z_BUF_ERROR) return kBadData;
  return kOk;
}

int PackBitsDecode(const uint8_t* src, size_t n, uint8_t* dst, size_t want) {
  size_t pos = 0, out = 0;
  while (out < want) {
    if (pos >= n) return kTruncated;
    const int8_t ctl = static_cast<int8_t>(src[pos++]);
    if (ctl >= 0) {
      const size_t cnt = static_cast<size_t>(ctl) + 1;
      if (pos + cnt > n || out + cnt > want) return kBadData;
      std::memcpy(dst + out, src + pos, cnt);
      pos += cnt;
      out += cnt;
    } else if (ctl != -128) {
      const size_t cnt = static_cast<size_t>(-ctl) + 1;
      if (out + cnt > want) return kBadData;
      std::memset(dst + out, src[pos], cnt);
      ++pos;
      out += cnt;
    }
  }
  return kOk;
}

// -- CCITT (T.4 / T.6) ------------------------------------------------------

// (code, length, run) of the T.4 tables: terminating codes 0-63, make-up
// codes 64-1728 of each colour, then the extended make-up codes 1792-2560
// both colours share. A run of -1 is the EOL code (000000000001).
struct Code {
  uint16_t code;
  uint8_t len;
  int16_t run;
};

const Code kWhite[] = {
    {0x35, 8, 0},    {0x7, 6, 1},     {0x7, 4, 2},     {0x8, 4, 3},
    {0xB, 4, 4},     {0xC, 4, 5},     {0xE, 4, 6},     {0xF, 4, 7},
    {0x13, 5, 8},    {0x14, 5, 9},    {0x7, 5, 10},    {0x8, 5, 11},
    {0x8, 6, 12},    {0x3, 6, 13},    {0x34, 6, 14},   {0x35, 6, 15},
    {0x2A, 6, 16},   {0x2B, 6, 17},   {0x27, 7, 18},   {0xC, 7, 19},
    {0x8, 7, 20},    {0x17, 7, 21},   {0x3, 7, 22},    {0x4, 7, 23},
    {0x28, 7, 24},   {0x2B, 7, 25},   {0x13, 7, 26},   {0x24, 7, 27},
    {0x18, 7, 28},   {0x2, 8, 29},    {0x3, 8, 30},    {0x1A, 8, 31},
    {0x1B, 8, 32},   {0x12, 8, 33},   {0x13, 8, 34},   {0x14, 8, 35},
    {0x15, 8, 36},   {0x16, 8, 37},   {0x17, 8, 38},   {0x28, 8, 39},
    {0x29, 8, 40},   {0x2A, 8, 41},   {0x2B, 8, 42},   {0x2C, 8, 43},
    {0x2D, 8, 44},   {0x4, 8, 45},    {0x5, 8, 46},    {0xA, 8, 47},
    {0xB, 8, 48},    {0x52, 8, 49},   {0x53, 8, 50},   {0x54, 8, 51},
    {0x55, 8, 52},   {0x24, 8, 53},   {0x25, 8, 54},   {0x58, 8, 55},
    {0x59, 8, 56},   {0x5A, 8, 57},   {0x5B, 8, 58},   {0x4A, 8, 59},
    {0x4B, 8, 60},   {0x32, 8, 61},   {0x33, 8, 62},   {0x34, 8, 63},
    {0x1B, 5, 64},   {0x12, 5, 128},  {0x17, 6, 192},  {0x37, 7, 256},
    {0x36, 8, 320},  {0x37, 8, 384},  {0x64, 8, 448},  {0x65, 8, 512},
    {0x68, 8, 576},  {0x67, 8, 640},  {0xCC, 9, 704},  {0xCD, 9, 768},
    {0xD2, 9, 832},  {0xD3, 9, 896},  {0xD4, 9, 960},  {0xD5, 9, 1024},
    {0xD6, 9, 1088}, {0xD7, 9, 1152}, {0xD8, 9, 1216}, {0xD9, 9, 1280},
    {0xDA, 9, 1344}, {0xDB, 9, 1408}, {0x98, 9, 1472}, {0x99, 9, 1536},
    {0x9A, 9, 1600}, {0x18, 6, 1664}, {0x9B, 9, 1728},
};

const Code kBlack[] = {
    {0x37, 10, 0},   {0x2, 3, 1},     {0x3, 2, 2},     {0x2, 2, 3},
    {0x3, 3, 4},     {0x3, 4, 5},     {0x2, 4, 6},     {0x3, 5, 7},
    {0x5, 6, 8},     {0x4, 6, 9},     {0x4, 7, 10},    {0x5, 7, 11},
    {0x7, 7, 12},    {0x4, 8, 13},    {0x7, 8, 14},    {0x18, 9, 15},
    {0x17, 10, 16},  {0x18, 10, 17},  {0x8, 10, 18},   {0x67, 11, 19},
    {0x68, 11, 20},  {0x6C, 11, 21},  {0x37, 11, 22},  {0x28, 11, 23},
    {0x17, 11, 24},  {0x18, 11, 25},  {0xCA, 12, 26},  {0xCB, 12, 27},
    {0xCC, 12, 28},  {0xCD, 12, 29},  {0x68, 12, 30},  {0x69, 12, 31},
    {0x6A, 12, 32},  {0x6B, 12, 33},  {0xD2, 12, 34},  {0xD3, 12, 35},
    {0xD4, 12, 36},  {0xD5, 12, 37},  {0xD6, 12, 38},  {0xD7, 12, 39},
    {0x6C, 12, 40},  {0x6D, 12, 41},  {0xDA, 12, 42},  {0xDB, 12, 43},
    {0x54, 12, 44},  {0x55, 12, 45},  {0x56, 12, 46},  {0x57, 12, 47},
    {0x64, 12, 48},  {0x65, 12, 49},  {0x52, 12, 50},  {0x53, 12, 51},
    {0x24, 12, 52},  {0x37, 12, 53},  {0x38, 12, 54},  {0x27, 12, 55},
    {0x28, 12, 56},  {0x58, 12, 57},  {0x59, 12, 58},  {0x2B, 12, 59},
    {0x2C, 12, 60},  {0x5A, 12, 61},  {0x66, 12, 62},  {0x67, 12, 63},
    {0xF, 10, 64},   {0xC8, 12, 128}, {0xC9, 12, 192}, {0x5B, 12, 256},
    {0x33, 12, 320}, {0x34, 12, 384}, {0x35, 12, 448}, {0x6C, 13, 512},
    {0x6D, 13, 576}, {0x4A, 13, 640}, {0x4B, 13, 704}, {0x4C, 13, 768},
    {0x4D, 13, 832}, {0x72, 13, 896}, {0x73, 13, 960}, {0x74, 13, 1024},
    {0x75, 13, 1088}, {0x76, 13, 1152}, {0x77, 13, 1216}, {0x52, 13, 1280},
    {0x53, 13, 1344}, {0x54, 13, 1408}, {0x55, 13, 1472}, {0x5A, 13, 1536},
    {0x5B, 13, 1600}, {0x64, 13, 1664}, {0x65, 13, 1728},
};

const Code kShared[] = {
    {0x8, 11, 1792},  {0xC, 11, 1856},  {0xD, 11, 1920},  {0x12, 12, 1984},
    {0x13, 12, 2048}, {0x14, 12, 2112}, {0x15, 12, 2176}, {0x16, 12, 2240},
    {0x17, 12, 2304}, {0x1C, 12, 2368}, {0x1D, 12, 2432}, {0x1E, 12, 2496},
    {0x1F, 12, 2560}, {0x1, 12, -1},
};

constexpr int kPeek = 13;  // the longest code
constexpr int kEol = -10;   // ReadRun's EOL code

// A lookup of 13-bit windows: (length << 12 | run + 2), 0 for no code.
struct RunTable {
  uint16_t e[1 << kPeek];

  template <size_t N>
  void Add(const Code (&codes)[N]) {
    for (const Code& c : codes) {
      const int shift = kPeek - c.len;
      for (int j = 0; j < (1 << shift); ++j)
        e[(c.code << shift) | j] =
            static_cast<uint16_t>((c.len << 12) | (c.run + 2));
    }
  }
};

struct Tables {
  RunTable white, black;
  Tables() {
    std::memset(&white, 0, sizeof(white));
    std::memset(&black, 0, sizeof(black));
    white.Add(kWhite);
    white.Add(kShared);
    black.Add(kBlack);
    black.Add(kShared);
  }
};

const Tables& Fax() {
  static const Tables t;
  return t;
}

// MSB-first bits of one strip; zeros are read past its end, which is an
// error once a code has used them.
struct BitIn {
  const uint8_t* p;
  size_t n;
  size_t pos = 0;  // in bits

  uint32_t Peek(int k) const {  // k <= 24
    const size_t byte = pos >> 3;
    uint32_t w = 0;
    for (size_t i = 0; i < 4; ++i)
      w = (w << 8) | (byte + i < n ? p[byte + i] : 0u);
    return (w << (pos & 7)) >> (32 - k);
  }
  void Skip(int k) { pos += k; }
  bool Over() const { return pos > n * 8; }
  void Align() { pos = (pos + 7) & ~size_t{7}; }
};

// One run of `black` (0 white): make-up codes then a terminating code.
// Returns the run, or kEol / an error.
int ReadRun(BitIn& in, bool black) {
  const RunTable& t = black ? Fax().black : Fax().white;
  int run = 0;
  while (true) {
    const uint16_t e = t.e[in.Peek(kPeek)];
    if (e == 0) return kBadData;
    in.Skip(e >> 12);
    if (in.Over()) return kTruncated;
    const int v = static_cast<int>(e & 0xfff) - 2;
    if (v == -1) return run == 0 ? kEol : kBadData;  // the EOL code
    run += v;
    if (run > (1 << 24)) return kBadData;
    if (v < 64) return run;
  }
}

// libtiff's SYNC_EOL: skip to 11 zero bits, then the zeros of any fill, then
// the EOL's 1 bit.
int SyncEol(BitIn& in) {
  while (in.Peek(11) != 0) {
    in.Skip(1);
    if (in.Over()) return kTruncated;
  }
  while (in.Peek(1) == 0) {
    in.Skip(1);
    if (in.Over()) return kTruncated;
  }
  in.Skip(1);
  return in.Over() ? kTruncated : kOk;
}

// A row as its changing elements: x[0..n) alternate white->black,
// black->white; three copies of the width follow them when the row is the
// reference of the next. Push refuses past width + 3 elements (a valid row
// has at most width + 2), which ends a stream of runs that do not advance.
struct Row {
  std::vector<int> x;  // width + 8 slots
  int n = 0;

  bool Push(int v) {
    if (n + 5 >= static_cast<int>(x.size())) return false;
    x[n++] = v;
    return true;
  }
};

// One 1-D coded row into `cur` (runs alternate from white).
int Row1D(BitIn& in, int width, Row& cur) {
  cur.n = 0;
  int a0 = 0;
  bool black = false;
  while (a0 < width) {
    const int run = ReadRun(in, black);
    if (run < 0) return run == kEol ? kBadData : run;
    a0 += run;
    if (a0 > width) return kBadData;  // a run past the row
    if (a0 < width && !cur.Push(a0)) return kBadData;
    black = !black;
  }
  return kOk;
}

// One 2-D coded row against the reference row `ref` (its changing
// elements, followed by at least two copies of the width).
int Row2D(BitIn& in, int width, const Row& ref, Row& cur) {
  cur.n = 0;
  int a0 = -1, i = 0;
  bool black = false;
  while (a0 < width) {
    // b1: the first change of the reference row right of a0 to the
    // colour opposite a0's; b2 the change after it
    while (i > 0 && ref.x[i - 1] > a0) --i;
    while (ref.x[i] <= a0 && ref.x[i] < width) ++i;
    if ((i & 1) != static_cast<int>(black)) ++i;  // i <= ref.n + 1
    const int b1 = ref.x[i], b2 = ref.x[i + 1];
    const uint32_t m = in.Peek(7);
    int a1;
    if (m >> 6) {  // 1: V0
      in.Skip(1);
      a1 = b1;
    } else if ((m >> 4) == 0x3) {  // 011: VR1
      in.Skip(3);
      a1 = b1 + 1;
    } else if ((m >> 4) == 0x2) {  // 010: VL1
      in.Skip(3);
      a1 = b1 - 1;
    } else if ((m >> 4) == 0x1) {  // 001: horizontal
      in.Skip(3);
      const int start = a0 < 0 ? 0 : a0;
      const int r1 = ReadRun(in, black);
      if (r1 < 0) return r1 == kEol ? kBadData : r1;
      const int r2 = ReadRun(in, !black);
      if (r2 < 0) return r2 == kEol ? kBadData : r2;
      const int a2 = start + r1 + r2;
      if (start + r1 > width || a2 > width) return kBadData;
      if (!cur.Push(start + r1) || !cur.Push(a2)) return kBadData;
      a0 = a2;
      if (in.Over()) return kTruncated;
      continue;
    } else if ((m >> 3) == 0x1) {  // 0001: pass
      in.Skip(4);
      if (in.Over()) return kTruncated;
      if (b2 > width) return kBadData;
      a0 = b2;
      continue;
    } else if ((m >> 1) == 0x3) {  // 000011: VR2
      in.Skip(6);
      a1 = b1 + 2;
    } else if ((m >> 1) == 0x2) {  // 000010: VL2
      in.Skip(6);
      a1 = b1 - 2;
    } else if (m == 0x3) {  // 0000011: VR3
      in.Skip(7);
      a1 = b1 + 3;
    } else if (m == 0x2) {  // 0000010: VL3
      in.Skip(7);
      a1 = b1 - 3;
    } else {  // extensions (uncompressed mode), an EOL, or no code
      return kBadData;
    }
    if (in.Over()) return kTruncated;
    if (a1 < (a0 < 0 ? 0 : a0) || a1 > width) return kBadData;
    if (a1 < width && !cur.Push(a1)) return kBadData;
    a0 = a1;
    black = !black;
  }
  return kOk;
}

// Set the bits [s, e) of a row, whole bytes at once.
void SetBits(uint8_t* row, int s, int e) {
  if (s >= e) return;
  const int b0 = s >> 3, b1 = (e - 1) >> 3;
  const uint8_t head = 0xFF >> (s & 7), tail = 0xFF << (7 - ((e - 1) & 7));
  if (b0 == b1) {
    row[b0] |= head & tail;
    return;
  }
  row[b0] |= head;
  std::memset(row + b0 + 1, 0xFF, b1 - b0 - 1);
  row[b1] |= tail;
}

// Set the black runs of a row of changing elements as 1 bits.
void Paint(const Row& cur, int width, uint8_t* row) {
  std::memset(row, 0, (width + 7) / 8);
  for (int k = 0; k < cur.n; k += 2)
    SetBits(row, cur.x[k], k + 1 < cur.n ? cur.x[k + 1] : width);
}

// `rows` rows of `width` 1-bit pixels of one strip or tile, each row
// (width + 7) / 8 bytes, bits set for black (libtiff's sense: photometric
// decides what black is).
int FaxDecode(int compression, uint32_t t4, const uint8_t* src, size_t n,
              uint8_t* dst, size_t rows, int width) {
  BitIn in{src, n};
  Row cur, ref;
  cur.x.assign(width + 8, 0);
  ref.x.assign(width + 8, 0);
  ref.n = 0;  // the imaginary white row above the first
  const size_t rb = (width + 7) / 8;
  for (size_t y = 0; y < rows; ++y) {
    for (int k = 0; k < 3; ++k) ref.x[ref.n + k] = width;  // sentinels
    int rc;
    if (compression == 2) {  // modified Huffman: byte-aligned 1-D rows
      rc = Row1D(in, width, cur);
      in.Align();
    } else if (compression == 3) {
      rc = SyncEol(in);
      if (rc != kOk) return rc;
      bool one_d = true;
      if (t4 & 1) {  // 2-D: a tag bit after each EOL
        one_d = in.Peek(1) != 0;
        in.Skip(1);
      }
      rc = one_d ? Row1D(in, width, cur) : Row2D(in, width, ref, cur);
    } else {
      rc = Row2D(in, width, ref, cur);
    }
    if (rc != kOk) return rc;
    if (in.Over()) return kTruncated;
    Paint(cur, width, dst + y * rb);
    std::swap(cur, ref);
  }
  return kOk;
}

int Decompress(const Tiff& t, const uint8_t* src, size_t n, uint8_t* dst,
               size_t rows, size_t rowbytes, int width) {
  const size_t want = rows * rowbytes;
  switch (t.compression) {
    case 1:
      if (n < want) return kTruncated;
      std::memcpy(dst, src, want);
      return kOk;
    case 2: case 3: case 4:
      return FaxDecode(t.compression, t.t4, src, n, dst, rows, width);
    case 5:
      return LzwDecode(src, n, dst, want);
    case 8: case 32946:
      return ZipDecode(src, n, dst, want);
    default:
      return PackBitsDecode(src, n, dst, want);
  }
}

// Samples of `count` at `bits` (1, 2 or 4), MSB first, as bytes.
void Unpack(const uint8_t* src, int bits, size_t count, uint8_t* dst) {
  const int per = 8 / bits, mask = (1 << bits) - 1;
  size_t i = 0;
  for (; i + per <= count; i += per) {  // whole bytes
    const int v = *src++;
    for (int j = 0; j < per; ++j)
      dst[i + j] = (v >> (8 - bits * (j + 1))) & mask;
  }
  for (int j = 0; i < count; ++i, ++j)  // the last, partial byte
    dst[i] = (*src >> (8 - bits * (j + 1))) & mask;
}

uint8_t Reverse(uint8_t v) {
  v = static_cast<uint8_t>((v & 0xF0) >> 4 | (v & 0x0F) << 4);
  v = static_cast<uint8_t>((v & 0xCC) >> 2 | (v & 0x33) << 2);
  return static_cast<uint8_t>((v & 0xAA) >> 1 | (v & 0x55) << 1);
}

// A sample of `bytes` (1, 2 or 4) at p, in the byte order `le`
uint32_t Word(const uint8_t* p, int bytes, bool le) {
  uint32_t v = 0;
  for (int k = 0; k < bytes; ++k)
    v |= static_cast<uint32_t>(p[k]) << (8 * (le ? k : bytes - 1 - k));
  return v;
}

void PutWord(uint8_t* p, int bytes, bool le, uint32_t v) {
  for (int k = 0; k < bytes; ++k)
    p[k] = static_cast<uint8_t>(v >> (8 * (le ? k : bytes - 1 - k)));
}

// libtiff's horizontal differencing undone on a row of `count` samples of
// `bytes` each in the file's byte order, `lanes` samples a pixel.
void Unfilter(uint8_t* row, size_t count, int bytes, size_t lanes, bool le) {
  if (bytes == 1) {
    for (size_t i = lanes; i < count; ++i) row[i] += row[i - lanes];
    return;
  }
  for (size_t i = lanes; i < count; ++i)
    PutWord(row + i * bytes, bytes, le,
            Word(row + i * bytes, bytes, le) +
                Word(row + (i - lanes) * bytes, bytes, le));
}

// libtiff's floating-point differencing undone (fpAcc) on a row of `count`
// 32-bit samples, `lanes` a pixel: the row's bytes summed `lanes` apart,
// then each sample's four bytes gathered from the row's four byte planes,
// the most significant first. The samples come out big-endian, whatever
// the file's byte order.
void FpUnfilter(uint8_t* row, size_t count, size_t lanes,
                std::vector<uint8_t>* tmp) {
  const size_t cc = count * 4;
  for (size_t i = lanes; i < cc; ++i) row[i] += row[i - lanes];
  tmp->assign(row, row + cc);
  for (size_t k = 0; k < count; ++k)
    for (size_t byte = 0; byte < 4; ++byte)
      row[4 * k + byte] = (*tmp)[byte * count + k];
}

// A 32-bit gray sample as Pillow's convert("RGB") makes it a byte: a float
// (F) truncated, NaN and what is not above 0 to 0, 255 and above to 255;
// an integer (I, signed) clipped to [0, 255].
uint8_t Gray32(uint32_t v, int format) {
  if (format == 3) {
    float f;
    std::memcpy(&f, &v, 4);
    if (!(f > 0.0f)) return 0;
    return f >= 255.0f ? 255 : static_cast<uint8_t>(f);
  }
  const int32_t i = static_cast<int32_t>(v);
  return i < 0 ? 0 : i > 255 ? 255 : static_cast<uint8_t>(i);
}

int Decode(const uint8_t* data, const Tiff& t, uint8_t* out,
           size_t out_cap) {
  if (t.compression == kJpeg || t.compression == kOldJpeg)
    return kUnsupported;  // ik_tiffx_jpeg_segments
  const size_t W = t.width, H = t.height, spp = t.spp;
  const int oc = t.photometric == 5 || t.alpha ? 4 : 3;
  if (out_cap < W * H * oc) return kBuffer;
  // every sample as a byte, chunky: (H, W, spp)
  std::vector<uint8_t> s(W * H * spp);
  const size_t rw = t.tiled ? t.tile_w : W;          // region width
  const size_t rh = t.tiled ? t.tile_h : t.rows_per_strip;
  const size_t lanes = t.planar == 2 ? 1 : spp;      // samples a pixel
  const size_t rowbytes = (rw * lanes * t.bits + 7) / 8;
  const size_t per_plane = t.offsets.size() / (t.planar == 2 ? spp : 1);
  const size_t across = t.tiled ? (W + rw - 1) / rw : 1;
  const int bytes = t.bits / 8;  // 0 below 8 bits
  std::vector<uint8_t> buf(rh * rowbytes), line(rw * lanes), src, tmp;
  const bool filtered = t.compression == 5 || t.compression == 8 ||
                        t.compression == 32946;
  const bool horizontal = filtered && t.predictor == 2;  // 8 bits and more
  const bool fp = filtered && t.predictor == 3;          // 32-bit floats
  // the byte order of the samples after the predictor, and Pillow's
  // reading of a big-endian file's 32-bit samples through libtiff (every
  // compression but none), which hands them over in the machine's order
  // while Pillow unpacks them big-endian: each such sample byte-swapped
  const bool order = fp ? false : t.le;
  const bool swapped = !t.le && t.compression != 1;
  for (size_t k = 0; k < t.offsets.size(); ++k) {
    const size_t g = k % per_plane, comp = k / per_plane;
    const size_t ox = (g % across) * rw, oy = (g / across) * rh;
    if (oy >= H) return kBadData;
    // a strip holds its rows only; a tile decodes whole and is clipped
    const size_t rows = t.tiled ? rh : (H - oy < rh ? H - oy : rh);
    const uint8_t* raw = data + t.offsets[k];
    if (t.fill == 2) {  // libtiff reverses the bits before decompressing
      src.resize(t.counts[k]);
      for (size_t i = 0; i < src.size(); ++i) src[i] = Reverse(raw[i]);
      raw = src.data();
    }
    const int rc = Decompress(t, raw, t.counts[k], buf.data(), rows,
                              rowbytes, static_cast<int>(rw));
    if (rc != kOk) return rc;
    for (size_t y = 0; y < rows; ++y) {
      uint8_t* r = buf.data() + y * rowbytes;
      if (horizontal) Unfilter(r, rw * lanes, bytes, lanes, t.le);
      if (fp) FpUnfilter(r, rw * lanes, lanes, &tmp);
    }
    const size_t cols = rw < W - ox ? rw : W - ox;
    const size_t keep = oy + rows <= H ? rows : H - oy;
    for (size_t y = 0; y < keep; ++y) {
      const uint8_t* r = buf.data() + y * rowbytes;
      const size_t count = rw * lanes;
      if (t.bits < 8) {
        Unpack(r, t.bits, count, line.data());
      } else if (bytes == 1) {
        std::memcpy(line.data(), r, count);
      } else if (bytes == 2) {  // 16-bit CMYK: the high byte (CMYK;16L/B)
        for (size_t i = 0; i < count; ++i) line[i] = r[2 * i + (t.le ? 1 : 0)];
      } else {  // 32-bit gray
        for (size_t i = 0; i < count; ++i) {
          uint32_t v = Word(r + 4 * i, 4, order);
          if (swapped) v = __builtin_bswap32(v);
          line[i] = Gray32(v, t.format);
        }
      }
      uint8_t* d = s.data() + ((oy + y) * W + ox) * spp;
      if (t.planar == 2) {
        for (size_t x = 0; x < cols; ++x) d[x * spp + comp] = line[x];
      } else {
        std::memcpy(d, line.data(), cols * spp);
      }
    }
  }
  const size_t npx = W * H;
  if (t.photometric == 5) {  // the four inks; extra samples dropped
    for (size_t i = 0; i < npx; ++i) std::memcpy(out + 4 * i, &s[i * spp], 4);
    return kOk;
  }
  if (t.alpha) {  // LA and PA, 8-bit: RGBA
    const size_t per = t.colors;
    for (size_t i = 0; i < npx; ++i) {
      const size_t v = s[2 * i];
      uint8_t* o = out + 4 * i;
      if (t.photometric == 3) {
        if (v >= per) return kBadData;  // an index past the ColorMap
        o[0] = t.colormap[v];
        o[1] = t.colormap[per + v];
        o[2] = t.colormap[2 * per + v];
      } else {
        o[0] = o[1] = o[2] = static_cast<uint8_t>(v);
      }
      o[3] = s[2 * i + 1];
    }
    return kOk;
  }
  if (t.photometric == 3) {
    const size_t per = t.colors;
    for (size_t i = 0; i < npx; ++i) {
      const size_t v = s[i];
      if (v >= per) return kBadData;  // an index past the ColorMap
      out[3 * i] = t.colormap[v];
      out[3 * i + 1] = t.colormap[per + v];
      out[3 * i + 2] = t.colormap[2 * per + v];
    }
    return kOk;
  }
  if (t.bits == 32) {  // already bytes; a float's photometric 0 is as 1
    for (size_t i = 0; i < npx; ++i)
      out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = s[i];
    return kOk;
  }
  const int scale = t.bits == 1 ? 255 : t.bits == 2 ? 85 : 17;
  const int flip = t.photometric == 0 ? 255 : 0;
  for (size_t i = 0; i < npx; ++i) {
    const uint8_t g = static_cast<uint8_t>(flip ^ (s[i] * scale));
    out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = g;
  }
  return kOk;
}

// -- old-style JPEG (compression 6) -----------------------------------------------

// The entropy-coded data's offset in the JPEG stream p[0, n): just past its
// first SOS segment; 0 where the stream's markers up to it do not parse.
size_t SosEnd(const uint8_t* p, size_t n) {
  if (n < 4 || p[0] != 0xFF || p[1] != 0xD8) return 0;
  size_t at = 2;
  while (at + 4 <= n) {
    if (p[at] != 0xFF) return 0;
    const uint8_t m = p[at + 1];
    if (m == 0xFF) {  // fill byte
      ++at;
      continue;
    }
    if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) {
      at += 2;
      continue;
    }
    if (m == 0xD9) return 0;
    const size_t seg = (static_cast<size_t>(p[at + 2]) << 8) | p[at + 3];
    if (seg < 2 || at + 2 + seg > n) return 0;
    at += 2 + seg;
    if (m == 0xDA) return at;
  }
  return 0;
}

// Just past the EOI at or after `from`, 0 where p[from, n) holds none
// (entropy-coded data holds 0xFF only before 0x00 or a marker)
size_t EoiEnd(const uint8_t* p, size_t n, size_t from) {
  for (size_t i = from; i + 1 < n; ++i)
    if (p[i] == 0xFF && p[i + 1] == 0xD9) return i + 2;
  return 0;
}

void Put16(std::vector<uint8_t>* o, uint32_t v) {
  o->push_back(static_cast<uint8_t>(v >> 8));
  o->push_back(static_cast<uint8_t>(v));
}

// The JPEG stream of the tables-in-tags form, as libtiff writes it for
// libjpeg: SOI, component i's quantisation table (JPEGQTables, 64 bytes in
// zigzag order) and DC and AC Huffman tables (JPEGDCTables, JPEGACTables:
// 16 counts, then the symbols) under id i, a baseline frame of the image
// with the luma sampled YCbCrSubSampling, JPEGRestartInterval, one
// interleaved scan, then `scan` (the strip's entropy-coded data) and an EOI.
int TablesStream(const Reader& r, const Tiff& t, const uint8_t* scan,
                 size_t n, std::vector<uint8_t>* o) {
  const Entry* tabs[3] = {&t.qtabs_e, &t.dctabs_e, &t.actabs_e};
  for (const Entry* e : tabs)
    if (e->count < 3) return kBadData;
  if (t.width > 65535 || t.height > 65535) return kUnsupported;
  o->assign({0xFF, 0xD8});
  for (uint32_t i = 0; i < 3; ++i) {
    const size_t q = EntryValue(r, t.qtabs_e, i);
    if (q > r.len || r.len - q < 64) return kTruncated;
    o->insert(o->end(), {0xFF, 0xDB, 0, 67, static_cast<uint8_t>(i)});
    o->insert(o->end(), r.d + q, r.d + q + 64);
  }
  for (int cls = 0; cls < 2; ++cls)
    for (uint32_t i = 0; i < 3; ++i) {
      const size_t h = EntryValue(r, cls ? t.actabs_e : t.dctabs_e, i);
      if (h > r.len || r.len - h < 16) return kTruncated;
      size_t symbols = 0;
      for (int l = 0; l < 16; ++l) symbols += r.d[h + l];
      if (symbols > 256) return kBadData;
      if (r.len - h < 16 + symbols) return kTruncated;
      o->insert(o->end(), {0xFF, 0xC4});
      Put16(o, static_cast<uint32_t>(3 + 16 + symbols));
      o->push_back(static_cast<uint8_t>(cls << 4 | i));
      o->insert(o->end(), r.d + h, r.d + h + 16 + symbols);
    }
  o->insert(o->end(), {0xFF, 0xC0, 0, 17, 8});
  Put16(o, t.height);
  Put16(o, t.width);
  o->insert(o->end(), {3, 1, static_cast<uint8_t>(t.sub_h << 4 | t.sub_v), 0,
                       2, 0x11, 1, 3, 0x11, 2});
  if (t.restart > 0) {
    if (t.restart > 65535) return kBadData;
    o->insert(o->end(), {0xFF, 0xDD, 0, 4});
    Put16(o, t.restart);
  }
  o->insert(o->end(), {0xFF, 0xDA, 0, 12, 3, 1, 0x00, 2, 0x11, 3, 0x22, 0, 63,
                       0});
  o->insert(o->end(), scan, scan + n);
  o->insert(o->end(), {0xFF, 0xD9});
  return kOk;
}

// An old-style JPEG page as the one JPEG stream libtiff hands to libjpeg:
// the JPEGInterchangeFormat stream (its range as Parse corrected it) up to
// its EOI; where it has no EOI, its entropy-coded data runs on into the
// strip; with no interchange format, the strip's own stream, or the
// tables-in-tags form's (TablesStream). The strips are ignored where the
// interchange format holds the whole stream. A stream to assemble from
// several strips (libtiff inserts restart markers between them) is -3.
int OldJpegStream(const uint8_t* data, size_t len, const Tiff& t,
                  std::vector<uint8_t>* o) {
  const bool one = t.offsets.size() == 1;
  const uint8_t* s0 = data + t.offsets[0];
  const size_t n0 = t.counts[0];
  const uint8_t* head = t.jif_off ? data + t.jif_off : s0;
  const size_t hn = t.jif_off ? t.jif_len : n0;
  if (!t.jif_off && !(n0 >= 2 && s0[0] == 0xFF && s0[1] == 0xD8)) {
    if (!one) return kUnsupported;
    return TablesStream(Reader{data, len, t.le}, t, s0, n0, o);
  }
  const size_t sos = SosEnd(head, hn);
  if (sos == 0) return kBadData;  // no JPEG header before a scan
  const size_t eoi = EoiEnd(head, hn, sos);
  if (eoi) {
    o->assign(head, head + eoi);
    return kOk;
  }
  if (!one) return kUnsupported;
  o->assign(head, head + hn);
  if (t.jif_off) o->insert(o->end(), s0, s0 + n0);
  o->insert(o->end(), {0xFF, 0xD9});
  return kOk;
}

// What Pillow's raw reader leaves unread of a YCbCr TIFF without
// compression where the file runs out: it reads four bytes a pixel (RGBX)
// where the file holds three, a region (strip or tile) at a time in the
// order of their offsets, each from its offset for its rows, a tile that
// passes the image's right edge at three bytes a pixel of the tile; the
// first region the file cannot fill leaves the rest of the file modulo a
// row. -1 where every region fits.
int64_t RawYccLeft(size_t len, const Tiff& t) {
  const size_t W = t.width, H = t.height;
  const size_t rw = t.tiled ? t.tile_w : W;
  const size_t rh = t.tiled ? t.tile_h : t.rows_per_strip;
  const size_t across = t.tiled ? (W + rw - 1) / rw : 1;
  std::vector<size_t> order(t.offsets.size());
  for (size_t i = 0; i < order.size(); ++i) order[i] = i;
  std::stable_sort(order.begin(), order.end(), [&](size_t a, size_t b) {
    return t.offsets[a] < t.offsets[b];
  });
  for (size_t k : order) {
    const size_t ox = (k % across) * rw, oy = (k / across) * rh;
    if (oy >= H) continue;
    const size_t line = ox + rw > W && t.tiled ? 3 * rw : 4 * (t.tiled ? rw
                                                                   : W);
    const size_t rows = (oy + rh < H ? oy + rh : H) - oy;
    const size_t avail = len - t.offsets[k];
    if (avail < line * rows) return static_cast<int64_t>(avail % line);
  }
  return -1;
}

}  // namespace

struct IkTiffxInfo {  // tiff_decode.cpp's IkTiffInfo, then the layout
  int32_t width, height, channels;
  // 0: ik_tiffx_decode writes the image; 1: it writes CMYK's four samples
  // as stored; 2: JPEG segments (ik_tiffx_jpeg_segments)
  int32_t layout;
  // where the parse refuses a YCbCr TIFF without compression (-8): the
  // bytes Pillow's read leaves unread, for its "truncated" message; else -1
  int32_t unread;
};

// channels: 3 (RGB), or 4 for alpha, and for CMYK, whose four samples the
// decode writes as stored; a JPEG TIFF's channels are its image's.
IK_EXPORT int ik_tiffx_parse(const uint8_t* data, size_t len,
                             IkTiffxInfo* out) {
  Tiff t;
  const int rc = Parse(data, len, &t);
  out->width = static_cast<int32_t>(t.width);
  out->height = static_cast<int32_t>(t.height);
  const bool jpeg = t.compression == kJpeg || t.compression == kOldJpeg;
  out->channels = t.alpha || (t.photometric == 5 && !jpeg) ? 4 : 3;
  out->layout = jpeg ? 2 : t.photometric == 5 ? 1 : 0;
  out->unread = static_cast<int32_t>(std::min<int64_t>(t.unread, INT32_MAX));
  return rc;
}

IK_EXPORT int ik_tiffx_decode(const uint8_t* data, size_t len, uint8_t* out,
                              size_t out_cap) {
  Tiff t;
  const int rc = Parse(data, len, &t);
  if (rc != kOk) return rc;
  return Decode(data, t, out, out_cap);
}

struct IkTiffxJpeg {
  int32_t width, height;
  int32_t photometric, samples;
  int32_t alpha;         // the image has alpha (the last sample)
  int32_t sub_h, sub_v;  // YCbCrSubSampling; 0 where the tag is missing
  int32_t seg_w, seg_h;  // a tile, or the image's width and RowsPerStrip
  int32_t rows, cols;    // the segment grid (strips: rows x 1) of a plane
  int32_t tiled;
  uint64_t tables_off, tables_len;  // JPEGTables; a length of 0 for none
  int32_t planes;     // 1, or the samples where each has its own segments
  int32_t extra;      // the one ExtraSamples value, -1 for none
  int32_t old_style;  // compression 6: one stream (ik_tiffx_ojpeg_stream)
  float luma[3];      // YCbCrCoefficients and ReferenceBlackWhite, or
  float refbw[6];     // libtiff's defaults
};

// A JPEG-compressed TIFF's segments: `out` always, then each segment's
// offset and byte count, plane by plane, in grid order (row by row), where
// `cap` holds planes * rows * cols of them (else -7). Every range lies
// inside `data`. -3 for a TIFF that is not one of the JPEG layouts of the
// header comment. An old-style JPEG's page is one segment, the image, whose
// stream ik_tiffx_ojpeg_stream writes: `out` only.
IK_EXPORT int ik_tiffx_jpeg_segments(const uint8_t* data, size_t len,
                                     IkTiffxJpeg* out, uint64_t* offsets,
                                     uint64_t* counts, size_t cap) {
  Tiff t;
  std::memset(out, 0, sizeof(*out));
  int rc = Parse(data, len, &t);
  if (rc != kOk) return rc;
  const bool old = t.compression == kOldJpeg;
  if (t.compression != kJpeg && !old) return kUnsupported;
  out->width = static_cast<int32_t>(t.width);
  out->height = static_cast<int32_t>(t.height);
  out->photometric = t.photometric;
  out->samples = t.spp;
  out->alpha = t.alpha;
  out->sub_h = old ? 0 : t.sub_h;  // an old-style stream's own sampling
  out->sub_v = old ? 0 : t.sub_v;
  out->tiled = t.tiled && !old;
  out->planes = t.planar == 2 ? t.spp : 1;
  out->extra = t.extra;
  out->old_style = old;
  std::memcpy(out->luma, t.luma, sizeof(t.luma));
  std::memcpy(out->refbw, t.refbw, sizeof(t.refbw));
  out->seg_w = static_cast<int32_t>(t.tiled && !old ? t.tile_w : t.width);
  out->seg_h = static_cast<int32_t>(
      old ? t.height : t.tiled ? t.tile_h : t.rows_per_strip);
  out->cols = static_cast<int32_t>(
      t.tiled && !old ? (t.width + t.tile_w - 1) / t.tile_w : 1);
  out->rows = old ? 1 : static_cast<int32_t>(
      t.offsets.size() / out->planes / out->cols);
  out->tables_off = t.tables_off;
  out->tables_len = t.tables_len;
  if (old) return kOk;
  if (cap < t.offsets.size()) return kBuffer;
  for (size_t i = 0; i < t.offsets.size(); ++i) {
    offsets[i] = t.offsets[i];
    counts[i] = t.counts[i];
  }
  return kOk;
}

// An old-style JPEG page's stream (OldJpegStream) into `out`: its length,
// written where `cap` holds it; or a negative code. The stream is at most
// the file and the tables, so 2 * len + 4096 bytes always hold it.
IK_EXPORT int64_t ik_tiffx_ojpeg_stream(const uint8_t* data, size_t len,
                                        uint8_t* out, size_t cap) {
  Tiff t;
  int rc = Parse(data, len, &t);
  if (rc != kOk) return rc;
  if (t.compression != kOldJpeg) return kUnsupported;
  std::vector<uint8_t> s;
  rc = OldJpegStream(data, len, t, &s);
  if (rc != kOk) return rc;
  if (s.size() <= cap) std::memcpy(out, s.data(), s.size());
  return static_cast<int64_t>(s.size());
}

// -- a page's JPEG segments, many at a time -----------------------------------

// jpeg_entropy.cpp's IkJpegInfo (jpeg4_decode.cpp's has the same layout)
struct IkSegInfo {
  int32_t width, height, ncomp, hmax, vmax;
  int32_t comp_h[4], comp_v[4], comp_width[4], comp_height[4];
  int32_t blocks_w[4], blocks_h[4], comp_tq[4];
  int32_t progressive;
};

extern "C" {
int ik_jpeg_parse(const uint8_t* data, size_t len, IkSegInfo* info);
int ik_jpeg_decode_coeffs(const uint8_t* data, size_t len, int16_t** coeffs,
                          uint16_t* qtabs_out);
struct IkSegExtra {  // jpeg4_decode.cpp's Ik4Extra
  int32_t adobe_transform, coding;
};
int ik_jpeg4_parse(const uint8_t* data, size_t len, IkSegInfo* info,
                   IkSegExtra* extra);
int ik_jpeg4_decode_coeffs(const uint8_t* data, size_t len, int16_t** coeffs,
                           uint16_t* qtabs_out);
}

// A page's segments as libtiff hands each to libjpeg: segment i, the bytes
// [offsets[i], offsets[i] + counts[i]) of the file, which start with an
// SOI, spliced after prefix[which[i]] in place of that SOI. The caller's
// prefixes are an SOI and the JPEGTables without their SOI and EOI (an SOI
// alone where there are none), prefix 1 with the Annex K Huffman tables
// between them.
struct IkTiffxSplice {
  const uint8_t* data;
  uint64_t len;
  const uint8_t* prefix[2];
  uint64_t prefix_len[2];
  const uint64_t* offsets;
  const uint64_t* counts;
  const int32_t* which;
  int32_t n;
};

namespace {

// Segment i of `s` as one stream in `buf`: -1 where its range leaves the
// file, -2 where it does not start with an SOI.
int Splice(const IkTiffxSplice& s, int32_t i, std::vector<uint8_t>* buf) {
  const uint64_t off = s.offsets[i], cnt = s.counts[i];
  if (off > s.len || cnt > s.len - off) return kTruncated;
  if (cnt < 2 || s.data[off] != 0xFF || s.data[off + 1] != 0xD8)
    return kBadMagic;
  const int w = s.which[i] ? 1 : 0;
  buf->assign(s.prefix[w], s.prefix[w] + s.prefix_len[w]);
  buf->insert(buf->end(), s.data + off + 2, s.data + off + cnt);
  return kOk;
}

// The header of a spliced segment as jpeg_abi.parse_any reads it: the
// pinned parser, then, where it says -3, the four-component one. Returns 0
// or the failing parser's code (the pinned parser's -3 where both refuse
// the frame as unsupported, and where the segment is arithmetic-coded or
// lossless, which a JPEG TIFF page does not take); `four` is 1 where the
// four-component parser took the stream or failed on it.
int ParseAny(const std::vector<uint8_t>& buf, IkSegInfo* info,
             int32_t* four) {
  *four = 0;
  int rc = ik_jpeg_parse(buf.data(), buf.size(), info);
  if (rc == kUnsupported) {
    IkSegExtra extra = {-1, 0};
    const int rc4 = ik_jpeg4_parse(buf.data(), buf.size(), info, &extra);
    if (rc4 != kUnsupported && !(rc4 == kOk && extra.coding != 0)) {
      rc = rc4;
      *four = 1;
    }
  }
  return rc;
}

}  // namespace

// The headers of the n spliced segments of `s` (ParseAny's): rcs[i] is 0
// or the splice's or parser's code.
IK_EXPORT void ik_tiffx_jpeg_parse_many(const IkTiffxSplice* s,
                                        IkSegInfo* infos, int32_t* four,
                                        int32_t* rcs) {
  std::vector<uint8_t> buf;
  for (int32_t i = 0; i < s->n; ++i) {
    four[i] = 0;
    int rc = Splice(*s, i, &buf);
    if (rc == kOk) rc = ParseAny(buf, &infos[i], &four[i]);
    rcs[i] = rc;
  }
}

// Entropy-decode the spliced segments of `s` (by the decoder ParseAny
// names): segment i's component c into a zeroed scratch, then its block
// rows copied to planes[4 * i + c], whose rows lie strides[4 * i + c]
// blocks of 64 int16 levels apart (the page's planes, each segment at its
// place), and its four quantisation tables into qtabs[256 * i]. Each
// destination holds the blocks_h rows of blocks_w blocks that
// ik_tiffx_jpeg_parse_many reported. rcs[i] is 0 or the splice's, parser's
// or decoder's code.
IK_EXPORT void ik_tiffx_jpeg_decode_many(const IkTiffxSplice* s,
                                         int16_t** planes,
                                         const int64_t* strides,
                                         uint16_t* qtabs, int32_t* rcs) {
  std::vector<uint8_t> buf;
  std::vector<int16_t> scratch;
  for (int32_t i = 0; i < s->n; ++i) {
    IkSegInfo h;
    int32_t four = 0;
    int rc = Splice(*s, i, &buf);
    if (rc == kOk) rc = ParseAny(buf, &h, &four);
    if (rc == kOk && (h.ncomp < 1 || h.ncomp > 4)) rc = kBadData;
    if (rc == kOk) {
      int16_t* comp[4] = {nullptr, nullptr, nullptr, nullptr};
      size_t at[4] = {0, 0, 0, 0}, total = 0;
      for (int c = 0; c < h.ncomp; ++c) {
        at[c] = total;
        total += static_cast<size_t>(h.blocks_w[c]) * h.blocks_h[c] * 64;
      }
      scratch.assign(total, 0);
      for (int c = 0; c < h.ncomp; ++c) comp[c] = scratch.data() + at[c];
      rc = four ? ik_jpeg4_decode_coeffs(buf.data(), buf.size(), comp,
                                         qtabs + 256 * i)
                : ik_jpeg_decode_coeffs(buf.data(), buf.size(), comp,
                                        qtabs + 256 * i);
      for (int c = 0; rc == kOk && c < h.ncomp; ++c) {
        const size_t row = static_cast<size_t>(h.blocks_w[c]) * 64;
        for (int32_t r = 0; r < h.blocks_h[c]; ++r)
          std::memcpy(planes[4 * i + c] + r * strides[4 * i + c] * 64,
                      comp[c] + r * row, row * sizeof(int16_t));
      }
    }
    rcs[i] = rc;
  }
}
