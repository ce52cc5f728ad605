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
//     pinned copy's compressions and predictor): written out as RGBA;
//   - CIELab (photometric 8, 8-bit, chunky or planar, the pinned copy's
//     compressions and predictor): L, a* and b* written out as a chunky
//     page stores them (a* and b* signed; Pillow's bands of a planar page
//     hold them unsigned, so those are flipped); the caller converts them
//     as Pillow does (ops/color.py::lab_to_rgb);
//   - YCbCr compressed without JPEG (LZW, deflate, PackBits), as libtiff's
//     RGBA interface reads it: chunky in the blocks it has a routine for,
//     planar without subsampling (DecodeYcc); written out as the Y plane,
//     then the Cb and Cr planes, whose blocks the caller replicates; and
//     uncompressed, where Pillow's raw reader fits the file (DecodeRawYcc);
//   - planar 16-bit CMYK: the high byte of each sample, or, uncompressed,
//     each plane's first bytes, as Pillow's raw reader takes them.
//
// The Orientation tag is not applied here: ik_tiffx_more reports it, with
// a YCbCr page's chroma grid, and the caller applies it as Pillow does.
//
// JPEG-compressed TIFFs (compression 7, 8-bit, strips or tiles: YCbCr with
// YCbCrSubSampling of 1, 2 or 4 on each axis, chunky; RGB, RGB with one
// extra sample (unspecified, associated or unassociated alpha), gray, gray
// with alpha and CMYK, chunky or planar; Huffman or arithmetic coded) are
// not decoded here: ik_tiffx_jpeg_segments returns their segment grid, each
// segment's byte range and the JPEGTables' range, and
// ik_tiffx_jpeg_parse_many and ik_tiffx_jpeg_decode_many entropy-decode a
// page's segments in two calls, each segment an independent JPEG as
// libtiff makes it (spliced onto the tables in one scratch buffer, a
// segment at a time, and its levels copied to its place in the page's
// planes), through the pinned decoder (jpeg_entropy.cpp) and the one for
// two and four components and for arithmetic coding (jpeg4_decode.cpp),
// which the loader links beside this file; a segment whose data ends early
// decodes as libjpeg decodes it under libtiff's fake EOI
// (ik_jpeg4_decode_libjpeg). libtiff reads the tables once; a splice copies them for
// each segment, so a JPEGTables longer than kMaxTables, and a page whose
// splices would copy more than kSpliceFactor times the file (overlapping
// segments, or many over large tables), are refused as corrupt.
//
// Old-style JPEG TIFFs (compression 6, which Pillow reads as YCbCr through
// libtiff: three 8-bit samples, or one for gray, chunky, baseline) are one
// JPEG stream a page, which ik_tiffx_ojpeg_stream assembles as libtiff does
// (OldJpegStream): the JPEGInterchangeFormat stream, the first strip's
// own, or the tables-in-tags form's, over the strips with an RSTn between
// each two; the same two calls decode it as one segment.
//
// Tags take Pillow's defaults where they are missing: BitsPerSample 1,
// PhotometricInterpretation 0, SamplesPerPixel 1 (3 for an old-style
// JPEG), YCbCrSubSampling (2, 2). A file whose layout has no mode in
// Pillow's reader (PillowKeys: a 16-bit palette, a 12-bit JPEG, CMYK with
// alpha, FillOrder 2 beyond gray and palette, float samples of 16 or 64
// bits, ICCLab, ...) is -8, as is one Pillow's read fails on (YCbCr
// without compression, which its raw reader runs out of; planar YCbCr
// JPEG and planar CMYK with extra samples): the reference answers those as
// corrupt; a YCbCr sampling libtiff's RGBA interface has no routine for is
// -9, Pillow's "decoder error -2". LZMA strips decode through the
// caller's liblzma (ik_tiffx_set_xz), Zstandard ones here (ZstdDecode).
// The few layouts no mode of Pillow's leads to here are -3. Corrupt data is an error. CCITT rows decode as libtiff's
// tif_fax3 decodes them (FaxDecoder), every write bounded by its row.
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
// A file Pillow opens whose read through libtiff fails: Pillow's "decoder
// error -2"
constexpr int kDecoderError = -9;
// A planar file Pillow's raw reader has no unpacker for: "unknown raw mode
// for given image mode"
constexpr int kRawMode = -12;

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
  bool premultiplied = false;  // RGB's first extra sample is associated
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
  int orientation = 1;  // the Orientation tag, which Pillow applies
  // YCbCr compressed without JPEG whose strips are not whole blocks high:
  // chroma written out at full resolution (libtiff's blocks start again
  // at each strip)
  bool ycc_full = false;
};

constexpr int kOldJpeg = 6, kJpeg = 7;
// Four DQT and four DHT segments take under 2.5 kB
constexpr uint64_t kMaxTables = 1 << 16;
// The Annex K Huffman tables the caller may splice ahead of a segment's own
constexpr uint64_t kStdDhtLen = 420;
constexpr uint64_t kSpliceFactor = 64;

// CCITT modified Huffman with word alignment (libtiff's CCITTRLEW),
// ThunderScan's 4-bit codes, LZMA (an .xz stream a strip) and Zstandard
// (a frame a strip)
constexpr int kRleW = 32771, kThunder = 32809, kLzma = 34925, kZstd = 50000;

// the compressions the pinned decoder does not take and this one decodes
// in every layout (ik_tiffx_rewrap for the pinned decoder's)
bool Packed(int c) { return c == kLzma || c == kZstd; }

bool Ccitt(int c) { return c == 2 || c == 3 || c == 4 || c == kRleW; }

// The layouts of the header comment with JPEG compression, 8 bits (libtiff's
// libjpeg takes no other precision), chunky or planar: photometric 6 (3
// samples; planar only without subsampling), 2 (3, or 4 with one extra sample), 1 (1,
// or 2 with alpha), 3 (1, or 2 with alpha, or chunky with an unspecified
// sample), 0 (1), 8 (3) or 5 (4). Five or six samples are libtiff's
// refusal: libjpeg-turbo finds no component past the fourth in a scan
// (get_sos), and a segment of fewer components fails libtiff's count, as
// does Pillow's planar read of an unspecified extra sample.
int CheckJpeg(const Tiff& t) {
  if (t.bits != 8) return kRefused;  // "Improper JPEG data precision"
  switch (t.photometric) {
    case 6:  // YCbCrSubSampling 1, 2 or 4 an axis (libtiff checks each
             // segment's sampling against it)
      // planar: libtiff's RGBA interface reads three planes without
      // subsampling (putseparate8bitYCbCr11tile); Pillow's read fails on
      // any other
      if (t.planar != 1)
        return t.spp == 3 && t.sub_h == 1 && t.sub_v == 1 ? kOk
                                                           : kDecoderError;
      if (t.spp == 1) return kRawMode;  // Pillow's L of YCbCr
      if (t.spp != 3) return kUnsupported;
      return t.sub_h > 4 || t.sub_v > 4 ? kBadData : kOk;
    case 8:  // CIELab: the three samples as stored, no colour step
      return t.spp == 3 ? kOk : kUnsupported;
    case 0:  // WhiteIsZero gray: its samples inverted (Pillow's L;I)
      return t.spp == 1 ? kOk : kUnsupported;
    case 3:  // palette: its samples the indices (Pillow's P), with alpha
             // (PA; planar, whose alpha Pillow reads as 0) or, chunky, an
             // unspecified sample (PX, dropped)
      if (t.spp == 1 || (t.spp == 2 && t.extra == 2)) return kOk;
      if (t.spp == 2 && t.extra == 0)
        return t.planar == 1 ? kOk : kDecoderError;
      return kUnsupported;
    case 2:
      if (t.spp == 3) return kOk;
      if (t.spp > 4 || (t.spp == 4 && t.planar == 2 && t.extra == 0))
        return kDecoderError;
      return t.spp == 4 && ((t.extra >= 0 && t.extra <= 2) ||
                            t.extra == 999)
                 ? kOk
                 : kUnsupported;
    case 1:  // gray, with alpha chunky or planar (whose alpha Pillow
             // reads as 0)
      return t.spp == 1 || (t.spp == 2 && t.alpha) ? kOk : kUnsupported;
    case 5: return t.spp == 4 ? kOk : t.spp > 4 ? kDecoderError : kUnsupported;
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
      case 274:  // Orientation, which Pillow's decode applies
        t->orientation = static_cast<int>(EntryValue(r, ent, 0));
        break;
      case 277: spp_e = ent; break;
      case 278: t->rows_per_strip = EntryValue(r, ent, 0); break;
      case 279: if (!tiles) cnt_e = ent; break;
      case 284: t->planar = EntryValue(r, ent, 0); break;
      case 292: t->t4 = EntryValue(r, ent, 0); break;
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
  const int c = t->compression;
  // Pillow's names of compressions (COMPRESSION_INFO): it opens no other;
  // of those, libtiff fails to read SGILog (but of LogLuv data, which
  // Pillow has no mode for) and WebP (not built in)
  if (c != 1 && c != 5 && c != 8 && c != 32946 && c != 32773 && !Ccitt(c) &&
      c != kJpeg && c != kOldJpeg && c != kThunder && !Packed(c) &&
      c != 34676 && c != 34677 && c != 50001)
    return kRefused;
  const bool filtered = c == 5 || c == 8 || c == 32946 || Packed(c);
  // a PlanarConfiguration other than 1 or 2, and a Predictor other than
  // 1-3 where the codec takes one: Pillow's raw reader reads the former as
  // chunky, libtiff fails to read either
  if (t->planar != 1 && t->planar != 2) {
    if (c != 1 && c != kOldJpeg) return kDecoderError;
    t->planar = 1;
  }
  if (t->predictor < 1 || t->predictor > 3) {
    if (filtered) return kDecoderError;
    t->predictor = 1;
  }
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
    return kRefused;  // "unknown data organization"
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
  // a JPEG page of four RGB samples and no ExtraSamples: Pillow's RGBA,
  // the fourth sample kept where chunky; planar, libtiff's RGBA interface
  // reads it, which takes the fourth for associated alpha
  if (c == kJpeg && p == 2 && t->spp == 4 && nx == 0)
    t->extra = t->planar == 2 ? 1 : 2;
  // YCbCrCoefficients and ReferenceBlackWhite, for libtiff's TIFFYCbCrToRGB
  for (uint32_t i = 0; i < 3 && i < luma_e.count; ++i)
    t->luma[i] = luma_e.type == 5 ? r.Rational(luma_e.value_off + 8 * i)
                                  : static_cast<float>(EntryValue(r, luma_e, i));
  for (uint32_t i = 0; i < 6 && i < refbw_e.count; ++i)
    t->refbw[i] = refbw_e.type == 5
                      ? r.Rational(refbw_e.value_off + 8 * i)
                      : static_cast<float>(EntryValue(r, refbw_e, i));
  t->alpha = t->extra == 2 || (t->extra == 1 && c == kJpeg);
  const int b = t->bits;
  // ThunderScan decodes 4-bit samples only ("Wrong bitspersample value"),
  // CCITT 1-bit gray, libtiff's SGILog and WebP nothing Pillow reads
  if (c == kThunder && (b != 4 || t->spp != 1)) return kDecoderError;
  if (Ccitt(c) && (b != 1 || t->spp != 1 || (p != 0 && p != 1) || t->alpha))
    return kDecoderError;
  if (c == 34676 || c == 34677 || c == 50001) return kDecoderError;
  bool raw_ycc = false;
  if (c == kJpeg) {
    if (sub_e.count >= 2) {
      t->sub_h = static_cast<int>(EntryValue(r, sub_e, 0));
      t->sub_v = static_cast<int>(EntryValue(r, sub_e, 1));
      if (t->sub_h < 1 || t->sub_v < 1) return kBadData;
    }
    const int rc = CheckJpeg(*t);
    if (rc != kOk) return rc;
    if (p == 3) {  // the ColorMap's high bytes (ik_tiffx_more)
      if (cmap_e.count < 3 * 256u) return kBadData;
      t->colors = 256;
      t->colormap.resize(3 * 256);
      for (uint32_t k = 0; k < 3; ++k)
        for (uint32_t j = 0; j < 256; ++j)
          t->colormap[k * 256 + j] = static_cast<uint8_t>(
              EntryValue(r, cmap_e, k * (cmap_e.count / 3) + j) >> 8);
    }
    if (tables_e.count > 0) {  // a count of 0 is no tables
      t->tables_off = tables_e.value_off;
      t->tables_len = tables_e.count * TypeSize(tables_e.type);
    }
  } else if (c == kOldJpeg) {
    // three 8-bit samples (one, gray); libtiff's OJPEG reads the samples
    // chunky whatever PlanarConfiguration says
    if ((t->spp != 3 && t->spp != 1) || b != 8) return kUnsupported;
    t->planar = 1;
    if (sub_e.count >= 2) {  // the tables-in-tags form's frame
      t->sub_h = static_cast<int>(EntryValue(r, sub_e, 0));
      t->sub_v = static_cast<int>(EntryValue(r, sub_e, 1));
    } else {
      t->sub_h = t->sub_v = 2;
    }
    if (t->sub_h < 1 || t->sub_h > 2 || t->sub_v < 1 || t->sub_v > 2)
      return kDecoderError;
    // libtiff: an interchange format past the file is none; a length of 0,
    // or past the file, runs to its end
    if (t->jif_off >= len) t->jif_off = 0;
    if (t->jif_off == 0) {
      t->jif_len = 0;
    } else if (t->jif_len == 0 || t->jif_len > len - t->jif_off) {
      t->jif_len = len - t->jif_off;
    }
  } else if (p == 2) {
    // RGB with extra samples the pinned decoder does not take (a fifth and
    // sixth, ExtraSamples 999): the first unspecified (dropped),
    // associated (Pillow's RGBa, unpremultiplied) or alpha, 8-bit
    if (b != 8 || t->spp < 4 || nx < 1) return kUnsupported;
    // in planes: four samples Pillow reads (its raw reader band by band,
    // or libtiff), more its raw reader has no unpacker for, libtiff fails
    if (t->planar == 2 && t->spp > 4) return c == 1 ? kRawMode : kDecoderError;
    t->alpha = extra[0] != 0;
    t->premultiplied = extra[0] == 1;
  } else if (t->alpha) {  // Pillow's LA and PA
    if ((p != 1 && p != 3) || t->spp != 2 || b != 8) return kUnsupported;
    // a planar page Pillow's raw reader has no unpacker for; libtiff reads
    if (t->planar == 2 && c == 1) return kRawMode;
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
    // 1-, 2- and 4-bit gray; 12-bit (Pillow's I;12, little-endian files
    // only); 32-bit float and integer gray (Pillow's F and I), the key
    // having checked their photometric and format; 16-bit gray (Pillow's
    // I;16) in LZMA or Zstandard, which the pinned decoder does not take
    if (b != 1 && b != 2 && b != 4 && b != 12 && b != 32 &&
        !(b == 16 && Packed(c)))
      return kUnsupported;
  } else if (p == 3) {
    // 1-, 2- and 4-bit; 8-bit with an unspecified extra sample (Pillow's
    // P of PX), whose planes its raw reader has no unpacker for and
    // libtiff's read fails on
    if (t->spp == 2 && t->planar == 2) return c == 1 ? kRawMode : kDecoderError;
    if (t->spp == 2 ? b != 8 || t->extra != 0
                    : t->spp != 1 || (b != 1 && b != 2 && b != 4))
      return kUnsupported;
    if (cmap_e.count < 3) return kBadData;
    t->colors = cmap_e.count / 3;
    if (t->colors > 65536) return kBadData;
    t->colormap.resize(3 * static_cast<size_t>(t->colors));
    for (uint32_t j = 0; j < 3 * t->colors; ++j)
      t->colormap[j] = static_cast<uint8_t>(EntryValue(r, cmap_e, j) >> 8);
  } else if (p == 5) {
    // 8 bits, chunky or planar; 16 bits, chunky (Pillow reads a planar
    // one's planes as 8-bit bands); 8 bits with one or two extra samples,
    // chunky (a planar one's extra band Pillow cannot read)
    if (t->spp > 4 && t->planar == 2) return kRefused;
  } else if (p == 6) {
    // YCbCr without JPEG: Pillow's raw reader takes RGBX, four bytes a
    // pixel, from three, and runs out of the file (RawYccLeft, once the
    // strips are read); libtiff's RGBA interface decodes the other
    // compressions, in the chroma blocks it has a routine for (chunky) or
    // with no subsampling (planar); YCbCrSubSampling is (2, 2) where the
    // tag is missing
    if (t->spp == 1) {  // Pillow's L: its raw reader's gray, libtiff none
      if (c != 1) return kDecoderError;
      t->photometric = 1;
    } else if (c == 1) {
      raw_ycc = true;
    } else {
      if (t->spp != 3) return kUnsupported;
      t->sub_h = sub_e.count >= 2 ? static_cast<int>(EntryValue(r, sub_e, 0))
                                  : 2;
      t->sub_v = sub_e.count >= 2 ? static_cast<int>(EntryValue(r, sub_e, 1))
                                  : 2;
      const int hv = t->sub_h << 4 | t->sub_v;
      const bool put = t->planar == 1 ? hv == 0x44 || hv == 0x42 ||
                                            hv == 0x41 || hv == 0x22 ||
                                            hv == 0x21 || hv == 0x12 ||
                                            hv == 0x11
                                      : hv == 0x11;
      if (!put) return kDecoderError;
    }
  } else if (p == 8) {  // CIELab: 8-bit L, a, b, chunky or planar
    if (t->spp != 3) return kUnsupported;
  } else {
    return kUnsupported;
  }
  if (t->planar == 2 && t->spp == 1) t->planar = 1;  // the same layout
  // libtiff's horizontal differencing takes 8 bits and more only; its
  // floating-point differencing, floats only
  if (filtered && t->predictor == 2 && b == 12) return kDecoderError;
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
  t->ycc_full = p == 6 && c != 1 && c != kJpeg && c != kOldJpeg && !tiles &&
                t->planar == 1 && t->rows_per_strip % t->sub_v != 0 &&
                t->rows_per_strip < t->height;
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
  // Pillow's raw read of the three samples as RGBX (DecodeRawYcc), or the
  // bytes it leaves unread where the file runs out
  if (raw_ycc) {
    t->unread = RawYccLeft(len, *t);
    return t->unread >= 0 ? kRefused : kOk;
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

// libtiff's decoder (tif_fax3.c, tif_fax3.h), state for state: its lookup
// tables (mkg3states: a 7-bit window for the 2-D modes, 12 bits for white
// runs, 13 for black; 7 zero bits are the 2-D table's EOL, 11 the run
// tables'; every other window that holds no code is no state, of width 0),
// its bit reader, which pads with zeros where a strip's data ends until a
// code has used them, and its rows of run lengths. A code libtiff does not
// expect ("Bad code word") ends the row, which CLEANUP_RUNS closes, and the
// decode goes on, as does an EOL inside a row; a run past the width is
// cut. What makes libtiff's strip decode fail (a strip's data ending
// before its rows do, but in a Group 4 strip past its first row; more runs
// than a row has room for) is Pillow's "decoder error -2" here.
enum FaxState : uint8_t {
  kNull, kPass, kHoriz, kV0, kVR, kVL, kExt, kTermW, kTermB, kMakeUpW,
  kMakeUpB, kMakeUp, kEolCode,
};

struct TabEnt {
  uint8_t state = kNull, width = 0;
  int16_t param = 0;
};

struct FaxTables {
  TabEnt main[1 << 7], white[1 << 12], black[1 << 13];

  template <size_t N>
  static void Fill(TabEnt* t, int size, const Code (&codes)[N],
                   uint8_t term, uint8_t makeup) {
    for (const Code& c : codes) {
      if (c.run < 0) continue;  // the EOL: 11 zero bits, below
      const int shift = size - c.len;
      for (int j = 0; j < (1 << shift); ++j)
        t[(c.code << shift) | j] = {c.run < 64 ? term : makeup, c.len,
                                    c.run};
    }
  }

  FaxTables() {
    Fill(white, 12, kWhite, kTermW, kMakeUpW);
    Fill(white, 12, kShared, kMakeUp, kMakeUp);
    Fill(black, 13, kBlack, kTermB, kMakeUpB);
    Fill(black, 13, kShared, kMakeUp, kMakeUp);
    for (int j = 0; j < 2; ++j) white[j] = {kEolCode, 11, 0};
    for (int j = 0; j < 4; ++j) black[j] = {kEolCode, 11, 0};
    // (code, length, state, param) of the 2-D modes
    const struct { uint8_t code, len, state; int8_t param; } modes[] = {
        {0x1, 1, kV0, 0},   {0x3, 3, kVR, 1},  {0x2, 3, kVL, 1},
        {0x1, 3, kHoriz, 0}, {0x1, 4, kPass, 0}, {0x3, 6, kVR, 2},
        {0x2, 6, kVL, 2},   {0x3, 7, kVR, 3},  {0x2, 7, kVL, 3},
        {0x1, 7, kExt, 0},  {0x0, 7, kEolCode, 0}};
    for (const auto& m : modes)
      for (int j = 0; j < (1 << (7 - m.len)); ++j)
        main[(m.code << (7 - m.len)) | j] = {m.state, m.len, m.param};
  }
};

const FaxTables& Fax() {
  static const FaxTables t;
  return t;
}

// libtiff's bit accumulator, MSB first: `avail` bits in the low bits of
// `acc`, the next one highest. Need() loads bytes up to n bits; where the
// data has ended it pads with zeros to n, unless no bit is left (false:
// libtiff's end-of-data label).
struct FaxBits {
  const uint8_t* cp;
  const uint8_t* ep;
  uint32_t acc = 0;
  int avail = 0;

  bool Need(int n) {
    while (avail < n) {
      if (cp >= ep) {
        if (avail == 0) return false;
        acc <<= n - avail;
        avail = n;
        return true;
      }
      acc = (acc << 8) | *cp++;
      avail += 8;
    }
    return true;
  }
  uint32_t Get(int n) const { return (acc >> (avail - n)) & ((1u << n) - 1); }
  void Clr(int n) {
    avail -= n;
    acc = avail > 0 ? acc & ((1u << avail) - 1) : 0;
  }
};

// int arithmetic as libtiff's: sums wrap at 32 bits
inline int Wrap(int64_t v) { return static_cast<int>(static_cast<uint32_t>(v)); }

// Bits [s, e) of a row set (black) or cleared, whole bytes at once.
void PaintRun(uint8_t* row, int64_t s, int64_t e, bool black) {
  if (s >= e) return;
  const int64_t b0 = s >> 3, b1 = (e - 1) >> 3;
  uint8_t head = 0xFF >> (s & 7), tail = 0xFF << (7 - ((e - 1) & 7));
  if (b0 == b1) head &= tail;
  auto put = [&](int64_t b, uint8_t m) {
    row[b] = black ? row[b] | m : row[b] & ~m;
  };
  put(b0, head);
  if (b0 == b1) return;
  std::memset(row + b0 + 1, black ? 0xFF : 0, b1 - b0 - 1);
  put(b1, tail);
}

// libtiff's _TIFFFax3fillruns: the runs [runs, erun), white first, painted
// on a row of `lastx` pixels (bits set for black), each run cut in place to
// what the row has left; a row whose runs end short keeps its other bits.
void FillRuns(uint8_t* row, uint32_t* runs, uint32_t* erun, int lastx) {
  if ((erun - runs) & 1) *erun++ = 0;
  int64_t x = 0;
  for (; runs < erun; runs += 2)
    for (int k = 0; k < 2; ++k) {
      if (x + runs[k] > lastx) runs[k] = static_cast<uint32_t>(lastx - x);
      PaintRun(row, x, x + runs[k], k == 1);
      x += runs[k];
    }
}

// What libtiff's decoder keeps from strip to strip of an image: its mode
// (FAXMODE_NOEOL, which its retry sets) and its arrays of runs, of which a
// strip's start resets the first two of the reference row only.
struct FaxImage {
  bool noeol = false;
  std::vector<uint32_t> runs;
  // the strip's data starts at an odd address (libtiff reads it in place
  // from Pillow's copy of the file): word alignment counts from there
  bool odd_base = false;
};

// One strip or tile of `rows` rows of `width` 1-bit pixels, each row
// (width + 7) / 8 bytes, bits set for black (libtiff's sense: photometric
// decides what black is), as libtiff's Fax3DecodeRLE (2), Fax3Decode1D and
// Fax3Decode2D (3) and Fax4Decode (4) write it. Rows past one where a Group
// 4 strip's data ends are left as `dst` held them.
class FaxDecoder {
 public:
  FaxDecoder(int compression, uint32_t t4, const uint8_t* src, size_t n,
             int width, FaxImage& image)
      : c_(compression), two_d_(compression == 4 || (compression == 3 &&
                                                     (t4 & 1))),
        lastx_(width), src_(src), n_(n), in_{src, src + n},
        noeol_(image.noeol), odd_base_(image.odd_base) {
    // Fax3SetupState: room for a row's runs, twice over with a reference
    nruns_ = static_cast<size_t>((width + 1 + 31) / 32) * 32;
    if (two_d_) nruns_ *= 2;
    if (image.runs.size() != 2 * nruns_ + 2)  // FillRuns' pad past a row
      image.runs.assign(2 * nruns_ + 2, 0);
    cur_ = image.runs.data();
    ref_ = image.runs.data() + nruns_;
    ref_[0] = static_cast<uint32_t>(width);  // the white row above the first
    ref_[1] = 0;
  }

  int Decode(uint8_t* dst, size_t rows) {
    const size_t rb = (lastx_ + 7) / 8;
    for (line_ = 0; line_ < rows; ++line_) {
      a0_ = 0;
      run_ = 0;
      pa_ = cur_;
      uint8_t* row = dst + line_ * rb;
      int rc = kOk;
      if (c_ == 3 && !noeol_ && SyncEol() == kEofData) {
        // libtiff's retry of Group 3 data without EOLs: the strip read
        // again from its start, this row on, and every later strip, with
        // no EOL before a row
        noeol_ = true;
        in_ = FaxBits{src_, src_ + n_};
      }
      if (c_ == 4 || (two_d_ && !(rc = TagBit()))) {
        pb_ = ref_;
        b1_ = static_cast<int>(*pb_++);
        rc = Expand2D();
        if (c_ == 4 && rc == kOk && eol_) rc = kEofData;  // EOFG4
      } else if (rc == kOk || rc == 2) {
        rc = Expand1D();
      }
      if (rc != kOk && rc != kEofData) return kDecoderError;
      if (rc == kEofData) {
        if (c_ == 4) {  // EOFG4: the EOFB's 13 bits, then the row
          if (in_.Need(13)) in_.Clr(13);
          FillRuns(row, cur_, pa_, lastx_);
          // Fax4Decode does not fail a strip past its first row
          return line_ ? kOk : kDecoderError;
        }
        FillRuns(row, cur_, pa_, lastx_);
        return kDecoderError;
      }
      FillRuns(row, cur_, pa_, lastx_);
      if (c_ == 2) {  // FAXMODE_BYTEALIGN
        in_.Clr(in_.avail & 7);
      } else if (c_ == kRleW) {  // FAXMODE_WORDALIGN
        in_.Clr(in_.avail & 15);
        if (in_.avail == 0 && ((in_.cp - src_) & 1) != odd_base_) ++in_.cp;
      } else if (two_d_) {
        if ((c_ == 4 || pa_ < cur_ + nruns_) && SetValue(0) != kOk)
          return kDecoderError;  // the imaginary change of the reference
        std::swap(cur_, ref_);
      }
    }
    return kOk;
  }

 private:
  static constexpr int kEofData = 1;  // libtiff's end-of-data label

  // A Group 3 2-D row's tag bit: 0 for a 2-D row, 2 for a 1-D one, or
  // kEofData (after the cleanup of the empty row)
  int TagBit() {
    if (!in_.Need(1)) return Eof2D();
    const bool one_d = in_.Get(1);
    in_.Clr(1);
    return one_d ? 2 : kOk;
  }

  int SetValue(int64_t x) {
    if (pa_ >= cur_ + nruns_) return kBadData;  // "Buffer overflow"
    *pa_++ = static_cast<uint32_t>(run_ + x);
    a0_ = Wrap(a0_ + x);
    run_ = 0;
    return kOk;
  }

  // CLEANUP_RUNS
  int Cleanup() {
    if (run_ && SetValue(0) != kOk) return kBadData;
    if (a0_ != lastx_) {
      while (a0_ > lastx_ && pa_ > cur_) a0_ = Wrap(a0_ - *--pa_);
      if (a0_ < lastx_) {
        if (a0_ < 0) a0_ = 0;
        if (((pa_ - cur_) & 1) && SetValue(0) != kOk) return kBadData;
        return SetValue(lastx_ - a0_);
      }
      if (a0_ > lastx_) {
        if (SetValue(lastx_) != kOk) return kBadData;
        return SetValue(0);
      }
    }
    return kOk;
  }

  // SYNC_EOL: to 11 zero bits (unless an EOL ended the row before), the
  // zero bytes and bits that follow, then the EOL's 1 bit
  int SyncEol() {
    if (!eol_) {
      while (true) {
        if (!in_.Need(11)) return kEofData;
        if (in_.Get(11) == 0) break;
        in_.Clr(1);
      }
    }
    while (true) {
      if (!in_.Need(8)) return kEofData;
      if (in_.Get(8)) break;
      in_.Clr(8);
    }
    while (in_.Get(1) == 0) in_.Clr(1);
    in_.Clr(1);
    eol_ = false;
    return kOk;
  }

  // A run's codes (make-up, then terminating) from `tab` of `bits`:
  // kOk at the terminating code, 2 for an EOL, 3 for no code, or
  // kEofData.
  int Run(const TabEnt* tab, int bits, uint8_t term, uint8_t makeup) {
    while (true) {
      if (!in_.Need(bits)) return kEofData;
      const TabEnt& e = tab[in_.Get(bits)];
      in_.Clr(e.width);
      if (e.state == term) return SetValue(e.param) == kOk ? kOk : kBadData;
      if (e.state == makeup || e.state == kMakeUp) {
        a0_ = Wrap(static_cast<int64_t>(a0_) + e.param);
        run_ = Wrap(static_cast<int64_t>(run_) + e.param);
        continue;
      }
      return e.state == kEolCode ? 2 : 3;
    }
  }

  // EXPAND1D, its cleanup included
  int Expand1D() {
    const FaxTables& t = Fax();
    while (true) {
      int rc = Run(t.white, 12, kTermW, kMakeUpW);
      if (rc == kOk && a0_ < lastx_)
        rc = Run(t.black, 13, kTermB, kMakeUpB);
      else if (rc == kOk)
        break;
      if (rc == kBadData) return rc;
      if (rc == kEofData) {
        const int c = Cleanup();
        return c == kOk ? kEofData : c;
      }
      if (rc == 2) eol_ = true;
      if (rc != kOk) break;  // an EOL, or a code libtiff does not expect
      if (a0_ >= lastx_) break;
      if (pa_[-1] == 0 && pa_[-2] == 0) pa_ -= 2;
    }
    return Cleanup();
  }

  // CHECK_b1
  int CheckB1() {
    if (pa_ != cur_)
      while (b1_ <= a0_ && b1_ < lastx_) {
        if (pb_ + 1 >= ref_ + nruns_) return kBadData;
        b1_ = Wrap(static_cast<int64_t>(b1_) + pb_[0] + pb_[1]);
        pb_ += 2;
      }
    return kOk;
  }

  // EXPAND2D, its cleanup included
  int Expand2D() {
    const FaxTables& t = Fax();
    bool bad = false;  // a code libtiff does not expect: goto eol2d
    while (a0_ < lastx_ && !bad) {
      if (pa_ >= cur_ + nruns_) return kBadData;
      if (!in_.Need(7)) return Eof2D();
      const TabEnt e = t.main[in_.Get(7)];
      in_.Clr(e.width);
      switch (e.state) {
        case kPass:
          if (CheckB1() != kOk || pb_ + 1 >= ref_ + nruns_) return kBadData;
          b1_ = Wrap(static_cast<int64_t>(b1_) + *pb_++);
          run_ = Wrap(static_cast<int64_t>(run_) + b1_ - a0_);
          a0_ = b1_;
          b1_ = Wrap(static_cast<int64_t>(b1_) + *pb_++);
          break;
        case kHoriz: {
          const bool black = (pa_ - cur_) & 1;
          for (int k = 0; k < 2 && !bad; ++k) {
            const int rc = (black != (k == 1))
                               ? Run(t.black, 13, kTermB, kMakeUpB)
                               : Run(t.white, 12, kTermW, kMakeUpW);
            if (rc == kBadData) return rc;
            if (rc == kEofData) return Eof2D();
            bad = rc != kOk;
          }
          if (!bad && CheckB1() != kOk) return kBadData;
          break;
        }
        case kV0:
        case kVR:
          if (CheckB1() != kOk || pb_ >= ref_ + nruns_ ||
              SetValue(static_cast<int64_t>(b1_) - a0_ + e.param) != kOk)
            return kBadData;
          b1_ = Wrap(static_cast<int64_t>(b1_) + *pb_++);
          break;
        case kVL:
          if (CheckB1() != kOk) return kBadData;
          if (b1_ < static_cast<int64_t>(a0_) + e.param) {
            bad = true;
            break;
          }
          if (SetValue(static_cast<int64_t>(b1_) - a0_ - e.param) != kOk)
            return kBadData;
          if (pb_ <= ref_) return kBadData;
          b1_ = Wrap(static_cast<int64_t>(b1_) - *--pb_);
          break;
        case kExt:
          *pa_++ = static_cast<uint32_t>(lastx_ - a0_);
          bad = true;
          break;
        default:  // the EOL (7 zero bits, then 4 more)
          *pa_++ = static_cast<uint32_t>(lastx_ - a0_);
          if (!in_.Need(4)) return Eof2D();
          in_.Clr(4);
          eol_ = true;
          bad = true;
          break;
      }
    }
    if (!bad && run_) {
      if (static_cast<int64_t>(run_) + a0_ < lastx_) {  // a final V0
        if (!in_.Need(1)) return Eof2D();
        if (in_.Get(1)) {
          in_.Clr(1);
          if (SetValue(0) != kOk) return kBadData;
        }
      } else if (SetValue(0) != kOk) {
        return kBadData;
      }
    }
    return Cleanup();
  }

  int Eof2D() {
    const int c = Cleanup();
    return c == kOk ? kEofData : c;
  }

  int c_;
  bool two_d_;
  int lastx_;
  const uint8_t* src_;
  size_t n_;
  FaxBits in_;
  bool& noeol_;  // libtiff's FAXMODE_NOEOL, set by its retry
  bool odd_base_;
  size_t nruns_ = 0, line_ = 0;
  uint32_t *cur_, *ref_, *pa_ = nullptr, *pb_ = nullptr;
  int a0_ = 0, b1_ = 0, run_ = 0;
  bool eol_ = false;  // EOLcnt
};

int FaxDecode(int compression, uint32_t t4, const uint8_t* src, size_t n,
              uint8_t* dst, size_t rows, int width, FaxImage& image) {
  return FaxDecoder(compression, t4, src, n, width, image).Decode(dst, rows);
}

// -- LZMA (xz) ----------------------------------------------------------------

// libtiff's LZMA codec is liblzma's stream decoder, one .xz stream a strip
// or tile, run until `want` bytes have come out. This library links no
// liblzma: its caller registers a function that runs it (ik_tiffx_set_xz;
// loader.py's, through Python's lzma module), which writes dst[0, want)
// and returns kOk, or a negative code where the stream ends first or does
// not decode, which fails the strip. Unregistered, LZMA is refused.
using XzFn = int (*)(const uint8_t* src, size_t n, uint8_t* dst, size_t want);
XzFn g_xz = nullptr;

int XzDecode(const uint8_t* src, size_t n, uint8_t* dst, size_t want) {
  return g_xz ? g_xz(src, n, dst, want) : kUnsupported;
}

// -- Zstandard -------------------------------------------------------------------

// A Zstandard frame (RFC 8878) decoded as libzstd's streaming decoder
// (which libtiff's ZSTD codec uses, one frame a strip or tile) gives it,
// until `want` bytes have come out, where libtiff stops: raw, RLE and
// compressed blocks; literals raw, RLE or Huffman-coded (one or four
// streams, a tree of direct or FSE-coded weights, or the frame's last
// tree); sequences by predefined, RLE, FSE-coded or repeated tables;
// repeat offsets. No dictionary. A frame that ends first, or that does not
// decode, fails the strip.
class Zstd {
 public:
  Zstd(uint8_t* out, size_t want) : out_(out), want_(want) {}

  int Frame(const uint8_t* p, size_t n) {
    if (n < 6) return kTruncated;
    const uint32_t magic = p[0] | (p[1] << 8) | (p[2] << 16) |
                           (static_cast<uint32_t>(p[3]) << 24);
    if (magic != 0xFD2FB528u) return kBadData;
    const uint8_t fhd = p[4];
    const int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1;
    const int dict_flag = fhd & 3;
    if (fhd & 0x08) return kBadData;  // the reserved bit
    size_t at = 5 + (single ? 0 : 1);
    if (dict_flag) {
      const int sz = dict_flag == 3 ? 4 : dict_flag;
      uint32_t id = 0;
      for (int i = 0; i < sz && at + i < n; ++i) id |= uint32_t{p[at + i]} << (8 * i);
      if (id != 0) return kBadData;  // a dictionary, which libtiff has none of
      at += sz;
    }
    at += fcs_flag == 0 ? (single ? 1 : 0) : fcs_flag == 1 ? 2
          : fcs_flag == 2 ? 4 : 8;
    while (pos_ < want_) {
      if (at + 3 > n) return kTruncated;
      const uint32_t bh = p[at] | (p[at + 1] << 8) | (p[at + 2] << 16);
      at += 3;
      const bool last = bh & 1;
      const int type = (bh >> 1) & 3;
      const size_t size = bh >> 3;
      if (type == 3) return kBadData;
      if (type == 1) {  // RLE: one byte, size times
        if (at >= n) return kTruncated;
        const size_t k = std::min(size, want_ - pos_);
        std::memset(out_ + pos_, p[at], k);
        pos_ += k;
        at += 1;
      } else {
        if (size > n - at) return kTruncated;
        if (type == 0) {
          const size_t k = std::min(size, want_ - pos_);
          std::memcpy(out_ + pos_, p + at, k);
          pos_ += k;
        } else {
          if (size > (1u << 17)) return kBadData;
          const int rc = Block(p + at, size);
          if (rc != kOk) return rc;
        }
        at += size;
      }
      if (last) break;
    }
    return pos_ == want_ ? kOk : kTruncated;
  }

 private:
  // -- bitstreams ------------------------------------------------------------

  // bits [lo, lo + nb) of p[0, n) as one little-endian number, zeros below
  // bit 0; nb <= 56
  static uint64_t Bits(const uint8_t* p, size_t n, int64_t lo, int nb) {
    if (nb <= 0) return 0;
    if (lo < 0) {
      if (nb + lo <= 0) return 0;
      return Bits(p, n, 0, static_cast<int>(nb + lo)) << (-lo);
    }
    const size_t byte = static_cast<size_t>(lo >> 3);
    uint64_t w = 0;
    for (size_t i = 0; i < 8 && byte + i < n; ++i)
      w |= uint64_t{p[byte + i]} << (8 * i);
    return (w >> (lo & 7)) & ((uint64_t{1} << nb) - 1);
  }

  // a backward bitstream: read from its last set bit down
  struct Back {
    const uint8_t* p = nullptr;
    size_t n = 0;
    int64_t at = 0;  // the bits not yet read lie below `at`
    bool Init(const uint8_t* q, size_t m) {
      p = q;
      n = m;
      if (m == 0 || q[m - 1] == 0) return false;
      at = static_cast<int64_t>(m - 1) * 8 + (31 - __builtin_clz(q[m - 1]));
      return true;
    }
    uint64_t Read(int nb) {
      at -= nb;
      return Bits(p, n, at, nb);
    }
    uint64_t Peek(int nb) const { return Bits(p, n, at - nb, nb); }
    void Skip(int nb) { at -= nb; }
  };

  // -- FSE ---------------------------------------------------------------------

  struct FseCell {
    uint16_t symbol;
    uint8_t bits;
    uint16_t base;
  };
  struct Fse {
    int log = 0;
    std::vector<FseCell> cells;
  };

  // a table from normalised counts (-1 for "less than one")
  static int Build(const int16_t* counts, int nsym, int log, Fse* t) {
    const size_t size = size_t{1} << log;
    t->log = log;
    t->cells.assign(size, FseCell{0, 0, 0});
    std::vector<uint32_t> next(nsym);
    size_t high = size - 1;
    for (int s = 0; s < nsym; ++s)
      if (counts[s] == -1) {
        t->cells[high--].symbol = static_cast<uint16_t>(s);
        next[s] = 1;
      } else {
        next[s] = static_cast<uint32_t>(counts[s]);
      }
    const size_t step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
    size_t at = 0;
    for (int s = 0; s < nsym; ++s)
      for (int i = 0; i < counts[s]; ++i) {
        t->cells[at].symbol = static_cast<uint16_t>(s);
        do {
          at = (at + step) & mask;
        } while (at > high);
      }
    if (at != 0) return kBadData;
    for (size_t u = 0; u < size; ++u) {
      const uint32_t x = next[t->cells[u].symbol]++;
      if (x == 0) return kBadData;
      const int nb = log - (31 - __builtin_clz(x));
      t->cells[u].bits = static_cast<uint8_t>(nb);
      t->cells[u].base = static_cast<uint16_t>((x << nb) - size);
    }
    return kOk;
  }

  // FSE_readNCount: normalised counts of up to `max_sym` + 1 symbols from
  // p[0, n) (a forward bitstream), accuracy at most `max_log`; their byte
  // length into *used
  static int ReadCounts(const uint8_t* p, size_t n, int max_sym, int max_log,
                        int16_t* counts, int* nsym, int* log, size_t* used) {
    int64_t at = 0;
    auto peek = [&](int nb) { return Bits(p, n, at, nb); };
    *log = static_cast<int>(peek(4)) + 5;
    at += 4;
    if (*log > max_log) return kBadData;
    int remaining = (1 << *log) + 1, threshold = 1 << *log;
    int nb = *log + 1, sym = 0;
    bool prev0 = false;
    while (remaining > 1 && sym <= max_sym) {
      if (prev0) {
        int n0 = sym;
        while (true) {
          const int r = static_cast<int>(peek(2));
          at += 2;
          n0 += r;
          if (r != 3) break;
        }
        if (n0 > max_sym) return kBadData;
        while (sym < n0) counts[sym++] = 0;
      }
      const int max = (2 * threshold - 1) - remaining;
      int count;
      const int low = static_cast<int>(peek(nb - 1));
      if (low < max) {
        count = low;
        at += nb - 1;
      } else {
        count = static_cast<int>(peek(nb));
        if (count >= threshold) count -= max;
        at += nb;
      }
      --count;
      remaining -= count < 0 ? -count : count;
      counts[sym++] = static_cast<int16_t>(count);
      prev0 = count == 0;
      while (remaining < threshold) {
        --nb;
        threshold >>= 1;
      }
      if (static_cast<size_t>(at) > 8 * n) return kTruncated;
    }
    if (remaining != 1) return kBadData;
    *nsym = sym;
    *used = static_cast<size_t>((at + 7) >> 3);
    return *used <= n ? kOk : kTruncated;
  }

  // -- Huffman literals ----------------------------------------------------------

  struct Huf {
    int max_bits = 0;
    std::vector<uint8_t> symbol, bits;  // by a max_bits window
  };

  static int HufFromWeights(std::vector<uint8_t> w, Huf* h) {
    uint32_t sum = 0;
    for (uint8_t x : w) {
      if (x > 11) return kBadData;
      if (x) sum += 1u << (x - 1);
    }
    if (sum == 0) return kBadData;
    const int max_bits = 32 - __builtin_clz(sum);  // highbit(sum) + 1
    const uint32_t left = (1u << max_bits) - sum;
    if (left & (left - 1)) return kBadData;  // not a power of two
    w.push_back(static_cast<uint8_t>(32 - __builtin_clz(left)));
    if (max_bits > 11) return kBadData;
    h->max_bits = max_bits;
    h->symbol.assign(size_t{1} << max_bits, 0);
    h->bits.assign(size_t{1} << max_bits, 0);
    size_t at = 0;
    for (int weight = 1; weight <= max_bits; ++weight)
      for (size_t s = 0; s < w.size(); ++s)
        if (w[s] == weight) {
          const size_t span = size_t{1} << (weight - 1);
          if (at + span > h->symbol.size()) return kBadData;
          std::fill(h->symbol.begin() + at, h->symbol.begin() + at + span,
                    static_cast<uint8_t>(s));
          std::fill(h->bits.begin() + at, h->bits.begin() + at + span,
                    static_cast<uint8_t>(max_bits + 1 - weight));
          at += span;
        }
    return at == h->symbol.size() ? kOk : kBadData;
  }

  // a tree description at p[0, n): its byte length into *used
  int ReadTree(const uint8_t* p, size_t n, size_t* used) {
    if (n < 1) return kTruncated;
    const int hb = p[0];
    std::vector<uint8_t> w;
    if (hb >= 128) {  // direct 4-bit weights
      const size_t nw = hb - 127, bytes = (nw + 1) / 2;
      if (1 + bytes > n) return kTruncated;
      for (size_t i = 0; i < nw; ++i)
        w.push_back(i & 1 ? p[1 + i / 2] & 15 : p[1 + i / 2] >> 4);
      *used = 1 + bytes;
    } else {  // FSE-coded weights, two interleaved states
      const size_t csize = hb;
      if (1 + csize > n) return kTruncated;
      int16_t counts[256];
      int nsym = 0, log = 0;
      size_t hdr = 0;
      int rc = ReadCounts(p + 1, csize, 255, 6, counts, &nsym, &log, &hdr);
      if (rc != kOk) return rc;
      Fse t;
      if ((rc = Build(counts, nsym, log, &t)) != kOk) return rc;
      Back b;
      if (!b.Init(p + 1 + hdr, csize - hdr)) return kBadData;
      uint32_t s1 = static_cast<uint32_t>(b.Read(log));
      uint32_t s2 = static_cast<uint32_t>(b.Read(log));
      auto next = [&](uint32_t* s) {
        const FseCell& c = t.cells[*s];
        w.push_back(static_cast<uint8_t>(c.symbol));
        *s = c.base + static_cast<uint32_t>(b.Read(c.bits));
        return b.at < 0;  // past the stream's start
      };
      bool ended = false;
      while (!ended && w.size() < 255) {
        if (next(&s1)) {
          w.push_back(static_cast<uint8_t>(t.cells[s2].symbol));
          ended = true;
        } else if (next(&s2)) {
          w.push_back(static_cast<uint8_t>(t.cells[s1].symbol));
          ended = true;
        }
      }
      if (!ended || w.size() > 255) return kBadData;
      *used = 1 + csize;
    }
    return HufFromWeights(w, &huf_);
  }

  int HufStream(const uint8_t* p, size_t n, uint8_t* dst, size_t count) {
    Back b;
    if (!b.Init(p, n)) return kBadData;
    const int mb = huf_.max_bits;
    for (size_t i = 0; i < count; ++i) {
      const size_t x = static_cast<size_t>(b.Peek(mb));
      dst[i] = huf_.symbol[x];
      b.Skip(huf_.bits[x]);
    }
    return b.at == 0 ? kOk : kBadData;  // the stream read whole
  }

  // the literals section at p[0, n) into lit_; its byte length into *used
  int Literals(const uint8_t* p, size_t n, size_t* used) {
    if (n < 1) return kTruncated;
    const int type = p[0] & 3, sf = (p[0] >> 2) & 3;
    size_t regen, csize = 0, hdr;
    if (type < 2) {
      if (sf == 0 || sf == 2) {
        hdr = 1;
        regen = p[0] >> 3;
      } else if (sf == 1) {
        hdr = 2;
        if (n < 2) return kTruncated;
        regen = (p[0] >> 4) + (size_t{p[1]} << 4);
      } else {
        hdr = 3;
        if (n < 3) return kTruncated;
        regen = (p[0] >> 4) + (size_t{p[1]} << 4) + (size_t{p[2]} << 12);
      }
      lit_.resize(regen);
      if (type == 0) {
        if (hdr + regen > n) return kTruncated;
        std::memcpy(lit_.data(), p + hdr, regen);
        *used = hdr + regen;
      } else {
        if (hdr + 1 > n) return kTruncated;
        std::memset(lit_.data(), p[hdr], regen);
        *used = hdr + 1;
      }
      return kOk;
    }
    int streams = sf == 0 ? 1 : 4;
    if (sf < 2) {
      hdr = 3;
      if (n < 3) return kTruncated;
      regen = (p[0] >> 4) + (size_t{p[1] & 0x3Fu} << 4);
      csize = (p[1] >> 6) + (size_t{p[2]} << 2);
    } else if (sf == 2) {
      hdr = 4;
      if (n < 4) return kTruncated;
      regen = (p[0] >> 4) + (size_t{p[1]} << 4) + (size_t{p[2] & 3u} << 12);
      csize = (p[2] >> 2) + (size_t{p[3]} << 6);
    } else {
      hdr = 5;
      if (n < 5) return kTruncated;
      regen = (p[0] >> 4) + (size_t{p[1]} << 4) +
              (size_t{p[2] & 0x3Fu} << 12);
      csize = (p[2] >> 6) + (size_t{p[3]} << 2) + (size_t{p[4]} << 10);
    }
    if (hdr + csize > n) return kTruncated;
    const uint8_t* q = p + hdr;
    size_t qn = csize;
    if (type == 2) {
      size_t tree = 0;
      const int rc = ReadTree(q, qn, &tree);
      if (rc != kOk) return rc;
      q += tree;
      qn -= tree;
    } else if (huf_.max_bits == 0) {
      return kBadData;  // no tree yet to repeat
    }
    lit_.resize(regen);
    if (streams == 1) {
      const int rc = HufStream(q, qn, lit_.data(), regen);
      if (rc != kOk) return rc;
    } else {
      if (qn < 6) return kTruncated;
      const size_t s1 = q[0] | (q[1] << 8), s2 = q[2] | (q[3] << 8),
                   s3 = q[4] | (q[5] << 8);
      if (6 + s1 + s2 + s3 > qn) return kTruncated;
      const size_t s4 = qn - 6 - s1 - s2 - s3, each = (regen + 3) / 4;
      if (3 * each > regen) return kBadData;
      const size_t sizes[4] = {s1, s2, s3, s4};
      size_t off = 6;
      for (int k = 0; k < 4; ++k) {
        const size_t cnt = k < 3 ? each : regen - 3 * each;
        const int rc = HufStream(q + off, sizes[k], lit_.data() + k * each, cnt);
        if (rc != kOk) return rc;
        off += sizes[k];
      }
    }
    *used = hdr + csize;
    return kOk;
  }

  // -- sequences -------------------------------------------------------------------

  static constexpr int16_t kLlNorm[36] = {
      4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
      2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
  static constexpr int16_t kMlNorm[53] = {
      1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
      1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
      1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
  static constexpr int16_t kOfNorm[29] = {
      1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
      1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
  static constexpr uint32_t kLlBase[36] = {
      0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 18,
      20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048, 4096,
      8192, 16384, 32768, 65536};
  static constexpr uint8_t kLlBits[36] = {
      0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
      1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
  static constexpr uint32_t kMlBase[53] = {
      3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20,
      21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 37,
      39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051,
      4099, 8195, 16387, 32771, 65539};
  static constexpr uint8_t kMlBits[53] = {
      0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
      0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
      2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

  // the table of one of LL, OF, ML by its mode; its bytes into *used
  static int Table(int mode, const uint8_t* p, size_t n, const int16_t* def,
                   int def_n, int def_log, int max_sym, int max_log, Fse* t,
                   bool* have, size_t* used) {
    *used = 0;
    if (mode == 0) {
      *have = true;
      return Build(def, def_n, def_log, t);
    }
    if (mode == 1) {  // one symbol, no bits
      if (n < 1) return kTruncated;
      if (p[0] > max_sym) return kBadData;
      t->log = 0;
      t->cells.assign(1, FseCell{p[0], 0, 0});
      *used = 1;
      *have = true;
      return kOk;
    }
    if (mode == 2) {
      int16_t counts[64];
      int nsym = 0, log = 0;
      const int rc = ReadCounts(p, n, max_sym, max_log, counts, &nsym, &log,
                                used);
      if (rc != kOk) return rc;
      *have = true;
      return Build(counts, nsym, log, t);
    }
    return *have ? kOk : kBadData;  // repeat the last block's
  }

  int Block(const uint8_t* p, size_t n) {
    size_t used = 0;
    int rc = Literals(p, n, &used);
    if (rc != kOk) return rc;
    size_t at = used;
    if (at >= n) return kTruncated;
    uint32_t nseq = p[at++];
    if (nseq >= 128) {
      if (at >= n) return kTruncated;
      if (nseq < 255) {
        nseq = ((nseq - 128) << 8) + p[at++];
      } else {
        if (at + 2 > n) return kTruncated;
        nseq = p[at] + (uint32_t{p[at + 1]} << 8) + 0x7F00;
        at += 2;
      }
    }
    size_t lit_at = 0;
    if (nseq > 0) {
      if (at >= n) return kTruncated;
      const uint8_t modes = p[at++];
      if (modes & 3) return kBadData;
      struct {
        int mode;
        const int16_t* def;
        int def_n, def_log, max_sym, max_log;
        Fse* t;
        bool* have;
      } tabs[3] = {{modes >> 6, kLlNorm, 36, 6, 35, 9, &ll_, &have_ll_},
                   {(modes >> 4) & 3, kOfNorm, 29, 5, 31, 8, &of_, &have_of_},
                   {(modes >> 2) & 3, kMlNorm, 53, 6, 52, 9, &ml_, &have_ml_}};
      for (auto& tb : tabs) {
        size_t u = 0;
        rc = Table(tb.mode, p + at, n - at, tb.def, tb.def_n, tb.def_log,
                   tb.max_sym, tb.max_log, tb.t, tb.have, &u);
        if (rc != kOk) return rc;
        at += u;
      }
      Back b;
      if (!b.Init(p + at, n - at)) return kBadData;
      uint32_t sll = static_cast<uint32_t>(b.Read(ll_.log));
      uint32_t sof = static_cast<uint32_t>(b.Read(of_.log));
      uint32_t sml = static_cast<uint32_t>(b.Read(ml_.log));
      for (uint32_t i = 0; i < nseq; ++i) {
        const uint32_t of_code = of_.cells[sof].symbol;
        const uint32_t ml_code = ml_.cells[sml].symbol;
        const uint32_t ll_code = ll_.cells[sll].symbol;
        if (of_code > 31 || ml_code > 52 || ll_code > 35) return kBadData;
        const uint64_t of_value =
            (uint64_t{1} << of_code) + b.Read(static_cast<int>(of_code));
        const uint64_t ml = kMlBase[ml_code] + b.Read(kMlBits[ml_code]);
        const uint64_t ll = kLlBase[ll_code] + b.Read(kLlBits[ll_code]);
        if (i + 1 < nseq) {
          const FseCell& a = ll_.cells[sll];
          sll = a.base + static_cast<uint32_t>(b.Read(a.bits));
          const FseCell& m = ml_.cells[sml];
          sml = m.base + static_cast<uint32_t>(b.Read(m.bits));
          const FseCell& o = of_.cells[sof];
          sof = o.base + static_cast<uint32_t>(b.Read(o.bits));
        }
        if (b.at < 0) return kBadData;  // past the stream's start
        // the offset, through the repeat offsets
        uint64_t offset;
        if (of_value > 3) {
          offset = of_value - 3;
          rep_[2] = rep_[1];
          rep_[1] = rep_[0];
          rep_[0] = offset;
        } else {
          const uint64_t idx = of_value - 1 + (ll == 0 ? 1 : 0);
          if (idx == 0) {
            offset = rep_[0];
          } else {
            offset = idx == 3 ? rep_[0] - 1 : rep_[idx];
            if (idx != 1) rep_[2] = rep_[1];
            rep_[1] = rep_[0];
            rep_[0] = offset;
          }
        }
        if (ll > lit_.size() - lit_at) return kBadData;
        const size_t kl = std::min<size_t>(ll, want_ - pos_);
        std::memcpy(out_ + pos_, lit_.data() + lit_at, kl);
        pos_ += kl;
        lit_at += ll;
        if (pos_ == want_) return kOk;
        if (offset == 0 || offset > pos_) return kBadData;
        const size_t km = std::min<size_t>(ml, want_ - pos_);
        for (size_t k = 0; k < km; ++k, ++pos_) out_[pos_] = out_[pos_ - offset];
        if (pos_ == want_) return kOk;
      }
      if (b.at != 0) return kBadData;  // the stream read whole
    }
    const size_t rest = lit_.size() - lit_at;
    const size_t k = std::min(rest, want_ - pos_);
    std::memcpy(out_ + pos_, lit_.data() + lit_at, k);
    pos_ += k;
    return kOk;
  }

  uint8_t* out_;
  size_t want_, pos_ = 0;
  std::vector<uint8_t> lit_;
  Huf huf_;
  Fse ll_, of_, ml_;
  bool have_ll_ = false, have_of_ = false, have_ml_ = false;
  uint64_t rep_[3] = {1, 4, 8};
};

int ZstdDecode(const uint8_t* src, size_t n, uint8_t* dst, size_t want) {
  return Zstd(dst, want).Frame(src, n);
}

// libtiff's ThunderDecode, row by row over one strip: a byte's top two
// bits pick a run of the last pixel (its low six bits the count), three
// 2-bit or two 3-bit deltas from it (2 and 4 skip one), or a raw 4-bit
// pixel; pixels pack two a byte, the first high. A row that does not
// come out exactly `width` pixels fails the strip ("decoder error -2").
int ThunderStrip(const uint8_t* src, size_t n, uint8_t* dst, size_t rows,
                 int width) {
  static const int kTwo[4] = {0, 1, 0, -1};
  static const int kThree[8] = {0, 1, 2, 3, 0, -3, -2, -1};
  const size_t rb = (static_cast<size_t>(width) + 1) / 2;
  const int64_t maxpx = width;
  size_t at = 0;
  for (size_t y = 0; y < rows; ++y) {
    uint8_t* op = dst + y * rb;
    uint8_t* const row = op;
    unsigned last = 0;
    int64_t npx = 0;
    auto set = [&](int v) {
      last = static_cast<unsigned>(v) & 0xf;
      if (npx < maxpx) {
        if (npx++ & 1)
          *op++ |= static_cast<uint8_t>(last);
        else
          op[0] = static_cast<uint8_t>(last << 4);
      }
    };
    while (at < n && npx < maxpx) {
      int c = src[at++];
      switch (c & 0xc0) {
        case 0x00: {  // a run of the last pixel
          int64_t k = c;
          if (npx & 1) {
            op[0] |= static_cast<uint8_t>(last);
            last = *op++;
            ++npx;
            --k;
          } else {
            last |= last << 4;
          }
          npx += k;
          if (npx <= maxpx)
            for (; k > 0; k -= 2) *op++ = static_cast<uint8_t>(last);
          if (k == -1 && op > row) *--op &= 0xf0;
          last &= 0xf;
          break;
        }
        case 0x40:  // three 2-bit deltas
          for (int sh = 4; sh >= 0; sh -= 2) {
            const int d = (c >> sh) & 3;
            if (d != 2) set(static_cast<int>(last) + kTwo[d]);
          }
          break;
        case 0x80:  // two 3-bit deltas
          for (int sh = 3; sh >= 0; sh -= 3) {
            const int d = (c >> sh) & 7;
            if (d != 4) set(static_cast<int>(last) + kThree[d]);
          }
          break;
        default:  // a raw pixel
          set(c);
          break;
      }
    }
    if (npx != maxpx) return kDecoderError;
  }
  return kOk;
}

int Decompress(const Tiff& t, const uint8_t* src, size_t n, uint8_t* dst,
               size_t rows, size_t rowbytes, int width, FaxImage& fax) {
  const size_t want = rows * rowbytes;
  switch (t.compression) {
    case 1:
      if (n < want) return kTruncated;
      std::memcpy(dst, src, want);
      return kOk;
    case kThunder:
      return ThunderStrip(src, n, dst, rows, width);
    case kLzma:  // libtiff fails the strip: Pillow's "decoder error -2"
      return XzDecode(src, n, dst, want) == kOk ? kOk : kDecoderError;
    case kZstd:
      return ZstdDecode(src, n, dst, want) == kOk ? kOk : kDecoderError;
    case 2: case 3: case 4: case kRleW:
      return FaxDecode(t.compression, t.t4, src, n, dst, rows, width, fax);
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

// The chroma grid of a YCbCr page without JPEG as ik_tiffx_decode writes
// it: (rows, columns, subsampling of each axis); full resolution where the
// page's strips do not start whole blocks, and for a planar page.
void YccGrid(const Tiff& t, size_t* ch, size_t* cw, int* sh, int* sv) {
  const bool full = t.ycc_full || t.planar == 2;
  *sh = full ? 1 : t.sub_h;
  *sv = full ? 1 : t.sub_v;
  *cw = (t.width + *sh - 1) / *sh;
  *ch = (t.height + *sv - 1) / *sv;
}

// A chunky YCbCr page compressed without JPEG as libtiff's RGBA interface
// reads it: each strip or tile a run of blocks of sub_h x sub_v luma
// samples, row by row, then Cb and Cr (whole blocks, past the image's
// edges too); the predictor, where there is one, undone on libtiff's
// "scanlines" (a row of blocks over sub_v), three samples apart, and left
// undone (libtiff fails the strip, which the RGBA interface reads all the
// same) where a scanline is not whole samples. Writes the Y plane, then
// the Cb and Cr planes of YccGrid; a strip that starts a block row of its
// own (rows per strip not a multiple of sub_v) writes its chroma at full
// resolution, as libtiff replicates it.
int DecodeYcc(const uint8_t* data, const Tiff& t, uint8_t* out,
              size_t out_cap) {
  const size_t W = t.width, H = t.height, sh = t.sub_h, sv = t.sub_v;
  size_t ch, cw;
  int gh, gv;
  YccGrid(t, &ch, &cw, &gh, &gv);
  if (out_cap < W * H + 2 * ch * cw) return kBuffer;
  uint8_t* py = out;
  uint8_t* pc[2] = {out + W * H, out + W * H + ch * cw};
  const size_t rw = t.tiled ? t.tile_w : W;
  const size_t rh = t.tiled ? t.tile_h : t.rows_per_strip;
  const size_t across = t.tiled ? (W + rw - 1) / rw : 1;
  const size_t bw = (rw + sh - 1) / sh, unit = sh * sv + 2;
  const size_t blockrow = bw * unit;
  std::vector<uint8_t> buf;
  FaxImage fax;
  for (size_t k = 0; k < t.offsets.size(); ++k) {
    const size_t ox = (k % across) * rw, oy = (k / across) * rh;
    if (oy >= H) return kBadData;
    const size_t rows = t.tiled ? rh : std::min(rh, H - oy);
    const size_t brows = (rows + sv - 1) / sv, size = brows * blockrow;
    buf.assign(size, 0);
    const uint8_t* raw = data + t.offsets[k];
    std::vector<uint8_t> rev;
    if (t.fill == 2) {
      rev.resize(t.counts[k]);
      for (size_t i = 0; i < rev.size(); ++i) rev[i] = Reverse(raw[i]);
      raw = rev.data();
    }
    const int rc = Decompress(t, raw, t.counts[k], buf.data(), 1, size,
                              static_cast<int>(rw), fax);
    if (rc != kOk) return rc;
    const size_t line = blockrow / sv;  // libtiff's scanline
    if (t.predictor == 2 && line % 3 == 0 && size % line == 0)
      for (size_t at = 0; at < size; at += line)
        Unfilter(buf.data() + at, line, 1, 3, t.le);
    for (size_t by = 0; by < brows; ++by)
      for (size_t bx = 0; bx < bw; ++bx) {
        const uint8_t* b = buf.data() + by * blockrow + bx * unit;
        for (size_t j = 0; j < sv; ++j)
          for (size_t i = 0; i < sh; ++i) {
            const size_t y = oy + by * sv + j, x = ox + bx * sh + i;
            if (y < H && y < oy + rows && x < W) py[y * W + x] = b[j * sh + i];
          }
        for (int c = 0; c < 2; ++c) {
          const uint8_t v = b[sh * sv + c];
          if (t.ycc_full) {  // the block's pixels in this strip
            for (size_t j = 0; j < sv; ++j)
              for (size_t i = 0; i < sh; ++i) {
                const size_t y = oy + by * sv + j, x = ox + bx * sh + i;
                if (y < oy + rows && y < H && x < W) pc[c][y * W + x] = v;
              }
          } else {
            const size_t y = oy / sv + by, x = ox / sh + bx;
            if (y < ch && x < cw) pc[c][y * cw + x] = v;
          }
        }
      }
  }
  return kOk;
}

// A YCbCr page without compression as Pillow's raw reader reads it, where
// the file holds what it reads (RawYccLeft): each region's rows from its
// offset, four bytes a pixel (RGBX) where the page stores three, a row
// every four bytes a pixel of the region's width, or three for a tile past
// the image's right edge; its pixels' first three bytes as R, G and B.
int DecodeRawYcc(const uint8_t* data, size_t len, const Tiff& t,
                 uint8_t* out, size_t out_cap) {
  const size_t W = t.width, H = t.height;
  if (out_cap < W * H * 3) return kBuffer;
  const size_t rw = t.tiled ? t.tile_w : W;
  const size_t rh = t.tiled ? t.tile_h : t.rows_per_strip;
  const size_t across = t.tiled ? (W + rw - 1) / rw : 1;
  for (size_t k = 0; k < t.offsets.size(); ++k) {
    const size_t ox = (k % across) * rw, oy = (k / across) * rh;
    if (oy >= H) continue;
    const size_t line = ox + rw > W && t.tiled ? 3 * rw : 4 * rw;
    const size_t cols = std::min(rw, W - ox);
    for (size_t y = oy; y < H && y < oy + rh; ++y) {
      const size_t at = t.offsets[k] + (y - oy) * line;
      if (at > len || 4 * cols > len - at) return kTruncated;
      for (size_t x = 0; x < cols; ++x)
        std::memcpy(out + (y * W + ox + x) * 3, data + at + 4 * x, 3);
    }
  }
  return kOk;
}

int Decode(const uint8_t* data, size_t len, const Tiff& t, uint8_t* out,
           size_t out_cap) {
  if (t.compression == kJpeg || t.compression == kOldJpeg)
    return kUnsupported;  // ik_tiffx_jpeg_segments
  if (t.photometric == 6 && t.compression == 1)
    return DecodeRawYcc(data, len, t, out, out_cap);
  if (t.photometric == 6 && t.planar == 1) return DecodeYcc(data, t, out,
                                                            out_cap);
  const size_t W = t.width, H = t.height, spp = t.spp;
  const int oc = t.photometric == 5 || t.alpha ? 4 : 3;
  if (out_cap < W * H * oc) return kBuffer;
  // every sample as a byte, chunky: (H, W, spp)
  std::vector<uint8_t> s(W * H * spp);
  const size_t rw = t.tiled ? t.tile_w : W;          // region width
  const size_t rh = t.tiled ? t.tile_h : t.rows_per_strip;
  const size_t lanes = t.planar == 2 ? 1 : spp;      // samples a pixel
  // Pillow's raw reader takes a planar 16-bit CMYK page's planes as 8-bit
  // bands: each region's first bytes, a byte a sample
  const bool bands8 = t.planar == 2 && t.bits == 16 && t.compression == 1;
  const size_t rowbytes = (rw * lanes * (bands8 ? 8 : t.bits) + 7) / 8;
  const size_t per_plane = t.offsets.size() / (t.planar == 2 ? spp : 1);
  const size_t across = t.tiled ? (W + rw - 1) / rw : 1;
  const int bytes = bands8 ? 1 : t.bits / 8;  // 0 below 8 bits
  std::vector<uint8_t> buf(rh * rowbytes), line(rw * lanes), src, tmp;
  const bool filtered = t.compression == 5 || t.compression == 8 ||
                        t.compression == 32946 || Packed(t.compression);
  const bool horizontal = filtered && t.predictor == 2;  // 8 bits and more
  const bool fp = filtered && t.predictor == 3;          // 32-bit floats
  FaxImage fax;  // a CCITT decode's state, from strip to strip
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
    fax.odd_base = t.fill != 2 && (t.offsets[k] & 1);
    const int rc = Decompress(t, raw, t.counts[k], buf.data(), rows,
                              rowbytes, static_cast<int>(rw), fax);
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
      if (t.bits == 12) {  // Pillow's unpackI12_I16, then I;16 to RGB
        for (size_t i = 0; i < count; ++i) {
          const uint8_t* q = r + (i / 2) * 3;
          const uint32_t v = i & 1 ? ((q[1] & 0x0Fu) << 8) | q[2]
                                   : (uint32_t{q[0]} << 4) | (q[1] >> 4);
          line[i] = static_cast<uint8_t>(std::min<uint32_t>(v, 255));
        }
      } else if (t.bits < 8) {
        Unpack(r, t.bits, count, line.data());
      } else if (bytes == 1) {
        std::memcpy(line.data(), r, count);
      } else if (bytes == 2 && t.photometric != 5) {
        // 16-bit gray: Pillow's I;16 (libtiff hands the samples over in
        // the machine's order, which Pillow reads so, but a big-endian
        // file's signed ones, I;16BS, which it reads byte-swapped) to RGB,
        // clipped
        for (size_t i = 0; i < count; ++i) {
          uint32_t v = Word(r + 2 * i, 2, t.le);
          if (t.format == 2 && !t.le) v = ((v & 0xFF) << 8) | (v >> 8);
          line[i] = static_cast<uint8_t>(t.format == 2
              ? std::clamp<int>(static_cast<int16_t>(v), 0, 255)
              : std::min<uint32_t>(v, 255));
        }
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
  if (t.photometric == 8) {  // L, a, b as a chunky page stores them
    std::memcpy(out, s.data(), npx * 3);
    if (t.planar == 2)  // Pillow's bands of a planar page hold a and b
      for (size_t i = 0; i < npx; ++i) {  // unsigned, a chunky page's signed
        out[3 * i + 1] ^= 0x80;
        out[3 * i + 2] ^= 0x80;
      }
    return kOk;
  }
  if (t.photometric == 6) {  // planar YCbCr: the Y, Cb and Cr planes
    for (size_t c = 0; c < 3; ++c)
      for (size_t i = 0; i < npx; ++i) out[c * npx + i] = s[3 * i + c];
    return kOk;
  }
  if (t.photometric == 5) {  // the four inks; extra samples dropped
    for (size_t i = 0; i < npx; ++i) std::memcpy(out + 4 * i, &s[i * spp], 4);
    return kOk;
  }
  if (t.photometric == 2) {  // RGB and its extra samples: RGB or RGBA
    for (size_t i = 0; i < npx; ++i) {
      const uint8_t* q = &s[i * spp];
      uint8_t* o = out + oc * i;
      if (!t.premultiplied || q[3] == 255) {
        std::memcpy(o, q, oc);
      } else if (q[3] == 0) {  // Pillow's unpackRGBa
        std::memset(o, 0, 4);
      } else {
        for (int k = 0; k < 3; ++k)
          o[k] = static_cast<uint8_t>(std::min(q[k] * 255 / q[3], 255));
        o[3] = q[3];
      }
    }
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
      // a planar page's alpha Pillow reads as 0 (through libtiff)
      o[3] = t.planar == 2 ? 0 : s[2 * i + 1];
    }
    return kOk;
  }
  if (t.photometric == 3) {
    const size_t per = t.colors;
    for (size_t i = 0; i < npx; ++i) {
      const size_t v = s[i * spp];
      if (v >= per) return kBadData;  // an index past the ColorMap
      out[3 * i] = t.colormap[v];
      out[3 * i + 1] = t.colormap[per + v];
      out[3 * i + 2] = t.colormap[2 * per + v];
    }
    return kOk;
  }
  if (t.bits >= 16) {  // already bytes; a float's photometric 0 is as 1
    for (size_t i = 0; i < npx; ++i)
      out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = s[i];
    return kOk;
  }
  const int scale = t.bits == 1 ? 255 : t.bits == 2 ? 85 : t.bits == 4 ? 17
                                                                      : 1;
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
  const uint32_t nc = t.spp == 1 ? 1 : 3;  // gray, or YCbCr
  for (const Entry* e : tabs)
    if (e->count < nc) return kBadData;
  if (t.width > 65535 || t.height > 65535) return kUnsupported;
  o->assign({0xFF, 0xD8});
  for (uint32_t i = 0; i < nc; ++i) {
    const size_t q = EntryValue(r, t.qtabs_e, i);
    if (q > r.len || r.len - q < 64) return kTruncated;
    o->insert(o->end(), {0xFF, 0xDB, 0, 67, static_cast<uint8_t>(i)});
    o->insert(o->end(), r.d + q, r.d + q + 64);
  }
  for (int cls = 0; cls < 2; ++cls)
    for (uint32_t i = 0; i < nc; ++i) {
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
  o->insert(o->end(), {0xFF, 0xC0, 0, static_cast<uint8_t>(8 + 3 * nc), 8});
  Put16(o, t.height);
  Put16(o, t.width);
  if (nc == 1)
    o->insert(o->end(), {1, 1, 0x11, 0});
  else
    o->insert(o->end(), {3, 1, static_cast<uint8_t>(t.sub_h << 4 | t.sub_v),
                         0, 2, 0x11, 1, 3, 0x11, 2});
  if (t.restart > 0) {
    if (t.restart > 65535) return kBadData;
    o->insert(o->end(), {0xFF, 0xDD, 0, 4});
    Put16(o, t.restart);
  }
  if (nc == 1)
    o->insert(o->end(), {0xFF, 0xDA, 0, 8, 1, 1, 0x00, 0, 63, 0});
  else
    o->insert(o->end(), {0xFF, 0xDA, 0, 12, 3, 1, 0x00, 2, 0x11, 3, 0x22, 0,
                         63, 0});
  o->insert(o->end(), scan, scan + n);
  o->insert(o->end(), {0xFF, 0xD9});
  return kOk;
}

// The strips of an old-style JPEG page as libtiff's OJPEG module feeds
// their bytes to libjpeg (OJPEGReadBufferFill, OJPEGWriteStreamRst): the
// first strip's from `first` on, then each later one's after an RSTn, n
// counting 0-7 from the first. Their ranges may not overlap: a page whose
// strips hold more bytes than the file is refused as corrupt.
int StripData(const uint8_t* data, size_t len, const Tiff& t, size_t first,
              std::vector<uint8_t>* o) {
  size_t total = 0;
  for (size_t i = 0; i < t.offsets.size(); ++i) total += t.counts[i];
  if (total > len) return kBadData;
  const uint8_t* s0 = data + t.offsets[0];
  if (first < t.counts[0]) o->insert(o->end(), s0 + first, s0 + t.counts[0]);
  for (size_t i = 1; i < t.offsets.size(); ++i) {
    o->insert(o->end(), {0xFF, static_cast<uint8_t>(0xD0 + ((i - 1) & 7))});
    o->insert(o->end(), data + t.offsets[i],
              data + t.offsets[i] + t.counts[i]);
  }
  return kOk;
}

// An old-style JPEG page as the one JPEG stream libtiff hands to libjpeg:
// the JPEGInterchangeFormat stream (its range as Parse corrected it) up to
// its EOI; where it has no EOI, its entropy-coded data runs on into the
// strips; with no interchange format, the first strip's own stream, or the
// tables-in-tags form's (TablesStream), over the strips (StripData). The
// strips are ignored where the interchange format holds the whole stream.
int OldJpegStream(const uint8_t* data, size_t len, const Tiff& t,
                  std::vector<uint8_t>* o) {
  const uint8_t* s0 = data + t.offsets[0];
  const size_t n0 = t.counts[0];
  const uint8_t* head = t.jif_off ? data + t.jif_off : s0;
  const size_t hn = t.jif_off ? t.jif_len : n0;
  if (!t.jif_off && !(n0 >= 2 && s0[0] == 0xFF && s0[1] == 0xD8)) {
    if (t.jpeg_proc != 1) return kDecoderError;  // lossless: libtiff's none
    std::vector<uint8_t> scan;
    const int rc = StripData(data, len, t, 0, &scan);
    if (rc != kOk) return rc;
    return TablesStream(Reader{data, len, t.le}, t, scan.data(), scan.size(),
                        o);
  }
  const size_t sos = SosEnd(head, hn);
  if (sos == 0) return kBadData;  // no JPEG header before a scan
  const size_t eoi = EoiEnd(head, hn, sos);
  if (eoi) {
    o->assign(head, head + eoi);
    return kOk;
  }
  o->assign(head, head + hn);
  // the first strip follows an interchange format; else it was the head
  const int rc = StripData(data, len, t, t.jif_off ? 0 : n0, o);
  if (rc != kOk) return rc;
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
  int32_t width, height, channels;  // as stored, before the Orientation
  // 0: ik_tiffx_decode writes the image; 1: it writes CMYK's four samples
  // as stored; 2: JPEG segments (ik_tiffx_jpeg_segments); 3: it writes
  // CIELab's L, a and b as a chunky page stores them; 4: it writes YCbCr's
  // Y plane, then the Cb and Cr planes, sub_h x sub_v coarser
  int32_t layout;
  // where the parse refuses a YCbCr TIFF without compression (-8): the
  // bytes Pillow's read leaves unread, for its "truncated" message; else -1
  int32_t unread;
};

// What ik_tiffx_more reports beyond IkTiffxInfo.
struct IkTiffxMore {
  int32_t compression;   // the Compression tag
  int32_t orientation;   // the Orientation tag (1 where missing)
  int32_t sub_h, sub_v;  // layout 4's chroma subsampling
  float luma[3];         // layout 4's YCbCrCoefficients and
  float refbw[6];        // ReferenceBlackWhite, or libtiff's defaults
  uint8_t palette[768];  // a JPEG palette page's ColorMap (R, then G, B)
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
  out->layout = jpeg ? 2 : t.photometric == 5 ? 1 : t.photometric == 8 ? 3
                : t.photometric == 6 && t.compression != 1 ? 4 : 0;
  out->unread = static_cast<int32_t>(std::min<int64_t>(t.unread, INT32_MAX));
  return rc;
}

// The Orientation and a YCbCr page's (layout 4) chroma grid and colour
// tags, as ik_tiffx_parse reads the file; its code.
IK_EXPORT int ik_tiffx_more(const uint8_t* data, size_t len,
                            IkTiffxMore* out) {
  Tiff t;
  const int rc = Parse(data, len, &t);
  out->compression = t.compression;
  out->orientation = t.orientation;
  size_t ch, cw;
  int sh = 1, sv = 1;
  if (rc == kOk && t.photometric == 6 && t.compression != 1 &&
      t.compression != kJpeg && t.compression != kOldJpeg)
    YccGrid(t, &ch, &cw, &sh, &sv);
  out->sub_h = sh;
  out->sub_v = sv;
  std::memcpy(out->luma, t.luma, sizeof(t.luma));
  std::memcpy(out->refbw, t.refbw, sizeof(t.refbw));
  std::memset(out->palette, 0, sizeof(out->palette));
  if (t.compression == kJpeg && t.colormap.size() == 768)
    std::memcpy(out->palette, t.colormap.data(), 768);
  return rc;
}

IK_EXPORT int ik_tiffx_decode(const uint8_t* data, size_t len, uint8_t* out,
                              size_t out_cap) {
  Tiff t;
  const int rc = Parse(data, len, &t);
  if (rc != kOk) return rc;
  return Decode(data, len, t, out, out_cap);
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
  out->photometric = old && t.spp == 1 ? 1 : t.photometric;  // gray
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
// the file twice, the tables and two bytes a strip (StripData).
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
int ik_jpeg4_huffman_guard(const uint8_t* data, size_t len);
int ik_jpeg4_parse(const uint8_t* data, size_t len, IkSegInfo* info,
                   IkSegExtra* extra);
int ik_jpeg4_decode_coeffs(const uint8_t* data, size_t len, int16_t** coeffs,
                           uint16_t* qtabs_out);
int ik_jpeg4_decode_libjpeg(const uint8_t* data, size_t len, size_t block,
                            int16_t** coeffs, uint16_t* qtabs_out,
                            int64_t* unread);
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
// Huffman guard of jpeg4_decode.cpp (-4 for a table that would overrun the
// pinned decoder's lookup), the pinned parser, then, where it says -3, the
// port's (jpeg4_decode.cpp).
// Returns 0 or the failing parser's code (the pinned parser's -3 where
// both refuse the frame as unsupported, and where the segment is lossless,
// which a JPEG TIFF page does not take); `four` is 1 where the port's
// parser took the stream (two or four components, an arithmetic-coded
// segment) or failed on it.
int ParseAny(const std::vector<uint8_t>& buf, IkSegInfo* info,
             int32_t* four) {
  *four = 0;
  int rc = ik_jpeg4_huffman_guard(buf.data(), buf.size());
  if (rc != kOk) return rc;
  rc = ik_jpeg_parse(buf.data(), buf.size(), info);
  if (rc == kUnsupported) {
    IkSegExtra extra = {-1, 0};
    const int rc4 = ik_jpeg4_parse(buf.data(), buf.size(), info, &extra);
    if (rc4 != kUnsupported && !(rc4 == kOk && extra.coding == 2)) {
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
      if (rc != kOk && rc != kUnsupported) {
        // libtiff hands libjpeg the segment whole, then a fake EOI: data
        // that ends early decodes, its MCU in flight from zero bits and the
        // rest of the segment zero, as jpeg4_decode.cpp's Lj follows it
        std::fill(scratch.begin(), scratch.end(), int16_t{0});
        int64_t unread = 0;
        rc = ik_jpeg4_decode_libjpeg(buf.data(), buf.size(), 0, comp,
                                     qtabs + 256 * i, &unread);
        if (rc == 1) rc = kTruncated;
      }
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

// -- LZMA and Zstandard pages of the pinned decoder's layouts -------------------

namespace {

void PutLe(std::vector<uint8_t>* o, size_t at, uint32_t v, int bytes,
           bool le) {
  for (int k = 0; k < bytes; ++k)
    (*o)[at + k] = static_cast<uint8_t>(v >> (8 * (le ? k : bytes - 1 - k)));
}

}  // namespace

// The LZMA strip decoder (XzDecode), set once before any decode.
IK_EXPORT void ik_tiffx_set_xz(XzFn fn) { g_xz = fn; }

// A TIFF of the pinned decoder's layouts (8- and 16-bit gray, palette and
// RGB(A)), which this decoder does not take, rewritten for that decoder:
// uncompressed with a PlanarConfiguration or Predictor Pillow's raw reader
// ignores, those tags made 1; LZMA or Zstandard (compression 34925,
// 50000), the file as it is, its Compression tag made deflate (8), and,
// where `strips` is set, each strip or tile decoded
// (XzDecode, ZstdDecode, as libtiff reads it) and stored again as a zlib
// stream of stored blocks, the new IFD after them. libtiff undoes the same
// predictor after either codec. Writes the new file where `cap` holds it
// and returns its length; -3 for any other file, or a negative code.
IK_EXPORT int64_t ik_tiffx_rewrap(const uint8_t* data, size_t len,
                                  uint8_t* out, size_t cap, int strips) {
  if (len < 8 || !((data[0] == 'I' && data[1] == 'I') ||
                   (data[0] == 'M' && data[1] == 'M')))
    return kBadMagic;
  const Reader r{data, len, data[0] == 'I'};
  const uint32_t ifd = r.U32(4);
  if (static_cast<size_t>(ifd) + 2 > len) return kTruncated;
  const uint16_t n = r.U16(ifd);
  if (ifd + 2 + 12u * n > len) return kTruncated;
  uint32_t width = 0, height = 0, rps = 0, tw = 0, th = 0, bits = 1;
  uint32_t spp = 1, planar = 1, compression = 1, predictor = 1;
  Entry off_e, cnt_e;
  size_t comp_at = 0, off_at = 0, cnt_at = 0, planar_at = 0, predictor_at = 0;
  for (uint16_t i = 0; i < n; ++i) {
    const size_t e = ifd + 2 + 12u * i;
    Entry ent;
    ent.type = r.U16(e + 2);
    ent.count = r.U32(e + 4);
    const int sz = TypeSize(ent.type);
    if (sz == 0) continue;
    const size_t total = static_cast<size_t>(sz) * ent.count;
    ent.value_off = total <= 4 ? e + 8 : r.U32(e + 8);
    if (ent.value_off + total > len) return kTruncated;
    switch (r.U16(e)) {
      case 256: width = EntryValue(r, ent, 0); break;
      case 257: height = EntryValue(r, ent, 0); break;
      case 258: bits = EntryValue(r, ent, 0); break;
      case 259: compression = EntryValue(r, ent, 0); comp_at = e; break;
      case 273: case 324: off_e = ent; off_at = e; break;
      case 277: spp = EntryValue(r, ent, 0); break;
      case 278: rps = EntryValue(r, ent, 0); break;
      case 279: case 325: cnt_e = ent; cnt_at = e; break;
      case 284: planar = EntryValue(r, ent, 0); planar_at = e; break;
      case 317: predictor = EntryValue(r, ent, 0); predictor_at = e; break;
      case 322: tw = EntryValue(r, ent, 0); break;
      case 323: th = EntryValue(r, ent, 0); break;
      default: break;
    }
  }
  const bool odd_raw = compression == 1 && (planar < 1 || planar > 2 ||
                                            predictor < 1 || predictor > 3);
  if (!Packed(static_cast<int>(compression)) && !odd_raw) return kUnsupported;
  if (odd_raw) {  // Pillow's raw reader: chunky, no predictor
    std::vector<uint8_t> o(data, data + len);
    for (size_t e : {planar_at, predictor_at})
      if (e) {
        PutLe(&o, e + 2, 3, 2, r.le);
        PutLe(&o, e + 4, 1, 4, r.le);
        PutLe(&o, e + 8, 1, 2, r.le);
        PutLe(&o, e + 10, 0, 2, r.le);
      }
    if (o.size() <= cap) std::memcpy(out, o.data(), o.size());
    return static_cast<int64_t>(o.size());
  }
  if (!comp_at || !off_at || !cnt_at || off_e.count != cnt_e.count ||
      width == 0 || height == 0 || width > (1u << 24) || height > (1u << 24) ||
      spp < 1 || spp > 8 || (bits != 8 && bits != 16))
    return kBadData;
  std::vector<uint8_t> o(data, data + len);
  // the Compression entry, made SHORT 8 in place
  PutLe(&o, comp_at + 2, 3, 2, r.le);
  PutLe(&o, comp_at + 4, 1, 4, r.le);
  PutLe(&o, comp_at + 8, 8, 2, r.le);
  PutLe(&o, comp_at + 10, 0, 2, r.le);
  if (strips) {
    const bool tiles = tw && th;
    const size_t rw = tiles ? tw : width;
    const size_t rh = tiles ? th : (rps && rps < height ? rps : height);
    const size_t lanes = planar == 2 ? 1 : spp;
    const size_t rowbytes = rw * lanes * bits / 8;
    const size_t across = tiles ? (width + rw - 1) / rw : 1;
    const size_t per_plane = (tiles ? across * ((height + rh - 1) / rh)
                                    : (height + rh - 1) / rh);
    if (off_e.count != per_plane * (planar == 2 ? spp : 1)) return kBadData;
    std::vector<uint32_t> offs, cnts;
    std::vector<uint8_t> raw;
    for (uint32_t k = 0; k < off_e.count; ++k) {
      const size_t g = k % per_plane, oy = (g / across) * rh;
      const size_t rows = tiles ? rh : std::min(rh, height - oy);
      const uint32_t at = EntryValue(r, off_e, k), cnt = EntryValue(r, cnt_e, k);
      if (static_cast<size_t>(at) + cnt > len) return kTruncated;
      raw.assign(rows * rowbytes, 0);
      const int rc = compression == kLzma
                         ? XzDecode(data + at, cnt, raw.data(), raw.size())
                         : ZstdDecode(data + at, cnt, raw.data(), raw.size());
      if (rc != kOk) return kDecoderError;  // libtiff fails the strip
      uLongf zn = compressBound(raw.size());
      o.resize(o.size() + (o.size() & 1));
      const size_t start = o.size();
      o.resize(start + zn);
      if (compress2(o.data() + start, &zn, raw.data(), raw.size(), 0) != Z_OK)
        return kBadData;
      o.resize(start + zn);
      if (o.size() > 0xFFFFFFFFu) return kBadData;
      offs.push_back(static_cast<uint32_t>(start));
      cnts.push_back(static_cast<uint32_t>(zn));
    }
    o.resize(o.size() + (o.size() & 1));
    const size_t new_ifd = o.size();
    const size_t arrays = new_ifd + 2 + 12u * n + 4;
    o.resize(arrays + (off_e.count > 1 ? 8u * off_e.count : 0), 0);
    std::memcpy(o.data() + new_ifd, o.data() + ifd, 2 + 12u * n);
    PutLe(&o, new_ifd + 2 + 12u * n, 0, 4, r.le);  // no next IFD
    for (int which = 0; which < 2; ++which) {
      const size_t e = new_ifd + ((which ? cnt_at : off_at) - ifd);
      const std::vector<uint32_t>& v = which ? cnts : offs;
      PutLe(&o, e + 2, 4, 2, r.le);  // LONG
      PutLe(&o, e + 4, static_cast<uint32_t>(v.size()), 4, r.le);
      if (v.size() == 1) {
        PutLe(&o, e + 8, v[0], 4, r.le);
      } else {
        const size_t a = arrays + (which ? 4u * v.size() : 0);
        PutLe(&o, e + 8, static_cast<uint32_t>(a), 4, r.le);
        for (size_t i = 0; i < v.size(); ++i) PutLe(&o, a + 4 * i, v[i], 4, r.le);
      }
    }
    if (new_ifd > 0xFFFFFFFFu) return kBadData;
    PutLe(&o, 4, static_cast<uint32_t>(new_ifd), 4, r.le);
  }
  if (o.size() <= cap) std::memcpy(out, o.data(), o.size());
  return static_cast<int64_t>(o.size());
}
