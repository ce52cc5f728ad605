// The port's own JPEG entropy decode: four-component (CMYK and YCCK)
// frames, baseline frames in several scans, arithmetic-coded frames and
// lossless frames.
//
// The port's copy of the reference's decoder (jpeg_entropy.cpp, pinned
// byte-equal to it) refuses a frame of four components, a baseline frame
// whose first scan is not interleaved over every component, and
// arithmetic-coded and lossless frames, with -3; the reference then
// decodes such a JPEG with Pillow. This decoder is the port's own, for
// those cases only: a frame of 8-bit precision and one to four
// components, in one of three codings.
//
// - Huffman DCT: baseline or extended (SOF0/SOF1) in one interleaved scan
//   or in a sequence of scans of one or more components each (a
//   component's blocks over ceil(cw / 8) x ceil(ch / 8) in its own raster
//   order when it is alone in a scan, T.81 A.2.2; the MCU-padding blocks
//   of such a component are not coded and stay zero), or progressive
//   (SOF2) in any sequence of scans: DC first and refinement scans,
//   interleaved or not, and AC first and refinement scans of one
//   component each, with EOB runs and restart intervals (an EOB run past
//   the scan's last block ends with the scan, and a restart marker ends
//   one, as in libjpeg). The progressive scans follow jpeg_entropy.cpp's
//   (DecodeProgressiveScan, DecodeBlockProgressive, FinalizeProgressive;
//   T.81 G.1.2 and G.2), copied rather than linked.
// - Arithmetic DCT, sequential (SOF9) or progressive (SOF10): the QM
//   decoder of T.81 Annex D with the statistics and conditioning of F.1.4
//   (sequential) and G.1.3 (progressive), DAC segments (L, U, K; 0, 1 and
//   5 by default), the statistics reset at each restart. It follows
//   libjpeg's jdarith.c, as lenient as it is: zero bytes are fed after a
//   marker; a magnitude or a run past the band (JWRN_ARITH_BAD_CODE) ends
//   the decode of the restart interval, the blocks decoded so far kept;
//   restart markers out of sequence are resynchronised as
//   jpeg_resync_to_restart does. Data that ends with no marker is
//   refused (libjpeg's arithmetic decoder cannot suspend for more), and so,
//   fed as Pillow feeds libjpeg (ik_jpeg4_decode_fed), is a scan that
//   needs a byte past the blocks Pillow has handed it (-9).
// - Lossless (SOF3, T.81 Annex H), Huffman coded: predictors 1-7, the
//   point transform, interleaved or one-component scans, restart intervals
//   of whole MCU rows (libjpeg's condition; others are refused). Its
//   output is the samples, not coefficients (ik_jpeg4_decode_lossless).
//
// Progressive blocks accumulate in zigzag order and are put in natural
// order once, at the EOI. An interleaved scan of more than 10 blocks (or
// samples) an MCU is refused with -8, as libjpeg refuses it ("Sampling
// factors too large for interleaved scan"). 12-bit, hierarchical and
// lossless arithmetic frames and other component counts return -3. A
// frame of two components (a JPEG TIFF's gray + alpha segments) decodes as
// one of four does; the JPEG source layer refuses it, as Pillow does.
// Its DCT output matches jpeg_entropy.cpp's ik_jpeg_decode_coeffs:
// quantised coefficient planes [by][bx][64] in natural order, MCU-padded,
// and the four 64-entry quant tables; its header is the same IkJpegInfo
// (a lossless frame's "blocks" are samples: its MCU-padded sample grid),
// plus the transform flag of an Adobe APP14 segment (-1 when there is
// none) and the frame's coding.
//
// Lj, beside them, follows libjpeg-turbo's Huffman decoder to the byte
// (ik_jpeg4_decode_libjpeg): fed as Pillow feeds it, it tells where
// Pillow's decode of data that runs out stops; fed as libtiff feeds a JPEG
// segment, it decodes one that ends early.
//
// The exported names are ik_jpeg4_*: the loader links every native source
// into one library.

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <utility>
#include <vector>

#define IK_EXPORT extern "C" __attribute__((visibility("default")))

namespace {

enum {
  kOk = 0,
  kTruncated = -1,
  kBadMarker = -2,
  kUnsupported = -3,
  kBadHuffman = -4,
  kBadDimensions = -5,
  kMcuTooLarge = -8,  // an interleaved scan of more than 10 blocks an MCU
  kCantSuspend = -9,  // arithmetic data past the bytes Pillow has fed
  kEoi = 1,  // Next(): the EOI marker, after a progressive frame's scans
};

// the frame's coding (Ik4Extra.coding)
enum { kHuffmanDct = 0, kArithDct = 1, kLossless = 2 };

// T.81 Table D.2 (jaricom.c's jpeg_aritab): Qe in bits 16-31, the next
// state after an MPS in bits 8-15, the MPS switch in bit 7 and the next
// state after an LPS in bits 0-6. State 113 is the fixed estimate of 0.5
// (T.851 10.3) that signs and refinement bits take.
#define IK_QE(qe, lps, mps, sw) \
  ((static_cast<uint32_t>(qe) << 16) | ((mps) << 8) | ((sw) << 7) | (lps))
const uint32_t kQe[114] = {
    IK_QE(0x5A1D, 1, 1, 1),     IK_QE(0x2586, 14, 2, 0),
    IK_QE(0x1114, 16, 3, 0),    IK_QE(0x080B, 18, 4, 0),
    IK_QE(0x03D8, 20, 5, 0),    IK_QE(0x01DA, 23, 6, 0),
    IK_QE(0x00E5, 25, 7, 0),    IK_QE(0x006F, 28, 8, 0),
    IK_QE(0x0036, 30, 9, 0),    IK_QE(0x001A, 33, 10, 0),
    IK_QE(0x000D, 35, 11, 0),   IK_QE(0x0006, 9, 12, 0),
    IK_QE(0x0003, 10, 13, 0),   IK_QE(0x0001, 12, 13, 0),
    IK_QE(0x5A7F, 15, 15, 1),   IK_QE(0x3F25, 36, 16, 0),
    IK_QE(0x2CF2, 38, 17, 0),   IK_QE(0x207C, 39, 18, 0),
    IK_QE(0x17B9, 40, 19, 0),   IK_QE(0x1182, 42, 20, 0),
    IK_QE(0x0CEF, 43, 21, 0),   IK_QE(0x09A1, 45, 22, 0),
    IK_QE(0x072F, 46, 23, 0),   IK_QE(0x055C, 48, 24, 0),
    IK_QE(0x0406, 49, 25, 0),   IK_QE(0x0303, 51, 26, 0),
    IK_QE(0x0240, 52, 27, 0),   IK_QE(0x01B1, 54, 28, 0),
    IK_QE(0x0144, 56, 29, 0),   IK_QE(0x00F5, 57, 30, 0),
    IK_QE(0x00B7, 59, 31, 0),   IK_QE(0x008A, 60, 32, 0),
    IK_QE(0x0068, 62, 33, 0),   IK_QE(0x004E, 63, 34, 0),
    IK_QE(0x003B, 32, 35, 0),   IK_QE(0x002C, 33, 9, 0),
    IK_QE(0x5AE1, 37, 37, 1),   IK_QE(0x484C, 64, 38, 0),
    IK_QE(0x3A0D, 65, 39, 0),   IK_QE(0x2EF1, 67, 40, 0),
    IK_QE(0x261F, 68, 41, 0),   IK_QE(0x1F33, 69, 42, 0),
    IK_QE(0x19A8, 70, 43, 0),   IK_QE(0x1518, 72, 44, 0),
    IK_QE(0x1177, 73, 45, 0),   IK_QE(0x0E74, 74, 46, 0),
    IK_QE(0x0BFB, 75, 47, 0),   IK_QE(0x09F8, 77, 48, 0),
    IK_QE(0x0861, 78, 49, 0),   IK_QE(0x0706, 79, 50, 0),
    IK_QE(0x05CD, 48, 51, 0),   IK_QE(0x04DE, 50, 52, 0),
    IK_QE(0x040F, 50, 53, 0),   IK_QE(0x0363, 51, 54, 0),
    IK_QE(0x02D4, 52, 55, 0),   IK_QE(0x025C, 53, 56, 0),
    IK_QE(0x01F8, 54, 57, 0),   IK_QE(0x01A4, 55, 58, 0),
    IK_QE(0x0160, 56, 59, 0),   IK_QE(0x0125, 57, 60, 0),
    IK_QE(0x00F6, 58, 61, 0),   IK_QE(0x00CB, 59, 62, 0),
    IK_QE(0x00AB, 61, 63, 0),   IK_QE(0x008F, 61, 32, 0),
    IK_QE(0x5B12, 65, 65, 1),   IK_QE(0x4D04, 80, 66, 0),
    IK_QE(0x412C, 81, 67, 0),   IK_QE(0x37D8, 82, 68, 0),
    IK_QE(0x2FE8, 83, 69, 0),   IK_QE(0x293C, 84, 70, 0),
    IK_QE(0x2379, 86, 71, 0),   IK_QE(0x1EDF, 87, 72, 0),
    IK_QE(0x1AA9, 87, 73, 0),   IK_QE(0x174E, 72, 74, 0),
    IK_QE(0x1424, 72, 75, 0),   IK_QE(0x119C, 74, 76, 0),
    IK_QE(0x0F6B, 74, 77, 0),   IK_QE(0x0D51, 75, 78, 0),
    IK_QE(0x0BB6, 77, 79, 0),   IK_QE(0x0A40, 77, 48, 0),
    IK_QE(0x5832, 80, 81, 1),   IK_QE(0x4D1C, 88, 82, 0),
    IK_QE(0x438E, 89, 83, 0),   IK_QE(0x3BDD, 90, 84, 0),
    IK_QE(0x34EE, 91, 85, 0),   IK_QE(0x2EAE, 92, 86, 0),
    IK_QE(0x299A, 93, 87, 0),   IK_QE(0x2516, 86, 71, 0),
    IK_QE(0x5570, 88, 89, 1),   IK_QE(0x4CA9, 95, 90, 0),
    IK_QE(0x44D9, 96, 91, 0),   IK_QE(0x3E22, 97, 92, 0),
    IK_QE(0x3824, 99, 93, 0),   IK_QE(0x32B4, 99, 94, 0),
    IK_QE(0x2E17, 93, 86, 0),   IK_QE(0x56A8, 95, 96, 1),
    IK_QE(0x4F46, 101, 97, 0),  IK_QE(0x47E5, 102, 98, 0),
    IK_QE(0x41CF, 103, 99, 0),  IK_QE(0x3C3D, 104, 100, 0),
    IK_QE(0x375E, 99, 93, 0),   IK_QE(0x5231, 105, 102, 0),
    IK_QE(0x4C0F, 106, 103, 0), IK_QE(0x4639, 107, 104, 0),
    IK_QE(0x415E, 103, 99, 0),  IK_QE(0x5627, 105, 106, 1),
    IK_QE(0x50E7, 108, 107, 0), IK_QE(0x4B85, 109, 103, 0),
    IK_QE(0x5597, 110, 109, 0), IK_QE(0x504F, 111, 107, 0),
    IK_QE(0x5A10, 110, 111, 1), IK_QE(0x5522, 112, 109, 0),
    IK_QE(0x59EB, 112, 111, 1), IK_QE(0x5A1D, 113, 113, 0)};
#undef IK_QE
constexpr uint8_t kFixedState = 113;

// The QM decoder's registers and its byte input (jdarith.c's
// arith_decode and get_byte): 0xFF00 is a data 0xFF; at a marker the
// marker is held and zero bytes are fed; past the end of the data with no
// marker, `overrun` is set (libjpeg's decoder cannot suspend for more).
struct Qm {
  const uint8_t* p;
  const uint8_t* end;
  int32_t c = 0, a = 0;
  int ct = -16;  // -16: two initial bytes to read; -1: the interval failed
  int marker = 0;  // the marker met in the data, not yet acted on
  bool overrun = false;

  int Byte() {
    if (p >= end) {
      overrun = true;
      return 0;
    }
    return *p++;
  }

  // one binary decision on statistics bin *st (T.81 D.2)
  int Decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        int data = 0;
        if (!marker) {
          data = Byte();
          if (data == 0xFF) {
            do data = Byte();
            while (data == 0xFF);
            if (data == 0) {
              data = 0xFF;  // a stuffed zero
            } else {
              marker = data;
              data = 0;
            }
          }
        }
        c = (c << 8) | data;
        if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;  // the first two bytes
      }
      a <<= 1;
    }
    const int sv = *st;
    const uint32_t e = kQe[sv & 0x7F];
    const int32_t qe = static_cast<int32_t>(e >> 16);
    const int nl = e & 0xFF, nm = (e >> 8) & 0xFF;
    int32_t temp = a - qe;
    a = temp;
    temp <<= ct;
    int bit = sv >> 7;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {  // conditional exchange: the MPS
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        bit ^= 1;
      }
    } else if (a < 0x8000) {
      if (a < qe) {  // conditional exchange: the LPS
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        bit ^= 1;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      }
    }
    return bit;
  }

  // Scan forward to the next marker (libjpeg's next_marker): false where
  // the data ends first.
  bool NextMarker() {
    while (true) {
      while (p < end && *p != 0xFF) ++p;
      while (p < end && *p == 0xFF) ++p;
      if (p >= end) return false;
      if (*p != 0) {
        marker = *p++;
        return true;
      }
      ++p;  // a stuffed zero: data, not a marker
    }
  }

  // At the end of a restart interval: the RSTn that should come next
  // (read_restart_marker, then jpeg_resync_to_restart where it is not),
  // then the registers afresh. False where the data ends first.
  bool Restart(int want) {
    if (!marker && !NextMarker()) return false;
    while (marker != 0xD0 + want) {
      int action;  // jpeg_resync_to_restart's
      if (marker < 0xC0) {
        action = 2;  // not a marker: look for the next one
      } else if (marker < 0xD0 || marker > 0xD7) {
        action = 3;  // another marker: leave it, the interval reads zeros
      } else if (marker == 0xD0 + ((want + 1) & 7) ||
                 marker == 0xD0 + ((want + 2) & 7)) {
        action = 3;  // one of the next two: an empty interval
      } else if (marker == 0xD0 + ((want - 1) & 7) ||
                 marker == 0xD0 + ((want - 2) & 7)) {
        action = 2;  // an earlier one: look further
      } else {
        action = 1;  // too far off: take it as this one
      }
      if (action == 1) break;
      if (action == 3) {
        c = a = 0;
        ct = -16;
        return true;
      }
      marker = 0;
      if (!NextMarker()) return false;
    }
    marker = 0;
    c = a = 0;
    ct = -16;
    return true;
  }
};

const uint8_t kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

constexpr int kFastBits = 9;

struct Huffman {
  bool present = false;
  // (length << 8) | symbol for codes of at most kFastBits bits, else 0
  uint16_t fast[1 << kFastBits];
  int32_t maxcode[18];  // largest code of each length, -1 when none
  int32_t valptr[17];
  int32_t mincode[17];
  uint8_t vals[256];
  int nvals = 0;

  // jpeg_make_d_derived_tbl's check of a table a scan takes as its DC
  // table: every symbol, a magnitude category, at most 15
  bool DcSymbolsOk() const {
    for (int i = 0; i < nvals; ++i)
      if (vals[i] > 15) return false;
    return true;
  }

  int Build(const uint8_t* counts, const uint8_t* symbols, int n) {
    if (n > 256) return kBadHuffman;
    std::memcpy(vals, symbols, n);
    nvals = n;
    std::memset(fast, 0, sizeof(fast));
    int code = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      valptr[l] = k;
      mincode[l] = code;
      for (int i = 0; i < counts[l - 1]; ++i, ++k, ++code) {
        // over-subscribed: refused before fast[] is written past its end
        if (code >= (1 << l)) return kBadHuffman;
        if (l <= kFastBits) {
          const int shift = kFastBits - l;
          for (int j = 0; j < (1 << shift); ++j)
            fast[(code << shift) | j] = static_cast<uint16_t>((l << 8) | vals[k]);
        }
      }
      maxcode[l] = counts[l - 1] ? code - 1 : -1;
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    present = true;
    return kOk;
  }
};

// Entropy-coded bits: 0xFF00 stuffing removed; zero bits are fed at a
// marker (as libjpeg does) and past the end of the data, which is counted.
struct Bits {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int cnt = 0;
  bool marker = false;
  int64_t pad = 0;  // zero bits fed past the end of the data

  void Fill() {
    while (cnt <= 56) {
      uint32_t b = 0;
      if (!marker && p < end) {
        if (*p == 0xFF) {
          if (p + 1 < end && p[1] == 0x00) {
            b = 0xFF;
            p += 2;
          } else if (p + 1 < end) {
            marker = true;  // stays at the marker
          } else {
            ++p;  // a lone 0xFF at the end: the data is cut
            pad += 8;
          }
        } else {
          b = *p++;
        }
      } else if (!marker) {
        pad += 8;
      }
      buf |= static_cast<uint64_t>(b) << (56 - cnt);
      cnt += 8;
    }
  }
  inline uint32_t Get(int n) {  // n <= 32, after Fill
    if (n == 0) return 0;
    const uint32_t v = static_cast<uint32_t>(buf >> (64 - n));
    buf <<= n;
    cnt -= n;
    return v;
  }
  bool Overrun() const { return pad > cnt; }
};

int DecodeSymbol(Bits& br, const Huffman& h) {
  br.Fill();
  const uint16_t f = h.fast[br.buf >> (64 - kFastBits)];
  if (f) {
    br.Get(f >> 8);
    return f & 0xff;
  }
  for (int l = kFastBits + 1; l <= 16; ++l) {
    const int32_t code = static_cast<int32_t>(br.buf >> (64 - l));
    if (code <= h.maxcode[l]) {
      br.Get(l);
      return h.vals[h.valptr[l] + code - h.mincode[l]];
    }
  }
  return -1;
}

inline int Extend(uint32_t v, int s) {
  return s == 0 ? 0
                : (v < (1u << (s - 1)) ? static_cast<int>(v) - (1 << s) + 1
                                       : static_cast<int>(v));
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0, td = 0, ta = 0;
  int width = 0, height = 0, blocks_w = 0, blocks_h = 0, pred = 0;
};

// One SOS: its components (frame indices) and spectral selection and
// successive approximation.
struct Scan {
  int ns = 0;
  int ci[4] = {0, 0, 0, 0};
  int Ss = 0, Se = 63, Ah = 0, Al = 0;
};

struct Frame {
  const uint8_t* data;
  size_t len;
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
  int restart_interval = 0;
  int adobe_transform = -1;
  bool have_frame = false;
  bool progressive = false;
  int coding = kHuffmanDct;
  // DAC conditioning of the arithmetic tables (defaults: L 0, U 1, K 5)
  uint8_t arith_l[16], arith_u[16], arith_k[16];
  uint16_t qtab[4][64] = {};
  Huffman dc[4], ac[4];
  Component comp[4];
  Scan sos;
  const uint8_t* scan = nullptr;
  const uint8_t* at = nullptr;  // where the marker walk stands
  const uint8_t* seg = nullptr;  // the marker segment it reads
  int scans = 0;                // scans decoded (DecodeScans)
  // Pillow's read block (ImageFile.decodermaxblock), 0 for the data whole,
  // and the end of the bytes fed so far (arithmetic scans, DecodeScans)
  size_t block = 0, win = 0;

  // SOI, then the markers up to the first SOS; scan points at its
  // entropy-coded data.
  int Parse() {
    if (len < 4 || data[0] != 0xFF || data[1] != 0xD8) return kBadMarker;
    std::memset(arith_l, 0, sizeof(arith_l));
    std::memset(arith_u, 1, sizeof(arith_u));
    std::memset(arith_k, 5, sizeof(arith_k));
    at = data + 2;
    return Next();
  }

  // The markers from `at` up to the next SOS, or kEoi at the EOI of a
  // progressive frame that has had a scan.
  int Next() {
    const uint8_t* p = at;
    const uint8_t* end = data + len;
    while (true) {
      seg = p;
      if (p + 2 > end) return kTruncated;
      if (p[0] != 0xFF) return kBadMarker;
      const uint8_t m = p[1];
      p += 2;
      if (m == 0xFF) {  // fill byte
        --p;
        continue;
      }
      if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
      if (m == 0xD9) return scans > 0 ? kEoi : kTruncated;
      if (p + 2 > end) return kTruncated;
      const int seglen = (p[0] << 8) | p[1];
      if (seglen < 2 || p + seglen > end) return kTruncated;
      const uint8_t* s = p + 2;
      const int n = seglen - 2;
      int rc = kOk;
      switch (m) {
        case 0xDB:
          rc = Dqt(s, n);
          break;
        case 0xC4:
          rc = Dht(s, n);
          break;
        case 0xC0:
        case 0xC1:
        case 0xC2:
        case 0xC3:
        case 0xC9:
        case 0xCA:
          if (have_frame) return kBadMarker;
          progressive = m == 0xC2 || m == 0xCA;
          coding = m == 0xC3 ? kLossless : m >= 0xC9 ? kArithDct : kHuffmanDct;
          rc = Sof(s, n);
          break;
        case 0xC5: case 0xC6: case 0xC7: case 0xCB:
        case 0xCD: case 0xCE: case 0xCF:
          return kUnsupported;  // hierarchical, lossless arithmetic
        case 0xCC:
          rc = Dac(s, n);
          break;
        case 0xDD:
          if (n < 2) return kTruncated;
          restart_interval = (s[0] << 8) | s[1];
          break;
        case 0xEE:  // APP14: Adobe's transform flag
          if (n >= 12 && std::memcmp(s, "Adobe", 5) == 0)
            adobe_transform = s[11];
          break;
        case 0xDA:
          rc = Sos(s, n);
          if (rc == kOk) at = scan = p + seglen;
          return rc;
        default:
          break;  // APPn, COM
      }
      if (rc != kOk) return rc;
      p += seglen;
    }
  }

  int Dqt(const uint8_t* s, int n) {
    while (n > 0) {
      const int pq = s[0] >> 4, t = s[0] & 15;
      if (t > 3) return kBadMarker;
      const int need = pq ? 128 : 64;
      if (n < 1 + need) return kTruncated;
      for (int i = 0; i < 64; ++i)
        qtab[t][kZigzag[i]] = pq ? static_cast<uint16_t>((s[1 + 2 * i] << 8) |
                                                         s[2 + 2 * i])
                                 : s[1 + i];
      s += 1 + need;
      n -= 1 + need;
    }
    return kOk;
  }

  // DAC (get_dac): a DC table's L and U (L <= U), an AC table's K
  int Dac(const uint8_t* s, int n) {
    if (n % 2) return kBadMarker;
    for (; n > 0; s += 2, n -= 2) {
      const int index = s[0], val = s[1];
      if (index >= 32) return kBadMarker;
      if (index >= 16) {
        arith_k[index - 16] = static_cast<uint8_t>(val);
      } else {
        if ((val & 15) > (val >> 4)) return kBadMarker;
        arith_l[index] = static_cast<uint8_t>(val & 15);
        arith_u[index] = static_cast<uint8_t>(val >> 4);
      }
    }
    return kOk;
  }

  int Dht(const uint8_t* s, int n) {
    while (n > 0) {
      if (n < 17) return kTruncated;
      const int tc = s[0] >> 4, th = s[0] & 15;
      if (th > 3 || tc > 1) return kBadMarker;
      int total = 0;
      for (int l = 0; l < 16; ++l) total += s[1 + l];
      if (n < 17 + total) return kTruncated;
      const int rc = (tc ? ac[th] : dc[th]).Build(s + 1, s + 17, total);
      if (rc != kOk) return rc;
      s += 17 + total;
      n -= 17 + total;
    }
    return kOk;
  }

  int Sof(const uint8_t* s, int n) {
    if (n < 6) return kTruncated;
    if (s[0] != 8) return kUnsupported;
    height = (s[1] << 8) | s[2];
    width = (s[3] << 8) | s[4];
    ncomp = s[5];
    if (ncomp < 1 || ncomp > 4) return kUnsupported;
    if (width <= 0 || height <= 0) return kBadDimensions;
    if (n < 6 + 3 * ncomp) return kTruncated;
    for (int c = 0; c < ncomp; ++c) {
      Component& C = comp[c];
      C.id = s[6 + 3 * c];
      C.h = s[7 + 3 * c] >> 4;
      C.v = s[7 + 3 * c] & 15;
      C.tq = s[8 + 3 * c];
      if (C.tq > 3) return kBadMarker;
      if (C.h < 1 || C.h > 4 || C.v < 1 || C.v > 4) return kUnsupported;
      hmax = C.h > hmax ? C.h : hmax;
      vmax = C.v > vmax ? C.v : vmax;
    }
    const int mcux = McusX(), mcuy = McusY();
    for (int c = 0; c < ncomp; ++c) {
      Component& C = comp[c];
      C.width = (width * C.h + hmax - 1) / hmax;
      C.height = (height * C.v + vmax - 1) / vmax;
      C.blocks_w = mcux * C.h;
      C.blocks_h = mcuy * C.v;
    }
    have_frame = true;
    return kOk;
  }

  // MCUs a row and a column: of 8x8 blocks, or of samples (lossless)
  int Unit() const { return coding == kLossless ? 1 : 8; }
  int McusX() const { return (width + Unit() * hmax - 1) / (Unit() * hmax); }
  int McusY() const { return (height + Unit() * vmax - 1) / (Unit() * vmax); }

  int Sos(const uint8_t* s, int n) {
    if (!have_frame) return kBadMarker;
    if (n < 1) return kTruncated;
    const int ns = s[0];
    if (ns < 1 || ns > 4) return kBadMarker;
    if (n < 1 + 2 * ns + 3) return kTruncated;
    sos.ns = ns;
    for (int i = 0; i < ns; ++i) {
      const int cid = s[1 + 2 * i], tabs = s[2 + 2 * i];
      // an arithmetic scan may name any of its 16 conditioning tables
      if (coding != kArithDct && ((tabs >> 4) > 3 || (tabs & 15) > 3))
        return kBadMarker;
      int found = -1;
      for (int c = 0; c < ncomp; ++c)
        if (comp[c].id == cid) found = c;
      if (found < 0) return kBadMarker;
      comp[found].td = tabs >> 4;
      comp[found].ta = tabs & 15;
      sos.ci[i] = found;
    }
    if (ns > 1) {  // libjpeg's D_MAX_BLOCKS_IN_MCU
      int blocks = 0;
      for (int i = 0; i < ns; ++i)
        blocks += comp[sos.ci[i]].h * comp[sos.ci[i]].v;
      if (blocks > 10) return kMcuTooLarge;
    }
    const uint8_t* sp = s + 1 + 2 * ns;
    sos.Ss = sp[0];
    sos.Se = sp[1];
    sos.Ah = sp[2] >> 4;
    sos.Al = sp[2] & 15;
    if (coding == kLossless)  // Ss the predictor, Al the point transform
      return sos.Ss < 1 || sos.Ss > 7 || sos.Se != 0 || sos.Ah != 0 ||
                     sos.Al >= 8
                 ? kBadMarker
                 : kOk;
    if (!progressive) {
      // jdhuff.c and jdarith.c only warn of another band in a sequential
      // scan (JWRN_NOT_SEQUENTIAL) and decode the whole block
      sos.Ss = 0;
      sos.Se = 63;
      sos.Ah = sos.Al = 0;
      return kOk;
    }
    // T.81 G.1.1.1.1: a DC scan is 0..0, an AC scan one component's
    // 1 <= Ss <= Se <= 63; refinement one bit at a time
    if (sos.Se > 63 || sos.Ss > sos.Se || (sos.Ss == 0) != (sos.Se == 0) ||
        (sos.Ss > 0 && ns != 1) || sos.Al > 13 ||
        (sos.Ah != 0 && sos.Ah != sos.Al + 1))
      return kBadMarker;
    return kOk;
  }

  // The interleaved scan into coeffs[c] ([by][bx][64], natural order).
  int Decode(int16_t** coeffs) {
    Bits br;
    br.p = scan;
    br.end = data + len;
    const int mcux = McusX(), mcuy = McusY();
    for (int c = 0; c < ncomp; ++c) {
      if (!dc[comp[c].td].present || !ac[comp[c].ta].present)
        return kBadHuffman;
      comp[c].pred = 0;
    }
    int count = 0;
    for (int my = 0; my < mcuy; ++my) {
      for (int mx = 0; mx < mcux; ++mx) {
        if (restart_interval && count == restart_interval) {
          const int rc = Restart(br);
          if (rc != kOk) return rc;
          for (int c = 0; c < ncomp; ++c) comp[c].pred = 0;
          count = 0;
        }
        for (int c = 0; c < ncomp; ++c) {
          Component& C = comp[c];
          for (int v = 0; v < C.v; ++v) {
            for (int h = 0; h < C.h; ++h) {
              int16_t* blk =
                  coeffs[c] + (static_cast<size_t>(my * C.v + v) * C.blocks_w +
                               mx * C.h + h) * 64;
              const int rc = DecodeBlock(br, C, blk);
              if (rc != kOk) return br.Overrun() ? kTruncated : rc;
            }
          }
        }
        ++count;
      }
    }
    return br.Overrun() ? kTruncated : kOk;
  }

  int DecodeBlock(Bits& br, Component& C, int16_t* blk) {
    const int t = DecodeSymbol(br, dc[C.td]);
    if (t < 0 || t > 11) return kBadHuffman;
    C.pred += Extend(br.Get(t), t);
    blk[0] = static_cast<int16_t>(C.pred);
    const Huffman& act = ac[C.ta];
    for (int k = 1; k < 64;) {
      const int rs = DecodeSymbol(br, act);
      if (rs < 0) return kBadHuffman;
      const int r = rs >> 4, s = rs & 15;
      if (s == 0) {
        if (r != 15) break;  // EOB
        k += 16;             // ZRL
        continue;
      }
      k += r;
      if (k > 63 || s > 10) return kBadHuffman;
      blk[kZigzag[k]] = static_cast<int16_t>(Extend(br.Get(s), s));
      ++k;
    }
    return kOk;
  }

  // At the end of a restart interval: its bytes are all read (the rest of
  // the buffer is padding), and its RSTn marker comes next.
  static int Restart(Bits& br) {
    if (br.Overrun()) return kTruncated;
    const uint8_t* q = br.p;
    if (!(q + 1 < br.end && q[0] == 0xFF && q[1] >= 0xD0 && q[1] <= 0xD7))
      return br.p >= br.end ? kTruncated : kBadHuffman;
    br.p = q + 2;
    br.buf = 0;
    br.cnt = 0;
    br.marker = false;
    return kOk;
  }

  // -- several scans: progressive (SOF2), or baseline not interleaved ----

  // Every scan from the first SOS to the EOI into coeffs[c] (a
  // progressive frame's in zigzag order while the scans accumulate, put in
  // natural order at the end).
  int DecodeScans(int16_t** coeffs) {
    const uint8_t* end = data + len;
    while (true) {
      const uint8_t* p;
      if (coding == kArithDct) {
        Qm qm;
        qm.p = scan;
        qm.end = end;
        if (block) {
          // Pillow's feed: libjpeg holds whole blocks from the file's
          // start, up to past this scan's header (its marker reader
          // suspends for more); the QM decoder cannot suspend, so it may
          // not need a byte past them (JERR_CANT_SUSPEND)
          const size_t sos_end = static_cast<size_t>(scan - data);
          const size_t need = (sos_end + block - 1) / block * block;
          if (need > win) win = need;
          if (win < len) qm.end = data + win;
        }
        const int rc = DecodeScanArith(qm, coeffs);
        if (rc != kOk) return block && qm.overrun ? kCantSuspend : rc;
        p = qm.marker ? qm.p - 2 : qm.p;  // the marker the decoder met
      } else {
        Bits br;
        br.p = scan;
        br.end = end;
        const int rc = DecodeScan(br, coeffs);
        if (rc != kOk || br.Overrun()) return br.Overrun() ? kTruncated : rc;
        p = br.p;
      }
      ++scans;
      // the next marker after the entropy-coded data (RSTn lie inside it)
      while (p + 1 < end && !(p[0] == 0xFF && p[1] != 0x00 &&
                              !(p[1] >= 0xD0 && p[1] <= 0xD7)))
        ++p;
      at = p;
      const int next = Next();
      if (next == kEoi) break;
      if (next != kOk) return next;
    }
    if (!progressive) return kOk;
    int16_t tmp[64];
    for (int c = 0; c < ncomp; ++c) {
      const size_t nblk =
          static_cast<size_t>(comp[c].blocks_w) * comp[c].blocks_h;
      for (size_t b = 0; b < nblk; ++b) {
        int16_t* blk = coeffs[c] + b * 64;
        for (int k = 0; k < 64; ++k) tmp[kZigzag[k]] = blk[k];
        std::memcpy(blk, tmp, sizeof(tmp));
      }
    }
    return kOk;
  }

  // One scan (T.81 G.2, A.2): interleaved over MCUs, or one component's
  // blocks in its own geometry (every progressive AC scan). A baseline
  // scan's blocks are whole (DecodeBlock), a progressive one's a band or a
  // bit of one (DecodeBlockP).
  int DecodeScan(Bits& br, int16_t** coeffs) {
    const Scan& si = sos;
    for (int i = 0; i < si.ns; ++i) {
      const Component& C = comp[si.ci[i]];
      if (si.Ss == 0 ? si.Ah == 0 && !dc[C.td].present : !ac[C.ta].present)
        return kBadHuffman;
      if (!progressive && !ac[C.ta].present) return kBadHuffman;
      comp[si.ci[i]].pred = 0;
    }
    int eobrun = 0, count = 0;
    if (si.ns == 1) {
      const int c = si.ci[0];
      Component& C = comp[c];
      const int bw = (C.width + 7) / 8;
      const int total = bw * ((C.height + 7) / 8);
      const bool ac_first = si.Ss != 0 && si.Ah == 0;
      for (int i = 0; i < total;) {
        if (restart_interval && count == restart_interval) {
          eobrun = 0;  // a restart ends an EOB run (process_restart)
          const int rc = Restart(br);
          if (rc != kOk) return rc;
          count = 0;
          C.pred = 0;
        }
        if (ac_first && eobrun > 0) {
          // blocks inside an EOB run of a first AC scan stay as they are:
          // skip the run whole, up to the scan's end or the interval's
          int n = eobrun < total - i ? eobrun : total - i;
          if (restart_interval && n > restart_interval - count)
            n = restart_interval - count;
          eobrun -= n;
          count += n;
          i += n;
          continue;
        }
        int16_t* blk = coeffs[c] +
            (static_cast<size_t>(i / bw) * C.blocks_w + i % bw) * 64;
        const int rc = progressive ? DecodeBlockP(br, si, C, blk, eobrun)
                                     : DecodeBlock(br, C, blk);
        if (rc != kOk) return rc;
        ++count;
        ++i;
      }
      return kOk;  // a run past the scan's last block ends with the scan
    }
    const int mcux = McusX(), mcuy = McusY();
    for (int my = 0; my < mcuy; ++my) {
      for (int mx = 0; mx < mcux; ++mx) {
        if (restart_interval && count == restart_interval) {
          const int rc = Restart(br);
          if (rc != kOk) return rc;
          count = 0;
          for (int i = 0; i < si.ns; ++i) comp[si.ci[i]].pred = 0;
        }
        for (int i = 0; i < si.ns; ++i) {
          const int c = si.ci[i];
          Component& C = comp[c];
          for (int v = 0; v < C.v; ++v) {
            for (int h = 0; h < C.h; ++h) {
              int16_t* blk = coeffs[c] +
                  (static_cast<size_t>(my * C.v + v) * C.blocks_w +
                   mx * C.h + h) * 64;
              const int rc = progressive ? DecodeBlockP(br, si, C, blk, eobrun)
                                     : DecodeBlock(br, C, blk);
              if (rc != kOk) return rc;
            }
          }
        }
        ++count;
      }
    }
    return kOk;
  }

  // One block of one scan, in zigzag order: DC first / refinement, AC
  // first (with EOB runs) / refinement (libjpeg's decode_mcu_AC_refine).
  int DecodeBlockP(Bits& br, const Scan& si, Component& C, int16_t* blk,
                   int& eobrun) {
    if (si.Ss == 0) {
      if (si.Ah == 0) {
        const int t = DecodeSymbol(br, dc[C.td]);
        if (t < 0 || t > 11) return kBadHuffman;
        C.pred += Extend(br.Get(t), t);
        blk[0] = static_cast<int16_t>(C.pred * (1 << si.Al));
      } else {  // one more bit of the DC
        br.Fill();
        if (br.Get(1)) blk[0] = static_cast<int16_t>(blk[0] | (1 << si.Al));
      }
      return kOk;
    }
    const Huffman& act = ac[C.ta];
    if (si.Ah == 0) {
      if (eobrun > 0) {
        --eobrun;
        return kOk;
      }
      for (int k = si.Ss; k <= si.Se;) {
        const int rs = DecodeSymbol(br, act);
        if (rs < 0) return kBadHuffman;
        const int r = rs >> 4, s = rs & 15;
        if (s == 0) {
          if (r == 15) {  // ZRL
            k += 16;
            continue;
          }
          eobrun = (1 << r) - 1;  // this block ends the run's first
          if (r) eobrun += br.Get(r);
          break;
        }
        k += r;
        if (k > si.Se) return kBadHuffman;
        blk[k] = static_cast<int16_t>(Extend(br.Get(s), s) * (1 << si.Al));
        ++k;
      }
      return kOk;
    }
    // refinement: one bit more of each coefficient already nonzero, and
    // new coefficients of +-1 << Al among the zero ones
    const int p1 = 1 << si.Al, m1 = -p1;
    auto correct = [&](int16_t* cp) {
      br.Fill();
      if (br.Get(1) && (*cp & p1) == 0)
        *cp = static_cast<int16_t>(*cp + (*cp >= 0 ? p1 : m1));
    };
    int k = si.Ss;
    if (eobrun == 0) {
      while (k <= si.Se) {
        const int rs = DecodeSymbol(br, act);
        if (rs < 0) return kBadHuffman;
        int r = rs >> 4;
        const int s = rs & 15;
        int newval = 0;
        if (s == 0) {
          if (r != 15) {  // EOBr: the rest of this block is in the run
            eobrun = 1 << r;
            if (r) eobrun += br.Get(r);
            break;
          }  // else ZRL: pass 16 zero coefficients
        } else {
          if (s != 1) return kBadHuffman;
          newval = br.Get(1) ? p1 : m1;
        }
        while (k <= si.Se) {
          int16_t* cp = blk + k;
          if (*cp != 0) {
            correct(cp);
          } else {
            if (r == 0) {
              if (newval) *cp = static_cast<int16_t>(newval);
              ++k;
              break;
            }
            --r;
          }
          ++k;
        }
      }
    }
    if (eobrun > 0) {  // inside an EOB run: correction bits only
      for (; k <= si.Se; ++k)
        if (blk[k] != 0) correct(blk + k);
      --eobrun;
    }
    return kOk;
  }

  // -- arithmetic coding (T.81 Annex D, F.1.4, G.1.3; jdarith.c) ---------

  uint8_t dc_stats[16][64];
  uint8_t ac_stats[16][256];

  // One scan in arithmetic coding, its blocks in DecodeScan's geometry:
  // a whole block a time (sequential, decode_mcu) or a band or a bit of
  // one (progressive, in zigzag order). The statistics, the DC
  // predictions and the registers start afresh with the scan and with
  // each restart interval; a failed interval (qm.ct == -1) decodes no
  // further block until the next restart, as libjpeg's does.
  int DecodeScanArith(Qm& qm, int16_t** coeffs) {
    const Scan& si = sos;
    int last[4], ctx[4];
    uint8_t fixed = kFixedState;
    auto fresh = [&]() {
      std::memset(dc_stats, 0, sizeof(dc_stats));
      std::memset(ac_stats, 0, sizeof(ac_stats));
      for (int i = 0; i < 4; ++i) last[i] = ctx[i] = 0;
    };
    fresh();
    int count = 0, rst = 0;
    auto restart = [&]() {
      if (!qm.Restart(rst)) return false;
      rst = (rst + 1) & 7;
      count = 0;
      fresh();
      return true;
    };
    auto block = [&](int i, int16_t* blk) {
      const Component& C = comp[si.ci[i]];
      if (!progressive) {
        if (ArithDc(qm, C.td, last[i], ctx[i])) {
          blk[0] = static_cast<int16_t>(last[i]);
          ArithAc(qm, C.ta, 1, 63, 0, blk, fixed, false);
        }
      } else if (si.Ss == 0 && si.Ah == 0) {
        if (ArithDc(qm, C.td, last[i], ctx[i]))
          blk[0] = static_cast<int16_t>(static_cast<uint32_t>(last[i])
                                        << si.Al);
      } else if (si.Ss == 0) {
        if (qm.Decode(&fixed)) blk[0] = static_cast<int16_t>(blk[0] |
                                                            (1 << si.Al));
      } else if (si.Ah == 0) {
        ArithAc(qm, C.ta, si.Ss, si.Se, si.Al, blk, fixed, true);
      } else {
        ArithAcRefine(qm, C.ta, si.Ss, si.Se, si.Al, blk, fixed);
      }
    };
    if (si.ns == 1) {
      const int c = si.ci[0];
      const Component& C = comp[c];
      const int bw = (C.width + 7) / 8;
      const int total = bw * ((C.height + 7) / 8);
      for (int i = 0; i < total; ++i) {
        if (restart_interval && count == restart_interval && !restart())
          return kTruncated;
        if (qm.ct != -1)
          block(0, coeffs[c] +
                       (static_cast<size_t>(i / bw) * C.blocks_w + i % bw) *
                           64);
        if (qm.overrun) return kTruncated;
        ++count;
      }
      return kOk;
    }
    const int mcux = McusX(), mcuy = McusY();
    for (int my = 0; my < mcuy; ++my) {
      for (int mx = 0; mx < mcux; ++mx) {
        if (restart_interval && count == restart_interval && !restart())
          return kTruncated;
        for (int i = 0; i < si.ns && qm.ct != -1; ++i) {
          const int c = si.ci[i];
          const Component& C = comp[c];
          for (int v = 0; v < C.v && qm.ct != -1; ++v)
            for (int h = 0; h < C.h && qm.ct != -1; ++h)
              block(i, coeffs[c] +
                           (static_cast<size_t>(my * C.v + v) * C.blocks_w +
                            mx * C.h + h) * 64);
        }
        if (qm.overrun) return kTruncated;
        ++count;
      }
    }
    return kOk;
  }

  // A DC difference (F.2.4.1) into last (mod 2^16) and the component's
  // conditioning category ctx; false where its magnitude overflows (the
  // interval fails: JWRN_ARITH_BAD_CODE).
  bool ArithDc(Qm& qm, int tbl, int& last, int& ctx) {
    uint8_t* st = dc_stats[tbl] + ctx;
    if (qm.Decode(st) == 0) {
      ctx = 0;
      return true;
    }
    const int sign = qm.Decode(st + 1);
    st += 2 + sign;
    int m = qm.Decode(st);
    if (m != 0) {
      st = dc_stats[tbl] + 20;
      while (qm.Decode(st)) {
        if ((m <<= 1) == 0x8000) {
          qm.ct = -1;
          return false;
        }
        st += 1;
      }
    }
    if (m < ((1 << arith_l[tbl]) >> 1))
      ctx = 0;
    else if (m > ((1 << arith_u[tbl]) >> 1))
      ctx = 12 + sign * 4;
    else
      ctx = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (qm.Decode(st)) v |= m;
    v += 1;
    if (sign) v = -v;
    last = (last + v) & 0xFFFF;
    return true;
  }

  // The AC band Ss..Se of a block (F.2.4.2, G.1.3.2): values shifted up
  // by Al, at blk[k] (zigzag) or blk[kZigzag[k]] (natural order). A run
  // or a magnitude past its end fails the interval.
  void ArithAc(Qm& qm, int tbl, int ss, int se, int al, int16_t* blk,
               uint8_t& fixed, bool zigzag) {
    int k = ss - 1;
    do {
      uint8_t* st = ac_stats[tbl] + 3 * k;
      if (qm.Decode(st)) break;  // the end of the block
      for (;;) {
        ++k;
        if (qm.Decode(st + 1)) break;
        st += 3;
        if (k >= se) {
          qm.ct = -1;
          return;
        }
      }
      const int sign = qm.Decode(&fixed);
      st += 2;
      int m = qm.Decode(st);
      if (m != 0 && qm.Decode(st)) {
        m <<= 1;
        st = ac_stats[tbl] + (k <= arith_k[tbl] ? 189 : 217);
        while (qm.Decode(st)) {
          if ((m <<= 1) == 0x8000) {
            qm.ct = -1;
            return;
          }
          st += 1;
        }
      }
      int v = m;
      st += 14;
      while (m >>= 1)
        if (qm.Decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      blk[zigzag ? k : kZigzag[k]] =
          static_cast<int16_t>(static_cast<uint32_t>(v) << al);
    } while (k < se);
  }

  // A refinement of the band Ss..Se (G.1.3.3, zigzag order): a bit more
  // of each value already nonzero, new values of +-1 << Al, the end of the
  // block decided only past the last value nonzero before this scan.
  void ArithAcRefine(Qm& qm, int tbl, int ss, int se, int al, int16_t* blk,
                     uint8_t& fixed) {
    const int p1 = 1 << al, m1 = -p1;
    int kex = se;
    while (kex > 0 && blk[kex] == 0) --kex;
    for (int k = ss; k <= se; ++k) {
      uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
      if (k > kex && qm.Decode(st)) break;  // the end of the block
      for (;;) {
        int16_t* coef = blk + k;
        if (*coef) {  // nonzero before: its next bit
          if (qm.Decode(st + 2))
            *coef = static_cast<int16_t>(*coef + (*coef < 0 ? m1 : p1));
          break;
        }
        if (qm.Decode(st + 1)) {  // newly nonzero
          *coef = static_cast<int16_t>(qm.Decode(&fixed) ? m1 : p1);
          break;
        }
        st += 3;
        if (k >= se) {
          qm.ct = -1;
          return;
        }
        ++k;
      }
    }
  }

  // -- lossless (T.81 Annex H; libjpeg-turbo's jdlhuff.c, jdpred.c) -----

  // Every scan of a lossless frame into out[c] (comp_height x comp_width
  // u8 samples each, zeroed by the caller; a component no scan codes stays
  // zero): the differences an MCU row at a time, then each of its rows
  // undone against the row above (Table H.1) and shifted up by Pt.
  int DecodeLossless(uint8_t** out) {
    const uint8_t* end = data + len;
    while (true) {
      Bits br;
      br.p = scan;
      br.end = end;
      const int rc = LosslessScan(br, out);
      if (rc != kOk || br.Overrun()) return br.Overrun() ? kTruncated : rc;
      ++scans;
      const uint8_t* p = br.p;
      while (p + 1 < end && !(p[0] == 0xFF && p[1] != 0x00 &&
                              !(p[1] >= 0xD0 && p[1] <= 0xD7)))
        ++p;
      at = p;
      const int next = Next();
      if (next == kEoi) return kOk;
      if (next != kOk) return next;
    }
  }

  int LosslessScan(Bits& br, uint8_t** out) {
    const Scan& si = sos;
    const bool one = si.ns == 1;
    // MCUs a row and MCU rows: one sample a MCU in a component's own scan
    const int per_row = one ? comp[si.ci[0]].width : McusX();
    const int mcu_rows = one ? comp[si.ci[0]].height : McusY();
    if (restart_interval && restart_interval % per_row)
      return kBadHuffman;  // libjpeg takes whole MCU rows only
    const int rows_a_interval =
        restart_interval ? restart_interval / per_row : mcu_rows;
    std::vector<int32_t> diff[4], prev[4], cur[4];
    int gw[4], gv[4], gh[4];
    for (int i = 0; i < si.ns; ++i) {
      const Component& C = comp[si.ci[i]];
      if (!dc[C.td].present) return kBadHuffman;
      gh[i] = one ? 1 : C.h;
      gv[i] = one ? 1 : C.v;
      gw[i] = per_row * gh[i];
      diff[i].assign(static_cast<size_t>(gw[i]) * gv[i], 0);
      prev[i].assign(gw[i], 0);
      cur[i].assign(gw[i], 0);
    }
    const int pt = si.Al, psv = si.Ss;
    for (int my = 0; my < mcu_rows; ++my) {
      const bool first = my % rows_a_interval == 0;
      if (first && my > 0) {
        const int rc = Restart(br);
        if (rc != kOk) return rc;
      }
      for (int mx = 0; mx < per_row; ++mx) {
        for (int i = 0; i < si.ns; ++i) {
          const Huffman& tab = dc[comp[si.ci[i]].td];
          for (int v = 0; v < gv[i]; ++v) {
            for (int h = 0; h < gh[i]; ++h) {
              const int s = DecodeSymbol(br, tab);
              if (s < 0 || s > 16) return kBadHuffman;
              int d = 0;
              if (s == 16)
                d = 32768;
              else if (s)
                d = Extend(br.Get(s), s);
              diff[i][static_cast<size_t>(v) * gw[i] + mx * gh[i] + h] = d;
            }
          }
        }
        if (br.Overrun()) return kTruncated;
      }
      for (int i = 0; i < si.ns; ++i) {
        const Component& C = comp[si.ci[i]];
        for (int v = 0; v < gv[i]; ++v) {
          const int32_t* d = diff[i].data() + static_cast<size_t>(v) * gw[i];
          int32_t* x = cur[i].data();
          const int32_t* up = prev[i].data();
          if (first && v == 0) {  // the first row of the scan or interval
            x[0] = (d[0] + (1 << (8 - pt - 1))) & 0xFFFF;
            for (int k = 1; k < gw[i]; ++k) x[k] = (d[k] + x[k - 1]) & 0xFFFF;
          } else {
            x[0] = (d[0] + up[0]) & 0xFFFF;
            for (int k = 1; k < gw[i]; ++k) {
              const int ra = x[k - 1], rb = up[k], rc = up[k - 1];
              int pred;
              switch (psv) {
                case 1: pred = ra; break;
                case 2: pred = rb; break;
                case 3: pred = rc; break;
                case 4: pred = ra + rb - rc; break;
                case 5: pred = ra + ((rb - rc) >> 1); break;
                case 6: pred = rb + ((ra - rc) >> 1); break;
                default: pred = (ra + rb) >> 1; break;
              }
              x[k] = (d[k] + pred) & 0xFFFF;
            }
          }
          const int y = my * gv[i] + v;
          if (y < C.height) {
            uint8_t* o = out[si.ci[i]] + static_cast<size_t>(y) * C.width;
            for (int k = 0; k < C.width; ++k)
              o[k] = static_cast<uint8_t>(x[k] << pt);
          }
          std::swap(prev[i], cur[i]);
        }
      }
    }
    return kOk;
  }
};

// -- libjpeg's Huffman decoder, to the byte (jdhuff.c, jdphuff.c) ------------
//
// Frame decodes a file at once and refuses a scan that runs out. Where the
// port must answer what libjpeg answers for such data, Lj follows
// libjpeg-turbo's bit reader to the byte instead: a fill loads at least 57
// bits (MIN_GET_BITS) or stops at a marker, after which zero bits are fed
// and the MCUs that follow stay zero (insufficient_data) until a restart;
// decode_mcu_fast prefetches six bytes at a time where 512 bytes a block
// of the MCU are in the buffer; the state is saved after each MCU and an
// MCU that runs out of bytes is decoded again from its start once more are
// fed; a bad code is the symbol 0; an EOB run ends with its scan and at a
// restart. It is fed in one of two ways:
//
// - as Pillow's ImageFile.load feeds libjpeg: `block` bytes more at each
//   call (decodermaxblock), the decoder suspending where they run out. A
//   frame of one scan is read whole once its last MCU is decoded (Pillow
//   ignores a missing EOI then); a frame of several scans once its EOI is
//   read. Where the data runs out first, Pillow reports the bytes its last
//   call left unconsumed ("image file is truncated (n bytes not
//   processed)"): `unread`.
// - as libtiff feeds a JPEG segment: the bytes whole, then an EOI (block 0;
//   the caller appends it), so a segment that ends early is decoded as
//   libjpeg decodes it, its MCU in flight from zero bits and the rest zero.
struct Lj {
  Frame& f;
  const uint8_t* data;
  size_t len, block, win;
  int16_t** coeffs;
  // the source and bitread_perm_state
  size_t pos = 0;
  uint64_t buf = 0;
  int bits = 0;
  int marker = 0;  // unread_marker
  bool insufficient = false;
  // the scan
  int ncomp = 0, ci[4] = {0, 0, 0, 0}, blocks_in_mcu = 0;
  int pred[4] = {0, 0, 0, 0};
  int togo = 0, next_rst = 0;
  unsigned eobrun = 0;
  static constexpr int kSusp = -100;

  Lj(Frame& fr, size_t blk, int16_t** out)
      : f(fr), data(fr.data), len(fr.len), block(blk),
        win(blk && blk < fr.len ? blk : fr.len), coeffs(out) {}

  uint32_t GetBits(int n) {
    bits -= n;
    return static_cast<uint32_t>(buf >> bits) & ((1u << n) - 1);
  }

  // jpeg_fill_bit_buffer: false to suspend
  bool Fill(int nbits) {
    if (!marker) {
      while (bits < 57) {
        if (pos >= win) return false;
        int c = data[pos++];
        if (c == 0xFF) {
          do {
            if (pos >= win) return false;
            c = data[pos++];
          } while (c == 0xFF);
          if (c == 0) {
            c = 0xFF;
          } else {
            marker = c;
            break;
          }
        }
        buf = (buf << 8) | static_cast<uint64_t>(c);
        bits += 8;
      }
      if (!marker) return true;
    }
    if (nbits > bits) {  // JWRN_HIT_MARKER: zero bits
      insufficient = true;
      buf <<= 57 - bits;
      bits = 57;
    }
    return true;
  }

  bool Need(int n) { return bits >= n || Fill(n); }

  // the rest of a code of at least l bits (jpeg_huff_decode)
  int Slow(const Huffman& h, int l) {
    if (!Need(l)) return kSusp;
    int32_t code = static_cast<int32_t>(GetBits(l));
    while (code > h.maxcode[l]) {
      code <<= 1;
      if (!Need(1)) return kSusp;
      code |= static_cast<int32_t>(GetBits(1));
      ++l;
    }
    if (l > 16) return 0;  // JWRN_HUFF_BAD_CODE
    return h.vals[h.valptr[l] + code - h.mincode[l]];
  }

  // a code of at most 8 bits in the next 8 (the lookahead table), else -1
  static int Look(const Huffman& h, int look, int* nb) {
    for (int l = 1; l <= 8; ++l) {
      const int code = look >> (8 - l);
      if (code <= h.maxcode[l]) {
        *nb = l;
        return h.vals[h.valptr[l] + code - h.mincode[l]];
      }
    }
    return -1;
  }

  int Sym(const Huffman& h) {  // HUFF_DECODE
    if (bits < 8) {
      if (!Fill(0)) return kSusp;
      if (bits < 8) return Slow(h, 1);
    }
    int nb;
    const int s = Look(h, static_cast<int>(buf >> (bits - 8)) & 0xFF, &nb);
    if (s < 0) return Slow(h, 9);
    bits -= nb;
    return s;
  }

  // decode_mcu_fast's input: GET_BYTE six times while 16 bits or fewer
  void FastFill() {
    if (bits > 16) return;
    for (int i = 0; i < 6; ++i) {
      const int c0 = data[pos++];
      const int c1 = pos < len ? data[pos] : 0;
      buf = (buf << 8) | static_cast<uint64_t>(c0);
      bits += 8;
      if (c0 == 0xFF) {
        ++pos;
        if (c1 != 0) {
          marker = c1;
          pos -= 2;
          buf &= ~uint64_t{0xFF};
        }
      }
    }
  }

  int FastSym(const Huffman& h) {  // HUFF_DECODE_FAST
    FastFill();
    int nb;
    const int s = Look(h, static_cast<int>(buf >> (bits - 8)) & 0xFF, &nb);
    if (s >= 0) {
      bits -= nb;
      return s;
    }
    nb = 9;
    bits -= nb;
    int32_t code = static_cast<int32_t>(buf >> bits) & 0x1FF;
    while (code > h.maxcode[nb]) {
      code <<= 1;
      code |= static_cast<int32_t>(GetBits(1));
      ++nb;
    }
    return nb > 16 ? 0 : h.vals[h.valptr[nb] + code - h.mincode[nb]];
  }

  int16_t* Block(int c, size_t row, size_t col) {
    return coeffs[c] + (row * f.comp[c].blocks_w + col) * 64;
  }
  static int Natural(int k) { return k > 63 ? 63 : kZigzag[k]; }

  // -- sequential (jdhuff.c) --

  // decode_mcu_slow / decode_mcu_fast over the MCU's blocks; false where the
  // slow one suspends or the fast one meets a marker
  template <bool kFast>
  bool McuSeq(int16_t** blks, const int* comp_of) {
    for (int b = 0; b < blocks_in_mcu; ++b) {
      const int i = comp_of[b];
      const Component& C = f.comp[ci[i]];
      const Huffman& dct = f.dc[C.td];
      const Huffman& act = f.ac[C.ta];
      int s = kFast ? FastSym(dct) : Sym(dct);
      if (s == kSusp) return false;
      if (s) {
        if (kFast) FastFill(); else if (!Need(s)) return false;
        s = Extend(GetBits(s), s);
      }
      pred[i] += s;
      int16_t* blk = blks[b];
      blk[0] = static_cast<int16_t>(pred[i]);
      for (int k = 1; k < 64; ++k) {
        s = kFast ? FastSym(act) : Sym(act);
        if (s == kSusp) return false;
        int r = s >> 4;
        s &= 15;
        if (s) {
          k += r;
          if (kFast) FastFill(); else if (!Need(s)) return false;
          blk[Natural(k)] = static_cast<int16_t>(Extend(GetBits(s), s));
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
    }
    if (kFast && marker) {
      marker = 0;
      return false;
    }
    return true;
  }

  // next_marker: the marker after `pos`, pos past it; false to suspend
  bool NextMarker() {
    for (;;) {
      if (pos >= win) return false;
      int c = data[pos++];
      while (c != 0xFF) {
        if (pos >= win) return false;
        c = data[pos++];
      }
      do {
        if (pos >= win) return false;
        c = data[pos++];
      } while (c == 0xFF);
      if (c != 0) {
        marker = c;
        return true;
      }
    }
  }

  // process_restart with read_restart_marker and jpeg_resync_to_restart;
  // false to suspend
  bool Restart() {
    bits = 0;
    if (!marker && !NextMarker()) return false;
    for (;;) {
      int action = 1;
      if (marker == 0xD0 + next_rst) {
        action = 1;
      } else if (marker < 0xC0) {
        action = 2;
      } else if (marker < 0xD0 || marker > 0xD7) {
        action = 3;
      } else if (marker == 0xD0 + ((next_rst + 1) & 7) ||
                 marker == 0xD0 + ((next_rst + 2) & 7)) {
        action = 3;
      } else if (marker == 0xD0 + ((next_rst - 1) & 7) ||
                 marker == 0xD0 + ((next_rst - 2) & 7)) {
        action = 2;
      }
      if (action == 1) marker = 0;
      if (action != 2) break;
      marker = 0;
      if (!NextMarker()) return false;
    }
    next_rst = (next_rst + 1) & 7;
    for (int& p : pred) p = 0;
    eobrun = 0;
    togo = f.restart_interval;
    if (!marker) insufficient = false;
    return true;
  }

  // -- progressive (jdphuff.c), one MCU; false to suspend --

  bool McuProg(int16_t** blks, const int* comp_of) {
    const Scan& si = f.sos;
    if (si.Ss == 0 && si.Ah == 0) {  // decode_mcu_DC_first
      if (insufficient) return true;
      for (int b = 0; b < blocks_in_mcu; ++b) {
        const int i = comp_of[b];
        int s = Sym(f.dc[f.comp[ci[i]].td]);
        if (s == kSusp) return false;
        if (s) {
          if (!Need(s)) return false;
          s = Extend(GetBits(s), s);
        }
        pred[i] += s;
        blks[b][0] = static_cast<int16_t>(
            static_cast<uint32_t>(pred[i]) << si.Al);
      }
      return true;
    }
    if (si.Ss == 0) {  // decode_mcu_DC_refine (no insufficient check)
      for (int b = 0; b < blocks_in_mcu; ++b) {
        if (!Need(1)) return false;
        if (GetBits(1)) blks[b][0] = static_cast<int16_t>(blks[b][0] |
                                                          (1 << si.Al));
      }
      return true;
    }
    if (insufficient) return true;
    const Huffman& act = f.ac[f.comp[ci[0]].ta];
    int16_t* blk = blks[0];
    if (si.Ah == 0) {  // decode_mcu_AC_first
      if (eobrun > 0) {
        --eobrun;
        return true;
      }
      for (int k = si.Ss; k <= si.Se; ++k) {
        int s = Sym(act);
        if (s == kSusp) return false;
        int r = s >> 4;
        s &= 15;
        if (s) {
          k += r;
          if (!Need(s)) return false;
          blk[Natural(k)] = static_cast<int16_t>(
              static_cast<uint32_t>(Extend(GetBits(s), s)) << si.Al);
        } else if (r == 15) {
          k += 15;
        } else {
          eobrun = 1u << r;
          if (r) {
            if (!Need(r)) return false;
            eobrun += GetBits(r);
          }
          --eobrun;
          break;
        }
      }
      return true;
    }
    // decode_mcu_AC_refine
    const int p1 = 1 << si.Al, m1 = -p1;
    int k = si.Ss;
    if (eobrun == 0) {
      for (; k <= si.Se; ++k) {
        int s = Sym(act);
        if (s == kSusp) return false;
        int r = s >> 4;
        s &= 15;
        if (s) {  // a size other than 1 is JWRN_HUFF_BAD_CODE, taken as 1
          if (!Need(1)) return false;
          s = GetBits(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1u << r;
          if (r) {
            if (!Need(r)) return false;
            eobrun += GetBits(r);
          }
          break;
        }
        do {
          int16_t* c = blk + Natural(k);
          if (*c != 0) {
            if (!Need(1)) return false;
            if (GetBits(1) && (*c & p1) == 0)
              *c = static_cast<int16_t>(*c + (*c >= 0 ? p1 : m1));
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= si.Se);
        if (s) blk[Natural(k)] = static_cast<int16_t>(s);
      }
    }
    if (eobrun > 0) {
      for (; k <= si.Se; ++k) {
        int16_t* c = blk + Natural(k);
        if (*c != 0) {
          if (!Need(1)) return false;
          if (GetBits(1) && (*c & p1) == 0)
            *c = static_cast<int16_t>(*c + (*c >= 0 ? p1 : m1));
        }
      }
      --eobrun;
    }
    return true;
  }

  // decode_mcu of either kind, after its restart (OneScan); false to
  // suspend
  bool Mcu(int16_t** blks, const int* comp_of) {
    bool fast = !f.progressive && !f.restart_interval;
    if (win - pos < static_cast<size_t>(512) * blocks_in_mcu || marker)
      fast = false;
    bool ok = true;
    if (f.progressive) {
      ok = McuProg(blks, comp_of);
    } else if (!insufficient) {
      const size_t p0 = pos;
      const uint64_t b0 = buf;
      const int n0 = bits;
      int pr[4];
      std::memcpy(pr, pred, sizeof(pr));
      if (!fast || !McuSeq<true>(blks, comp_of)) {
        pos = p0;
        buf = b0;
        bits = n0;
        std::memcpy(pred, pr, sizeof(pr));
        ok = McuSeq<false>(blks, comp_of);
      }
    }
    if (ok && f.restart_interval) --togo;
    return ok;
  }

  // One scan, MCU by MCU, each decoded again from its start with another
  // block fed while it suspends. 0, or 1 where the data runs out.
  int OneScan(int64_t* unread) {
    const ::Scan& si = f.sos;
    ncomp = si.ns;
    int comp_of[10];
    blocks_in_mcu = 0;
    for (int i = 0; i < ncomp; ++i) {
      ci[i] = si.ci[i];
      const Component& C = f.comp[ci[i]];
      const bool dc = si.Ss == 0;
      if (dc ? si.Ah == 0 && !f.dc[C.td].present
             : !f.ac[C.ta].present)
        return kBadHuffman;
      // libjpeg derives a DC first scan's tables with their symbols
      // checked (JERR_BAD_HUFF_TABLE): a category past 15 would shift by
      // more than the bit buffer holds
      if (dc && si.Ah == 0 && !f.dc[C.td].DcSymbolsOk()) return kBadHuffman;
      if (!f.progressive && !f.ac[C.ta].present) return kBadHuffman;
      const int nb = ncomp == 1 ? 1 : C.h * C.v;
      for (int k = 0; k < nb && blocks_in_mcu < 10; ++k)
        comp_of[blocks_in_mcu++] = i;
    }
    bits = 0;
    buf = 0;
    marker = 0;
    insufficient = false;
    eobrun = 0;
    for (int& p : pred) p = 0;
    togo = f.restart_interval;
    next_rst = 0;
    pos = static_cast<size_t>(f.scan - data);
    const Component& C0 = f.comp[ci[0]];
    const size_t bw = (C0.width + 7) / 8, bh = (C0.height + 7) / 8;
    const size_t mcux = ncomp == 1 ? bw : f.McusX();
    const size_t mcus = ncomp == 1 ? bw * bh : mcux * f.McusY();
    int16_t* blks[10];
    int16_t keep[64];
    for (size_t m = 0; m < mcus; ++m) {
      const size_t my = m / mcux, mx = m % mcux;
      if (ncomp == 1) {
        blks[0] = Block(ci[0], my, mx);
      } else {
        int b = 0;
        for (int i = 0; i < ncomp; ++i) {
          const Component& C = f.comp[ci[i]];
          for (int v = 0; v < C.v; ++v)
            for (int h = 0; h < C.h; ++h)
              blks[b++] = Block(ci[i], my * C.v + v, mx * C.h + h);
        }
      }
      const bool refine = f.progressive && si.Ss > 0 && si.Ah > 0;
      if (refine) std::memcpy(keep, blks[0], sizeof(keep));
      for (;;) {
        // a restart read stays read when the MCU after it suspends
        const size_t r0 = pos;
        if (f.restart_interval && togo == 0 && !Restart()) {
          pos = r0;
        } else {
          const size_t p0 = pos;
          const uint64_t b0 = buf;
          const int n0 = bits;
          const unsigned e0 = eobrun;
          int pr[4];
          std::memcpy(pr, pred, sizeof(pr));
          if (Mcu(blks, comp_of)) break;
          pos = p0;
          buf = b0;
          bits = n0;
          eobrun = e0;
          std::memcpy(pred, pr, sizeof(pr));
        }
        if (refine) std::memcpy(blks[0], keep, sizeof(keep));
        if (win >= len) {
          *unread = static_cast<int64_t>(len - pos);
          return 1;
        }
        win = win + block < len ? win + block : len;
      }
    }
    return kOk;
  }

  // Every scan to the end of the frame: 0 where libjpeg reads it whole, 1
  // where the data runs out first (`unread` set), or the frame's error.
  int Run(int64_t* unread) {
    const bool several = f.progressive || f.sos.ns != f.ncomp;
    for (;;) {
      // the marker reader suspends until it has the scan's header whole
      const size_t sos_end = static_cast<size_t>(f.scan - data);
      while (win < sos_end) win = win + block < len ? win + block : len;
      const int rc = OneScan(unread);
      if (rc != kOk) return rc;
      ++f.scans;
      if (!several) return kOk;
      // the next marker: met by the entropy decoder, or read past the
      // scan's last bytes; the data ending first leaves the FF bytes
      // read since the last byte discarded
      if (!marker) {
        size_t sync = pos;
        for (;;) {
          if (pos >= len) {
            *unread = static_cast<int64_t>(len - sync);
            return 1;
          }
          const int c = data[pos++];
          if (c != 0xFF) {
            sync = pos;
            continue;
          }
          while (pos < len && data[pos] == 0xFF) ++pos;
          if (pos >= len) {
            *unread = static_cast<int64_t>(len - sync);
            return 1;
          }
          if (data[pos++] != 0) {
            marker = data[pos - 1];
            break;
          }
          sync = pos;
        }
      }
      f.at = data + pos - 2;
      marker = 0;
      const int next = f.Next();
      if (next == kEoi) return kOk;
      if (next == kTruncated) {
        // a marker segment cut: the marker reader keeps what follows its
        // code; an APPn or COM segment is skipped to the data's end once
        // its length is read
        const size_t m = static_cast<size_t>(f.seg - data);
        const int code = m + 1 < len ? data[m + 1] : 0;
        const bool skipped = (code >= 0xE0 && code <= 0xEF) || code == 0xFE;
        *unread = static_cast<int64_t>(
            m + 2 > len ? len - m
            : skipped && m + 4 <= len ? 0 : len - m - 2);
        return 1;
      }
      if (next != kOk) return next;
    }
  }
};

struct Ik4Info {  // the layout of jpeg_entropy.cpp's IkJpegInfo
  int32_t width, height, ncomp, hmax, vmax;
  int32_t comp_h[4], comp_v[4], comp_width[4], comp_height[4];
  int32_t blocks_w[4], blocks_h[4], comp_tq[4];
  int32_t progressive;
};

// What the port's header adds to IkJpegInfo.
struct Ik4Extra {
  int32_t adobe_transform;  // an Adobe APP14 segment's flag, -1 without
  int32_t coding;           // 0 Huffman DCT, 1 arithmetic DCT, 2 lossless
};

}  // namespace

// Header only, up to the first SOS: the frame, its Adobe transform flag
// and its coding.
IK_EXPORT int ik_jpeg4_parse(const uint8_t* data, size_t len, Ik4Info* info,
                             Ik4Extra* extra) {
  Frame f;
  f.data = data;
  f.len = len;
  const int rc = f.Parse();
  if (rc != kOk) return rc;
  std::memset(info, 0, sizeof(*info));
  info->width = f.width;
  info->height = f.height;
  info->ncomp = f.ncomp;
  info->hmax = f.hmax;
  info->vmax = f.vmax;
  info->progressive = f.progressive;
  for (int c = 0; c < f.ncomp; ++c) {
    info->comp_h[c] = f.comp[c].h;
    info->comp_v[c] = f.comp[c].v;
    info->comp_width[c] = f.comp[c].width;
    info->comp_height[c] = f.comp[c].height;
    info->blocks_w[c] = f.comp[c].blocks_w;
    info->blocks_h[c] = f.comp[c].blocks_h;
    info->comp_tq[c] = f.comp[c].tq;
  }
  extra->adobe_transform = f.adobe_transform;
  extra->coding = f.coding;
  return kOk;
}

// The scans of a DCT frame into coeffs[0..ncomp-1] (zeroed by the caller,
// blocks_h*blocks_w*64 int16 each) and qtabs_out (4 x 64, natural order);
// -3 for a lossless frame. With `block` > 0 the arithmetic scans are fed
// as Pillow feeds libjpeg, `block` bytes at a time (-9 where the QM decoder
// needs a byte it has not been fed).
IK_EXPORT int ik_jpeg4_decode_fed(const uint8_t* data, size_t len,
                                  size_t block, int16_t** coeffs,
                                  uint16_t* qtabs_out) {
  Frame f;
  f.data = data;
  f.len = len;
  f.block = block;
  int rc = f.Parse();
  if (rc != kOk) return rc;
  if (f.coding == kLossless) return kUnsupported;
  // one interleaved Huffman baseline scan, or a sequence of scans to the EOI
  rc = f.coding == kHuffmanDct && !f.progressive && f.sos.ns == f.ncomp
           ? f.Decode(coeffs)
           : f.DecodeScans(coeffs);
  std::memcpy(qtabs_out, f.qtab, sizeof(f.qtab));  // DQT may follow a scan
  return rc;
}

// ik_jpeg4_decode_fed of the data whole.
IK_EXPORT int ik_jpeg4_decode_coeffs(const uint8_t* data, size_t len,
                                     int16_t** coeffs, uint16_t* qtabs_out) {
  return ik_jpeg4_decode_fed(data, len, 0, coeffs, qtabs_out);
}

// A DCT frame decoded as libjpeg decodes it (Lj), into coeffs (zeroed by
// the caller) and qtabs_out. With `block` > 0, a Huffman frame fed as
// Pillow feeds libjpeg: 0 where libjpeg reads it whole, 1 where the data
// runs out first, *unread then the bytes Pillow's last call left
// unconsumed; -3 for another coding. With `block` 0, the data whole and
// then an EOI, as libtiff feeds a JPEG segment: a Huffman frame through
// Lj, an arithmetic one through Frame (which feeds zeros at the EOI).
IK_EXPORT int ik_jpeg4_decode_libjpeg(const uint8_t* data, size_t len,
                                      size_t block, int16_t** coeffs,
                                      uint16_t* qtabs_out, int64_t* unread) {
  *unread = 0;
  std::vector<uint8_t> copy;
  if (!block) {
    copy.assign(data, data + len);
    copy.push_back(0xFF);
    copy.push_back(0xD9);
    data = copy.data();
    len = copy.size();
  }
  Frame f;
  f.data = data;
  f.len = len;
  int rc = f.Parse();
  if (rc != kOk) return rc;
  if (f.coding == kHuffmanDct) {
    Lj lj(f, block, coeffs);
    rc = lj.Run(unread);
  } else if (f.coding == kArithDct && !block) {
    rc = f.DecodeScans(coeffs);
  } else {
    return kUnsupported;
  }
  std::memcpy(qtabs_out, f.qtab, sizeof(f.qtab));
  return rc;
}

// The samples of a lossless frame into planes[0..ncomp-1] (zeroed by the
// caller, comp_height x comp_width u8 each); -3 for a DCT frame.
IK_EXPORT int ik_jpeg4_decode_lossless(const uint8_t* data, size_t len,
                                       uint8_t** planes) {
  Frame f;
  f.data = data;
  f.len = len;
  const int rc = f.Parse();
  if (rc != kOk) return rc;
  if (f.coding != kLossless) return kUnsupported;
  return f.DecodeLossless(planes);
}

// ---------------------------------------------------------------------------
// The guard of the pinned decoder's Huffman tables.
//
// jpeg_entropy.cpp (a byte-equal copy of the reference's decoder) fills the
// 8-bit lookup of each table from its codes without checking that a
// length's codes fit that length: a DHT whose counts oversubscribe a length
// of 8 bits or fewer (a code of l bits at 2^l or more) writes past the
// lookup's 256 entries, and past the decoder's own object. libjpeg refuses
// such a table ("Bogus Huffman table definition"). The port calls this
// guard before each call into the pinned decoder (jpeg_abi.py; the JPEG
// TIFF splices, tiff_ext_decode.cpp). It walks the stream as the pinned
// Parse walks it, and stops where Parse returns: at an error of a DQT, a
// DHT, a frame or a scan header, at a frame Parse refuses (not 8-bit, not
// one or three components, a sampling factor outside 1-4, another SOFn),
// at the first SOS of a sequential frame, and at the EOI; in a progressive
// frame it skips each scan's data to the next marker, as Parse does after
// decoding it. It returns kBadHuffman, the pinned decoder's answer for a
// bad table, where a DHT that Parse would build is oversubscribed at 8 bits
// or fewer; else 0. (A progressive scan whose data the pinned decoder
// refuses before a later bad DHT is refused here with -4 instead of its
// own error: a 400 either way.)

namespace {

bool Oversubscribed(const uint8_t* counts) {  // counts[1..16]
  int code = 0;
  for (int l = 1; l <= 8; ++l) {
    code += counts[l];
    if (code > (1 << l)) return true;
    code <<= 1;
  }
  return false;
}

}  // namespace

IK_EXPORT int ik_jpeg4_huffman_guard(const uint8_t* data, size_t len) {
  const uint8_t* p = data;
  const uint8_t* end = data + len;
  if (len < 4 || p[0] != 0xFF || p[1] != 0xD8) return kOk;
  p += 2;
  bool progressive = false;
  int ncomp = 0;
  uint8_t ids[4] = {0, 0, 0, 0};
  while (p + 2 <= end) {
    if (p[0] != 0xFF) return kOk;
    const uint8_t m = p[1];
    p += 2;
    if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7)) continue;
    if (m == 0xD9 || p + 2 > end) return kOk;
    const int seglen = (p[0] << 8) | p[1];
    if (seglen < 2 || p + seglen > end) return kOk;
    const uint8_t* seg = p + 2;
    int segrem = seglen - 2;
    switch (m) {
      case 0xDB:
        while (segrem > 0) {
          const int pq = seg[0] >> 4, tq = seg[0] & 15, n = pq ? 128 : 64;
          ++seg;
          --segrem;
          if (tq > 3 || segrem < n) return kOk;
          seg += n;
          segrem -= n;
        }
        break;
      case 0xC4:
        while (segrem >= 17) {
          if ((seg[0] & 15) > 3) return kOk;
          int total = 0;
          for (int l = 1; l <= 16; ++l) total += seg[l];
          if (segrem < 17 + total || total > 256) return kOk;
          if (Oversubscribed(seg)) return kBadHuffman;
          seg += 17 + total;
          segrem -= 17 + total;
        }
        break;
      case 0xC2:
        progressive = true;
        [[fallthrough]];
      case 0xC0:
      case 0xC1:
        if (segrem < 6 || seg[0] != 8) return kOk;
        if (((seg[1] << 8) | seg[2]) <= 0 || ((seg[3] << 8) | seg[4]) <= 0)
          return kOk;
        ncomp = seg[5];
        if ((ncomp != 1 && ncomp != 3) || segrem < 6 + 3 * ncomp) return kOk;
        for (int c = 0; c < ncomp; ++c) {
          const int h = seg[7 + 3 * c] >> 4, v = seg[7 + 3 * c] & 15;
          if (seg[8 + 3 * c] > 3 || h < 1 || h > 4 || v < 1 || v > 4)
            return kOk;
          ids[c] = seg[6 + 3 * c];
        }
        break;
      case 0xC3: case 0xC5: case 0xC6: case 0xC7: case 0xC9: case 0xCA:
      case 0xCB: case 0xCD: case 0xCE: case 0xCF:
        return kOk;
      case 0xDD:
        if (segrem < 2) return kOk;
        break;
      case 0xDA: {
        if (segrem < 1) return kOk;
        const int ns = seg[0];
        if (ns < 1 || ns > 4 || segrem < 1 + 2 * ns + 3) return kOk;
        for (int s = 0; s < ns; ++s) {
          const int tabs = seg[2 + 2 * s];
          if ((tabs >> 4) > 3 || (tabs & 15) > 3) return kOk;
          bool found = false;
          for (int c = 0; c < ncomp; ++c) found |= ids[c] == seg[1 + 2 * s];
          if (!found) return kOk;
        }
        const uint8_t* sp = seg + 1 + 2 * ns;
        if (sp[0] > 63 || sp[1] > 63 || sp[0] > sp[1]) return kOk;
        if (!progressive) return kOk;  // Parse stops at a sequential SOS
        p += seglen;
        while (p + 1 < end && !(p[0] == 0xFF && p[1] != 0x00 &&
                                !(p[1] >= 0xD0 && p[1] <= 0xD7)))
          ++p;
        continue;
      }
      default:
        break;
    }
    p += seglen;
  }
  return kOk;
}
