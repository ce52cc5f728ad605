// Four-component (CMYK and YCCK) baseline JPEG entropy decode of the port.
//
// The port's copy of the reference's decoder (jpeg_entropy.cpp, pinned
// byte-equal to it) refuses a frame of four components with -3; the
// reference then decodes such a JPEG with Pillow. This decoder is the
// port's own, for that case only: a baseline or extended-Huffman frame
// (SOF0/SOF1) of 8-bit precision and exactly four components in one
// interleaved scan. Progressive, arithmetic-coded, 12-bit and lossless
// frames, other component counts and non-interleaved scans return -3.
// Its output matches jpeg_entropy.cpp's ik_jpeg_decode_coeffs: quantised
// coefficient planes [by][bx][64] in natural order, MCU-padded, and the
// four 64-entry quant tables; its header is the same IkJpegInfo, plus the
// transform flag of an Adobe APP14 segment (-1 when there is none).
//
// The exported names are ik_jpeg4_*: the loader links every native source
// into one library.

#include <cstddef>
#include <cstdint>
#include <cstring>

#define IK_EXPORT extern "C" __attribute__((visibility("default")))

namespace {

enum {
  kOk = 0,
  kTruncated = -1,
  kBadMarker = -2,
  kUnsupported = -3,
  kBadHuffman = -4,
  kBadDimensions = -5,
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

  int Build(const uint8_t* counts, const uint8_t* symbols, int n) {
    if (n > 256) return kBadHuffman;
    std::memcpy(vals, symbols, n);
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

struct Frame {
  const uint8_t* data;
  size_t len;
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
  int restart_interval = 0;
  int adobe_transform = -1;
  bool have_frame = false;
  uint16_t qtab[4][64] = {};
  Huffman dc[4], ac[4];
  Component comp[4];
  const uint8_t* scan = nullptr;

  // Markers up to the first SOS; scan points at its entropy-coded data.
  int Parse() {
    const uint8_t* p = data;
    const uint8_t* end = data + len;
    if (len < 4 || p[0] != 0xFF || p[1] != 0xD8) return kBadMarker;
    p += 2;
    while (true) {
      if (p + 2 > end) return kTruncated;
      if (p[0] != 0xFF) return kBadMarker;
      const uint8_t m = p[1];
      p += 2;
      if (m == 0xFF) {  // fill byte
        --p;
        continue;
      }
      if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
      if (m == 0xD9) return kTruncated;  // EOI before a scan
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
          rc = Sof(s, n);
          break;
        case 0xC2: case 0xC3: case 0xC5: case 0xC6: case 0xC7: case 0xC9:
        case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
          return kUnsupported;  // progressive, lossless, arithmetic
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
          if (rc == kOk) scan = p + seglen;
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
    if (ncomp != 4) return kUnsupported;
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
    const int mcux = (width + 8 * hmax - 1) / (8 * hmax);
    const int mcuy = (height + 8 * vmax - 1) / (8 * vmax);
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

  int Sos(const uint8_t* s, int n) {
    if (!have_frame) return kBadMarker;
    if (n < 1) return kTruncated;
    const int ns = s[0];
    if (n < 1 + 2 * ns + 3) return kTruncated;
    if (ns != ncomp) return kUnsupported;  // one interleaved scan only
    for (int i = 0; i < ns; ++i) {
      const int cid = s[1 + 2 * i], tabs = s[2 + 2 * i];
      if ((tabs >> 4) > 3 || (tabs & 15) > 3) return kBadMarker;
      int found = -1;
      for (int c = 0; c < ncomp; ++c)
        if (comp[c].id == cid) found = c;
      if (found < 0) return kBadMarker;
      comp[found].td = tabs >> 4;
      comp[found].ta = tabs & 15;
    }
    const uint8_t* sp = s + 1 + 2 * ns;
    if (sp[0] != 0 || sp[1] != 63 || sp[2] != 0) return kUnsupported;
    return kOk;
  }

  // The interleaved scan into coeffs[c] ([by][bx][64], natural order).
  int Decode(int16_t** coeffs) {
    Bits br;
    br.p = scan;
    br.end = data + len;
    const int mcux = (width + 8 * hmax - 1) / (8 * hmax);
    const int mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int c = 0; c < ncomp; ++c) {
      if (!dc[comp[c].td].present || !ac[comp[c].ta].present)
        return kBadHuffman;
      comp[c].pred = 0;
    }
    int count = 0;
    for (int my = 0; my < mcuy; ++my) {
      for (int mx = 0; mx < mcux; ++mx) {
        if (restart_interval && count == restart_interval) {
          if (br.Overrun()) return kTruncated;
          // the rest of the buffer is padding: the interval's bytes are
          // all read, and the RSTn marker comes next
          const uint8_t* q = br.p;
          if (!(q + 1 < br.end && q[0] == 0xFF && q[1] >= 0xD0 && q[1] <= 0xD7))
            return br.p >= br.end ? kTruncated : kBadHuffman;
          br.p = q + 2;
          br.buf = 0;
          br.cnt = 0;
          br.marker = false;
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
};

struct Ik4Info {  // the layout of jpeg_entropy.cpp's IkJpegInfo
  int32_t width, height, ncomp, hmax, vmax;
  int32_t comp_h[4], comp_v[4], comp_width[4], comp_height[4];
  int32_t blocks_w[4], blocks_h[4], comp_tq[4];
  int32_t progressive;
};

}  // namespace

// Header only, up to the first SOS: the frame, and in *adobe_transform
// the flag of an Adobe APP14 segment (-1 when none).
IK_EXPORT int ik_jpeg4_parse(const uint8_t* data, size_t len, Ik4Info* info,
                             int32_t* adobe_transform) {
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
  for (int c = 0; c < f.ncomp; ++c) {
    info->comp_h[c] = f.comp[c].h;
    info->comp_v[c] = f.comp[c].v;
    info->comp_width[c] = f.comp[c].width;
    info->comp_height[c] = f.comp[c].height;
    info->blocks_w[c] = f.comp[c].blocks_w;
    info->blocks_h[c] = f.comp[c].blocks_h;
    info->comp_tq[c] = f.comp[c].tq;
  }
  *adobe_transform = f.adobe_transform;
  return kOk;
}

// The scan into coeffs[0..3] (zeroed by the caller, blocks_h*blocks_w*64
// int16 each) and qtabs_out (4 x 64, natural order).
IK_EXPORT int ik_jpeg4_decode_coeffs(const uint8_t* data, size_t len,
                                     int16_t** coeffs, uint16_t* qtabs_out) {
  Frame f;
  f.data = data;
  f.len = len;
  int rc = f.Parse();
  if (rc != kOk) return rc;
  std::memcpy(qtabs_out, f.qtab, sizeof(f.qtab));
  return f.Decode(coeffs);
}
