// Four-component (CMYK and YCCK) JPEG entropy decode of the port, and the
// baseline frames in several scans.
//
// The port's copy of the reference's decoder (jpeg_entropy.cpp, pinned
// byte-equal to it) refuses a frame of four components, and a baseline
// frame whose first scan is not interleaved over every component, with
// -3; the reference then decodes such a JPEG with Pillow. This decoder is
// the port's own, for those cases only: a frame of 8-bit precision and
// two, three or four components, baseline or extended Huffman (SOF0/SOF1)
// in one interleaved scan or in a sequence of scans of one or more
// components each (a component's blocks over ceil(cw / 8) x ceil(ch / 8)
// in its own raster order when it is alone in a scan, T.81 A.2.2; the
// MCU-padding blocks of such a component are not coded and stay zero), or
// progressive Huffman (SOF2) in any sequence of scans: DC first and
// refinement scans, interleaved or not, and AC first and refinement scans
// of one component each, with EOB runs and restart intervals (an EOB run
// past the scan's last block or across a restart marker, which no encoder
// writes, is refused). The progressive scans follow jpeg_entropy.cpp's
// (DecodeProgressiveScan, DecodeBlockProgressive, FinalizeProgressive;
// T.81 G.1.2 and G.2), copied rather than linked: blocks accumulate in
// zigzag order and are put in natural order once, at the EOI. An
// interleaved scan of more than 10 blocks an MCU is refused with -8, as
// libjpeg refuses it ("Sampling factors too large for interleaved scan").
// Arithmetic-coded, 12-bit and lossless frames and other component counts
// return -3. A frame of two components (a JPEG TIFF's gray + alpha
// segments) decodes as one of four does; the JPEG source layer refuses it,
// as Pillow does.
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
  kMcuTooLarge = -8,  // an interleaved scan of more than 10 blocks an MCU
  kEoi = 1,  // Next(): the EOI marker, after a progressive frame's scans
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
  uint16_t qtab[4][64] = {};
  Huffman dc[4], ac[4];
  Component comp[4];
  Scan sos;
  const uint8_t* scan = nullptr;
  const uint8_t* at = nullptr;  // where the marker walk stands
  int scans = 0;                // scans decoded (DecodeScans)

  // SOI, then the markers up to the first SOS; scan points at its
  // entropy-coded data.
  int Parse() {
    if (len < 4 || data[0] != 0xFF || data[1] != 0xD8) return kBadMarker;
    at = data + 2;
    return Next();
  }

  // The markers from `at` up to the next SOS, or kEoi at the EOI of a
  // progressive frame that has had a scan.
  int Next() {
    const uint8_t* p = at;
    const uint8_t* end = data + len;
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
          if (have_frame) return kBadMarker;
          progressive = m == 0xC2;
          rc = Sof(s, n);
          break;
        case 0xC3: case 0xC5: case 0xC6: case 0xC7: case 0xC9:
        case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
          return kUnsupported;  // lossless, hierarchical, arithmetic
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
    if (ncomp < 2 || ncomp > 4) return kUnsupported;
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
    if (ns < 1 || ns > 4) return kBadMarker;
    if (n < 1 + 2 * ns + 3) return kTruncated;
    sos.ns = ns;
    for (int i = 0; i < ns; ++i) {
      const int cid = s[1 + 2 * i], tabs = s[2 + 2 * i];
      if ((tabs >> 4) > 3 || (tabs & 15) > 3) return kBadMarker;
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
    if (!progressive)
      return sos.Ss != 0 || sos.Se != 63 || sp[2] != 0 ? kUnsupported : kOk;
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
      Bits br;
      br.p = scan;
      br.end = end;
      const int rc = DecodeScan(br, coeffs);
      if (rc != kOk || br.Overrun()) return br.Overrun() ? kTruncated : rc;
      ++scans;
      // the next marker after the entropy-coded data (RSTn lie inside it)
      const uint8_t* p = br.p;
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
          if (eobrun > 0) return kBadHuffman;  // a run across the RSTn
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
      return eobrun > 0 ? kBadHuffman : kOk;  // a run past the scan's blocks
    }
    const int mcux = (width + 8 * hmax - 1) / (8 * hmax);
    const int mcuy = (height + 8 * vmax - 1) / (8 * vmax);
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
  *adobe_transform = f.adobe_transform;
  return kOk;
}

// The scans into coeffs[0..ncomp-1] (zeroed by the caller,
// blocks_h*blocks_w*64 int16 each) and qtabs_out (4 x 64, natural order).
IK_EXPORT int ik_jpeg4_decode_coeffs(const uint8_t* data, size_t len,
                                     int16_t** coeffs, uint16_t* qtabs_out) {
  Frame f;
  f.data = data;
  f.len = len;
  int rc = f.Parse();
  if (rc != kOk) return rc;
  // one interleaved baseline scan, or a sequence of scans to the EOI
  rc = !f.progressive && f.sos.ns == f.ncomp ? f.Decode(coeffs)
                                             : f.DecodeScans(coeffs);
  std::memcpy(qtabs_out, f.qtab, sizeof(f.qtab));  // DQT may follow a scan
  return rc;
}
