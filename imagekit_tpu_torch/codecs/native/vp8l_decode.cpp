// VP8L (WebP lossless) decoder — completes native WebP source coverage
// alongside the lossy VP8 decoder (reference decode arm:
// src/transform.rs:27-43 via the `image` crate).
//
// Implements the WebP lossless bitstream: LSB-first bit reading, canonical
// prefix codes (simple and code-length-coded forms with repeats and the
// max-symbol short form), colour cache, LZ77 backward references with the
// 2D distance mapping, meta prefix-code groups, and all four transforms
// (predictor with its 14 modes, colour transform, subtract-green, colour
// indexing with pixel bundling). Output is ARGB, exact — validated
// pixel-for-pixel against the host library on every test image.
//
// VP8X containers (alpha/animation) are out of scope here and fall back to
// the host library (see codecs/vp8.py).

#include <cstdint>
#include <cstring>
#include <vector>

#include "vp8_tables.h"

#ifndef IK_EXPORT
#define IK_EXPORT extern "C" __attribute__((visibility("default")))
#endif

namespace {

constexpr int VL_OK = 0;
constexpr int VL_TRUNCATED = -1;
constexpr int VL_BAD_MAGIC = -2;
constexpr int VL_UNSUPPORTED = -3;
constexpr int VL_BAD_DATA = -4;
constexpr int VL_BUFFER = -7;

// ---------------------------------------------------------------------------
// LSB-first bit reader
// ---------------------------------------------------------------------------
struct LsbReader {
  const uint8_t* buf = nullptr;
  size_t len = 0, pos = 0;
  uint64_t val = 0;
  int bits = 0;
  bool overrun = false;

  void Init(const uint8_t* b, size_t n) {
    buf = b;
    len = n;
    pos = 0;
    val = 0;
    bits = 0;
    overrun = false;
  }

  uint32_t ReadBits(int n) {
    while (bits < n) {
      if (pos < len) {
        val |= static_cast<uint64_t>(buf[pos]) << bits;
        ++pos;
      } else {
        overrun = true;  // zero-fill; decode loops abort via overrun
      }
      bits += 8;
    }
    const uint32_t out = static_cast<uint32_t>(val & ((1ull << n) - 1));
    val >>= n;
    bits -= n;
    return out;
  }
};

// ---------------------------------------------------------------------------
// Canonical prefix code as a walkable binary tree (codes are transmitted
// most-significant-bit first, deflate style)
// ---------------------------------------------------------------------------
struct PrefixCode {
  // nodes: children[i][0/1]; negative = -(symbol+1) leaf, 0 = empty
  std::vector<int32_t> child0, child1;
  int single_symbol = -1;  // code with exactly one symbol reads no bits

  int NewNode() {
    child0.push_back(0);
    child1.push_back(0);
    return static_cast<int>(child0.size()) - 1;
  }

  int Build(const std::vector<uint8_t>& lengths) {
    child0.clear();
    child1.clear();
    single_symbol = -1;
    int nonzero = 0, last = -1;
    for (size_t s = 0; s < lengths.size(); ++s)
      if (lengths[s]) {
        ++nonzero;
        last = static_cast<int>(s);
      }
    if (nonzero == 0) return VL_BAD_DATA;
    if (nonzero == 1) {
      single_symbol = last;
      return VL_OK;
    }
    // canonical code assignment (deflate): count per length
    int count[16] = {0};
    for (uint8_t l : lengths)
      if (l) ++count[l];
    uint32_t next[16];
    uint32_t code = 0;
    int total = 0;
    for (int l = 1; l <= 15; ++l) {
      code = (code + count[l - 1]) << 1;
      next[l] = code;
      total += count[l] << (15 - l);
    }
    if (total > (1 << 15)) return VL_BAD_DATA;  // over-subscribed
    NewNode();  // root
    for (size_t s = 0; s < lengths.size(); ++s) {
      const int l = lengths[s];
      if (!l) continue;
      uint32_t c = next[l]++;
      int node = 0;
      for (int b = l - 1; b >= 0; --b) {
        const int bit = (c >> b) & 1;
        int32_t& slot = bit ? child1[node] : child0[node];
        if (b == 0) {
          if (slot != 0) return VL_BAD_DATA;
          slot = -static_cast<int32_t>(s) - 1;
        } else {
          if (slot < 0) return VL_BAD_DATA;
          if (slot == 0) {
            const int nn = NewNode();
            // NewNode may reallocate; re-take the reference
            (bit ? child1[node] : child0[node]) = nn;
            node = nn;
          } else {
            node = slot;
          }
        }
      }
    }
    return VL_OK;
  }

  int Decode(LsbReader& br) const {
    if (single_symbol >= 0) return single_symbol;
    int node = 0;
    for (int guard = 0; guard < 16; ++guard) {
      const int bit = static_cast<int>(br.ReadBits(1));
      const int32_t slot = bit ? child1[node] : child0[node];
      if (slot < 0) return -slot - 1;
      if (slot == 0) return -1;  // invalid path
      node = slot;
    }
    return -1;
  }
};

const uint8_t kClOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16,
                              6,  7,  8, 9, 10, 11, 12, 13, 14, 15};

int ReadPrefixCode(LsbReader& br, int num_symbols, PrefixCode* out) {
  std::vector<uint8_t> lengths(num_symbols, 0);
  if (br.ReadBits(1)) {  // simple form: 1 or 2 symbols
    const int n = static_cast<int>(br.ReadBits(1)) + 1;
    const int first_8 = static_cast<int>(br.ReadBits(1));
    const int s0 = static_cast<int>(br.ReadBits(first_8 ? 8 : 1));
    if (s0 >= num_symbols) return VL_BAD_DATA;
    lengths[s0] = 1;
    if (n == 2) {
      const int s1 = static_cast<int>(br.ReadBits(8));
      if (s1 >= num_symbols || s1 == s0) return VL_BAD_DATA;
      lengths[s1] = 1;
    }
    return out->Build(lengths);
  }
  // code-length-coded form
  std::vector<uint8_t> cl(19, 0);
  const int num_codes = static_cast<int>(br.ReadBits(4)) + 4;
  if (num_codes > 19) return VL_BAD_DATA;
  for (int i = 0; i < num_codes; ++i)
    cl[kClOrder[i]] = static_cast<uint8_t>(br.ReadBits(3));
  PrefixCode cltree;
  if (cltree.Build(cl) != VL_OK) return VL_BAD_DATA;

  int max_tokens;
  if (br.ReadBits(1)) {
    const int nbits = 2 + 2 * static_cast<int>(br.ReadBits(3));
    max_tokens = 2 + static_cast<int>(br.ReadBits(nbits));
  } else {
    max_tokens = num_symbols;
  }
  int symbol = 0, prev_len = 8;
  while (symbol < num_symbols && max_tokens-- > 0) {
    if (br.overrun) return VL_TRUNCATED;
    const int code = cltree.Decode(br);
    if (code < 0) return VL_BAD_DATA;
    if (code < 16) {
      lengths[symbol++] = static_cast<uint8_t>(code);
      if (code) prev_len = code;
    } else {
      int repeat, fill;
      if (code == 16) {
        repeat = 3 + static_cast<int>(br.ReadBits(2));
        fill = prev_len;
      } else if (code == 17) {
        repeat = 3 + static_cast<int>(br.ReadBits(3));
        fill = 0;
      } else {
        repeat = 11 + static_cast<int>(br.ReadBits(7));
        fill = 0;
      }
      while (repeat-- > 0 && symbol < num_symbols)
        lengths[symbol++] = static_cast<uint8_t>(fill);
    }
  }
  return out->Build(lengths);
}

// LZ77 length/distance prefix decode (WebP lossless spec)
inline int PrefixDecode(LsbReader& br, int code) {
  if (code < 4) return code + 1;
  const int extra = (code - 2) >> 1;
  const int offset = (2 + (code & 1)) << extra;
  return offset + static_cast<int>(br.ReadBits(extra)) + 1;
}

inline int PlaneCodeToDistance(int xsize, int plane_code) {
  if (plane_code > 120) return plane_code - 120;
  const uint8_t packed = kVp8lCodeToPlane[plane_code - 1];
  const int y = packed >> 4;
  const int x = 8 - (packed & 0xf);
  const int d = y * xsize + x;
  return d >= 1 ? d : 1;
}

// ---------------------------------------------------------------------------
// Entropy-coded ARGB image
// ---------------------------------------------------------------------------
struct HuffGroup {
  PrefixCode green;  // 256 literals + 24 length codes + cache
  PrefixCode red, blue, alpha, dist;
};

struct Transform {
  int type;        // 0 predictor, 1 color, 2 subtract-green, 3 color-index
  int bits = 0;    // tile size bits
  int xsize = 0;   // original xsize when the transform was read
  std::vector<uint32_t> data;  // tiles or palette
};

int DecodeImageStream(LsbReader& br, int xsize, int ysize, bool is_level0,
                      std::vector<uint32_t>* out_argb, int* out_xsize,
                      std::vector<Transform>* transforms);

int ReadTransform(LsbReader& br, int* xsize, int ysize,
                  std::vector<Transform>* transforms) {
  Transform t;
  t.type = static_cast<int>(br.ReadBits(2));
  t.xsize = *xsize;
  switch (t.type) {
    case 0:  // predictor
    case 1: {  // color
      t.bits = static_cast<int>(br.ReadBits(3)) + 2;
      const int tx = (*xsize + (1 << t.bits) - 1) >> t.bits;
      const int ty = (ysize + (1 << t.bits) - 1) >> t.bits;
      int w;
      const int rc = DecodeImageStream(br, tx, ty, false, &t.data, &w, nullptr);
      if (rc != VL_OK) return rc;
      break;
    }
    case 2:  // subtract green: no data
      break;
    case 3: {  // color indexing
      const int n = static_cast<int>(br.ReadBits(8)) + 1;
      t.bits = n;  // reuse: palette size
      int w;
      const int rc = DecodeImageStream(br, n, 1, false, &t.data, &w, nullptr);
      if (rc != VL_OK) return rc;
      // palette entries are componentwise deltas from the previous entry
      // (per-lane adds: carries must not cross channel lanes)
      for (int i = 1; i < n; ++i) {
        const uint32_t p = t.data[i - 1], c = t.data[i];
        t.data[i] =
            (((p & 0xff00ff00u) + (c & 0xff00ff00u)) & 0xff00ff00u) |
            (((p & 0x00ff00ffu) + (c & 0x00ff00ffu)) & 0x00ff00ffu);
      }
      // pixel bundling shrinks the coded width
      int ppu_bits = 0;  // pixels-per-unit = 1 << ppu_bits? inverse below
      if (n <= 2)
        ppu_bits = 3;  // 8 px per byte-unit
      else if (n <= 4)
        ppu_bits = 2;
      else if (n <= 16)
        ppu_bits = 1;
      if (ppu_bits) *xsize = (*xsize + (1 << ppu_bits) - 1) >> ppu_bits;
      break;
    }
  }
  transforms->push_back(std::move(t));
  return VL_OK;
}

int DecodeImageStream(LsbReader& br, int xsize, int ysize, bool is_level0,
                      std::vector<uint32_t>* out_argb, int* out_xsize,
                      std::vector<Transform>* transforms) {
  if (is_level0) {
    int seen[4] = {0, 0, 0, 0};
    while (br.ReadBits(1)) {
      if (br.overrun) return VL_TRUNCATED;
      const size_t peek = transforms->size();
      (void)peek;
      Transform dummy;
      const int before = static_cast<int>(transforms->size());
      const int rc = ReadTransform(br, &xsize, ysize, transforms);
      if (rc != VL_OK) return rc;
      const int ty = (*transforms)[before].type;
      if (seen[ty]) return VL_BAD_DATA;  // each transform at most once
      seen[ty] = 1;
    }
  }

  // colour cache
  int cache_bits = 0;
  if (br.ReadBits(1)) {
    cache_bits = static_cast<int>(br.ReadBits(4));
    if (cache_bits < 1 || cache_bits > 11) return VL_BAD_DATA;
  }
  const int cache_size = cache_bits ? (1 << cache_bits) : 0;

  // meta prefix-code image (level0 only)
  std::vector<uint32_t> meta;
  int meta_xsize = 0, meta_bits = 0;
  int num_groups = 1;
  if (is_level0 && br.ReadBits(1)) {
    meta_bits = static_cast<int>(br.ReadBits(3)) + 2;
    const int mx = (xsize + (1 << meta_bits) - 1) >> meta_bits;
    const int my = (ysize + (1 << meta_bits) - 1) >> meta_bits;
    const int rc = DecodeImageStream(br, mx, my, false, &meta, &meta_xsize,
                                     nullptr);
    if (rc != VL_OK) return rc;
    uint32_t max_idx = 0;
    for (uint32_t p : meta) {
      const uint32_t idx = (p >> 8) & 0xffff;
      if (idx > max_idx) max_idx = idx;
    }
    num_groups = static_cast<int>(max_idx) + 1;
  }

  const int green_syms = 256 + 24 + cache_size;
  std::vector<HuffGroup> groups(num_groups);
  for (auto& g : groups) {
    if (ReadPrefixCode(br, green_syms, &g.green) != VL_OK) return VL_BAD_DATA;
    if (ReadPrefixCode(br, 256, &g.red) != VL_OK) return VL_BAD_DATA;
    if (ReadPrefixCode(br, 256, &g.blue) != VL_OK) return VL_BAD_DATA;
    if (ReadPrefixCode(br, 256, &g.alpha) != VL_OK) return VL_BAD_DATA;
    if (ReadPrefixCode(br, 40, &g.dist) != VL_OK) return VL_BAD_DATA;
  }

  std::vector<uint32_t> cache(cache_size, 0);
  auto cache_insert = [&](uint32_t argb) {
    if (cache_size)
      cache[(0x1e35a7bdu * argb) >> (32 - cache_bits)] = argb;
  };

  const size_t npix = static_cast<size_t>(xsize) * ysize;
  out_argb->assign(npix, 0);
  size_t pos = 0;
  while (pos < npix) {
    if (br.overrun) return VL_TRUNCATED;
    const HuffGroup* g = &groups[0];
    if (meta_bits) {
      const int x = static_cast<int>(pos % xsize);
      const int y = static_cast<int>(pos / xsize);
      const uint32_t mp =
          meta[(y >> meta_bits) * meta_xsize + (x >> meta_bits)];
      const uint32_t idx = (mp >> 8) & 0xffff;
      g = &groups[idx];
    }
    const int s = g->green.Decode(br);
    if (s < 0) return VL_BAD_DATA;
    if (s < 256) {  // literal
      const int r = g->red.Decode(br);
      const int b = g->blue.Decode(br);
      const int a = g->alpha.Decode(br);
      if ((r | b | a) < 0) return VL_BAD_DATA;
      const uint32_t argb = (static_cast<uint32_t>(a) << 24) |
                            (static_cast<uint32_t>(r) << 16) |
                            (static_cast<uint32_t>(s) << 8) |
                            static_cast<uint32_t>(b);
      (*out_argb)[pos++] = argb;
      cache_insert(argb);
    } else if (s < 256 + 24) {  // LZ77 backward reference
      const int length = PrefixDecode(br, s - 256);
      const int dsym = g->dist.Decode(br);
      if (dsym < 0) return VL_BAD_DATA;
      const int dcode = PrefixDecode(br, dsym);
      const int dist = PlaneCodeToDistance(xsize, dcode);
      if (static_cast<size_t>(dist) > pos) return VL_BAD_DATA;
      if (pos + length > npix) return VL_BAD_DATA;
      for (int i = 0; i < length; ++i) {
        (*out_argb)[pos] = (*out_argb)[pos - dist];
        cache_insert((*out_argb)[pos]);
        ++pos;
      }
    } else {  // colour cache reference
      const int idx = s - 256 - 24;
      if (idx >= cache_size) return VL_BAD_DATA;
      (*out_argb)[pos++] = cache[idx];
    }
  }
  *out_xsize = xsize;
  return VL_OK;
}

// ---------------------------------------------------------------------------
// Inverse transforms
// ---------------------------------------------------------------------------
inline uint32_t Average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}

inline int Sub3(int a, int b, int c) {
  const int pb = b - c, pa = a - c;
  return (pb < 0 ? -pb : pb) - (pa < 0 ? -pa : pa);
}

inline uint32_t Select(uint32_t a, uint32_t b, uint32_t c) {
  const int pa_minus_pb =
      Sub3((a >> 24), (b >> 24), (c >> 24)) +
      Sub3((a >> 16) & 0xff, (b >> 16) & 0xff, (c >> 16) & 0xff) +
      Sub3((a >> 8) & 0xff, (b >> 8) & 0xff, (c >> 8) & 0xff) +
      Sub3(a & 0xff, b & 0xff, c & 0xff);
  return (pa_minus_pb <= 0) ? a : b;
}

inline int Clip255i(int v) { return v < 0 ? 0 : (v > 255 ? 255 : v); }

inline uint32_t ClampAddSubtractFull(uint32_t c0, uint32_t c1, uint32_t c2) {
  uint32_t out = 0;
  for (int sh = 0; sh < 32; sh += 8) {
    const int v = Clip255i(static_cast<int>((c0 >> sh) & 0xff) +
                           static_cast<int>((c1 >> sh) & 0xff) -
                           static_cast<int>((c2 >> sh) & 0xff));
    out |= static_cast<uint32_t>(v) << sh;
  }
  return out;
}

inline uint32_t ClampAddSubtractHalf(uint32_t c0, uint32_t c2) {
  uint32_t out = 0;
  for (int sh = 0; sh < 32; sh += 8) {
    const int a = static_cast<int>((c0 >> sh) & 0xff);
    const int b = static_cast<int>((c2 >> sh) & 0xff);
    const int v = Clip255i(a + (a - b) / 2);
    out |= static_cast<uint32_t>(v) << sh;
  }
  return out;
}

void InversePredictor(std::vector<uint32_t>& img, int w, int h,
                      const Transform& t) {
  const int tx = (w + (1 << t.bits) - 1) >> t.bits;
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      const size_t p = static_cast<size_t>(y) * w + x;
      uint32_t pred;
      if (y == 0 && x == 0) {
        pred = 0xff000000u;
      } else if (y == 0) {
        pred = img[p - 1];  // L
      } else if (x == 0) {
        pred = img[p - w];  // T
      } else {
        const uint32_t tile = t.data[(y >> t.bits) * tx + (x >> t.bits)];
        const int mode = (tile >> 8) & 0xff;
        const uint32_t L = img[p - 1];
        const uint32_t T = img[p - w];
        const uint32_t TL = img[p - w - 1];
        // rightmost column: TR wraps to the first pixel of the current row
        const uint32_t TR = img[p - w + 1];
        switch (mode) {
          case 0: pred = 0xff000000u; break;
          case 1: pred = L; break;
          case 2: pred = T; break;
          case 3: pred = TR; break;
          case 4: pred = TL; break;
          case 5: pred = Average2(Average2(L, TR), T); break;
          case 6: pred = Average2(L, TL); break;
          case 7: pred = Average2(L, T); break;
          case 8: pred = Average2(TL, T); break;
          case 9: pred = Average2(T, TR); break;
          case 10:
            pred = Average2(Average2(L, TL), Average2(T, TR));
            break;
          // spec: L if pL < pT else T — a TIE selects T, so T must be
          // the <=0 branch of Select
          case 11: pred = Select(T, L, TL); break;
          case 12: pred = ClampAddSubtractFull(L, T, TL); break;
          case 13:
            pred = ClampAddSubtractHalf(Average2(L, T), TL);
            break;
          default: pred = 0xff000000u; break;
        }
      }
      // add prediction per channel, mod 256
      const uint32_t v = img[p];
      img[p] = (((v & 0xff00ff00u) + (pred & 0xff00ff00u)) & 0xff00ff00u) |
               (((v & 0x00ff00ffu) + (pred & 0x00ff00ffu)) & 0x00ff00ffu);
    }
  }
}

inline int ColorDelta(int8_t t, int8_t c) {
  return (static_cast<int>(t) * static_cast<int>(c)) >> 5;
}

void InverseColorTransform(std::vector<uint32_t>& img, int w, int h,
                           const Transform& t) {
  const int tx = (w + (1 << t.bits) - 1) >> t.bits;
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      const size_t p = static_cast<size_t>(y) * w + x;
      const uint32_t cte = t.data[(y >> t.bits) * tx + (x >> t.bits)];
      const int8_t g2r = static_cast<int8_t>(cte & 0xff);
      const int8_t g2b = static_cast<int8_t>((cte >> 8) & 0xff);
      const int8_t r2b = static_cast<int8_t>((cte >> 16) & 0xff);
      const uint32_t v = img[p];
      const int green = static_cast<int8_t>((v >> 8) & 0xff);
      int red = static_cast<int>((v >> 16) & 0xff);
      int blue = static_cast<int>(v & 0xff);
      red = (red + ColorDelta(g2r, static_cast<int8_t>(green))) & 0xff;
      blue = (blue + ColorDelta(g2b, static_cast<int8_t>(green))) & 0xff;
      blue = (blue + ColorDelta(r2b, static_cast<int8_t>(red))) & 0xff;
      img[p] = (v & 0xff00ff00u) | (static_cast<uint32_t>(red) << 16) |
               static_cast<uint32_t>(blue);
    }
  }
}

void InverseSubtractGreen(std::vector<uint32_t>& img) {
  for (uint32_t& v : img) {
    const uint32_t g = (v >> 8) & 0xff;
    uint32_t r = ((v >> 16) & 0xff) + g;
    uint32_t b = (v & 0xff) + g;
    v = (v & 0xff00ff00u) | ((r & 0xff) << 16) | (b & 0xff);
  }
}

int InverseColorIndexing(std::vector<uint32_t>& img, int w, int h,
                         const Transform& t,
                         std::vector<uint32_t>* out) {
  const int n = t.bits;  // palette size
  int ppu_bits = 0;
  if (n <= 2)
    ppu_bits = 3;
  else if (n <= 4)
    ppu_bits = 2;
  else if (n <= 16)
    ppu_bits = 1;
  const int coded_w = ppu_bits ? ((w + (1 << ppu_bits) - 1) >> ppu_bits) : w;
  const int idx_bits = 8 >> ppu_bits;  // bits per index within the byte
  const uint32_t idx_mask = (1u << idx_bits) - 1;
  out->assign(static_cast<size_t>(w) * h, 0);
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      const int cx = ppu_bits ? (x >> ppu_bits) : x;
      const uint32_t packed =
          (img[static_cast<size_t>(y) * coded_w + cx] >> 8) & 0xff;
      const uint32_t idx =
          ppu_bits ? ((packed >> (idx_bits * (x & ((1 << ppu_bits) - 1)))) &
                      idx_mask)
                   : packed;
      // spec: an index >= color_table_size decodes as 0x00000000
      // (transparent black) — encoders exploit this, e.g. libwebp's
      // alpha palettes omit the zero entry
      (*out)[static_cast<size_t>(y) * w + x] =
          idx < static_cast<uint32_t>(n) ? t.data[idx] : 0u;
    }
  }
  return VL_OK;
}

// Full post-header decode: entropy stream + inverse transforms in reverse
// order of reading -> w*h ARGB words. Shared by the image path
// (ik_vp8l_decode) and the VP8X alpha-plane path (ik_webp_decode_alph).
int DecodeVp8lBody(LsbReader& br, int w, int h, std::vector<uint32_t>* img) {
  std::vector<Transform> transforms;
  int coded_w;
  int rc = DecodeImageStream(br, w, h, true, img, &coded_w, &transforms);
  if (rc != VL_OK) return rc;

  int cur_w = coded_w;
  for (auto it = transforms.rbegin(); it != transforms.rend(); ++it) {
    switch (it->type) {
      case 3: {  // color indexing restores the full width
        std::vector<uint32_t> full;
        rc = InverseColorIndexing(*img, it->xsize, h, *it, &full);
        if (rc != VL_OK) return rc;
        img->swap(full);
        cur_w = it->xsize;
        break;
      }
      case 2:
        InverseSubtractGreen(*img);
        break;
      case 1:
        InverseColorTransform(*img, cur_w, h, *it);
        break;
      case 0:
        InversePredictor(*img, cur_w, h, *it);
        break;
    }
  }
  if (cur_w != w) return VL_BAD_DATA;
  if (img->size() != static_cast<size_t>(w) * h) return VL_BAD_DATA;
  return VL_OK;
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------
struct IkVp8lInfo {
  int32_t width, height, has_alpha;
};

namespace {

int FindVp8lChunk(const uint8_t* d, size_t len, const uint8_t** body,
                  size_t* body_len) {
  if (len < 20 || std::memcmp(d, "RIFF", 4) != 0 ||
      std::memcmp(d + 8, "WEBP", 4) != 0)
    return VL_BAD_MAGIC;
  size_t pos = 12;
  while (pos + 8 <= len) {
    const uint32_t sz = d[pos + 4] | (d[pos + 5] << 8) | (d[pos + 6] << 16) |
                        (static_cast<uint32_t>(d[pos + 7]) << 24);
    if (std::memcmp(d + pos, "VP8L", 4) == 0) {
      if (pos + 8 + sz > len) return VL_TRUNCATED;
      *body = d + pos + 8;
      *body_len = sz;
      return VL_OK;
    }
    if (std::memcmp(d + pos, "VP8X", 4) == 0) return VL_UNSUPPORTED;
    pos += 8 + sz + (sz & 1);
  }
  return VL_BAD_DATA;
}

int ParseVp8lHeader(const uint8_t* b, size_t n, LsbReader* br, int* w, int* h,
                    int* alpha) {
  if (n < 5) return VL_TRUNCATED;
  if (b[0] != 0x2f) return VL_BAD_MAGIC;
  br->Init(b + 1, n - 1);
  *w = static_cast<int>(br->ReadBits(14)) + 1;
  *h = static_cast<int>(br->ReadBits(14)) + 1;
  *alpha = static_cast<int>(br->ReadBits(1));
  const int version = static_cast<int>(br->ReadBits(3));
  if (version != 0) return VL_UNSUPPORTED;
  return VL_OK;
}

}  // namespace

IK_EXPORT int ik_vp8l_parse(const uint8_t* d, size_t len, IkVp8lInfo* out) {
  const uint8_t* body;
  size_t blen;
  int rc = FindVp8lChunk(d, len, &body, &blen);
  if (rc != VL_OK) return rc;
  LsbReader br;
  int w, h, alpha;
  rc = ParseVp8lHeader(body, blen, &br, &w, &h, &alpha);
  out->width = w;
  out->height = h;
  out->has_alpha = alpha;
  return rc;
}

// Decode a lossless WebP to RGBA (HWC u8, 4 channels, w*h*4 bytes).
IK_EXPORT int ik_vp8l_decode(const uint8_t* d, size_t len, uint8_t* out,
                             size_t out_cap) {
  const uint8_t* body;
  size_t blen;
  int rc = FindVp8lChunk(d, len, &body, &blen);
  if (rc != VL_OK) return rc;
  LsbReader br;
  int w, h, alpha;
  rc = ParseVp8lHeader(body, blen, &br, &w, &h, &alpha);
  if (rc != VL_OK) return rc;
  if (w <= 0 || h <= 0) return VL_BAD_DATA;
  if (out_cap < static_cast<size_t>(w) * h * 4) return VL_BUFFER;

  std::vector<uint32_t> img;
  rc = DecodeVp8lBody(br, w, h, &img);
  if (rc != VL_OK) return rc;

  // ARGB words -> RGBA bytes
  for (size_t i = 0; i < img.size(); ++i) {
    const uint32_t v = img[i];
    out[i * 4 + 0] = (v >> 16) & 0xff;
    out[i * 4 + 1] = (v >> 8) & 0xff;
    out[i * 4 + 2] = v & 0xff;
    out[i * 4 + 3] = (v >> 24) & 0xff;
  }
  return VL_OK;
}

// Decode a VP8X/ALPH alpha-plane chunk payload to w*h alpha bytes.
// Container-spec layout: 1 header byte (reserved:2 | preprocessing:2 |
// filtering:2 | compression:2, MSB..LSB) then either raw filtered bytes
// (compression 0) or a headerless VP8L bitstream whose GREEN channel is
// the filtered alpha (compression 1). The four row filters are inverted
// exactly as the spec's horizontal/vertical/gradient predictors.
IK_EXPORT int ik_webp_decode_alph(const uint8_t* d, size_t len, int w, int h,
                                  uint8_t* out) {
  if (w <= 0 || h <= 0) return VL_BAD_DATA;
  if (len < 1) return VL_TRUNCATED;
  const int compression = d[0] & 3;
  const int filter = (d[0] >> 2) & 3;
  const int reserved = d[0] >> 6;
  if (reserved != 0 || compression > 1) return VL_BAD_DATA;
  const size_t npix = static_cast<size_t>(w) * h;

  if (compression == 0) {
    if (len < 1 + npix) return VL_TRUNCATED;
    std::memcpy(out, d + 1, npix);
  } else {
    LsbReader br;
    br.Init(d + 1, len - 1);
    std::vector<uint32_t> img;
    const int rc = DecodeVp8lBody(br, w, h, &img);
    if (rc != VL_OK) return rc;
    for (size_t i = 0; i < npix; ++i)
      out[i] = static_cast<uint8_t>((img[i] >> 8) & 0xff);  // green = alpha
  }

  // inverse row filters, in place (prev row is already reconstructed)
  if (filter == 0) return VL_OK;
  for (int y = 0; y < h; ++y) {
    uint8_t* row = out + static_cast<size_t>(y) * w;
    const uint8_t* prev = y ? row - w : nullptr;
    if (prev == nullptr || filter == 1) {  // horizontal (and every row 0)
      uint8_t pred = prev ? prev[0] : 0;
      for (int x = 0; x < w; ++x) {
        row[x] = static_cast<uint8_t>(row[x] + pred);
        pred = row[x];
      }
    } else if (filter == 2) {  // vertical
      for (int x = 0; x < w; ++x)
        row[x] = static_cast<uint8_t>(row[x] + prev[x]);
    } else {  // gradient
      int left = prev[0], top_left = prev[0];
      for (int x = 0; x < w; ++x) {
        const int top = prev[x];
        const int g = left + top - top_left;
        left = (row[x] + (g < 0 ? 0 : (g > 255 ? 255 : g))) & 0xff;
        top_left = top;
        row[x] = static_cast<uint8_t>(left);
      }
    }
  }
  return VL_OK;
}

IK_EXPORT int ik_vp8l_version() { return 1; }
