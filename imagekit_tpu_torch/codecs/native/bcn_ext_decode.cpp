// BC6H and BC7 block decodes of the port (DDS sources), for
// raster_decode.cpp's ik_bcn_decode.
//
// The reference decodes DDS sources with Pillow
// (imagekit_tpu/codecs/pil_backend.py); the port has no Pillow, so these are
// its own, written to give Pillow 12's pixels (libImaging's BcnDecode.c):
//
// - BC7: the eight modes of the format (partition, rotation and index
//   selection bits, per-endpoint or shared p-bits, endpoints widened by bit
//   replication, (e0 * (64 - w) + e1 * w + 32) >> 6 per channel). A block
//   whose first byte is 0 (no mode bit) is opaque black. The partition and
//   anchor tables below are the format's.
// - BC6H, unsigned and signed: the fourteen modes' endpoint layouts,
//   deltas sign-extended and added to the base endpoint modulo its
//   precision (the sum of a signed block is not sign-extended again: a
//   negative one reads as large), unquantised to 16 bits, interpolated
//   with no rounding term, scaled by 31/64
//   (unsigned) or 31/32 (signed) to a half float, then clipped to [0, 1]
//   and scaled by 255, truncated. A reserved mode (10011, 10111, 11011,
//   11111) is black.
//
// Each block gives 16 texels of 4 bytes (R, G, B, A) in row-major order.

#include <cstdint>
#include <cstring>

namespace ik_bcn {

namespace {

// -- shared -----------------------------------------------------------------

inline int Bit(const uint8_t* src, int bit) {
  return (src[bit >> 3] >> (bit & 7)) & 1;
}

// `count` (at most 8) bits of the 128-bit block, LSB first from `bit`.
inline int Bits(const uint8_t* src, int bit, int count) {
  int v = 0;
  for (int i = 0; i < count; ++i) v |= Bit(src, bit + i) << i;
  return v;
}

// Subset of texel n: bit n of a two-subset partition, bits 2n..2n+1 of a
// three-subset one.
const uint16_t kSubsets2[64] = {
    0xcccc, 0x8888, 0xeeee, 0xecc8, 0xc880, 0xfeec, 0xfec8, 0xec80,
    0xc800, 0xffec, 0xfe80, 0xe800, 0xffe8, 0xff00, 0xfff0, 0xf000,
    0xf710, 0x008e, 0x7100, 0x08ce, 0x008c, 0x7310, 0x3100, 0x8cce,
    0x088c, 0x3110, 0x6666, 0x366c, 0x17e8, 0x0ff0, 0x718e, 0x399c,
    0xaaaa, 0xf0f0, 0x5a5a, 0x33cc, 0x3c3c, 0x55aa, 0x9696, 0xa55a,
    0x73ce, 0x13c8, 0x324c, 0x3bdc, 0x6996, 0xc33c, 0x9966, 0x0660,
    0x0272, 0x04e4, 0x4e40, 0x2720, 0xc936, 0x936c, 0x39c6, 0x639c,
    0x9336, 0x9cc6, 0x817e, 0xe718, 0xccf0, 0x0fcc, 0x7744, 0xee22,
};
const uint32_t kSubsets3[64] = {
    0xaa685050, 0x6a5a5040, 0x5a5a4200, 0x5450a0a8, 0xa5a50000, 0xa0a05050,
    0x5555a0a0, 0x5a5a5050, 0xaa550000, 0xaa555500, 0xaaaa5500, 0x90909090,
    0x94949494, 0xa4a4a4a4, 0xa9a59450, 0x2a0a4250, 0xa5945040, 0x0a425054,
    0xa5a5a500, 0x55a0a0a0, 0xa8a85454, 0x6a6a4040, 0xa4a45000, 0x1a1a0500,
    0x0050a4a4, 0xaaa59090, 0x14696914, 0x69691400, 0xa08585a0, 0xaa821414,
    0x50a4a450, 0x6a5a0200, 0xa9a58000, 0x5090a0a8, 0xa8a09050, 0x24242424,
    0x00aa5500, 0x24924924, 0x24499224, 0x50a50a50, 0x500aa550, 0xaaaa4444,
    0x66660000, 0xa5a0a5a0, 0x50a050a0, 0x69286928, 0x44aaaa44, 0x66666600,
    0xaa444444, 0x54a854a8, 0x95809580, 0x96969600, 0xa85454a8, 0x80959580,
    0xaa141414, 0x96960000, 0xaaaa1414, 0xa05050a0, 0xa0a5a5a0, 0x96000000,
    0x40804080, 0xa9a8a9a8, 0xaaaaaa44, 0x2a4a5254,
};
// The anchor texel (its index one bit short) of subset 1 of a two-subset
// partition, and of subsets 1 and 2 of a three-subset one; texel 0
// anchors subset 0.
const uint8_t kAnchor2[64] = {
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15, 2,  8,  2,  2,  8,  8,  15, 2,  8,  2,  2,  8,  8,  2,  2,
    15, 15, 6,  8,  2,  8,  15, 15, 2,  8,  2,  2,  2,  15, 15, 6,
    6,  2,  6,  8,  15, 15, 2,  2,  15, 15, 15, 15, 15, 2,  2,  15,
};
const uint8_t kAnchor3a[64] = {
    3,  3,  15, 15, 8,  3,  15, 15, 8,  8,  6,  6,  6,  5,  3,  3,
    3,  3,  8,  15, 3,  3,  6,  10, 5,  8,  8,  6,  8,  5,  15, 15,
    8,  15, 3,  5,  6,  10, 8,  15, 15, 3,  15, 5,  15, 15, 15, 15,
    3,  15, 5,  5,  5,  8,  5,  10, 5,  10, 8,  13, 15, 12, 3,  3,
};
const uint8_t kAnchor3b[64] = {
    15, 8,  8,  3,  15, 15, 3,  8,  15, 15, 15, 15, 15, 15, 15, 8,
    15, 8,  15, 3,  15, 8,  15, 8,  3,  15, 6,  10, 15, 15, 10, 8,
    15, 3,  15, 10, 10, 8,  9,  10, 6,  15, 8,  15, 3,  6,  6,  8,
    15, 3,  15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 3,  15, 15, 8,
};

const uint8_t kWeights2[4] = {0, 21, 43, 64};
const uint8_t kWeights3[8] = {0, 9, 18, 27, 37, 46, 55, 64};
const uint8_t kWeights4[16] = {0,  4,  9,  13, 17, 21, 26, 30,
                               34, 38, 43, 47, 51, 55, 60, 64};

inline const uint8_t* Weights(int bits) {
  return bits == 2 ? kWeights2 : bits == 3 ? kWeights3 : kWeights4;
}

inline int Subset(int ns, int partition, int n) {
  if (ns == 2) return 1 & (kSubsets2[partition] >> n);
  if (ns == 3) return 3 & (kSubsets3[partition] >> (2 * n));
  return 0;
}

// Whether texel n's index is one bit short (it anchors its subset).
inline bool Anchor(int ns, int partition, int n, int subset) {
  if (n == 0) return true;
  if (ns == 2) return subset == 1 && n == kAnchor2[partition];
  if (ns == 3)
    return (subset == 1 && n == kAnchor3a[partition]) ||
           (subset == 2 && n == kAnchor3b[partition]);
  return false;
}

// -- BC7 --------------------------------------------------------------------

struct Bc7Mode {
  uint8_t ns;   // subsets
  uint8_t pb;   // partition bits
  uint8_t rb;   // rotation bits
  uint8_t isb;  // index selection bits
  uint8_t cb;   // colour bits an endpoint channel
  uint8_t ab;   // alpha bits (0: opaque)
  uint8_t epb;  // a p-bit an endpoint
  uint8_t spb;  // a p-bit a subset
  uint8_t ib;   // index bits
  uint8_t ib2;  // second index bits (modes 4 and 5)
};

const Bc7Mode kBc7Modes[8] = {
    {3, 4, 0, 0, 4, 0, 1, 0, 3, 0}, {2, 6, 0, 0, 6, 0, 0, 1, 3, 0},
    {3, 6, 0, 0, 5, 0, 0, 0, 2, 0}, {2, 6, 0, 0, 7, 0, 1, 0, 2, 0},
    {1, 0, 2, 1, 5, 6, 0, 0, 2, 3}, {1, 0, 2, 0, 7, 8, 0, 0, 2, 2},
    {1, 0, 0, 0, 7, 7, 1, 0, 4, 0}, {2, 6, 0, 0, 5, 5, 1, 0, 2, 0},
};

inline int Widen(int v, int bits) {
  v = (v << (8 - bits)) & 0xff;
  return v | (v >> bits);
}

inline uint8_t Lerp(int e0, int e1, int w) {
  return static_cast<uint8_t>(((64 - w) * e0 + w * e1 + 32) >> 6);
}

void Bc7(const uint8_t* src, uint8_t* out) {
  if (src[0] == 0) {
    for (int i = 0; i < 16; ++i) {
      out[4 * i] = out[4 * i + 1] = out[4 * i + 2] = 0;
      out[4 * i + 3] = 255;
    }
    return;
  }
  int mode = 0;
  while (!(src[0] & (1 << mode))) ++mode;
  const Bc7Mode& m = kBc7Modes[mode];
  int bit = mode + 1;
  const int partition = Bits(src, bit, m.pb);
  bit += m.pb;
  const int rotation = Bits(src, bit, m.rb);
  bit += m.rb;
  const int index_sel = Bits(src, bit, m.isb);
  bit += m.isb;
  const int numep = 2 * m.ns;
  int ep[6][4];
  for (int c = 0; c < 3; ++c)
    for (int i = 0; i < numep; ++i, bit += m.cb)
      ep[i][c] = Bits(src, bit, m.cb);
  for (int i = 0; i < numep; ++i) {
    ep[i][3] = m.ab ? Bits(src, bit, m.ab) : 255;
    bit += m.ab;
  }
  int cb = m.cb, ab = m.ab;
  if (m.epb || m.spb) {
    ++cb;
    if (ab) ++ab;
    for (int i = 0; i < numep; ++i) {
      // one bit an endpoint, or one a subset shared by its two endpoints
      const int p = Bit(src, m.epb ? bit + i : bit + i / 2);
      for (int c = 0; c < (m.ab ? 4 : 3); ++c) ep[i][c] = (ep[i][c] << 1) | p;
    }
    bit += m.epb ? numep : m.ns;
  }
  for (int i = 0; i < numep; ++i) {
    for (int c = 0; c < 3; ++c) ep[i][c] = Widen(ep[i][c], cb);
    if (ab) ep[i][3] = Widen(ep[i][3], ab);
  }
  const uint8_t* cw = Weights(m.ib);
  const uint8_t* aw = Weights(m.ab && m.ib2 ? m.ib2 : m.ib);
  int cibit = bit;
  int aibit = cibit + 16 * m.ib - m.ns;
  for (int n = 0; n < 16; ++n) {
    const int s = Subset(m.ns, partition, n);
    const int ib = m.ib - (Anchor(m.ns, partition, n, s) ? 1 : 0);
    const int i0 = Bits(src, cibit, ib);
    cibit += ib;
    int wc = cw[i0], wa = cw[i0];
    if (m.ab && m.ib2) {
      const int ib2 = m.ib2 - (n == 0 ? 1 : 0);
      const int i1 = Bits(src, aibit, ib2);
      aibit += ib2;
      if (index_sel) {
        wc = aw[i1];
        wa = cw[i0];
      } else {
        wa = aw[i1];
      }
    }
    const int* e0 = ep[2 * s];
    const int* e1 = ep[2 * s + 1];
    uint8_t* px = out + 4 * n;
    for (int c = 0; c < 3; ++c) px[c] = Lerp(e0[c], e1[c], wc);
    px[3] = Lerp(e0[3], e1[3], wa);
    if (rotation) {  // swap the alpha with R, G or B
      const uint8_t t = px[rotation - 1];
      px[rotation - 1] = px[3];
      px[3] = t;
    }
  }
}

// -- BC6H -------------------------------------------------------------------

// Endpoint fields, in the order r0 g0 b0 r1 g1 b1 r2 g2 b2 r3 g3 b3 (the
// first endpoint pair is subset 0's, the second subset 1's).
enum { R0, G0, B0, R1, G1, B1, R2, G2, B2, R3, G3, B3 };

// A run of endpoint bits in the block: `n` bits of field `f` from bit
// `lo` up, or, reversed, from bit lo + n - 1 down.
struct Seg {
  uint8_t f, lo, n, rev;
};

struct Bc6Mode {
  uint8_t ns;       // regions
  uint8_t tr;       // deltas from the first endpoint
  uint8_t epb;      // bits of the first endpoint
  uint8_t db[3];    // bits of the deltas (or other endpoints), R G B
  uint8_t nseg;
  Seg seg[24];
};

// The fourteen modes' layouts (after the 2- or 5-bit mode field), as the
// BC6H format lists them.
const Bc6Mode kBc6Modes[14] = {
    {2, 1, 10, {5, 5, 5}, 19,
     {{G2, 4, 1, 0}, {B2, 4, 1, 0}, {B3, 4, 1, 0}, {R0, 0, 10, 0},
      {G0, 0, 10, 0}, {B0, 0, 10, 0}, {R1, 0, 5, 0}, {G3, 4, 1, 0},
      {G2, 0, 4, 0}, {G1, 0, 5, 0}, {B3, 0, 1, 0}, {G3, 0, 4, 0},
      {B1, 0, 5, 0}, {B3, 1, 1, 0}, {B2, 0, 4, 0}, {R2, 0, 5, 0},
      {B3, 2, 1, 0}, {R3, 0, 5, 0}, {B3, 3, 1, 0}}},
    {2, 1, 7, {6, 6, 6}, 24,
     {{G2, 5, 1, 0}, {G3, 4, 1, 0}, {G3, 5, 1, 0}, {R0, 0, 7, 0},
      {B3, 0, 1, 0}, {B3, 1, 1, 0}, {B2, 4, 1, 0}, {G0, 0, 7, 0},
      {B2, 5, 1, 0}, {B3, 2, 1, 0}, {G2, 4, 1, 0}, {B0, 0, 7, 0},
      {B3, 3, 1, 0}, {B3, 5, 1, 0}, {B3, 4, 1, 0}, {R1, 0, 6, 0},
      {G2, 0, 4, 0}, {G1, 0, 6, 0}, {G3, 0, 4, 0}, {B1, 0, 6, 0},
      {B2, 0, 4, 0}, {R2, 0, 6, 0}, {R3, 0, 6, 0}, {0, 0, 0, 0}}},
    {2, 1, 11, {5, 4, 4}, 18,
     {{R0, 0, 10, 0}, {G0, 0, 10, 0}, {B0, 0, 10, 0}, {R1, 0, 5, 0},
      {R0, 10, 1, 0}, {G2, 0, 4, 0}, {G1, 0, 4, 0}, {G0, 10, 1, 0},
      {B3, 0, 1, 0}, {G3, 0, 4, 0}, {B1, 0, 4, 0}, {B0, 10, 1, 0},
      {B3, 1, 1, 0}, {B2, 0, 4, 0}, {R2, 0, 5, 0}, {B3, 2, 1, 0},
      {R3, 0, 5, 0}, {B3, 3, 1, 0}}},
    {2, 1, 11, {4, 5, 4}, 20,
     {{R0, 0, 10, 0}, {G0, 0, 10, 0}, {B0, 0, 10, 0}, {R1, 0, 4, 0},
      {R0, 10, 1, 0}, {G3, 4, 1, 0}, {G2, 0, 4, 0}, {G1, 0, 5, 0},
      {G0, 10, 1, 0}, {G3, 0, 4, 0}, {B1, 0, 4, 0}, {B0, 10, 1, 0},
      {B3, 1, 1, 0}, {B2, 0, 4, 0}, {R2, 0, 4, 0}, {B3, 0, 1, 0},
      {B3, 2, 1, 0}, {R3, 0, 4, 0}, {G2, 4, 1, 0}, {B3, 3, 1, 0}}},
    {2, 1, 11, {4, 4, 5}, 20,
     {{R0, 0, 10, 0}, {G0, 0, 10, 0}, {B0, 0, 10, 0}, {R1, 0, 4, 0},
      {R0, 10, 1, 0}, {B2, 4, 1, 0}, {G2, 0, 4, 0}, {G1, 0, 4, 0},
      {G0, 10, 1, 0}, {B3, 0, 1, 0}, {G3, 0, 4, 0}, {B1, 0, 5, 0},
      {B0, 10, 1, 0}, {B2, 0, 4, 0}, {R2, 0, 4, 0}, {B3, 1, 1, 0},
      {B3, 2, 1, 0}, {R3, 0, 4, 0}, {B3, 4, 1, 0}, {B3, 3, 1, 0}}},
    {2, 1, 9, {5, 5, 5}, 20,
     {{R0, 0, 9, 0}, {B2, 4, 1, 0}, {G0, 0, 9, 0}, {G2, 4, 1, 0},
      {B0, 0, 9, 0}, {B3, 4, 1, 0}, {R1, 0, 5, 0}, {G3, 4, 1, 0},
      {G2, 0, 4, 0}, {G1, 0, 5, 0}, {B3, 0, 1, 0}, {G3, 0, 4, 0},
      {B1, 0, 5, 0}, {B3, 1, 1, 0}, {B2, 0, 4, 0}, {R2, 0, 5, 0},
      {B3, 2, 1, 0}, {R3, 0, 5, 0}, {B3, 3, 1, 0}, {0, 0, 0, 0}}},
    {2, 1, 8, {6, 5, 5}, 20,
     {{R0, 0, 8, 0}, {G3, 4, 1, 0}, {B2, 4, 1, 0}, {G0, 0, 8, 0},
      {B3, 2, 1, 0}, {G2, 4, 1, 0}, {B0, 0, 8, 0}, {B3, 3, 1, 0},
      {B3, 4, 1, 0}, {R1, 0, 6, 0}, {G2, 0, 4, 0}, {G1, 0, 5, 0},
      {B3, 0, 1, 0}, {G3, 0, 4, 0}, {B1, 0, 5, 0}, {B3, 1, 1, 0},
      {B2, 0, 4, 0}, {R2, 0, 6, 0}, {R3, 0, 6, 0}, {0, 0, 0, 0}}},
    {2, 1, 8, {5, 6, 5}, 22,
     {{R0, 0, 8, 0}, {B3, 0, 1, 0}, {B2, 4, 1, 0}, {G0, 0, 8, 0},
      {G2, 5, 1, 0}, {G2, 4, 1, 0}, {B0, 0, 8, 0}, {G3, 5, 1, 0},
      {B3, 4, 1, 0}, {R1, 0, 5, 0}, {G3, 4, 1, 0}, {G2, 0, 4, 0},
      {G1, 0, 6, 0}, {G3, 0, 4, 0}, {B1, 0, 5, 0}, {B3, 1, 1, 0},
      {B2, 0, 4, 0}, {R2, 0, 5, 0}, {B3, 2, 1, 0}, {R3, 0, 5, 0},
      {B3, 3, 1, 0}, {0, 0, 0, 0}}},
    {2, 1, 8, {5, 5, 6}, 22,
     {{R0, 0, 8, 0}, {B3, 1, 1, 0}, {B2, 4, 1, 0}, {G0, 0, 8, 0},
      {B2, 5, 1, 0}, {G2, 4, 1, 0}, {B0, 0, 8, 0}, {B3, 5, 1, 0},
      {B3, 4, 1, 0}, {R1, 0, 5, 0}, {G3, 4, 1, 0}, {G2, 0, 4, 0},
      {G1, 0, 5, 0}, {B3, 0, 1, 0}, {G3, 0, 4, 0}, {B1, 0, 6, 0},
      {B2, 0, 4, 0}, {R2, 0, 5, 0}, {B3, 2, 1, 0}, {R3, 0, 5, 0},
      {B3, 3, 1, 0}, {0, 0, 0, 0}}},
    {2, 0, 6, {6, 6, 6}, 24,
     {{R0, 0, 6, 0}, {G3, 4, 1, 0}, {B3, 0, 1, 0}, {B3, 1, 1, 0},
      {B2, 4, 1, 0}, {G0, 0, 6, 0}, {G2, 5, 1, 0}, {B2, 5, 1, 0},
      {B3, 2, 1, 0}, {G2, 4, 1, 0}, {B0, 0, 6, 0}, {G3, 5, 1, 0},
      {B3, 3, 1, 0}, {B3, 5, 1, 0}, {B3, 4, 1, 0}, {R1, 0, 6, 0},
      {G2, 0, 4, 0}, {G1, 0, 6, 0}, {G3, 0, 4, 0}, {B1, 0, 6, 0},
      {B2, 0, 4, 0}, {R2, 0, 6, 0}, {R3, 0, 6, 0}, {0, 0, 0, 0}}},
    {1, 0, 10, {10, 10, 10}, 6,
     {{R0, 0, 10, 0}, {G0, 0, 10, 0}, {B0, 0, 10, 0}, {R1, 0, 10, 0},
      {G1, 0, 10, 0}, {B1, 0, 10, 0}}},
    {1, 1, 11, {9, 9, 9}, 9,
     {{R0, 0, 10, 0}, {G0, 0, 10, 0}, {B0, 0, 10, 0}, {R1, 0, 9, 0},
      {R0, 10, 1, 0}, {G1, 0, 9, 0}, {G0, 10, 1, 0}, {B1, 0, 9, 0},
      {B0, 10, 1, 0}}},
    {1, 1, 12, {8, 8, 8}, 9,
     {{R0, 0, 10, 0}, {G0, 0, 10, 0}, {B0, 0, 10, 0}, {R1, 0, 8, 0},
      {R0, 10, 2, 1}, {G1, 0, 8, 0}, {G0, 10, 2, 1}, {B1, 0, 8, 0},
      {B0, 10, 2, 1}}},
    {1, 1, 16, {4, 4, 4}, 9,
     {{R0, 0, 10, 0}, {G0, 0, 10, 0}, {B0, 0, 10, 0}, {R1, 0, 4, 0},
      {R0, 10, 6, 1}, {G1, 0, 4, 0}, {G0, 10, 6, 1}, {B1, 0, 4, 0},
      {B0, 10, 6, 1}}},
};

inline int SignExtend(int v, int bits) {
  v &= (1 << bits) - 1;
  return v & (1 << (bits - 1)) ? v - (1 << bits) : v;
}

int Unquantize(int x, int prec, bool sign) {
  if (!sign) {
    if (prec >= 15 || x == 0) return x;
    if (x == (1 << prec) - 1) return 0xffff;
    return ((x << 15) + 0x4000) >> (prec - 1);
  }
  if (prec >= 16) return x;
  const bool neg = x < 0;
  if (neg) x = -x;
  if (x != 0)
    x = x >= (1 << (prec - 1)) - 1 ? 0x7fff
                                   : ((x << 15) + 0x4000) >> (prec - 1);
  return neg ? -x : x;
}

float HalfToFloat(uint16_t h) {
  // exponent and mantissa shifted into a float, rescaled by 2^112; the
  // largest exponent is infinity or NaN
  uint32_t u = static_cast<uint32_t>(h & 0x7fff) << 13;
  float f;
  std::memcpy(&f, &u, 4);
  f *= 5.192296858534828e+33f;  // 2^112
  if (f >= 65536.0f) {
    std::memcpy(&u, &f, 4);
    u |= 255u << 23;
    std::memcpy(&f, &u, 4);
  }
  std::memcpy(&u, &f, 4);
  u |= static_cast<uint32_t>(h & 0x8000) << 16;
  std::memcpy(&f, &u, 4);
  return f;
}

uint8_t Finish(int v, bool sign) {
  uint16_t h;
  if (sign)
    h = v < 0 ? static_cast<uint16_t>(0x8000 | (((-v) * 31) >> 5))
              : static_cast<uint16_t>((v * 31) >> 5);
  else
    h = static_cast<uint16_t>((v * 31) >> 6);
  const float f = HalfToFloat(h);
  if (f < 0.0f) return 0;
  if (f > 1.0f) return 255;
  return static_cast<uint8_t>(f * 255.0f);
}

void Bc6(const uint8_t* src, uint8_t* out, bool sign) {
  int mode = src[0] & 0x1f;
  int bit = 5;
  if ((mode & 3) < 2) {
    mode &= 3;
    bit = 2;
  } else if ((mode & 3) == 2) {
    mode = 2 + (mode >> 2);
  } else {
    mode = 10 + (mode >> 2);
  }
  if (mode >= 14) {  // reserved
    std::memset(out, 0, 64);
    return;
  }
  const Bc6Mode& m = kBc6Modes[mode];
  int ep[12] = {0};
  for (int s = 0; s < m.nseg; ++s) {
    const Seg& g = m.seg[s];
    for (int k = 0; k < g.n; ++k)
      ep[g.f] |= Bit(src, bit++) << (g.rev ? g.lo + g.n - 1 - k : g.lo + k);
  }
  const int partition = m.ns == 2 ? Bits(src, bit, 5) : 0;
  bit += m.ns == 2 ? 5 : 0;
  const int numep = m.ns == 2 ? 12 : 6;
  if (sign)
    for (int c = 0; c < 3; ++c) ep[c] = SignExtend(ep[c], m.epb);
  for (int i = 3; i < numep; ++i) {
    const int c = i % 3;
    if (m.tr) {
      // the sum modulo the precision, not sign-extended again (Pillow's
      // 16-bit endpoint read as signed)
      ep[i] = (ep[c] + SignExtend(ep[i], m.db[c])) & ((1 << m.epb) - 1);
      if (sign) ep[i] = static_cast<int16_t>(ep[i]);
    } else if (sign) {
      ep[i] = SignExtend(ep[i], m.db[c]);
    }
  }
  int uq[12];
  for (int i = 0; i < numep; ++i) uq[i] = Unquantize(ep[i], m.epb, sign);
  const int ib = m.ns == 2 ? 3 : 4;
  const uint8_t* w = Weights(ib);
  for (int n = 0; n < 16; ++n) {
    const int s = Subset(m.ns, partition, n);
    const int bits = ib - (Anchor(m.ns, partition, n, s) ? 1 : 0);
    const int wi = w[Bits(src, bit, bits)];
    bit += bits;
    const int* e0 = uq + 6 * s;
    const int* e1 = e0 + 3;
    uint8_t* px = out + 4 * n;
    for (int c = 0; c < 3; ++c)
      px[c] = Finish((e0[c] * (64 - wi) + e1[c] * wi) >> 6, sign);
    px[3] = 255;
  }
}

}  // namespace

void DecodeBc7(const uint8_t* src, uint8_t* rgba) { Bc7(src, rgba); }

void DecodeBc6(const uint8_t* src, uint8_t* rgba, bool sign) {
  Bc6(src, rgba, sign);
}

}  // namespace ik_bcn
