// Native PNG decode: chunk parsing, zlib inflate, scanline unfiltering and
// palette/grayscale expansion to RGB(A) — the host entropy stage of the PNG
// source path (reference decode arm: src/transform.rs:27-43 via the `image`
// crate; its own test decodes PNG, tests/transform.rs:123-131).
//
// The decompressed pixels feed the batched device resize directly, replacing
// the PIL fallback for the second-most-common source format (VERDICT r1
// missing #3). Scope: every legal PNG — all five colour types, bit depths
// 1/2/4/8/16, Adam7 interlacing, palette with optional tRNS alpha. 16-bit
// samples convert to 8-bit by taking the high byte (the reference's
// to_rgb8 semantics; see the parity ledger for the deliberate divergence
// from PIL's I;16 clamping on 16-bit grayscale).

#include <cstdint>
#include <cstring>
#include <vector>

#include <zlib.h>

#ifndef IK_EXPORT
#define IK_EXPORT extern "C" __attribute__((visibility("default")))
#endif

namespace {

constexpr int IK_PNG_OK = 0;
constexpr int IK_PNG_TRUNCATED = -1;
constexpr int IK_PNG_BAD_MAGIC = -2;
constexpr int IK_PNG_UNSUPPORTED = -3;
constexpr int IK_PNG_BAD_DATA = -4;
constexpr int IK_PNG_BAD_DIMS = -5;
constexpr int IK_PNG_BUFFER = -7;

inline uint32_t ReadU32(const uint8_t* p) {
  return (static_cast<uint32_t>(p[0]) << 24) | (p[1] << 16) | (p[2] << 8) |
         p[3];
}

struct PngInfo {
  uint32_t width = 0, height = 0;
  int depth = 0, color = 0, interlace = 0;
  int src_channels = 0;   // channels as stored in the file
  int out_channels = 0;   // channels after palette/gray expansion (3 or 4)
  bool has_trns = false;
};

struct Chunks {
  const uint8_t* plte = nullptr;
  size_t plte_len = 0;
  const uint8_t* trns = nullptr;
  size_t trns_len = 0;
  std::vector<std::pair<const uint8_t*, size_t>> idat;
};

int ParsePng(const uint8_t* data, size_t len, PngInfo* info, Chunks* chunks) {
  static const uint8_t kMagic[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  if (len < 8 + 25) return IK_PNG_TRUNCATED;
  if (std::memcmp(data, kMagic, 8) != 0) return IK_PNG_BAD_MAGIC;
  size_t pos = 8;
  bool saw_ihdr = false, saw_iend = false;
  while (pos + 12 <= len && !saw_iend) {
    const uint32_t clen = ReadU32(data + pos);
    if (pos + 12 + clen > len) return IK_PNG_TRUNCATED;
    const uint8_t* type = data + pos + 4;
    const uint8_t* body = data + pos + 8;
    const uint32_t crc = ReadU32(body + clen);
    // validate the CRC like the reference's decoder (corrupt data must
    // fail decode, tests/transform.rs:102-120 analogue)
    uint32_t actual = crc32(0L, Z_NULL, 0);
    actual = crc32(actual, type, 4 + clen);
    if (actual != crc) return IK_PNG_BAD_DATA;
    if (std::memcmp(type, "IHDR", 4) == 0) {
      if (clen != 13) return IK_PNG_BAD_DATA;
      info->width = ReadU32(body);
      info->height = ReadU32(body + 4);
      info->depth = body[8];
      info->color = body[9];
      if (body[10] != 0 || body[11] != 0) return IK_PNG_UNSUPPORTED;
      info->interlace = body[12];
      saw_ihdr = true;
    } else if (std::memcmp(type, "PLTE", 4) == 0) {
      chunks->plte = body;
      chunks->plte_len = clen;
    } else if (std::memcmp(type, "tRNS", 4) == 0) {
      chunks->trns = body;
      chunks->trns_len = clen;
      info->has_trns = true;
    } else if (std::memcmp(type, "IDAT", 4) == 0) {
      chunks->idat.emplace_back(body, clen);
    } else if (std::memcmp(type, "IEND", 4) == 0) {
      saw_iend = true;
    }
    pos += 12 + clen;
  }
  if (!saw_ihdr || chunks->idat.empty()) return IK_PNG_TRUNCATED;
  if (info->width == 0 || info->height == 0 ||
      info->width > (1u << 24) || info->height > (1u << 24))
    return IK_PNG_BAD_DIMS;
  if (info->interlace != 0 && info->interlace != 1) return IK_PNG_BAD_DATA;
  switch (info->color) {
    case 0: info->src_channels = 1; break;  // gray
    case 2: info->src_channels = 3; break;  // RGB
    case 3: info->src_channels = 1; break;  // palette
    case 4: info->src_channels = 2; break;  // gray+alpha
    case 6: info->src_channels = 4; break;  // RGBA
    default: return IK_PNG_BAD_DATA;
  }
  // legal depth x colour-type combinations (PNG spec table 11.1)
  const int d = info->depth;
  const bool depth_ok =
      (info->color == 0 && (d == 1 || d == 2 || d == 4 || d == 8 || d == 16)) ||
      (info->color == 3 && (d == 1 || d == 2 || d == 4 || d == 8)) ||
      ((info->color == 2 || info->color == 4 || info->color == 6) &&
       (d == 8 || d == 16));
  if (!depth_ok) return IK_PNG_BAD_DATA;
  if (info->color == 3 && chunks->plte == nullptr) return IK_PNG_BAD_DATA;
  // output layout mirrors the host-library backend (pil_backend.decode):
  // alpha-carrying sources expand to RGBA, the rest to RGB
  const bool alpha =
      info->color == 4 || info->color == 6 ||
      (info->color == 3 && info->has_trns);
  info->out_channels = alpha ? 4 : 3;
  return IK_PNG_OK;
}

int InflateAll(const Chunks& chunks, std::vector<uint8_t>* out) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return IK_PNG_BAD_DATA;
  int rc = IK_PNG_OK;
  size_t produced = 0;
  for (size_t i = 0; i < chunks.idat.size(); ++i) {
    zs.next_in = const_cast<uint8_t*>(chunks.idat[i].first);
    zs.avail_in = static_cast<uInt>(chunks.idat[i].second);
    while (zs.avail_in > 0) {
      if (produced == out->size()) {
        rc = IK_PNG_BAD_DATA;  // more data than the geometry needs
        goto done;
      }
      zs.next_out = out->data() + produced;
      zs.avail_out = static_cast<uInt>(out->size() - produced);
      const int zr = inflate(&zs, Z_NO_FLUSH);
      produced = out->size() - zs.avail_out;
      if (zr == Z_STREAM_END) goto done;
      if (zr != Z_OK && zr != Z_BUF_ERROR) {
        rc = IK_PNG_BAD_DATA;
        goto done;
      }
      if (zr == Z_BUF_ERROR && zs.avail_in == 0) break;
    }
  }
done:
  inflateEnd(&zs);
  if (rc == IK_PNG_OK && produced != out->size()) return IK_PNG_TRUNCATED;
  return rc;
}

inline int PaethPredictor(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = p > a ? p - a : a - p;
  const int pb = p > b ? p - b : b - p;
  const int pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

}  // namespace

// Header info for the Python side.
struct IkPngInfo {
  int32_t width;
  int32_t height;
  int32_t channels;  // output channels after expansion (3 or 4)
  int32_t color_type;
  int32_t bit_depth;
  int32_t interlaced;
};

IK_EXPORT int ik_png_parse(const uint8_t* data, size_t len, IkPngInfo* out) {
  PngInfo info;
  Chunks chunks;
  const int rc = ParsePng(data, len, &info, &chunks);
  out->width = static_cast<int32_t>(info.width);
  out->height = static_cast<int32_t>(info.height);
  out->channels = info.out_channels;
  out->color_type = info.color;
  out->bit_depth = info.depth;
  out->interlaced = info.interlace;
  return rc;
}

namespace {

// Adam7 pass geometry: x_start, y_start, x_step, y_step
struct Pass {
  int x0, y0, dx, dy;
};
const Pass kAdam7[7] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8},
                        {2, 0, 4, 4}, {0, 2, 2, 4}, {1, 0, 2, 2},
                        {0, 1, 1, 2}};

}  // namespace

// Decode into caller-provided buffer of width*height*channels bytes
// (channels from ik_png_parse). Returns IK_PNG_OK or an error code.
IK_EXPORT int ik_png_decode(const uint8_t* data, size_t len, uint8_t* out,
                            size_t out_cap) {
  PngInfo info;
  Chunks chunks;
  int rc = ParsePng(data, len, &info, &chunks);
  if (rc != IK_PNG_OK) return rc;
  const size_t W = info.width, H = info.height;
  const int sc = info.src_channels;
  const int oc = info.out_channels;
  const int depth = info.depth;
  if (out_cap < W * H * static_cast<size_t>(oc)) return IK_PNG_BUFFER;

  // per-row byte count for a given pixel width, and the filter unit
  auto row_bytes = [&](size_t w) -> size_t {
    return (w * sc * depth + 7) / 8;
  };
  const int bpp = depth < 8 ? 1 : sc * (depth / 8);
  // grayscale expansion factor for depths < 8 (255 / max_sample_value)
  const int gray_scale = depth < 8 ? 255 / ((1 << depth) - 1) : 1;

  // pass list: one full-frame pass, or the seven Adam7 passes
  struct PassDims {
    int x0, y0, dx, dy;
    size_t pw, ph;
  };
  std::vector<PassDims> passes;
  if (info.interlace == 0) {
    passes.push_back({0, 0, 1, 1, W, H});
  } else {
    for (const Pass& p : kAdam7) {
      const size_t pw =
          W > static_cast<size_t>(p.x0) ? (W - p.x0 + p.dx - 1) / p.dx : 0;
      const size_t ph =
          H > static_cast<size_t>(p.y0) ? (H - p.y0 + p.dy - 1) / p.dy : 0;
      passes.push_back({p.x0, p.y0, p.dx, p.dy, pw, ph});
    }
  }
  size_t total = 0;
  for (const auto& p : passes)
    if (p.pw && p.ph) total += p.ph * (1 + row_bytes(p.pw));
  std::vector<uint8_t> raw(total);
  rc = InflateAll(chunks, &raw);
  if (rc != IK_PNG_OK) return rc;

  // one sample (post-unfilter) -> 8-bit value; c is the channel index
  auto sample = [&](const uint8_t* cur, size_t x, int c) -> int {
    if (depth == 8) return cur[x * sc + c];
    if (depth == 16) return cur[(x * sc + c) * 2];  // big-endian high byte
    const int per_byte = 8 / depth;
    const int shift =
        8 - depth * (1 + static_cast<int>(x % per_byte));
    return (cur[x / per_byte] >> shift) & ((1 << depth) - 1);
  };

  const size_t plte_n = chunks.plte_len / 3;
  std::vector<uint8_t> prev, expanded;
  size_t off = 0;
  for (const auto& p : passes) {
    if (!p.pw || !p.ph) continue;
    const size_t rb = row_bytes(p.pw);
    prev.assign(rb, 0);
    expanded.resize(p.pw * oc);
    for (size_t yrow = 0; yrow < p.ph; ++yrow) {
      uint8_t* line = raw.data() + off + yrow * (1 + rb);
      const int filter = line[0];
      uint8_t* cur = line + 1;
      switch (filter) {
        case 0:
          break;
        case 1:  // sub
          for (size_t i = bpp; i < rb; ++i) cur[i] += cur[i - bpp];
          break;
        case 2:  // up
          for (size_t i = 0; i < rb; ++i) cur[i] += prev[i];
          break;
        case 3:  // average
          for (size_t i = 0; i < static_cast<size_t>(bpp) && i < rb; ++i)
            cur[i] += prev[i] / 2;
          for (size_t i = bpp; i < rb; ++i)
            cur[i] += (cur[i - bpp] + prev[i]) / 2;
          break;
        case 4:  // paeth
          for (size_t i = 0; i < static_cast<size_t>(bpp) && i < rb; ++i)
            cur[i] += PaethPredictor(0, prev[i], 0);
          for (size_t i = bpp; i < rb; ++i)
            cur[i] += PaethPredictor(cur[i - bpp], prev[i], prev[i - bpp]);
          break;
        default:
          return IK_PNG_BAD_DATA;
      }
      std::memcpy(prev.data(), cur, rb);

      // expand the scanline to 8-bit RGB(A)
      uint8_t* ex = expanded.data();
      switch (info.color) {
        case 0:  // gray -> RGB
          for (size_t x = 0; x < p.pw; ++x) {
            const uint8_t g =
                static_cast<uint8_t>(sample(cur, x, 0) * gray_scale);
            ex[x * 3 + 0] = g;
            ex[x * 3 + 1] = g;
            ex[x * 3 + 2] = g;
          }
          break;
        case 2:  // RGB
          if (depth == 8) {
            std::memcpy(ex, cur, p.pw * 3);
          } else {
            for (size_t x = 0; x < p.pw; ++x)
              for (int c = 0; c < 3; ++c)
                ex[x * 3 + c] = static_cast<uint8_t>(sample(cur, x, c));
          }
          break;
        case 3: {  // palette (indices never scale)
          for (size_t x = 0; x < p.pw; ++x) {
            const size_t idx = static_cast<size_t>(sample(cur, x, 0));
            if (idx >= plte_n) return IK_PNG_BAD_DATA;
            const uint8_t* e = chunks.plte + 3 * idx;
            if (oc == 4) {
              ex[x * 4 + 0] = e[0];
              ex[x * 4 + 1] = e[1];
              ex[x * 4 + 2] = e[2];
              ex[x * 4 + 3] =
                  idx < chunks.trns_len ? chunks.trns[idx] : 255;
            } else {
              ex[x * 3 + 0] = e[0];
              ex[x * 3 + 1] = e[1];
              ex[x * 3 + 2] = e[2];
            }
          }
          break;
        }
        case 4:  // gray+alpha -> RGBA
          for (size_t x = 0; x < p.pw; ++x) {
            const uint8_t g = static_cast<uint8_t>(sample(cur, x, 0));
            ex[x * 4 + 0] = g;
            ex[x * 4 + 1] = g;
            ex[x * 4 + 2] = g;
            ex[x * 4 + 3] = static_cast<uint8_t>(sample(cur, x, 1));
          }
          break;
        case 6:  // RGBA
          if (depth == 8) {
            std::memcpy(ex, cur, p.pw * 4);
          } else {
            for (size_t x = 0; x < p.pw; ++x)
              for (int c = 0; c < 4; ++c)
                ex[x * 4 + c] = static_cast<uint8_t>(sample(cur, x, c));
          }
          break;
      }

      // place the scanline (contiguous rows for pass 7 / non-interlaced)
      const size_t oy = p.y0 + yrow * p.dy;
      uint8_t* dst = out + (oy * W + p.x0) * oc;
      if (p.dx == 1) {
        std::memcpy(dst, expanded.data(), p.pw * oc);
      } else {
        for (size_t x = 0; x < p.pw; ++x)
          std::memcpy(dst + x * p.dx * oc, expanded.data() + x * oc, oc);
      }
    }
    off += p.ph * (1 + rb);
  }
  return IK_PNG_OK;
}

IK_EXPORT int ik_png_version() { return 1; }
