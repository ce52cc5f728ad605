// K6 on Hopper: the JPEG pixel decode as Pillow's libjpeg-turbo computes it.
//
// Replaces no Pallas kernel. The JAX package serves every JPEG outside its
// batched 4:2:0 heads (other samplings, grayscale, CMYK and YCCK,
// progressive and arithmetic frames, requests with no resize, the pages
// of JPEG-compressed TIFFs) through Pillow, whose decode is
// libjpeg-turbo's: the fixed-point islow IDCT, the fancy upsamplers and
// the fixed-point YCbCr -> RGB tables. K6 computes exactly that, in
// integers, so the port's pixels are Pillow's byte for byte. Two entries,
// one launch each:
//
//   ik_jpeg_idct     dequantise + islow IDCT + range limit of every 8x8
//                    block of up to four components, u8 planes out;
//   ik_jpeg_upcolour each component's upsample to the output grid by the
//                    sample maps the wrapper builds, then the colour step,
//                    (H, W, C) u8 out.
//
// The IDCT follows jidctint.c::jpeg_idct_islow (CONST_BITS 13, PASS1_BITS
// 2, the FIX_* constants below) as the x86-64 SIMD build Pillow runs
// computes it (jidctint-avx2.asm, whose results probing Pillow showed):
// the products of level and table kept to their low 16 bits (pmullw), the
// sums in0 + in4, in0 - in4, in7 + in3 and in5 + in1 in 16 bits (paddw),
// the pass-1 results saturated to 16 bits (packssdw), the whole block's
// pass 1 replaced by (in0 << PASS1_BITS) in 16 bits when every AC level of
// rows 1-7 is 0, and the output saturated to [-128, 127] before the +128
// (packsswb, paddb) where jidctint.c wraps through its range-limit table.
// For the levels a JPEG of 8-bit samples codes the two agree; they part
// only on hostile levels, where Pillow's is the answer. No sum here can
// pass 31 bits (|in| <= 32768 times the largest constants).
//
// The upsample (jdsample.c) and colour (jdcolor.c) steps: a component's
// sample at output (y, x) is read through its row map and column map,
// each (near, far, parity) a coordinate: h2v1 (3 near + far + 1|2) >> 2
// by column parity, h1v2 the same by row parity, h2v2 (3 colsum(near) +
// colsum(far) + 8|7) >> 4 with colsum = 3 near-row + far-row, and plain
// replication or the identity where the maps have near == far. The maps
// carry libjpeg's edges (the component's real size, a segment of a JPEG
// TIFF page restarting the context) so the kernel has no special cases.
// ycc_rgb_convert: R = y + Cr_r, G = y + ((Cb_g + Cr_g) >> 16), B = y +
// Cb_b with jdcolor.c's tables written as their formulas, clipped;
// ycck_cmyk_convert: 255 minus those, K passed through.
//
// What bounds it: bytes. A 1080p 4:2:0 image is 4.1 MB of i16 levels in
// and 6.2 MB of RGB out (about 3.7 us at 3.35 TB/s), and the u8 planes
// between the two launches (3.1 MB written, read again from L2). The
// IDCT is about 1.2k integer operations a block, far below the card's
// rate. Design: ik_jpeg_idct gives a block of 256 threads 32 JPEG blocks,
// loads their levels into shared memory in coalesced rows, runs pass 1
// with one thread a column and pass 2 with one thread a row, and stores
// each row's 8 bytes as one 8-byte write; ik_jpeg_upcolour gives one
// thread an output pixel of a row stripe, its 3-4 bytes next to its
// neighbours'. No tensor cores, no TMA: integer work on bytes.
//
// The source also compiles as plain C++ under the CPU tests' shim (one
// thread a block, __syncthreads a no-op): every loop strides by
// blockDim.x and every phase ends at a barrier.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef IK_LAUNCH
#define IK_LAUNCH(kernel, grid, block, smem, stream) \
  kernel<<<grid, block, smem, stream>>>
#endif

namespace {

// jidctint.c's constants, FIX(x) = x * 2^13 rounded
constexpr int CONST_BITS = 13;
constexpr int PASS1_BITS = 2;
constexpr int FIX_0_298631336 = 2446;
constexpr int FIX_0_390180644 = 3196;
constexpr int FIX_0_541196100 = 4433;
constexpr int FIX_0_765366865 = 6270;
constexpr int FIX_0_899976223 = 7373;
constexpr int FIX_1_175875602 = 9633;
constexpr int FIX_1_501321110 = 12299;
constexpr int FIX_1_847759065 = 15137;
constexpr int FIX_1_961570560 = 16069;
constexpr int FIX_2_053119869 = 16819;
constexpr int FIX_2_562915447 = 20995;
constexpr int FIX_3_072711026 = 25172;
constexpr int DESCALE_P1 = CONST_BITS - PASS1_BITS;
constexpr int DESCALE_P2 = CONST_BITS + PASS1_BITS + 3;

// jdcolor.c's constants, SCALEBITS 16: FIX(1.40200), FIX(1.77200),
// FIX(0.71414), FIX(0.34414) and ONE_HALF
constexpr int SCALEBITS = 16;
constexpr int FIX_1_40200 = 91881;
constexpr int FIX_1_77200 = 116130;
constexpr int FIX_0_71414 = 46802;
constexpr int FIX_0_34414 = 22554;
constexpr int ONE_HALF = 1 << (SCALEBITS - 1);

constexpr int kMaxComps = 4;
constexpr int kThreads = 256;
constexpr int kBlocks = kThreads / 8;  // JPEG blocks a thread block
constexpr int kTile = 256;             // output pixels a thread block

enum Colour { kNone = 0, kYcc = 1, kYcck = 2 };

struct Comp {
  const int16_t* coef;  // (by, bx, 64) levels, natural order
  uint8_t* plane;       // (by * 8, bx * 8) samples
  const int32_t* rows;  // (3, H): near row, far row, parity
  const int32_t* cols;  // (3, W): near column, far column, parity
  int by, bx;
  int first;            // its first block in the launch's block order
  int fancy;            // bit 0: triangle on rows, bit 1: on columns
};

struct Args {
  Comp comp[kMaxComps];
  const int16_t* qt;  // (ncomp, 64) the tables' low 16 bits, natural order
  uint8_t* out;       // (H, W, ncomp)
  int ncomp, H, W, colour, blocks;
};

__device__ __forceinline__ int w16(int x) {
  return static_cast<int>(static_cast<int16_t>(x));
}

__device__ __forceinline__ int sat16(int x) {
  return x < -32768 ? -32768 : (x > 32767 ? 32767 : x);
}

// One 8-point islow pass over in[0..7] (16-bit values), as the SIMD
// computes it: out[0..7] before the descale.
__device__ __forceinline__ void idct8(const int* in, int* out) {
  // even part
  const int tmp3 = in[2] * (FIX_0_541196100 + FIX_0_765366865) +
                   in[6] * FIX_0_541196100;
  const int tmp2 = in[2] * FIX_0_541196100 +
                   in[6] * (FIX_0_541196100 - FIX_1_847759065);
  const int tmp0 = w16(in[0] + in[4]) * (1 << CONST_BITS);
  const int tmp1 = w16(in[0] - in[4]) * (1 << CONST_BITS);
  const int tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  const int tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  // odd part
  const int z3 = w16(in[7] + in[3]);
  const int z4 = w16(in[5] + in[1]);
  const int z3m = z3 * (FIX_1_175875602 - FIX_1_961570560) +
                  z4 * FIX_1_175875602;
  const int z4m = z3 * FIX_1_175875602 +
                  z4 * (FIX_1_175875602 - FIX_0_390180644);
  const int o0 = in[7] * (FIX_0_298631336 - FIX_0_899976223) -
                 in[1] * FIX_0_899976223 + z3m;
  const int o1 = in[5] * (FIX_2_053119869 - FIX_2_562915447) -
                 in[3] * FIX_2_562915447 + z4m;
  const int o2 = -in[5] * FIX_2_562915447 +
                 in[3] * (FIX_3_072711026 - FIX_2_562915447) + z3m;
  const int o3 = -in[7] * FIX_0_899976223 +
                 in[1] * (FIX_1_501321110 - FIX_0_899976223) + z4m;
  out[0] = tmp10 + o3;
  out[7] = tmp10 - o3;
  out[1] = tmp11 + o2;
  out[6] = tmp11 - o2;
  out[2] = tmp12 + o1;
  out[5] = tmp12 - o1;
  out[3] = tmp13 + o0;
  out[4] = tmp13 - o0;
}

__global__ void __launch_bounds__(kThreads) idct_kernel(Args a) {
  __shared__ int16_t coef[kBlocks * 64];
  __shared__ int16_t ws[kBlocks * 64];
  __shared__ int16_t qt[kMaxComps * 64];
  __shared__ int comp_of[kBlocks];
  __shared__ int index_of[kBlocks];
  __shared__ int ac[kBlocks * 8];
  const int first = blockIdx.x * kBlocks;
  const int nb = min(kBlocks, a.blocks - first);
  for (int i = threadIdx.x; i < a.ncomp * 64; i += blockDim.x)
    qt[i] = a.qt[i];
  for (int b = threadIdx.x; b < nb; b += blockDim.x) {
    int c = 0;
    while (c + 1 < a.ncomp && first + b >= a.comp[c + 1].first) ++c;
    comp_of[b] = c;
    index_of[b] = first + b - a.comp[c].first;
  }
  __syncthreads();
  // the levels, a block's 64 after another's: one component's blocks are
  // contiguous, so the reads are too
  for (int i = threadIdx.x; i < nb * 64; i += blockDim.x) {
    const int b = i >> 6;
    coef[i] = a.comp[comp_of[b]].coef[(size_t)index_of[b] * 64 + (i & 63)];
  }
  __syncthreads();
  // whether column x of block b has an AC level in rows 1-7
  for (int t = threadIdx.x; t < nb * 8; t += blockDim.x) {
    const int16_t* col = coef + (t >> 3) * 64 + (t & 7);
    int any = 0;
    for (int r = 1; r < 8; ++r) any |= col[r * 8];
    ac[t] = any != 0;
  }
  __syncthreads();
  // pass 1: columns, dequantised as they are read
  for (int t = threadIdx.x; t < nb * 8; t += blockDim.x) {
    const int b = t >> 3, x = t & 7;
    const int16_t* col = coef + b * 64 + x;
    const int16_t* q = qt + comp_of[b] * 64 + x;
    int16_t* dst = ws + b * 64 + x;
    int any = 0;
    for (int k = 0; k < 8; ++k) any |= ac[b * 8 + k];
    if (!any) {
      const int dc = w16(w16(col[0] * q[0]) * (1 << PASS1_BITS));
      for (int r = 0; r < 8; ++r) dst[r * 8] = static_cast<int16_t>(dc);
      continue;
    }
    int in[8], out[8];
    for (int r = 0; r < 8; ++r) in[r] = w16(col[r * 8] * q[r * 8]);
    idct8(in, out);
    for (int r = 0; r < 8; ++r)
      dst[r * 8] = static_cast<int16_t>(
          sat16((out[r] + (1 << (DESCALE_P1 - 1))) >> DESCALE_P1));
  }
  __syncthreads();
  // pass 2: rows, then the range limit and one 8-byte store a row
  for (int t = threadIdx.x; t < nb * 8; t += blockDim.x) {
    const int b = t >> 3, y = t & 7;
    const Comp& c = a.comp[comp_of[b]];
    const int16_t* row = ws + b * 64 + y * 8;
    int in[8], out[8];
    for (int k = 0; k < 8; ++k) in[k] = row[k];
    idct8(in, out);
    unsigned lo = 0, hi = 0;
    for (int k = 0; k < 8; ++k) {
      int v = (out[k] + (1 << (DESCALE_P2 - 1))) >> DESCALE_P2;
      v = (v < -128 ? -128 : (v > 127 ? 127 : v)) + 128;
      if (k < 4)
        lo |= static_cast<unsigned>(v) << (8 * k);
      else
        hi |= static_cast<unsigned>(v) << (8 * (k - 4));
    }
    const int by = index_of[b] / c.bx, bx = index_of[b] % c.bx;
    uint2* dst = reinterpret_cast<uint2*>(
        c.plane + ((size_t)by * 8 + y) * c.bx * 8 + (size_t)bx * 8);
    *dst = uint2{lo, hi};
  }
}

__device__ __forceinline__ int clampi(int i, int n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// component c's sample at output (y, x), by its maps
__device__ __forceinline__ int sample(const Comp& c, int H, int W, int y,
                                      int x) {
  // the maps are checked on the host; the clamps keep a bad one in the
  // plane
  const int pw = c.bx * 8, ph = c.by * 8;
  const uint8_t* near = c.plane + (size_t)clampi(c.rows[y], ph) * pw;
  const uint8_t* far = c.plane + (size_t)clampi(c.rows[H + y], ph) * pw;
  const int xn = clampi(c.cols[x], pw), xf = clampi(c.cols[W + x], pw);
  switch (c.fancy) {
    case 3: {  // h2v2
      const int sn = 3 * near[xn] + far[xn];
      const int sf = 3 * near[xf] + far[xf];
      return (3 * sn + sf + 8 - c.cols[2 * W + x]) >> 4;
    }
    case 2:  // h2v1
      return (3 * near[xn] + near[xf] + 1 + c.cols[2 * W + x]) >> 2;
    case 1:  // h1v2
      return (3 * near[xn] + far[xn] + 1 + c.rows[2 * H + y]) >> 2;
    default:  // the identity, replication
      return near[xn];
  }
}

__device__ __forceinline__ int clip8(int v) {
  return v < 0 ? 0 : (v > 255 ? 255 : v);
}

__global__ void __launch_bounds__(kThreads) upcolour_kernel(Args a) {
  const int y = blockIdx.y;
  const int x1 = min(a.W, (int)(blockIdx.x + 1) * kTile);
  for (int x = blockIdx.x * kTile + threadIdx.x; x < x1; x += blockDim.x) {
    int v[kMaxComps];
    for (int c = 0; c < a.ncomp; ++c) v[c] = sample(a.comp[c], a.H, a.W, y, x);
    uint8_t* dst = a.out + ((size_t)y * a.W + x) * a.ncomp;
    if (a.colour != kNone) {
      const int cb = v[1] - 128, cr = v[2] - 128;
      const int r = v[0] + ((FIX_1_40200 * cr + ONE_HALF) >> SCALEBITS);
      const int g = v[0] + ((-FIX_0_34414 * cb + ONE_HALF - FIX_0_71414 * cr)
                            >> SCALEBITS);
      const int b = v[0] + ((FIX_1_77200 * cb + ONE_HALF) >> SCALEBITS);
      if (a.colour == kYcc) {
        v[0] = r, v[1] = g, v[2] = b;
      } else {
        v[0] = 255 - r, v[1] = 255 - g, v[2] = 255 - b;
      }
      for (int c = 0; c < 3; ++c) v[c] = clip8(v[c]);
    }
    for (int c = 0; c < a.ncomp; ++c) dst[c] = static_cast<uint8_t>(v[c]);
  }
}

// the launch's arguments from the wrapper's record, or false for a record
// the kernels do not take
bool unpack(const void* rec, Args& a) {
  struct Record {
    const void* coef[kMaxComps];
    void* plane[kMaxComps];
    const void* rows[kMaxComps];
    const void* cols[kMaxComps];
    int by[kMaxComps], bx[kMaxComps], fancy[kMaxComps];
    const void* qt;
    void* out;
    int ncomp, H, W, colour;
  };
  const Record& r = *static_cast<const Record*>(rec);
  if (r.ncomp < 1 || r.ncomp > kMaxComps || r.H < 1 || r.W < 1 ||
      r.H > 65535 || r.colour < kNone || r.colour > kYcck ||
      (r.colour == kYcc && r.ncomp != 3) ||
      (r.colour == kYcck && r.ncomp != 4))
    return false;
  a.qt = static_cast<const int16_t*>(r.qt);
  a.out = static_cast<uint8_t*>(r.out);
  a.ncomp = r.ncomp;
  a.H = r.H;
  a.W = r.W;
  a.colour = r.colour;
  long long blocks = 0;
  for (int c = 0; c < r.ncomp; ++c) {
    Comp& k = a.comp[c];
    if (r.by[c] < 1 || r.bx[c] < 1 || r.fancy[c] < 0 || r.fancy[c] > 3 ||
        (reinterpret_cast<uintptr_t>(r.plane[c]) & 7))
      return false;
    k.coef = static_cast<const int16_t*>(r.coef[c]);
    k.plane = static_cast<uint8_t*>(r.plane[c]);
    k.rows = static_cast<const int32_t*>(r.rows[c]);
    k.cols = static_cast<const int32_t*>(r.cols[c]);
    k.by = r.by[c];
    k.bx = r.bx[c];
    k.fancy = r.fancy[c];
    k.first = static_cast<int>(blocks);
    blocks += (long long)r.by[c] * r.bx[c];
  }
  if (blocks > (1LL << 30)) return false;
  a.blocks = static_cast<int>(blocks);
  return true;
}

}  // namespace

extern "C" int ik_jpeg_idct(const void* rec, void* stream) {
  Args a;
  if (!unpack(rec, a)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((a.blocks + kBlocks - 1) / kBlocks);
  IK_LAUNCH(idct_kernel, grid, dim3(kThreads), 0,
            static_cast<cudaStream_t>(stream))(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ik_jpeg_upcolour(const void* rec, void* stream) {
  Args a;
  if (!unpack(rec, a)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((a.W + kTile - 1) / kTile, a.H);
  IK_LAUNCH(upcolour_kernel, grid, dim3(kThreads), 0,
            static_cast<cudaStream_t>(stream))(a);
  return static_cast<int>(cudaGetLastError());
}
