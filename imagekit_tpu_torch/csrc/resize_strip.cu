// K2 on Hopper: the strip resize of one u8 plane.
//
// Replaces imagekit_tpu/ops/pallas_resize.py::_make_resize_kernel (the body
// launched by _plane_resize through pl.pallas_call). Per image b:
//
//   acc = Wv[vidx[b]] @ f32(x[b]) @ Wh[hidx[b]]^T          (OH x OW)
//
// Epilogue: optional (acc + pre) * scale + post, then floor(v + 0.5) (round
// half up), clip to [0, 255], and u8 out, or i8 after -128 when centered.
//
// What bounds it: the Lanczos stacks are banded (about 27 of 1088 taps per
// row of Wv and 29 of 1920 per row of Wh at the 1080p -> 240x400 bucket), so
// with the zero band skipped an image-channel costs ~30 MFLOP for ~2 MB of
// u8 read: it is bound by reading the interleaved batch and by shared-memory
// traffic, not by arithmetic. A dense fp32 product would spend ~1.4 GFLOP
// per image-channel on zeros.
// Design: one block per (image, tile of TR output rows); one launch per
// channel. The block reads vidx[b] and hidx[b] itself (the analogue of the
// Pallas scalar prefetch) and reads x in place through its strides, so one
// channel of an interleaved (B, H, W*3) batch needs no de-interleave copy.
// Pass 1 (vertical) runs over the union of the tile rows' [first, last)
// bands from the per-row band table, staging Wv in chunks of kChunk input
// rows in shared memory as [row][TR] (two float4 broadcasts feed eight
// FMAs), and keeps the (TR, IW) f32 intermediate in dynamic shared memory,
// so it never reaches device memory. Inside the union a row's weights off
// its own band are exact zeros, so the sum is the dense product's. Pass 2
// (horizontal) gives one output column to each thread, loops over that
// column's band of Wh only, and applies the epilogue. The epilogue's adds
// and products are kept apart (__fadd_rn/__fmul_rn) so nvcc cannot contract
// them into FMAs. Tensor cores (wgmma), TMA and coalesced u8 loads are later
// work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 64;  // input rows of Wv staged per step of pass 1
constexpr size_t kMaxSmem = 227 * 1024;

size_t smem_bytes(int tr, int iw) {
  return sizeof(float) * ((size_t)tr * iw + (size_t)kChunk * tr);
}

__device__ __forceinline__ uint8_t epilogue(float v, float scale, float pre,
                                            float post, int affine,
                                            int centered) {
  if (affine) v = __fadd_rn(__fmul_rn(__fadd_rn(v, pre), scale), post);
  v = floorf(__fadd_rn(v, 0.5f));
  v = fminf(fmaxf(v, 0.0f), 255.0f);
  if (centered)
    return static_cast<uint8_t>(static_cast<int8_t>(static_cast<int>(v) - 128));
  return static_cast<uint8_t>(static_cast<int>(v));
}

template <int TR>
__global__ void __launch_bounds__(kThreads)
strip_resize_kernel(const uint8_t* __restrict__ x, long long sb, long long sh,
                    long long sw, const float* __restrict__ wv,
                    const float* __restrict__ wh,
                    const int32_t* __restrict__ vidx,
                    const int32_t* __restrict__ hidx,
                    const int32_t* __restrict__ band_v,
                    const int32_t* __restrict__ band_h,
                    uint8_t* __restrict__ out, int IH, int IW, int OH, int OW,
                    int U, int U2, float scale, float pre, float post,
                    int affine, int centered) {
  static_assert(TR % 4 == 0, "TR feeds float4 weight broadcasts");
  extern __shared__ __align__(16) float smem[];
  float* tile = smem;                       // [TR][IW] f32 intermediate
  float* w_s = tile + (size_t)TR * IW;      // [kChunk][TR] slab of Wv
  __shared__ int window[2];

  const int b = blockIdx.y;
  const int o0 = blockIdx.x * TR;
  // an index outside the stack is clamped, as a JAX gather clamps it
  const int uv = min(max(vidx[b], 0), U - 1);
  const int uh = min(max(hidx[b], 0), U2 - 1);
  const float* wv_b = wv + (size_t)uv * OH * IH;
  const int32_t* bv_b = band_v + (size_t)uv * OH * 2;

  // Union of the tile rows' vertical bands; rows past OH and empty (pad)
  // rows take no part.
  if (threadIdx.x == 0) {
    int lo = IH, hi = 0;
    for (int r = 0; r < TR; ++r) {
      const int o = o0 + r;
      if (o >= OH) break;
      const int f = max(bv_b[2 * o], 0);
      const int l = min(bv_b[2 * o + 1], IH);
      if (f < l) {
        lo = min(lo, f);
        hi = max(hi, l);
      }
    }
    window[0] = lo;
    window[1] = hi;
  }
  __syncthreads();
  const int lo = window[0];
  const int hi = window[1];

  // Pass 1: tile[r][c] = sum_{i in [lo, hi)} Wv[o0 + r][i] * x[b][i][c].
  const uint8_t* xb = x + (size_t)b * sb;
  if (lo >= hi) {
    for (int i = threadIdx.x; i < TR * IW; i += blockDim.x) tile[i] = 0.0f;
  }
  for (int c0 = lo; c0 < hi; c0 += kChunk) {
    const int n = min(kChunk, hi - c0);
    __syncthreads();  // the previous chunk's slab is no longer read
    for (int i = threadIdx.x; i < n * TR; i += blockDim.x) {
      const int k = i / TR;
      const int r = i - k * TR;
      const int o = o0 + r;
      w_s[i] = o < OH ? wv_b[(size_t)o * IH + c0 + k] : 0.0f;
    }
    __syncthreads();
    const float4* w4 = reinterpret_cast<const float4*>(w_s);
    for (int c = threadIdx.x; c < IW; c += blockDim.x) {
      float acc[TR];
#pragma unroll
      for (int r = 0; r < TR; ++r)
        acc[r] = c0 == lo ? 0.0f : tile[(size_t)r * IW + c];
      const uint8_t* xc = xb + (size_t)c0 * sh + (size_t)c * sw;
      for (int k = 0; k < n; ++k) {
        const float xv = static_cast<float>(__ldg(xc + (size_t)k * sh));
#pragma unroll
        for (int r4 = 0; r4 < TR / 4; ++r4) {
          const float4 w = w4[k * (TR / 4) + r4];
          acc[4 * r4 + 0] = fmaf(w.x, xv, acc[4 * r4 + 0]);
          acc[4 * r4 + 1] = fmaf(w.y, xv, acc[4 * r4 + 1]);
          acc[4 * r4 + 2] = fmaf(w.z, xv, acc[4 * r4 + 2]);
          acc[4 * r4 + 3] = fmaf(w.w, xv, acc[4 * r4 + 3]);
        }
      }
#pragma unroll
      for (int r = 0; r < TR; ++r) tile[(size_t)r * IW + c] = acc[r];
    }
  }
  __syncthreads();

  // Pass 2: out[o0 + r][p] = sum_{j in band_h[p]} Wh[p][j] * tile[r][j].
  const float* wh_b = wh + (size_t)uh * OW * IW;
  const int32_t* bh_b = band_h + (size_t)uh * OW * 2;
  const int nr = min(TR, OH - o0);
  uint8_t* out_b = out + ((size_t)b * OH + o0) * OW;
  for (int p = threadIdx.x; p < OW; p += blockDim.x) {
    const int f = max(bh_b[2 * p], 0);
    const int l = min(bh_b[2 * p + 1], IW);
    const float* wr = wh_b + (size_t)p * IW;
    float acc[TR];
#pragma unroll
    for (int r = 0; r < TR; ++r) acc[r] = 0.0f;
    for (int j = f; j < l; ++j) {
      const float w = __ldg(wr + j);
#pragma unroll
      for (int r = 0; r < TR; ++r)
        acc[r] = fmaf(w, tile[(size_t)r * IW + j], acc[r]);
    }
#pragma unroll
    for (int r = 0; r < TR; ++r)
      if (r < nr)
        out_b[(size_t)r * OW + p] =
            epilogue(acc[r], scale, pre, post, affine, centered);
  }
}

template <int TR>
cudaError_t launch(const uint8_t* x, long long sb, long long sh, long long sw,
                   const float* wv, const float* wh, const int32_t* vidx,
                   const int32_t* hidx, const int32_t* band_v,
                   const int32_t* band_h, uint8_t* out, int B, int IH, int IW,
                   int OH, int OW, int U, int U2, float scale, float pre,
                   float post, int affine, int centered, cudaStream_t stream) {
  const size_t smem = smem_bytes(TR, IW);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        strip_resize_kernel<TR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((OH + TR - 1) / TR, B);
  strip_resize_kernel<TR><<<grid, kThreads, smem, stream>>>(
      x, sb, sh, sw, wv, wh, vidx, hidx, band_v, band_h, out, IH, IW, OH, OW,
      U, U2, scale, pre, post, affine, centered);
  return cudaGetLastError();
}

}  // namespace

// Shapes: x (B, IH, IW) u8 addressed as x[b*sb + i*sh + c*sw] (strides in
// elements, so one channel of an interleaved batch is read in place);
// wv (U, OH, IH) f32; wh (U2, OW, IW) f32; vidx, hidx (B,) i32;
// band_v (U, OH, 2) / band_h (U2, OW, 2) i32 [first, last) per row;
// out (B, OH, OW) u8 (i8 when centered). All but x contiguous.
// Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int ik_resize_strip_plane(
    const void* x, const void* wv, const void* wh, const void* vidx,
    const void* hidx, const void* band_v, const void* band_h, void* out,
    int B, int IH, int IW, int OH, int OW, int U, int U2, long long sb,
    long long sh, long long sw, float scale, float pre, float post,
    int affine, int centered, void* stream) {
  if (B <= 0 || IH <= 0 || IW <= 0 || OH <= 0 || OW <= 0 || U <= 0 ||
      U2 <= 0 || B > 65535 || sb <= 0 || sh <= 0 || sw <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* x8 = static_cast<const uint8_t*>(x);
  const auto* wvf = static_cast<const float*>(wv);
  const auto* whf = static_cast<const float*>(wh);
  const auto* vi = static_cast<const int32_t*>(vidx);
  const auto* hi = static_cast<const int32_t*>(hidx);
  const auto* bv = static_cast<const int32_t*>(band_v);
  const auto* bh = static_cast<const int32_t*>(band_h);
  auto* o8 = static_cast<uint8_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (smem_bytes(8, IW) <= kMaxSmem)
    return static_cast<int>(launch<8>(x8, sb, sh, sw, wvf, whf, vi, hi, bv,
                                      bh, o8, B, IH, IW, OH, OW, U, U2, scale,
                                      pre, post, affine, centered, s));
  if (smem_bytes(4, IW) <= kMaxSmem)
    return static_cast<int>(launch<4>(x8, sb, sh, sw, wvf, whf, vi, hi, bv,
                                      bh, o8, B, IH, IW, OH, OW, U, U2, scale,
                                      pre, post, affine, centered, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
