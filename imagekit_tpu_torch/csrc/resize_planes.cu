// K3 and K4 on Hopper: the two-pass resize of contiguous planes.
//
// Replaces imagekit_tpu/ops/pallas/resize_kernel.py::_resize_plane_kernel
// (K3, launched by pallas_resize_u8 through pl.pallas_call) and
// ::_resize_plane_kernel_f32 (K4, launched by resize_planes_f32_pallas).
// Per image b, with one index u = vidx[b] for both axes:
//
//   acc = Wv[u] @ f32(P[b]) @ Wh[u]^T                        (OH x OW)
//
// K3 (u8 in, u8 out): floor(clip(acc, 0, 255) + 0.5), K3's own epilogue,
// which equals K2's clip(floor(acc + 0.5)) for every f32 value. K4 (f32 in,
// f32 out): acc as it is. One template, resize_planes_kernel<Tin, Tout, TR>,
// gives both.
//
// What bounds it: the Lanczos stacks are banded (about 27 of 1088 taps per
// row of Wv and 29 of 1920 per row of Wh at the luma 1088x1920 -> 240x400
// bucket), so with the zero band skipped a plane costs ~30 MFLOP for ~2 MB
// of u8 read: it is bound by reading the planes (several tiles re-read a
// row through L2) and by shared-memory traffic, not by arithmetic.
// Design: K2's (resize_strip.cu). One block per (image, tile of TR output
// rows), the block reads vidx[b] itself. Pass 1 (vertical) runs over the
// union of the tile rows' [first, last) bands from the per-row band table,
// staging Wv in chunks of kChunk input rows in shared memory as [row][TR],
// into a (TR, IW) f32 tile in dynamic shared memory that never reaches
// device memory. What differs from K2: the planes are contiguous, so each
// thread of pass 1 owns four neighbouring columns and reads them with one
// vector load (4 bytes of u8, 16 bytes of f32), neighbouring threads on
// neighbouring addresses. Inside the band union a row's weights off its own
// band are exact zeros, so the sums are the dense product's. Pass 2
// (horizontal) gives one output column to each thread over that column's
// band of Wh. The epilogue's add is kept apart (__fadd_rn) so nvcc cannot
// contract it into an FMA. Tensor cores (wgmma), TMA and one launch for
// Y, Cb and Cr are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 64;  // input rows of Wv staged per step of pass 1
constexpr size_t kMaxSmem = 227 * 1024;

size_t smem_bytes(int tr, int iw) {
  return sizeof(float) * ((size_t)tr * iw + (size_t)kChunk * tr);
}

__device__ __forceinline__ float4 load4(const uint8_t* p) {
  const uchar4 v = __ldg(reinterpret_cast<const uchar4*>(p));
  return make_float4(static_cast<float>(v.x), static_cast<float>(v.y),
                     static_cast<float>(v.z), static_cast<float>(v.w));
}

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void store(uint8_t* p, float v) {
  v = fminf(fmaxf(v, 0.0f), 255.0f);
  *p = static_cast<uint8_t>(static_cast<int>(floorf(__fadd_rn(v, 0.5f))));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }

template <typename Tin, typename Tout, int TR>
__global__ void __launch_bounds__(kThreads)
resize_planes_kernel(const Tin* __restrict__ x, const float* __restrict__ wv,
                     const float* __restrict__ wh,
                     const int32_t* __restrict__ vidx,
                     const int32_t* __restrict__ band_v,
                     const int32_t* __restrict__ band_h,
                     Tout* __restrict__ out, int IH, int IW, int OH, int OW,
                     int U) {
  static_assert(TR % 4 == 0, "TR feeds float4 weight broadcasts");
  extern __shared__ __align__(16) float smem[];
  float* tile = smem;                       // [TR][IW] f32 intermediate
  float* w_s = tile + (size_t)TR * IW;      // [kChunk][TR] slab of Wv
  __shared__ int window[2];

  const int b = blockIdx.y;
  const int o0 = blockIdx.x * TR;
  // an index outside the stack is clamped, as a JAX gather clamps it
  const int u = min(max(vidx[b], 0), U - 1);
  const float* wv_b = wv + (size_t)u * OH * IH;
  const int32_t* bv_b = band_v + (size_t)u * OH * 2;

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

  // Pass 1: tile[r][c] = sum_{i in [lo, hi)} Wv[o0 + r][i] * x[b][i][c],
  // four columns c = 4q .. 4q+3 per thread.
  const Tin* xb = x + (size_t)b * IH * IW;
  const int nq = IW / 4;
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
    for (int q = threadIdx.x; q < nq; q += blockDim.x) {
      float4 acc[TR];
      float4* t4 = reinterpret_cast<float4*>(tile);
#pragma unroll
      for (int r = 0; r < TR; ++r)
        acc[r] = c0 == lo ? make_float4(0.0f, 0.0f, 0.0f, 0.0f)
                          : t4[(size_t)r * nq + q];
      const Tin* xc = xb + (size_t)c0 * IW + 4 * q;
      for (int k = 0; k < n; ++k) {
        const float4 xv = load4(xc + (size_t)k * IW);
#pragma unroll
        for (int r4 = 0; r4 < TR / 4; ++r4) {
          const float4 w = w4[k * (TR / 4) + r4];
          const float wr[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float4& a = acc[4 * r4 + j];
            a.x = fmaf(wr[j], xv.x, a.x);
            a.y = fmaf(wr[j], xv.y, a.y);
            a.z = fmaf(wr[j], xv.z, a.z);
            a.w = fmaf(wr[j], xv.w, a.w);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < TR; ++r) t4[(size_t)r * nq + q] = acc[r];
    }
  }
  __syncthreads();

  // Pass 2: out[o0 + r][p] = sum_{j in band_h[p]} Wh[p][j] * tile[r][j].
  const float* wh_b = wh + (size_t)u * OW * IW;
  const int32_t* bh_b = band_h + (size_t)u * OW * 2;
  const int nr = min(TR, OH - o0);
  Tout* out_b = out + ((size_t)b * OH + o0) * OW;
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
      if (r < nr) store(out_b + (size_t)r * OW + p, acc[r]);
  }
}

template <typename Tin, typename Tout, int TR>
cudaError_t launch(const Tin* x, const float* wv, const float* wh,
                   const int32_t* vidx, const int32_t* band_v,
                   const int32_t* band_h, Tout* out, int B, int IH, int IW,
                   int OH, int OW, int U, cudaStream_t stream) {
  const size_t smem = smem_bytes(TR, IW);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        resize_planes_kernel<Tin, Tout, TR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((OH + TR - 1) / TR, B);
  resize_planes_kernel<Tin, Tout, TR><<<grid, kThreads, smem, stream>>>(
      x, wv, wh, vidx, band_v, band_h, out, IH, IW, OH, OW, U);
  return cudaGetLastError();
}

template <typename Tin, typename Tout>
int dispatch(const void* x, const void* wv, const void* wh, const void* vidx,
             const void* band_v, const void* band_h, void* out, int B, int IH,
             int IW, int OH, int OW, int U, void* stream) {
  // IW % 4: pass 1 reads four columns per vector load; the base must be
  // aligned to that load's width
  if (B <= 0 || IH <= 0 || IW <= 0 || OH <= 0 || OW <= 0 || U <= 0 ||
      B > 65535 || IW % 4 != 0 ||
      reinterpret_cast<uintptr_t>(x) % (4 * sizeof(Tin)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xi = static_cast<const Tin*>(x);
  const auto* wvf = static_cast<const float*>(wv);
  const auto* whf = static_cast<const float*>(wh);
  const auto* vi = static_cast<const int32_t*>(vidx);
  const auto* bv = static_cast<const int32_t*>(band_v);
  const auto* bh = static_cast<const int32_t*>(band_h);
  auto* o = static_cast<Tout*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (smem_bytes(8, IW) <= kMaxSmem)
    return static_cast<int>(launch<Tin, Tout, 8>(
        xi, wvf, whf, vi, bv, bh, o, B, IH, IW, OH, OW, U, s));
  if (smem_bytes(4, IW) <= kMaxSmem)
    return static_cast<int>(launch<Tin, Tout, 4>(
        xi, wvf, whf, vi, bv, bh, o, B, IH, IW, OH, OW, U, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Shapes: x (B, IH, IW) contiguous, u8 (K3) or f32 (K4), IW % 4 == 0;
// wv (U, OH, IH) f32; wh (U, OW, IW) f32; vidx (B,) i32, one index for both
// axes; band_v (U, OH, 2) / band_h (U, OW, 2) i32 [first, last) per row;
// out (B, OH, OW) u8 (K3) or f32 (K4). All contiguous.
// Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int ik_resize_planes_u8(const void* x, const void* wv,
                                   const void* wh, const void* vidx,
                                   const void* band_v, const void* band_h,
                                   void* out, int B, int IH, int IW, int OH,
                                   int OW, int U, void* stream) {
  return dispatch<uint8_t, uint8_t>(x, wv, wh, vidx, band_v, band_h, out, B,
                                    IH, IW, OH, OW, U, stream);
}

extern "C" int ik_resize_planes_f32(const void* x, const void* wv,
                                    const void* wh, const void* vidx,
                                    const void* band_v, const void* band_h,
                                    void* out, int B, int IH, int IW, int OH,
                                    int OW, int U, void* stream) {
  return dispatch<float, float>(x, wv, wh, vidx, band_v, band_h, out, B, IH,
                                IW, OH, OW, U, stream);
}
